"""Generated training set IO, in the reference's formats (the JAX package's
``data/shards.py``):

* a generation shard is an ``.npy`` holding a list of batches
  ``{"imgs": (N, 6, S, S) uint8, "homos": (N, 3, 3)}`` (CHW uint8), named
  ``idx_{i}_rank_{r}_part_{p}_dm_cahomo_{n}k.npy``;
* a per-sample file is ``{"img12": (6, S, S) uint8, "homo12": (3, 3)}``
  pickled into an ``.npy`` (what ``HEMTrainDataset`` reads).
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def shard_filename(idx: int, rank: int, part: int, n_samples: int) -> str:
    return f"idx_{idx}_rank_{rank}_part_{part}_dm_cahomo_{n_samples / 1000}k.npy"


def save_generation_shard(path: str, batches: Sequence[dict]) -> None:
    """batches: list of {"imgs": (N, 6, S, S) uint8, "homos": (N, 3, 3)}."""
    for b in batches:
        if b["imgs"].dtype != np.uint8 or b["imgs"].shape[1] != 6:
            raise ValueError(f"imgs must be (N, 6, S, S) uint8; got {b['imgs'].dtype} "
                             f"{b['imgs'].shape}")
        if b["homos"].shape[-2:] != (3, 3):
            raise ValueError(f"homos must be (N, 3, 3); got {b['homos'].shape}")
    np.save(path, np.asarray(list(batches), dtype=object), allow_pickle=True)


def load_generation_shard(path: str) -> List[dict]:
    # the files are written by this project's generation pipeline
    return list(np.load(path, allow_pickle=True))


def explode_shards_to_samples(shard_paths: Sequence[str], out_dir: str,
                              start_index: int = 0) -> int:
    """Write every sample of the shards as ``{index}.npy`` into out_dir;
    returns the next free index."""
    os.makedirs(out_dir, exist_ok=True)
    idx = start_index
    for sp in shard_paths:
        for batch in load_generation_shard(sp):
            for img, homo in zip(batch["imgs"], batch["homos"]):
                np.save(os.path.join(out_dir, f"{idx}.npy"),
                        {"img12": img, "homo12": np.asarray(homo)}, allow_pickle=True)
                idx += 1
    return idx


def load_sample(path: str) -> dict:
    # the files are written by this project's generation pipeline
    return np.load(path, allow_pickle=True).item()
