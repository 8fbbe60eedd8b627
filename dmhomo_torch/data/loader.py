"""Batching of dict samples: the seeded shuffling ``DataLoader`` (the JAX
package's ``data/loader.py``, in one process), plain in-order batches, tail
padding and ``cycle``."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def collate(items):
    first = items[0]
    if isinstance(first, dict):
        return {k: collate([it[k] for it in items]) for k in first}
    if isinstance(first, (str, bytes)):
        return list(items)
    return np.stack([np.asarray(it) for it in items])


def iterate_batches(dataset, batch_size: int) -> Iterator[dict]:
    """Batches of ``batch_size`` samples in dataset order; the last may be short."""
    for start in range(0, len(dataset), batch_size):
        stop = min(start + batch_size, len(dataset))
        yield collate([dataset[i] for i in range(start, stop)])


def pad_batch(batch: dict, batch_size: int):
    """Pad a short tail batch to ``batch_size`` by repeating its last element
    (arrays along axis 0, lists extended).  Returns (padded_batch, n_valid)."""
    first = next(iter(batch.values()))
    n = len(first) if isinstance(first, list) else first.shape[0]
    if n > batch_size:
        raise ValueError(f"batch of {n} exceeds batch_size {batch_size}")
    if n == batch_size:
        return batch, n
    pad = batch_size - n
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = v + [v[-1]] * pad
        else:
            out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
    return out, n


class DataLoader:
    """Batches of ``batch_size`` samples; with ``shuffle`` the order of epoch
    e (counted from 1) is ``np.random.default_rng(seed + e)``'s permutation,
    as in the JAX package, so both see the same batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        self.epoch += 1
        idx = self._indices()
        for b in range(len(self)):
            sel = idx[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.dataset[int(i)] for i in sel])


def cycle(loader) -> Iterator:
    """Endless batch stream (the reference's ``cycle``)."""
    while True:
        yield from loader
