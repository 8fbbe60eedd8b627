"""Per-sample files of the generated training set: ``{"img12": (6, S, S)
uint8, "homo12": (3, 3)}`` pickled into an ``.npy`` (the JAX package's
``data/shards.py`` and the reference's generate_nyps_to_single_case.py)."""

from __future__ import annotations

import numpy as np


def load_sample(path: str) -> dict:
    # the files are written by this project's generation pipeline
    return np.load(path, allow_pickle=True).item()
