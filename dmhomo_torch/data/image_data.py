"""Plain-image datasets for the unconditional diffusion twin (the JAX
package's ``data/image_data.py``; reference ``denoising_diffusion_pytorch.py``):

* :class:`CifarDataset` (:820-871): the CIFAR-10 pickle batches
  ``data_batch_1`` .. ``_5`` -> (N, 32, 32, 3) uint8, resized to
  ``image_size``, an optional horizontal flip;
* :class:`GHOFTestDataset` (:874-911): an ``.npy`` list of dicts whose
  ``"img1"`` frames get a random ``image_size`` crop, an optional flip.

Items are NHWC float32 in [0, 1], drawn with the caller's
``np.random.Generator`` (the same draws as the JAX package's for the same
seed).  OpenCV is imported only where a resize is needed.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np


class CifarDataset:
    """CIFAR-10 train batches as (image_size, image_size, 3) float32."""

    def __init__(self, folder: str, image_size: int, augment_horizontal_flip: bool = False,
                 rng: Optional[np.random.Generator] = None):
        batches = []
        for i in range(1, 6):
            with open(os.path.join(folder, f"data_batch_{i}"), "rb") as f:
                batches.append(pickle.load(f, encoding="bytes")[b"data"])
        data = np.concatenate(batches, 0)
        self.datas = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC uint8
        self.image_size = image_size
        self.flip = augment_horizontal_flip
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.datas)

    def __getitem__(self, idx):
        img = self.datas[idx]
        s = self.image_size
        if img.shape[:2] != (s, s):
            import cv2

            img = cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
        if self.flip and self.rng.random() < 0.5:
            img = img[:, ::-1]
        return np.ascontiguousarray(img, np.float32) / 255.0


class GHOFTestDataset:
    """GHOF benchmark frames: a random image_size crop of each sample's img1."""

    def __init__(self, benchmark_path: str, image_size: int,
                 augment_horizontal_flip: bool = False,
                 rng: Optional[np.random.Generator] = None):
        self.samples = np.load(benchmark_path, allow_pickle=True)
        self.image_size = image_size
        self.flip = augment_horizontal_flip
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = np.asarray(self.samples[idx]["img1"], np.uint8)
        s = self.image_size
        h, w = img.shape[:2]
        if h < s or w < s:
            raise ValueError(f"a frame of {img.shape} is smaller than the {s}x{s} crop")
        y = int(self.rng.integers(0, h - s + 1))
        x = int(self.rng.integers(0, w - s + 1))
        img = img[y:y + s, x:x + s]
        if self.flip and self.rng.random() < 0.5:
            img = img[:, ::-1]
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return np.ascontiguousarray(img, np.float32) / 255.0
