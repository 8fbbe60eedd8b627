"""Flow <-> mapping conversions, validity masks and the random homography
sampler (the JAX package's ``geometry/flow_ops.py``).

* mapping = flow + pixel grid, and its [-1, 1] normalization (2x/(W-1) - 1);
* the correspondence mask: where the mapped position lands strictly inside
  (0, w) x (0, h) (``get_gt_correspondence_mask``), and as a float border mask;
* the zero-border mask: False where every channel is ~0;
* :class:`RandomHomography`: flip, rotation, shear, scale, perspective and
  translation about the image centre, from a numpy Generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dmhomo_torch.geometry.grids import pixel_grid


def _grid_like(t: torch.Tensor) -> torch.Tensor:
    return pixel_grid(t.shape[-3], t.shape[-2], dtype=t.dtype, device=t.device)


def convert_flow_to_mapping(flow: torch.Tensor) -> torch.Tensor:
    """(..., h, w, 2) flow -> absolute mapping (flow + grid)."""
    return flow + _grid_like(flow)


def convert_mapping_to_flow(mapping: torch.Tensor) -> torch.Tensor:
    """(..., h, w, 2) absolute mapping -> flow (mapping - grid)."""
    return mapping - _grid_like(mapping)


def _xy(t: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """(sx, sy) as a tensor of t's dtype on its device."""
    return torch.tensor([sx, sy], dtype=t.dtype, device=t.device)


def normalize_mapping(mapping: torch.Tensor) -> torch.Tensor:
    """Pixel mapping -> [-1, 1] coordinates (2x/(W-1) - 1)."""
    h, w = mapping.shape[-3], mapping.shape[-2]
    return mapping * _xy(mapping, 2.0 / (w - 1), 2.0 / (h - 1)) - 1.0


def unnormalize_mapping(mapping_n: torch.Tensor) -> torch.Tensor:
    """[-1, 1] coordinates -> pixel mapping."""
    h, w = mapping_n.shape[-3], mapping_n.shape[-2]
    return (mapping_n + 1.0) * _xy(mapping_n, (w - 1) / 2.0, (h - 1) / 2.0)


def correspondence_mask(flow: torch.Tensor) -> torch.Tensor:
    """(..., h, w) bool: the mapped position lies strictly inside (0, w) x (0, h)."""
    m = convert_flow_to_mapping(flow)
    h, w = flow.shape[-3], flow.shape[-2]
    return (m[..., 0] > 0) & (m[..., 0] < w) & (m[..., 1] > 0) & (m[..., 1] < h)


def border_mask(flow: torch.Tensor) -> torch.Tensor:
    """:func:`correspondence_mask` as float32 (``create_border_mask``)."""
    return correspondence_mask(flow).to(torch.float32)


def zero_border_mask(image: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """(..., h, w, C) image -> (..., h, w) bool, False where every channel < epsilon."""
    return ~(image < epsilon).all(dim=-1)


@dataclasses.dataclass
class RandomHomography:
    """Random homography sampler for augmentation: a 3x3 matrix on the pixel
    coordinates of an (h, w) image, composed about the image centre, the
    draws taken from the Generator in a fixed order (flip, rotation, shear,
    scale, perspective, translation)."""

    p_flip: float = 0.0
    max_rotation: float = 10.0  # degrees
    max_shear: float = 0.1
    max_scale: float = 0.1
    max_perspective: float = 1e-4
    max_translation: float = 8.0  # pixels

    def sample(self, rng: np.random.Generator, h: int, w: int) -> np.ndarray:
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        H = np.eye(3)
        if rng.uniform() < self.p_flip:
            H = H @ np.diag([-1.0, 1.0, 1.0])
        theta = np.deg2rad(rng.uniform(-self.max_rotation, self.max_rotation))
        c, s = np.cos(theta), np.sin(theta)
        H = H @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        shx, shy = rng.uniform(-self.max_shear, self.max_shear, 2)
        H = H @ np.array([[1, shx, 0], [shy, 1, 0], [0, 0, 1.0]])
        sx, sy = 1 + rng.uniform(-self.max_scale, self.max_scale, 2)
        H = H @ np.diag([sx, sy, 1.0])
        px, py = rng.uniform(-self.max_perspective, self.max_perspective, 2)
        H = H @ np.array([[1, 0, 0], [0, 1, 0], [px, py, 1.0]])
        tx, ty = rng.uniform(-self.max_translation, self.max_translation, 2)
        H = np.array([[1, 0, tx], [0, 1, ty], [0, 0, 1.0]]) @ H
        H = (np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1.0]]) @ H
             @ np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]]))
        return H / H[2, 2]
