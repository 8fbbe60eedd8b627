"""Host-side (numpy, float64) geometry for the data pipelines (the JAX
package's ``geometry/host.py``): condition flows in float64 with one fp32
cast at the end, as the reference's numpy pipeline."""

from __future__ import annotations

import numpy as np


def _mapped(H: np.ndarray, h: int, w: int, eps: float):
    X, Y = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    o = np.asarray(H, np.float64) @ np.stack([X.ravel(), Y.ravel(), np.ones(h * w)])
    z = o[2] + eps
    return (o[0] / z).reshape(h, w), (o[1] / z).reshape(h, w), X, Y


def homography_to_mapping_np(H: np.ndarray, h: int, w: int, eps: float = 1e-6) -> np.ndarray:
    """Where H takes every pixel, in float64 -> (h, w, 2) float32."""
    mx, my, _, _ = _mapped(H, h, w, eps)
    return np.stack([mx, my], axis=-1).astype(np.float32)


def homography_to_flow_np(H: np.ndarray, h: int, w: int, eps: float = 1e-6) -> np.ndarray:
    """flow(x) = H(x) - x in float64, one fp32 cast at the end: (h, w, 2)."""
    mx, my, X, Y = _mapped(H, h, w, eps)
    return np.stack([mx - X, my - Y], axis=-1).astype(np.float32)


def half_size_matrix(hh: int, ww: int) -> np.ndarray:
    """Pixel coordinates from [-1, 1] ones at an (hh, ww) resolution."""
    return np.array([[ww / 2.0, 0.0, ww / 2.0], [0.0, hh / 2.0, hh / 2.0], [0.0, 0.0, 1.0]])


def rescale_homography_np(H: np.ndarray, src_hw, dst_hw) -> np.ndarray:
    """float64 ``adapt_homography_to_preprocessing_v3`` conjugation."""
    m0, m1 = half_size_matrix(*src_hw), half_size_matrix(*dst_hw)
    return m1 @ np.linalg.inv(m0) @ np.asarray(H, np.float64) @ m0 @ np.linalg.inv(m1)
