"""Homography math on tensors: application, H -> dense mapping / flow,
conjugation into another resolution, the exact 4-point DLT (the JAX
package's ``geometry/homography.py``).

fp32 here is full fp32: the entry points switch TF32 off on the card, where
the JAX code asks for ``precision=HIGHEST``.  Projective divides carry the
reference's guards: ``"add"`` (+eps always, ``get_flow_np``) or ``"cond"``
(+eps only where |z| < 1e-7, HEM/model/utils.py).
"""

from __future__ import annotations

import numpy as np
import torch

from dmhomo_torch.geometry.grids import pixel_grid
from dmhomo_torch.geometry.host import half_size_matrix


def _projective_divide(xyz: torch.Tensor, guard: str, eps: float) -> torch.Tensor:
    """(..., 3) homogeneous -> (..., 2) with the reference's divide guards."""
    z = xyz[..., 2:3]
    if guard == "add":
        z = z + eps
    elif guard == "cond":
        z = z + eps * (z.abs() < 1e-7).to(z.dtype)
    else:
        raise ValueError(f"unknown guard {guard!r}")
    return xyz[..., :2] / z


def apply_homography(H: torch.Tensor, pts: torch.Tensor, guard: str = "cond",
                     eps: float = 1e-6) -> torch.Tensor:
    """H (..., 3, 3) applied to pts (..., N, 2) -> (..., N, 2)."""
    xy1 = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    return _projective_divide(torch.einsum("...ij,...nj->...ni", H, xy1), guard, eps)


def homography_to_mapping(H: torch.Tensor, h: int, w: int, guard: str = "add",
                          eps: float = 1e-6) -> torch.Tensor:
    """Where H takes every pixel (x, y): (..., 3, 3) -> (..., h, w, 2).
    Pass eps=1e-8 for the HEM data-pipeline variant."""
    grid = pixel_grid(h, w, dtype=H.dtype, device=H.device)
    xy1 = torch.cat([grid, torch.ones_like(grid[..., :1])], dim=-1)  # (h, w, 3)
    return _projective_divide(torch.einsum("...ij,hwj->...hwi", H, xy1), guard, eps)


def homography_to_flow(H: torch.Tensor, h: int, w: int, guard: str = "add",
                       eps: float = 1e-6) -> torch.Tensor:
    """Dense flow of H: flow(x) = H(x) - x, (..., h, w, 2)."""
    return (homography_to_mapping(H, h, w, guard=guard, eps=eps)
            - pixel_grid(h, w, dtype=H.dtype, device=H.device))


def rescale_homography(H: torch.Tensor, src_hw, dst_hw) -> torch.Tensor:
    """Conjugate H (..., 3, 3) from src (h0, w0) pixel coordinates into dst
    (h1, w1) ones (``adapt_homography_to_preprocessing_v3``)."""
    m0, m1 = half_size_matrix(*src_hw), half_size_matrix(*dst_hw)
    pre = torch.as_tensor(m1 @ np.linalg.inv(m0), dtype=H.dtype, device=H.device)
    post = torch.as_tensor(m0 @ np.linalg.inv(m1), dtype=H.dtype, device=H.device)
    return pre @ H @ post


def dlt_solve_4pt(src: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Exact 4-point DLT: src (..., 4, 2) and dst = src + offset -> H
    (..., 3, 3) with H[2, 2] = 1, by solving the square 8x8 system."""
    dst = src + offset
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_x = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=-1)
    rows_y = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=-1)
    A = torch.stack([rows_x, rows_y], dim=-2).reshape(*x.shape[:-1], 8, 8)
    b = torch.stack([u, v], dim=-1).reshape(*u.shape[:-1], 8)
    h8 = torch.linalg.solve(A, b[..., None])[..., 0]
    return torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1).reshape(*h8.shape[:-1], 3, 3)
