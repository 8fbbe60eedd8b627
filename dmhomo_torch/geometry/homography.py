"""Homography math on tensors: application, H -> dense mapping / flow,
conjugation into another resolution, the exact 4-point DLT, the
least-squares DLT from points and the dense flow fit (the JAX package's
``geometry/homography.py``).

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


def _dlt_system(src: torch.Tensor, dst: torch.Tensor):
    """Rows of the DLT system A h8 = b for correspondences src -> dst (..., N, 2):
    A (..., 2N, 8), b (..., 2N), an x-row then a y-row per point:
    [x, y, 1, 0, 0, 0, -u*x, -u*y] . h8 = u and [0, 0, 0, x, y, 1, -v*x, -v*y] . h8 = v."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_x = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], dim=-1)
    rows_y = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], dim=-1)
    A = torch.stack([rows_x, rows_y], dim=-2).reshape(*x.shape[:-1], -1, 8)
    return A, torch.stack([u, v], dim=-1).reshape(*u.shape[:-1], -1)


def _h8_to_matrix(h8: torch.Tensor) -> torch.Tensor:
    return torch.cat([h8, torch.ones_like(h8[..., :1])], dim=-1).reshape(*h8.shape[:-1], 3, 3)


def _solve_normal_equations(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares h8 of A h8 = b through the 8x8 normal equations (fp32)."""
    At = A.transpose(-1, -2)
    return torch.linalg.solve(At @ A, (At @ b[..., None]))[..., 0]


def dlt_solve_4pt(src: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Exact 4-point DLT: src (..., 4, 2) and dst = src + offset -> H
    (..., 3, 3) with H[2, 2] = 1, by solving the square 8x8 system."""
    A, b = _dlt_system(src, src + offset)
    return _h8_to_matrix(torch.linalg.solve(A, b[..., None])[..., 0])


def _normalize_points(p: torch.Tensor):
    """Hartley normalization of (..., N, 2): translate to the centroid, scale
    the mean distance to sqrt(2).  Returns the points and T (..., 3, 3) with
    pn_hom = T p_hom."""
    c = p.mean(dim=-2, keepdim=True)
    d = torch.linalg.norm(p - c, dim=-1).mean(dim=-1)
    s = np.float32(np.sqrt(2.0)) / torch.clamp(d, min=1e-12)
    zeros, ones = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([torch.stack([s, zeros, -s * c[..., 0, 0]], dim=-1),
                     torch.stack([zeros, s, -s * c[..., 0, 1]], dim=-1),
                     torch.stack([zeros, zeros, ones], dim=-1)], dim=-2)
    return (p - c) * s[..., None, None], T


def homography_from_points(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares homography from N >= 4 correspondences (..., N, 2) by the
    normalized DLT (the drop-in for ``cv2.findHomography(src, dst)`` with
    method 0); scaled to H[2, 2] = 1."""
    src_n, T_src = _normalize_points(src)
    dst_n, T_dst = _normalize_points(dst)
    Hn = _h8_to_matrix(_solve_normal_equations(*_dlt_system(src_n, dst_n)))
    H = torch.linalg.inv(T_dst) @ Hn @ T_src
    return H / H[..., 2:3, 2:3]


def fit_homography_to_flow(flow: torch.Tensor) -> torch.Tensor:
    """One H per batch item fitted to a dense flow: (B, h, w, 2) -> (B, 3, 3)
    with H(x) ~= x + flow(x), least squares over every pixel through the 8x8
    normal equations in fp32, on coordinates normalized to [-1, 1] and
    un-normalized as T^-1 Hn T; scaled to H[2, 2] = 1.

    The JAX package solves G h8 = A^T b; this solves G d = A^T (b - A e)
    for d = h8 - e, e the identity's h8: the same least-squares solution,
    but the right-hand side is the (small) flow itself, so fp32 rounding of
    the ill-conditioned G costs error relative to the flow, not to the
    coordinates (at 256x256, 9.5e-3 px against the true flow in the JAX
    form, measured on the H100)."""
    B, h, w, _ = flow.shape
    grid = pixel_grid(h, w, dtype=flow.dtype, device=flow.device).reshape(1, -1, 2)
    T_np = np.array([[2.0 / max(w - 1, 1), 0.0, -1.0],
                     [0.0, 2.0 / max(h - 1, 1), -1.0],
                     [0.0, 0.0, 1.0]])
    scale = torch.tensor([T_np[0, 0], T_np[1, 1]], dtype=flow.dtype, device=flow.device)
    src_n = (grid * scale - 1.0).expand(B, h * w, 2)
    flow_n = flow.reshape(B, -1, 2) * scale  # b - A e, interleaved as b
    A, _ = _dlt_system(src_n, src_n + flow_n)
    e = torch.tensor([1.0, 0, 0, 0, 1.0, 0, 0, 0], dtype=flow.dtype, device=flow.device)
    Hn = _h8_to_matrix(e + _solve_normal_equations(A, flow_n.reshape(B, -1)))
    T = torch.as_tensor(T_np, dtype=flow.dtype, device=flow.device)
    Tinv = torch.as_tensor(np.linalg.inv(T_np), dtype=flow.dtype, device=flow.device)
    H = Tinv @ Hn @ T
    return H / H[..., 2:3, 2:3]
