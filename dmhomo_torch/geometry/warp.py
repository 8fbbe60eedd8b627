"""Dense warping / resampling on NHWC tensors (gather formulation).

Two bilinear boundary semantics, as in the reference:

* ``mode='border'``  - clamp the sample coordinates to the image, then
  bilinear (grid_sample(padding='border', align_corners=True)).
* ``mode='collapse'`` - the HEM ``_interpolate`` gather: coordinates are
  not clamped; the four tap indices are, and the interpolation weights come
  from the *clamped* tap positions against the raw coordinate, so samples
  outside the image fade to zero.  This is what the estimator uses.

Resizes follow torch ``F.interpolate`` semantics (align_corners=True
bilinear as two interpolation matrices; floor-scaled nearest with the
indices computed explicitly on the host), and cv2's half-pixel bilinear for
``resize_bilinear``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dmhomo_torch.geometry.grids import pixel_grid


def _taps_and_weights(hw, coords: torch.Tensor, mode: str, wdt):
    """Per-axis int64 taps (x0, x1, y0, y1) and weights (wx0, wx1, wy0, wy1)."""
    H, W = hw
    x = coords[..., 0]
    y = coords[..., 1]
    if mode == "border":
        x = x.clamp(0.0, W - 1.0)
        y = y.clamp(0.0, H - 1.0)
    elif mode != "collapse":
        raise ValueError(f"unknown mode {mode!r}")
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x0l = x0.long()
    y0l = y0.long()
    x0i = x0l.clamp(0, W - 1)
    x1i = (x0l + 1).clamp(0, W - 1)
    y0i = y0l.clamp(0, H - 1)
    y1i = (y0l + 1).clamp(0, H - 1)
    if mode == "border":
        # grid_sample semantics: weights from the unclamped tap positions
        x0f, x1f, y0f, y1f = x0, x0 + 1.0, y0, y0 + 1.0
    else:
        # weights from the clamped tap positions (zero-collapse outside)
        x0f, x1f, y0f, y1f = (t.to(wdt) for t in (x0i, x1i, y0i, y1i))
    return x0i, x1i, y0i, y1i, x1f - x, x - x0f, y1f - y, y - y0f


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    mode: str = "collapse") -> torch.Tensor:
    """Sample ``img`` (B, H, W, C) at pixel ``coords`` (B, h, w, 2) of (x, y).

    Returns (B, h, w, C), by four gathers of the flattened image.
    """
    B, H, W, C = img.shape
    _, h, w, _ = coords.shape
    x0i, x1i, y0i, y1i, wx0, wx1, wy0, wy1 = (
        t.reshape(B, -1) for t in _taps_and_weights((H, W), coords, mode, img.dtype))
    wa, wb = wx0 * wy0, wx0 * wy1
    wc, wd = wx1 * wy0, wx1 * wy1

    flat = img.reshape(B, H * W, C)

    def gather(idx):
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))

    out = (wa[..., None] * gather(y0i * W + x0i) + wb[..., None] * gather(y1i * W + x0i)
           + wc[..., None] * gather(y0i * W + x1i) + wd[..., None] * gather(y1i * W + x1i))
    return out.reshape(B, h, w, C)


def warp_by_flow(img: torch.Tensor, flow: torch.Tensor,
                 mode: str = "collapse") -> torch.Tensor:
    """Backward warp: out(x) = img(x + flow(x)).  img (B,H,W,C), flow (B,h,w,2)."""
    _, h, w, _ = flow.shape
    coords = pixel_grid(h, w, dtype=flow.dtype, device=flow.device)[None] + flow
    return bilinear_sample(img, coords, mode=mode)


@functools.lru_cache(maxsize=128)
def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) interpolation matrix for align_corners=True bilinear."""
    M = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1:
        M[0, 0] = 1.0
        return M
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = (src - lo).astype(np.float32)
    M[np.arange(n_out), lo] += 1.0 - frac
    M[np.arange(n_out), hi] += frac
    return M


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch F.interpolate(mode='bilinear', align_corners=True) on NHWC, as
    two separable interpolation-matrix products (full fp32 with TF32 off)."""
    _, H, W, _ = x.shape
    return _separable(x, _align_corners_matrix(H, out_hw[0]), _align_corners_matrix(W, out_hw[1]))


def _separable(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """Rows then columns of NHWC ``x`` through (oh, H) and (ow, W) matrices,
    in x.dtype with autocast off (coordinates and images stay fp32)."""
    Mh = torch.from_numpy(mh).to(x.device, x.dtype)
    Mw = torch.from_numpy(mw).to(x.device, x.dtype)
    with torch.autocast(x.device.type, enabled=False):
        y = torch.einsum("oh,bhwc->bowc", Mh, x)
        return torch.einsum("pw,bowc->bopc", Mw, y)


@functools.lru_cache(maxsize=128)
def _half_pixel_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix for half-pixel bilinear (cv2 INTER_LINEAR /
    align_corners=False), taps edge-clamped."""
    M = np.zeros((n_out, n_in), dtype=np.float32)
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    M[np.arange(n_out), np.clip(lo, 0, n_in - 1)] += 1.0 - frac
    M[np.arange(n_out), np.clip(lo + 1, 0, n_in - 1)] += frac
    return M


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Half-pixel bilinear resize on NHWC (cv2 INTER_LINEAR semantics for
    float inputs), as two separable interpolation-matrix products."""
    _, H, W, _ = x.shape
    return _separable(x, _half_pixel_matrix(H, out_hw[0]), _half_pixel_matrix(W, out_hw[1]))


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') on NHWC: src = floor(i * in/out),
    indices computed explicitly in float64 on the host."""
    _, H, W, _ = x.shape
    oh, ow = out_hw
    iy = np.clip(np.floor(np.arange(oh) * (H / oh)).astype(np.int64), 0, H - 1)
    ix = np.clip(np.floor(np.arange(ow) * (W / ow)).astype(np.int64), 0, W - 1)
    iy = torch.from_numpy(iy).to(x.device)
    ix = torch.from_numpy(ix).to(x.device)
    return x.index_select(1, iy).index_select(2, ix)


def upsample_flow_to(flow: torch.Tensor, out_hw) -> torch.Tensor:
    """Resize a flow (B, h, w, 2) with magnitude rescale: (u, v) is
    multiplied by (w_out/w_in, h_out/h_in) *before* the align-corners
    bilinear resize (``upsample2d_flow_as(..., if_rate=True)``)."""
    _, h, w, _ = flow.shape
    oh, ow = out_hw
    flow = flow * torch.tensor([ow / w, oh / h], dtype=flow.dtype, device=flow.device)
    return resize_bilinear_align_corners(flow, out_hw)
