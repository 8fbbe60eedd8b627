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
``resize_bilinear``.  The matrices and indices are copied to the device once
per (sizes, device, dtype) and kept there, so that a training step makes no
host-to-device copy (a copy from pageable memory waits for the stream, and a
CUDA graph cannot capture it).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dmhomo_torch.geometry.grids import pixel_grid
from dmhomo_torch.geometry.homography import homography_to_mapping


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


def warp_by_homography(img: torch.Tensor, H: torch.Tensor, mode: str = "collapse",
                       guard: str = "cond") -> torch.Tensor:
    """out(x) = img(H(x)).  img (B, H, W, C), H (B, 3, 3)."""
    _, hh, ww, _ = img.shape
    return bilinear_sample(img, homography_to_mapping(H, hh, ww, guard=guard), mode=mode)


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
    return _separable(x, out_hw, _align_corners_matrix)


@functools.lru_cache(maxsize=128)
def _device_matrix(matrix, n_in: int, n_out: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """``matrix(n_in, n_out)`` as a tensor on ``device``, copied there once
    (outside inference mode, so that autograd may save it later)."""
    with torch.inference_mode(False):
        return torch.from_numpy(matrix(n_in, n_out)).to(device, dtype)


def _separable(x: torch.Tensor, out_hw, matrix) -> torch.Tensor:
    """Rows then columns of NHWC ``x`` through the (oh, H) and (ow, W)
    matrices ``matrix`` gives, in x.dtype with autocast off (coordinates and
    images stay fp32)."""
    _, H, W, _ = x.shape
    Mh = _device_matrix(matrix, H, out_hw[0], x.device, x.dtype)
    Mw = _device_matrix(matrix, W, out_hw[1], x.device, x.dtype)
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
    return _separable(x, out_hw, _half_pixel_matrix)


@functools.lru_cache(maxsize=128)
def _nearest_index(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """floor(i * n_in / n_out) in float64 on the host, clipped; copied to
    ``device`` once (outside inference mode)."""
    idx = np.clip(np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64), 0, n_in - 1)
    with torch.inference_mode(False):
        return torch.from_numpy(idx).to(device)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') on NHWC: src = floor(i * in/out),
    indices computed explicitly in float64 on the host."""
    _, H, W, _ = x.shape
    oh, ow = out_hw
    return x.index_select(1, _nearest_index(H, oh, x.device)).index_select(
        2, _nearest_index(W, ow, x.device))


def upsample_flow_to(flow: torch.Tensor, out_hw, scale: bool = True) -> torch.Tensor:
    """Resize a flow (B, h, w, 2) by the align-corners bilinear resize; with
    ``scale`` (``upsample2d_flow_as(..., if_rate=True)``) (u, v) is first
    multiplied by (w_out/w_in, h_out/h_in).  Each rate multiplies its channel
    as a scalar, rounded to the flow's dtype as a rate tensor of that dtype
    would be (no copy to the device)."""
    if scale:
        _, h, w, _ = flow.shape
        oh, ow = out_hw
        rate = torch.tensor([ow / w, oh / h], dtype=flow.dtype).tolist()
        flow = torch.cat([flow[..., :1] * rate[0], flow[..., 1:] * rate[1]], dim=-1)
    return resize_bilinear_align_corners(flow, out_hw)
