"""Preview panels, image grids and PNG files (the JAX package's
``utils/viz.py``).

* :func:`sample_panel` - the reference's ``postProcess`` check panel
  (denoising_diffusion_pytorch.py:1505-1517): per sample, row 1 =
  [img1, img1, mask, flow_rgb], row 2 = [img2, warp(img2, flow), mask,
  flow_rgb], so that aligned columns match when a generation is
  consistent.  The warp and the flow colours are ``geometry/``'s, on the
  inputs' device.
* :func:`image_grid` - a square grid of images, as torchvision's
  ``save_image`` lays them out.
* :func:`save_png` - an 8-bit RGB PNG written with the standard library
  (``zlib``, ``struct``): one filter byte (0) per row, one IDAT chunk.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch


def sample_panel(imgs6, mask, flow) -> np.ndarray:
    """imgs6 (B, H, W, 6) in [0, 1], mask (B, H, W, 1), flow (B, H, W, 2),
    arrays or tensors -> (B, 2H, 4W, 3) float32 in [0, 1]."""
    from dmhomo_torch.geometry.flow_viz import flow_to_rgb
    from dmhomo_torch.geometry.warp import warp_by_flow

    imgs6 = torch.as_tensor(imgs6, dtype=torch.float32)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=imgs6.device)
    flow = torch.as_tensor(flow, dtype=torch.float32, device=imgs6.device)
    img1, img2 = imgs6[..., :3], imgs6[..., 3:]
    warp = warp_by_flow(img2, flow, mode="border")
    flow_rgb = flow_to_rgb(flow)
    mask3 = mask.expand(*mask.shape[:-1], 3)
    row1 = torch.cat([img1, img1, mask3, flow_rgb], dim=2)
    row2 = torch.cat([img2, warp, mask3, flow_rgb], dim=2)
    return torch.clamp(torch.cat([row1, row2], dim=1), 0, 1).cpu().numpy()


def image_grid(images: np.ndarray, nrow: Optional[int] = None, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) -> one (gh*H', gw*W', C) grid image, the gaps white (1)."""
    n, h, w, c = images.shape
    nrow = nrow or int(np.ceil(np.sqrt(n)))
    ncol = int(np.ceil(n / nrow))
    grid = np.ones((ncol * (h + pad) - pad, nrow * (w + pad) - pad, c), images.dtype)
    for i in range(n):
        r, cl = divmod(i, nrow)
        grid[r * (h + pad):r * (h + pad) + h, cl * (w + pad):cl * (w + pad) + w] = images[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(image01: np.ndarray) -> bytes:
    """(H, W, 3) values in [0, 1] as an 8-bit RGB PNG file's bytes (the
    values quantised as the JAX package quantises them for PIL)."""
    img = np.asarray(image01)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"an RGB PNG takes an (H, W, 3) image, got {img.shape}")
    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w, _ = u8.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), u8.reshape(h, 3 * w)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, truecolour, no interlace
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path: str, image01: np.ndarray) -> None:
    """Write :func:`png_bytes` of ``image01`` to ``path`` (its directory made)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(image01))
