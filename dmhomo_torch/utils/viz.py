"""Preview panels, image grids and image files (the JAX package's
``utils/viz.py``).

* :func:`sample_panel` - the reference's ``postProcess`` check panel
  (denoising_diffusion_pytorch.py:1505-1517): per sample, row 1 =
  [img1, img1, mask, flow_rgb], row 2 = [img2, warp(img2, flow), mask,
  flow_rgb], so that aligned columns match when a generation is
  consistent.  The warp and the flow colours are ``geometry/``'s, on the
  inputs' device.
* :func:`image_grid` - a square grid of images, as torchvision's
  ``save_image`` lays them out.
* :func:`save_png` - an 8-bit image file whose format follows the path's
  extension, as PIL's ``save`` does for the JAX package: ``.jpg`` /
  ``.jpeg`` a baseline JPEG at quality 75 (``utils/codecs.py``), anything
  else an RGB PNG written with the standard library (``zlib``,
  ``struct``: one filter byte (0) per row, one IDAT chunk).
* :func:`save_flip_gif` - the reference's two-frame warp-consistency flip
  GIF (``make_gif``, denoising_diffusion_pytorch.py:1543-1555,
  HEM/model/utils.py:575-583), written by ``utils/codecs.py``; the delay is
  0.5 s, written as 50 hundredths (the JAX call's ``duration=0.5`` reaches
  the file as 0 under imageio's pillow plugin, which takes milliseconds).
* :func:`vis_bad_case` and :func:`warp_check_gif` - the debugging dumps of
  a generation and of a generated shard's first pair.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from dmhomo_torch.utils.codecs import gif_bytes, jpeg_bytes


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
    """Write ``image01`` ((H, W, 3) in [0, 1]) to ``path`` (its directory
    made): a JPEG for a ``.jpg`` / ``.jpeg`` path, else :func:`png_bytes`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    jpeg = os.path.splitext(path)[1].lower() in (".jpg", ".jpeg")
    with open(path, "wb") as f:
        f.write(jpeg_bytes(image01) if jpeg else png_bytes(image01))


def save_flip_gif(path: str, frames01: Sequence[np.ndarray], duration: float = 0.5) -> None:
    """Frames (H, W, 3) in [0, 1] as a looping GIF, ``duration`` seconds a
    frame (written in hundredths)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = [(np.clip(np.asarray(f), 0, 1) * 255).astype(np.uint8) for f in frames01]
    with open(path, "wb") as f:
        f.write(gif_bytes(frames, delay_cs=int(round(duration * 100)), loop=0))


def vis_bad_case(path_dir: str, imgs6, flow, motion: float, duration: float = 0.5) -> str:
    """The dump of a rejected or extreme generation
    (GaussianDiffusion.vis_bad_case, classifier_free_guidance.py:753-768):
    the batch's first sample as a flip GIF, frame 1 = [img1 | img1], frame 2
    = [img2 | warp(img2, flow)] (border warp on the inputs' device), written
    as ``badcase_{motion}.gif`` under ``path_dir``; returns its path."""
    from dmhomo_torch.geometry.warp import warp_by_flow

    imgs6 = torch.as_tensor(imgs6, dtype=torch.float32)
    flow = torch.as_tensor(flow, dtype=torch.float32, device=imgs6.device)
    img1, img2 = imgs6[:1, ..., :3], imgs6[:1, ..., 3:]
    warp = warp_by_flow(img2, flow[:1], mode="border")
    f1 = torch.cat([img1[0], img1[0]], dim=1).cpu().numpy()
    f2 = torch.cat([img2[0], warp[0]], dim=1).cpu().numpy()
    path = os.path.join(path_dir, f"badcase_{motion}.gif")
    save_flip_gif(path, [f1, f2], duration)
    return path


def warp_perspective(img: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """cv2.warpPerspective(img, H, (w, h)) with its defaults: bilinear,
    dst(p) = img(H^-1 p), 0 outside.  img (B, h, w, C), H (B, 3, 3).  The
    image gets a ring of zeros, so that a sample between the border and
    the outside blends with 0 as cv2's constant border does; ``collapse``
    sampling (0 beyond the ring) on the port's warp."""
    from dmhomo_torch.geometry.homography import homography_to_mapping
    from dmhomo_torch.geometry.warp import bilinear_sample

    _, h, w, _ = img.shape
    coords = homography_to_mapping(torch.linalg.inv(H.double()).float(), h, w, guard="cond") + 1.0
    return bilinear_sample(torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1)), coords,
                           mode="collapse")


def warp_check_gif(path: str, img12_u8_chw, homo, duration: float = 0.5,
                   device=None) -> str:
    """A generated pair's warp-consistency flip GIF
    (generate_nyps_to_single_case.py:8-19): frame 1 = [img1 | warp(img1,
    H)], frame 2 = [img2 | img2]; the right half holds still while flipping
    when the generation is consistent.  img12 (6, S, S) uint8, homo (3, 3);
    the warp runs on ``device`` (default the inputs' CPU tensors)."""
    img12 = torch.as_tensor(np.asarray(img12_u8_chw), device=device).permute(1, 2, 0).float()
    img1, img2 = img12[..., :3], img12[..., 3:]
    H = torch.as_tensor(np.asarray(homo, np.float64), device=img12.device)
    warp = warp_perspective(img1[None], H[None])[0]
    f1 = (torch.cat([img1, warp], dim=1) / 255.0).cpu().numpy()
    f2 = (torch.cat([img2, img2], dim=1) / 255.0).cpu().numpy()
    save_flip_gif(path, [f1, f2], duration)
    return path
