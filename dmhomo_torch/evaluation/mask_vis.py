"""Qualitative mask / alignment dumps of HEM evaluation (the JAX package's
``evaluation/mask_vis.py``; reference ``HEM/evaluate.py::mask_vis``,
:165-329).

* :func:`mask_vis_categories` - per CAHomo test pair whose video falls in a
  scene category, up to a cap per category: the RGB pair as JPEGs, the two
  masks as jet heatmaps over an image, and a 4-panel flip GIF [im1 |
  im1 remapped by flow_b | heat1 | heat2] against [im2 | im2 | heat1 |
  heat2], under ``out_dir/<category>/``;
* :func:`mask_vis` - the light gray-only variant for in-training checks.

The warps (``collapse`` for the remap, ``border`` for the gray panel) run
on ``geometry/`` on the caller's device; the heatmaps use :data:`JET_LUT`,
matplotlib's ``cm.jet`` lookup rebuilt from its public segment table.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from dmhomo_torch.evaluation.metrics import TEST_CATEGORIES
from dmhomo_torch.utils.viz import save_flip_gif, save_png

# matplotlib's _jet_data: per channel, (x, y_left, y_right) breakpoints
_JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
JET_N = 256


def _segment_lut(data, n: int) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` for one channel (gamma 1)."""
    a = np.asarray(data, dtype=np.float64)
    x, y0, y1 = a[:, 0], a[:, 1], a[:, 2]
    xind = np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_LUT = np.stack([_segment_lut(_JET_SEGMENTS[c], JET_N) for c in ("red", "green", "blue")],
                   axis=-1)  # (256, 3)


def jet(values01: np.ndarray) -> np.ndarray:
    """``cm.jet(v)[..., :3]`` for v in [0, 1]: entry floor(v N), N - 1 at 1."""
    xa = np.array(values01, dtype=np.float32) * np.float32(JET_N)
    xa[xa == JET_N] = JET_N - 1
    return JET_LUT[np.clip(xa.astype(int), 0, JET_N - 1)]


def _jet_overlay(base01: np.ndarray, heat01: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """A heatmap (..., 1) over a gray or RGB image (show_cam_on_image-style)."""
    heat_rgb = jet(np.clip(heat01.squeeze(-1), 0, 1))
    base = np.clip(base01, 0, 1)
    if base.shape[-1] == 1:
        base = np.repeat(base, 3, axis=-1)
    return np.clip((1 - alpha) * base + alpha * heat_rgb, 0, 1)


def _warp(img: np.ndarray, flow: np.ndarray, mode: str, device) -> np.ndarray:
    from dmhomo_torch.geometry.warp import warp_by_flow

    t = torch.as_tensor(np.asarray(img, np.float32), device=device)
    f = torch.as_tensor(np.asarray(flow, np.float32), device=device)
    return warp_by_flow(t, f, mode=mode).cpu().numpy()


def mask_vis(batch: Dict[str, np.ndarray], outputs: Dict[str, np.ndarray], out_dir: str,
             prefix: str = "val", max_items: int = 4, device=None) -> list:
    """Gray alignment and fusion-mask panels for a CAHomo eval batch.

    batch: imgs_gray_full (B, H, W, 2); outputs: full-resolution flow_f,
    mask_fusion.  Writes ``{prefix}_{i}_mask.png`` and ``{prefix}_{i}_align.gif``;
    returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    g = np.asarray(batch["imgs_gray_full"])
    g1, g2 = g[..., :1], g[..., 1:2]
    mask = np.asarray(outputs.get("mask_fusion", np.ones_like(g1)))
    lo, hi = g.min(), g.max()
    g1d = (g1 - lo) / max(hi - lo, 1e-6)
    g2d = (g2 - lo) / max(hi - lo, 1e-6)
    warp = _warp(g2d, outputs["flow_f"], "border", device)
    paths = []
    for i in range(min(len(g1), max_items)):
        heat = _jet_overlay(g1d[i], mask[i])
        panel1 = np.concatenate([np.repeat(g1d[i], 3, -1), heat], axis=1)
        panel2 = np.concatenate([np.repeat(warp[i], 3, -1), heat], axis=1)
        png = os.path.join(out_dir, f"{prefix}_{i}_mask.png")
        gif = os.path.join(out_dir, f"{prefix}_{i}_align.gif")
        save_png(png, panel1)
        save_flip_gif(gif, [panel1, panel2])
        paths += [png, gif]
    return paths


def mask_vis_categories(batch: Dict[str, np.ndarray], outputs: Dict[str, np.ndarray],
                        out_dir: str, counts: Optional[Dict[str, int]] = None,
                        per_category_cap: int = 50, device=None) -> list:
    """Reference-format per-category dumps (HEM/evaluate.py:165-329).

    batch: imgs_rgb_full (B, H, W, 6) in [0, 1], video_names, optionally
    save_names; outputs (full resolution): flow_b, mask_f, mask_b.
    ``counts`` carries the per-category count across batches (updated in
    place).  Returns the paths written."""
    counts = counts if counts is not None else {}
    rgb = np.asarray(batch["imgs_rgb_full"])
    names = batch["video_names"]
    save_names = batch.get("save_names", [f"{n}_{i}" for i, n in enumerate(names)])
    im1, im2 = rgb[..., :3], rgb[..., 3:]
    # im1 remapped by flow_b: the reference's get_warp_flow (collapse)
    im1_remap = _warp(im1, outputs["flow_b"], "collapse", device)

    def norm_mask(m):  # (m / (max(m) * 0.5)).clamp(0, 1)  (ref :269-270)
        return np.clip(m / max(float(m.max()) * 0.5, 1e-6), 0, 1)

    paths = []
    for i, vid in enumerate(names):
        cat = next((c for c, ids in TEST_CATEGORIES.items() if vid in ids), None)
        if cat is None:
            continue
        counts[cat] = counts.get(cat, 0) + 1
        if counts[cat] >= per_category_cap:
            continue
        heat1 = _jet_overlay(im1_remap[i], norm_mask(np.asarray(outputs["mask_f"][i])))
        heat2 = _jet_overlay(im2[i], norm_mask(np.asarray(outputs["mask_b"][i])))
        stem = os.path.join(out_dir, cat, str(save_names[i]))
        save_png(f"{stem}_img1.jpg", im1[i])
        save_png(f"{stem}_img2.jpg", im2[i])
        save_png(f"{stem}_mask_1.jpg", heat1)
        save_png(f"{stem}_mask_2.jpg", heat2)
        frame1 = np.concatenate([im1[i], im1_remap[i], heat1, heat2], axis=1)
        frame2 = np.concatenate([im2[i], im2[i], heat1, heat2], axis=1)
        save_flip_gif(f"{stem}.gif", [np.clip(frame1, 0, 1), np.clip(frame2, 0, 1)])
        paths += [f"{stem}_img1.jpg", f"{stem}_img2.jpg",
                  f"{stem}_mask_1.jpg", f"{stem}_mask_2.jpg", f"{stem}.gif"]
    return paths
