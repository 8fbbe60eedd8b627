"""CAHomo point-matching error and scene-category reporting.

Per sample: the mean over 6 ground-truth point pairs of
  min(||dst - (src + flow_f[int(src_y), int(src_x)])||,
      ||src - (dst + flow_b[int(dst_y), int(dst_x)])||)
with the integer-truncated pixel lookup into the full-resolution flow.
Categories RE/LT/LL/SF/LF over the test video ids; AVG is the mean of the
category means.  ``seed_zero=True`` reproduces the reference eval's
spurious 0 element at the head of every category list.  The point errors
under a homography (``point_error_under_h``, ``_v2``) are the reference's
unused loss-side metrics.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from dmhomo_torch.geometry.homography import apply_homography

CATEGORY_NAMES = ("RE", "LT", "LL", "SF", "LF")

# CAHomo test split video ids per scene category (hem_evaluate.py lists)
TEST_CATEGORIES: Dict[str, tuple] = {
    "RE": ("0000011", "0000016", "00000147", "00000155", "00000158", "00000107",
           "00000239", "0000030"),
    "LT": ("0000038", "0000044", "0000046", "0000047", "00000238", "00000177",
           "00000188", "00000181"),
    "LL": ("0000085", "00000100", "0000091", "0000092", "00000216", "00000226"),
    "SF": ("00000244", "00000251", "0000026", "0000030", "0000034", "00000115"),
    "LF": ("00000104", "0000031", "0000035", "00000129", "00000141", "00000200"),
}

# the reference test() twin's lists: '0000030' only under SF
TEST_CATEGORIES_TESTFN: Dict[str, tuple] = {
    **TEST_CATEGORIES,
    "RE": ("0000011", "0000016", "00000147", "00000155", "00000158", "00000107",
           "00000239"),
}


def point_matching_error(pt_set: torch.Tensor, flow_f: torch.Tensor,
                         flow_b: torch.Tensor) -> torch.Tensor:
    """pt_set (B, 6, 2, 2) = [pair, (src, dst), (x, y)]; flows (B, H, W, 2)
    at full resolution.  Returns (B,) errors."""
    src = pt_set[:, :, 0, :]
    dst = pt_set[:, :, 1, :]
    B, H, W, _ = flow_f.shape
    rows = torch.arange(B, device=flow_f.device)[:, None]

    def lookup(flow, pts):
        x = pts[..., 0].to(torch.int64).clamp(0, W - 1)  # truncation toward zero
        y = pts[..., 1].to(torch.int64).clamp(0, H - 1)
        return flow[rows, y, x]  # (B, 6, 2)

    err_f = torch.linalg.vector_norm(dst - (src + lookup(flow_f, src)), dim=-1)
    err_b = torch.linalg.vector_norm(src - (dst + lookup(flow_b, dst)), dim=-1)
    return torch.minimum(err_f, err_b).mean(dim=1)


def bucket_by_category(errors: Sequence[float], video_names: Sequence[str],
                       categories: Dict[str, tuple] = TEST_CATEGORIES,
                       seed_zero: bool = False) -> Dict[str, list]:
    """Per-sample errors bucketed by video id."""
    buckets = {k: ([0.0] if seed_zero else []) for k in categories}
    for err, name in zip(errors, video_names):
        for cat, ids in categories.items():
            if name in ids:
                buckets[cat].append(float(err))
                break
    return buckets


def bucket_sums(buckets: Dict[str, list]) -> np.ndarray:
    """(5, 2) float32 per-category [sum, count]: one rank's share of an
    evaluation, summed over the ranks by ``HEMTrainer.evaluate``."""
    return np.asarray([[float(np.sum(buckets.get(c, []))), float(len(buckets.get(c, [])))]
                       for c in CATEGORY_NAMES], np.float32)


def merge_bucket_sums(gathered) -> Dict[str, list]:
    """Buckets from (n_ranks, 5, 2) or already summed (5, 2) [sum, count]
    rows, summed in float64: each category holds its global mean ``count``
    times, so that its mean and count are the unsharded evaluation's."""
    totals = np.asarray(gathered, np.float64).reshape(-1, len(CATEGORY_NAMES), 2).sum(axis=0)
    return {c: ([totals[i, 0] / totals[i, 1]] * int(totals[i, 1]) if totals[i, 1] else [])
            for i, c in enumerate(CATEGORY_NAMES)}


def category_report(buckets: Dict[str, list]) -> Dict[str, float]:
    """Per-category means + AVG (mean of the category means; empty categories
    report NaN and are left out of AVG)."""
    report = {}
    for cat in CATEGORY_NAMES:
        vals = buckets.get(cat, [])
        report[cat] = float(np.mean(vals)) if vals else float("nan")
    cats = [report[c] for c in CATEGORY_NAMES]
    report["AVG"] = float(np.nanmean(cats)) if not all(np.isnan(cats)) else float("nan")
    return report


def point_error_under_h(src: torch.Tensor, dst: torch.Tensor, H: torch.Tensor,
                        reproduce_axis_quirk: bool = False) -> torch.Tensor:
    """Per-point matching error under a homography (ComputeErrH_kornia,
    HEM/loss/losses.py:187-194): src, dst (B, N, 2) matched (x, y) points,
    H (B, 3, 3) -> (B, N) errors ||dst - H(src)||.

    The reference expression (dead code there) compares the warped x with
    *src* x; ``reproduce_axis_quirk=True`` keeps that, the default compares
    with dst x."""
    src_warp = apply_homography(H, src)
    ref_x = src if reproduce_axis_quirk else dst
    return torch.sqrt((src_warp[:, :, 0] - ref_x[:, :, 0]) ** 2
                      + (src_warp[:, :, 1] - dst[:, :, 1]) ** 2)


def point_error_under_h_v2(src: torch.Tensor, dst: torch.Tensor,
                           H: torch.Tensor) -> torch.Tensor:
    """One Frobenius error over all points of one sample (ComputeErrH_v2,
    HEM/loss/losses.py:196-205, dead code there): src, dst (N, 2), H (3, 3)
    -> 0-d ||dst - H(src)||_F."""
    src_warp = apply_homography(H[None], src[None])[0]
    return torch.sqrt(torch.sum((dst - src_warp) ** 2))
