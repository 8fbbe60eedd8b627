"""HEM data: the generated training set, synthetic pairs and the CAHomo
test split.

* :class:`HEMTrainDataset` - per-sample npys of the generated training set.
  By default (``device_pipeline=True``) each sample is the raw uint8 pair,
  its homography (and inverse) at the training resolution and a random crop
  start, and :func:`device_build_patches` turns a batch of them into the
  training batch on the device (resize, gray normalization, GT flows,
  crops).  With ``device_pipeline=False`` the host builds the patch schema
  itself (the JAX package's host pipeline: a fixed-point uint8 resize,
  gray normalization and float64 flows by the native kernels, the crops,
  and unless ``minimal`` the full-resolution extras).
* :class:`SyntheticHomoPairs` - random textures and their warps by random
  homographies, with exact GT flows, optionally with an independently moving
  rectangle (``outlier_frac``) whose labels follow the global H or its own
  motion (``label_outliers``): no disk, numpy only (no OpenCV).
* :class:`CAHomoTestDataset` - the CAHomo test split.  Layout of
  ``data_dir``: ``test.txt`` (one "video/img1 video/img2" pair per line),
  ``img/`` and ``pt/<img1>_<img2>.npy`` with the matched points.  Samples
  carry what the eval path reads: the NHWC float32 gray patch pair, the
  matched points and the video id.
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Optional

import numpy as np
import torch

from dmhomo_torch.data.shards import load_sample
from dmhomo_torch.geometry.homography import dlt_solve_4pt, homography_to_flow
from dmhomo_torch.geometry.host import (
    homography_to_flow_np,
    homography_to_mapping_np,
    rescale_homography_np,
)
from dmhomo_torch.geometry.warp import resize_bilinear

MEAN_I = np.array([118.93, 113.97, 102.60], np.float64).reshape(1, 1, 3)
STD_I = np.array([69.85, 68.81, 72.45], np.float64).reshape(1, 1, 3)


def normalize_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8/float -> (H, W, 1) normalized grayscale, in float64
    then rounded to float32, by the native kernel (``dmhomo_torch/native``)."""
    from dmhomo_torch import native

    return native.normalize_gray(img, MEAN_I, STD_I)


def normalize_gray_plain(img: np.ndarray) -> np.ndarray:
    """The numpy version of :func:`normalize_gray`."""
    x = (np.asarray(img, np.float64) - MEAN_I) / STD_I
    return np.mean(x, axis=2, keepdims=True).astype(np.float32)


RESIZE_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_u8_taps(n_in: int, n_out: int):
    """Per output pixel: the two source taps and their fixed-point weights
    (sum 2^11) of a half-pixel bilinear resize, as OpenCV computes them for
    uint8: the position in float32, taps past an edge clamped to it."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    lo = np.floor(f).astype(np.int64)
    f = f - lo.astype(np.float32)
    edge = (lo < 0) | (lo >= n_in - 1)
    f[edge] = 0.0
    lo = np.clip(lo, 0, n_in - 1)
    one = 1 << RESIZE_COEF_BITS
    return (lo, np.minimum(lo + 1, n_in - 1), np.rint((np.float32(1) - f) * one).astype(np.int64),
            np.rint(f * one).astype(np.int64))


def resize_linear_u8(img: np.ndarray, out_hw) -> np.ndarray:
    """(H, W, C) uint8 -> (oh, ow, C) uint8: cv2.resize's INTER_LINEAR on
    uint8 in fixed point: 11-bit weights, the rows first into integers, then
    the columns with OpenCV's vectorized rounding (within one grey level of
    OpenCV, whose scalar tail rounds once at the end)."""
    x0, x1, a0, a1 = _linear_u8_taps(img.shape[1], out_hw[1])
    y0, y1, b0, b1 = _linear_u8_taps(img.shape[0], out_hw[0])
    im = np.asarray(img).astype(np.int64)
    rows = (im[:, x0] * a0[None, :, None] + im[:, x1] * a1[None, :, None]) >> 4
    out = ((b0[:, None, None] * rows[y0]) >> 16) + ((b1[:, None, None] * rows[y1]) >> 16)
    return ((out + 2) >> 2).clip(0, 255).astype(np.uint8)


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 in cv2.imread's BGR order: a PNG by
    ``utils/codecs.py::read_png`` (no OpenCV), any other format by OpenCV,
    imported here (the card's machine has none)."""
    if path.lower().endswith(".png"):
        from dmhomo_torch.utils.codecs import read_png

        return np.ascontiguousarray(read_png(path)[..., ::-1])
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


class CAHomoTestDataset:
    """CAHomo test split: image pairs + 6 ground-truth matched points each,
    the items the JAX package's dataset gives (gray patch and full images,
    the BGR pair in [0, 1], the points, the video name).  PNG pairs need no
    OpenCV (:func:`read_image`); the resize is ``geometry/warp.py``'s
    half-pixel bilinear (cv2.resize's INTER_LINEAR) on the CPU."""

    def __init__(self, data_dir: str, crop_size=(320, 576)):
        self.data_dir = data_dir
        self.crop_size = tuple(crop_size)
        with open(os.path.join(data_dir, "test.txt")) as f:
            self.pairs = [ln.strip() for ln in f if ln.strip()]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        from dmhomo_torch.geometry.warp import resize_bilinear

        line = self.pairs[idx]
        video_name = line.split("/")[0]
        names = line.split(" ")
        pt_name = names[0].split("/")[-1] + "_" + names[1].split("/")[-1] + ".npy"
        img1 = read_image(os.path.join(self.data_dir, "img", names[0]))
        img2 = read_image(os.path.join(self.data_dir, "img", names[1]))
        # the point files are pickled dicts written by the dataset's authors
        pt = np.load(os.path.join(self.data_dir, "pt", pt_name), allow_pickle=True).item()
        pt_set = np.asarray(pt["matche_pts"][:6], np.float32)  # (6, 2, 2)

        g = np.stack([normalize_gray(img1), normalize_gray(img2)])
        with torch.no_grad():
            patch = resize_bilinear(torch.from_numpy(g[..., 0]).permute(1, 2, 0)[None],
                                    self.crop_size)[0].numpy()
        return {
            "imgs_gray_full": np.concatenate([g[0], g[1]], axis=2),
            "imgs_gray_patch": patch,
            "imgs_rgb_full": np.concatenate([img1, img2], axis=2).astype(np.float32) / 255.0,
            "pt_set": pt_set,
            "video_names": video_name,
            "ganhomo_mask": np.ones((img1.shape[0], img1.shape[1], 1), np.float32),
        }


@functools.lru_cache(maxsize=None)
def _gray_stats(device: torch.device):
    """MEAN_I and STD_I as fp32 tensors on ``device``, copied there once (a
    copy per batch would make the training step wait for it), made outside
    inference mode."""
    with torch.inference_mode(False):
        return (torch.tensor(MEAN_I.ravel(), dtype=torch.float32, device=device),
                torch.tensor(STD_I.ravel(), dtype=torch.float32, device=device))


def device_build_patches(img12_u8: torch.Tensor, homo: torch.Tensor, homo_inv: torch.Tensor,
                         start: torch.Tensor, crop_size, ori_size) -> dict:
    """The training batch from raw samples, on their device.

    img12_u8 (B, 6, S, S) uint8; homo / homo_inv (B, 3, 3) at ori_size;
    start (B, 2) integer (x, y) crop corners.  Half-pixel bilinear resize to
    ori_size, gray normalization in fp32, dense GT flows from H and H^-1
    (eps 1e-8), and the crops: ``imgs_gray_patch`` (B, ph, pw, 2) and
    ``flow_gt_patch`` (B, ph, pw, 4) = (backward, forward).
    """
    ph, pw = crop_size
    oh, ow = ori_size
    imgs = img12_u8.permute(0, 2, 3, 1).float()  # (B, S, S, 6)
    if tuple(imgs.shape[1:3]) != (oh, ow):
        imgs = resize_bilinear(imgs, (oh, ow))
    mean, std = _gray_stats(imgs.device)
    gray = torch.cat([((imgs[..., :3] - mean) / std).mean(-1, keepdim=True),
                      ((imgs[..., 3:] - mean) / std).mean(-1, keepdim=True)], dim=-1)
    flows = torch.cat([homography_to_flow(homo_inv.float(), oh, ow, eps=1e-8),
                       homography_to_flow(homo.float(), oh, ow, eps=1e-8)], dim=-1)
    start = start.to(imgs.device, torch.long)
    rows = (start[:, 1:2] + torch.arange(ph, device=imgs.device))[:, :, None]
    cols = (start[:, 0:1] + torch.arange(pw, device=imgs.device))[:, None, :]
    b = torch.arange(imgs.shape[0], device=imgs.device)[:, None, None]
    return {"imgs_gray_patch": gray[b, rows, cols], "flow_gt_patch": flows[b, rows, cols]}


class HEMTrainDataset:
    """Generated-pair training set over per-sample npys (sorted, the first
    ``limit`` when given), crop starts drawn inside a ``rho`` margin.

    ``device_pipeline=True`` (the port's trainer consumes this): the raw
    schema that :func:`device_build_patches` takes: ``img12`` (6, S, S)
    uint8, ``homo`` / ``homo_inv`` (3, 3) float32 at ori_size, ``start`` (2,)
    int32 (x, y).  ``device_pipeline=False``: the patch schema built on the
    host, ``imgs_gray_patch`` (ph, pw, 2), ``flow_gt_patch`` (ph, pw, 4) =
    (backward, forward), ``start`` (2,) float32, and unless ``minimal`` the
    full-resolution ``imgs_gray_full``, ``flow_gt_full``, ``imgs_rgb_full``
    and a ``ganhomo_mask`` of ones."""

    def __init__(self, samples_dir: str, crop_size=(320, 576), ori_size=(360, 640),
                 rho: int = 16, rng: Optional[np.random.Generator] = None,
                 limit: Optional[int] = None, minimal: bool = False,
                 device_pipeline: bool = True):
        self.paths = sorted(glob.glob(os.path.join(samples_dir, "*.npy")))
        if limit:
            self.paths = self.paths[:limit]
        self.crop_size = tuple(crop_size)
        self.ori_size = tuple(ori_size)
        # clamp the crop margin so small geometries stay valid
        max_rho = min((ori_size[0] - crop_size[0]) // 2, (ori_size[1] - crop_size[1]) // 2)
        self.rho = max(0, min(rho, max_rho))
        self.rng = rng or np.random.default_rng()
        self.minimal = minimal
        self.device_pipeline = device_pipeline

    def __len__(self):
        return len(self.paths)

    def _start(self):
        oh, ow = self.ori_size
        ph, pw = self.crop_size
        x = int(self.rng.integers(self.rho, ow - self.rho - pw + 1))
        y = int(self.rng.integers(self.rho, oh - self.rho - ph + 1))
        return x, y

    def __getitem__(self, idx):
        buf = load_sample(self.paths[idx])
        img12 = buf["img12"]
        homo = np.asarray(buf["homo12"], np.float64)
        oh, ow = self.ori_size
        ph, pw = self.crop_size
        h, w = img12.shape[1:]
        H = homo if (h, w) == (oh, ow) else rescale_homography_np(homo, (h, w), (oh, ow))
        if self.device_pipeline:
            x, y = self._start()
            return {
                "img12": img12,
                "homo": H.astype(np.float32),
                "homo_inv": np.linalg.inv(H).astype(np.float32),
                "start": np.asarray([x, y], np.int32),
            }
        img1, img2 = img12[:3].transpose(1, 2, 0), img12[3:].transpose(1, 2, 0)
        if (h, w) != (oh, ow):
            img1, img2 = resize_linear_u8(img1, (oh, ow)), resize_linear_u8(img2, (oh, ow))
        g1, g2 = normalize_gray(img1), normalize_gray(img2)
        x, y = self._start()
        flow_f = homography_to_flow_np(H, oh, ow, eps=1e-8)
        flow_b = homography_to_flow_np(np.linalg.inv(H), oh, ow, eps=1e-8)
        out = {
            "imgs_gray_patch": np.concatenate([g1[y:y + ph, x:x + pw], g2[y:y + ph, x:x + pw]],
                                              axis=2),
            "flow_gt_patch": np.concatenate(
                [flow_b[y:y + ph, x:x + pw], flow_f[y:y + ph, x:x + pw]], axis=2),
            "start": np.asarray([x, y], np.float32),
        }
        if self.minimal:
            return out
        out.update({
            "imgs_gray_full": np.concatenate([g1, g2], axis=2),
            "flow_gt_full": np.concatenate([flow_b, flow_f], axis=2),
            "imgs_rgb_full": np.concatenate([img1, img2], axis=2).astype(np.float32) / 255.0,
            "ganhomo_mask": np.ones((ph, pw, 1), np.float32),
        })
        return out


@functools.lru_cache(maxsize=16)
def _cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bicubic resize matrix: cv2 INTER_CUBIC (A = -0.75,
    half-pixel centres, taps clamped to the border)."""
    A = -0.75
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    lo = np.floor(src).astype(np.int64)
    t = src - lo
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    w2 = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    M = np.zeros((n_out, n_in))
    rows = np.arange(n_out)
    for k, wk in enumerate((w0, w1, w2, 1.0 - w0 - w1 - w2)):
        np.add.at(M, (rows, np.clip(lo + k - 1, 0, n_in - 1)), wk)
    return M


def resize_cubic_np(img: np.ndarray, out_hw) -> np.ndarray:
    """(H, W, C) float32 -> (oh, ow, C) float32, cv2 INTER_CUBIC semantics."""
    y = np.tensordot(_cubic_matrix(img.shape[0], out_hw[0]), img, axes=(1, 0))
    y = np.tensordot(_cubic_matrix(img.shape[1], out_hw[1]), y, axes=(1, 1))
    return y.transpose(1, 0, 2).astype(np.float32)


def remap_bilinear_np(img: np.ndarray, mapping: np.ndarray) -> np.ndarray:
    """img (H, W, C) float32 sampled at mapping (h, w, 2) = (x, y) by fp32
    bilinear interpolation with taps clamped to the border: cv2.remap with
    INTER_LINEAR and BORDER_REPLICATE on a float image (OpenCV releases
    that round the positions to 1/32 pixel differ by that rounding)."""
    H, W = img.shape[:2]
    x, y = mapping[..., 0], mapping[..., 1]
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = (x - x0)[..., None], (y - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    x0c, x1c = np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1)
    y0c, y1c = np.clip(y0, 0, H - 1), np.clip(y0 + 1, 0, H - 1)
    top = img[y0c, x0c] + fx * (img[y0c, x1c] - img[y0c, x0c])
    bottom = img[y1c, x0c] + fx * (img[y1c, x1c] - img[y1c, x0c])
    return top + fy * (bottom - top)


class SyntheticHomoPairs:
    """Random-texture pairs under known homographies (no disk), in the
    schema of the JAX package's ``SyntheticHomoPairs``: img2 is img1 warped
    by H (corner offsets up to ``max_offset`` px) plus Gaussian noise of
    ``noise`` * 255, so the GT flows are exact.

    ``outlier_frac`` > 0 moves a rectangle of that share of the image area
    in img2 by an independent shift (an object that breaks the global H).
    Its GT flows stay the H flows unless ``label_outliers``, which makes
    them the rectangle's own motion, as a dense-flow fit would label it, and
    zeroes ``inlier_mask_full`` over the rectangle dilated by 12 px.

    The random draws come in the JAX version's order from
    ``default_rng(seed * 100003 + idx)``: the homographies, rectangles and
    flows are the same; the images differ from OpenCV's by float rounding
    only.
    """

    MAX_OFFSET = 8.0
    NOISE = 0.01
    OUTLIER_PAD = 12  # px of the inlier mask's exclusion band around the rectangle

    def __init__(self, n: int = 64, crop_size=(320, 576), ori_size=(360, 640), rho: int = 16,
                 max_offset: float = MAX_OFFSET, seed: int = 0, noise: float = NOISE,
                 outlier_frac: float = 0.0, label_outliers: bool = False):
        self.n = n
        self.crop_size = tuple(crop_size)
        self.ori_size = tuple(ori_size)
        self.rho = rho
        self.max_offset = max_offset
        self.noise = noise
        self.seed = seed
        self.outlier_frac = outlier_frac
        self.label_outliers = label_outliers

    def __len__(self):
        return self.n

    def _random_homography(self, rng, h, w) -> np.ndarray:
        corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float32)
        off = rng.uniform(-self.max_offset, self.max_offset, (4, 2)).astype(np.float32)
        H = dlt_solve_4pt(torch.from_numpy(corners[None]), torch.from_numpy(off[None]))[0]
        return H.numpy().astype(np.float64)

    def _move_outlier(self, rng, img2, flow_f, flow_b, inlier) -> None:
        """Copy a rectangle of img2 from a shifted place (in place); with
        ``label_outliers`` its flows take that shift and the inlier mask
        excludes it."""
        oh, ow = self.ori_size
        area = self.outlier_frac * oh * ow
        rh = int(np.sqrt(area * rng.uniform(0.5, 2.0)))
        rw = max(int(area / max(rh, 1)), 8)
        rh = min(max(rh, 8), oh // 2)
        rw = min(rw, ow // 2)
        ry = int(rng.integers(0, oh - rh))
        rx = int(rng.integers(0, ow - rw))
        dy = int(rng.integers(-rh // 2, rh // 2 + 1))
        dx = int(rng.integers(-rw // 2, rw // 2 + 1))
        sy = np.clip(ry + dy, 0, oh - rh)
        sx = np.clip(rx + dx, 0, ow - rw)
        img2[ry:ry + rh, rx:rx + rw] = img2[sy:sy + rh, sx:sx + rw]
        if self.label_outliers:
            # content at q in the rectangle came from q + (s - r): it moved
            # by the H flow plus (r - s)
            ddx, ddy = float(rx - sx), float(ry - sy)
            flow_f[ry:ry + rh, rx:rx + rw] += (ddx, ddy)
            flow_b[ry:ry + rh, rx:rx + rw] -= (ddx, ddy)
            pad = self.OUTLIER_PAD
            inlier[max(ry - pad, 0):min(ry + rh + pad, oh),
                   max(rx - pad, 0):min(rx + rw + pad, ow)] = 0.0

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        oh, ow = self.ori_size
        small = rng.uniform(0, 255, (oh // 8, ow // 8, 3)).astype(np.float32)
        img1 = np.clip(resize_cubic_np(small, (oh, ow)), 0, 255)
        homo = self._random_homography(rng, oh, ow)
        homo_inv = np.linalg.inv(homo)
        # a feature at x in img1 sits at H(x) in img2: img2(y) = img1(H^-1 y)
        img2 = remap_bilinear_np(img1, homography_to_mapping_np(homo_inv, oh, ow, eps=1e-8))
        img2 = np.clip(img2 + rng.normal(0, self.noise * 255, img2.shape), 0, 255)
        flow_f = homography_to_flow_np(homo, oh, ow, eps=1e-8)
        flow_b = homography_to_flow_np(homo_inv, oh, ow, eps=1e-8)
        inlier = np.ones((oh, ow, 1), np.float32)
        if self.outlier_frac > 0:
            self._move_outlier(rng, img2, flow_f, flow_b, inlier)
        g1 = normalize_gray(img1)
        g2 = normalize_gray(img2)
        ph, pw = self.crop_size
        x = int(rng.integers(self.rho, ow - self.rho - pw + 1))
        y = int(rng.integers(self.rho, oh - self.rho - ph + 1))
        return {
            "inlier_mask_full": inlier,
            "imgs_gray_full": np.concatenate([g1, g2], axis=2),
            "imgs_gray_patch": np.concatenate([g1[y:y + ph, x:x + pw], g2[y:y + ph, x:x + pw]],
                                              axis=2),
            "flow_gt_full": np.concatenate([flow_b, flow_f], axis=2),
            "flow_gt_patch": np.concatenate(
                [flow_b[y:y + ph, x:x + pw], flow_f[y:y + ph, x:x + pw]], axis=2),
            "start": np.asarray([x, y], np.float32),
            "imgs_rgb_full": np.concatenate([img1, img2], axis=2).astype(np.float32) / 255.0,
            "ganhomo_mask": np.ones((ph, pw, 1), np.float32),
        }


def write_synthetic_cahomo(root: str, n_pairs: int, hw=(360, 640), seed: int = 0,
                           videos=("0000011", "0000038", "0000085", "00000244",
                                   "00000104")) -> list:
    """A CAHomo-format test layout from a seed, no OpenCV needed:
    ``root/test.txt``, PNG pairs under ``root/img/<video>/`` (smooth random
    textures, the second a shifted copy with noise) and 6 matched points
    each under ``root/pt/``.  Pair i takes video ``videos[i % len]`` (by
    default one of each of the five scene categories).  Returns the lines
    of test.txt."""
    from dmhomo_torch.geometry.warp import resize_bilinear
    from dmhomo_torch.utils.viz import png_bytes

    rng = np.random.default_rng(seed)
    h, w = hw
    os.makedirs(os.path.join(root, "pt"), exist_ok=True)
    lines = []
    for i in range(n_pairs):
        vid = videos[i % len(videos)]
        os.makedirs(os.path.join(root, "img", vid), exist_ok=True)
        coarse = rng.uniform(0, 1, (h // 16 + 2, w // 16 + 2, 3)).astype(np.float32)
        with torch.no_grad():
            tex = resize_bilinear(torch.from_numpy(coarse)[None], (h + 8, w + 8))[0].numpy()
        dx, dy = rng.integers(0, 8, 2)
        img1 = tex[4:4 + h, 4:4 + w]
        img2 = np.clip(tex[dy:dy + h, dx:dx + w] + rng.normal(0, 0.02, (h, w, 3)), 0, 1)
        a, b = f"{vid}/{10000 + 2 * i}.png", f"{vid}/{10001 + 2 * i}.png"
        for name, img in ((a, img1), (b, img2)):
            with open(os.path.join(root, "img", name), "wb") as f:
                f.write(png_bytes(img))
        src = rng.uniform([0, 0], [w - 1, h - 1], (6, 2)).astype(np.float32)
        pts = np.stack([src, src + np.array([4 - dx, 4 - dy], np.float32)], axis=1)
        np.save(os.path.join(root, "pt", f"{a.split('/')[-1]}_{b.split('/')[-1]}.npy"),
                {"matche_pts": pts}, allow_pickle=True)
        lines.append(f"{a} {b}")
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines
