"""HEM data: the generated training set, synthetic pairs and the CAHomo
test split.

* :class:`HEMTrainDataset` - per-sample npys of the generated training set;
  each sample is the raw uint8 pair, its homography (and inverse) at the
  training resolution and a random crop start, and
  :func:`device_build_patches` turns a batch of them into the training
  batch on the device (resize, gray normalization, GT flows, crops).
* :class:`SyntheticHomoPairs` - random textures and their warps by random
  homographies, with exact GT flows: no disk, numpy only (no OpenCV).
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
    then rounded to float32."""
    x = (np.asarray(img, np.float64) - MEAN_I) / STD_I
    return np.mean(x, axis=2, keepdims=True).astype(np.float32)


class CAHomoTestDataset:
    """CAHomo test split: image pairs + 6 ground-truth matched points each."""

    def __init__(self, data_dir: str, crop_size=(320, 576)):
        self.data_dir = data_dir
        self.crop_size = tuple(crop_size)
        with open(os.path.join(data_dir, "test.txt")) as f:
            self.pairs = [ln.strip() for ln in f if ln.strip()]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        import cv2

        line = self.pairs[idx]
        video_name = line.split("/")[0]
        names = line.split(" ")
        pt_name = names[0].split("/")[-1] + "_" + names[1].split("/")[-1] + ".npy"
        img1 = cv2.imread(os.path.join(self.data_dir, "img", names[0]))
        img2 = cv2.imread(os.path.join(self.data_dir, "img", names[1]))
        # the point files are pickled dicts written by the dataset's authors
        pt = np.load(os.path.join(self.data_dir, "pt", pt_name), allow_pickle=True).item()
        pt_set = np.asarray(pt["matche_pts"][:6], np.float32)  # (6, 2, 2)

        g1 = normalize_gray(img1)
        g2 = normalize_gray(img2)
        ph, pw = self.crop_size
        g1_rs = cv2.resize(g1, (pw, ph))[..., None]
        g2_rs = cv2.resize(g2, (pw, ph))[..., None]
        return {
            "imgs_gray_patch": np.concatenate([g1_rs, g2_rs], axis=2),
            "pt_set": pt_set,
            "video_names": video_name,
        }


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
    mean = torch.tensor(MEAN_I.ravel(), dtype=torch.float32, device=imgs.device)
    std = torch.tensor(STD_I.ravel(), dtype=torch.float32, device=imgs.device)
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
    """Generated-pair training set over per-sample npys, in the raw schema
    that :func:`device_build_patches` takes: ``img12`` (6, S, S) uint8,
    ``homo`` / ``homo_inv`` (3, 3) float32 at ori_size, ``start`` (2,)
    int32 (x, y), drawn inside a ``rho`` margin."""

    def __init__(self, samples_dir: str, crop_size=(320, 576), ori_size=(360, 640),
                 rho: int = 16, rng: Optional[np.random.Generator] = None):
        self.paths = sorted(glob.glob(os.path.join(samples_dir, "*.npy")))
        self.crop_size = tuple(crop_size)
        self.ori_size = tuple(ori_size)
        # clamp the crop margin so small geometries stay valid
        max_rho = min((ori_size[0] - crop_size[0]) // 2, (ori_size[1] - crop_size[1]) // 2)
        self.rho = max(0, min(rho, max_rho))
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        buf = load_sample(self.paths[idx])
        img12 = buf["img12"]
        homo = np.asarray(buf["homo12"], np.float64)
        oh, ow = self.ori_size
        ph, pw = self.crop_size
        h, w = img12.shape[1:]
        H = homo if (h, w) == (oh, ow) else rescale_homography_np(homo, (h, w), (oh, ow))
        x = int(self.rng.integers(self.rho, ow - self.rho - pw + 1))
        y = int(self.rng.integers(self.rho, oh - self.rho - ph + 1))
        return {
            "img12": img12,
            "homo": H.astype(np.float32),
            "homo_inv": np.linalg.inv(H).astype(np.float32),
            "start": np.asarray([x, y], np.int32),
        }


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
    by H (corner offsets up to 8 px) plus 1% noise, so the GT flows are
    exact.  The random draws come in the JAX version's order from
    ``default_rng(seed * 100003 + idx)``: the homographies and flows are the
    same; the images differ from OpenCV's by float rounding only.
    """

    MAX_OFFSET = 8.0
    NOISE = 0.01

    def __init__(self, n: int = 64, crop_size=(320, 576), ori_size=(360, 640), rho: int = 16,
                 seed: int = 0):
        self.n = n
        self.crop_size = tuple(crop_size)
        self.ori_size = tuple(ori_size)
        self.rho = rho
        self.seed = seed

    def __len__(self):
        return self.n

    def _random_homography(self, rng, h, w) -> np.ndarray:
        corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float32)
        off = rng.uniform(-self.MAX_OFFSET, self.MAX_OFFSET, (4, 2)).astype(np.float32)
        H = dlt_solve_4pt(torch.from_numpy(corners[None]), torch.from_numpy(off[None]))[0]
        return H.numpy().astype(np.float64)

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        oh, ow = self.ori_size
        small = rng.uniform(0, 255, (oh // 8, ow // 8, 3)).astype(np.float32)
        img1 = np.clip(resize_cubic_np(small, (oh, ow)), 0, 255)
        homo = self._random_homography(rng, oh, ow)
        homo_inv = np.linalg.inv(homo)
        # a feature at x in img1 sits at H(x) in img2: img2(y) = img1(H^-1 y)
        img2 = remap_bilinear_np(img1, homography_to_mapping_np(homo_inv, oh, ow, eps=1e-8))
        img2 = np.clip(img2 + rng.normal(0, self.NOISE * 255, img2.shape), 0, 255)
        flow_f = homography_to_flow_np(homo, oh, ow, eps=1e-8)
        flow_b = homography_to_flow_np(homo_inv, oh, ow, eps=1e-8)
        g1 = normalize_gray(img1)
        g2 = normalize_gray(img2)
        ph, pw = self.crop_size
        x = int(rng.integers(self.rho, ow - self.rho - pw + 1))
        y = int(rng.integers(self.rho, oh - self.rho - ph + 1))
        return {
            "inlier_mask_full": np.ones((oh, ow, 1), np.float32),
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
