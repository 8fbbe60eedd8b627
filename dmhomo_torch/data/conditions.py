"""DGM conditions (the JAX package's ``data/conditions.py``): the CAHomo
scene classes, building conditions on the device, the flat condition cache
and synthetic condition batches.

A condition is a (S, S, 12) float32 tensor: img1 (3) img2 (3) mask (1)
rgb_flow (3) flow (2), images and rgb_flow in [0, 1].  It is built from a
raw pair (``build_condition``; batched, ``build_conditions``): the images
resized half-pixel bilinearly (OpenCV's INTER_LINEAR on float input), the
dominant-plane mask resized to its nearest pixels (INTER_NEAREST) and closed
by a 3x3 erode then dilate, the homography rescaled from the source
resolution, its dense flow in float64 (one float32 rounding) and the flow's
HSV image.  Every step but the 3x3 homography rescale runs on the device it
is given (the card by default).  ``iter_cahomo_train_samples`` reads the
real CAHomo train layout with OpenCV, which it imports when called.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dmhomo_torch.geometry.flow_viz import flow_to_rgb
from dmhomo_torch.geometry.homography import homography_from_points
from dmhomo_torch.geometry.host import homography_to_flow_np, rescale_homography_np
from dmhomo_torch.geometry.warp import resize_bilinear, resize_nearest
from dmhomo_torch.utils.device import resolve_device

# CAHomo *train* split video ids per scene category; label order RE=0 LT=1
# LL=2 SF=3 LF=4 (the reference's prefix2label).
TRAIN_CATEGORIES = {
    "RE": (
        "000004", "000008", "000009", "0000010", "0000012", "0000013", "0000014",
        "0000015", "0000017", "0000018", "0000052", "0000053", "0000054",
        "0000055", "0000065", "0000066", "0000068", "0000070", "00000105",
        "00000108", "00000111", "00000112", "00000113", "00000114", "00000116",
        "00000120", "00000122", "00000121", "00000125", "00000126", "00000127",
        "00000128", "00000130", "00000131", "00000132", "00000133", "00000134",
        "00000136", "00000138", "00000142", "00000143", "00000144", "00000145",
        "00000151", "00000153", "00000154", "00000156", "00000157", "00000159",
        "00000160", "00000162", "00000167", "00000168", "00000203", "00000204",
        "00000205", "00000206", "00000207", "00000208", "00000209", "00000212",
        "00000231", "00000233", "00000234",
    ),
    "LT": (
        "0000032", "0000033", "0000036", "0000037", "0000039", "0000040",
        "0000041", "0000042", "0000043", "0000045", "0000048", "0000049",
        "0000050", "0000051", "00000123", "00000150", "00000175", "00000176",
        "00000178", "00000179", "00000180", "00000182", "00000183", "00000184",
        "00000186", "00000187", "00000189", "00000237", "00000240", "00000245",
        "00000246",
    ),
    "LL": (
        "0000071", "0000072", "0000073", "0000074", "0000075", "0000076",
        "0000077", "0000078", "0000079", "0000080", "0000081", "0000082",
        "0000083", "0000084", "0000086", "0000087", "0000088", "0000089",
        "0000090", "0000093", "0000094", "0000095", "0000096", "0000097",
        "0000098", "0000099", "00000214", "00000215", "00000217", "00000218",
        "00000219", "00000220", "00000221", "00000222", "00000223", "00000224",
        "00000225", "00000227", "00000228",
    ),
    "SF": (
        "000001", "000002", "000003", "000007", "0000057", "0000058", "0000059",
        "0000060", "0000061", "0000062", "0000063", "0000067", "0000069",
        "00000101", "00000102", "00000103", "00000106", "00000170", "00000171",
        "00000172", "00000173", "00000174", "00000185", "00000190", "00000191",
        "00000192", "00000193", "00000202", "00000210", "00000211", "00000213",
        "00000229", "00000230", "00000235", "00000236", "00000241", "00000242",
        "00000243", "00000247", "00000248", "00000249", "00000250",
    ),
    "LF": (
        "000005", "000006", "0000019", "0000020", "0000021", "0000022", "0000023",
        "0000024", "0000025", "0000027", "0000028", "0000029", "0000056",
        "0000064", "00000109", "00000110", "00000117", "00000118", "00000119",
        "00000124", "00000135", "00000137", "00000139", "00000140", "00000146",
        "00000148", "00000149", "00000152", "00000161", "00000163", "00000164",
        "00000165", "00000166", "00000169", "00000194", "00000195", "00000196",
        "00000197", "00000198", "00000199", "00000201", "00000232",
    ),
}

_PREFIX_TO_LABEL = {vid: label for label, ids in enumerate(TRAIN_CATEGORIES.values())
                    for vid in ids}


def prefix2label(prefix: str) -> int:
    """CAHomo train video id -> scene class 0..4 (RE LT LL SF LF)."""
    try:
        return _PREFIX_TO_LABEL[prefix]
    except KeyError:
        raise ValueError(f"unknown CAHomo train video id: {prefix!r}") from None


def pair_name_to_class(im1_im2_name: str) -> int:
    """Scene class of a pseudo-label pair key like
    '0000012_000001_0000012_000005' (its first field is the video id)."""
    return prefix2label(im1_im2_name.split("_")[0])


def hsv_to_rgb_np(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) HSV in [0, 1] -> RGB, the six-sector formula of
    ``matplotlib.colors.hsv_to_rgb``, in at least float32."""
    hsv = np.asarray(hsv, dtype=np.promote_types(np.asarray(hsv).dtype, np.float32))
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    sector = i % 6
    rgb = np.empty_like(hsv)
    for k, (r, g, b) in enumerate(((v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
                                   (v, p, q))):
        sel = sector == k
        rgb[..., 0][sel], rgb[..., 1][sel], rgb[..., 2][sel] = r[sel], g[sel], b[sel]
    grey = s == 0
    for c in range(3):
        rgb[..., c][grey] = v[grey]
    return rgb


def flow_to_rgb_np(flow: np.ndarray, max_flow: float = 256.0, n: float = 8.0) -> np.ndarray:
    """The HSV flow image of (H, W, 2) -> (H, W, 3) float32: hue the flow's
    angle, saturation its magnitude * n / max_flow, value n - saturation."""
    max_flow = max(max_flow, 1.0) if max_flow is not None else np.max(flow)
    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u * u + v * v)
    angle = np.arctan2(v, u)
    im_h = np.mod(angle / (2 * np.pi) + 1.0, 1.0)
    im_s = np.clip(mag * n / max_flow, 0, 1)
    im_v = np.clip(n - im_s, 0, 1)
    return hsv_to_rgb_np(np.stack([im_h, im_s, im_v], axis=2)).astype(np.float32)


def _close(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    """(B, H, W) float: ksize x ksize erode then dilate.  Max-pooling pads
    with -inf, so the border wins neither the min nor the max, as OpenCV's
    default border for erode and dilate."""
    x = mask[:, None]
    x = -F.max_pool2d(-x, ksize, stride=1, padding=ksize // 2)
    return F.max_pool2d(x, ksize, stride=1, padding=ksize // 2)[:, 0]


def morph_close_mask(mask: np.ndarray, ksize: int = 3, device=None) -> np.ndarray:
    """3x3 erode then dilate (the reference's mask cleanup) of an (H, W) or
    (B, H, W) mask, as float32, computed on ``device`` (default: the card)."""
    m = torch.from_numpy(np.asarray(mask, np.float32)).to(resolve_device(device))
    return _close(m.reshape(-1, *m.shape[-2:]), ksize).reshape(m.shape).cpu().numpy()


def _images_f01(imgs, device: torch.device) -> torch.Tensor:
    """A stack of (H, W, 3) images, uint8 (scaled by 1/255) or in [0, 1], as
    float32 on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(np.stack([np.asarray(im) for im in imgs])))
    t = t.to(device)
    return t.float() / 255.0 if t.dtype == torch.uint8 else t.float()


def _flow_f64(H: np.ndarray, h: int, w: int, device: torch.device,
              eps: float = 1e-6) -> torch.Tensor:
    """Dense flows of homographies (B, 3, 3) in float64 with the +eps divide
    guard and one float32 rounding, on ``device``: (B, h, w, 2)."""
    Ht = torch.from_numpy(np.asarray(H, np.float64)).to(device)[:, :, :, None, None]
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    u = Ht[:, 0, 0] * x + Ht[:, 0, 1] * y + Ht[:, 0, 2]
    v = Ht[:, 1, 0] * x + Ht[:, 1, 1] * y + Ht[:, 1, 2]
    z = Ht[:, 2, 0] * x + Ht[:, 2, 1] * y + Ht[:, 2, 2] + eps
    return torch.stack([u / z - x, v / z - y], dim=-1).float()


def _condition(img1, img2, mask, homo, image_size: int, src_hw,
               dev: torch.device) -> torch.Tensor:
    """(B, S, S, 12) conditions (11 channels without a mask) from homographies
    at ``src_hw``."""
    S = (image_size, image_size)
    parts = [resize_bilinear(_images_f01(img1, dev), S), resize_bilinear(_images_f01(img2, dev), S)]
    if mask is not None:
        # uploaded as given (uint8 masks: a quarter of the bytes), float32 there
        m = torch.from_numpy(np.stack([np.squeeze(np.asarray(x)) for x in mask])).to(dev).float()
        parts.append(_close(resize_nearest(m[..., None], S)[..., 0], 3)[..., None])
    H = np.stack([rescale_homography_np(h, src_hw, S) for h in homo])
    flow = _flow_f64(H, image_size, image_size, dev)
    return torch.cat(parts + [flow_to_rgb(flow), flow], dim=-1)


def build_conditions(img1, img2, mask, homo_f, image_size: int = 256, src_hw=(360, 640),
                     device=None) -> torch.Tensor:
    """A batch of conditions (B, image_size, image_size, 12) float32 on
    ``device`` (default: the card).  img1 / img2: B images (H, W, 3) uint8 or
    in [0, 1]; mask: B masks (H', W') (or (H', W', 1)); homo_f: B homographies
    (3, 3) in ``src_hw`` pixel coordinates (img1 -> img2)."""
    return _condition(img1, img2, mask, homo_f, image_size, src_hw, resolve_device(device))


def build_condition(img1, img2, mask, homo_f, image_size: int = 256, src_hw=(360, 640),
                    device=None) -> np.ndarray:
    """One condition (image_size, image_size, 12) float32, built on
    ``device`` (default: the card): :func:`build_conditions` of one pair."""
    return build_conditions([img1], [img2], [mask], [homo_f], image_size, src_hw,
                            device)[0].cpu().numpy()


def build_test_condition(img1, img2, matched_pts, image_size: int = 256, src_hw=(360, 640),
                         device=None) -> np.ndarray:
    """A CATestSet-style 11-channel condition without a mask: img1 (3) img2
    (3) rgb_flow (3) flow (2), the homography fitted to the ground-truth
    matched points ``matched_pts`` (>= 4, 2, 2) = [pair, (src, dst), (x, y)]
    by ``homography_from_points`` in float32; built on ``device`` (default:
    the card)."""
    dev = resolve_device(device)
    pts = torch.from_numpy(np.asarray(matched_pts, np.float32)).to(dev)
    H = homography_from_points(pts[None, :, 0], pts[None, :, 1])[0].cpu().numpy()
    return _condition([img1], [img2], None, [H], image_size, src_hw, dev)[0].cpu().numpy()


class ConditionCache:
    """Flat condition cache: ``conditions.npy`` (N, S, S, 12) float32 and
    ``classes.npy`` (N,) in one directory, read through a memory map."""

    def __init__(self, path: str):
        self.path = path
        self.conditions = np.load(os.path.join(path, "conditions.npy"), mmap_mode="r")
        self.classes = np.load(os.path.join(path, "classes.npy"))

    def __len__(self):
        return self.conditions.shape[0]

    def __getitem__(self, idx):
        return np.asarray(self.conditions[idx]), self.classes[idx]

    def batch(self, indices: Sequence[int]):
        return np.asarray(self.conditions[list(indices)]), self.classes[list(indices)]

    @staticmethod
    def build(out_dir: str, samples, image_size: int = 256, src_hw=(360, 640), device=None,
              batch: int = 32) -> "ConditionCache":
        """Build the cache from (img1, img2, mask, homo_f, class) tuples, in
        batches of ``batch`` on ``device`` (default: the card).  The class is
        an int or a CAHomo pair name, whose scene class
        :func:`pair_name_to_class` gives.  Writes ``conditions.npy`` and
        ``classes.npy`` (int32) into out_dir."""
        dev = resolve_device(device)
        os.makedirs(out_dir, exist_ok=True)
        conds, classes, chunk = [], [], []

        def flush():
            img1, img2, mask, homo, _ = zip(*chunk)
            conds.append(_condition(img1, img2, mask, homo, image_size, src_hw, dev).cpu().numpy())
            chunk.clear()

        for sample in samples:
            chunk.append(sample)
            cls = sample[4]
            classes.append(pair_name_to_class(cls) if isinstance(cls, str) else int(cls))
            if len(chunk) == batch:
                flush()
        if chunk:
            flush()
        np.save(os.path.join(out_dir, "conditions.npy"), np.concatenate(conds))
        np.save(os.path.join(out_dir, "classes.npy"), np.asarray(classes, np.int32))
        return ConditionCache(out_dir)


def synthetic_condition_batches(n: int, image_size: int, batch_size: int, num_classes: int,
                                seed: int = 0):
    """Endless (conditions (B, S, S, 12), classes (B,)) batches drawn from n
    conditions of random near-identity homographies over smooth random
    images; the JAX package's draws, in the same order, from ``seed``."""
    rng = np.random.default_rng(seed)
    conds = np.zeros((n, image_size, image_size, 12), np.float32)
    classes = rng.integers(0, num_classes, (n,)).astype(np.int32)
    for i in range(n):
        d = rng.normal(0, 0.01, (3, 3))
        d[2, :2] *= 1e-4
        d[2, 2] = 0
        flow = homography_to_flow_np(np.eye(3) + d, image_size, image_size)
        small = rng.uniform(0, 1, (image_size // 8, image_size // 8, 6)).astype(np.float32)
        # cv2.resize's INTER_LINEAR (half-pixel) on the CPU
        conds[i, ..., :6] = resize_bilinear(torch.from_numpy(small)[None],
                                            (image_size, image_size))[0].numpy()
        conds[i, ..., 6:7] = 1.0
        conds[i, ..., 7:10] = flow_to_rgb_np(flow)
        conds[i, ..., 10:12] = flow
    while True:
        idx = rng.integers(0, n, (batch_size,))
        yield conds[idx], classes[idx]


def iter_cahomo_train_samples(trainset_path: str, pseudo_labels_npy: str,
                              masks_dir: str = "HomoGAN_Bug_Masks"):
    """Yield (img1, img2, mask, homo_f, pair_name) over the CAHomo train
    layout, pairs in sorted order: a BasesHomo pseudo-label dict
    ``{pair_name: [homo_b, homo_f]}`` and a dominant-plane mask
    ``masks_dir/<pair_name>.npy`` per pair; the images as OpenCV reads them
    (BGR uint8).  Feed to :meth:`ConditionCache.build`."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("iter_cahomo_train_samples reads the CAHomo images with OpenCV "
                          f"(cv2), which does not import here: {e}") from e

    # the pseudo-label dict is pickled by the dataset's authors
    labels = np.load(pseudo_labels_npy, allow_pickle=True).item()
    for name in sorted(labels.keys()):
        parts = name.split("_")
        im1 = "_".join(parts[:2]) + ".png"
        im2 = "_".join(parts[2:]) + ".png"
        homo_f = np.asarray(labels[name][1], np.float64)
        mask = np.load(os.path.join(trainset_path, masks_dir, name + ".npy"))
        img1 = cv2.imread(os.path.join(trainset_path, parts[0], im1))
        img2 = cv2.imread(os.path.join(trainset_path, parts[0], im2))
        yield img1, img2, mask, homo_f, name
