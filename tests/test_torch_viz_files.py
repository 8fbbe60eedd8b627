"""The port's image files (``utils/codecs.py``, ``utils/viz.py``) against
PIL, OpenCV and the JAX package's ``utils/viz.py``, on the CPU.

* JPEG (``save_png`` on a ``.jpg`` path): PIL decodes it as a baseline JPEG
  of the image's size; its mean absolute error to the 8-bit input is at
  most 1.25x that of PIL's own quality-75 round trip of the same pixels
  (PIL subsamples chroma, the port does not, so the port's is usually the
  smaller), its largest error at most 1.5x PIL's plus 4 levels.
* GIF (``save_flip_gif``): PIL decodes the frames, the NETSCAPE loop 0 and
  a 500 ms (50 cs) delay; every pixel within half a step of the palette's
  per-channel levels (25.5 of 255 for red and blue, 21.25 for green) of the
  8-bit frame.  The JAX function's file carries the same frames through
  imageio (its own palette) with a delay of 0 (imageio's pillow plugin
  reads ``duration=0.5`` as milliseconds): the port writes 50 cs, the
  delay the call means.
* ``vis_bad_case`` and ``warp_check_gif``: the file name JAX writes, and
  the decoded frames within the palette's half step of the frames the JAX
  functions build (JAX's warp; ``cv2.warpPerspective``).
* ``warp_perspective`` against ``cv2.warpPerspective`` (bilinear, 0
  outside) on a smooth image: mean absolute difference below 0.01 and
  largest below 0.5 of 255 (cv2 may round source positions to 1/32 px).
* ``read_png`` against ``cv2.imread`` on PNGs with every row filter.
"""

import io
import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from dmhomo_tpu.utils import viz as jviz

from dmhomo_torch.utils import codecs, viz

HALF_STEP = np.array([255 / 5, 255 / 6, 255 / 5]) / 2


def _smooth_image(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([np.sin(x / 7.0 + c) * np.cos(y / 9.0 - c) * 0.4 + 0.5
                    for c in range(channels)], -1)
    return np.clip(img + rng.normal(0, 0.03, img.shape), 0, 1).astype(np.float32)


def _u8(img01):
    return (np.clip(img01, 0, 1) * 255).astype(np.uint8)


def _gif_frames(path):
    im = Image.open(path)
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("RGB")).astype(np.float64))
    return im, frames


@pytest.mark.parametrize("h, w", [(45, 70), (64, 64), (37, 101)])
def test_jpeg_against_pil(tmp_path, h, w):
    img = _smooth_image(h, w, h)
    u8 = _u8(img).astype(np.float64)
    path = str(tmp_path / "a.jpg")
    viz.save_png(path, img)
    im = Image.open(path)
    assert im.format == "JPEG" and im.size == (w, h) and im.mode == "RGB"
    ours = np.abs(np.asarray(im).astype(np.float64) - u8)
    bio = io.BytesIO()
    Image.fromarray(_u8(img)).save(bio, format="JPEG")  # PIL's default: quality 75
    pil = np.abs(np.asarray(Image.open(bio)).astype(np.float64) - u8)
    assert ours.mean() <= 1.25 * pil.mean(), (ours.mean(), pil.mean())
    assert ours.max() <= 1.5 * pil.max() + 4, (ours.max(), pil.max())


def test_png_path_stays_png(tmp_path):
    img = _smooth_image(9, 13, 1)
    viz.save_png(str(tmp_path / "a.png"), img)
    im = Image.open(tmp_path / "a.png")
    assert im.format == "PNG"
    np.testing.assert_array_equal(np.asarray(im), _u8(img))


@pytest.mark.parametrize("n_frames, h, w", [(2, 30, 50), (3, 64, 200)])
def test_gif_against_pil(tmp_path, n_frames, h, w):
    rng = np.random.default_rng(n_frames)
    frames = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(n_frames)]
    path = str(tmp_path / "sub" / "f.gif")
    viz.save_flip_gif(path, frames)
    im, decoded = _gif_frames(path)
    assert im.format == "GIF" and im.n_frames == n_frames and im.info["loop"] == 0
    for i, d in enumerate(decoded):
        im.seek(i)
        assert im.info["duration"] == 500
        assert (np.abs(d - _u8(frames[i])) <= HALF_STEP + 1e-9).all()
    raw = open(path, "rb").read()
    assert raw.count(b"\x21\xf9\x04\x04\x32\x00") == n_frames  # graphic control: 50 cs


def test_lzw_table_resets(tmp_path):
    """Noise fills the 4096-code table many times over: it still decodes."""
    frame = np.random.default_rng(0).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    path = str(tmp_path / "n.gif")
    open(path, "wb").write(codecs.gif_bytes([frame]))
    _, (d,) = _gif_frames(path)
    assert (np.abs(d - frame) <= HALF_STEP + 1e-9).all()


def test_flip_gif_against_jax(tmp_path):
    frames = [_smooth_image(20, 30, s) for s in (1, 2)]
    jviz.save_flip_gif(str(tmp_path / "j.gif"), frames)
    viz.save_flip_gif(str(tmp_path / "p.gif"), frames)
    jim, jframes = _gif_frames(str(tmp_path / "j.gif"))
    pim, pframes = _gif_frames(str(tmp_path / "p.gif"))
    assert jim.n_frames == pim.n_frames == 2 and jim.info["loop"] == pim.info["loop"] == 0
    jim.seek(0)
    assert jim.info.get("duration", 0) == 0  # the JAX file's delay, as imageio writes it
    for f, j, p in zip(frames, jframes, pframes):
        # each its own palette: the port's within half a step of the frame,
        # the two files within a half step of each other on average
        assert (np.abs(p - _u8(f)) <= HALF_STEP + 1e-9).all()
        assert np.abs(j - p).mean() < HALF_STEP.min()


def test_vis_bad_case_against_jax(tmp_path):
    rng = np.random.default_rng(3)
    imgs = np.concatenate([_smooth_image(16, 24, 4), _smooth_image(16, 24, 5)], -1)[None]
    imgs = np.concatenate([imgs, imgs[:, ::-1]])
    flow = rng.normal(0, 2, (2, 16, 24, 2)).astype(np.float32)
    path = viz.vis_bad_case(str(tmp_path), imgs, flow, 1.5)
    assert os.path.basename(path) == os.path.basename(
        jviz.vis_bad_case(str(tmp_path / "jax"), imgs, flow, 1.5)) == "badcase_1.5.gif"
    import jax.numpy as jnp

    from dmhomo_tpu.geometry import warp_by_flow

    warp = np.asarray(warp_by_flow(jnp.asarray(imgs[:1, ..., 3:]), jnp.asarray(flow[:1]),
                                   mode="border"))[0]
    want = [np.concatenate([imgs[0, ..., :3]] * 2, 1),
            np.concatenate([imgs[0, ..., 3:], warp], 1)]
    _, frames = _gif_frames(path)
    for d, f in zip(frames, want):
        assert (np.abs(d - _u8(f)) <= HALF_STEP + 1.0).all()


def _homography(rng, s):
    return np.eye(3) + np.array([
        [rng.normal(0, 0.05), rng.normal(0, 0.05), rng.normal(0, s / 12)],
        [rng.normal(0, 0.05), rng.normal(0, 0.05), rng.normal(0, s / 12)],
        [rng.normal(0, 1e-4), rng.normal(0, 1e-4), 0.0]])


@pytest.mark.parametrize("seed", range(3))
def test_warp_perspective_against_cv2(seed):
    rng = np.random.default_rng(seed)
    img = (_smooth_image(48, 64, seed) * 255).astype(np.float32)
    H = _homography(rng, 64)
    want = cv2.warpPerspective(img, H, (64, 48))
    got = viz.warp_perspective(torch.from_numpy(img)[None], torch.from_numpy(H)[None])[0].numpy()
    diff = np.abs(got - want)
    assert diff.mean() < 0.01 and diff.max() < 0.5, (diff.mean(), diff.max())
    assert (got[want == 0] == 0).mean() > 0.99  # outside stays 0


def test_warp_check_gif_against_jax(tmp_path):
    rng = np.random.default_rng(7)
    img12 = (np.concatenate([_smooth_image(32, 32, 8), _smooth_image(32, 32, 9)], -1)
             * 255).astype(np.uint8).transpose(2, 0, 1)
    H = _homography(rng, 32)
    path = viz.warp_check_gif(str(tmp_path / "p" / "s.gif"), img12, H)
    jpath = jviz.warp_check_gif(str(tmp_path / "s.gif"), img12, H)
    assert os.path.basename(path) == os.path.basename(jpath)
    img = img12.transpose(1, 2, 0).astype(np.float32)
    warp = cv2.warpPerspective(img[..., :3], H, (32, 32))  # what the JAX function warps
    want = [np.concatenate([img[..., :3], warp], 1), np.concatenate([img[..., 3:]] * 2, 1)]
    im, frames = _gif_frames(path)
    assert im.n_frames == 2
    for d, f in zip(frames, want):
        assert (np.abs(d - f.astype(np.uint8)) <= HALF_STEP + 1.0).all()


@pytest.mark.parametrize("level", [0, 1, 9])
@pytest.mark.parametrize("channels", [1, 3])
def test_read_png_against_cv2(tmp_path, level, channels):
    img = _u8(_smooth_image(23, 41, level, channels))
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img[..., 0] if channels == 1 else img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(codecs.read_png(path)[..., ::-1], cv2.imread(path))
