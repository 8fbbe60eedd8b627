"""The port's condition building and its CLIs against the JAX package's,
on the CPU (the JAX functions use OpenCV, which imports here).

* ``build_condition`` / ``build_conditions`` and ``ConditionCache.build`` on
  4 synthetic raw pairs at the real 360x640 -> 256 (the mask and resize
  conventions are what it checks): images and rgb_flow within 1e-5, the mask
  equal, the flow within 1e-4 px, the classes equal;
* ``build_test_condition``: the same rule;
* ``morph_close_mask``: equal to OpenCV's erode then dilate;
* ``make_conditions --synthetic 6 --device cpu`` against JAX's CLI: the same
  files to those tolerances; ``make_samples`` against JAX's on one shard:
  equal files;
* ``iter_cahomo_train_samples`` on a CAHomo-layout tree made here: JAX's
  tuples; without OpenCV it raises ImportError.
"""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from dmhomo_tpu.cli import make_conditions as jax_make_conditions
from dmhomo_tpu.cli import make_samples as jax_make_samples
from dmhomo_tpu.data import conditions as jc

from dmhomo_torch.cli import make_conditions, make_samples
from dmhomo_torch.data import conditions as tc
from dmhomo_torch.data.shards import save_generation_shard

TOL = {"image": (slice(0, 6), 1e-5), "rgb_flow": (slice(7, 10), 1e-5),
       "flow": (slice(10, 12), 1e-4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_conditions_match(got, want, mask: bool = True):
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    if mask:
        np.testing.assert_array_equal(got[..., 6:7], want[..., 6:7])
    off = 0 if mask else 1  # without a mask the channels after the images move down one
    for name, (sl, tol) in TOL.items():
        if name != "image":
            sl = slice(sl.start - off, sl.stop - off)
        np.testing.assert_allclose(got[..., sl], want[..., sl], rtol=0, atol=tol, err_msg=name)


def test_synthetic_raw_samples_match_jax():
    for a, b in zip(make_conditions.synthetic_raw_samples(3, (24, 40), seed=2),
                    jax_make_conditions.synthetic_raw_samples(3, (24, 40), seed=2)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_build_condition_and_cache_match_jax(tmp_path):
    raw = list(jax_make_conditions.synthetic_raw_samples(4, (360, 640), seed=1))
    want = np.stack([jc.build_condition(*r[:4]) for r in raw])
    got = tc.build_conditions(*list(zip(*raw))[:4], device="cpu").numpy()
    assert got.shape == (4, 256, 256, 12)
    assert_conditions_match(got, want)
    assert_conditions_match(tc.build_condition(*raw[2][:4], device="cpu"), want[2])
    ours = tc.ConditionCache.build(str(tmp_path / "ours"), raw, device="cpu", batch=3)
    theirs = jc.ConditionCache.build(str(tmp_path / "theirs"), raw)
    assert_conditions_match(np.asarray(ours.conditions), np.asarray(theirs.conditions))
    np.testing.assert_array_equal(ours.classes, theirs.classes)
    assert ours.classes.dtype == np.int32 and list(ours.classes) == [0, 1, 2, 3]


def test_build_test_condition_matches_jax():
    rng = np.random.default_rng(3)
    H = np.eye(3) + np.array([[0.01, 0.002, 5.0], [0.003, -0.01, -3.0], [1e-5, 2e-5, 0.0]])
    src = rng.uniform([0, 0], [640, 360], (6, 2))
    xy = np.c_[src, np.ones(6)] @ H.T
    pts = np.stack([src, xy[:, :2] / xy[:, 2:]], axis=1)  # (6, 2, 2)
    img1 = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
    img2 = rng.uniform(0, 1, (360, 640, 3)).astype(np.float32)
    got = tc.build_test_condition(img1, img2, pts, device="cpu")
    want = jc.build_test_condition(img1, img2, pts)
    assert got.shape == (256, 256, 11)
    assert_conditions_match(got, want, mask=False)


def test_morph_close_mask_matches_opencv():
    import cv2

    rng = np.random.default_rng(4)
    masks = (rng.random((3, 23, 31)) > 0.35).astype(np.float32)
    kernel = np.ones((3, 3), np.uint8)
    got = tc.morph_close_mask(masks, device="cpu")
    for m, g in zip(masks, got):
        want = cv2.dilate(cv2.erode(m, kernel, iterations=1), kernel, iterations=1)
        np.testing.assert_array_equal(g, want)
        np.testing.assert_array_equal(g, jc.morph_close_mask(m))


def test_make_conditions_cli_matches_jax(tmp_path):
    args = ["--synthetic", "6", "--image-size", "32", "--src-hw", "48,80", "--seed", "5"]
    cache = make_conditions.main(args + ["--out", str(tmp_path / "ours"), "--device", "cpu"])
    jax_make_conditions.main(args + ["--out", str(tmp_path / "theirs")])
    theirs = jc.ConditionCache(str(tmp_path / "theirs"))
    assert len(cache) == 6
    assert_conditions_match(np.asarray(cache.conditions), np.asarray(theirs.conditions))
    np.testing.assert_array_equal(cache.classes, theirs.classes)


def test_make_samples_cli_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    for part in range(2):
        save_generation_shard(str(tmp_path / f"shard_{part}.npy"), [
            {"imgs": rng.integers(0, 256, (3, 6, 16, 16), dtype=np.uint8),
             "homos": np.eye(3) + rng.normal(0, 1e-3, (3, 3, 3))}])
    shards = str(tmp_path / "shard_*.npy")
    assert make_samples.main(["--shards", shards, "--out", str(tmp_path / "ours"),
                              "--start-index", "2"]) == 8
    jax_make_samples.main(["--shards", shards, "--out", str(tmp_path / "theirs"),
                           "--start-index", "2"])
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert sorted(os.listdir(tmp_path / "ours")) == names and len(names) == 6
    for n in names:
        # the files are written by these tests
        a = np.load(tmp_path / "ours" / n, allow_pickle=True).item()
        b = np.load(tmp_path / "theirs" / n, allow_pickle=True).item()
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(SystemExit):
        make_samples.main(["--shards", str(tmp_path / "none_*.npy"), "--out", str(tmp_path)])


def _cahomo_tree(root, rng):
    import cv2

    names = ["0000012_000001_0000012_000005", "0000071_000002_0000071_000004"]
    os.makedirs(os.path.join(root, "HomoGAN_Bug_Masks"))
    labels = {}
    for name in names:
        parts = name.split("_")
        os.makedirs(os.path.join(root, parts[0]), exist_ok=True)
        for im in ("_".join(parts[:2]), "_".join(parts[2:])):
            cv2.imwrite(os.path.join(root, parts[0], im + ".png"),
                        rng.integers(0, 256, (24, 40, 3), dtype=np.uint8))
        np.save(os.path.join(root, "HomoGAN_Bug_Masks", name + ".npy"),
                (rng.random((24, 40)) > 0.5).astype(np.float32))
        labels[name] = [np.eye(3), np.eye(3) + rng.normal(0, 1e-3, (3, 3))]
    path = os.path.join(root, "labels.npy")
    np.save(path, labels, allow_pickle=True)
    return path


def test_iter_cahomo_train_samples_matches_jax(tmp_path, monkeypatch):
    labels = _cahomo_tree(str(tmp_path), np.random.default_rng(7))
    got = list(tc.iter_cahomo_train_samples(str(tmp_path), labels))
    want = list(jc.iter_cahomo_train_samples(str(tmp_path), labels))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a[4] == b[4]
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)
    cache = tc.ConditionCache.build(str(tmp_path / "cache"), got, image_size=16,
                                    src_hw=(24, 40), device="cpu")
    assert list(cache.classes) == [0, 2]
    monkeypatch.setitem(sys.modules, "cv2", None)  # OpenCV absent, as on the card's machine
    with pytest.raises(ImportError, match="OpenCV"):
        next(tc.iter_cahomo_train_samples(str(tmp_path), labels))
    assert glob.glob(str(tmp_path / "cache" / "*.npy"))
