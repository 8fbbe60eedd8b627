"""The HEM data remainder against the JAX package's, on the CPU.

* ``HEMTrainDataset``: ``limit`` and ``minimal``; the host pipeline
  (``device_pipeline=False``) against JAX's host pipeline: the same keys and
  crop starts, flows within 1e-5 px, gray within 0.03 (the port resizes
  uint8 in its own fixed point, OpenCV's within one grey level); the
  port's host pipeline against its own device pipeline on the same starts;
* ``resize_linear_u8`` within one grey level of ``cv2.resize``;
* ``SyntheticHomoPairs`` with ``outlier_frac=0.2``, ``label_outliers`` both
  ways, other ``max_offset`` and ``noise``: JAX's draws (the same starts,
  flows and inlier masks; images to float rounding);
* the native host library against its numpy versions, with the tolerances
  of the JAX pair's ``tests/test_native.py`` (flows bit for bit, gray
  2e-7), and a build that fails raises.
"""


import numpy as np
import pytest
import torch

from dmhomo_tpu.data import hem_data as jd

from dmhomo_torch import native
from dmhomo_torch.data import hem_data as td
from dmhomo_torch.data.shards import explode_shards_to_samples, save_generation_shard
from dmhomo_torch.geometry import host

CROP, ORI = (32, 64), (48, 80)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _homography(rng, scale=0.002):
    d = rng.normal(0, scale, (3, 3))
    d[2, :2] *= 1e-3
    d[2, 2] = 0
    return np.eye(3) + d


@pytest.fixture
def samples(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "shard.npy")
    save_generation_shard(path, [{"imgs": rng.integers(0, 256, (5, 6, 32, 32), dtype=np.uint8),
                                  "homos": np.stack([_homography(rng) for _ in range(5)])}])
    explode_shards_to_samples([path], str(tmp_path / "samples"))
    return str(tmp_path / "samples")


def test_limit_and_minimal(samples):
    kw = dict(crop_size=CROP, ori_size=ORI, rho=4, device_pipeline=False)
    assert len(td.HEMTrainDataset(samples, limit=3, **kw)) == 3
    assert len(td.HEMTrainDataset(samples, **kw)) == 5
    full = td.HEMTrainDataset(samples, rng=np.random.default_rng(1), **kw)[2]
    small = td.HEMTrainDataset(samples, rng=np.random.default_rng(1), minimal=True, **kw)[2]
    assert set(small) == {"imgs_gray_patch", "flow_gt_patch", "start"}
    assert set(full) == set(small) | {"imgs_gray_full", "flow_gt_full", "imgs_rgb_full",
                                      "ganhomo_mask"}
    for k in small:
        np.testing.assert_array_equal(small[k], full[k])


@pytest.mark.parametrize("minimal", [False, True])
def test_host_pipeline_matches_jax(samples, minimal):
    kw = dict(crop_size=CROP, ori_size=ORI, rho=4, minimal=minimal, device_pipeline=False)
    ours = td.HEMTrainDataset(samples, rng=np.random.default_rng(2), **kw)
    theirs = jd.HEMTrainDataset(samples, rng=np.random.default_rng(2), **kw)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in b:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a["start"], b["start"])
        for k in ("flow_gt_patch", "flow_gt_full", "ganhomo_mask"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5, err_msg=k)
        for k in ("imgs_gray_patch", "imgs_gray_full"):
            if k in b:
                assert np.abs(a[k] - b[k]).max() < 0.03, k
        if "imgs_rgb_full" in b:
            assert np.abs(a["imgs_rgb_full"] - b["imgs_rgb_full"]).max() <= 1 / 255 + 1e-7


@pytest.mark.parametrize("in_hw, out_hw", [((32, 32), (48, 80)), ((256, 256), (360, 640)),
                                           ((45, 70), (32, 33)), ((17, 23), (40, 51))])
def test_resize_linear_u8_within_one_level_of_opencv(in_hw, out_hw):
    import cv2

    img = np.random.default_rng(3).integers(0, 256, (*in_hw, 3), dtype=np.uint8)
    got = td.resize_linear_u8(img, out_hw)
    want = cv2.resize(img, out_hw[::-1])
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= 1


def test_host_pipeline_matches_device_pipeline(samples):
    kw = dict(crop_size=CROP, ori_size=ORI, rho=4)
    hosted = td.HEMTrainDataset(samples, rng=np.random.default_rng(4), device_pipeline=False,
                                **kw)
    raw = td.HEMTrainDataset(samples, rng=np.random.default_rng(4), **kw)
    h_items, r_items = [hosted[i] for i in range(5)], [raw[i] for i in range(5)]
    for h, r in zip(h_items, r_items):
        np.testing.assert_array_equal(h["start"].astype(np.int32), r["start"])
    batch = {k: torch.from_numpy(np.stack([r[k] for r in r_items]))
             for k in ("img12", "homo", "homo_inv", "start")}
    built = td.device_build_patches(batch["img12"], batch["homo"], batch["homo_inv"],
                                    batch["start"], CROP, ORI)
    gray = np.stack([h["imgs_gray_patch"] for h in h_items])
    flow = np.stack([h["flow_gt_patch"] for h in h_items])
    assert np.abs(built["imgs_gray_patch"].numpy() - gray).max() < 0.03
    np.testing.assert_allclose(built["flow_gt_patch"].numpy(), flow, rtol=0, atol=2e-3)


@pytest.mark.parametrize("kw", [
    dict(outlier_frac=0.2, label_outliers=False),
    dict(outlier_frac=0.2, label_outliers=True),
    dict(max_offset=4.0, noise=0.05),
])
def test_synthetic_pairs_arguments_match_jax(kw):
    args = dict(n=2, crop_size=(48, 96), ori_size=(64, 128), rho=3, seed=3, **kw)
    ours, theirs = td.SyntheticHomoPairs(**args), jd.SyntheticHomoPairs(**args)
    tol = {"flow_gt_full": 5e-5, "flow_gt_patch": 5e-5, "imgs_rgb_full": 3e-5,
           "imgs_gray_full": 1e-4, "imgs_gray_patch": 1e-4}
    for i in range(2):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k, want in b.items():
            assert a[k].shape == want.shape and a[k].dtype == want.dtype, k
            np.testing.assert_allclose(a[k], want, atol=tol.get(k, 0), rtol=0, err_msg=k)
        if kw.get("label_outliers"):
            assert a["inlier_mask_full"].min() == 0.0
        else:
            assert a["inlier_mask_full"].min() == 1.0
    assert td.SyntheticHomoPairs.MAX_OFFSET == ours.__class__(n=1).max_offset == 8.0


def test_native_matches_numpy():
    rng = np.random.default_rng(5)
    H = _homography(rng, 0.02)
    np.testing.assert_array_equal(native.homography_to_flow(H, 45, 80),
                                  host.homography_to_flow_plain(H, 45, 80))
    np.testing.assert_array_equal(host.homography_to_flow_np(H, 45, 80, eps=1e-8),
                                  host.homography_to_flow_plain(H, 45, 80, eps=1e-8))
    for img in (rng.integers(0, 256, (36, 64, 3)).astype(np.uint8),
                rng.uniform(0, 255, (36, 64, 3)).astype(np.float32),
                rng.uniform(0, 255, (36, 64, 3)), rng.integers(0, 256, (36, 64, 3))):
        np.testing.assert_allclose(td.normalize_gray(img), td.normalize_gray_plain(img),
                                   atol=2e-7, rtol=0)
        np.testing.assert_allclose(td.normalize_gray(img), jd.normalize_gray(img), atol=2e-7,
                                   rtol=0)
    with pytest.raises(ValueError):
        native.normalize_gray(np.zeros((4, 4, 2), np.uint8), td.MEAN_I, td.STD_I)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "hemdata.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
    bad.write_text('extern "C" void f() {}\n')
    lib = native.build()  # a good source builds under its own hash
    assert lib.exists() and lib.parent == tmp_path / "build"
