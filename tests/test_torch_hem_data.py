"""The port's HEM training data against the JAX package's.

* ``SyntheticHomoPairs``: the same random draws, so the same crop starts
  (exactly) and the same GT flows (5e-5 px: H from an fp32 DLT solve in
  either framework); the images are made without OpenCV (bicubic texture
  resize and bilinear remap in numpy) and agree with OpenCV's to float
  rounding: 3e-5 on the [0, 1] RGB images, 1e-4 on the normalized gray
  ones;
* ``HEMTrainDataset`` (raw schema): the same crop starts and homographies;
* ``device_build_patches`` on the same raw uint8, H and starts (fp32:
  1e-5 on gray values, 3e-5 px on flows);
* the shuffling loader: the JAX loader's batches, epoch by epoch.
"""

import os

import numpy as np
import pytest
import torch

from dmhomo_tpu.data import hem_data as jd
from dmhomo_tpu.data import loader as jloader

from dmhomo_torch.data import hem_data as td
from dmhomo_torch.data import loader as tloader

CROP, ORI = (64, 128), (72, 144)
TOL = {"flow_gt_full": 5e-5, "flow_gt_patch": 5e-5, "imgs_rgb_full": 3e-5,
       "imgs_gray_full": 1e-4, "imgs_gray_patch": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: one torch thread is faster than many, and
    the suite runs test files side by side in worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [1, 2])
def test_synthetic_pairs_match_jax(seed):
    kw = dict(n=3, crop_size=CROP, ori_size=ORI, rho=3, seed=seed)
    ours, theirs = td.SyntheticHomoPairs(**kw), jd.SyntheticHomoPairs(**kw)
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k, want in b.items():
            assert a[k].shape == want.shape and a[k].dtype == want.dtype, k
            np.testing.assert_allclose(a[k], want, atol=TOL.get(k, 0), rtol=0, err_msg=k)


def test_remap_and_cubic_resize_match_opencv():
    import cv2

    rng = np.random.default_rng(0)
    small = rng.uniform(0, 255, (9, 18, 3)).astype(np.float32)
    img = td.resize_cubic_np(small, ORI)
    np.testing.assert_allclose(
        img, cv2.resize(small, ORI[::-1], interpolation=cv2.INTER_CUBIC), atol=2e-4, rtol=0)
    grid = np.stack(np.meshgrid(np.arange(ORI[1]), np.arange(ORI[0])), -1).astype(np.float32)
    mapping = grid + rng.uniform(-5, 5, grid.shape).astype(np.float32)
    np.testing.assert_allclose(
        td.remap_bilinear_np(img, mapping),
        cv2.remap(img, mapping[..., 0], mapping[..., 1], cv2.INTER_LINEAR,
                  borderMode=cv2.BORDER_REPLICATE), atol=2e-4, rtol=0)


def _write_samples(root, n, S, rng):
    os.makedirs(root)
    for i in range(n):
        off = rng.uniform(-6, 6, (4, 2))
        H = np.eye(3) + np.pad(off.reshape(-1)[:6].reshape(2, 3) * 0.01, ((0, 1), (0, 0)))
        np.save(os.path.join(root, f"{i}.npy"),
                {"img12": rng.integers(0, 256, (6, S, S), dtype=np.uint8), "homo12": H},
                allow_pickle=True)


def test_train_dataset_and_device_build_patches_match_jax(tmp_path):
    import jax.numpy as jnp

    _write_samples(str(tmp_path / "s"), 3, 80, np.random.default_rng(0))
    kw = dict(crop_size=CROP, ori_size=ORI, rho=16)
    ours = td.HEMTrainDataset(str(tmp_path / "s"), rng=np.random.default_rng(5), **kw)
    theirs = jd.HEMTrainDataset(str(tmp_path / "s"), rng=np.random.default_rng(5),
                                device_pipeline=True, **kw)
    assert len(ours) == 3 and ours.rho == theirs.rho == 4
    items = [ours[i] for i in range(3)]
    for i, a in enumerate(items):
        b = theirs[i]
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k

    batch = tloader.collate(items)
    got = td.device_build_patches(*(torch.from_numpy(batch[k]) for k in
                                    ("img12", "homo", "homo_inv", "start")), CROP, ORI)
    want = jd.device_build_patches(*(jnp.asarray(batch[k]) for k in
                                     ("img12", "homo", "homo_inv", "start")), CROP, ORI)
    assert got["imgs_gray_patch"].shape == (3, *CROP, 2)
    assert got["flow_gt_patch"].shape == (3, *CROP, 4)
    np.testing.assert_allclose(got["imgs_gray_patch"].numpy(), np.asarray(want["imgs_gray_patch"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["flow_gt_patch"].numpy(), np.asarray(want["flow_gt_patch"]),
                               atol=3e-5, rtol=0)


@pytest.mark.parametrize("shuffle, drop_last", [(True, True), (False, False)])
def test_loader_matches_jax(shuffle, drop_last):
    ds = [{"x": np.full((2,), i, np.float32), "name": str(i)} for i in range(10)]
    ours = tloader.DataLoader(ds, 4, shuffle=shuffle, drop_last=drop_last, seed=3)
    theirs = jloader.DataLoader(ds, 4, shuffle=shuffle, drop_last=drop_last, seed=3,
                                prefetch=0)
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: a new order each, the same on both sides
        a, b = list(ours), list(theirs)
        assert [x["name"] for x in a] == [x["name"] for x in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["x"], y["x"])
    stream = tloader.cycle(tloader.DataLoader(ds, 4, seed=3))
    first = [next(stream)["name"] for _ in range(5)]
    again = tloader.cycle(tloader.DataLoader(ds, 4, seed=3))
    assert first == [next(again)["name"] for _ in range(5)]  # deterministic from the seed
    assert first[0] != first[2]  # epoch 2 reshuffles


def test_trainer_takes_the_raw_schema(tmp_path):
    """A raw-schema batch (HEMTrainDataset) trains as the batch that
    device_build_patches makes of it."""
    from dmhomo_torch.cli.hem_train import tiny_config
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    cfg = tiny_config(1, False, str(tmp_path))
    est = cfg.estimator
    _write_samples(str(tmp_path / "s"), 4, 48, np.random.default_rng(1))
    ds = td.HEMTrainDataset(str(tmp_path / "s"), est.crop_size, est.ori_size, rho=3,
                            rng=np.random.default_rng(0))
    raw = tloader.collate([ds[i] for i in range(4)])
    built = td.device_build_patches(*(torch.from_numpy(raw[k]) for k in
                                      ("img12", "homo", "homo_inv", "start")),
                                    est.crop_size, est.ori_size)
    losses = []
    for batch in (raw, {k: v.numpy() for k, v in built.items()}):
        tr = HEMTrainer(cfg, device="cpu")
        tr.init_state(0)
        losses.append(float(tr.train_step(batch)["total"]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
