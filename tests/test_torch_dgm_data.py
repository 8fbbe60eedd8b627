"""The port's generation geometry and data against the JAX package's.

* ``fit_homography_to_flow`` on flows of random homographies: the fitted
  flows within 1e-3 px of JAX's (fp32 normal equations over every pixel,
  summed in another order); ``homography_from_points`` of 6 noisy 360x640
  correspondences: the points mapped by the port's H and by JAX's within
  1e-2 px (fp32 normal equations of a least-squares fit, whose 6-point
  system amplifies round-off);
* ``flow_to_rgb_np`` (its own HSV -> RGB) equal to the JAX version's
  (matplotlib) within 1e-6;
* synthetic conditions: the same draws as JAX's, images within 1e-5 (a
  numpy resize for OpenCV's), flows and rgb flows equal;
* generation shards round-trip, explode into per-sample files that
  ``HEMTrainDataset`` reads; the condition cache reads back;
* ``load_dgm_checkpoint`` on a reference-layout ``DGM.pt`` written here.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_torch.data import conditions, shards
from dmhomo_torch.geometry.homography import (
    apply_homography,
    fit_homography_to_flow,
    homography_from_points,
    homography_to_flow,
)
from dmhomo_torch.geometry.host import homography_to_flow_np


def _random_homographies(rng, n, h, w):
    Hs = []
    for _ in range(n):
        d = rng.normal(0, 0.02, (3, 3))
        d[2, :2] *= 1e-3
        d[2, 2] = 0
        d[:2, 2] *= 100
        Hs.append(np.eye(3) + d)
    return np.stack(Hs)


def test_fit_homography_to_flow_matches_jax():
    from dmhomo_tpu.geometry.homography import fit_homography_to_flow as jax_fit

    rng = np.random.default_rng(0)
    h, w = 24, 40
    Hs = _random_homographies(rng, 3, h, w)
    flow = np.stack([homography_to_flow_np(H, h, w) for H in Hs])
    got = fit_homography_to_flow(torch.from_numpy(flow))
    want = np.array(jax_fit(jnp.asarray(flow)))
    assert got.shape == (3, 3, 3) and float(got[:, 2, 2].sub(1).abs().max()) == 0.0
    got_flow = homography_to_flow(got, h, w).numpy()
    want_flow = homography_to_flow(torch.from_numpy(want), h, w).numpy()
    np.testing.assert_allclose(got_flow, want_flow, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_flow, flow, rtol=0, atol=1e-3)  # and the true flow


def test_homography_from_points_matches_jax():
    from dmhomo_tpu.geometry.homography import homography_from_points as jax_from_points

    rng = np.random.default_rng(1)
    Hs = _random_homographies(rng, 2, 360, 640)
    src = rng.uniform([0, 0], [640, 360], (2, 6, 2))
    xy1 = np.concatenate([src, np.ones_like(src[..., :1])], -1) @ Hs.transpose(0, 2, 1)
    dst = (xy1[..., :2] / xy1[..., 2:] + rng.normal(0, 0.3, src.shape)).astype(np.float32)
    src = src.astype(np.float32)
    got = homography_from_points(torch.from_numpy(src), torch.from_numpy(dst))
    want = np.array(jax_from_points(jnp.asarray(src), jnp.asarray(dst)))
    assert float(got[:, 2, 2].sub(1).abs().max()) == 0.0
    pts = torch.from_numpy(src)
    np.testing.assert_allclose(apply_homography(got, pts).numpy(),
                               apply_homography(torch.from_numpy(want), pts).numpy(),
                               rtol=0, atol=1e-2)


def test_flow_to_rgb_matches_jax():
    from dmhomo_tpu.data.conditions import flow_to_rgb_np as jax_flow_to_rgb

    rng = np.random.default_rng(2)
    flow = rng.normal(0, 40, (20, 30, 2)).astype(np.float32)
    flow[0, :3] = 0.0  # zero saturation
    flow[1, 0] = [-5.0, 0.0]  # angle pi: hue exactly 0.5
    got = conditions.flow_to_rgb_np(flow)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jax_flow_to_rgb(flow), rtol=0, atol=1e-6)


def test_synthetic_conditions_match_jax():
    from dmhomo_tpu.cli.dgm_train import synthetic_condition_batches as jax_batches

    got = conditions.synthetic_condition_batches(5, 32, 3, 2, seed=4)
    want = jax_batches(5, 32, 3, 2, seed=4)
    for _ in range(2):
        (gc, gk), (wc, wk) = next(got), next(want)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_allclose(gc[..., :6], wc[..., :6], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(gc[..., 6:], wc[..., 6:])


def test_shards_round_trip_and_explode(tmp_path):
    from dmhomo_torch.data.hem_data import HEMTrainDataset

    rng = np.random.default_rng(5)
    batches = [{"imgs": rng.integers(0, 256, (2, 6, 16, 16), dtype=np.uint8),
                "homos": rng.normal(size=(2, 3, 3)).astype(np.float32) + np.eye(3)}
               for _ in range(2)]
    name = shards.shard_filename(3, 0, 1, 4)
    assert name == "idx_3_rank_0_part_1_dm_cahomo_0.004k.npy"
    path = str(tmp_path / name)
    shards.save_generation_shard(path, batches)
    back = shards.load_generation_shard(path)
    for a, b in zip(back, batches):
        np.testing.assert_array_equal(a["imgs"], b["imgs"])
        np.testing.assert_array_equal(a["homos"], b["homos"])
    with pytest.raises(ValueError, match="uint8"):
        shards.save_generation_shard(path, [{"imgs": batches[0]["imgs"].astype(np.float32),
                                             "homos": batches[0]["homos"]}])
    out = tmp_path / "samples"
    assert shards.explode_shards_to_samples([path, path], str(out), start_index=10) == 18
    sample = shards.load_sample(str(out / "13.npy"))
    np.testing.assert_array_equal(sample["img12"], batches[1]["imgs"][1])
    ds = HEMTrainDataset(str(out), crop_size=(8, 12), ori_size=(12, 16),
                         rng=np.random.default_rng(0))
    assert len(ds) == 8 and ds[0]["img12"].shape == (6, 16, 16)


def test_condition_cache_reads_back(tmp_path):
    rng = np.random.default_rng(6)
    conds = rng.uniform(size=(4, 8, 8, 12)).astype(np.float32)
    np.save(os.path.join(tmp_path, "conditions.npy"), conds)
    np.save(os.path.join(tmp_path, "classes.npy"), np.arange(4, dtype=np.int32))
    cache = conditions.ConditionCache(str(tmp_path))
    c, k = cache.batch([2, 0])
    assert len(cache) == 4 and k.tolist() == [2, 0]
    np.testing.assert_array_equal(c, conds[[2, 0]])
    assert conditions.pair_name_to_class("0000032_000001_0000032_000005") == 1
    with pytest.raises(ValueError):
        conditions.prefix2label("nope")


def test_train_categories_match_jax():
    from dmhomo_tpu.data.conditions import TRAIN_CATEGORIES

    assert conditions.TRAIN_CATEGORIES == TRAIN_CATEGORIES


def test_load_dgm_checkpoint(tmp_path):
    """A reference-layout DGM.pt (trained with 5 classes): the EMA weights
    load by default, the online ones with use_ema=False, the class
    embedding is trimmed to 1 row, and an unknown key is refused."""
    from dmhomo_torch.models.convert import load_dgm_checkpoint
    from dmhomo_torch.models.unet import UNetConfig, build_unet

    train_cfg = UNetConfig(dim=8, dim_mults=(1, 2), num_classes=5)
    online = build_unet(train_cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    ema = build_unet(train_cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    betas = torch.linspace(1e-4, 2e-2, 10)
    model_sd = {f"model.{k}": v for k, v in online.state_dict().items()}
    model_sd.update(betas=betas, alphas_cumprod=torch.cumprod(1 - betas, 0),
                    sqrt_alphas_cumprod=betas, posterior_variance=betas, loss_weight=betas)
    ema_sd = {f"ema_model.model.{k}": v for k, v in ema.state_dict().items()}
    ema_sd.update({"initted": torch.tensor(True), "step": torch.tensor(9),
                   "ema_model.betas": betas, "online_model.model.init_conv.bias": betas})
    ckpt = tmp_path / "DGM.pt"
    torch.save({"step": 123, "model": model_sd, "ema": ema_sd, "opt": {}, "version": "x"}, ckpt)

    sample_cfg = UNetConfig(dim=8, dim_mults=(1, 2), num_classes=1)
    model = build_unet(sample_cfg, device="cpu")
    assert load_dgm_checkpoint(model, str(ckpt)) == 123
    got = model.state_dict()
    for k, v in ema.state_dict().items():
        want = v[:1] if k == "classes_emb.weight" else v
        torch.testing.assert_close(got[k], want, rtol=0, atol=0)
    load_dgm_checkpoint(model, str(ckpt), use_ema=False)
    torch.testing.assert_close(model.state_dict()["init_conv.weight"],
                               online.state_dict()["init_conv.weight"], rtol=0, atol=0)

    model_sd["mystery"] = betas
    torch.save({"step": 1, "model": model_sd, "ema": None}, ckpt)
    with pytest.raises(ValueError, match="mystery"):
        load_dgm_checkpoint(model, str(ckpt))
