"""``hem_eval --ckpt`` on the port trainer's own checkpoints, and the point
errors under a homography (``point_error_under_h``, ``_v2``) against the JAX
package's, on the CPU."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.evaluation.metrics import point_error_under_h as jax_point_error_under_h
from dmhomo_tpu.evaluation.metrics import point_error_under_h_v2 as jax_point_error_under_h_v2

from dmhomo_torch.cli import hem_eval
from dmhomo_torch.cli.hem_train import tiny_config
from dmhomo_torch.data.hem_data import CAHomoTestDataset, SyntheticHomoPairs
from dmhomo_torch.data.loader import DataLoader
from dmhomo_torch.evaluation.metrics import point_error_under_h, point_error_under_h_v2
from dmhomo_torch.train.hem_trainer import HEMTrainer
from dmhomo_torch.utils.checkpoint import checkpoint_path, resolve_checkpoint
from test_torch_hem_train_cli import TINY_PARAMS, _write_cahomo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points_and_homographies(B, N, seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 640, (B, N, 2)).astype(np.float32)
    H = np.tile(np.eye(3), (B, 1, 1)) + rng.normal(0, 1e-3, (B, 3, 3))
    H[:, :2, 2] += rng.uniform(-20, 20, (B, 2))
    H[:, 2, 2] = 1.0
    dst = src + rng.normal(0, 5, (B, N, 2)).astype(np.float32)
    return src, dst, H.astype(np.float32)


@pytest.mark.parametrize("quirk", [False, True])
def test_point_error_under_h_matches_jax(quirk):
    src, dst, H = _points_and_homographies(4, 6, seed=0)
    want = np.asarray(jax_point_error_under_h(jnp.asarray(src), jnp.asarray(dst),
                                              jnp.asarray(H), reproduce_axis_quirk=quirk))
    got = point_error_under_h(torch.from_numpy(src), torch.from_numpy(dst),
                              torch.from_numpy(H), reproduce_axis_quirk=quirk)
    assert got.shape == (4, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_point_error_under_h_quirk_differs():
    """The quirk compares the warped x with src x: another value."""
    src, dst, H = (torch.from_numpy(a) for a in _points_and_homographies(2, 6, seed=1))
    assert not torch.allclose(point_error_under_h(src, dst, H),
                              point_error_under_h(src, dst, H, reproduce_axis_quirk=True))


def test_point_error_under_h_v2_matches_jax():
    src, dst, H = _points_and_homographies(1, 8, seed=2)
    want = float(jax_point_error_under_h_v2(jnp.asarray(src[0]), jnp.asarray(dst[0]),
                                            jnp.asarray(H[0])))
    got = point_error_under_h_v2(torch.from_numpy(src[0]), torch.from_numpy(dst[0]),
                                 torch.from_numpy(H[0]))
    assert got.dim() == 0
    assert float(got) == pytest.approx(want, rel=1e-5)


@pytest.fixture
def trained(tmp_path):
    """A tiny fp32 trainer after two steps, its ``best`` checkpoint saved,
    its report on a synthetic CAHomo-layout tree, and a params.json of its
    config."""
    data = tmp_path / "cahomo"
    _write_cahomo(str(data), 5, np.random.default_rng(0))
    out = tmp_path / "run"
    cfg = dataclasses.replace(tiny_config(2, False, str(out)), bf16=False, eval_batch_size=2)
    tr = HEMTrainer(cfg, device="cpu")
    tr.init_state(3)
    est = cfg.estimator
    batch = next(iter(DataLoader(SyntheticHomoPairs(8, est.crop_size, est.ori_size, rho=3), 8)))
    for _ in range(2):
        tr.train_step(batch)
    report = tr.evaluate(iter(DataLoader(CAHomoTestDataset(str(data), crop_size=est.crop_size),
                                         batch_size=2, shuffle=False, drop_last=False)))
    tr.save(tag="best")
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    with open(model_dir / "params.json", "w") as f:
        json.dump(TINY_PARAMS, f)
    return str(data), str(out), str(model_dir), report


@pytest.mark.parametrize("form", ["tag", "file"])
def test_hem_eval_ckpt_equals_trainer_evaluate(trained, form):
    """``--ckpt <out>/best`` (or the file itself) reports what
    ``HEMTrainer.evaluate`` reported on the same tree."""
    data, out, model_dir, want = trained
    ckpt = f"{out}/best" if form == "tag" else checkpoint_path(out, "best")
    got = hem_eval.main(["--test-data", data, "--model-dir", model_dir, "--ckpt", ckpt,
                         "--batch-size", "2", "--device", "cpu"])
    assert set(got) == set(want)
    assert np.isfinite(got["RE"]) and np.isfinite(got["AVG"])
    np.testing.assert_allclose([got[k] for k in want], list(want.values()), rtol=1e-6,
                               equal_nan=True)


def test_hem_eval_takes_exactly_one_checkpoint(trained):
    data, out, model_dir, _ = trained
    common = ["--test-data", data, "--model-dir", model_dir, "--device", "cpu"]
    with pytest.raises(SystemExit):
        hem_eval.main(common)
    with pytest.raises(SystemExit):
        hem_eval.main(common + ["--ckpt", f"{out}/best",
                                "--torch-ckpt", checkpoint_path(out, "best")])
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint(f"{out}/latest")  # only best was written
