"""Package rules of the port, its data helpers and its eval entry point.

* ``dmhomo_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
  package (checked in a fresh interpreter);
* entry points default to the card and raise without one;
* metrics, data helpers and the eval CLI, end to end on the CPU on a tiny
  synthetic CAHomo layout.
"""

import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import dmhomo_torch
from dmhomo_torch.config import EstimatorConfig, Params, SwinConfig
from dmhomo_torch.data import hem_data
from dmhomo_torch.data.loader import iterate_batches, pad_batch
from dmhomo_torch.evaluation import metrics
from dmhomo_torch.models.estimator import build_estimator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = (64, 128)
ORI = (72, 144)


def test_no_jax_in_the_port():
    modules = sorted(m.name for m in pkgutil.walk_packages(dmhomo_torch.__path__, "dmhomo_torch."))
    for m in ("ops.window_attention", "ops.linear_attention", "ops.swin_block", "models.unet",
              "diffusion.gaussian", "diffusion.schedules", "data.conditions",
              "cli.dgm_sample", "models.unet_uncond", "diffusion.uncond", "data.image_data"):
        assert f"dmhomo_torch.{m}" in modules
    assert len(modules) >= 25
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'dmhomo_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card():
    """No card: chip_smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_estimator(EstimatorConfig(ori_size=ORI, swin=SwinConfig(crop_size=CROP)))
    from dmhomo_torch.cli import hem_eval

    with pytest.raises(RuntimeError, match="no CUDA device"):
        hem_eval.main(["--test-data", str(tmp_path), "--torch-ckpt", str(tmp_path / "x.pth")])
    from dmhomo_torch.cli import hem_train
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        hem_train.main(["--synthetic", "4", "--tiny", "--steps", "1", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HEMTrainer(HEMTrainConfig())
    from dmhomo_torch.cli import dgm_sample

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dgm_sample.main(["--synthetic", "4", "--exp", "x", "--out", str(tmp_path)])


def test_point_matching_error_truncates_and_takes_the_min():
    flow_f = torch.zeros(1, 4, 5, 2)
    flow_b = torch.zeros(1, 4, 5, 2)
    flow_f[0, 1, 2] = torch.tensor([1.0, 0.0])  # read at (x=2.9, y=1.7) -> [1, 2]
    pts = torch.zeros(1, 6, 2, 2)
    pts[0, :, 0] = torch.tensor([2.9, 1.7])
    pts[0, :, 1] = torch.tensor([3.9, 1.7])
    err = metrics.point_matching_error(pts, flow_f, flow_b)
    torch.testing.assert_close(err, torch.zeros(1))
    flow_f[0, 1, 2] = 0.0
    pts[0, :, 1] = torch.tensor([5.9, 1.7])  # fwd error 3; bwd reads clipped x=4 -> 3
    torch.testing.assert_close(metrics.point_matching_error(pts, flow_f, flow_b),
                               torch.full((1,), 3.0))


def test_category_report_matches_jax():
    from dmhomo_tpu.evaluation import metrics as jm

    names = ["0000011", "0000038", "0000030", "0000085", "nope", "00000244"]
    errs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    for cats, jcats in ((metrics.TEST_CATEGORIES, jm.TEST_CATEGORIES),
                        (metrics.TEST_CATEGORIES_TESTFN, jm.TEST_CATEGORIES_TESTFN)):
        assert cats == jcats
        for seed_zero in (False, True):
            got = metrics.category_report(
                metrics.bucket_by_category(errs, names, cats, seed_zero))
            want = jm.category_report(jm.bucket_by_category(errs, names, jcats, seed_zero))
            assert json.dumps(got) == json.dumps(want)


def test_normalize_gray_matches_jax():
    from dmhomo_tpu.data.hem_data import normalize_gray as jax_normalize_gray

    img = np.random.default_rng(0).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    np.testing.assert_allclose(hem_data.normalize_gray(img), jax_normalize_gray(img),
                               atol=1e-6, rtol=0)


def test_pad_batch_and_iterate_batches():
    ds = [{"x": np.full((2,), i, np.float32), "name": str(i)} for i in range(5)]
    batches = list(iterate_batches(ds, 2))
    assert [len(b["name"]) for b in batches] == [2, 2, 1]
    padded, n = pad_batch(batches[-1], 2)
    assert n == 1 and padded["name"] == ["4", "4"]
    np.testing.assert_array_equal(padded["x"], [[4, 4], [4, 4]])
    with pytest.raises(ValueError):
        pad_batch(batches[0], 1)


def _write_cahomo(root, n, rng):
    import cv2

    os.makedirs(os.path.join(root, "img", "0000011"))
    os.makedirs(os.path.join(root, "pt"))
    lines = []
    for i in range(n):
        a, b = f"0000011/{i}a.jpg", f"0000011/{i}b.jpg"
        for name in (a, b):
            cv2.imwrite(os.path.join(root, "img", name),
                        rng.integers(0, 256, (ORI[0], ORI[1], 3), dtype=np.uint8))
        pts = rng.uniform(0, 60, (6, 2, 2)).astype(np.float32)
        np.save(os.path.join(root, "pt", f"{i}a.jpg_{i}b.jpg.npy"),
                {"matche_pts": pts}, allow_pickle=True)
        lines.append(f"{a} {b}")
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def test_hem_eval_cli_on_cpu(tmp_path):
    """The eval entry point on a tiny synthetic CAHomo layout with a ragged
    tail batch: a reference-layout checkpoint loads, the RE category gets a
    finite mean, and the tail pad does not change the per-pair errors."""
    rng = np.random.default_rng(0)
    data = tmp_path / "cahomo"
    _write_cahomo(str(data), 3, rng)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    with open(model_dir / "params.json", "w") as f:
        json.dump({"crop_size": list(CROP), "ori_size": list(ORI)}, f)
    cfg = EstimatorConfig.from_params(Params(str(model_dir / "params.json")))
    assert cfg.crop_size == CROP and cfg.swin.crop_size == CROP and cfg.ori_size == ORI
    model = build_estimator(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    ckpt = tmp_path / "HEM.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()},
                "epoch": 3}, ckpt)

    from dmhomo_torch.cli.hem_eval import eval_forward, main

    out = tmp_path / "report.json"
    report = main(["--test-data", str(data), "--model-dir", str(model_dir),
                   "--torch-ckpt", str(ckpt), "--batch-size", "2", "--device", "cpu",
                   "--out-json", str(out)])
    assert np.isfinite(report["RE"]) and np.isnan(report["LT"])
    assert report["AVG"] == report["RE"]
    assert json.load(open(out)) == pytest.approx(report, nan_ok=True)

    ds = hem_data.CAHomoTestDataset(str(data), crop_size=CROP)
    batch = next(iterate_batches(ds, 3))
    errs = eval_forward(model, torch.from_numpy(batch["imgs_gray_patch"]),
                        torch.from_numpy(batch["pt_set"]), ORI)
    assert errs.shape == (3,)
    assert report["RE"] == pytest.approx(float(errs.mean()), rel=1e-5)


def test_every_jax_module_has_a_counterpart():
    """Every module of the JAX package has a file of the same path in the
    port, but the two renamed ones (the weight importer, the platform
    set-up), whose counterparts exist."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def modules(pkg):
        base = os.path.join(root, pkg)
        return {os.path.relpath(os.path.join(d, f), base) for d, _, fs in os.walk(base)
                for f in fs if f.endswith(".py")}

    renamed = {"models/import_torch.py": "models/convert.py", "utils/platform.py": "utils/device.py"}
    port = modules("dmhomo_torch")
    assert modules("dmhomo_tpu") - port == set(renamed)
    assert set(renamed.values()) <= port

