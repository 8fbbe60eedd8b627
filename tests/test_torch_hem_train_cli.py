"""The port's training CLI end to end on the CPU: a tiny config on
synthetic pairs takes a few steps with a finite loss, writes a checkpoint
in the reference Manager layout, resumes from it (``--resume``, and
``--resume --ow`` for weights only), and the checkpoint loads in
``hem_eval --torch-ckpt``."""

import json
import os

import numpy as np
import pytest
import torch

from dmhomo_torch.cli import hem_eval, hem_train
from dmhomo_torch.utils.checkpoint import checkpoint_path

ORI = (40, 72)
TINY_PARAMS = {"crop_size": [32, 64], "ori_size": list(ORI), "embed_dim": 8,
               "depths": [1, 1, 1], "layer_depth": [3, 2, 1], "num_heads": [2, 2, 4],
               "window_size": 4, "mlp_ratio": 2.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: one torch thread is faster than many, and
    the suite runs test files side by side in worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_cahomo(root, n, rng):
    import cv2

    os.makedirs(os.path.join(root, "img", "0000011"))
    os.makedirs(os.path.join(root, "pt"))
    lines = []
    for i in range(n):
        a, b = f"0000011/{i}a.jpg", f"0000011/{i}b.jpg"
        for name in (a, b):
            cv2.imwrite(os.path.join(root, "img", name),
                        rng.integers(0, 256, (*ORI, 3), dtype=np.uint8))
        np.save(os.path.join(root, "pt", f"{i}a.jpg_{i}b.jpg.npy"),
                {"matche_pts": rng.uniform(0, 30, (6, 2, 2)).astype(np.float32)},
                allow_pickle=True)
        lines.append(f"{a} {b}")
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def test_hem_train_cli_on_cpu(tmp_path):
    data = tmp_path / "cahomo"
    _write_cahomo(str(data), 3, np.random.default_rng(0))
    out = str(tmp_path / "run")
    common = ["--synthetic", "16", "--tiny", "--device", "cpu", "--out", out]
    # 3 steps, then the eval of the tiny config's train_num_steps = 3
    tr = hem_train.main(common + ["--steps", "3", "--test-data", str(data)])
    for tag in ("latest", "best"):
        ckpt = torch.load(checkpoint_path(out, tag), map_location="cpu", weights_only=True)
        assert set(ckpt) == {"state_dict", "optimizer", "scheduler", "step", "epoch"}
        assert ckpt["step"] == 3
    assert np.isfinite(tr.metrics.best["val"])
    assert np.isfinite(tr.metrics.current("val")["RE"])

    # --resume continues the step count; --resume --ow restarts it
    tr = hem_train.main(common + ["--steps", "4", "--resume"])
    assert tr.step == 4
    tr = hem_train.main(common + ["--steps", "1", "--resume", "--ow"])
    assert tr.step == 1 and tr.lr == 1e-4
    losses = tr.train_step(tr_batch(tr))
    assert np.isfinite(float(losses["total"])) and float(losses["total"]) > 0

    # the checkpoint loads in the eval CLI (reference key names, strict)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    with open(model_dir / "params.json", "w") as f:
        json.dump(TINY_PARAMS, f)
    report = hem_eval.main(["--test-data", str(data), "--model-dir", str(model_dir),
                            "--torch-ckpt", checkpoint_path(out, "latest"),
                            "--batch-size", "2", "--device", "cpu"])
    assert np.isfinite(report["RE"])


def tr_batch(tr):
    from dmhomo_torch.data.hem_data import SyntheticHomoPairs
    from dmhomo_torch.data.loader import DataLoader

    est = tr.config.estimator
    return next(iter(DataLoader(SyntheticHomoPairs(8, est.crop_size, est.ori_size, rho=3), 8)))


def test_hem_train_cli_fused_block_on_cpu(tmp_path):
    """``--attn fused_block`` with the tiny config trains on the CPU through
    the whole-block plain versions (remat on, as the JAX trainer resolves
    it) and writes a checkpoint."""
    from dmhomo_torch.models.swin import SwinBlock

    out = str(tmp_path / "run")
    tr = hem_train.main(["--synthetic", "16", "--tiny", "--device", "cpu", "--out", out,
                         "--steps", "2", "--attn", "fused_block"])
    assert tr.config.attn_impl == "fused_block" and tr.step == 2
    assert all(m.fused for m in tr.model.modules() if isinstance(m, SwinBlock))
    assert tr.model.h_net.encoder_layers[0].remat
    ckpt = torch.load(checkpoint_path(out, "latest"), map_location="cpu", weights_only=True)
    assert ckpt["step"] == 2
    losses = tr.train_step(tr_batch(tr))
    assert np.isfinite(float(losses["total"])) and float(losses["total"]) > 0
