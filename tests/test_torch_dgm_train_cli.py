"""The port's DGM trainer on the CPU without JAX: checkpoints in the
reference layout ``{step, model, opt, ema, scaler, version}`` that
``load_dgm_checkpoint`` (``strict=True``) and ``dgm_sample --torch-ckpt``
take as they are, a resume that continues bit for bit as an uninterrupted
run, and the ``dgm_train`` CLI at a tiny size (dim 8, mults (1, 2), 16x16,
batch 4 in 2 microbatches)."""

import os

import numpy as np
import pytest
import torch

from dmhomo_torch.cli import dgm_sample, dgm_train
from dmhomo_torch.data.conditions import synthetic_condition_batches
from dmhomo_torch.diffusion.gaussian import DiffusionConfig
from dmhomo_torch.models.convert import load_dgm_checkpoint
from dmhomo_torch.models.unet import ConditionalUNet, UNetConfig
from dmhomo_torch.train.config import DGMTrainConfig
from dmhomo_torch.train.dgm_trainer import DGMTrainer, checkpoint_steps

S = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(root, bf16=False):
    cfg = DGMTrainConfig(unet=UNetConfig(dim=8, dim_mults=(1, 2), num_classes=2),
                         diffusion=DiffusionConfig(image_size=S, sampling_timesteps=4),
                         train_batch_size=4, gradient_accumulate_every=2, bf16=bf16,
                         ema_update_every=1, results_dir=str(root))
    tr = DGMTrainer(cfg, device="cpu")
    tr.init_state(3)
    return tr


def _batches():
    return synthetic_condition_batches(8, S, 4, 2, seed=1)


def test_checkpoint_loads_in_load_dgm_checkpoint(tmp_path):
    tr = _trainer(tmp_path)
    batches, gen = _batches(), torch.Generator().manual_seed(0)
    for _ in range(2):
        tr.train_step(*next(batches), generator=gen)
    path = tr.save()
    assert os.path.basename(path) == "model-2.pt"
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert set(ckpt) == {"step", "model", "opt", "ema", "scaler", "version"}
    assert ckpt["step"] == 2 and ckpt["scaler"] is None
    assert int(ckpt["ema"]["step"]) == 2 and bool(ckpt["ema"]["initted"])
    names = [n for n, _ in tr.model.named_parameters()]
    assert set(ckpt["model"]) == {f"model.{n}" for n in names}
    # the EMA moved away from the weights (decay 0 copies at step 1 and 2;
    # perturb the average to tell the two apart)
    tr.ema.params[0].add_(1.0)
    path = tr.save()
    for use_ema in (True, False):
        model = ConditionalUNet(tr.unet_config)
        assert load_dgm_checkpoint(model, path, use_ema=use_ema) == 2
        want = tr.ema.params if use_ema else [p.detach() for p in tr.model.parameters()]
        for (n, p), w in zip(model.named_parameters(), want):
            assert torch.equal(p.detach(), w), (use_ema, n)


def test_resume_continues_bit_for_bit(tmp_path):
    batches = _batches()
    data = [next(batches) for _ in range(3)]
    whole = _trainer(tmp_path / "whole", bf16=True)
    gen = torch.Generator().manual_seed(0)
    for b in data:
        whole.train_step(*b, generator=gen)

    first = _trainer(tmp_path / "cut", bf16=True)
    gen = torch.Generator().manual_seed(0)
    for b in data[:2]:
        first.train_step(*b, generator=gen)
    first.save()
    resumed = _trainer(tmp_path / "cut", bf16=True)
    resumed.init_state(99)  # other weights: the checkpoint must replace them all
    resumed.load()
    assert resumed.step == 2
    resumed.train_step(*data[2], generator=gen)

    assert resumed.step == whole.step == 3 and resumed.ema.step == whole.ema.step
    for a, b in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(resumed.ema.params, whole.ema.params):
        assert torch.equal(a, b)
    sa, sb = resumed.optimizer.state_dict()["state"], whole.optimizer.state_dict()["state"]
    for k in sb:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k][name], sb[k][name]), (k, name)


def test_keeps_the_newest_checkpoints(tmp_path):
    tr = _trainer(tmp_path)
    for step in range(1, 6):
        tr.step = step
        tr.save()
    assert sorted(checkpoint_steps(tmp_path)) == [3, 4, 5]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_dgm_train_cli_then_dgm_sample(tmp_path):
    results = tmp_path / "results"
    out = dgm_train.main(["--synthetic", "8", "--dim", "8", "--dim-mults", "1,2",
                          "--image-size", "16", "--batch-size", "4", "--accum", "2",
                          "--steps", "3", "--device", "cpu", "--results", str(results)])
    assert out["step"] == 3 and out["checkpoint"] == str(results / "model-3.pt")
    assert out["loss"] == out["loss"] and out["loss"] > 0  # finite
    gen = dgm_sample.main(["--torch-ckpt", out["checkpoint"], "--synthetic", "8", "--dim", "8",
                           "--dim-mults", "1,2", "--image-size", "16", "--s-step", "4",
                           "--bs", "2", "--exp", "smoke", "--batches", "2", "--device", "cpu",
                           "--out", str(tmp_path / "gen")])
    assert gen["samples"] == 4 and len(gen["shards"]) == 1
    # --resume continues from model-3.pt
    out = dgm_train.main(["--synthetic", "8", "--dim", "8", "--dim-mults", "1,2",
                          "--image-size", "16", "--batch-size", "4", "--accum", "2",
                          "--steps", "4", "--device", "cpu", "--results", str(results),
                          "--resume", "--no-bf16"])
    assert out["step"] == 4 and sorted(checkpoint_steps(results)) == [3, 4]


def test_sample_with_ema_or_online_weights():
    tr = _trainer("unused")
    cond, classes = next(_batches())
    cond = torch.from_numpy(cond[:2])
    classes = torch.from_numpy(classes[:2]).long()
    tr.ema.params = [e + 0.01 for e in tr.ema.params]
    imgs = [tr.sample(classes, cond[..., 7:10], cond[..., 6:7], use_ema=u,
                      generator=torch.Generator().manual_seed(0)) for u in (True, False)]
    for im in imgs:
        assert im.shape == (2, S, S, 6) and bool(torch.isfinite(im).all())
    assert not torch.equal(imgs[0], imgs[1])
    assert tr.model.training


def test_dgm_training_defaults_to_the_card(monkeypatch, tmp_path):
    """Without --device cpu / device='cpu' the trainer and the CLI take the
    card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DGMTrainer(DGMTrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dgm_train.main(["--synthetic", "4", "--dim", "8", "--dim-mults", "1,2",
                        "--image-size", "16", "--batch-size", "2", "--steps", "1",
                        "--results", str(tmp_path)])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs the DGM step there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_step_with_and_without_remat(cuda_device, bf16):
    """On the card one step of a small UNet (dim 16, mults (1, 2), 32x32,
    batch 4 in 2 microbatches) from the same weights and draws: the
    linear-attention kernels launch once per site and microbatch (4 sites),
    twice with remat (the recompute), never the plain version; the losses
    agree, and each gradient lies within 1e-5 (fp32) or 3e-2 (bf16) of its
    largest value, or within 10 times the change its own run without remat
    makes for conditions moved by 1e-7 (remat sums a block's gradients into
    the shared time and class embedding in another order, and some of those
    sums cancel, as the card-vs-CPU steps of chip_smoke.py allow)."""
    from dmhomo_torch.ops import linear_attention as la

    cond, cls = next(synthetic_condition_batches(4, 32, 4, 2, seed=5))
    nudged = cond + 1e-7 * np.random.default_rng(8).normal(size=cond.shape).astype(np.float32)
    gen = torch.Generator().manual_seed(6)
    draws = [(torch.randint(0, 1000, (2,), generator=gen), torch.randn(2, 32, 32, 6, generator=gen),
              torch.tensor([True, False])) for _ in range(2)]
    grads, losses = [], []
    for remat, c in ((False, cond), (True, cond), (False, nudged)):
        cfg = DGMTrainConfig(unet=UNetConfig(dim=16, dim_mults=(1, 2), num_classes=2, remat=remat),
                             diffusion=DiffusionConfig(image_size=32, sampling_timesteps=4),
                             train_batch_size=4, gradient_accumulate_every=2, bf16=bf16)
        tr = DGMTrainer(cfg, device=cuda_device)
        tr.init_state(7)
        before = (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches)
        losses.append(float(tr.loss_and_grads(c, cls, draws=draws)))
        torch.cuda.synchronize()
        launched = (la.linear_attention_pass1.launches - before[0],
                    la.linear_attention_pass2.launches - before[1])
        assert launched == ((16, 16) if remat else (8, 8))
        grads.append({n: p.grad.detach().float().cpu() for n, p in tr.model.named_parameters()})
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    base = 3e-2 if bf16 else 1e-5
    for n, g in grads[0].items():
        scale = float(g.abs().max()) + 1e-30
        own = float((grads[2][n] - g).abs().max()) / scale
        assert float((grads[1][n] - g).abs().max()) / scale <= max(base, 10 * own), n
