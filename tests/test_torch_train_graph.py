"""The port's HEM training step as a CUDA graph (``HEMTrainer.train_steps``)
and ``hem_train --fuse-steps``, without JAX (the card has none).

On the CPU: ``--fuse-steps`` trains as step-by-step training does.  On the
card (``gpu`` marker, skipped here inside a fixture): one eager step makes
no host sync; ``train_steps`` replays a CUDA graph whose steps agree with
eager ones (fp32: losses within 1e-5 relative, weights within 2 lr) and
launch the eager step's kernels; a capture that fails raises.  The kernels
take 8x8 windows, so these use the shipped widths and window with one or
two blocks per level and a 128x128 crop.
"""

import numpy as np
import pytest
import torch

from dmhomo_torch.config import EstimatorConfig, SwinConfig
from dmhomo_torch.train.config import HEMTrainConfig
from dmhomo_torch.train.hem_trainer import HEMTrainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


def test_hem_train_cli_fuse_steps_on_cpu(tmp_path):
    """``--fuse-steps 3`` over 5 steps (chunks of 3 and 2) writes the same
    checkpoint as step-by-step training on the same batches."""
    from dmhomo_torch.cli import hem_train
    from dmhomo_torch.utils.checkpoint import checkpoint_path

    ckpts = []
    for fuse in ("1", "3"):
        out = str(tmp_path / f"fuse{fuse}")
        tr = hem_train.main(["--synthetic", "16", "--tiny", "--device", "cpu", "--out", out,
                             "--steps", "5", "--fuse-steps", fuse])
        assert tr.step == 5
        ckpts.append(torch.load(checkpoint_path(out, "latest"), map_location="cpu",
                                weights_only=True))
    assert_same(ckpts[1], ckpts[0])
    assert tr.step_graph is None and not tr._graphs  # no graphs on the CPU


def test_resume_takes_this_devices_adam_form(tmp_path):
    """A checkpoint written on the card holds Adam's capturable form; a
    trainer on the CPU resumes from it in its own form and trains on."""
    from dmhomo_torch.cli.hem_train import tiny_config
    from dmhomo_torch.data.hem_data import SyntheticHomoPairs
    from dmhomo_torch.data.loader import DataLoader
    from dmhomo_torch.utils.checkpoint import checkpoint_path

    cfg = tiny_config(2, False, str(tmp_path))
    est = cfg.estimator
    batch = next(iter(DataLoader(SyntheticHomoPairs(8, est.crop_size, est.ori_size, rho=3), 8)))
    tr = HEMTrainer(cfg, device="cpu")
    tr.init_state(0)
    tr.train_step(batch)
    path = tr.save(tag="latest")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for group in ckpt["optimizer"]["param_groups"]:
        group["capturable"] = True  # as the card writes it
    torch.save(ckpt, checkpoint_path(str(tmp_path), "latest"))
    resumed = HEMTrainer(cfg, device="cpu")
    resumed.load(str(tmp_path), "latest")
    assert not resumed.optimizer.param_groups[0]["capturable"] and resumed.step == 1
    tr.train_step(batch)
    resumed.train_step(batch)
    assert_same(resumed.model.state_dict(), tr.model.state_dict())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs train_steps there")
    return torch.device("cuda")


def _kernel_config(attn_impl: str, bf16: bool) -> HEMTrainConfig:
    """The shipped widths, heads and window with two blocks on the finest
    sub-levels (W-MSA and SW-MSA) and one on the others, at a 128x128 crop
    (the coarsest map 16x16): shapes every kernel takes."""
    swin = SwinConfig(crop_size=(128, 128), depths=(2, 1, 1))
    return HEMTrainConfig(estimator=EstimatorConfig(ori_size=(144, 144), swin=swin),
                          bf16=bf16, train_batch_size=8, attn_impl=attn_impl)


def _device_batches(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    return [{"imgs_gray_patch": torch.from_numpy(
                 rng.normal(0, 1, (8, 128, 128, 2)).astype(np.float32)).to(dev),
             "flow_gt_patch": torch.from_numpy(
                 rng.normal(0, 3, (8, 128, 128, 4)).astype(np.float32)).to(dev)}
            for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("attn_impl", ["auto", "fused_block"])
def test_cuda_eager_step_makes_no_host_sync(cuda_device, attn_impl):
    """A warm eager step on a batch already on the card waits for nothing:
    no copy from the host, no read of a device value."""
    tr = HEMTrainer(_kernel_config(attn_impl, bf16=True), device=cuda_device)
    tr.init_state(0)
    batch = _device_batches(1, cuda_device)[0]
    tr.train_step(batch)  # the device tables, kernel attributes and Adam's state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = tr.train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(losses["total"]).item() and tr.step == 2


@pytest.mark.gpu
@pytest.mark.parametrize("attn_impl", ["auto", "fused_block"])
@torch.no_grad()
def test_cuda_graph_steps_match_eager(cuda_device, attn_impl):
    """3 fp32 steps (the first eager, then two replays) against 3 eager
    steps from the same start: losses within 1e-5 relative, weights within
    2 lr (an element whose gradient is near zero may move either way, as
    between two eager runs); after the first replay, whose forward reads the
    weights of the eager first step, the BatchNorm statistics within 1e-5 of
    their largest value.  Each replay's launches, counted at capture, are an
    eager step's; the wrappers' counters moved for the eager steps only."""
    from dmhomo_torch.train.hem_trainer import LAUNCH_COUNTERS

    def counts():
        return {fn.__name__: fn.launches for fn in LAUNCH_COUNTERS}

    def moved(before):
        return {k: v - before[k] for k, v in counts().items()}

    cfg = _kernel_config(attn_impl, bf16=False)
    eager, graph = (HEMTrainer(cfg, steps_per_epoch=2, device=cuda_device) for _ in range(2))
    eager.init_state(0)
    graph.init_state(0)
    batches = _device_batches(3, cuda_device, seed=1)
    want = []
    for b in batches[:2]:
        before = counts()
        with torch.enable_grad():
            want.append(eager.train_step(b))
        per_step = moved(before)
    before = counts()
    with torch.enable_grad():
        got = graph.train_steps(batches[:2])
    assert moved(before) == per_step  # the eager first step only
    assert graph.step_graph.launches == per_step
    kernels = ("swin_block", "swin_block_backward") if attn_impl == "fused_block" else \
        ("window_attention", "window_attention_backward")
    assert all(per_step[k] > 0 for k in kernels)
    eager_bufs = dict(eager.model.named_buffers())
    for n, v in graph.model.named_buffers():
        if "running_" in n:
            u = eager_bufs[n]
            assert float((v - u).abs().max()) <= 1e-5 * float(u.abs().max()), n

    before = counts()
    with torch.enable_grad():
        want.append(eager.train_step(batches[2]))
        last = graph.train_steps(batches[2:])
    got = {k: torch.cat([v, last[k]]) for k, v in got.items()}
    assert moved(before) == per_step  # the eager step; the replay moved nothing
    for k in want[0]:
        w = torch.stack([x[k] for x in want])
        assert float(((got[k] - w).abs() / w.abs().clamp_min(1e-30)).max()) <= 1e-5, k
    assert (graph.step, graph.epoch, graph.lr) == (eager.step, eager.epoch, eager.lr)
    for (n, p), q in zip(graph.model.named_parameters(), eager.model.parameters()):
        assert float((p - q).abs().max()) <= 2 * cfg.lr, n


@pytest.mark.gpu
def test_cuda_capture_failure_raises(cuda_device, monkeypatch):
    """A step that cannot be captured (here: a host read inside it) makes
    ``train_steps`` raise after its eager first step; the second step does
    not run eagerly instead."""
    import dmhomo_torch.train.hem_trainer as ht

    real = ht.compute_losses

    def reads_the_loss(*args, **kw):
        out = real(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            out["total"].item()
        return out

    monkeypatch.setattr(ht, "compute_losses", reads_the_loss)
    tr = HEMTrainer(_kernel_config("auto", bf16=False), device=cuda_device)
    tr.init_state(0)
    with pytest.raises(RuntimeError):
        tr.train_steps(_device_batches(2, cuda_device, seed=2))
    assert tr.step == 1 and not tr._graphs
