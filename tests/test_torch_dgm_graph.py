"""The DGM training step as a CUDA graph (``DGMTrainer.train_steps``),
without JAX (the card has none).

On the CPU: the EMA's device-factor form (``ema_step_decay`` +
``ema_apply_``, what a replay runs) equals ``ema_update`` bit for bit over
130 steps; ``train_steps`` drawing from a generator is ``train_step``
calls on the same stream of draws.  On the card (``gpu`` marker, skipped
here inside a fixture): one eager step makes no host sync; the graph's
steps agree with eager ones drawn from generators seeded alike (fp32:
losses within 1e-5 relative, weights within 2 lr), and the generators'
offsets match after them, so each replay draws anew; a replay launches the
eager step's linear-attention kernels (counted at capture), none generic;
the EMA after 12 graph steps (an update every 10) is the weights after
step 10; after a checkpoint is loaded the step is captured anew and the
graph's steps, EMA included, again match eager ones; a new generator
replaces the captured step and its memory pool.
"""

import gc

import numpy as np
import pytest
import torch

from dmhomo_torch.data.conditions import synthetic_condition_batches
from dmhomo_torch.diffusion.gaussian import DiffusionConfig
from dmhomo_torch.models.unet import UNetConfig
from dmhomo_torch.train.config import DGMTrainConfig
from dmhomo_torch.train.dgm_trainer import DGMTrainer
from dmhomo_torch.train.ema import ema_apply_, ema_init, ema_step_decay, ema_update

CLASSES = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("every", [1, 10])
def test_ema_device_factors_equal_ema_update(every):
    rng = np.random.default_rng(every)
    p0 = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((5, 3), (7,))]
    host, dev = ema_init(p0), ema_init(p0)
    decay, one_minus = torch.zeros(()), torch.zeros(())
    for _ in range(130):
        new = [torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)) for p in p0]
        ema_update(host, new, update_every=every)
        d = ema_step_decay(dev, update_every=every)
        decay.fill_(d)
        one_minus.fill_(1.0 - d)
        ema_apply_(dev, new, decay, one_minus)
        assert dev.step == host.step
        for a, b in zip(dev.params, host.params):
            assert torch.equal(a, b)


def _tiny(dev, ema_every=10, image_size=16, dim=8):
    cfg = DGMTrainConfig(unet=UNetConfig(dim=dim, dim_mults=(1, 2), num_classes=CLASSES),
                         diffusion=DiffusionConfig(image_size=image_size, sampling_timesteps=4),
                         train_batch_size=4, gradient_accumulate_every=2, bf16=False,
                         ema_update_every=ema_every)
    tr = DGMTrainer(cfg, device=dev)
    tr.init_state(3)
    return tr


def test_train_steps_draw_as_train_step_calls():
    cond, cls = next(synthetic_condition_batches(8, 16, 4, CLASSES, seed=2))
    fused, single = _tiny("cpu"), _tiny("cpu")
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = fused.train_steps(np.stack([cond] * 3), np.stack([cls] * 3), generator=g1)
    b = torch.stack([single.train_step(cond, cls, generator=g2)["loss"] for _ in range(3)])
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    for x, y in zip(fused.model.parameters(), single.model.parameters()):
        assert torch.equal(x, y)
    assert fused.step_graph is None  # no graphs on the CPU


@pytest.fixture
def cuda_device():
    """The card; afterwards the test's graphs and their memory pools are
    freed and handed back to the card for the tests after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs the DGM graph step there")
    yield torch.device("cuda")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _card_batches(n, dev):
    cond, cls = next(synthetic_condition_batches(16, 32, 4 * n, CLASSES, seed=8))
    return (torch.from_numpy(cond).to(dev).reshape(n, 4, 32, 32, 12),
            torch.from_numpy(cls.astype(np.int64)).to(dev).reshape(n, 4))


@pytest.mark.gpu
def test_cuda_eager_step_makes_no_host_sync(cuda_device):
    tr = _tiny(cuda_device, image_size=32, dim=16)
    imgs, cls = _card_batches(2, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    tr.train_step(imgs[0], cls[0], generator=gen)  # builds the kernels, Adam's state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr.train_step(imgs[1], cls[1], generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_graph_steps_match_eager(cuda_device):
    """12 steps: eager ones against ``train_steps`` (its first step eager,
    then replays), each drawing from a generator seeded alike."""
    from dmhomo_torch.ops import linear_attention as la

    imgs, cls = _card_batches(12, cuda_device)
    eager, graph = (_tiny(cuda_device, image_size=32, dim=16) for _ in range(2))
    ge, gg = (torch.Generator(device=cuda_device).manual_seed(4) for _ in range(2))
    want = torch.stack([eager.train_step(imgs[k], cls[k], generator=ge)["loss"]
                        for k in range(12)])
    before = (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches)
    got = graph.train_steps(imgs[:10], cls[:10], generator=gg)
    after_10 = [p.detach().clone() for p in graph.model.parameters()]
    got = torch.cat([got, graph.train_steps(imgs[10:], cls[10:], generator=gg)])
    torch.cuda.synchronize()
    eager_launches = (la.linear_attention_pass1.launches - before[0],
                      la.linear_attention_pass2.launches - before[1])
    assert eager_launches == (8, 8)  # the first step of the first call alone ran eagerly
    assert graph.step_graph.launches == {
        "linear_attention_pass1": 8, "linear_attention_pass2": 8,
        "linear_attention_pass1_generic": 0, "linear_attention_pass2_generic": 0}
    assert gg.get_offset() == ge.get_offset()
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-5, (got, want)
    for a, b in zip(graph.model.parameters(), eager.model.parameters()):
        assert float((a - b).abs().max()) <= 2 * graph.config.lr
    assert graph.step == graph.ema.step == 12
    for e, p in zip(graph.ema.params, after_10):
        assert torch.equal(e, p)


@pytest.mark.gpu
def test_cuda_graph_injected_draws_match_eager(cuda_device):
    """Injected draws (static buffers refilled before each replay): the
    losses of eager steps on the same draws."""
    imgs, cls = _card_batches(3, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    draws = [[tuple(x.clone() for x in graph_draw) for graph_draw in (
        (torch.randint(0, 1000, (2,), device=cuda_device, generator=gen),
         torch.randn(2, 32, 32, 6, device=cuda_device, generator=gen),
         torch.rand(2, device=cuda_device, generator=gen) < 0.5) for _ in range(2))]
        for _ in range(3)]
    eager, graph = (_tiny(cuda_device, image_size=32, dim=16) for _ in range(2))
    want = torch.stack([eager.train_step(imgs[k], cls[k], draws=draws[k])["loss"]
                        for k in range(3)])
    got = graph.train_steps(imgs, cls, draws=draws)
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-5, (got, want)


@pytest.mark.gpu
def test_cuda_graph_recaptured_after_load_and_for_a_new_generator(cuda_device, tmp_path):
    """A load replaces the EMA and Adam's state that the captured step
    updates: the next ``train_steps`` captures anew, and its steps, the EMA
    (an update every step) included, match eager ones from the same
    checkpoint.  Each ``train()`` call draws from a new generator: one
    captured step at a time, so the reserved memory stays flat."""
    imgs, cls = _card_batches(6, cuda_device)
    eager, graph = (_tiny(cuda_device, ema_every=1, image_size=32, dim=16) for _ in range(2))
    ge, gg = (torch.Generator(device=cuda_device).manual_seed(6) for _ in range(2))
    graph.train_steps(imgs[:2], cls[:2], generator=gg)
    first = graph.step_graph
    for k in range(2):
        eager.train_step(imgs[k], cls[k], generator=ge)
    eager.save(str(tmp_path))
    for tr in (eager, graph):
        tr.load(str(tmp_path))
    assert graph.step_graph is None
    want = torch.stack([eager.train_step(imgs[k], cls[k], generator=ge)["loss"]
                        for k in range(2, 6)])
    got = graph.train_steps(imgs[2:], cls[2:], generator=gg)
    assert graph.step_graph is not first and gg.get_offset() == ge.get_offset()
    assert float(((got - want).abs() / want.abs()).max()) <= 1e-5, (got, want)
    for tr in (eager, graph):
        assert tr.step == tr.ema.step == 6
    for a, b in zip(graph.ema.params, eager.ema.params):
        assert float((a - b).abs().max()) <= 2 * graph.config.lr
    reserved = []
    for seed in range(3):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        graph.train_steps(imgs[:2], cls[:2], generator=gen)
        torch.cuda.synchronize()
        assert graph.step_graph.generator is gen
        reserved.append(torch.cuda.memory_reserved(cuda_device))
    assert reserved[2] <= reserved[1], reserved
