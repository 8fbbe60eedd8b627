"""``DGMTrainer.train_steps`` and ``train(fuse_steps, on_milestone)``
against the JAX package's, on the CPU (the CUDA graph of the step on the
card: ``test_torch_dgm_graph.py``, without JAX).

* K=3 steps of ``train_steps`` on the JAX draws (``jax.random.split(key,
  K)``, each step's key split per microbatch as ``_step_body`` splits it)
  give the per-step losses of JAX ``train_steps`` within 1e-5 relative,
  the weights within 2 lr x 3 (``test_torch_dgm_train.py``'s rule over
  three steps) and the same EMA step; and equal K ``train_step`` calls bit
  for bit (on the CPU ``train_steps`` is those calls).
* ``load_params`` and ``load_state_dict`` free a captured step.
* ``train``'s chunks and milestones are the JAX loop's: the JAX
  ``DGMTrainer.train`` run on a stand-in trainer that records what it is
  asked, beside the port's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from dmhomo_tpu.models.unet import ConditionalUNet as JaxUNet
from dmhomo_tpu.models.unet import UNetConfig as JaxUNetConfig
from dmhomo_tpu.parallel import make_mesh
from dmhomo_tpu.train.config import DGMTrainConfig as JaxDGMConfig
from dmhomo_tpu.train.dgm_trainer import DGMTrainer as JaxDGMTrainer
from dmhomo_tpu.train.ema import ema_init as jax_ema_init

from dmhomo_torch.data.conditions import synthetic_condition_batches
from dmhomo_torch.models.convert import unet_state_dict_from_jax
from dmhomo_torch.train.dgm_trainer import DGMTrainer
from test_torch_data_parallel import _fill, _step_draws
from torch_dp_ranks import dgm_config

K, B, ACCUM, LR, S, CLASSES = 3, 4, 2, 5e-4, 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    """(params, K batches, the chunk's key, JAX's losses and state)."""
    unet = JaxUNet(JaxUNetConfig(dim=8, dim_mults=(1, 2), num_classes=CLASSES))
    dummy = dict(x=jnp.zeros((1, S, S, 6)), time=jnp.zeros((1,), jnp.int32),
                 classes=jnp.zeros((1,), jnp.int32), rgb_flow=jnp.zeros((1, S, S, 3)),
                 mask=jnp.ones((1, S, S, 1)), keep_mask=jnp.ones((1,), bool))
    shapes = jax.eval_shape(lambda k: unet.init(k, **dummy), jax.random.PRNGKey(0))
    params = _fill(shapes["params"], np.random.default_rng(4))
    batches = synthetic_condition_batches(8, S, B, CLASSES, seed=6)
    data = [next(batches) for _ in range(K)]
    key = jax.random.PRNGKey(13)
    jcfg = JaxDGMConfig(unet=JaxUNetConfig(dim=8, dim_mults=(1, 2), num_classes=CLASSES),
                        diffusion=JaxDiffusionConfig(image_size=S, timesteps=1000,
                                                     sampling_timesteps=4),
                        train_batch_size=B, gradient_accumulate_every=ACCUM, bf16=False, lr=LR,
                        ema_update_every=2, seed=0)
    jt = JaxDGMTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]))
    p = jax.tree.map(jnp.asarray, params)
    state = {"params": p, "opt_state": jt.tx.init(p), "ema": jax_ema_init(p),
             "step": jnp.zeros((), jnp.int32)}
    jt.state_shardings = jt._state_shardings(state)
    jt.state = state
    losses = jt.train_steps(np.stack([d[0] for d in data]), np.stack([d[1] for d in data]), key)
    return {"params": params, "data": data, "key": key,
            "jax_losses": [float(v) for v in np.asarray(losses)],
            "jax_params": jax.tree.map(np.asarray, jax.device_get(jt.state["params"])),
            "jax_ema_step": int(jt.state["ema"].step)}


def _port(params):
    tr = DGMTrainer(dgm_config(B, ACCUM, LR, 2), device="cpu")
    tr.init_state()
    tr.load_params(params)
    return tr


def _draws(key):
    return [_step_draws(k, B, ACCUM) for k in jax.random.split(key, K)]


def test_train_steps_match_jax_train_steps(start):
    tr = _port(start["params"])
    data = start["data"]
    losses = tr.train_steps(np.stack([d[0] for d in data]), np.stack([d[1] for d in data]),
                            draws=_draws(start["key"]))
    assert losses.shape == (K,) and tr.step == K and tr.ema.step == start["jax_ema_step"] == K
    for got, want in zip(losses.tolist(), start["jax_losses"]):
        assert got == pytest.approx(want, rel=1e-5)
    want = unet_state_dict_from_jax(start["jax_params"], tr.unet_config)
    diffs = []
    for n, p in tr.model.named_parameters():
        d = (p.detach() - want[n]).abs()
        assert float(d.max()) <= 2 * LR * K + 1e-6, n
        diffs.append(d.flatten())
    assert float((torch.cat(diffs) > 1e-5).float().mean()) < 0.01


@pytest.mark.parametrize("load", ["load_params", "load_state_dict"])
def test_loading_frees_the_captured_step(start, load):
    """A captured step updates the EMA and Adam's state that a load
    replaces: the load frees it (on the card the next ``train_steps``
    captures anew; the CPU captures none, so a stand-in marks the slot)."""
    tr = _port(start["params"])
    saved = tr.state_dict()
    tr.step_graph = object()
    if load == "load_params":
        tr.load_params(start["params"])
    else:
        tr.load_state_dict(saved)
    assert tr.step_graph is None


def test_train_steps_equal_train_step_calls(start):
    data, draws = start["data"], _draws(start["key"])
    fused, single = _port(start["params"]), _port(start["params"])
    losses = fused.train_steps(torch.stack([torch.from_numpy(d[0]) for d in data]),
                               torch.stack([torch.from_numpy(d[1]) for d in data]), draws=draws)
    want = [single.train_step(img, cls, draws=d)["loss"] for (img, cls), d in zip(data, draws)]
    assert torch.equal(losses, torch.stack(want))
    for a, b in zip(fused.model.parameters(), single.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(fused.ema.params, single.ema.params):
        assert torch.equal(a, b)
    sa, sb = fused.optimizer.state_dict()["state"], single.optimizer.state_dict()["state"]
    for i in sb:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


class _Recorder:
    """What a trainer's loop asks of it: steps per call, saves, milestones."""

    def __init__(self):
        self.calls, self.saves, self.milestones = [], [], []


@pytest.mark.parametrize("num_steps,save_every,fuse", [(7, 3, 2), (10, 4, 3), (5, 5, 8),
                                                       (6, 2, 1)])
def test_train_chunks_as_the_jax_loop(tmp_path, monkeypatch, num_steps, save_every, fuse):
    """The chunk sizes, the steps saved at and the milestones of the port's
    ``train`` equal those of the JAX ``train`` loop."""
    # the JAX loop, on a stand-in trainer
    jrec = _Recorder()

    class JaxStandIn:
        config = JaxDGMConfig(seed=0)
        state = {"step": jnp.zeros((), jnp.int32)}
        logger = type("L", (), {"info": staticmethod(lambda *_: None)})()

        def train_step(self, img, cls, key):
            jrec.calls.append(1)
            return jnp.zeros(())

        def train_steps(self, imgs, cls, key):
            jrec.calls.append(len(imgs))
            return jnp.zeros((len(imgs),))

        def save(self):
            jrec.saves.append(sum(jrec.calls))

    one = (np.zeros((1,)), np.zeros((1,)))
    JaxDGMTrainer.train(JaxStandIn(), iter([one] * 100), num_steps=num_steps,
                        save_every=save_every, fuse_steps=fuse,
                        on_milestone=lambda tr, step: jrec.milestones.append(step))
    # the port's loop, on a tiny trainer whose steps are recorded
    tr = DGMTrainer(dataclasses.replace(dgm_config(2, 1, LR, 10), results_dir=str(tmp_path)),
                    device="cpu")
    tr.init_state()
    prec = _Recorder()
    step_one, step_many, save = tr.train_step, tr.train_steps, tr.save

    inside = []  # on the CPU train_steps runs train_step calls: not the loop's

    def train_step(*a, **kw):
        if not inside:
            prec.calls.append(1)
        return step_one(*a, **kw)

    def train_steps(imgs, *a, **kw):
        prec.calls.append(len(imgs))
        inside.append(1)
        try:
            return step_many(imgs, *a, **kw)
        finally:
            inside.pop()

    def saved(*a, **kw):
        prec.saves.append(tr.step)
        return save(*a, **kw)

    monkeypatch.setattr(tr, "train_step", train_step)
    monkeypatch.setattr(tr, "train_steps", train_steps)
    monkeypatch.setattr(tr, "save", saved)
    batches = synthetic_condition_batches(4, S, 2, CLASSES, seed=1)
    out = tr.train(batches, num_steps=num_steps, save_every=save_every, fuse_steps=fuse,
                   on_milestone=lambda t, step: prec.milestones.append(step))
    assert (prec.calls, prec.saves, prec.milestones) == (jrec.calls, jrec.saves, jrec.milestones)
    assert tr.step == num_steps and bool(torch.isfinite(out["loss"]))
