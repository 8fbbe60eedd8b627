"""The port's K-steps-per-call training (``HEMTrainer.train_steps``,
``train_and_evaluate(fuse_steps=...)``, ``hem_train --fuse-steps``) and the
clip-validity diagnostic ``logit_health``, against the JAX trainer's.

On the CPU, on the tiny fp32 config and start of ``test_torch_train.py``
(its docstring states the tolerances used here): ``train_steps`` with K=3
against the JAX trainer's scanned ``train_steps`` on a 1-device mesh, and
against three ``train_step`` calls (equal); the chunking of the training
loop against JAX's on stub steps; ``logit_health`` against JAX's within
1e-5 relative.  The JAX programs run once, in a module fixture.  The
card's side is ``test_torch_train_graph.py``.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from dmhomo_tpu.parallel import make_mesh
from dmhomo_tpu.train.hem_trainer import HEMTrainer as JaxTrainer

from dmhomo_torch.train.hem_trainer import HEMTrainer
from test_torch_train import (
    B,
    STEPS_PER_EPOCH,
    _jax_config,
    _port_config,
    _port_trainer,
    _state_dicts,
    start,  # noqa: F401  (module fixture: shared weights and batches)
)
from test_torch_train_graph import assert_same

ACCUM = 2  # microbatches per step on both sides


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(start):
    """The JAX trainer from the shared start: K=3 scanned steps, and
    ``logit_health`` of the start weights on the first batch."""
    params, stats, batches = start
    jt = JaxTrainer(_jax_config(ACCUM), mesh=make_mesh(jax.devices()[:1]),
                    steps_per_epoch=STEPS_PER_EPOCH)
    jt.init_state()
    jt.load_params(params, stats)
    health = jt.logit_health(batches[0]["imgs_gray_patch"])
    losses = {k: np.asarray(v) for k, v in jax.device_get(
        jt.train_steps([dict(b) for b in batches])).items()}
    return jt, losses, health


def test_train_steps_match_jax(start, jax_run):
    """K=3 in one call on each side: per-step losses, LR, step, epoch,
    BatchNorm statistics and parameters."""
    import optax

    params, stats, batches = start
    jt, want_losses, _ = jax_run
    tr = _port_trainer(ACCUM, params, stats)
    got = tr.train_steps(batches)
    assert set(got) == set(want_losses)
    for k, v in got.items():
        assert tuple(v.shape) == (3,), k
    for i in range(3):
        assert float(got["total"][i]) == pytest.approx(float(want_losses["total"][i]),
                                                       rel=2e-6 if i == 0 else 1e-4)
        assert float(got["nll"][i]) == pytest.approx(float(want_losses["nll"][i]),
                                                     rel=2e-6 if i == 0 else 1e-4)
    assert (tr.step, tr.epoch) == (3, 1)
    assert (int(jax.device_get(jt.state["step"])), int(jax.device_get(jt.state["epoch"]))) \
        == (3, 1)
    schedule = optax.exponential_decay(1e-4, STEPS_PER_EPOCH, 0.8, staircase=True)
    assert tr.lr == pytest.approx(float(schedule(3)), rel=1e-6)

    want, have = _state_dicts(jt, tr)
    diffs = []
    for n, v in want.items():
        d = (have[n] - v).abs()
        if "running_" in n:
            assert float(d.max()) <= 2e-3 * float(v.abs().max()), n
        else:
            assert float(d.max()) <= 6e-4, n
            diffs.append(d.flatten())
    assert float((torch.cat(diffs) > 1e-5).float().mean()) < 0.01


def _full_state(tr):
    """Weights, buffers, Adam's moments and step counts, LR state."""
    opt = tr.optimizer.state_dict()
    return (tr.model.state_dict(), opt["state"], opt["param_groups"],
            tr.scheduler.state_dict(), tr.step, tr.epoch, tr.lr)


@pytest.mark.parametrize("schema", ["patches", "raw"])
def test_train_steps_equal_train_step_calls(start, schema):
    """On the CPU ``train_steps`` is K ``train_step`` calls: the same losses
    and the same state, bit for bit, in either batch schema."""
    params, stats, batches = start
    if schema == "raw":
        batches = _raw_batches(3, np.random.default_rng(5))
    one, many = (_port_trainer(ACCUM, params, stats) for _ in range(2))
    want = [one.train_step(b) for b in batches]
    got = many.train_steps(batches)
    for k in want[0]:
        assert torch.equal(got[k], torch.stack([w[k] for w in want])), k
    assert_same(_full_state(many), _full_state(one))


def _raw_batches(n, rng):
    """Raw-schema batches (``device_build_patches``' inputs) at the tiny
    config's sizes: 6-channel uint8 pairs at 40x72, homographies, crop starts."""
    out = []
    for _ in range(n):
        homo = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        homo[:, :2, 2] = rng.uniform(-2, 2, (B, 2))
        out.append({"img12": rng.integers(0, 256, (B, 6, 40, 72), dtype=np.uint8),
                    "homo": homo, "homo_inv": np.linalg.inv(homo).astype(np.float32),
                    "start": rng.integers(0, 5, (B, 2)).astype(np.int32)})
    return out


class _Log:
    def __init__(self, events):
        self.events = events

    def info(self, msg):
        if msg.startswith("step "):
            self.events.append(("log", msg.split()[1]))


def _stub_loop(trainer, counts_steps, events):
    """Replaces a trainer's steps, eval and saves with recorders; with
    ``counts_steps`` the stubs advance ``trainer.step`` (the port's loop
    reads it; the JAX loop counts on its own)."""
    evals = itertools.count()

    def train_step(batch):
        events.append(("steps", 1))
        if counts_steps:
            trainer.step += 1
        return {"total": np.float32(0.0)}

    def train_steps(bs):
        events.append(("steps", len(bs)))
        if counts_steps:
            trainer.step += len(bs)
        return {"total": np.zeros(len(bs), np.float32)}

    def evaluate(it, split="val"):
        report = {"AVG": (3.0, 1.0, 2.0, 0.5)[next(evals) % 4]}
        trainer.metrics.reset(split)
        trainer.metrics.update(split, report)
        events.append(("eval",))
        return report

    trainer.train_step, trainer.train_steps, trainer.evaluate = train_step, train_steps, evaluate
    trainer.save = lambda root=None, tag="latest": events.append(("save", tag))
    trainer.logger = _Log(events)


@pytest.mark.parametrize("total,every,fuse,log_every",
                         [(10, 4, 3, 2), (7, 3, 5, 1), (12, 5, 1, 4), (9, 9, 4, 100),
                          (6, 2, 6, 3)])
def test_fuse_steps_chunking_matches_jax(total, every, fuse, log_every):
    """The chunks, logs, evals and saves of ``train_and_evaluate`` with
    ``fuse_steps`` in the JAX trainer's order, on stub steps."""
    want, got = [], []
    jcfg = dataclasses.replace(_jax_config(1), train_num_steps=every)
    jt = JaxTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]))
    jt.state = {"step": np.int32(0)}
    _stub_loop(jt, False, want)
    jt.train_and_evaluate(itertools.count(), eval_loader=[], total_steps=total,
                          log_every=log_every, fuse_steps=fuse)

    tr = HEMTrainer(dataclasses.replace(_port_config(1), train_num_steps=every), device="cpu")
    tr.model = torch.nn.Identity()  # the stubs take no model
    _stub_loop(tr, True, got)
    tr.train_and_evaluate(itertools.count(), eval_loader=[], total_steps=total,
                          log_every=log_every, fuse_steps=fuse)
    assert got == want
    assert tr.step == total
    assert sum(e[1] for e in got if e[0] == "steps") == total


def test_logit_health_matches_jax(start, jax_run):
    params, stats, batches = start
    _, _, want = jax_run
    tr = _port_trainer(1, params, stats)
    got = tr.logit_health(batches[0]["imgs_gray_patch"])
    assert got == pytest.approx(want, rel=1e-5)
    assert 0 < got < 60


def test_logit_health_fused_block_runs_the_unfused_twin(start):
    """Under ``fused_block`` the twin runs unfused blocks (the whole-block
    kernel keeps its logits on chip too): the same reading as the unfused
    model's on the same weights, and the training model stays fused."""
    from dmhomo_torch.models.swin import SwinBlock

    params, stats, batches = start
    plain = _port_trainer(1, params, stats)
    fused = HEMTrainer(dataclasses.replace(_port_config(1), attn_impl="fused_block"),
                       steps_per_epoch=STEPS_PER_EPOCH, device="cpu")
    fused.init_state()
    fused.load_params(params, stats)
    imgs = batches[1]["imgs_gray_patch"]
    assert fused.logit_health(imgs) == plain.logit_health(imgs)
    assert all(m.fused for m in fused.model.modules() if isinstance(m, SwinBlock))
    assert not any(m.fused for m in fused._health_model.modules() if isinstance(m, SwinBlock))
