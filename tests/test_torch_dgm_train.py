"""The port's DGM training against the JAX package's ``DGMTrainer``, on the CPU.

A tiny UNet (dim 8, mults (1, 2), 16x16, 2 classes) with every part of the
shipped architecture, fp32, batch 4.  Both sides start from the same
weights (a JAX init, perturbed so that gains, biases and norms are not
trivial, carried over with ``unet_state_dict_from_jax``), and the port gets
the JAX draws of t, the noise and the CFG keep-mask (``jax.random`` as
``GaussianDiffusion.loss`` takes them, split per microbatch as ``_step_body``
splits its key), injected as numpy arrays.  The JAX trainer runs on a
1-device mesh, so that its batch is not sharded.

Tolerances.  Step 1 starts from the same weights and draws, so only fp32
summation order separates the two (the port's nearest-up then 3x3 conv is
JAX's fused dilated conv, its warp a gather where JAX multiplies by
interpolation matrices):
* the step-1 loss: 2e-6 relative;
* each step-1 gradient: 5e-4 of the tensor's largest |gradient|, + 1e-6;
* the global norm 1e-5 relative, the clip scale 1e-5 relative;
* the parameters after step 1: Adam's first update is about +-lr for every
  element whatever its gradient's size, so an element whose gradient is
  near zero may move the other way in the other framework: 2 lr, with
  fewer than 1% of the elements off by more than 1e-6.
Over three steps with accum 2 the weights drift apart by up to 2 lr per
step on such elements: the losses of steps 2 and 3 within 1e-4 relative,
the parameters and the EMA within 2 lr x 3, fewer than 1% of the elements
off by more than 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
from dmhomo_tpu.models.unet import UNetConfig as JaxUNetConfig
from dmhomo_tpu.parallel import make_mesh
from dmhomo_tpu.train.config import DGMTrainConfig as JaxTrainConfig
from dmhomo_tpu.train.dgm_trainer import DGMTrainer as JaxTrainer
from dmhomo_tpu.train.ema import _decay as jax_decay
from dmhomo_tpu.train.ema import ema_init as jax_ema_init
from dmhomo_tpu.train.ema import ema_update as jax_ema_update

from dmhomo_torch.data.conditions import synthetic_condition_batches
from dmhomo_torch.diffusion.gaussian import DiffusionConfig
from dmhomo_torch.models.convert import unet_state_dict_from_jax
from dmhomo_torch.models.unet import UNetConfig
from dmhomo_torch.train.config import DGMTrainConfig
from dmhomo_torch.train.dgm_trainer import DGMTrainer
from dmhomo_torch.train.ema import ema_decay, ema_init, ema_update

B, S, CLASSES, T = 4, 16, 2, 1000
LR = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are small: one torch thread is faster than many, and
    the suite runs test files side by side in worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_config(accum, ema_every=10):
    return JaxTrainConfig(
        unet=JaxUNetConfig(dim=8, dim_mults=(1, 2), num_classes=CLASSES),
        diffusion=JaxDiffusionConfig(image_size=S, timesteps=T, sampling_timesteps=4),
        train_batch_size=B, gradient_accumulate_every=accum, bf16=False, lr=LR,
        ema_update_every=ema_every, seed=0)


def _port_config(accum, ema_every=10):
    return DGMTrainConfig(
        unet=UNetConfig(dim=8, dim_mults=(1, 2), num_classes=CLASSES),
        diffusion=DiffusionConfig(image_size=S, timesteps=T, sampling_timesteps=4),
        train_batch_size=B, gradient_accumulate_every=accum, bf16=False, lr=LR,
        ema_update_every=ema_every, seed=0)


def _perturb(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        out[k] = (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
    return out


def _draws(key, n):
    """What ``GaussianDiffusion.loss`` draws from ``key`` for n samples:
    (t, noise, keep_mask) as numpy."""
    key_t, key_loss = jax.random.split(key)
    t = jax.random.randint(key_t, (n,), 0, T)
    key_noise, key_drop = jax.random.split(key_loss)
    noise = jax.random.normal(key_noise, (n, S, S, 6), jnp.float32)
    keep = jax.random.uniform(key_drop, (n,)) < 0.5
    return tuple(np.array(a) for a in (t, noise, keep))


def _step_draws(key, accum):
    """Per microbatch, as ``_step_body`` splits the step's key."""
    if accum == 1:
        return [_draws(key, B)]
    return [_draws(k, B // accum) for k in jax.random.split(key, accum)]


@pytest.fixture(scope="module")
def start():
    """(params, 3 condition batches with classes, 3 step keys) for both."""
    jt = JaxTrainer(_jax_config(1), mesh=make_mesh(jax.devices()[:1]))
    jt.init_state()
    params = _perturb(jax.tree.map(np.asarray, jax.device_get(jt.state["params"])),
                      np.random.default_rng(1))
    batches = synthetic_condition_batches(8, S, B, CLASSES, seed=2)
    data = [next(batches) for _ in range(3)]
    keys = list(jax.random.split(jax.random.PRNGKey(5), 3))
    return params, data, keys


def _jax_trainer(accum, params, ema_every=10):
    jt = JaxTrainer(_jax_config(accum, ema_every), mesh=make_mesh(jax.devices()[:1]))
    jt.init_state()
    p = jax.tree.map(jnp.asarray, params)
    jt.state = {"params": p, "opt_state": jt.tx.init(p), "ema": jax_ema_init(p),
                "step": jnp.zeros((), jnp.int32)}
    return jt


def _port_trainer(accum, params, ema_every=10):
    tr = DGMTrainer(_port_config(accum, ema_every), device="cpu")
    tr.init_state()
    tr.load_params(params)
    return tr


def _params(tree, tr):
    return unet_state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(tree)),
                                    tr.unet_config)


@pytest.fixture(scope="module")
def step1(start):
    """The JAX step-1 loss and gradients, and its parameters after the step."""
    import optax

    params, data, keys = start
    jt = _jax_trainer(1, params)
    (img, cls) = data[0]

    def loss_fn(p):
        return jt.gd.loss(p, keys[0], jnp.asarray(img), jnp.asarray(cls))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    norm = float(optax.global_norm(grads))
    jt.train_step(img, cls, keys[0])
    return {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads), "norm": norm,
            "params": jax.tree.map(np.asarray, jax.device_get(jt.state["params"]))}


def test_step1_loss_and_gradients_match_jax(start, step1):
    params, data, keys = start
    tr = _port_trainer(1, params)
    img, cls = data[0]
    loss = tr.loss_and_grads(img, cls, draws=_step_draws(keys[0], 1))
    assert float(loss) == pytest.approx(step1["loss"], rel=2e-6)
    want = _params(step1["grads"], tr)
    for name, p in tr.model.named_parameters():
        g = want[name]
        assert float((p.grad - g).abs().max()) <= 5e-4 * float(g.abs().max()) + 1e-6, name


def test_step1_clip_and_adam_match_jax(start, step1):
    params, data, keys = start
    tr = _port_trainer(1, params)
    img, cls = data[0]
    out = tr.train_step(img, cls, draws=_step_draws(keys[0], 1))
    assert float(out["grad_norm"]) == pytest.approx(step1["norm"], rel=1e-5)
    assert step1["norm"] > 1.0  # the clip acts
    assert float(out["clip_scale"]) == pytest.approx(1.0 / step1["norm"], rel=1e-5)
    want = _params(step1["params"], tr)
    diffs = []
    for name, p in tr.model.named_parameters():
        d = (p.detach() - want[name]).abs()
        assert float(d.max()) <= 2 * LR + 1e-6, name
        diffs.append(d.flatten())
    assert float((torch.cat(diffs) > 1e-6).float().mean()) < 0.01


def test_three_accumulated_steps_match_jax(start):
    """accum 2, the EMA updating every 2 steps: losses, parameters and EMA."""
    params, data, keys = start
    jt = _jax_trainer(2, params, ema_every=2)
    tr = _port_trainer(2, params, ema_every=2)
    for k, ((img, cls), key) in enumerate(zip(data, keys)):
        want = float(jt.train_step(img, cls, key))
        got = float(tr.train_step(img, cls, draws=_step_draws(key, 2))["loss"])
        assert got == pytest.approx(want, rel=2e-6 if k == 0 else 1e-4)
    assert tr.step == 3 and tr.ema.step == int(jt.state["ema"].step) == 3
    tol = 2 * LR * 3
    names = [n for n, _ in tr.model.named_parameters()]
    for what, got in (("params", [p.detach() for p in tr.model.parameters()]),
                      ("ema", tr.ema.params)):
        tree = jt.state["params"] if what == "params" else jt.state["ema"].params
        want = _params(tree, tr)
        diffs = []
        for name, g in zip(names, got):
            d = (g - want[name]).abs()
            assert float(d.max()) <= tol, (what, name)
            diffs.append(d.flatten())
        assert float((torch.cat(diffs) > 1e-5).float().mean()) < 0.01, what
    # the EMA moved at step 2 (decay 0 before update_after_step): step 2's weights
    assert not all(torch.equal(e, p) for e, p in zip(tr.ema.params, tr.model.parameters()))


@pytest.mark.parametrize("step", [1, 10, 100, 101, 102, 110, 120, 1000, 100_000])
def test_ema_decay_matches_jax(step):
    want = float(jax_decay(jnp.asarray(step, jnp.int32), 0.995, 100, 1.0, 2.0 / 3.0, 0.0))
    assert ema_decay(step) == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_ema_updates_match_jax():
    """130 update calls on random parameters: copies every 10th step before
    step 100, then the warmed-up lerp; within fp32 rounding of JAX's."""
    rng = np.random.default_rng(3)
    p0 = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)]
    ours = ema_init([torch.from_numpy(a) for a in p0])
    theirs = jax_ema_init({str(i): jnp.asarray(a) for i, a in enumerate(p0)})
    for _ in range(130):
        new = [rng.normal(size=a.shape).astype(np.float32) for a in p0]
        ema_update(ours, [torch.from_numpy(a) for a in new])
        theirs = jax_ema_update(theirs, {str(i): jnp.asarray(a) for i, a in enumerate(new)})
        if ours.step == 100:  # a plain copy of step 100's parameters
            for o, a in zip(ours.params, new):
                assert torch.equal(o, torch.from_numpy(a))
    assert ours.step == int(theirs.step) == 130
    for i, o in enumerate(ours.params):
        np.testing.assert_allclose(o.numpy(), np.asarray(theirs.params[str(i)]), rtol=1e-6,
                                   atol=1e-6)


def test_config_defaults_match_jax():
    jc, pc = JaxTrainConfig(), DGMTrainConfig()
    for f in dataclasses.fields(pc):
        if f.name in ("unet", "diffusion"):
            continue
        assert getattr(pc, f.name) == getattr(jc, f.name), f.name
    for f in dataclasses.fields(pc.diffusion):
        assert getattr(pc.diffusion, f.name) == getattr(jc.diffusion, f.name), f.name
    for name in ("dim", "num_classes", "dim_mults", "channels", "cond_channels",
                 "resnet_block_groups", "attn_heads", "attn_dim_head", "remat"):
        assert getattr(pc.unet, name) == getattr(jc.unet, name), name


@pytest.mark.slow
def test_full_width_step1_matches_jax():
    """The shipped UNet widths (dim 64, mults 1-2-4-8, 5 classes) at 32x32,
    batch 2, fp32: the step-1 loss and gradients within the tolerances of
    the tiny config's."""
    jcfg = dataclasses.replace(
        _jax_config(1), unet=JaxUNetConfig(num_classes=5), train_batch_size=2,
        diffusion=JaxDiffusionConfig(image_size=32, timesteps=T, sampling_timesteps=4))
    pcfg = dataclasses.replace(
        _port_config(1), unet=UNetConfig(num_classes=5), train_batch_size=2,
        diffusion=DiffusionConfig(image_size=32, timesteps=T, sampling_timesteps=4))
    jt = JaxTrainer(jcfg, mesh=make_mesh(jax.devices()[:1]))
    jt.init_state()
    params = jax.tree.map(np.asarray, jax.device_get(jt.state["params"]))
    img, cls = next(synthetic_condition_batches(2, 32, 2, 5, seed=4))
    key = jax.random.PRNGKey(9)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt.gd.loss(p, key, jnp.asarray(img), jnp.asarray(cls))))(params)
    tr = DGMTrainer(pcfg, device="cpu")
    tr.init_state()
    tr.load_params(params)
    key_t, key_loss = jax.random.split(key)
    key_noise, key_drop = jax.random.split(key_loss)
    draws = [(np.array(jax.random.randint(key_t, (2,), 0, T)),
              np.array(jax.random.normal(key_noise, (2, 32, 32, 6), jnp.float32)),
              np.array(jax.random.uniform(key_drop, (2,)) < 0.5))]
    got = tr.loss_and_grads(img, cls, draws=draws)
    assert float(got) == pytest.approx(float(loss), rel=2e-6)
    want = unet_state_dict_from_jax(jax.tree.map(np.asarray, grads), tr.unet_config)
    for name, p in tr.model.named_parameters():
        g = want[name]
        assert float((p.grad - g).abs().max()) <= 5e-4 * float(g.abs().max()) + 1e-6, name
