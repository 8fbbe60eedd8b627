"""The port's unconditional DGM twin against the JAX package's.

At ``dim=8, dim_mults=(1, 2)``, 16x16, as ``tests/test_aux.py`` sizes it.
JAX ``UncondUNet`` weights (seeded numpy draws of its parameter tree, so
that no bias or gain is trivially 0 or 1) go through
``uncond_unet_state_dict_from_jax`` into the port's ``UncondUNet``
(``load_state_dict(strict=True)``), for the default config,
``self_condition``, ``learned_sinusoidal``, ``random_fourier`` and
``attn_heads=2, attn_dim_head=16``:

* the UNet forward within 1e-5 of the largest output (fp32 summation
  order; the port's nearest-up then conv3x3 is the JAX package's fused
  dilated conv);
* ``_pred_x0_and_noise`` under the three objectives, clipped and not;
* a 4-step DDIM chain and a 4-step DDPM chain with JAX's draws injected
  (reproduced from the keys the JAX sampler splits), within 1e-4 absolute
  of the [0, 1] images (four UNet calls, each 1e-5 relative, through the
  chain's coefficients);
* ``p_losses`` against JAX ``loss`` on the same t, noise and
  self-condition coin (both ways), within 1e-5 relative, and (with the
  self-condition) its gradients against ``jax.grad`` within 1e-4 of each
  tensor's largest value;
* ``CifarDataset`` and ``GHOFTestDataset`` against JAX's on a synthetic
  CIFAR pickle set and a GHOF ``.npy`` in ``tmp_path``, with the same
  ``np.random.Generator`` seed, item for item.

The JAX forwards and losses are jitted once per config, in module fixtures.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_torch.diffusion.uncond import UncondDiffusionConfig, UnconditionalGaussianDiffusion
from dmhomo_torch.models.convert import uncond_unet_state_dict_from_jax
from dmhomo_torch.models.unet_uncond import UncondUNet, UncondUNetConfig

S = 16
VARIANTS = {
    "default": {},
    "self_condition": {"self_condition": True},
    "learned_sinusoidal": {"learned_sinusoidal": True},
    "random_fourier": {"random_fourier": True},
    "heads2_dim16": {"attn_heads": 2, "attn_dim_head": 16},
}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _seeded_params(jmodel, self_condition, seed):
    """The JAX module's parameter tree filled from a numpy generator, by
    the shapes ``jax.eval_shape`` gives (no init to compile): kernels
    normal of std 1/sqrt(fan_in), biases normal of std 0.05, LayerNorm and
    GroupNorm gains 1 + that, Fourier weights standard normal."""
    x0 = jax.ShapeDtypeStruct((1, S, S, 3), jnp.float32)
    t0 = jax.ShapeDtypeStruct((1,), jnp.int32)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x0, t0,
                            x0 if self_condition else None)["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(
                np.float32)
        if name == "weights":
            return rng.normal(size=leaf.shape).astype(np.float32)
        noise = rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        return noise + (1.0 if name in ("scale", "g") else 0.0)

    return jax.tree_util.tree_map_with_path(fill, shapes)


class _Twin:
    """One variant: the JAX module, its jitted apply and seeded params, and
    the port's model carrying the same weights."""

    def __init__(self, name):
        from dmhomo_tpu.models.unet_uncond import UncondUNet as JaxUNet
        from dmhomo_tpu.models.unet_uncond import UncondUNetConfig as JaxConfig

        kw = dict(dim=8, dim_mults=(1, 2), channels=3, **VARIANTS[name])
        self.jcfg, self.cfg = JaxConfig(**kw), UncondUNetConfig(**kw)
        self.jmodel = JaxUNet(self.jcfg)
        self.params = _seeded_params(self.jmodel, self.cfg.self_condition, len(name))
        self.apply = jax.jit(lambda p, x, t, sc: self.jmodel.apply({"params": p}, x, t, sc))
        self.model = UncondUNet(self.cfg)
        self.model.load_state_dict(uncond_unet_state_dict_from_jax(self.params, self.cfg),
                                   strict=True)
        self.model.eval()

    def model_fn(self, params, x, t, x_self_cond, train=False):
        return self.apply(params, x, t, x_self_cond)


@pytest.fixture(scope="module")
def twins():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _Twin(name)
        return cache[name]

    return get


def _inputs(seed, B=3, sc=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    t = np.array([0, 500, 999][:B], np.int32)
    return x, t, (rng.normal(size=(B, S, S, 3)).astype(np.float32) if sc else None)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_unet_matches_jax(twins, name):
    tw = twins(name)
    x, t, sc = _inputs(1, sc=tw.cfg.self_condition)
    want = np.asarray(tw.apply(tw.params, jnp.asarray(x), jnp.asarray(t),
                               None if sc is None else jnp.asarray(sc)))
    with torch.inference_mode():
        got = tw.model(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)),
                       None if sc is None else torch.from_numpy(sc)).numpy()
    assert got.shape == (3, S, S, 3) and got.dtype == np.float32
    assert _rel(got, want) <= 1e-5
    if name == "random_fourier":  # frozen, as the JAX package's stop_gradient
        assert not tw.model.time_mlp[0].weights.requires_grad
    if name == "self_condition":  # None is the zeros
        with torch.inference_mode():
            a = tw.model(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)))
            b = tw.model(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)),
                         torch.zeros(3, S, S, 3))
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _diffusions(tw, **kw):
    from dmhomo_tpu.diffusion.uncond import UncondDiffusionConfig as JaxConfig
    from dmhomo_tpu.diffusion.uncond import UnconditionalGaussianDiffusion as JaxDiffusion

    kw = dict(image_size=S, channels=3, self_condition=tw.cfg.self_condition, **kw)
    return (JaxDiffusion(tw.model_fn, JaxConfig(**kw)),
            UnconditionalGaussianDiffusion(tw.model, UncondDiffusionConfig(**kw), device="cpu"))


@pytest.mark.parametrize("objective", ["pred_noise", "pred_x0", "pred_v"])
def test_pred_x0_and_noise(twins, objective):
    tw = twins("default")
    jgd, gd = _diffusions(tw, timesteps=1000, objective=objective)
    x, t, _ = _inputs(2)
    for clip in (True, False):
        want = jgd._pred_x0_and_noise(tw.params, jnp.asarray(x), jnp.asarray(t), None, clip=clip)
        with torch.inference_mode():
            got = gd._pred_x0_and_noise(torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)),
                                        None, clip=clip)
        for a, b in zip(got, want):
            assert _rel(a.numpy(), b) <= 1e-5


def _jax_sampler_draws(key, shape, steps):
    """The noise the JAX sampler draws from ``key``: the initial image, then
    one draw per step, as its scan splits the key."""
    key, ik = jax.random.split(key)
    init = np.asarray(jax.random.normal(ik, shape))
    zs = []
    for _ in range(steps):
        key, nk = jax.random.split(key)
        zs.append(np.asarray(jax.random.normal(nk, shape)))
    return init, np.stack(zs)


@pytest.mark.parametrize("name, timesteps, sampling", [
    ("default", 40, 4),            # DDIM, 4 steps
    ("default", 4, 4),             # DDPM over all 4 steps
])
def test_sampling_chain_matches_jax(twins, name, timesteps, sampling):
    tw = twins(name)
    jgd, gd = _diffusions(tw, timesteps=timesteps, sampling_timesteps=sampling)
    B, key = 2, jax.random.PRNGKey(7)
    want = np.asarray(jgd.sample(tw.params, key, B))
    fixed = _jax_sampler_draws(key, (B, S, S, 3), sampling)
    got = gd.sample(B, fixed_noise=fixed).numpy()
    assert got.shape == (B, S, S, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _jax_loss_draws(key, B, shape, timesteps, prob):
    """(t, noise, coin) as JAX ``loss`` draws them from ``key``."""
    k_t, k_n, k_sc, _ = jax.random.split(key, 4)
    t = np.asarray(jax.random.randint(k_t, (B,), 0, timesteps))
    noise = np.asarray(jax.random.normal(k_n, shape))
    coin = bool(jax.random.uniform(k_sc, ()) < prob)
    return t, noise, coin


def _key_with_coin(want: bool, B, shape, timesteps):
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        if _jax_loss_draws(key, B, shape, timesteps, 0.5)[2] == want:
            return key
    raise AssertionError("no key gives that coin")


# (variant, diffusion config, the self-condition coin (None: any), gradients too)
LOSS_CASES = [
    ("default", dict(objective="pred_noise", loss_type="l1"), None, False),
    ("default", dict(objective="pred_v", loss_type="l2", p2_loss_weight_gamma=1.0), None, False),
    ("self_condition", dict(objective="pred_x0", loss_type="l1"), True, True),
    ("self_condition", dict(objective="pred_x0", loss_type="l1"), False, True),
]


@pytest.fixture(scope="module")
def jax_losses():
    """One jitted JAX loss (or value and gradient) per variant and config,
    the key an argument."""
    cache = {}

    def get(tw, name, kw, grads, img):
        k = (name, tuple(sorted(kw.items())), grads)
        if k not in cache:
            jgd, _ = _diffusions(tw, timesteps=100, **kw)

            def f(p, key):
                return jgd.loss(p, key, img)

            cache[k] = jax.jit(jax.value_and_grad(f) if grads else f)
        return cache[k]

    return get


@pytest.mark.parametrize("name, kw, coin, grads", LOSS_CASES)
def test_loss_and_gradients_match_jax(twins, jax_losses, name, kw, coin, grads):
    """p_losses on JAX's draws against JAX ``loss``, within 1e-5 relative;
    with ``grads`` each gradient against ``jax.grad`` within 1e-4 of the
    tensor's largest value, or of 1e-3 of the largest gradient of all
    where the tensor's is below that (a conv bias that the GroupNorm right
    after it removes has gradient 0 up to round-off)."""
    tw = twins(name)
    T = 100
    _, gd = _diffusions(tw, timesteps=T, **kw)
    B, shape = 3, (3, S, S, 3)
    img = np.random.default_rng(3).uniform(size=shape).astype(np.float32)
    key = _key_with_coin(coin, B, shape, T) if coin is not None else jax.random.PRNGKey(4)
    t, noise, c = _jax_loss_draws(key, B, shape, T, 0.5)
    out = jax_losses(tw, name, kw, grads, jnp.asarray(img))(tw.params, key)
    want, want_grads = out if grads else (out, None)

    tw.model.zero_grad(set_to_none=True)
    with torch.set_grad_enabled(grads):
        got = gd.loss(torch.from_numpy(img), draws=(t, noise, c))
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    if not grads:
        return
    got.backward()
    want_sd = uncond_unet_state_dict_from_jax(jax.tree.map(np.asarray, want_grads), tw.cfg)
    largest = max(float(np.abs(g.numpy()).max()) for g in want_sd.values())
    for pname, p in tw.model.named_parameters():
        if not p.requires_grad:
            continue
        g = want_sd[pname].numpy()
        scale = max(float(np.abs(g).max()), 1e-3 * largest)
        assert p.grad is not None, pname
        assert float(np.abs(p.grad.numpy() - g).max()) <= 1e-4 * scale, pname


def test_loss_draws_from_the_generator():
    """``loss`` draws (t, noise, coin) from its generator on the images'
    device: the same seed gives the same loss, another another."""
    cfg = UncondUNetConfig(dim=8, dim_mults=(1, 2), self_condition=True)
    from dmhomo_torch.models.unet_uncond import build_uncond_unet

    model = build_uncond_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    gd = UnconditionalGaussianDiffusion(model, UncondDiffusionConfig(
        image_size=8, timesteps=50, self_condition=True), device="cpu")
    img = torch.rand(2, 8, 8, 3)
    t, noise, coin = gd.draw(img.shape, torch.Generator().manual_seed(0))
    assert t.shape == (2,) and noise.shape == img.shape and coin.dim() == 0
    with torch.no_grad():
        a, b, c = (gd.loss(img, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert float(a) == float(b) and float(a) != float(c)


def _cifar_folder(tmp_path):
    rng = np.random.default_rng(9)
    for i in range(1, 6):
        data = rng.integers(0, 256, (3, 3072), dtype=np.uint8)
        with open(tmp_path / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": data, b"labels": [0, 1, 2]}, f)
    return str(tmp_path)


@pytest.mark.parametrize("image_size", [32, 20])  # 20: the cv2 resize
def test_cifar_dataset_matches_jax(tmp_path, image_size):
    from dmhomo_tpu.data.image_data import CifarDataset as JaxCifar

    from dmhomo_torch.data import CifarDataset

    folder = _cifar_folder(tmp_path)
    a = CifarDataset(folder, image_size, True, np.random.default_rng(5))
    b = JaxCifar(folder, image_size, True, np.random.default_rng(5))
    assert len(a) == len(b) == 15
    for i in range(len(a)):
        got, want = a[i], b[i]
        assert got.shape == (image_size, image_size, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_ghof_dataset_matches_jax(tmp_path):
    from dmhomo_tpu.data.image_data import GHOFTestDataset as JaxGHOF

    from dmhomo_torch.data import GHOFTestDataset

    rng = np.random.default_rng(10)
    samples = np.array([{"img1": rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)},
                        {"img1": rng.integers(0, 256, (36, 36), dtype=np.uint8)},
                        {"img1": rng.integers(0, 256, (32, 64, 3), dtype=np.uint8)}],
                       dtype=object)
    path = tmp_path / "ghof.npy"
    np.save(path, samples, allow_pickle=True)
    a = GHOFTestDataset(str(path), 32, True, np.random.default_rng(6))
    b = JaxGHOF(str(path), 32, True, np.random.default_rng(6))
    for _ in range(2):
        for i in range(len(a)):
            got, want = a[i], b[i]
            assert got.shape == (32, 32, 3)
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="smaller"):
        GHOFTestDataset(str(path), 37)[1]


def test_build_defaults_to_the_card(monkeypatch):
    """Without ``device`` the twin goes to the card, and raises without one."""
    from dmhomo_torch.models.unet_uncond import build_uncond_unet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_uncond_unet(UncondUNetConfig(dim=8, dim_mults=(1, 2)))
    model = build_uncond_unet(UncondUNetConfig(dim=8, dim_mults=(1, 2)), device="cpu")
    assert next(model.parameters()).device.type == "cpu" and not model.training
