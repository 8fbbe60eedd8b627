"""The port's auxiliary modules (``models/extras.py``) against the JAX
package's, on the CPU.

Each flax module is initialised from a seed, its variables carried over
with ``module_state_dict_from_jax`` and loaded ``strict=True``; both run the
same numpy inputs (NHWC), fp32, eval mode, within 1e-5 absolute (outputs
of order 1; summation order only).  Also: the gradient reversal's forward
and backward against ``jax.grad`` of JAX's, and the pixel (un)shuffle's
JAX channel order (equal, element for element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.models import extras as jx

from dmhomo_torch.models import extras as tx
from dmhomo_torch.models.convert import module_state_dict_from_jax

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread is faster than many, and the suite
    runs test files side by side in worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturbed(variables, seed):
    """The variables with BatchNorm statistics of a trained-looking net."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.3, np.shape(v)).astype(np.float32),
        variables.get("batch_stats", {}))
    return params, stats


def _carry(jax_module, port_module, *inputs, seed=0, train_arg=False):
    kw = {"train": False} if train_arg else {}
    variables = jax_module.init(jax.random.PRNGKey(seed), *map(jnp.asarray, inputs), **kw)
    params, stats = _perturbed(variables, seed)
    port_module.load_state_dict(module_state_dict_from_jax(params, stats), strict=True)
    want = jax_module.apply({"params": params, "batch_stats": stats} if stats else
                            {"params": params}, *map(jnp.asarray, inputs), **kw)
    with torch.no_grad():
        got = port_module.eval()(*(torch.from_numpy(x) for x in inputs))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("alpha", [1.0, 2.0, 0.25])
def test_gradient_reversal(alpha, rng):
    x = rng.normal(0, 1, (3, 4)).astype(np.float32)
    w = rng.normal(0, 1, (3, 4)).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jx.gradient_reversal(v, alpha) * w))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = tx.gradient_reversal(xt, alpha)
    np.testing.assert_array_equal(out.detach().numpy(), x)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=0)


@pytest.mark.parametrize("shape, r", [((2, 8, 8, 4), 2), ((1, 6, 9, 3), 3)])
def test_pixel_shuffle_in_jax_order(shape, r, rng):
    x = rng.normal(0, 1, shape).astype(np.float32)
    d = tx.pixel_unshuffle(torch.from_numpy(x), r)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jx.pixel_unshuffle(jnp.asarray(x), r)))
    back = tx.pixel_shuffle(d, r)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jx.pixel_shuffle(jx.pixel_unshuffle(jnp.asarray(x), r), r)))


def test_discriminator(rng):
    x = rng.normal(0, 1, (2, 64, 64, 2)).astype(np.float32)
    got, want = _carry(jx.Discriminator(in_channels=2), tx.Discriminator(in_channels=2), x,
                       train_arg=True)
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("dim, heads, bias", [(8, 2, False), (16, 4, True)])
def test_spatial_attention(dim, heads, bias, rng):
    x = rng.normal(0, 1, (2, 8, 6, dim)).astype(np.float32)
    got, want = _carry(jx.SpatialAttention(dim, heads, use_bias=bias),
                       tx.SpatialAttention(dim, heads, use_bias=bias), x, seed=dim)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_mask_predictor(rng):
    x = rng.normal(0, 1, (1, 16, 16, 2)).astype(np.float32)
    got, want = _carry(jx.MaskPredictor(), tx.MaskPredictor(2), x)
    assert got.shape == (1, 16, 16, 1) and (got >= 0).all() and (got <= 1).all()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_aspp(rng):
    x = rng.normal(0, 1, (1, 32, 32, 8)).astype(np.float32)
    got, want = _carry(jx.ASPP(out_channels=16, dilations=(1, 2, 4)),
                       tx.ASPP(8, out_channels=16, dilations=(1, 2, 4)), x, train_arg=True)
    assert got.shape == (1, 32, 32, 16)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("ws, heads, qkv_bias", [(4, 2, True), (2, 4, False)])
def test_window_cross_attention(ws, heads, qkv_bias, rng):
    xa = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    xb = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    jm = jx.WindowCrossAttention(dim=16, window_size=ws, num_heads=heads, qkv_bias=qkv_bias)
    tm = tx.WindowCrossAttention(16, ws, heads, qkv_bias=qkv_bias)
    got, want = _carry(jm, tm, xa, xb, seed=ws)
    np.testing.assert_allclose(got, want, atol=ATOL)
    with torch.no_grad():  # cross attention: the output follows xb
        other = tm(torch.from_numpy(xa), torch.from_numpy(2 * xb)).numpy()
    assert np.abs(other - got).max() > 1e-3
