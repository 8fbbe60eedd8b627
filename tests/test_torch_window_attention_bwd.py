"""The port's window-attention backward against the JAX package's.

* the explicit plain backward (``window_attention_backward_reference``) and
  autograd through ``window_attention`` on CPU tensors, against ``jax.vjp``
  of ``fused_window_attention`` (the Pallas kernels in interpret mode):
  N=64, Bn=8 over nW=4, (C, h) in {(24, 3), (48, 12), (96, 3)}, with and
  without the SW-MSA mask.  Tolerances: fp32 1e-5 absolute (summation
  order; values up to ~5); bf16 3e-2 absolute on dqkv and dbias (one bf16
  ulp at the largest values: e, gg, dsim and the outputs are rounded at the
  same points, but an fp32 sum in another order can land a rounding on the
  other side);
* in fp32 the explicit backward against autograd of the plain forward;
* the CUDA backward kernel against the plain backward (needs the card;
  skips here).

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_window_attention_bwd.py
"""

import numpy as np
import pytest
import torch

from dmhomo_torch.ops import window_attention as wa

N = 64
SHAPES = [(24, 3), (48, 12), (96, 3)]  # (C, heads): head dims 8, 4, 32
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(rng, Bn, nW, C, h, with_mask):
    qkv = rng.normal(0, 1, (Bn, N, 3 * C)).astype(np.float32)
    bias = rng.normal(0, 0.5, (h, N, N)).astype(np.float32)
    gout = rng.normal(0, 1, (Bn, N, C)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.zeros((nW, N, N), np.float32)
        mask[rng.uniform(size=(nW, N, N)) < 0.3] = -100.0
    return qkv, bias, mask, gout


def _torch(qkv, bias, mask, gout, dtype, device="cpu"):
    dt = getattr(torch, dtype)
    return (torch.from_numpy(qkv).to(device, dt), torch.from_numpy(bias).to(device),
            None if mask is None else torch.from_numpy(mask).to(device),
            torch.from_numpy(gout).to(device, dt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("C, h", SHAPES)
def test_backward_matches_pallas_vjp(C, h, with_mask, dtype):
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.window_attention import fused_window_attention

    rng = np.random.default_rng(C + h)
    qkv, bias, mask, gout = _inputs(rng, 8, 4, C, h, with_mask)
    jdt = getattr(jnp, dtype)
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(
        lambda q, b: fused_window_attention(q, b, jmask, num_heads=h, scale=(C // h)**-0.5,
                                            interpret=True),
        jnp.asarray(qkv, jdt), jnp.asarray(bias))
    want_dqkv, want_dbias = (np.asarray(t, np.float32) for t in vjp(jnp.asarray(gout, jdt)))

    q, b, m, g = _torch(qkv, bias, mask, gout, dtype)
    dqkv, dbias = wa.window_attention_backward_reference(q, b, m, g, num_heads=h)
    assert dqkv.dtype == q.dtype and dbias.dtype == torch.float32
    assert dqkv.shape == q.shape and dbias.shape == (h, N, N)
    np.testing.assert_allclose(dqkv.float().numpy(), want_dqkv, atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(dbias.numpy(), want_dbias, atol=TOL[dtype], rtol=0)

    # autograd through the Function on CPU tensors runs that same backward
    q = q.clone().requires_grad_()
    b = b.clone().requires_grad_()
    before = wa.window_attention_backward.launches
    wa.window_attention(q, b, m, num_heads=h).backward(g)
    assert wa.window_attention_backward.launches == before
    torch.testing.assert_close(q.grad, dqkv, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, dbias, rtol=0, atol=0)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("C, h", SHAPES)
def test_explicit_backward_matches_autograd_of_plain_forward(C, h, with_mask):
    """fp32: the step-by-step backward is the gradient of the plain forward
    (1e-5: summation order)."""
    rng = np.random.default_rng(10 + C)
    q, b, m, g = _torch(*_inputs(rng, 8, 4, C, h, with_mask), "float32")
    dqkv, dbias = wa.window_attention_backward_reference(q, b, m, g, num_heads=h)
    q.requires_grad_()
    b.requires_grad_()
    wa.window_attention_reference(q, b, m, num_heads=h).backward(g)
    torch.testing.assert_close(q.grad, dqkv, atol=1e-5, rtol=0)
    torch.testing.assert_close(b.grad, dbias, atol=1e-5, rtol=0)


def test_clipped_logits_get_no_gradient():
    """Where |sim| >= 60 the gradient is zeroed, as in the Pallas kernel."""
    rng = np.random.default_rng(3)
    qkv, bias, _, gout = _inputs(rng, 4, 4, 24, 3, False)
    bias[0, :, :8] = 70.0
    q, b, _, g = _torch(qkv, bias, None, gout, "float32")
    _, dbias = wa.window_attention_backward_reference(q, b, None, g, num_heads=3)
    assert float(dbias[0, :, :8].abs().max()) == 0.0
    assert float(dbias[0, :, 8:].abs().max()) > 0.0


@pytest.mark.parametrize("gout, match", [
    (torch.zeros(4, 64, 24, dtype=torch.bfloat16), "gout must be"),
    (torch.zeros(4, 64, 48), "gout must be"),
    (torch.zeros(4, 24, 64).transpose(1, 2), "contiguous"),
])
def test_backward_gout_checks(gout, match):
    """What the backward kernel does not take is refused before any launch."""
    with pytest.raises(ValueError, match=match):
        wa._check_gout(torch.zeros(4, 64, 72), gout)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this comparison there")
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("hd", [4, 8, 16, 32])
def test_cuda_backward_kernel_matches_plain(cuda_device, hd, with_mask, dtype):
    """Kernel vs plain backward on the card, through the autograd Function.
    Tolerance relative to max(1, largest value): fp32 1e-5 (summation order:
    dbias is summed per chunk of windows, then over the chunks), bf16 2e-2 (a
    rounding of e, gg or dsim on the other side)."""
    rng = np.random.default_rng(hd)
    h = 3
    qkv, bias, mask, gout = _inputs(rng, 4 * 45, 45, h * hd, h, with_mask)
    q, b, m, g = _torch(qkv, bias, mask, gout, dtype, cuda_device)
    want_dqkv, want_dbias = wa.window_attention_backward_reference(q, b, m, g, num_heads=h)
    q.requires_grad_()
    b.requires_grad_()
    fwd0, bwd0 = wa.window_attention.launches, wa.window_attention_backward.launches
    wa.window_attention(q, b, m, num_heads=h).backward(g)
    torch.cuda.synchronize()
    assert (wa.window_attention.launches - fwd0, wa.window_attention_backward.launches - bwd0) \
        == (1, 1)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert q.grad.dtype == q.dtype and b.grad.dtype == torch.float32
    assert _rel_err(q.grad, want_dqkv) <= tol
    assert _rel_err(b.grad, want_dbias) <= tol
