"""The port's linear attention against the JAX package's.

* the plain version vs ``blockdiag_linear_attention`` (the JAX production
  function) with and without the folded pre-LayerNorm, fp32 and bf16, at a
  ragged N (not a multiple of the kernels' 64-token tile): the largest
  difference relative to the largest output, within 1e-5 in fp32 and 1e-2
  in bf16 (one bf16 step of the output is 2^-8 = 3.9e-3 of its value);
* the plain version vs ``_fused_forward`` (the two Pallas kernels, in
  interpret mode on the CPU), fp32 without prenorm, within 1e-5 relative:
  the Pallas kernels subtract a tile max and merge tiles by logsumexp where
  the production function clips at +-60, the same function while
  |logits| < 60;
* the CUDA kernels vs the plain version (needs the card; skips here).

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_linear_attention.py
"""

import numpy as np
import pytest
import torch

from dmhomo_torch.ops import linear_attention as la

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(rng, B, N, C):
    x = (rng.normal(0, 1.5, (B, N, C)) + 0.3).astype(np.float32)
    w = rng.normal(0, 1.0 / np.sqrt(C), (C, 3 * la.HIDDEN)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (C,)).astype(np.float32)
    return x, w, g


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prenorm", [False, True])
@pytest.mark.parametrize("N", [64, 200])
def test_plain_matches_blockdiag(N, prenorm, dtype):
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.linear_attention import blockdiag_linear_attention

    rng = np.random.default_rng(N)
    x, w, g = _inputs(rng, 2, N, 24)
    jdt = getattr(jnp, dtype)
    xj = jnp.asarray(x, jdt)
    pn = None
    if prenorm:  # ChannelLayerNorm(return_stats=True)
        xf = xj.astype(jnp.float32)
        pn = (xf.mean(-1, keepdims=True),
              jax.lax.rsqrt(xf.var(-1, keepdims=True) + 1e-5), jnp.asarray(g))
    want = blockdiag_linear_attention(xj, jnp.asarray(w), prenorm=pn).astype(jnp.float32)
    tdt = getattr(torch, dtype)
    got = la.linear_attention(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                              prenorm=(torch.from_numpy(g),) if prenorm else None)
    assert got.dtype == tdt and got.shape == (2, N, la.HIDDEN)
    assert _rel_err(got.float().numpy(), want) <= TOL[dtype]


def test_plain_matches_pallas_kernels():
    import jax.numpy as jnp

    from dmhomo_tpu.ops.linear_attention import _fused_forward

    rng = np.random.default_rng(3)
    x, w, _ = _inputs(rng, 2, 256, 24)
    want = _fused_forward(jnp.asarray(x), jnp.asarray(w), 4, 32, tile=128, interpret=True)
    got = la.linear_attention(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel_err(got.numpy(), want) <= TOL["float32"]


def test_given_statistics_equal_computed_ones():
    """prenorm (mean, rstd, g) with ChannelLayerNorm's statistics is (g,)."""
    rng = np.random.default_rng(4)
    x, w, g = (torch.from_numpy(a) for a in _inputs(rng, 2, 70, 16))
    mean, rstd = la.layer_norm_stats(x)
    a = la.linear_attention(x, w, prenorm=(mean, rstd, g))
    b = la.linear_attention(x, w, prenorm=(g,))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    x, w, g = (torch.from_numpy(a) for a in _inputs(rng, 1, 40, 8))
    before = (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches)
    got = la.linear_attention(x, w, prenorm=(g,))
    want = la.linear_attention_reference(x, w, prenorm=(g,))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches) == before


@pytest.mark.parametrize("case, match", [
    (dict(heads=8), "heads=4"),
    (dict(x=(2, 5)), r"\(B, N, C\)"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(w=(8, 300)), "w_qkv must be"),
    (dict(g=(9,)), "g must be"),
])
def test_kernel_argument_checks(case, match):
    """What the kernels do not take is refused before any launch."""
    x = torch.zeros(case.get("x", (2, 5, 8)), dtype=case.get("dtype", torch.float32))
    w = torch.zeros(case.get("w", (8, 384)))
    g = torch.zeros(case.get("g", (8,)))
    with pytest.raises((ValueError, TypeError), match=match):
        la._check_cuda_args(x, w, case.get("heads", 4), 32, g)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this comparison there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prenorm", ["none", "gain", "stats"])
@pytest.mark.parametrize("N, C, channel_major", [(64, 16, True), (200, 64, True),
                                                  (1000, 100, False), (4096, 256, True),
                                                  (70001, 32, True)])
def test_cuda_kernels_match_plain(cuda_device, N, C, channel_major, prenorm, dtype):
    rng = np.random.default_rng(N + C)
    x, w, g = _inputs(rng, 3, N, C)  # at N = 70001 a block walks several ragged tiles
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(cuda_device, tdt)
    if channel_major:  # the UNet's NCHW activations: token stride 1
        xt = xt.transpose(1, 2).contiguous().transpose(1, 2)
    wt, gt = torch.from_numpy(w).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    pn = {"none": None, "gain": (gt,), "stats": (*la.layer_norm_stats(xt), gt)}[prenorm]
    before = (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches)
    got = la.linear_attention(xt, wt, prenorm=pn)
    torch.cuda.synchronize()
    assert (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches) == (
        before[0] + 1, before[1] + 1)
    want = la.linear_attention_reference(xt, wt, prenorm=pn)
    assert got.dtype == tdt and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert err <= TOL[dtype], err
