"""The port's window attention against the JAX package's.

* the plain version vs ``fused_window_attention`` (the Pallas kernel, in
  interpret mode on the CPU) for head dims 4, 8, 16 and 32, with and without
  the SW-MSA mask, fp32 (tolerance 1e-5) and bf16 (3e-2: one bf16 rounding
  of e and of the output, summed in another order);
* the port's ``WindowAttention`` module vs the JAX module's XLA path with
  the same weights (fp32, 1e-5);
* the CUDA kernel vs the plain version (needs the card; skips here).

The port's scale is always ``hd**-0.5``; the JAX calls are given the same.

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_window_attention.py
"""

import numpy as np
import pytest
import torch

from dmhomo_torch.models.swin import WindowAttention, relative_position_index, shifted_window_mask
from dmhomo_torch.ops import window_attention as wa

N = 64
HEAD_DIMS = [4, 8, 16, 32]


def _inputs(rng, B, nW, h, hd, with_mask):
    C = h * hd
    qkv = rng.normal(0, 1, (B * nW, N, 3 * C)).astype(np.float32)
    bias = rng.normal(0, 0.5, (h, N, N)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.zeros((nW, N, N), np.float32)
        mask[rng.uniform(size=(nW, N, N)) < 0.3] = -100.0
    return qkv, bias, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_matches_pallas_kernel(hd, with_mask, dtype):
    import jax.numpy as jnp

    from dmhomo_tpu.ops.window_attention import fused_window_attention

    rng = np.random.default_rng(hd)
    h = 2
    qkv, bias, mask = _inputs(rng, 2, 4, h, hd, with_mask)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = fused_window_attention(
        jnp.asarray(qkv, jdt), jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
        num_heads=h, scale=hd**-0.5, interpret=True)
    tdt = getattr(torch, dtype)
    got = wa.window_attention(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(bias),
        None if mask is None else torch.from_numpy(mask), num_heads=h)
    assert got.dtype == tdt and got.shape == (qkv.shape[0], N, h * hd)
    atol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_module_matches_jax_xla_path(hd, with_mask):
    """WindowAttention (qkv projection, bias-table lookup, attention, proj)
    with the same weights as the JAX module's XLA max-free branch."""
    import jax.numpy as jnp

    from dmhomo_tpu.models.swin import WindowAttention as JaxWindowAttention
    from dmhomo_tpu.models.swin import shifted_window_mask as jax_shifted_window_mask

    rng = np.random.default_rng(100 + hd)
    h, ws, B = 2, 8, 1
    H, W = 16, 16
    C = h * hd
    nW = (H // ws) * (W // ws)
    x = rng.normal(0, 1, (B * nW, N, C)).astype(np.float32)
    mask = jax_shifted_window_mask(H, W, ws, ws // 2) if with_mask else None
    jmod = JaxWindowAttention(C, ws, h, attn_impl="xla")
    params = {
        "qkv": {"kernel": rng.normal(0, 0.3, (C, 3 * C)).astype(np.float32),
                "bias": rng.normal(0, 0.1, (3 * C,)).astype(np.float32)},
        "relative_position_bias_table": rng.normal(0, 0.5, ((2 * ws - 1) ** 2, h)).astype(
            np.float32),
        "proj": {"kernel": rng.normal(0, 0.3, (C, C)).astype(np.float32),
                 "bias": rng.normal(0, 0.1, (C,)).astype(np.float32)},
    }
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      None if mask is None else jnp.asarray(mask))

    mod = WindowAttention(C, ws, h)
    with torch.no_grad():
        mod.qkv.weight.copy_(torch.from_numpy(params["qkv"]["kernel"].T.copy()))
        mod.qkv.bias.copy_(torch.from_numpy(params["qkv"]["bias"]))
        mod.relative_position_bias_table.copy_(
            torch.from_numpy(params["relative_position_bias_table"]))
        mod.proj.weight.copy_(torch.from_numpy(params["proj"]["kernel"].T.copy()))
        mod.proj.bias.copy_(torch.from_numpy(params["proj"]["bias"]))
        port_mask = shifted_window_mask(H, W, ws, ws // 2) if with_mask else None
        got = mod(torch.from_numpy(x), None if port_mask is None else torch.from_numpy(port_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_index_and_mask_match_jax():
    from dmhomo_tpu.models.swin import relative_position_index as jax_rpi
    from dmhomo_tpu.models.swin import shifted_window_mask as jax_shifted_window_mask

    np.testing.assert_array_equal(relative_position_index(8), jax_rpi(8))
    for H, W in ((40, 72), (16, 32)):
        np.testing.assert_array_equal(shifted_window_mask(H, W, 8, 4),
                                      jax_shifted_window_mask(H, W, 8, 4))


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper computes the plain version and counts no launch."""
    rng = np.random.default_rng(1)
    qkv, bias, mask = _inputs(rng, 1, 4, 3, 8, True)
    before = wa.window_attention.launches
    args = (torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(mask))
    got = wa.window_attention(*args, num_heads=3)
    want = wa.window_attention_reference(*args, num_heads=3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert wa.window_attention.launches == before


@pytest.mark.parametrize("case, match", [
    (dict(qkv=(4, 169, 72)), "qkv must be"),
    (dict(heads=5), "head dim"),
    (dict(bias=(2, 64, 64)), "bias must be"),
    (dict(mask=(3, 64, 64)), "not a multiple"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
])
def test_kernel_argument_checks(case, match):
    """What the kernel does not take is refused before any launch."""
    dtype = case.get("dtype", torch.float32)
    qkv = torch.zeros(case.get("qkv", (4, 64, 72)), dtype=dtype)
    bias = torch.zeros(case.get("bias", (3, 64, 64)))
    mask = torch.zeros(case.get("mask", (2, 64, 64)))
    with pytest.raises((ValueError, TypeError), match=match):
        wa._check_cuda_args(qkv, bias, mask, case.get("heads", 3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this comparison there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_kernel_matches_plain(cuda_device, hd, with_mask, dtype):
    rng = np.random.default_rng(7)
    h = 3
    qkv, bias, mask = _inputs(rng, 4, 45, h, hd, with_mask)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(qkv).to(cuda_device, tdt), torch.from_numpy(bias).to(cuda_device),
            None if mask is None else torch.from_numpy(mask).to(cuda_device))
    before = wa.window_attention.launches
    got = wa.window_attention(*args, num_heads=h)
    torch.cuda.synchronize()
    assert wa.window_attention.launches == before + 1
    want = wa.window_attention_reference(*args, num_heads=h)
    atol = 1e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
