"""The window attention at every window and head width the Pallas kernels
take: the generic variant (``csrc/window_attention_any.cu``).

* the plain version, forward and VJP, vs ``fused_window_attention`` (the
  Pallas kernels under their ``custom_vjp``, in interpret mode on the CPU)
  at N = 1, 4, 16 and 49 tokens with head dims 4, 6 and 64, with the SW-MSA
  mask: fp32 within 1e-5 (the forward) and 1e-5 of max(1, the largest
  |value|) (dqkv, dbias), as ``tests/test_torch_window_attention*.py``
  hold the shipped shapes;
* the variant a shape takes, the generic plan's arithmetic at the edges of
  the envelope (N 1..144, hd 1..64), and the argument checks at those edges;
* on the card: the generic kernels vs the plain versions at N in 1, 4, 16,
  49, 144 and hd in 4, 6, 8, 12, 64, both dtypes, with and without the
  mask (1e-5 fp32, 3e-2 bf16; the backward relative to max(1, largest)); the
  generic variant forced at a shipped shape against the tuned kernels; the
  same bits from two runs; no atomic instruction in the generic library's
  machine code; the plan as the library computes it (skip here).

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_window_attention_any.py
"""

import re

import numpy as np
import pytest
import torch

from dmhomo_torch.ops import window_attention as wa

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # relative to max(1, largest |value|)


def _inputs(seed, Bn, nW, N, h, hd, with_mask):
    rng = np.random.default_rng(seed)
    C = h * hd
    qkv = rng.normal(0, 1, (Bn, N, 3 * C)).astype(np.float32)
    bias = rng.normal(0, 0.5, (h, N, N)).astype(np.float32)
    gout = rng.normal(0, 1, (Bn, N, C)).astype(np.float32)
    mask = None
    if with_mask:
        mask = np.zeros((nW, N, N), np.float32)
        mask[rng.uniform(size=(nW, N, N)) < 0.3] = -100.0
    return qkv, bias, mask, gout


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("hd", [4, 6, 64])
@pytest.mark.parametrize("N", [1, 4, 16, 49])
def test_plain_matches_pallas_kernel(N, hd):
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.window_attention import fused_window_attention

    h, nW = 2, 2
    qkv, bias, mask, gout = _inputs(N * 100 + hd, 2 * nW, nW, N, h, hd, True)

    def f(q, b):
        return fused_window_attention(q, b, jnp.asarray(mask), num_heads=h, scale=hd**-0.5,
                                      interpret=True)

    want, vjp = jax.vjp(f, jnp.asarray(qkv), jnp.asarray(bias))
    want_dqkv, want_dbias = vjp(jnp.asarray(gout))
    args = (torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(mask))
    got = wa.window_attention(*args, num_heads=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    dqkv, dbias = wa.window_attention_backward(*args, torch.from_numpy(gout), num_heads=h)
    assert _rel_err(dqkv, torch.from_numpy(np.asarray(want_dqkv))) <= BWD_TOL["float32"]
    assert _rel_err(dbias, torch.from_numpy(np.asarray(want_dbias))) <= BWD_TOL["float32"]


@pytest.mark.parametrize("N, hd, want", [(64, 4, "tuned"), (64, 32, "tuned"), (64, 6, "generic"),
                                         (16, 8, "generic"), (144, 64, "generic"),
                                         (49, 32, "generic")])
def test_variant_by_shape(N, hd, want):
    assert wa.variant(N, hd) == want
    qkv = torch.empty(4, N, 3 * 2 * hd)
    assert wa.launch_plan(qkv, 2)["variant"] == want


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("N, hd", [(1, 1), (4, 4), (16, 8), (49, 12), (144, 64), (144, 63),
                                   (100, 64)])
def test_generic_plan_fits_the_card(N, hd, backward):
    """Every shape of the envelope asks for no more shared memory than a
    block may have; the chunks cover the windows in whole rounds."""
    for Bn, heads in ((1, 1), (7, 3), (92160, 3), (2880, 24)):
        p = wa.generic_launch_plan(Bn, N, hd, heads, backward)
        assert 0 < p["smem"] <= wa.SMEM_PER_BLOCK and p["blocks_per_sm"] >= 1
        G, per = p["windows_per_round"], p["windows_per_block"]
        assert 1 <= G <= wa.ANY_MAX_ROUND and G == max(1, min(16, 1024 // (N * N)))
        assert per % G == 0
        chunks, h = p["grid"]
        assert h == heads and chunks * per >= Bn > (chunks - 1) * per
        assert p["partials"] == (chunks if backward else 0)
        assert p["ld"] == (hd + 1 if hd < 64 else 64)


def test_generic_plan_at_the_edge():
    """N = 144, hd = 64: the backward's tile and four slices fill a block's
    227 KB (231,552 of 232,448 bytes); the forward's take 194,112."""
    assert wa.generic_launch_plan(8, 144, 64, 1, True)["smem"] == 231552
    assert wa.generic_launch_plan(8, 144, 64, 1, False)["smem"] == 194112


@pytest.mark.parametrize("case, match", [
    (dict(qkv=(4, 144, 6 * 64)), None),
    (dict(qkv=(4, 145, 18)), "qkv must be"),
    (dict(qkv=(4, 1, 18)), None),
    (dict(qkv=(4, 16, 3 * 2 * 65)), "head dim"),
    (dict(qkv=(4, 16, 3 * 2 * 6)), None),
    (dict(qkv=(4, 16, 18), mask=(3, 16, 16)), "not a multiple"),
])
def test_envelope_argument_checks(case, match):
    """The envelope's edges: 144 tokens and head dim 64 are taken, one more
    of either is refused before any launch."""
    qkv = torch.zeros(case["qkv"])
    N, C = qkv.shape[1], qkv.shape[2] // 3
    heads = 2 if C % 2 == 0 else 1
    bias = torch.zeros(heads, N, N)
    mask = torch.zeros(case.get("mask", (2, N, N)))
    if match is None:
        wa._check_cuda_args(qkv, bias, mask, heads)
        return
    with pytest.raises((ValueError, TypeError), match=match):
        wa._check_cuda_args(qkv, bias, mask, heads)


def test_generic_kernel_names():
    assert wa.kernel_key("_ZN6wa_any31window_attention_any_fwd_kernelIfEEvPKT_") == (
        "fwd", "float32", "generic", None)
    assert wa.kernel_key(
        "_ZN6wa_any31window_attention_any_bwd_kernelI13__nv_bfloat16EEvPKT_") == (
        "bwd", "bfloat16", "generic", None)
    assert wa.kernel_key("_ZN6wa_any34window_attention_any_reduce_kernelENS_8SegmentsE") is None
    assert wa.kernel_key("_ZN12_GLOBAL__N_126window_attention_fwd_kernelIfLi8ELb1EEEv") == (
        "fwd", "float32", 8, True)


def test_source_has_no_atomics():
    """The generic sources sum dbias, and the whole block's gradients, in
    fixed orders: no atomic operation is written in them."""
    for name in ("window_attention_any.cuh", "window_attention_any.cu", "swin_block_any.cu"):
        src = (wa.CSRC / name).read_text()
        assert not re.search(r"atomic(Add|Sub|Exch|Min|Max|Inc|Dec|CAS|And|Or|Xor)|\bred\.",
                             src), name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py phase 28 runs these there")
    return torch.device("cuda")


def _cuda_args(dev, seed, Bn, nW, N, h, hd, with_mask, dtype):
    qkv, bias, mask, gout = _inputs(seed, Bn, nW, N, h, hd, with_mask)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(qkv).to(dev, tdt), torch.from_numpy(bias).to(dev),
            None if mask is None else torch.from_numpy(mask).to(dev),
            torch.from_numpy(gout).to(dev, tdt))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("hd", [4, 6, 8, 12, 64])
@pytest.mark.parametrize("N", [1, 4, 16, 49, 144])
def test_cuda_generic_matches_plain(cuda_device, N, hd, with_mask, dtype):
    h, nW = 2, 3
    qkv, bias, mask, gout = _cuda_args(cuda_device, N + hd, 4 * nW, nW, N, h, hd, with_mask,
                                       dtype)
    before = (wa.window_attention.launches_by_variant["generic"],
              wa.window_attention_backward.launches_by_variant["generic"])
    got = wa.window_attention(qkv, bias, mask, num_heads=h)
    dqkv, dbias = wa.window_attention_backward(qkv, bias, mask, gout, num_heads=h)
    torch.cuda.synchronize()
    if wa.variant(N, hd) == "generic":
        assert (wa.window_attention.launches_by_variant["generic"],
                wa.window_attention_backward.launches_by_variant["generic"]) == (
            before[0] + 1, before[1] + 1)
    want = wa.window_attention_reference(qkv, bias, mask, num_heads=h)
    want_dqkv, want_dbias = wa.window_attention_backward_reference(qkv, bias, mask, gout,
                                                                   num_heads=h)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]
    assert _rel_err(dqkv, want_dqkv) <= BWD_TOL[dtype]
    assert _rel_err(dbias, want_dbias) <= BWD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forced_generic_matches_tuned(cuda_device, dtype):
    """At a shipped shape (N = 64, hd = 8, masked) the generic variant,
    forced by the private argument, agrees with the tuned kernels."""
    qkv, bias, mask, gout = _cuda_args(cuda_device, 3, 90, 45, 64, 3, 8, True, dtype)
    tuned = wa.window_attention(qkv, bias, mask, num_heads=3)
    generic = wa.window_attention(qkv, bias, mask, num_heads=3, _generic=True)
    t_bwd = wa.window_attention_backward(qkv, bias, mask, gout, num_heads=3)
    g_bwd = wa.window_attention_backward(qkv, bias, mask, gout, num_heads=3, _generic=True)
    torch.cuda.synchronize()
    assert float((tuned.float() - generic.float()).abs().max()) <= TOL[dtype]
    for a, b in zip(t_bwd, g_bwd):
        assert _rel_err(b, a) <= BWD_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_generic_is_deterministic(cuda_device, dtype):
    """Two runs give the same bits, at a shape with many dbias slabs."""
    args = _cuda_args(cuda_device, 5, 2880, 2880 // 4, 16, 3, 8, True, dtype)
    assert wa.launch_plan(args[0], 3, True)["partials"] > 1
    first = (wa.window_attention(*args[:3], num_heads=3),
             *wa.window_attention_backward(*args, num_heads=3))
    second = (wa.window_attention(*args[:3], num_heads=3),
              *wa.window_attention_backward(*args, num_heads=3))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_generic_library_has_no_atomics(cuda_device):
    found = wa.atomic_instructions_by_kernel(generic=True)
    assert found and all(n == 0 for n in found.values()), found
    counts = wa.tensor_core_instructions(generic=True)
    assert set(counts) == {(d, dt, "generic", None) for d in ("fwd", "bwd")
                           for dt in ("float32", "bfloat16")}


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True])
def test_cuda_generic_plan_matches_library(cuda_device, backward):
    for Bn, N, hd, heads in ((4, 1, 4, 2), (92160, 16, 8, 3), (360, 16, 32, 3), (8, 144, 64, 1),
                             (45, 49, 12, 2)):
        qkv = torch.empty(Bn, N, 3 * hd * heads)
        assert wa.library_plan(qkv, heads, backward) == wa.launch_plan(qkv, heads, backward)
