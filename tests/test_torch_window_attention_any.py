"""The window attention at every window and head width the Pallas kernels
take: the generic variant (``csrc/window_attention_any.cu``).

* the plain version, forward and VJP, vs ``fused_window_attention`` (the
  Pallas kernels under their ``custom_vjp``, in interpret mode on the CPU)
  at N = 1, 4, 16 and 49 tokens with head dims 4, 6 and 64, with the SW-MSA
  mask: fp32 within 1e-5 (the forward) and 1e-5 of max(1, the largest
  |value|) (dqkv, dbias), as ``tests/test_torch_window_attention*.py``
  hold the shipped shapes;
* the variant a shape takes, the generic plan's arithmetic at the edges of
  the envelope (N 1..144, hd 1..64, both dtypes), the whole block's
  attention plan and dbias slabs taken from it, and the argument checks at
  those edges;
* on the card: the generic kernels vs the plain versions at N in 1, 4, 16,
  49, 144 and hd in 1, 4, 6, 8, 12, 63, 64, both dtypes, with and without
  the mask (1e-5 fp32, 3e-2 bf16; the backward relative to max(1,
  largest)); the generic variant forced at a shipped shape against the
  tuned kernels; the same bits from two runs; in the generic library's
  machine code no atomic instruction, tensor-core instructions in every
  bf16 instantiation and none in an fp32 one; the plan as the library
  computes it (skip here).

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
    block may have (at N <= 16 no more than 64 KB): a warp's staged slices
    of each stage's windows and heads, and in the backward its fp32 tile;
    the chunks cover the windows in whole stages; a dbias slab per chunk and
    warp of a head."""
    for itemsize in (4, 2):
        for Bn, heads in ((1, 1), (7, 3), (92160, 3), (2880, 24)):
            p = wa.generic_launch_plan(Bn, N, hd, heads, backward, itemsize)
            assert 0 < p["smem"] <= wa.SMEM_PER_BLOCK and p["blocks_per_sm"] >= 1
            np_, hdp, ld = p["padded_tokens"], p["padded_hd"], p["ld"]
            assert np_ % 16 == 0 and np_ - 16 < N <= np_
            assert hdp in ((4, 8, 16, 32, 64) if itemsize == 4 else (8, 16, 32, 64))
            assert hd <= hdp and (hdp == 4 or hdp // 2 < hd or hdp == 8)
            assert ld >= hdp and (ld * itemsize) % 16 == 0
            nh, R, tpw = p["heads_per_block"], p["warps_per_head"], p["tasks_per_warp"]
            chunks, groups = p["grid"]
            assert groups == -(-heads // nh) and (groups - 1) * nh < heads <= groups * nh
            assert p["threads"] == 32 * nh * R <= wa.ANY_THREADS
            G, per = p["windows_per_stage"], p["windows_per_block"]
            assert G == R * tpw and per % G == 0
            assert chunks * per >= Bn > (chunks - 1) * per
            assert p["partials"] == (chunks * R if backward else 0)
            task = (4 if backward else 3) * np_ * ld * itemsize
            tile = 4 * (np_ * wa._any_tile_ld(np_, hdp, itemsize) + np_) if backward else 0
            assert p["smem"] == p["stages"] * G * nh * task + nh * R * tile
            if np_ == 16:
                assert p["smem"] <= wa.ANY_SMALL_SMEM and nh * hd * itemsize <= max(
                    2 * wa.ANY_GROUP_BYTES, hd * itemsize)
            else:
                assert nh == 1 and tpw == 1


def test_generic_plan_at_the_edge():
    """N = 144, hd = 64: one warp a block, one stage in the backward; its
    fp32 slices and tile fill a block's 227 KB (230,976 of 232,448 bytes)."""
    for itemsize, backward, smem, stages in ((4, True, 230976, 1), (4, False, 221184, 2),
                                             (2, True, 168768, 1), (2, False, 124416, 2)):
        p = wa.generic_launch_plan(8, 144, 64, 1, backward, itemsize)
        assert (p["smem"], p["stages"], p["threads"]) == (smem, stages, 32)


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
    assert wa.kernel_key("_ZN6wa_any12_GLOBAL__N_131window_attention_any_fwd_kernelIfLi64EEEvN"
                         "S0_5KArgsE") == ("fwd", "float32", "generic", 64)
    assert wa.kernel_key("_ZN6wa_any12_GLOBAL__N_131window_attention_any_bwd_kernelI13__nv_"
                         "bfloat16Li8EEEvNS0_5KArgsE") == ("bwd", "bfloat16", "generic", 8)
    assert wa.kernel_key("_ZN6wa_any12_GLOBAL__N_131window_attention_any_fwd_kernelIfLi4EEEvN"
                         "S0_5KArgsE") == ("fwd", "float32", "generic", 4)
    assert wa.kernel_key("_ZN6wa_any12_GLOBAL__N_131window_attention_any_bwd_kernelI13__nv_"
                         "bfloat16Li16EEEvNS0_5KArgsE") == ("bwd", "bfloat16", "generic", 16)
    assert wa.kernel_key("_ZN6wa_any34window_attention_any_reduce_kernelENS_8SegmentsE") is None
    assert wa.kernel_key("_ZN12_GLOBAL__N_126window_attention_fwd_kernelIfLi8ELb1EEEv") == (
        "fwd", "float32", 8, True)


def test_block_plan_takes_the_attention_plan():
    """The generic whole block launches the window attention with the
    attention's own plan at the block's dtype, and sizes its dbias slabs
    from that plan's partials."""
    from dmhomo_torch.ops import swin_block as sb

    for dtype in (torch.float32, torch.bfloat16):
        for B, H, W, C, heads, ws in ((8, 160, 288, 24, 3, 4), (8, 40, 72, 96, 24, 4),
                                      (2, 14, 21, 12, 2, 7), (1, 12, 12, 384, 6, 12)):
            x = torch.empty(B, H, W, C, dtype=dtype)
            N = ws * ws
            Bn = B * H * W // N
            f = sb.generic_forward_plan(x, heads, 3 * C, ws)
            b = sb.generic_backward_plan(x, heads, 3 * C, ws)
            for plan, name, bwd in ((f, "attention", False), (b, "attention", False),
                                    (b, "attention_bwd", True)):
                att = wa.generic_launch_plan(Bn, N, C // heads, heads, bwd, x.element_size())
                k = plan["launches"][name]
                assert k["grid"] == att["grid"] + (1,)
                assert (k["threads"], k["smem"]) == (att["threads"], att["smem"])
            att = wa.generic_launch_plan(Bn, N, C // heads, heads, True, x.element_size())
            assert b["launches"]["attention_bwd"]["partials"] == att["partials"]
            assert b["scratch"]["bpart"][1] == 4 * att["partials"] * heads * N * N


def test_breakdown_copies_apply():
    """``window_attention_breakdown --generic`` takes this checkout's header
    apart: every removal it makes applies (each edit exactly where it
    expects), the unchanged copy is the source itself."""
    from dmhomo_torch.ops import window_attention_breakdown as wb

    cu = (wa.CSRC / "window_attention_any.cu").read_text()
    cuh = (wa.CSRC / "window_attention_any.cuh").read_text()
    copies = wb.generic_variants(cu, cuh)
    assert list(copies) == ["unchanged", "without the loads", "without the exp",
                            "without the products", "without dbias"]
    assert copies["unchanged"] == (cu, cuh)
    for name, (c, h) in copies.items():
        assert name == "unchanged" or h != cuh
        assert c == cu or name == "without dbias"


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
@pytest.mark.parametrize("hd", [1, 4, 6, 8, 12, 63, 64])
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
    assert {k[:3] for k in counts} == {(d, dt, "generic") for d in ("fwd", "bwd")
                                       for dt in ("float32", "bfloat16")}


@pytest.mark.gpu
def test_cuda_generic_tensor_cores(cuda_device):
    """The generic library's machine code: every bf16 instantiation of the
    forward and the backward (one per padded head dim) has tensor-core
    instructions, every fp32 one none, and no kernel an atomic."""
    counts = wa.tensor_core_instructions(generic=True)
    want = {(d, dt, "generic", hdp) for d in ("fwd", "bwd") for dt, hdps in (
        ("float32", (4, 8, 16, 32, 64)), ("bfloat16", (8, 16, 32, 64))) for hdp in hdps}
    assert set(counts) == want, counts
    assert all((n > 0) == (k[1] == "bfloat16") for k, n in counts.items()), counts
    assert all(n == 0 for n in wa.atomic_instructions_by_kernel(generic=True).values())


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True])
def test_cuda_generic_plan_matches_library(cuda_device, backward):
    for Bn, N, hd, heads in ((4, 1, 4, 2), (92160, 16, 8, 3), (360, 16, 32, 3), (8, 144, 64, 1),
                             (45, 49, 12, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.empty(Bn, N, 3 * hd * heads, dtype=dtype)
            assert wa.library_plan(qkv, heads, backward) == wa.launch_plan(qkv, heads, backward)
