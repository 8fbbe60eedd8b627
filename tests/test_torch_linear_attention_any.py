"""The linear attention at any heads and dim_head (the generic variant) against
the JAX package's.

* the plain passes and the whole plain version against the JAX production
  function ``blockdiag_linear_attention`` (and pass 1 against its (E, s)
  written out with the same jnp ops) over a heads x dim_head grid, with and
  without the folded pre-LayerNorm: fp32 within 1e-5 of the largest
  output, bf16 within 1e-2 (one bf16 step of the output is 3.9e-3 of it);
* the plain version against ``_fused_forward`` (the two Pallas kernels in
  interpret mode) at two shapes other than (4, 32), N a multiple of 128;
* ``linear_attention_backward`` against ``jax.vjp`` of
  ``blockdiag_linear_attention`` at two such shapes, and
  ``LinearAttentionFunction`` against autograd of the plain version;
* the variant picked by shape, the generic plan (its shared memory within
  a block's in both dtypes, its head groups and grid covering the heads and
  tokens, the scratch sized for the slots and the prepared weights), also
  at the envelope's edges, the envelope's ``ValueError``\\ s, a source free
  of atomics, and the breakdown tool's sites equal to the UNet's;
* on the card (``gpu``; skips here): the generic kernels against their
  plain versions over the grid (dim_head 1-128, C 3-512, N 1-4099), the
  generic variant forced at (4, 32) against the tuned kernels, reruns
  bit-identical in both dtypes, no atomic instruction in the library's
  machine code, tensor-core instructions in every bf16 pass and none in
  fp32, and the library's plan equal to :func:`generic_launch_plan`.

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_linear_attention_any.py
"""

import re

import numpy as np
import pytest
import torch

from dmhomo_torch.ops import linear_attention as la

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# on the card: chip_smoke.py's LA_TOL (the tuned kernels' tolerances)
CUDA_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# (heads, dim_head) other than the tuned (4, 32)
SHAPES = [(1, 8), (3, 24), (8, 64), (16, 8), (2, 12)]


def _inputs(rng, B, N, C, hd):
    x = (rng.normal(0, 1.5, (B, N, C)) + 0.3).astype(np.float32)
    w = rng.normal(0, 1.0 / np.sqrt(C), (C, 3 * hd)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (C,)).astype(np.float32)
    return x, w, g


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_prenorm(xj, g):
    import jax
    import jax.numpy as jnp

    xf = xj.astype(jnp.float32)  # ChannelLayerNorm(return_stats=True)
    return (xf.mean(-1, keepdims=True), jax.lax.rsqrt(xf.var(-1, keepdims=True) + 1e-5),
            jnp.asarray(g))


def _jax_sums(xj, w, heads, dim_head, pn):
    """Pass 1's (E diagonal blocks, s) with the ops of
    ``blockdiag_linear_attention`` (its qkv, ek, s and E lines)."""
    import jax.numpy as jnp

    B, N, _ = xj.shape
    hd, dt = heads * dim_head, xj.dtype
    wj = jnp.asarray(w)
    if pn is None:
        qkv = jnp.einsum("bnc,ck->bnk", xj, wj.astype(dt))
    else:
        mean, rstd, g = pn
        a = jnp.einsum("bnc,ck->bnk", xj, (wj * g[:, None]).astype(dt),
                       preferred_element_type=jnp.float32)
        qkv = ((a - mean * (g @ wj)[None, None, :]) * rstd).astype(dt)
    _, k, v = jnp.split(qkv, 3, axis=-1)
    ek = jnp.exp(jnp.clip(k.astype(jnp.float32), -60.0, 60.0)).astype(dt)
    s = jnp.sum(ek, axis=1, dtype=jnp.float32)
    E = jnp.einsum("bnd,bne->bde", ek, v, preferred_element_type=jnp.float32)
    blocks = [E[:, h * dim_head:(h + 1) * dim_head, h * dim_head:(h + 1) * dim_head]
              for h in range(heads)]
    return np.concatenate([np.asarray(jnp.stack(blocks, 1)).reshape(B, -1), np.asarray(s)], 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prenorm", [False, True])
@pytest.mark.parametrize("heads, dim_head", SHAPES)
def test_plain_matches_blockdiag(heads, dim_head, prenorm, dtype):
    import jax.numpy as jnp

    from dmhomo_tpu.ops.linear_attention import blockdiag_linear_attention

    N, C = 70, 24
    rng = np.random.default_rng(heads * 1000 + dim_head)
    x, w, g = _inputs(rng, 2, N, C, heads * dim_head)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    pn = _jax_prenorm(xj, g) if prenorm else None
    want = np.asarray(blockdiag_linear_attention(xj, jnp.asarray(w), heads, dim_head, prenorm=pn)
                      .astype(jnp.float32))
    want_sums = _jax_sums(xj, w, heads, dim_head, pn)

    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    wt, gt = torch.from_numpy(w), torch.from_numpy(g)
    tpn = (gt,) if prenorm else None
    sums = la.linear_attention_pass1_reference(xt, wt, heads, dim_head, tpn)
    assert sums.shape == (2, la.sums_width(heads, dim_head))
    # in bf16 a rounding of k or v may land on the other side
    assert _rel_err(sums.numpy(), want_sums) <= TOL[dtype]
    # pass 2 on JAX's sums, and the whole plain version
    out2 = la.linear_attention_pass2_reference(xt, wt, torch.from_numpy(want_sums), heads,
                                               dim_head, tpn)
    got = la.linear_attention(xt, wt, heads, dim_head, prenorm=tpn)
    assert got.dtype == xt.dtype and got.shape == (2, N, heads * dim_head)
    for out in (out2, got):
        assert _rel_err(out.float().numpy(), want) <= TOL[dtype]


@pytest.mark.parametrize("heads, dim_head, N, C", [(2, 16, 256, 24), (3, 24, 128, 16)])
def test_plain_matches_pallas_kernels(heads, dim_head, N, C):
    """The plain version against the two Pallas kernels (interpret mode),
    fp32 without prenorm: the kernels subtract a tile max and merge tiles by
    logsumexp where the production function clips at +-60, the same
    function while |logits| < 60."""
    import jax.numpy as jnp

    from dmhomo_tpu.ops.linear_attention import _fused_forward

    rng = np.random.default_rng(N + C)
    x, w, _ = _inputs(rng, 2, N, C, heads * dim_head)
    want = _fused_forward(jnp.asarray(x), jnp.asarray(w), heads, dim_head, tile=128,
                          interpret=True)
    got = la.linear_attention(torch.from_numpy(x), torch.from_numpy(w), heads, dim_head)
    assert _rel_err(got.numpy(), want) <= TOL["float32"]


def _grad_leaves(x, w, g, prenorm, dtype, device="cpu"):
    xt = torch.from_numpy(x).to(device, getattr(torch, dtype))
    xt = xt.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()  # NCHW's layout
    wt = torch.from_numpy(w).to(device).requires_grad_()
    gt = torch.from_numpy(g).to(device).requires_grad_()
    return ([xt, wt, gt], (gt,)) if prenorm else ([xt, wt], None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads, dim_head, prenorm", [(2, 12, True), (8, 64, False)])
def test_backward_matches_jax_vjp(heads, dim_head, prenorm, dtype):
    """dx, dW (and dg) of the Function against ``jax.vjp`` of the production
    function, whose prenorm statistics come from x inside it."""
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.linear_attention import blockdiag_linear_attention

    N, C = 60, 24
    rng = np.random.default_rng(heads + dim_head)
    x, w, g = _inputs(rng, 2, N, C, heads * dim_head)
    dout = rng.normal(0, 1, (2, N, heads * dim_head)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def f(x, w, g):
        return blockdiag_linear_attention(x, w, heads, dim_head,
                                          prenorm=_jax_prenorm(x, g) if prenorm else None)

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(g))
    want = vjp(jnp.asarray(dout, jdt))
    leaves, pn = _grad_leaves(x, w, g, prenorm, dtype)
    out = la.linear_attention(leaves[0], leaves[1], heads, dim_head, prenorm=pn)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout).to(out.dtype))
    assert got[0].stride(1) == 1  # x's layout
    for a, b in zip(got, want):
        assert _rel_err(a.float().numpy(), np.asarray(b, np.float32)) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads, dim_head", [(3, 24), (16, 8)])
def test_function_matches_autograd_of_plain(heads, dim_head, dtype):
    rng = np.random.default_rng(heads * dim_head)
    x, w, g = _inputs(rng, 2, 90, 16, heads * dim_head)
    dout = torch.from_numpy(rng.normal(size=(2, 90, heads * dim_head)).astype(np.float32))
    grads = []
    for fn in (la.linear_attention, la.linear_attention_reference):
        leaves, pn = _grad_leaves(x, w, g, True, dtype)
        out = fn(leaves[0], leaves[1], heads, dim_head, prenorm=pn)
        grads.append(torch.autograd.grad(out, leaves, dout.to(out.dtype)))
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert _rel_err(a.float().numpy(), b.float().numpy()) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("heads, dim_head, want", [
    (4, 32, "tuned"), (8, 64, "generic"), (4, 16, "generic"), (2, 32, "generic"), (1, 1, "generic"),
])
def test_variant_by_shape(heads, dim_head, want):
    assert la.variant(heads, dim_head) == want


def _check_generic_plan(p, pass_, B, N, C, heads, dim_head):
    """A generic plan fits a block's shared memory in both dtypes, its head
    groups of 128 padded columns cover the heads, its grid covers the
    tokens without an empty chunk (pass 1) or block (pass 2), and pass 1's
    scratch holds a slot per chunk, head and batch, then u and the
    prepared weights of every group."""
    assert p["smem"] <= la.SMEM_LIMIT and p["smem_fp32"] <= la.SMEM_LIMIT
    dp = p["dim_head_padded"]
    assert dp in (16, 32, 64, 128) and dim_head <= dp and (dp == 16 or dp // 2 < dim_head)
    assert p["heads_per_group"] * dp == la.ANY_GROUP and p["threads"] == 256
    gx, groups, gz = p["grid"]
    assert (groups - 1) * p["heads_per_group"] < heads <= groups * p["heads_per_group"]
    assert p["tile"] == (128 if pass_ == 2 and dp == 128 else 64)
    n_tiles = -(-N // p["tile"])
    for key in ("stages", "stages_fp32"):
        assert p[key] in (2, 3)
    if pass_ == 1:
        assert gz == B
        assert gx * p["tiles_per_chunk"] >= n_tiles > (gx - 1) * p["tiles_per_chunk"]
        slots = B * heads * gx * dim_head * (dim_head + 1)
        cp = -(-C // 16) * 16
        prep = groups * 2 * la.ANY_GROUP * (1 + cp)
        assert slots + prep <= p["partials"] < slots + la.ANY_PREP_ALIGN + prep
    else:
        assert gz == 1 and 1 <= gx <= B * n_tiles and p["partials"] == 0
        assert gx * p["tiles_per_chunk"] >= B * n_tiles > gx * (p["tiles_per_chunk"] - 1)


@pytest.mark.parametrize("pass_", [1, 2])
@pytest.mark.parametrize("heads, dim_head", [(1, 1), (1, 5), (3, 24), (4, 32), (8, 64),
                                             (16, 64), (8, 128), (2, 127), (16, 8)])
def test_generic_plans_fit_shared_memory(heads, dim_head, pass_):
    """Each generic plan fits a block's shared memory (at C = 1024 the
    weights stream by channel steps), covers the tokens and sizes the
    scratch (:func:`_check_generic_plan`)."""
    for B, N, C in ((1, 1, 1), (50, 65536, 64), (16, 1024, 1024), (128, 4097, 512)):
        p = la.generic_launch_plan(pass_, B, N, C, heads, dim_head)
        _check_generic_plan(p, pass_, B, N, C, heads, dim_head)


@pytest.mark.parametrize("pass_", [1, 2])
@pytest.mark.parametrize("heads, dim_head", [(1, 1), (1, 5), (2, 127), (16, 64), (8, 128)])
def test_generic_plans_at_the_edges(heads, dim_head, pass_):
    """The envelope's edge shapes at C 1, 3, 24, 1024 and N 1, 17, 65536
    (B 1 and 50): every plan fits, covers the tokens and sizes the scratch;
    the weights are resident at C <= 256 in bf16 pass 1 and stream at C =
    1024 in pass 1."""
    for C in (1, 3, 24, 1024):
        for N in (1, 17, 65536):
            for B in (1, 50):
                p = la.generic_launch_plan(pass_, B, N, C, heads, dim_head)
                _check_generic_plan(p, pass_, B, N, C, heads, dim_head)
                if pass_ == 1:
                    assert p["resident"] == (C <= 256) and p["resident_fp32"] == (C <= 144)


@pytest.mark.parametrize("heads, dim_head, shape, match", [
    (17, 8, (2, 5, 8), r"1 <= heads <= 16"),
    (0, 8, (2, 5, 8), r"1 <= heads <= 16"),
    (2, 129, (2, 5, 8), r"1 <= dim_head <= 128"),
    (2, 0, (2, 5, 8), r"1 <= dim_head <= 128"),
    (16, 65, (2, 5, 8), r"heads\*dim_head <= 1024"),
    (8, 64, (2, 5, 1025), r"C <= 1024"),
    (8, 64, (65536, 1, 8), r"B <= 65535"),
])
def test_envelope_refused(heads, dim_head, shape, match):
    """A shape outside the envelope raises before any launch, naming the limit."""
    B, N, C = shape
    x = torch.zeros((1, N, C)).expand(B, N, C)
    w = torch.zeros((C, 3 * heads * dim_head))
    with pytest.raises(ValueError, match=match):
        la._check_cuda_args(x, w, heads, dim_head)


def test_forced_generic_is_checked_at_the_tuned_shape():
    """At (4, 32) the forced generic variant takes the generic envelope."""
    x = torch.zeros((1, 4, 1025)).expand(2, 4, 1025)
    w = torch.zeros((1025, 384))
    la._check_cuda_args(x, w, 4, 32)  # the tuned kernels take it
    with pytest.raises(ValueError, match=r"C <= 1024"):
        la._check_cuda_args(x, w, 4, 32, generic=True)


def test_source_has_no_atomics():
    """No atomic call or reduction-to-memory instruction in the source's code
    (comments aside)."""
    src = la._SOURCE_ANY.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\bred\.|\batom\.", code)
    assert "linear_attention_any_reduce_kernel" in code


def test_chip_smoke_grid_covers_the_envelope():
    """``chip_smoke.py`` phase 29 (a): every (heads, dim_head) of its grid
    inside the envelope, in both dtypes, and every N, C, prenorm mode and
    layout among them."""
    import chip_smoke

    cases = chip_smoke.la_any_cases()
    grid = {(h, d) for h in chip_smoke.LA_ANY_HEADS for d in chip_smoke.LA_ANY_DIM_HEAD
            if h * d <= la.MAX_HIDDEN}
    assert {(h, d) for h, d, *_ in cases} == grid and len(cases) == 2 * len(grid)
    for i, values in enumerate((chip_smoke.LA_ANY_N, chip_smoke.LA_ANY_C,
                                ("float32", "bfloat16"), ("none", "gain", "stats"),
                                (True, False))):
        assert {c[2 + i] for c in cases} == set(values)
    for h, d, N, C, *_ in cases:
        la._check_cuda_args(torch.zeros((1, 1, C)).expand(2, N, C),
                            torch.zeros((C, 3 * h * d)), h, d, generic=True)


def test_breakdown_sites_are_the_unets():
    """``linear_attention_breakdown --generic`` times the UNet's eight sites,
    as ``chip_smoke.py`` lists them, at both of its image sizes."""
    import chip_smoke
    from dmhomo_torch.models.unet import UNetConfig
    from dmhomo_torch.ops.linear_attention_breakdown import GENERIC_PATHS, unet_sites

    for _, _, size in GENERIC_PATHS:
        want = [(hw * hw, C) for _, hw, C in chip_smoke.linear_attention_sites(UNetConfig(), size)]
        assert unet_sites(size) == want


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    x, w, g = (torch.from_numpy(a) for a in _inputs(rng, 1, 40, 8, 3 * 24))
    before = (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches,
              la.linear_attention_pass1.generic, la.linear_attention_pass2.generic)
    got = la.linear_attention(x, w, 3, 24, prenorm=(g,))
    torch.testing.assert_close(got, la.linear_attention_reference(x, w, 3, 24, prenorm=(g,)),
                               rtol=0, atol=0)
    assert (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches,
            la.linear_attention_pass1.generic, la.linear_attention_pass2.generic) == before


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this comparison there")
    return torch.device("cuda")


GPU_GRID = [(h, d) for h in (1, 2, 3, 8, 16) for d in (1, 5, 8, 12, 24, 64, 127, 128)
            if h * d <= 1024]


def _card_inputs(rng, B, N, C, hd, dtype, channel_major, dev):
    x, w, g = _inputs(rng, B, N, C, hd)
    xt = torch.from_numpy(x).to(dev, getattr(torch, dtype))
    if channel_major:  # the UNet's NCHW activations: token stride 1
        xt = xt.transpose(1, 2).contiguous().transpose(1, 2)
    return xt, torch.from_numpy(w).to(dev), torch.from_numpy(g).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("heads, dim_head", GPU_GRID)
def test_cuda_generic_matches_plain(cuda_device, heads, dim_head):
    """Over the grid, cycling N, C, dtype, prenorm and layout: one generic
    launch of each pass, within the tuned kernels' tolerances of the plain
    version; each pass alone against its plain version."""
    i = GPU_GRID.index((heads, dim_head))
    N = (1, 17, 100, 1000, 4099)[i % 5]
    C = (3, 16, 64, 257, 512)[(i // 2) % 5]
    dtype = ("float32", "bfloat16")[i % 2]
    prenorm = ("none", "gain", "stats")[i % 3]
    rng = np.random.default_rng(i)
    x, w, g = _card_inputs(rng, 3, N, C, heads * dim_head, dtype, i % 4 < 2, cuda_device)
    pn = {"none": None, "gain": (g,), "stats": (*la.layer_norm_stats(x), g)}[prenorm]
    before = (la.linear_attention_pass1.generic, la.linear_attention_pass2.generic)
    got = la.linear_attention(x, w, heads, dim_head, prenorm=pn)
    torch.cuda.synchronize()
    assert (la.linear_attention_pass1.generic - before[0],
            la.linear_attention_pass2.generic - before[1]) == (1, 1)
    want = la.linear_attention_reference(x, w, heads, dim_head, prenorm=pn)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert got.stride(1) == (1 if x.stride(1) == 1 else heads * dim_head)
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert bool(torch.isfinite(got).all()) and err <= CUDA_TOL[dtype], err
    # pass 1 alone (with computed statistics) and pass 2 on the plain sums
    B = x.shape[0]
    sums = torch.full((B, la.sums_width(heads, dim_head)), float("nan"), device=cuda_device)
    mean = torch.full((B, N), float("nan"), device=cuda_device)
    rstd = torch.full((B, N), float("nan"), device=cuda_device)
    la.linear_attention_pass1(x, w, g, mean, rstd, True, sums, heads, dim_head)
    want_sums = la.linear_attention_pass1_reference(x, w, heads, dim_head, (g,))
    out = torch.empty((B, N, heads * dim_head), dtype=x.dtype, device=cuda_device)
    la.linear_attention_pass2(x, w, g, mean, rstd, want_sums, out, heads, dim_head)
    want_out = la.linear_attention_pass2_reference(x, w, want_sums, heads, dim_head, (g,))
    for a, b in ((sums, want_sums), (out, want_out)):
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert err <= CUDA_TOL[dtype], err
    m_ref, r_ref = la.layer_norm_stats(x)
    torch.testing.assert_close(mean, m_ref.reshape(B, N), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, r_ref.reshape(B, N), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N, C", [(1024, 64), (4096, 256)])
def test_cuda_forced_generic_matches_tuned(cuda_device, N, C, dtype):
    """At (4, 32) the generic variant, forced, against the tuned kernels and
    the plain version, channel-major with the prenorm (the UNet's call)."""
    rng = np.random.default_rng(N + C)
    x, w, g = _card_inputs(rng, 4, N, C, 128, dtype, True, cuda_device)
    before = (la.linear_attention_pass1.generic, la.linear_attention_pass1.launches)
    gen = la.linear_attention(x, w, prenorm=(g,), _generic=True)
    tuned = la.linear_attention(x, w, prenorm=(g,))
    torch.cuda.synchronize()
    assert (la.linear_attention_pass1.generic - before[0],
            la.linear_attention_pass1.launches - before[1]) == (1, 2)
    want = la.linear_attention_reference(x, w, prenorm=(g,))
    scale = float(want.float().abs().max())
    for got in (gen, tuned):
        assert float((got.float() - want.float()).abs().max()) / scale <= CUDA_TOL[dtype]
    assert float((gen.float() - tuned.float()).abs().max()) / scale <= 2 * CUDA_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads, dim_head", [(8, 64), (3, 24)])
def test_cuda_generic_reruns_bit_identical(cuda_device, heads, dim_head, dtype):
    rng = np.random.default_rng(heads)
    x, w, g = _card_inputs(rng, 8, 16384, 64, heads * dim_head, dtype, True, cuda_device)
    first = la.linear_attention(x, w, heads, dim_head, prenorm=(g,))
    for _ in range(3):
        assert torch.equal(la.linear_attention(x, w, heads, dim_head, prenorm=(g,)), first)


@pytest.mark.gpu
def test_cuda_generic_sass_has_no_atomics(cuda_device):
    found = la.atomic_instructions_any()
    assert found and not any(found.values()), found


@pytest.mark.gpu
def test_cuda_generic_bf16_runs_on_tensor_cores(cuda_device):
    """Every bf16 pass-1 and pass-2 instantiation of the generic library has
    tensor-core (HMMA / HGMMA) instructions in its machine code; every fp32
    one has none (TF32 is never used)."""
    from dmhomo_torch.ops.build import tensor_core_instructions

    found = tensor_core_instructions(la.build_generic(), "linear_attention_any_")
    for p in ("pass1", "pass2"):
        bf16 = {k: v for k, v in found.items() if f"{p}_bf16" in k}
        fp32 = {k: v for k, v in found.items() if f"{p}_fp32" in k}
        assert len(bf16) == len(fp32) == 4, found  # dim_head padded to 16, 32, 64, 128
        assert all(v > 0 for v in bf16.values()) and not any(fp32.values()), found


@pytest.mark.gpu
@pytest.mark.parametrize("pass_", [1, 2])
@pytest.mark.parametrize("heads, dim_head", [(1, 1), (1, 5), (3, 24), (8, 64), (8, 128),
                                             (2, 127), (16, 8), (16, 64)])
def test_cuda_library_plan_is_the_python_plan(cuda_device, pass_, heads, dim_head):
    for B, N, C in ((1, 1, 1), (16, 16384, 64), (50, 1024, 512), (3, 17, 1024)):
        want = la.generic_launch_plan(pass_, B, N, C, heads, dim_head)
        got = la.library_plan_any(pass_, B, N, C, heads, dim_head)
        assert got == {**want, "partials": want["partials"] % 2**31}
