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
* the bf16 kernels' launch plan (loader, heads per block, ring) and their
  weights (round(diag(g) W)^T, g . W) against the plain version's;
* the CUDA kernels vs the plain version (needs the card; skips here): small,
  ragged and unaligned cases (the element-wise loader), and the UNet's
  eight LinearAttention sites at the generation batch (the aligned loader);
* the backward (``LinearAttentionFunction``, ``linear_attention_backward``)
  against ``jax.vjp`` of ``blockdiag_linear_attention`` with and without the
  prenorm (whose statistics JAX differentiates), and against
  ``torch.autograd.grad`` of the plain version, on the CPU and (needs the
  card) at the UNet's eight sites with the kernels' forward: dx, dW, dg,
  each relative to its largest value, within 1e-5 in fp32 (summation order) and 2e-2 in
  bf16 (the backward rounds each cotangent of a bf16 value to bf16, as
  JAX's autodiff does, and autograd of the plain version rounds the sum of
  two of them once: in the softmax's backward they nearly cancel, so a
  rounding lands on the other side; the largest seen is 1.2e-2); on the
  card 3e-2 in bf16, the forward's tolerance (the kernels compute the
  statistics in their own order, and dW sums terms that largely cancel,
  so one rounding of qkv moves it by ~1e-2); given statistics
  ``(mean, rstd, g)`` under autograd are refused.

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_linear_attention.py
"""

import re

import numpy as np
import pytest
import torch

from dmhomo_torch.ops import linear_attention as la

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# on the card, with the kernels' forward: chip_smoke.py's LA_BWD_TOL
CUDA_GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


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
@pytest.mark.parametrize("C", [24, 64, 512])  # 64 and 512: the UNet's narrowest and widest
def test_plain_matches_blockdiag(C, N, prenorm, dtype):
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.linear_attention import blockdiag_linear_attention

    rng = np.random.default_rng(N)
    x, w, g = _inputs(rng, 2, N, C)
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
    (dict(heads=17), "heads <= 16"),  # outside the generic kernels' envelope
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


def _grad_inputs(x, w, g, prenorm, dtype, device="cpu", channel_major=True):
    """Leaf tensors (x channel-major, w, and g with a prenorm) and the
    prenorm argument of one call."""
    xt = torch.from_numpy(x).to(device, getattr(torch, dtype))
    if channel_major:  # the UNet's NCHW activations: token stride 1
        xt = xt.transpose(1, 2).contiguous().transpose(1, 2)
    xt.requires_grad_()
    wt = torch.from_numpy(w).to(device).requires_grad_()
    gt = torch.from_numpy(g).to(device).requires_grad_()
    leaves = [xt, wt]
    if prenorm == "none":
        return leaves, None
    return leaves + [gt], (gt,)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prenorm", [False, True])
@pytest.mark.parametrize("N, C", [(64, 24), (200, 64)])
def test_backward_matches_jax_vjp(N, C, prenorm, dtype):
    """dx, dW and dg of the Function against ``jax.vjp`` of the JAX
    production function, whose prenorm statistics come from x inside the
    differentiated function (``ChannelLayerNorm(return_stats=True)``)."""
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.linear_attention import blockdiag_linear_attention

    rng = np.random.default_rng(N + C)
    x, w, g = _inputs(rng, 2, N, C)
    dout = rng.normal(0, 1, (2, N, la.HIDDEN)).astype(np.float32)
    jdt = getattr(jnp, dtype)

    def f(x, w, g):
        pn = None
        if prenorm:
            xf = x.astype(jnp.float32)
            pn = (xf.mean(-1, keepdims=True), jax.lax.rsqrt(xf.var(-1, keepdims=True) + 1e-5), g)
        return blockdiag_linear_attention(x, w, prenorm=pn)

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(g))
    want = vjp(jnp.asarray(dout, jdt))
    leaves, pn = _grad_inputs(x, w, g, "gain" if prenorm else "none", dtype)
    out = la.linear_attention(leaves[0], leaves[1], prenorm=pn)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout).to(out.dtype))
    assert got[0].dtype == out.dtype and got[0].stride(1) == 1  # x's layout
    for a, b in zip(got, want):
        assert _rel_err(a.float().numpy(), np.asarray(b, np.float32)) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("channel_major", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prenorm", ["none", "gain"])
def test_function_matches_autograd_of_plain(prenorm, dtype, channel_major):
    """The Function (plain forward on the CPU, explicit backward) against
    ``torch.autograd.grad`` through ``linear_attention_reference``; dx in
    x's layout."""
    rng = np.random.default_rng(7)
    x, w, g = _inputs(rng, 2, 200, 64)
    dout = torch.from_numpy(rng.normal(size=(2, 200, la.HIDDEN)).astype(np.float32))
    grads, outs = [], []
    for fn in (la.linear_attention, la.linear_attention_reference):
        leaves, pn = _grad_inputs(x, w, g, prenorm, dtype, channel_major=channel_major)
        out = fn(leaves[0], leaves[1], prenorm=pn)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, leaves, dout.to(out.dtype)))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert grads[0][0].stride() == leaves[0].stride()
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert _rel_err(a.float().numpy(), b.float().numpy()) <= GRAD_TOL[dtype]


@pytest.mark.parametrize("prenorm", ["none", "gain"])
def test_backward_in_slices_and_chunks_equals_one_pass(monkeypatch, prenorm):
    """The backward takes the batch in slices of samples (to bound its fp32
    temporaries) and sums over the tokens per chunk of them: the same
    gradients within fp32 order (a product's blocking depends on its batch;
    the sums run over the slices and chunks), 1e-6 of each one's largest
    value."""
    rng = np.random.default_rng(8)
    x, w, g = (torch.from_numpy(a) for a in _inputs(rng, 3, 100, 32))
    x = x.transpose(1, 2).contiguous().transpose(1, 2)
    mean, rstd = (t.reshape(3, 100) for t in la.layer_norm_stats(x))
    if prenorm == "none":
        g = mean = rstd = None
    dout = torch.from_numpy(rng.normal(size=(3, 100, la.HIDDEN)).astype(np.float32))
    args = (x, w, g, mean, rstd, dout)
    whole = la.linear_attention_backward(*args)
    monkeypatch.setattr(la, "_BACKWARD_SLICE_BYTES", 100 * 384 * 4)  # one sample a slice
    monkeypatch.setattr(la, "_BACKWARD_CHUNK", 25)  # 4 chunks of 25 tokens
    sliced = la.linear_attention_backward(*args)
    assert sliced[0].stride() == x.stride()
    for a, b in zip(sliced, whole):
        assert (a is None) == (b is None)
        if b is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("leaf", ["x", "w", "g", "mean", "rstd"])
def test_given_statistics_under_autograd_raise(leaf):
    """A call with ``prenorm=(mean, rstd, g)`` that needs a gradient is
    refused, whichever input needs it; without a gradient it runs."""
    rng = np.random.default_rng(9)
    x, w, g = (torch.from_numpy(a) for a in _inputs(rng, 2, 40, 16))
    mean, rstd = la.layer_norm_stats(x)
    t = dict(x=x, w=w, g=g, mean=mean, rstd=rstd)
    t[leaf].requires_grad_()
    with pytest.raises(ValueError, match=r"prenorm None or \(g,\)"):
        la.linear_attention(t["x"], t["w"], prenorm=(t["mean"], t["rstd"], t["g"]))
    with torch.no_grad():
        got = la.linear_attention(t["x"], t["w"], prenorm=(t["mean"], t["rstd"], t["g"]))
    torch.testing.assert_close(got, la.linear_attention_reference(x, w, prenorm=(g,)),
                               rtol=0, atol=0)


# (N, C) of the UNet's eight LinearAttention sites at 256x256 (dim 64, mults
# (1, 2, 4, 8)): down_0..3, then up_0..3
UNET_SITES = [(65536, 64), (16384, 64), (4096, 128), (1024, 256),
              (1024, 512), (4096, 256), (16384, 128), (65536, 64)]


def _channel_major(B, N, C, dtype=torch.bfloat16, device="cpu"):
    """x (B, N, C) as the UNet hands it over: an NCHW activation, token stride 1."""
    return torch.zeros((B, C, N), dtype=dtype, device=device).transpose(1, 2)


@pytest.mark.parametrize("N, C", sorted(set(UNET_SITES)))
def test_unet_sites_take_the_aligned_loader(N, C):
    x = _channel_major(1, N, C)
    out = torch.empty((1, la.HIDDEN, N), dtype=torch.bfloat16).transpose(1, 2)
    stats = torch.empty((2, 1, N))
    for pass_, kw in ((1, {}), (1, {"stats": tuple(stats)}), (2, {"stats": tuple(stats), "out": out})):
        plan = la.launch_plan(x, pass_, **kw)
        assert plan["loader"] == "aligned" and plan.get("store", "aligned") == "aligned"
        assert plan["smem"] <= la.SMEM_LIMIT
        assert plan["chunk"] * plan["chunks"] >= plan["padded_channels"] >= C
    # four heads' resident weights fit up to C = 256, so x is read once per pass
    assert la.launch_plan(x, 1)["heads_per_block"] == (4 if C <= 256 else 2)


@pytest.mark.parametrize("N, C, channel_major", [(70001, 32, True), (1000, 100, False),
                                                  (64, 16, True), (200, 64, False)])
def test_loader_follows_the_strides(N, C, channel_major):
    """16-byte copies need token stride 1 and rows a multiple of 8 bf16:
    token-major x or N = 70001 take element loads; C is zero-padded to a
    multiple of 16 in shared memory either way."""
    if channel_major:  # out in x's layout, as linear_attention makes it
        x, out = _channel_major(1, N, C), _channel_major(1, N, la.HIDDEN)
    else:
        x, out = (torch.zeros((1, N, c), dtype=torch.bfloat16) for c in (C, la.HIDDEN))
    plan = la.launch_plan(x, 2, out=out)
    aligned = channel_major and N % 8 == 0
    assert plan["loader"] == plan["store"] == ("aligned" if aligned else "elementwise")
    assert plan["padded_channels"] == -(-C // 16) * 16


def test_offset_base_takes_the_elementwise_loader():
    x = _channel_major(1, 1032, 64)[:, 1:1025]  # token stride 1, base 2 bytes off
    assert la.launch_plan(x, 1)["loader"] == "elementwise"


@pytest.mark.parametrize("pass_", [1, 2])
@pytest.mark.parametrize("C", [16, 64, 100, 128, 256, 512, 1024])
def test_plans_fit_shared_memory(C, pass_):
    """Every plan fits a block's shared memory and covers the padded
    channels; four heads per pass-1 block take one chunk; at C <= 128 two
    blocks share an SM; beyond resident weights' room they are streamed."""
    plan = la.launch_plan(_channel_major(1, 1024, C), pass_)
    assert plan["smem"] == la._plan_smem(
        pass_, plan["padded_channels"], plan["heads_per_block"], plan["chunk"], plan["stages"],
        plan["weights"] == "streamed") <= la.SMEM_LIMIT
    assert plan["weights"] == ("streamed" if C > 800 else "resident")
    assert plan["chunk"] % 16 == 0 and plan["chunk"] * plan["chunks"] >= plan["padded_channels"]
    if pass_ == 1 and plan["heads_per_block"] == 4:
        assert plan["chunks"] == 1
    if C <= 128:
        assert 2 * (plan["smem"] + 1024) <= la.SM_SMEM


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


@pytest.mark.gpu
@pytest.mark.parametrize("site", range(len(UNET_SITES)))
def test_bf16_kernels_at_unet_sites(cuda_device, site):
    """The bf16 kernels at the generation batch (B = 50, the CFG-doubled 25),
    channel-major, prenorm: the aligned loader and stores, no element-wise
    launch, the library's shared memory as planned, and both passes within
    the bf16 tolerance of their plain versions."""
    N, C = UNET_SITES[site]
    B = 50
    gen = torch.Generator(device=cuda_device).manual_seed(site)
    x = (1.5 * torch.randn(B, C, N, generator=gen, device=cuda_device) + 0.3).to(
        torch.bfloat16).transpose(1, 2)
    w = torch.randn(C, 3 * la.HIDDEN, generator=gen, device=cuda_device) / C**0.5
    g = 0.5 + torch.rand(C, generator=gen, device=cuda_device)
    for pass_ in (1, 2):
        plan = la.launch_plan(x, pass_)
        assert la.shared_memory_bytes(pass_, plan) == plan["smem"]
    before = (la.linear_attention_pass1.elementwise, la.linear_attention_pass2.elementwise)
    got = la.linear_attention(x, w, prenorm=(g,))
    sums = torch.zeros((B, la.SUMS), device=cuda_device)
    mean = torch.empty((B, N), device=cuda_device)
    rstd = torch.empty_like(mean)
    la.linear_attention_pass1(x, w, g, mean, rstd, True, sums)
    torch.cuda.synchronize()
    assert (la.linear_attention_pass1.elementwise, la.linear_attention_pass2.elementwise) == before
    assert got.stride(1) == 1  # channel-major out, as x
    want_sums = la.linear_attention_pass1_reference(x, w, prenorm=(g,))
    want = la.linear_attention_pass2_reference(x, w, want_sums, prenorm=(g,))
    for a, b in ((got, want), (sums, want_sums)):
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert bool(torch.isfinite(a).all()) and err <= TOL["bfloat16"], err
    m_ref, r_ref = la.layer_norm_stats(x)
    torch.testing.assert_close(mean, m_ref.reshape(B, N), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, r_ref.reshape(B, N), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("channel_major", [True, False])
def test_bf16_streamed_weights(cuda_device, channel_major):
    """Past the resident weights' room (C = 1000) each tile's chunks bring
    their weights along; the result stays the plain version's."""
    N, C = 3000, 1000
    rng = np.random.default_rng(C)
    x, w, g = _inputs(rng, 2, N, C)
    xt = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    if channel_major:
        xt = xt.transpose(1, 2).contiguous().transpose(1, 2)
    wt, gt = torch.from_numpy(w).to(cuda_device), torch.from_numpy(g).to(cuda_device)
    for pass_ in (1, 2):
        assert la.launch_plan(xt, pass_)["weights"] == "streamed"
    got = la.linear_attention(xt, wt, prenorm=(gt,))
    want = la.linear_attention_reference(xt, wt, prenorm=(gt,))
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert err <= TOL["bfloat16"], err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("site", range(len(UNET_SITES)))
def test_cuda_backward_at_unet_sites(cuda_device, site, dtype):
    """The Function on the card (both kernels forward, one launch each, the
    explicit backward) at a UNet site, B = 2, channel-major, prenorm: dx,
    dW and dg against ``torch.autograd.grad`` of the plain version."""
    N, C = UNET_SITES[site]
    rng = np.random.default_rng(site)
    x, w, g = _inputs(rng, 2, N, C)
    dout = torch.from_numpy(rng.normal(size=(2, N, la.HIDDEN)).astype(np.float32))
    grads = []
    for fn in (la.linear_attention, la.linear_attention_reference):
        leaves, pn = _grad_inputs(x, w, g, "gain", dtype, cuda_device)
        before = (la.linear_attention_pass1.launches, la.linear_attention_pass2.launches)
        out = fn(leaves[0], leaves[1], prenorm=pn)
        grads.append(torch.autograd.grad(out, leaves, dout.to(cuda_device, out.dtype)))
        launched = (la.linear_attention_pass1.launches - before[0],
                    la.linear_attention_pass2.launches - before[1])
        assert launched == ((1, 1) if fn is la.linear_attention else (0, 0))
    assert grads[0][0].stride(1) == 1
    for a, b in zip(*grads):
        err = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert bool(torch.isfinite(a).all()) and err <= CUDA_GRAD_TOL[dtype], err


def test_source_has_no_atomics():
    """No atomic call or reduction-to-memory instruction in the tuned
    kernels' code (comments aside): pass 1 writes per-block slots and its
    reduction launches sum them in a fixed order."""
    code = re.sub(r"//[^\n]*", "", la._SOURCE.read_text())
    assert not re.search(r"\batomic[A-Z]\w*\s*\(|\bred\.|\batom\.", code)
    for name in ("linear_attention_reduce_kernel", "linear_attention_reduce_kernel_tc"):
        assert re.search(rf"\b{name}\s*(<<<|\()", code), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B, site", [(32, s) for s in sorted(set(UNET_SITES))]
                         + [(50, (65536, 64)), (50, (1024, 512)), (3, (70001, 32))])
def test_cuda_pass1_is_deterministic(cuda_device, B, site, dtype):
    """Six calls of the tuned pass 1 and of the whole forward on one input
    give the same bits: at the DGM training sites (microbatch 32), at
    generation's batch (50) and where a block walks ragged tiles of several
    batch rows; the sums stay the plain version's."""
    N, C = site
    gen = torch.Generator(device=cuda_device).manual_seed(N + C + B)
    x = (1.5 * torch.randn(B, C, N, generator=gen, device=cuda_device) + 0.3).to(
        getattr(torch, dtype)).transpose(1, 2)
    w = torch.randn(C, 3 * la.HIDDEN, generator=gen, device=cuda_device) / C**0.5
    g = 0.5 + torch.rand(C, generator=gen, device=cuda_device)
    sums, outs = [], []
    for _ in range(6):
        s = torch.full((B, la.SUMS), float("nan"), device=cuda_device)
        mean, rstd = (torch.empty((B, N), device=cuda_device) for _ in range(2))
        la.linear_attention_pass1(x, w, g, mean, rstd, True, s)
        sums.append(s)
        outs.append(la.linear_attention(x, w, prenorm=(g,)))
    torch.cuda.synchronize()
    assert all(torch.equal(s, sums[0]) for s in sums[1:])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    want = la.linear_attention_pass1_reference(x, w, prenorm=(g,))
    err = float((sums[0] - want).abs().max() / want.abs().max())
    assert err <= TOL[dtype], err


def test_breakdown_edits_apply():
    """Each part the breakdown tool removes is still found once in the
    kernel source, so its copies differ from the source by that part."""
    from dmhomo_torch.ops import linear_attention_breakdown as bd

    src = la._SOURCE.read_text()
    copies = bd.variants(src)
    assert copies.pop("unchanged") == src
    assert len(copies) == 7 and all(text != src for text in copies.values())
