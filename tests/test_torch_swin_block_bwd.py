"""The port's whole-block Swin backward against the JAX package's.

* the plain backward vs the gradients of ``fused_swin_block`` (the Pallas
  ``_bwd_kernel`` under its ``custom_vjp``, in interpret mode on the CPU) at
  H=W=16, C=24, 3 heads, an MLP of 2C, shift 0 and 4: fp32 dx within 1e-4
  and each parameter gradient within 1e-5 of max(1, its largest |value|),
  as ``tests/test_models.py`` holds the JAX fused block to the XLA one;
  bf16 within 2e-2 of max(1, the largest |value|), as the forward: XLA on
  the CPU keeps excess precision between the kernel's bf16 operations, so
  some roundings land one bf16 step apart;
* ``swin_block`` on CPU tensors goes through ``SwinBlockFunction`` and the
  explicit plain backward, not autograd of the plain forward;
* the port's ``SwinBlock`` with ``fused_block`` vs the default: the same
  gradients of every parameter and of the input (fp32, 1e-5 of max(1, the
  largest |value|): the gradients sum 512 tokens and reach 30-90);
* the argument checks of ``swin_block_backward``;
* on the card: the backward kernels vs the plain backward at the six block
  shapes of the shipped estimator; grids with fewer windows than SMs, a
  short last chunk of windows, shift 4 with its mask at every C; two
  launches bit-identical; the plan's shared memory and scratch layout as
  the library computes them, a scratch too small refused; the window
  kernels' scratch against the plain per-window part's operands; the SASS
  counter finds the atomics of a kernel built with them (skip here).

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_swin_block_bwd.py
"""

import numpy as np
import pytest
import torch

from dmhomo_torch.models.swin import SwinBlock
from dmhomo_torch.ops import swin_block as sb
from dmhomo_torch.ops.window_attention import _scale_io

from test_torch_swin_block import KERNELS, SHIPPED, TOL, _inputs, _port_params, _rel_err

# fp32: dx absolute, parameter gradients relative to max(1, largest |value|)
DX_TOL = 1e-4


def _jax_grads(x, params, mask, dy, heads, shift, dtype):
    """(dx, grads in the port's layout) of ``fused_swin_block`` by jax.vjp."""
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.swin_block import fused_swin_block

    B, H, W, C = x.shape
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def f(xx, pp):
        return fused_swin_block(xx, pp, None if mask is None else jnp.asarray(mask),
                                resolution=(H, W), window_size=8, num_heads=heads, shift=shift)

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt).reshape(B, H * W, C),
                     tuple(jnp.asarray(p) for p in params))
    dx, grads = vjp(jnp.asarray(dy, jdt).reshape(B, H * W, C))
    dx = torch.from_numpy(np.array(dx.astype(jnp.float32)).reshape(B, H, W, C))
    grads = [np.asarray(g) for g in grads]
    return dx, [torch.from_numpy(np.ascontiguousarray(g.T if n in KERNELS else g))
                for n, g in zip(sb.PARAM_NAMES, grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 4])
def test_plain_backward_matches_pallas_kernel(shift, dtype):
    B, H, W, C, heads, hidden = 2, 16, 16, 24, 3, 48
    x, params, mask = _inputs(10 + shift, B, H, W, C, heads, hidden, shift)
    dy = np.random.default_rng(20 + shift).normal(0, 1, x.shape).astype(np.float32)
    want_dx, want = _jax_grads(x, params, mask, dy, heads, shift, dtype)
    tdt = getattr(torch, dtype)
    dx, grads = sb.swin_block_backward_reference(
        torch.from_numpy(x).to(tdt), _port_params(params),
        None if mask is None else torch.from_numpy(mask), torch.from_numpy(dy).to(tdt),
        num_heads=heads, shift=shift)
    assert dx.dtype == tdt and dx.shape == (B, H, W, C)
    assert [g.dtype for g in grads] == [torch.float32] * len(sb.PARAM_NAMES)
    assert [g.shape for g in grads] == [g.shape for g in want]
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), want_dx.numpy(), atol=DX_TOL, rtol=0)
        for name, got, g in zip(sb.PARAM_NAMES, grads, want):
            assert _rel_err(got, g) <= TOL["float32"], name
    else:
        assert _rel_err(dx, want_dx) <= TOL["bfloat16"]
        for name, got, g in zip(sb.PARAM_NAMES, grads, want):
            assert _rel_err(got, g) <= TOL["bfloat16"], name


def test_cpu_gradients_take_the_explicit_plain_backward(monkeypatch):
    """``swin_block`` builds a ``SwinBlockFunction`` node whose backward is
    the plain backward (called once, with the forward's saved inputs)."""
    x, params, mask = _inputs(4, 1, 16, 16, 24, 3, 72, 4)
    calls = []
    plain = sb.swin_block_backward_reference

    def spy(*args, **kw):
        calls.append(kw)
        return plain(*args, **kw)

    monkeypatch.setattr(sb, "swin_block_backward_reference", spy)
    before = (sb.swin_block.launches, sb.swin_block_backward.launches)
    xt = torch.from_numpy(x).requires_grad_()
    pp = [p.requires_grad_() for p in _port_params(params)]
    y = sb.swin_block(xt, pp, torch.from_numpy(mask), num_heads=3, shift=4)
    assert type(y.grad_fn).__name__ == "SwinBlockFunctionBackward"
    dy = torch.from_numpy(np.random.default_rng(5).normal(0, 1, x.shape).astype(np.float32))
    got = torch.autograd.grad(y, [xt] + pp, dy)
    assert calls == [dict(num_heads=3, window_size=8, shift=4)]
    dx, grads = plain(torch.from_numpy(x), _port_params(params), torch.from_numpy(mask), dy,
                      num_heads=3, shift=4)
    for a, b in zip(got, (dx,) + grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (sb.swin_block.launches, sb.swin_block_backward.launches) == before


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_module_fused_gradients_match_default(shift):
    """Same weights: the fused block's gradients of every parameter (the
    position-bias table through ``position_bias()``) and of the input are
    the unfused block's."""
    H = W = 16
    default = SwinBlock(24, (H, W), 3, 8, shift, 2.0)
    fused = SwinBlock(24, (H, W), 3, 8, shift, 2.0, attn_impl="fused_block")
    gen = torch.Generator().manual_seed(10 + shift)
    with torch.no_grad():
        for name, p in default.named_parameters():
            base = 1.0 if name.endswith(("norm1.weight", "norm2.weight")) else 0.0
            p.copy_(base + 0.2 * torch.randn(p.shape, generator=gen))
    fused.load_state_dict(default.state_dict(), strict=True)
    x = torch.randn(2, H * W, 24, generator=gen)
    dy = torch.randn(2, H * W, 24, generator=gen)
    grads = []
    for block in (default, fused):
        xt = x.clone().requires_grad_()
        names, ps = zip(*block.named_parameters())
        grads.append(dict(zip(("x",) + names, torch.autograd.grad(block(xt), (xt,) + ps, dy))))
    assert list(grads[0]) == list(grads[1])
    assert float(grads[1]["attn.relative_position_bias_table"].abs().max()) > 0
    for name, g in grads[0].items():
        assert _rel_err(grads[1][name], g) <= TOL["float32"], name


@pytest.mark.parametrize("case, match", [
    (dict(), None),
    (dict(dtype=torch.bfloat16), "dy must be"),
    (dict(shape=(1, 16, 8, 24)), "dy must be"),
    (dict(strided=True), "dy must be contiguous"),
])
def test_backward_argument_checks(case, match):
    """A dy the backward kernel does not take is refused before any launch."""
    x = torch.zeros((1, 16, 16, 24))
    dy = torch.zeros(case.get("shape", x.shape), dtype=case.get("dtype", x.dtype))
    if case.get("strided"):
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    if match is None:
        sb._check_dy(x, dy)
        return
    with pytest.raises(ValueError, match=match):
        sb._check_dy(x, dy)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this comparison there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("shape", SHIPPED, ids=[f"{h}x{w}c{c}h{n}" for h, w, c, n in SHIPPED])
def test_cuda_backward_kernel_matches_plain(cuda_device, shape, shift, dtype):
    """The kernels sum the parameter gradients in another order than the
    plain version: fp32 within 1e-5 of max(1, largest |value|)."""
    H, W, C, heads = shape
    x, params, mask = _inputs(8, 2, H, W, C, heads, 3 * C, shift)
    tdt = getattr(torch, dtype)
    dy = np.random.default_rng(9).normal(0, 1, x.shape).astype(np.float32)
    args = (torch.from_numpy(x).to(cuda_device, tdt), _port_params(params, cuda_device),
            None if mask is None else torch.from_numpy(mask).to(cuda_device),
            torch.from_numpy(dy).to(cuda_device, tdt))
    before = sb.swin_block_backward.launches
    dx, grads = sb.swin_block_backward(*args, num_heads=heads, shift=shift)
    torch.cuda.synchronize()
    assert sb.swin_block_backward.launches == before + 1
    want_dx, want = sb.swin_block_backward_reference(*args, num_heads=heads, shift=shift)
    assert dx.dtype == want_dx.dtype and dx.shape == want_dx.shape
    for name, got, w in zip(("dx",) + sb.PARAM_NAMES, (dx,) + grads, (want_dx,) + want):
        assert bool(torch.isfinite(got).all()), name
        assert _rel_err(got, w) <= TOL[dtype], name


def _cuda_backward(dev, B, H, W, C, heads, shift, dtype, seed=8):
    x, params, mask = _inputs(seed, B, H, W, C, heads, 3 * C, shift)
    dy = np.random.default_rng(seed + 1).normal(0, 1, x.shape).astype(np.float32)
    tdt = getattr(torch, dtype)
    args = (torch.from_numpy(x).to(dev, tdt), _port_params(params, dev),
            None if mask is None else torch.from_numpy(mask).to(dev),
            torch.from_numpy(dy).to(dev, tdt))
    return args, sb.swin_block_backward(*args, num_heads=heads, shift=shift)


# (B, H, W, C, heads, shift): fewer windows than SMs (B=1 at 40x72: 45);
# window counts that are no multiple of the attention's windows per block;
# shift 4 with its mask at every C
EDGES = [(1, 40, 72, 96, 24, 0), (1, 40, 72, 96, 3, 4), (3, 40, 72, 48, 12, 0),
         (3, 80, 144, 24, 3, 4), (2, 40, 72, 48, 3, 4), (2, 40, 72, 96, 12, 4),
         (3, 40, 72, 96, 24, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", EDGES, ids=[f"b{b}_{h}x{w}c{c}h{n}s{s}" for b, h, w, c, n, s in EDGES])
def test_cuda_backward_edge_grids(cuda_device, case, dtype):
    B, H, W, C, heads, shift = case
    args, (dx, grads) = _cuda_backward(cuda_device, B, H, W, C, heads, shift, dtype)
    plan = sb.backward_plan(args[0], heads, 3 * C, args[2])
    per = plan["kernels"]["attention"]["windows_per_block"]
    if B == 1:
        assert plan["windows"] < sb.SMS
    want_dx, want = sb.swin_block_backward_reference(*args, num_heads=heads, shift=shift)
    for name, got, w in zip(("dx",) + sb.PARAM_NAMES, (dx,) + grads, (want_dx,) + want):
        assert bool(torch.isfinite(got).all()), name
        assert _rel_err(got, w) <= TOL[dtype], (name, per)


def test_edge_grids_cover_short_chunks():
    """Some edge cases leave the attention's last chunk of windows short."""
    short = [plan["windows"] % plan["kernels"]["attention"]["windows_per_block"]
             for plan in (sb.backward_plan(torch.empty(b, h, w, c), n, 3 * c)
                          for b, h, w, c, n, _ in EDGES)]
    assert any(short)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_is_deterministic(cuda_device, dtype):
    """Every sum runs in a fixed order: two launches, the same bits."""
    args, first = _cuda_backward(cuda_device, 8, 40, 72, 96, 24, 4, dtype)
    second = sb.swin_block_backward(*args, num_heads=24, shift=4)
    for name, a, b in zip(("dx",) + sb.PARAM_NAMES, (first[0],) + first[1],
                          (second[0],) + second[1]):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHIPPED, ids=[f"{h}x{w}c{c}h{n}" for h, w, c, n in SHIPPED])
def test_cuda_backward_plan_matches_library(cuda_device, shape):
    """The plan's shared memory and scratch (offsets and size, computed in
    Python for the CPU) are the library's, which carves the scratch."""
    H, W, C, heads = shape
    for dtype in (torch.float32, torch.bfloat16):
        for B in (8, 1, 3):
            x = torch.empty(B, H, W, C, dtype=dtype)
            plan = sb.backward_plan(x, heads, 3 * C)
            layout = sb.backward_scratch_layout(x, heads, 3 * C)
            assert layout == {**{n: plan["scratch"][n][0] for n in sb.SCRATCH},
                              "bytes": plan["scratch_bytes"]}, (dtype, B)
        for kernel in sb.BACKWARD_KERNELS:
            assert sb.backward_shared_memory_bytes(C, C // heads, kernel, dtype) == \
                plan["kernels"][kernel]["smem"], (dtype, kernel)


def _raw_backward(args, heads, shift, scratch_bytes=None):
    """The library's backward launched directly on ``args`` with a scratch
    of its own layout's size, declared as ``scratch_bytes`` if given:
    (error, scratch, layout) after the card finishes."""
    x, params, mask, dy = args
    B, H, W, C = x.shape
    hidden, hd = params[10].shape[0], C // heads
    k = sb.backward_plan(x, heads, hidden, mask)["kernels"]
    layout = sb.backward_scratch_layout(x, heads, hidden, mask)
    scratch = torch.empty(layout["bytes"], dtype=torch.uint8, device=x.device)
    dx, grads = torch.empty_like(x), [torch.empty_like(p) for p in params]
    err = sb._library().dmh_swin_block_bwd(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in params[:5]),
        None if mask is None else mask.data_ptr(), *(t.data_ptr() for t in params[5:]),
        *(g.data_ptr() for g in grads), scratch.data_ptr(),
        layout["bytes"] if scratch_bytes is None else scratch_bytes, B, H, W, C, heads, hidden,
        shift, _scale_io(hd, x.dtype), hd**-0.5, k["attention"]["windows_per_block"],
        k["weights"]["tokens_per_block"], int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return err, scratch, layout


@pytest.mark.gpu
def test_cuda_backward_refuses_small_scratch(cuda_device):
    """The library checks the scratch it is given against its own layout."""
    args, _ = _cuda_backward(cuda_device, 1, 40, 72, 96, 24, 4, "bfloat16")
    nbytes = sb.backward_scratch_layout(args[0], 24, 288, args[2])["bytes"]
    assert _raw_backward(args, 24, 4, nbytes - 256)[0] == 1  # cudaErrorInvalidValue
    assert _raw_backward(args, 24, 4)[0] == 0


# scratch slot -> the operand of backward_window_reference it holds once the
# window kernels are done (the attention's backward writes dq, dk, dv over qkv)
SLOTS = {"n1": "n1", "qkv": "dqkv", "ao": "ao", "n2": "n2", "gm": "gm", "dm1": "dm1", "dh": "dh"}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 4])
def test_cuda_backward_scratch_matches_window_reference(cuda_device, shift, dtype):
    """What the window kernels hand the weight-gradient product, row for
    row (window order) against the plain per-window part's operands."""
    args, _ = _cuda_backward(cuda_device, 2, 16, 24, 24, 3, shift, dtype)
    err, scratch, layout = _raw_backward(args, 3, shift)
    assert err == 0
    _, operands, _ = sb.backward_window_reference(*args, num_heads=3, shift=shift)
    for slot, name in SLOTS.items():
        want = sb._windows(operands[name], sb.WINDOW)
        want = want.reshape(-1, want.shape[-1])
        nbytes = want.numel() * want.element_size()
        got = scratch[layout[slot]:layout[slot] + nbytes].view(want.dtype).reshape(want.shape)
        assert _rel_err(got, want) <= TOL[dtype], name


_PROBE = """
__global__ void probe_atomic_kernel(float* p) { atomicAdd(p + threadIdx.x, 1.0f); }
__global__ void probe_plain_kernel(float* p) { p[threadIdx.x] += 1.0f; }
"""


@pytest.mark.gpu
def test_atomic_instructions_found_in_built_kernels(cuda_device, tmp_path):
    """The counter chip_smoke.py reads the backward's atomics with sees the
    atomic a kernel is built with, and none in a kernel without."""
    from dmhomo_torch.ops.build import atomic_instructions, build_library

    src = tmp_path / "probe.cu"
    src.write_text(_PROBE)
    counts = atomic_instructions(build_library(src, "dmh_atomics_probe"), "probe_")
    (atomic,) = [n for n in counts if "probe_atomic_kernel" in n]
    (plain,) = [n for n in counts if "probe_plain_kernel" in n]
    assert counts[atomic] >= 1 and counts[plain] == 0
    assert set(sb.backward_atomic_instructions().values()) == {0}
