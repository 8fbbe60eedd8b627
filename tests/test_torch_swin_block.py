"""The port's whole-block Swin path (``attn_impl='fused_block'``) against
the JAX package's.

* the plain version vs ``fused_swin_block`` (the Pallas kernel, in interpret
  mode on the CPU) at H=W=16, C=24, 3 heads, an MLP of 2C, shift 0 and 4:
  fp32 within 1e-5 (as ``tests/test_models.py`` holds the JAX fused block to
  the XLA one); bf16 within 2e-2 of the largest value: XLA on the CPU keeps
  excess precision between the kernel's bf16 operations, so some roundings
  land one bf16 step apart.  The Pallas kernel body run op by op (each
  rounding as written) agrees to one bf16 step of each value;
* the port's ``SwinBlock`` with ``fused_block`` vs the default, same
  weights and state-dict keys (fp32, 1e-5);
* the tiny estimator of ``tests/test_torch_estimator.py`` with
  ``fused_block``, weights carried by ``estimator_state_dict_from_jax``, vs
  the jitted JAX estimator with ``fused_block`` (flows 1e-4, masks 1e-5);
* ``level_impl`` vs the JAX ``_level_impl``; the argument checks;
* on the card: the kernel vs the plain version at the six block shapes of
  the shipped estimator (B = 1 and 2, both shifts, both dtypes), the same
  bits from two launches, tensor-core instructions in the bf16 forward's
  machine code and none in the fp32 one, the plan's shared memory and
  blocks per SM against the library's and the card's, what the kernel
  refuses, and that a grad-requiring input runs the backward kernel (skips
  here).

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_swin_block.py
"""

import numpy as np
import pytest
import torch

from dmhomo_torch.config import EstimatorConfig, SwinConfig, level_impl
from dmhomo_torch.models.swin import SwinBlock, SwinTransformer, shifted_window_mask
from dmhomo_torch.ops import swin_block as sb

KERNELS = ("wq", "wp", "w1", "w2")  # (in, out) in JAX, (out, in) in the port
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # relative to max(1, largest |value|)


def _params(rng, C, heads, hidden):
    """JAX-layout block parameters (numpy fp32), in PARAM_NAMES order."""
    shapes = {"g1": (C,), "b1": (C,), "wq": (C, 3 * C), "bq": (3 * C,),
              "bias": (heads, 64, 64), "wp": (C, C), "bp": (C,), "g2": (C,), "b2": (C,),
              "w1": (C, hidden), "c1": (hidden,), "w2": (hidden, C), "c2": (C,)}
    out = []
    for name in sb.PARAM_NAMES:
        shape = shapes[name]
        if name in KERNELS:
            v = rng.normal(0, shape[0]**-0.5, shape)
        elif name in ("g1", "g2"):
            v = rng.normal(1, 0.1, shape)
        elif name == "bias":
            v = rng.normal(0, 0.5, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        out.append(v.astype(np.float32))
    return out


def _port_params(params, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(p.T if n in KERNELS else p)).to(device)
                 for n, p in zip(sb.PARAM_NAMES, params))


def _inputs(seed, B, H, W, C, heads, hidden, shift):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    params = _params(rng, C, heads, hidden)
    mask = shifted_window_mask(H, W, 8, shift) if shift else None
    return x, params, mask


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 4])
def test_plain_matches_pallas_kernel(shift, dtype):
    import jax.numpy as jnp

    from dmhomo_tpu.ops.swin_block import fused_swin_block

    B, H, W, C, heads, hidden = 2, 16, 16, 24, 3, 48
    x, params, mask = _inputs(shift, B, H, W, C, heads, hidden, shift)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = fused_swin_block(
        jnp.asarray(x, jdt).reshape(B, H * W, C), tuple(jnp.asarray(p) for p in params),
        None if mask is None else jnp.asarray(mask), resolution=(H, W), window_size=8,
        num_heads=heads, shift=shift)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)).reshape(B, H, W, C))
    got = sb.swin_block_reference(
        torch.from_numpy(x).to(getattr(torch, dtype)), _port_params(params),
        None if mask is None else torch.from_numpy(mask), num_heads=heads, shift=shift)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, W, C)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    else:
        assert _rel_err(got, want) <= TOL["bfloat16"]


class _Ref:
    """A stand-in for a Pallas ref around a jax array."""

    def __init__(self, a):
        self.a = a

    shape = property(lambda self: self.a.shape)

    def __getitem__(self, i):
        return self.a[i]

    def __setitem__(self, i, v):
        self.a = self.a.at[i].set(v)


def test_plain_follows_the_kernel_body_in_bf16():
    """The Pallas ``_fwd_kernel`` run op by op on jax arrays, one 8-row strip
    at a time (each bf16 rounding where it is written): the plain version is
    within one bf16 step (2**-8 of the value's magnitude, at least 2**-8) of
    every value."""
    import jax.numpy as jnp

    from dmhomo_tpu.ops.swin_block import _fwd_kernel

    B, H, W, C, heads, hidden = 1, 16, 16, 24, 3, 48
    x, params, _ = _inputs(5, B, H, W, C, heads, hidden, 0)
    xb = jnp.asarray(x, jnp.bfloat16)
    strips = []
    for r in range(H // 8):
        y = _Ref(jnp.zeros((B, 8, W, C), jnp.bfloat16))
        refs = [_Ref(jnp.asarray(p)) for p in params]
        _fwd_kernel(_Ref(xb[:, 8 * r:8 * r + 8]), *refs[:5], None, *refs[5:], y, ws=8,
                    num_heads=heads, clip=60.0, dt=jnp.bfloat16)
        strips.append(y.a)
    want = np.asarray(jnp.concatenate(strips, axis=1).astype(jnp.float32))
    got = sb.swin_block_reference(torch.from_numpy(x).bfloat16(), _port_params(params),
                                  num_heads=heads).float().numpy()
    step = 2.0**-8 * np.maximum(1.0, 2.0**np.ceil(np.log2(np.abs(want) + 1e-30)))
    assert (np.abs(got - want) <= step).all()
    assert (got != want).mean() < 0.01


def _randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            base = 1.0 if name.endswith("norm1.weight") or name.endswith("norm2.weight") else 0.0
            p.copy_(base + 0.2 * torch.randn(p.shape, generator=gen))


@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_module_fused_matches_default(shift):
    """Same weights and keys; the fused path gives the unfused block's output."""
    H = W = 16
    default = SwinBlock(24, (H, W), 3, 8, shift, 2.0)
    fused = SwinBlock(24, (H, W), 3, 8, shift, 2.0, attn_impl="fused_block")
    assert fused.fused and not default.fused
    assert list(fused.state_dict()) == list(default.state_dict())
    _randomize(default, shift)
    fused.load_state_dict(default.state_dict(), strict=True)
    x = torch.randn(2, H * W, 24, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(fused(x), default(x), atol=1e-5, rtol=0)


def test_fused_block_needs_a_divisible_resolution():
    """As in the JAX package, a resolution the window does not divide keeps
    the unfused path."""
    assert not SwinBlock(24, (12, 20), 3, 8, 0, 2.0, attn_impl="fused_block").fused
    assert SwinBlock(24, (8, 16), 3, 8, 4, 2.0, attn_impl="fused_block").fused


@pytest.mark.parametrize("spec", ["xla", "pallas", "auto", "fused_block",
                                  "pallas,pallas,fused_block", "xla,fused_block",
                                  "fused_block,xla,auto,pallas"])
def test_level_impl_matches_jax(spec):
    from dmhomo_tpu.models.swin import _level_impl

    for enc_idx in range(5):
        assert level_impl(spec, enc_idx) == _level_impl(spec, enc_idx)


@pytest.mark.parametrize("spec", ["flash", "xla,flash", "pallas,,fused_block"])
def test_unknown_attn_impl_raises(spec):
    with pytest.raises(ValueError, match="unknown attn_impl"):
        SwinConfig(attn_impl=spec)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        [level_impl(spec, e) for e in range(3)]


def test_per_level_spec_routes_the_blocks():
    net = SwinTransformer(SwinConfig(crop_size=(64, 128), attn_impl="xla,xla,fused_block"))
    fused = [[m.fused for m in layer.layer if isinstance(m, SwinBlock)]
             for layer in net.encoder_layers]
    assert fused == [[False] * 6, [False] * 8, [True] * 6]


def _jax_like_params(shapes, rng):
    """Trained-looking values for a JAX variables tree of ShapeDtypeStructs."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0, np.prod(s.shape[:-1])**-0.5, s.shape)
        elif name == "scale":
            v = rng.normal(1, 0.05, s.shape)
        elif name.startswith("gamma_"):
            v = rng.normal(0.5, 0.1, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:  # biases, BN means, position tables, query tokens
            v = rng.normal(0, 0.05, s.shape)
        return v.astype(np.float32)

    import jax

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_estimator_matches_jax_fused_block():
    """The tiny estimator with attn_impl='fused_block' on both sides."""
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.geometry import basis as jax_basis
    from dmhomo_tpu.models.estimator import EstimatorConfig as JaxEstimatorConfig
    from dmhomo_tpu.models.estimator import HomographyEstimator as JaxEstimator
    from dmhomo_tpu.models.swin import SwinConfig as JaxSwinConfig

    from dmhomo_torch.models.convert import estimator_state_dict_from_jax
    from dmhomo_torch.models.estimator import HomographyEstimator, build_estimator

    crop, ori = (64, 128), (72, 144)
    jax_basis._BASIS_OVERRIDES.clear()
    jmodel = JaxEstimator(JaxEstimatorConfig(
        crop_size=crop, ori_size=ori, swin=JaxSwinConfig(crop_size=crop, attn_impl="fused_block")))
    # the parameter tree is the same for every attn_impl; only its shapes are needed
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, *crop, 2)), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    variables = _jax_like_params(shapes, rng)
    patch = rng.normal(0, 1, (2, *crop, 2)).astype(np.float32)
    want = jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(variables, jnp.asarray(patch))

    cfg = EstimatorConfig(ori_size=ori, swin=SwinConfig(crop_size=crop, attn_impl="fused_block"))
    model = build_estimator(cfg, device="cpu")
    default = HomographyEstimator(EstimatorConfig(ori_size=ori, swin=SwinConfig(crop_size=crop)))
    assert list(model.state_dict()) == list(default.state_dict())
    model.load_state_dict(
        estimator_state_dict_from_jax(variables["params"], variables["batch_stats"], cfg),
        strict=True)
    assert sum(m.fused for m in model.modules() if isinstance(m, SwinBlock)) == 20
    with torch.no_grad():
        got = model(torch.from_numpy(patch))
    assert float(got["flow_f"].abs().max()) > 0.1
    for key in ("flow_f", "flow_b", "weight_f", "weight_b", "mask_f", "mask_b", "mask_fusion"):
        atol = 1e-5 if key.startswith("mask") else 1e-4
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol, rtol=0,
                                   err_msg=key)


def test_cpu_tensors_take_the_plain_version():
    x, params, mask = _inputs(2, 1, 16, 16, 24, 3, 72, 4)
    before = sb.swin_block.launches
    args = (torch.from_numpy(x), _port_params(params), torch.from_numpy(mask))
    got = sb.swin_block(*args, num_heads=3, shift=4)
    want = sb.swin_block_reference(*args, num_heads=3, shift=4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert sb.swin_block.launches == before


def _check_case(case):
    """Arguments for ``_check_cuda_args``: the shipped 40x72, C=96 block with
    one thing changed."""
    B, H, W = 1, case.get("H", 40), 72
    C, heads, hidden = case.get("C", 96), case.get("heads", 24), case.get("hidden", 288)
    x = torch.zeros((B, H, W, C), dtype=case.get("dtype", torch.float32))
    params = list(_port_params(_params(np.random.default_rng(0), C, heads, hidden)))
    if "param_dtype" in case:
        params[0] = params[0].to(case["param_dtype"])
    if case.get("strided"):
        params[2] = params[2].t().contiguous().t()
    if case.get("grad"):
        params[2].requires_grad_()
    mask = torch.zeros((case.get("mask_rows", (H // 8) * (W // 8)), 64, 64))
    return x, params, mask, heads, case.get("window_size", 8), case.get("shift", 4)


@pytest.mark.parametrize("case, match", [
    (dict(), None),
    (dict(C=392, heads=4), "C <= 384"),
    (dict(heads=5), "head dim"),
    (dict(H=44), "multiples of 8"),
    (dict(window_size=13), "window"),
    (dict(shift=8), "shift must be"),
    (dict(mask_rows=44), "mask must be"),
    (dict(hidden=385), "MLP width"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(param_dtype=torch.float64), "g1 must be float32"),
    (dict(strided=True), "wq must be contiguous"),
    (dict(grad=True), None),
])
def test_kernel_argument_checks(case, match):
    """What the kernel does not take is refused before any launch; an input
    that requires grad is taken (the backward kernel gives its gradient)."""
    args = _check_case(case)
    if match is None:
        sb._check_cuda_args(*args)
        return
    with pytest.raises((ValueError, TypeError, NotImplementedError), match=match):
        sb._check_cuda_args(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs this comparison there")
    return torch.device("cuda")


# (H, W, C, heads) of the shipped estimator's Swin blocks
SHIPPED = [(160, 288, 24, 3), (80, 144, 48, 3), (40, 72, 96, 3), (80, 144, 48, 12),
           (40, 72, 96, 12), (40, 72, 96, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("shape", SHIPPED, ids=[f"{h}x{w}c{c}h{n}" for h, w, c, n in SHIPPED])
def test_cuda_kernel_matches_plain(cuda_device, shape, shift, dtype, B):
    H, W, C, heads = shape
    x, params, mask = _inputs(7, B, H, W, C, heads, 3 * C, shift)
    args = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype)),
            _port_params(params, cuda_device),
            None if mask is None else torch.from_numpy(mask).to(cuda_device))
    before = sb.swin_block.launches
    got = sb.swin_block(*args, num_heads=heads, shift=shift)
    torch.cuda.synchronize()
    assert sb.swin_block.launches == before + 1
    want = sb.swin_block_reference(*args, num_heads=heads, shift=shift)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHIPPED, ids=[f"{h}x{w}c{c}h{n}" for h, w, c, n in SHIPPED])
def test_cuda_forward_is_deterministic(cuda_device, shape, dtype):
    """Two launches on the same inputs give the same bits (no atomics, fixed
    summation order)."""
    H, W, C, heads = shape
    x, params, mask = _inputs(9, 2, H, W, C, heads, 3 * C, 4)
    args = (torch.from_numpy(x).to(cuda_device, getattr(torch, dtype)),
            _port_params(params, cuda_device), torch.from_numpy(mask).to(cuda_device))
    with torch.no_grad():
        a = sb.swin_block(*args, num_heads=heads, shift=4)
        b = sb.swin_block(*args, num_heads=heads, shift=4)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_forward_tensor_cores(cuda_device):
    """Every forward instantiation is in the library; the bf16 ones hold
    tensor-core instructions (HMMA), the fp32 ones none (TF32 off)."""
    counts = sb.forward_tensor_core_instructions()
    want = {(dt, C, hd) for dt in ("float32", "bfloat16") for C in sb.CHANNELS
            for hd in (4, 8, 16, 32) if hd <= C // 3}
    assert set(counts) == want
    for (dt, C, hd), n in counts.items():
        assert (n > 0) == (dt == "bfloat16"), (dt, C, hd, n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHIPPED, ids=[f"{h}x{w}c{c}h{n}" for h, w, c, n in SHIPPED])
def test_cuda_forward_plan_matches_library(cuda_device, shape, dtype):
    """The plan's shared memory is the library's, and the card holds two or
    more blocks per SM, at C = 96 too, and no more than the plan's shared
    memory and threads allow (the registers may allow fewer)."""
    H, W, C, heads = shape
    dt = getattr(torch, dtype)
    plan = sb.forward_plan(torch.empty((8, H, W, C), dtype=dt), heads, 3 * C)
    assert sb.shared_memory_bytes(C, 3 * C, dt) == plan["smem"]
    assert 2 <= sb.forward_blocks_per_sm(C, heads, dt) <= plan["blocks_per_sm"]


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["grad", "shape", "build"])
def test_cuda_refuses_without_falling_back(cuda_device, monkeypatch, what):
    """A grad-requiring input runs the backward kernel; an unsupported shape
    or a failed build raises; nothing runs the plain or the unfused path
    instead."""
    C = 392 if what == "shape" else 48  # 392: above the envelope's 384
    x, params, _ = _inputs(3, 1, 16, 16, C, 4 if what == "shape" else 3, 3 * C, 0)
    xt = torch.from_numpy(x).to(cuda_device).requires_grad_(what != "build")
    if what == "grad":
        before = (sb.swin_block.launches, sb.swin_block_backward.launches)
        pp = [p.requires_grad_() for p in _port_params(params, cuda_device)]
        y = sb.swin_block(xt, pp, num_heads=3)
        grads = torch.autograd.grad(y, [xt] + pp, torch.ones_like(y))
        torch.cuda.synchronize()
        assert (sb.swin_block.launches, sb.swin_block_backward.launches) == (
            before[0] + 1, before[1] + 1)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        return
    if what == "build":
        def broken():
            raise RuntimeError("nvcc failed")

        monkeypatch.setattr(sb, "_library", broken)
    before = sb.swin_block.launches
    with pytest.raises((ValueError, RuntimeError)):
        sb.swin_block(xt, _port_params(params, cuda_device), num_heads=4 if what == "shape" else 3)
    assert sb.swin_block.launches == before
