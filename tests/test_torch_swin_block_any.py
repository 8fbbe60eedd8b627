"""The whole Swin block at every window and width the Pallas kernels take:
the generic variant (``csrc/swin_block_any.cu``).

* the plain version, forward and gradients, vs ``fused_swin_block`` (the
  Pallas kernels under their ``custom_vjp``, in interpret mode on the CPU)
  at windows 2, 4 and 7, C = 8 and 24, with the shift and its mask: fp32
  within 1e-5 (the forward), dx within 1e-4 and each parameter gradient
  within 1e-5 of max(1, its largest |value|), as
  ``tests/test_torch_swin_block*.py`` hold the shipped shapes;
* a tiny estimator at window 4 with two blocks per level (so SW-MSA at N =
  16 runs) against the jitted JAX ``HomographyEstimator``, both with
  ``attn_impl`` 'xla' and with 'fused_block' (flows 1e-4, masks 1e-5);
* the variant a shape takes, the generic plans' arithmetic and the argument
  checks at the edges of the envelope (windows up to 12, C up to 384 with
  head dims up to 64, an MLP of 1..4 C);
* on the card: the generic kernels vs the plain versions at windows 1, 2, 4,
  7, 12 with C = 8, 24, 96, 384 and MLPs of 2, 3, 4 C (1e-5 / 2e-2 relative
  to max(1, largest), dx 1e-4 in fp32); the generic variant forced at a
  shipped shape against the tuned kernels; the same bits from two runs; no
  atomic instruction in the library; the plans as the library computes them
  (skip here); tensor-core instructions in every bf16 product
  instantiation's machine code and none in any fp32 one.

JAX is imported inside the tests that use it, so that the card's tests run
where JAX is not installed:
  python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_swin_block_any.py
"""

import numpy as np
import pytest
import torch

from dmhomo_torch.config import EstimatorConfig, SwinConfig
from dmhomo_torch.models.swin import SwinBlock, shifted_window_mask
from dmhomo_torch.ops import swin_block as sb

KERNELS = ("wq", "wp", "w1", "w2")  # (in, out) in JAX, (out, in) in the port
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # relative to max(1, largest |value|)
DX_TOL = 1e-4  # fp32 dx, absolute


def _params(rng, C, heads, hidden, N):
    """JAX-layout block parameters (numpy fp32), in PARAM_NAMES order."""
    shapes = {"g1": (C,), "b1": (C,), "wq": (C, 3 * C), "bq": (3 * C,),
              "bias": (heads, N, N), "wp": (C, C), "bp": (C,), "g2": (C,), "b2": (C,),
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


def _inputs(seed, B, H, W, C, heads, hidden, ws, shift):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    dy = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    params = _params(rng, C, heads, hidden, ws * ws)
    mask = shifted_window_mask(H, W, ws, shift) if shift else None
    return x, params, mask, dy


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


# (ws, H, W): a shift of ws // 2 where ws > 1
PLAIN_WINDOWS = [(2, 8, 8), (4, 8, 16), (7, 14, 14)]


@pytest.mark.parametrize("C, heads", [(8, 2), (24, 3)])
@pytest.mark.parametrize("ws, H, W", PLAIN_WINDOWS)
def test_plain_matches_pallas_kernel(ws, H, W, C, heads):
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.ops.swin_block import fused_swin_block

    B, hidden, shift = 1, 2 * C, ws // 2
    x, params, mask, dy = _inputs(ws * 10 + C, B, H, W, C, heads, hidden, ws, shift)

    def f(xx, pp):
        return fused_swin_block(xx, pp, None if mask is None else jnp.asarray(mask),
                                resolution=(H, W), window_size=ws, num_heads=heads, shift=shift)

    want, vjp = jax.vjp(f, jnp.asarray(x).reshape(B, H * W, C),
                        tuple(jnp.asarray(p) for p in params))
    want_dx, want_grads = vjp(jnp.asarray(dy).reshape(B, H * W, C))
    args = (torch.from_numpy(x), _port_params(params),
            None if mask is None else torch.from_numpy(mask))
    kw = dict(num_heads=heads, window_size=ws, shift=shift)
    got = sb.swin_block_reference(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(B, H, W, C), atol=1e-5,
                               rtol=0)
    dx, grads = sb.swin_block_backward_reference(*args, torch.from_numpy(dy), **kw)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx).reshape(B, H, W, C),
                               atol=DX_TOL, rtol=0)
    for n, g, w in zip(sb.PARAM_NAMES, grads, want_grads):
        w = torch.from_numpy(np.ascontiguousarray(np.asarray(w).T if n in KERNELS else w))
        assert _rel_err(g, w) <= TOL["float32"], n


def _jax_like_params(shapes, rng):
    """Trained-looking values for a JAX variables tree of ShapeDtypeStructs."""
    import jax

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

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# window 4 with two blocks a level: the second shifts by 2 wherever the
# window does not cover the map, so SW-MSA runs at N = 16
WINDOW4 = dict(embed_dim=8, depths=(2, 2, 2), layer_depth=(3, 2, 1), num_heads=(2, 2, 4),
               window_size=4, mlp_ratio=2.0)


@pytest.mark.parametrize("attn_impl", ["xla", "fused_block"])
def test_window4_estimator_matches_jax(attn_impl):
    import jax
    import jax.numpy as jnp

    from dmhomo_tpu.geometry import basis as jax_basis
    from dmhomo_tpu.models.estimator import EstimatorConfig as JaxEstimatorConfig
    from dmhomo_tpu.models.estimator import HomographyEstimator as JaxEstimator
    from dmhomo_tpu.models.swin import SwinConfig as JaxSwinConfig

    from dmhomo_torch.models.convert import estimator_state_dict_from_jax
    from dmhomo_torch.models.estimator import build_estimator

    crop, ori = (32, 64), (40, 72)
    jax_basis._BASIS_OVERRIDES.clear()
    jmodel = JaxEstimator(JaxEstimatorConfig(
        crop_size=crop, ori_size=ori,
        swin=JaxSwinConfig(crop_size=crop, attn_impl=attn_impl, **WINDOW4)))
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, *crop, 2)), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    variables = _jax_like_params(shapes, rng)
    patch = rng.normal(0, 1, (2, *crop, 2)).astype(np.float32)
    want = jax.jit(lambda v, p: jmodel.apply(v, p, train=False))(variables, jnp.asarray(patch))

    cfg = EstimatorConfig(ori_size=ori, swin=SwinConfig(crop_size=crop, attn_impl=attn_impl,
                                                        **WINDOW4))
    model = build_estimator(cfg, device="cpu")
    model.load_state_dict(
        estimator_state_dict_from_jax(variables["params"], variables["batch_stats"], cfg),
        strict=True)
    blocks = [m for m in model.modules() if isinstance(m, SwinBlock)]
    assert {m.window_size for m in blocks} == {4}
    assert any(m.shift_size == 2 for m in blocks)
    assert all(m.fused for m in blocks) == (attn_impl == "fused_block")
    with torch.no_grad():
        got = model(torch.from_numpy(patch))
    assert float(got["flow_f"].abs().max()) > 0.1
    for key in ("flow_f", "flow_b", "weight_f", "weight_b", "mask_f", "mask_b", "mask_fusion"):
        atol = 1e-5 if key.startswith("mask") else 1e-4
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=atol, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("ws, C, heads, hidden, want", [
    (8, 24, 3, 72, "tuned"), (8, 96, 24, 288, "tuned"), (8, 48, 12, 48, "tuned"),
    (4, 24, 3, 72, "generic"), (8, 32, 4, 64, "generic"), (8, 24, 4, 72, "generic"),
    (8, 24, 3, 36, "generic"), (12, 384, 6, 1536, "generic"),
])
def test_variant_by_shape(ws, C, heads, hidden, want):
    assert sb.variant(ws, C, heads, hidden) == want
    x = torch.empty(1, 2 * ws * 4, 3 * ws * 4, C)
    assert sb.forward_plan(x, heads, hidden, ws).get("variant", "tuned") == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, H, W, C, heads, hidden, ws", [
    (32, 160, 288, 24, 3, 72, 4), (8, 40, 72, 96, 24, 288, 4), (2, 16, 32, 8, 2, 16, 4),
    (1, 4, 8, 32, 4, 64, 4), (1, 12, 12, 384, 6, 1536, 12), (3, 7, 14, 8, 8, 1, 7),
    (1, 1, 1, 1, 1, 1, 1),
])
def test_generic_plans(B, H, W, C, heads, hidden, ws, dtype):
    """The forward's five launches and the backward's eleven: the preparing
    launch covers every prepared weight, each product launch (one product,
    or a chain) covers every token row in tiles that fit the card (bf16: 64
    rows x 64 columns; fp32: 4096 outputs a chunk), the attention's plan is
    the window attention's, the scratch holds every buffer at its size."""
    x = torch.empty(B, H, W, C, dtype=dtype)
    f = sb.forward_plan(x, heads, hidden, ws)
    b = sb.backward_plan(x, heads, hidden, None, ws)
    assert tuple(f["launches"]) == sb.GENERIC_FORWARD
    assert tuple(b["launches"]) == sb.GENERIC_BACKWARD and b["atomics"] == 0
    M, N, it = B * H * W, ws * ws, x.element_size()
    bf16 = dtype == torch.bfloat16
    assert f["tokens"] == M and f["windows"] * N == M
    products = {"qkv": [(C, 3 * C)], "proj_fc1": [(C, C), (C, hidden)], "fc2": [(hidden, C)],
                "dm1": [(C, hidden)], "dn2": [(hidden, C)], "dao": [(C, C)], "dn1": [(3 * C, C)]}
    att_threads = {n: sb.generic_launch_plan(M // N, N, C // heads, heads, n == "attention_bwd",
                                             it)["threads"] for n in ("attention", "attention_bwd")}
    for plan in (f, b):
        for name, k in plan["launches"].items():
            assert 0 <= k["smem"] <= sb.SMEM_PER_BLOCK
            assert k["threads"] == att_threads.get(name, 256)
            if name not in products:
                continue
            gx, gy, gz = k["grid"]
            rows, cols = k["rows"], k["cols"]
            assert [tuple(p) for p in k["products"]] == products[name] and gy == gz == 1
            if name not in sb.GENERIC_LNB:  # a tile a block
                assert gx * rows >= M > (gx - 1) * rows and k["tiles_per_block"] == 1
            assert (rows, cols) == (64, 64) if bf16 else rows * cols == sb.F_OUTPUTS
    for plan, n_mats in ((f, 4), (b, 8)):
        mats = sb._prepared(C, hidden, bf16, it)[:n_mats]
        assert plan["launches"]["prep"]["matrices"] == n_mats
        assert plan["scratch"]["w"][1] == sum(sb._align(m[4]) for m in mats)
        elems = sum(kp * np_ for _, _, kp, np_, _ in mats)
        gx = plan["launches"]["prep"]["grid"][0]
        assert gx == min(-(-elems // 256), sb.PREP_MAX_BLOCKS)
        for k, n, kp, np_, nbytes in mats:
            assert kp >= k and np_ >= n and kp % (16 if bf16 else 4) == 0 and np_ % 8 == 0
            assert nbytes == kp * np_ * it
    att = sb.generic_launch_plan(M // N, N, C // heads, heads, True, it)
    assert b["launches"]["attention_bwd"]["grid"][:2] == att["grid"]
    assert b["launches"]["attention_bwd"]["partials"] == att["partials"]
    for name in sb.GENERIC_LNB:  # the fused LayerNorm backward: consecutive tiles a block
        k = b["launches"][name]
        tiles = -(-M // k["rows"])
        assert k["grid"][0] <= sb.LN_MAX_BLOCKS
        assert k["grid"][0] * k["tiles_per_block"] >= tiles > (k["grid"][0] - 1) * k[
            "tiles_per_block"]
    tps, splits = b["launches"]["weights"]["tokens_per_split"], b["launches"]["weights"]["grid"][1]
    assert splits * tps >= M > (splits - 1) * tps
    need = {"qkv": it * M * 3 * C, "ao": it * M * C, "h": it * M * C, "gm": it * M * hidden}
    for name, size in need.items():
        assert f["scratch"][name][1] == size
        assert b["scratch"][name][1] == size
    assert b["scratch"]["m1"][1] == 4 * M * hidden and b["scratch"]["dh"][1] == 4 * M * C
    assert b["scratch"]["bpart"][1] == 4 * att["partials"] * heads * N * N
    for plan, names in ((f, sb.GENERIC_FORWARD_SCRATCH), (b, sb.GENERIC_SCRATCH)):
        offsets = [plan["scratch"][n][0] for n in names]
        assert offsets == sorted(offsets) and all(o % 256 == 0 for o in offsets)
        last = plan["scratch"][names[-1]]
        assert plan["scratch_bytes"] >= last[0] + last[1]


def _check_case(case):
    """Arguments for ``_check_cuda_args``: a window-4 block at 16x32, C=24, 3
    heads, an MLP of 3C, shift 2, with one thing changed."""
    ws = case.get("window_size", 4)
    B, H, W = 1, case.get("H", 4 * ws), case.get("W", 8 * ws)
    C, heads, hidden = case.get("C", 24), case.get("heads", 3), case.get("hidden", 72)
    x = torch.zeros((B, H, W, C))
    params = _port_params(_params(np.random.default_rng(0), C, heads, hidden, ws * ws))
    mask = torch.zeros(((H // ws) * (W // ws), ws * ws, ws * ws))
    return x, params, mask, heads, ws, case.get("shift", ws // 2)


@pytest.mark.parametrize("case, match", [
    (dict(), None),
    (dict(window_size=12, C=384, heads=6, hidden=1536, shift=11), None),
    (dict(window_size=13), "window"),
    (dict(window_size=1, shift=0), None),
    (dict(C=390, heads=6), "C <= 384"),
    (dict(C=130, heads=2), "head dim"),
    (dict(C=128, heads=2, hidden=1), None),
    (dict(hidden=97), "MLP width"),
    (dict(H=18), "multiples of 4"),
    (dict(shift=4), "shift must be"),
])
def test_envelope_argument_checks(case, match):
    args = _check_case(case)
    if match is None:
        sb._check_cuda_args(*args)
        return
    with pytest.raises((ValueError, TypeError), match=match):
        sb._check_cuda_args(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py phase 28 runs these there")
    return torch.device("cuda")


def _cuda_case(dev, seed, B, H, W, C, heads, hidden, ws, shift, dtype):
    x, params, mask, dy = _inputs(seed, B, H, W, C, heads, hidden, ws, shift)
    tdt = getattr(torch, dtype)
    return (torch.from_numpy(x).to(dev, tdt), _port_params(params, dev),
            None if mask is None else torch.from_numpy(mask).to(dev),
            torch.from_numpy(dy).to(dev, tdt))


def _check_against_plain(args, heads, ws, shift, dtype, generic=False):
    x, params, mask, dy = args
    kw = dict(num_heads=heads, window_size=ws, shift=shift)
    y = sb.swin_block(x, params, mask, _generic=generic, **kw)
    dx, grads = sb.swin_block_backward(x, params, mask, dy, _generic=generic, **kw)
    torch.cuda.synchronize()
    want = sb.swin_block_reference(x, params, mask, **kw)
    want_dx, want_grads = sb.swin_block_backward_reference(x, params, mask, dy, **kw)
    assert y.dtype == x.dtype and bool(torch.isfinite(y).all())
    assert _rel_err(y, want) <= TOL[dtype]
    if dtype == "float32":
        assert float((dx - want_dx).abs().max()) <= DX_TOL
    else:
        assert _rel_err(dx, want_dx) <= TOL[dtype]
    for n, g, w in zip(sb.PARAM_NAMES, grads, want_grads):
        assert _rel_err(g, w) <= TOL[dtype], n


# (ws, H, W, C, heads, hidden factor)
GPU_CASES = [(1, 4, 6, 8, 2, 2), (2, 8, 12, 24, 3, 3), (4, 16, 32, 24, 3, 4),
             (4, 8, 16, 96, 12, 3), (7, 14, 21, 24, 4, 2), (7, 7, 14, 96, 2, 4),
             (12, 12, 24, 384, 6, 2), (12, 24, 12, 8, 1, 3), (4, 4, 8, 384, 12, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_CASES, ids=[f"ws{c[0]}c{c[3]}" for c in GPU_CASES])
def test_cuda_generic_matches_plain(cuda_device, case, dtype):
    ws, H, W, C, heads, k = case
    shift = ws // 2
    args = _cuda_case(cuda_device, ws + C, 2, H, W, C, heads, k * C, ws, shift, dtype)
    before = (sb.swin_block.launches_by_variant["generic"],
              sb.swin_block_backward.launches_by_variant["generic"])
    _check_against_plain(args, heads, ws, shift, dtype)
    assert (sb.swin_block.launches_by_variant["generic"],
            sb.swin_block_backward.launches_by_variant["generic"]) == (before[0] + 1,
                                                                       before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_forced_generic_at_a_shipped_shape(cuda_device, dtype):
    """At the shipped 40x72, C = 96, 24 heads, shift 4: the generic variant,
    forced by the private argument, against the plain version and the tuned
    kernels."""
    args = _cuda_case(cuda_device, 1, 1, 40, 72, 96, 24, 288, 8, 4, dtype)
    _check_against_plain(args, 24, 8, 4, dtype, generic=True)
    x, params, mask, dy = args
    tuned = sb.swin_block(x, params, mask, num_heads=24, shift=4)
    generic = sb.swin_block(x, params, mask, num_heads=24, shift=4, _generic=True)
    torch.cuda.synchronize()
    assert _rel_err(generic, tuned) <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_generic_is_deterministic(cuda_device, dtype):
    x, params, mask, dy = _cuda_case(cuda_device, 2, 4, 32, 64, 24, 3, 72, 4, 2, dtype)
    kw = dict(num_heads=3, window_size=4, shift=2)
    runs = []
    for _ in range(2):
        y = sb.swin_block(x, params, mask, **kw)
        dx, grads = sb.swin_block_backward(x, params, mask, dy, **kw)
        runs.append((y, dx) + tuple(grads))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_generic_library_has_no_atomics(cuda_device):
    found = sb.generic_atomic_instructions()
    assert all(n == 0 for n in found.values()), found


@pytest.mark.parametrize("signature, want", [
    ("void (anonymous namespace)::swin_block_any_gemm_kernel<__nv_bfloat16>("
     "(anonymous namespace)::GemmLaunch<__nv_bfloat16>)", ("gemm", "bfloat16")),
    ("void (anonymous namespace)::swin_block_any_weights_kernel<float>("
     "(anonymous namespace)::WeightArgs)", ("weights", "float32")),
    ("void wa_any::window_attention_any_fwd_kernel<float, 4>(const float*)",
     ("attention_any_fwd", "float32")),
    ("void wa_any::window_attention_any_reduce_kernel(wa_any::Segments)", ("reduce", "none")),
    ("void swin_block_any_gemm_kernel<4, float>(Args)", None),
    ("void swin_block_any_gemm_kernel<Pair<float>>(Args)", None),
    ("void swin_block_any_other_kernel<float>(Args)", None),
])
def test_generic_instantiation_by_template_argument(signature, want):
    """The SASS check's (kernel, dtype) of a demangled signature: an
    instantiation it cannot classify raises, so none escapes the check."""
    if want is None:
        with pytest.raises(RuntimeError):
            sb.generic_instantiation(signature)
    else:
        assert sb.generic_instantiation(signature) == want


@pytest.mark.gpu
def test_cuda_generic_tensor_core_instructions(cuda_device):
    """The generic library's SASS: every bf16 product instantiation (the
    row-tile products and the weight products) has tensor-core instructions,
    every fp32 instantiation none, and no kernel an atomic one."""
    found = sb.generic_tensor_core_instructions()
    for kernel in ("gemm", "weights"):
        assert found[(kernel, "bfloat16")] > 0, found
    assert all(n == 0 for (kernel, dtype), n in found.items() if dtype == "float32"), found
    assert ("gemm", "float32") in found and ("weights", "float32") in found, found
    assert all(n == 0 for n in sb.generic_atomic_instructions().values())


@pytest.mark.gpu
@pytest.mark.parametrize("backward", [False, True])
def test_cuda_generic_plan_matches_library(cuda_device, backward):
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, W, C, heads, hidden, ws in ((8, 160, 288, 24, 3, 72, 4),
                                              (1, 12, 12, 384, 6, 1536, 12),
                                              (3, 7, 14, 8, 8, 1, 7)):
            x = torch.empty(B, H, W, C, dtype=dtype)
            plan = (sb.generic_backward_plan if backward else sb.generic_forward_plan)(
                x, heads, hidden, ws)
            lib = sb.generic_library_plan(x, heads, hidden, ws, backward)
            for name, k in lib["launches"].items():
                want = plan["launches"][name]
                assert (k["grid"], k["threads"], k["smem"]) == (
                    want["grid"], want["threads"], want["smem"]), name
            assert lib["scratch"] == {**{n: o for n, (o, _) in plan["scratch"].items()},
                                      "bytes": plan["scratch_bytes"]}
