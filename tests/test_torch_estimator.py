"""The port's HEM estimator against the JAX package's, on the CPU.

A tiny config (crop 64x128, ori 72x144; every Swin level, merge and
class-attention block of the shipped architecture, at small widths) is
initialized in JAX, carried over with ``estimator_state_dict_from_jax`` and
loaded ``strict=True``; both run the same numpy inputs.  The JAX side uses
its XLA attention path and its matmul warp; the port its plain window
attention and its gather warp.  Tolerance: fp32, 1e-4 absolute on flows
(pixels) and basis weights (values up to ~10) and 1e-5 on masks --
summation-order noise accumulated over the three coarse-to-fine levels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.evaluation.metrics import point_matching_error as jax_point_error
from dmhomo_tpu.geometry import basis as jax_basis
from dmhomo_tpu.models.estimator import EstimatorConfig as JaxEstimatorConfig
from dmhomo_tpu.models.estimator import HomographyEstimator as JaxEstimator
from dmhomo_tpu.models.estimator import upsample_outputs as jax_upsample
from dmhomo_tpu.models.import_torch import import_estimator_state_dict
from dmhomo_tpu.models.swin import SwinConfig as JaxSwinConfig

from dmhomo_torch.config import EstimatorConfig, SwinConfig
from dmhomo_torch.evaluation.metrics import point_matching_error
from dmhomo_torch.models.convert import (
    estimator_state_dict_from_jax,
    load_reference_state_dict,
)
from dmhomo_torch.models.estimator import (
    HomographyEstimator,
    build_estimator,
    upsample_outputs,
)

CROP = (64, 128)
ORI = (72, 144)
B = 2
FLOW_ATOL = 1e-4
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clear_basis_override():
    """The JAX importer installs a process-global basis override; keep it
    from leaking into other tests."""
    jax_basis._BASIS_OVERRIDES.clear()
    yield
    jax_basis._BASIS_OVERRIDES.clear()


def _perturb(tree, rng):
    """Random trained-looking values: LN/BN gains near 1, layer scales of
    order 0.5 (the init's 1e-5 would hide the class-attention path)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k.startswith("gamma_"):
            v = rng.normal(0.5, 0.1, v.shape)
        elif k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        else:
            v = v + rng.normal(0, 0.05, v.shape)
        out[k] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def pair():
    """(jax outputs as numpy, port model, inputs, numpy params, batch stats)."""
    jcfg = JaxEstimatorConfig(crop_size=CROP, ori_size=ORI, swin=JaxSwinConfig(crop_size=CROP))
    jmodel = JaxEstimator(jcfg)
    # jitted: one XLA compile each instead of op-by-op dispatch
    variables = jax.jit(lambda key: jmodel.init(key, jnp.zeros((1, *CROP, 2)), train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = _perturb(jax.tree.map(np.asarray, variables["params"]), rng)
    stats = _perturb(jax.tree.map(np.asarray, variables["batch_stats"]), rng)
    patch = rng.normal(0, 1, (B, *CROP, 2)).astype(np.float32)
    pt_set = rng.uniform(0, [ORI[1] - 1, ORI[0] - 1], (B, 6, 2, 2)).astype(np.float32)

    @jax.jit
    def forward(variables, patch, pt_set):
        out = jmodel.apply(variables, patch, train=False)
        full = jax_upsample(out, ORI)
        return out, full, jax_point_error(pt_set, full["flow_f"], full["flow_b"])

    jout, jfull, jerr = forward({"params": params, "batch_stats": stats}, jnp.asarray(patch),
                                jnp.asarray(pt_set))
    jax_np = {
        "patch": {k: np.asarray(v) for k, v in jout.items() if k != "fil_features"},
        "full": {k: np.asarray(jfull[k]) for k in ("flow_f", "flow_b", "mask_f", "mask_b",
                                                   "mask_fusion")},
        "err": np.asarray(jerr),
    }
    cfg = EstimatorConfig(ori_size=ORI, swin=SwinConfig(crop_size=CROP))
    model = build_estimator(cfg, device="cpu")
    model.load_state_dict(estimator_state_dict_from_jax(params, stats, cfg), strict=True)
    return jax_np, model, patch, pt_set, params, stats


@pytest.fixture(scope="module")
def port_out(pair):
    _, model, patch, pt_set, _, _ = pair
    with torch.no_grad():
        out = model(torch.from_numpy(patch))
        full = upsample_outputs(out, ORI)
        err = point_matching_error(torch.from_numpy(pt_set), full["flow_f"], full["flow_b"])
    return out, full, err


@pytest.mark.parametrize("key", ["flow_f", "flow_b", "mask_f", "mask_b", "mask_fusion",
                                 "weight_f", "weight_b"])
def test_estimator_patch_outputs_match_jax(pair, port_out, key):
    want = pair[0]["patch"][key]
    got = port_out[0][key].numpy()
    assert got.shape == want.shape
    atol = ATOL if key.startswith("mask") else FLOW_ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("key", ["flow_f", "flow_b", "mask_f", "mask_b", "mask_fusion"])
def test_upsample_outputs_match_jax(pair, port_out, key):
    want = pair[0]["full"][key]
    got = port_out[1][key].numpy()
    assert got.shape == want.shape == (B, *ORI, want.shape[-1])
    atol = FLOW_ATOL if key.startswith("flow") else ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_point_matching_error_matches_jax(pair, port_out):
    np.testing.assert_allclose(port_out[2].numpy(), pair[0]["err"], atol=FLOW_ATOL, rtol=0)


def test_flows_are_not_trivial(port_out):
    """The comparison means something only if the flows move pixels."""
    assert float(port_out[0]["flow_f"].abs().max()) > 0.1


def test_round_trip_through_jax_importer(pair):
    """import_estimator_state_dict(port.state_dict(), strict=True) gives
    back the JAX params and batch stats exactly."""
    _, model, _, _, params, stats = pair
    cfg = JaxEstimatorConfig(crop_size=CROP, ori_size=ORI, swin=JaxSwinConfig(crop_size=CROP))
    p2, s2 = import_estimator_state_dict(model.state_dict(), cfg, strict=True)
    flat1 = jax.tree_util.tree_leaves_with_path((params, stats))
    flat2 = jax.tree_util.tree_leaves_with_path((p2, s2))
    assert [k for k, _ in flat1] == [k for k, _ in flat2]
    for (k, a), (_, b) in zip(flat1, flat2):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(k))


def test_basis_buffer_in_reference_layout(pair):
    """h_net.basis is (1, 8, 2*h*w), flattened from (8, 2, h, w)."""
    model = pair[1]
    buf = model.h_net.basis.numpy()
    assert buf.shape == (1, 8, 2 * CROP[0] * CROP[1])
    want = jax_basis._gen_homography_basis(*CROP).transpose(0, 3, 1, 2).reshape(1, 8, -1)
    np.testing.assert_array_equal(buf, want)


def test_load_reference_state_dict_drops_dead_keys(pair):
    """A reference-style state dict (DDP prefix, dead modules, derived
    buffers) loads strict; a foreign key still raises."""
    model = pair[1]
    sd = {f"module.{k}": v.clone() for k, v in model.state_dict().items()}
    sd["module.h_net.patch_embed.proj.weight"] = torch.zeros(1)
    sd["module.h_net.encoder_layers.0.layer.0.attn.relative_position_index"] = torch.zeros(1)
    sd["module.h_net.encoder_layers.0.layer.1.attn_mask"] = torch.zeros(1)
    sd["module.h_net.encoder_layers.0.layer.2.reduction.weight"] = torch.zeros(1)
    sd["module.h_net.encoder_layers.0.layer.0.attn.info_flatten.0.weight"] = torch.zeros(1)
    fresh = HomographyEstimator(model.config)
    load_reference_state_dict(fresh, sd)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)
    sd["module.h_net.extra.weight"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_reference_state_dict(fresh, sd)


def test_random_init_is_seeded():
    cfg = EstimatorConfig(ori_size=ORI, swin=SwinConfig(crop_size=CROP))
    a = build_estimator(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_estimator(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)


@pytest.mark.slow
def test_shipped_config_matches_jax_at_full_size():
    """The shipped config (crop 320x576 -> 360x640, the params.json Swin
    widths) against JAX on one pair, fp32: flows and basis weights within
    1e-3 absolute, masks within 1e-4 (the tiny config's tolerances x 10:
    the same summation-order noise over 16x more tokens per window level).
    Marked slow: a full-size forward of both packages on the CPU."""
    crop, ori = (320, 576), (360, 640)
    jcfg = JaxEstimatorConfig(crop_size=crop, ori_size=ori, swin=JaxSwinConfig(crop_size=crop))
    jmodel = JaxEstimator(jcfg)
    variables = jax.jit(lambda key: jmodel.init(key, jnp.zeros((1, *crop, 2)), train=False))(
        jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    params = _perturb(jax.tree.map(np.asarray, variables["params"]), rng)
    stats = _perturb(jax.tree.map(np.asarray, variables["batch_stats"]), rng)
    patch = rng.normal(0, 1, (1, *crop, 2)).astype(np.float32)
    jout = jax.jit(lambda v, x: jax_upsample(jmodel.apply(v, x, train=False), ori))(
        {"params": params, "batch_stats": stats}, jnp.asarray(patch))
    cfg = EstimatorConfig(ori_size=ori, swin=SwinConfig(crop_size=crop))
    model = build_estimator(cfg, device="cpu")
    model.load_state_dict(estimator_state_dict_from_jax(params, stats, cfg), strict=True)
    with torch.no_grad():
        full = upsample_outputs(model(torch.from_numpy(patch)), ori)
    for key in ("flow_f", "flow_b", "mask_f", "mask_b", "mask_fusion"):
        atol = 1e-3 if key.startswith("flow") else 1e-4
        np.testing.assert_allclose(full[key].numpy(), np.asarray(jout[key]), atol=atol, rtol=0,
                                   err_msg=key)
