"""The port's BasesHomo family against the JAX package's, on the CPU.

JAX ``BasesHomoNet`` at crop 64x96 is initialised from a seed, its
variables carried over with ``baseshomo_state_dict_from_jax`` and loaded
``strict=True``; both run the same numpy inputs, in eval mode.

At random init V^T V of the untrained basis maps is ill-conditioned (about
1e10 after layer 3 here), so a full forward diverges chaotically through
layer 4 (the JAX package's own
``tests/test_extras.py::test_baseshomo_import_forward_parity`` says so), and
at 64x96 layer 4 leaves 2x3 positions for 16 maps, so V^T V is singular
there.  So, as there: the shared feature extractor and the stem with
layers 1-3 end to end (fp32, 1e-4 of the largest activation: summation
order over 13 blocks), then layer 4, conv_last and each Subspace stage in
isolation on random inputs; each Subspace difference is reported beside
cond(V^T V) and held to 1e-4 where the condition is below 1e4, and the
projection itself against a float64 projection.  The whole forward is
checked for its contract only (shapes, H mapping the corners onto corners
+ offsets).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_tpu.models import baseshomo as jb
from dmhomo_tpu.models.import_torch import import_baseshomo_state_dict

from dmhomo_torch.geometry.homography import apply_homography
from dmhomo_torch.models import baseshomo as tb
from dmhomo_torch.models.convert import (
    BASESHOMO_DEAD_KEYS,
    baseshomo_state_dict_from_jax,
    load_baseshomo_state_dict,
)

from reference_oracle import make_reference_baseshomo, reference_available

CROP = (64, 96)
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one torch thread is faster than many, and the suite
    runs test files side by side in worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _perturb_stats(tree, rng):
    """BatchNorm statistics of a trained-looking net (the init's 0 / 1 would
    hide a swapped mean and variance)."""
    return jax.tree.map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, np.shape(v)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def nets():
    cfg = jb.BasesHomoConfig(crop_size=CROP)
    model = jb.BasesHomoNet(cfg)
    variables = model.init(jax.random.PRNGKey(3), jnp.zeros((1, *CROP, 2)), train=False)
    rng = np.random.default_rng(3)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _perturb_stats(variables["batch_stats"], rng)
    port = tb.BasesHomoNet(tb.BasesHomoConfig(crop_size=CROP)).eval()
    port.load_state_dict(baseshomo_state_dict_from_jax(params, stats), strict=True)
    return cfg, params, stats, port


def test_state_dict_round_trip(nets):
    """The JAX importer takes the port's state dict (reference key names)
    strictly, every key accounted for, and gives back the JAX variables."""
    _, params, stats, port = nets
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    p2, s2 = import_baseshomo_state_dict(sd, jb.BasesHomoConfig(crop_size=CROP), strict=True)
    for a, b in ((params, p2), (stats, s2)):
        la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (_, x), (_, y) in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_reference_format_loads_strict(nets):
    """A reference-format state dict (``module.`` prefix, the dead
    ``subspace_block`` and ``basis`` keys) loads ``strict=True``."""
    _, _, _, port = nets
    sd = {f"module.{k}": v.clone() for k, v in port.state_dict().items()}
    sd["module.subspace_block.conv0.weight"] = torch.zeros(16, 256, 1, 1)
    sd["module.basis"] = torch.zeros(1, 8, CROP[0] * CROP[1])
    assert BASESHOMO_DEAD_KEYS
    fresh = tb.BasesHomoNet(tb.BasesHomoConfig(crop_size=CROP))
    load_baseshomo_state_dict(fresh, sd)
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(RuntimeError):
        sd.pop("module.conv_last.weight")
        load_baseshomo_state_dict(fresh, sd)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_reference_net_loads_strict():
    ref = make_reference_baseshomo(crop_size=CROP)
    load_baseshomo_state_dict(tb.BasesHomoNet(tb.BasesHomoConfig(crop_size=CROP)),
                              ref.state_dict())


def test_subspace_project_against_jax_and_float64(rng):
    """The projection (well-conditioned random maps) against the JAX
    function (fp32, HIGHEST) and against a float64 projection."""
    x = rng.normal(0, 1, (2, 8, 12, 6)).astype(np.float32)
    v = rng.normal(0, 1, (2, 8, 12, 4)).astype(np.float32)
    got = tb.subspace_project(torch.from_numpy(x), torch.from_numpy(v)).numpy()
    want = np.asarray(jb.subspace_project(jnp.asarray(x), jnp.asarray(v)))
    cond = tb.vtv_condition(torch.from_numpy(v).permute(0, 3, 1, 2))
    assert float(cond.max()) < 1e3
    np.testing.assert_allclose(got, want, atol=1e-5)
    exact = tb.subspace_project(torch.from_numpy(x).double(), torch.from_numpy(v).double())
    np.testing.assert_allclose(got, exact.numpy(), atol=1e-5)


def _jax_stage(params, stats, name, module, x):
    return np.asarray(module.apply({"params": params[name], "batch_stats": stats[name]},
                                   jnp.asarray(x), train=False))


def test_stem_and_layers_1_to_3(nets, rng):
    """ShareFeature on both images, then the stem and layers 1-3 end to end."""
    import flax.linen as nn

    _, params, stats, port = nets
    patch = rng.normal(0, 0.5, (2, *CROP, 2)).astype(np.float32)
    f1 = _jax_stage(params, stats, "share_feature", jb.ShareFeature(), patch[..., :1])
    f2 = _jax_stage(params, stats, "share_feature", jb.ShareFeature(), patch[..., 1:])
    xj = jnp.concatenate([f1, f2], -1)
    xj = nn.Conv(64, (7, 7), strides=(2, 2), padding=3, use_bias=False).apply(
        {"params": params["conv1"]}, xj)
    xj = nn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": params["bn1"], "batch_stats": stats["bn1"]}, xj)
    xj = nn.max_pool(nn.leaky_relu(xj, 0.01), (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
    for layer, planes, n in ((1, 64, 3), (2, 128, 4), (3, 256, 6)):
        for bi in range(n):
            name = f"layer{layer}_block{bi}"
            xj = _jax_stage(params, stats, name,
                            jb.BasicBlock(planes, 2 if bi == 0 and layer > 1 else 1), xj)
    t = torch.from_numpy(patch).permute(0, 3, 1, 2)
    with torch.no_grad():
        t1, t2 = port.share_feature(t[:, :1]), port.share_feature(t[:, 1:])
        np.testing.assert_allclose(_nhwc(t1), np.asarray(f1), atol=1e-5)
        np.testing.assert_allclose(_nhwc(t2), np.asarray(f2), atol=1e-5)
        l3 = port.layer3(port.layer2(port.layer1(port.stem(torch.cat([t1, t2], 1)))))
    err = np.abs(_nhwc(l3) - np.asarray(xj)).max()
    assert err < ATOL * max(1.0, float(np.abs(xj).max())), err


def test_layer4_and_conv_last(nets, rng):
    _, params, stats, port = nets
    z = rng.normal(0, 0.5, (2, 8, 12, 256)).astype(np.float32)
    zj = z
    for bi in range(3):
        zj = _jax_stage(params, stats, f"layer4_block{bi}", jb.BasicBlock(512, 2 if bi == 0 else 1),
                        zj)
    import flax.linen as nn

    cj = nn.Conv(8, (1, 1), use_bias=False, feature_group_count=8).apply(
        {"params": params["conv_last"]}, jnp.asarray(zj))
    with torch.no_grad():
        l4 = port.layer4(torch.from_numpy(z).permute(0, 3, 1, 2))
        cl = port.conv_last(l4)
    np.testing.assert_allclose(_nhwc(l4), zj, atol=ATOL)
    np.testing.assert_allclose(_nhwc(cl), np.asarray(cj), atol=ATOL)


@pytest.mark.parametrize("name, C", [("sp_layer3", 256), ("sp_layer4", 512)])
def test_subspace_stages(nets, rng, name, C):
    """Each Subspace stage on its own: the basis block's maps, then the
    projection; the difference reported with cond(V^T V)."""
    _, params, stats, port = nets
    w = rng.normal(0, 0.2, (1, 8, 12, C)).astype(np.float32)
    block = jb.SubspaceBlock(16)
    vj = np.asarray(block.apply({"params": params[name]["block"],
                                 "batch_stats": stats[name]["block"]}, jnp.asarray(w),
                                train=False))
    sj = _jax_stage(params, stats, name, jb.Subspace(16), w)
    stage = getattr(port, name)
    with torch.no_grad():
        t = torch.from_numpy(w).permute(0, 3, 1, 2)
        v = stage.Block(t)
        s = stage(t)
    np.testing.assert_allclose(_nhwc(v), vj, atol=1e-5)
    cond = float(tb.vtv_condition(v).max())
    err = float(np.abs(_nhwc(s) - sj).max())
    print(f"{name}: cond(V^T V) {cond:.3g}, max abs difference {err:.3g}")
    if cond < 1e4:
        assert err < ATOL, (err, cond)
    # the port against a float64 projection of its own basis maps
    exact = tb.subspace_project_nchw(t.double(), v.double())
    assert float((s.double() - exact).abs().max()) < 1e-7 * cond * float(t.abs().max()) + 1e-5


def test_forward_contract(nets, rng):
    """The whole forward: shapes, H[2, 2] = 1, and H maps the corners onto
    corners + offsets, as the JAX test checks its own."""
    _, _, _, port = nets
    x = torch.from_numpy(rng.normal(0, 1, (2, *CROP, 2)).astype(np.float32))
    with torch.no_grad():
        out = port(x)
    assert out["homo_f"].shape == (2, 3, 3) and out["offset_b"].shape == (2, 8)
    corners = torch.tensor([[0, 0], [95, 0], [0, 63], [95, 63]], dtype=torch.float32)
    for d in ("f", "b"):
        H = out[f"homo_{d}"]
        torch.testing.assert_close(H[:, 2, 2], torch.ones(2))
        mapped = apply_homography(H, corners.expand(2, 4, 2))
        torch.testing.assert_close(mapped, corners + out[f"offset_{d}"].reshape(2, 4, 2),
                                   atol=1e-2, rtol=0)


def test_train_mode_keeps_the_passes_apart(rng):
    """In training mode each trunk pass updates the BatchNorm statistics
    with its own batch: two updates per forward, as the JAX module makes."""
    port = tb.BasesHomoNet(tb.BasesHomoConfig(crop_size=CROP, layers=(1, 1, 1, 1))).train()
    x = torch.from_numpy(rng.normal(0, 1, (2, *CROP, 2)).astype(np.float32))
    port(x)
    assert int(port.bn1.num_batches_tracked) == 2
    assert int(port.share_feature.layers[1].num_batches_tracked) == 2


def test_fetch_model_dispatch():
    assert type(tb.fetch_model("BasesHomo", device="cpu")).__name__ == "BasesHomoNet"
    assert type(tb.fetch_model("HomoGAN", device="cpu")).__name__ == "HomographyEstimator"
    with pytest.raises(NotImplementedError):
        tb.fetch_model("nope", device="cpu")
