"""The port's DGM UNet against the JAX package's ``ConditionalUNet``.

A tiny config (dim 8, mults (1, 2), 16x16, 2 classes) with every part of
the shipped architecture; a mixed keep_mask takes the null class for half
the batch.  Weights go both ways: the port's state dict through the JAX
importer (``import_unet_state_dict(..., strict=True)``), and a JAX init
through ``unet_state_dict_from_jax``.  Tolerances, relative to the largest
output: fp32 1e-5 (summation order; the port's nearest-up then conv3x3 is
the JAX package's fused dilated conv, rounded elsewhere); bf16 3e-2 (the
two frameworks round the activations after different ops, through ~30
layers).  ``UNetConfig.remat`` (every ResnetBlock and pre-norm attention
recomputed in the backward) gives the gradients of remat off, within 1e-6
of each tensor's largest value (the sum order of shared inputs' gradients),
in fp32 and in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_torch.models.convert import unet_state_dict_from_jax
from dmhomo_torch.models.unet import ConditionalUNet, UNetConfig, build_unet

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _configs(dtype):
    from dmhomo_tpu.models.unet import UNetConfig as JaxUNetConfig

    kw = dict(dim=8, dim_mults=(1, 2), num_classes=2)
    return (UNetConfig(**kw, dtype=getattr(torch, dtype)),
            JaxUNetConfig(**kw, dtype=getattr(jnp, dtype)))


def _inputs(seed=0, B=4, S=16):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(B, S, S, 6)).astype(np.float32),
        time=np.array([0, 100, 500, 999][:B], np.int32),
        classes=np.array([0, 1, 1, 0][:B], np.int32),
        rgb_flow=rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
        mask=(rng.uniform(size=(B, S, S, 1)) > 0.3).astype(np.float32),
        keep_mask=np.array([True, False, True, False][:B]))


def _jax_forward(jcfg, params, inp):
    from dmhomo_tpu.models.unet import ConditionalUNet as JaxUNet

    out = JaxUNet(jcfg).apply({"params": params}, *(jnp.asarray(v) for v in inp.values()))
    return np.asarray(out, np.float32)


def _port_forward(model, inp):
    args = [torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for v in inp.values()]
    with torch.inference_mode():
        return model(*args).float().numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_weights_through_the_jax_importer(dtype):
    from dmhomo_tpu.models.import_torch import import_unet_state_dict

    cfg, jcfg = _configs(dtype)
    model = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    params = import_unet_state_dict(model.state_dict(), jcfg, strict=True)
    inp = _inputs()
    got = _port_forward(model, inp)
    want = _jax_forward(jcfg, params, inp)
    assert got.shape == (4, 16, 16, 6) and got.dtype == np.float32
    assert _rel(got, want) <= TOL[dtype]


def test_jax_weights_through_the_converter():
    cfg, jcfg = _configs("float32")
    from dmhomo_tpu.models.unet import ConditionalUNet as JaxUNet

    inp = _inputs(1)
    params = JaxUNet(jcfg).init(jax.random.PRNGKey(3), *(jnp.asarray(v) for v in inp.values()))
    params = jax.tree.map(np.asarray, params["params"])
    model = ConditionalUNet(cfg)
    model.load_state_dict(unet_state_dict_from_jax(params, cfg), strict=True)
    assert _rel(_port_forward(model.eval(), inp), _jax_forward(jcfg, params, inp)) <= TOL["float32"]


def test_state_dict_round_trip_is_exact():
    from dmhomo_tpu.models.import_torch import import_unet_state_dict

    cfg, jcfg = _configs("float32")
    sd = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(2)).state_dict()
    back = unet_state_dict_from_jax(import_unet_state_dict(sd, jcfg, strict=True), cfg)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_null_class_and_keep_mask():
    """keep_mask False takes the learned null embedding, per sample."""
    cfg, _ = _configs("float32")
    model = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    inp = _inputs(2)
    both = _port_forward(model, inp)
    for keep in (True, False):
        one = _port_forward(model, dict(inp, keep_mask=np.full(4, keep)))
        rows = inp["keep_mask"] == keep
        np.testing.assert_allclose(both[rows], one[rows], rtol=0, atol=1e-5)
    assert np.abs(both - _port_forward(model, dict(inp, keep_mask=np.full(4, True)))).max() > 1e-4


def test_full_config_parameter_count():
    """The shipped architecture (dim 64, mults 1-2-4-8, 9 -> 6 channels, 5
    classes) has the reference UNet's 38,417,990 parameters."""
    model = ConditionalUNet(dataclasses.replace(UNetConfig(), num_classes=5))
    assert sum(p.numel() for p in model.parameters()) == 38_417_990


@pytest.mark.slow
def test_full_width_unet_matches_jax():
    """The shipped widths (dim 64, mults 1-2-4-8, 1 class) at 64x64, fp32,
    through the JAX importer: within 1e-5 of the largest output."""
    from dmhomo_tpu.models.import_torch import import_unet_state_dict
    from dmhomo_tpu.models.unet import UNetConfig as JaxUNetConfig

    model = build_unet(UNetConfig(num_classes=1), device="cpu",
                       generator=torch.Generator().manual_seed(8))
    jcfg = JaxUNetConfig(num_classes=1)
    params = import_unet_state_dict(model.state_dict(), jcfg, strict=True)
    inp = dict(_inputs(3, B=2, S=64), classes=np.zeros(2, np.int32))
    assert _rel(_port_forward(model, inp), _jax_forward(jcfg, params, inp)) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gives_the_same_gradients(dtype):
    cfg, _ = _configs(dtype)
    inp = _inputs(5)
    args = [torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32 else v)
            for v in inp.values()]
    target = torch.from_numpy(np.random.default_rng(6).normal(size=(4, 16, 16, 6))
                              .astype(np.float32))
    grads, losses = [], []
    for remat in (False, True):
        model = build_unet(dataclasses.replace(cfg, remat=remat), device="cpu",
                           generator=torch.Generator().manual_seed(5)).train()
        loss = (model(*args) - target).abs().mean()
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert losses[0] == losses[1]
    assert grads[0].keys() == grads[1].keys()
    for n, g in grads[0].items():
        tol = 1e-6 * max(float(g.abs().max()), 1e-30)
        assert float((grads[1][n] - g).abs().max()) <= tol, n
