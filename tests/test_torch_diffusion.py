"""The port's diffusion schedule and DDIM sampler against the JAX package's.

* all 13 schedule buffers (cosine and linear) and the DDIM time grid:
  exactly equal (both are float64 numpy cast once to float32);
* a 4-step DDIM chain with injected noise through the tiny UNet, at
  classifier-free guidance 3 (one doubled batch) and 1, fp32: images within
  1e-4 of JAX's (the UNet's fp32 round-off, 1e-5 relative, carried through
  four steps and the x0 clip).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmhomo_torch.diffusion import schedules
from dmhomo_torch.diffusion.gaussian import DiffusionConfig, GaussianDiffusion
from dmhomo_torch.models.unet import UNetConfig, build_unet


@pytest.mark.parametrize("beta_schedule", ["cosine", "linear"])
def test_schedule_buffers_match_jax(beta_schedule):
    from dmhomo_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule

    got = schedules.DiffusionSchedule.create(1000, beta_schedule, p2_loss_weight_gamma=0.5)
    want = JaxSchedule.create(1000, beta_schedule, p2_loss_weight_gamma=0.5)
    fields = [f.name for f in dataclasses.fields(got)]
    assert len(fields) == 13
    for name in fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_ddim_time_pairs_match_jax():
    from dmhomo_tpu.diffusion.schedules import ddim_time_pairs as jax_pairs

    for T, S in ((1000, 32), (1000, 4), (100, 7), (1000, 250)):
        np.testing.assert_array_equal(schedules.ddim_time_pairs(T, S), jax_pairs(T, S))
    assert schedules.ddim_time_pairs(1000, 32)[-1, 1] == -1


@pytest.mark.parametrize("cond_scale", [3.0, 1.0])
def test_ddim_chain_matches_jax(cond_scale):
    from dmhomo_tpu.diffusion import DiffusionConfig as JaxDiffusionConfig
    from dmhomo_tpu.diffusion import GaussianDiffusion as JaxDiffusion
    from dmhomo_tpu.models.import_torch import import_unet_state_dict
    from dmhomo_tpu.models.unet import ConditionalUNet as JaxUNet
    from dmhomo_tpu.models.unet import UNetConfig as JaxUNetConfig
    from dmhomo_tpu.models.unet import make_unet_apply

    S, B, steps = 16, 2, 4
    cfg = UNetConfig(dim=8, dim_mults=(1, 2), num_classes=2)
    model = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    jcfg = JaxUNetConfig(dim=8, dim_mults=(1, 2), num_classes=2)
    params = import_unet_state_dict(model.state_dict(), jcfg, strict=True)
    dcfg = dict(image_size=S, timesteps=1000, sampling_timesteps=steps, objective="pred_x0",
                cond_scale=3.0)

    rng = np.random.default_rng(6)
    classes = np.array([1, 0], np.int32)
    rgb_flow = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    mask = (rng.uniform(size=(B, S, S, 1)) > 0.2).astype(np.float32)
    init = rng.normal(size=(B, S, S, 6)).astype(np.float32)
    step_noise = rng.normal(size=(steps, B, S, S, 6)).astype(np.float32)

    jgd = JaxDiffusion(make_unet_apply(JaxUNet(jcfg)), JaxDiffusionConfig(**dcfg))
    want = np.asarray(jgd.ddim_sample(params, jax.random.PRNGKey(0), jnp.asarray(classes),
                                      jnp.asarray(rgb_flow), jnp.asarray(mask),
                                      cond_scale=cond_scale, fixed_noise=(init, step_noise)))
    gd = GaussianDiffusion(model, DiffusionConfig(**dcfg), device="cpu")
    got = gd.ddim_sample(torch.from_numpy(classes.astype(np.int64)), torch.from_numpy(rgb_flow),
                         torch.from_numpy(mask), cond_scale=cond_scale,
                         fixed_noise=(init, step_noise)).numpy()
    assert got.shape == (B, S, S, 6)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_sample_draws_from_the_generator():
    """``sample`` normalizes rgb_flow and draws from the generator: the same
    seed gives the same images, another seed others."""
    cfg = UNetConfig(dim=8, dim_mults=(1, 2), num_classes=1)
    model = build_unet(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    gd = GaussianDiffusion(model, DiffusionConfig(image_size=8, sampling_timesteps=2),
                           device="cpu")
    args = (torch.zeros(1, dtype=torch.long), torch.rand(1, 8, 8, 3), torch.ones(1, 8, 8, 1))
    a, b, c = (gd.sample(*args, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-3
