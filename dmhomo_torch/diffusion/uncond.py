"""Unconditional Gaussian diffusion (the JAX package's ``diffusion/uncond.py``,
the reference lucidrains ``GaussianDiffusion`` of
``denoising_diffusion_pytorch.py:453-817``): the conditional class's
schedule, plus self-conditioning (with probability 0.5 a stop-gradient x0
estimate feeds the model's second input), p2 loss reweighting and plain
DDIM / DDPM sampling without CFG.

The model is the port's ``UncondUNet``, called as ``model(x, t,
x_self_cond)``; layouts are NHWC.  The JAX ``lax.scan`` samplers become
Python loops over one-step functions (:meth:`UnconditionalGaussianDiffusion.ddim_step`,
:meth:`~UnconditionalGaussianDiffusion.ddpm_step`) that take their noise
explicitly; :meth:`~UnconditionalGaussianDiffusion.sample` draws it from an
explicit ``torch.Generator``.  The loss likewise is :meth:`p_losses` on
explicit draws (t, noise, the self-condition coin), which :meth:`loss`
draws from a generator; the coin stays on the device (``torch.where``, no
host sync).  The parity tests inject the JAX draws into both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dmhomo_torch.diffusion.gaussian import normalize_to_neg_one_to_one, unnormalize_to_zero_to_one
from dmhomo_torch.diffusion.schedules import DiffusionSchedule, ddim_time_pairs, extract


@dataclasses.dataclass(frozen=True)
class UncondDiffusionConfig:
    image_size: int = 128
    channels: int = 3
    timesteps: int = 1000
    sampling_timesteps: int = 250
    objective: str = "pred_noise"  # pred_noise | pred_x0 | pred_v
    beta_schedule: str = "cosine"
    loss_type: str = "l1"  # l1 | l2
    ddim_sampling_eta: float = 1.0
    self_condition: bool = False
    self_condition_prob: float = 0.5
    p2_loss_weight_gamma: float = 0.0
    p2_loss_weight_k: float = 1.0

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.timesteps


class UnconditionalGaussianDiffusion:
    """Diffusion around an unconditional denoiser; the schedule lives on
    ``device`` (default: the model's)."""

    def __init__(self, model: torch.nn.Module, config: UncondDiffusionConfig, device=None):
        if config.objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {config.objective!r}")
        if config.loss_type not in ("l1", "l2"):
            raise ValueError(f"unknown loss type {config.loss_type!r}")
        if device is None:
            device = next(model.parameters()).device
        self.model = model
        self.config = config
        self.schedule = DiffusionSchedule.create(
            timesteps=config.timesteps, beta_schedule=config.beta_schedule,
            p2_loss_weight_gamma=config.p2_loss_weight_gamma,
            p2_loss_weight_k=config.p2_loss_weight_k, device=device)
        # host fp32 copy for the DDIM step's scalar coefficients
        self._alphas_cumprod = self.schedule.alphas_cumprod.cpu().numpy()

    def q_sample(self, x_start, t, noise):
        s, nd = self.schedule, x_start.dim()
        return (extract(s.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def _pred_x0_and_noise(self, x, t, x_self_cond, clip: bool = True):
        """(x0, noise) from one model call under the config's objective,
        x0 clipped to [-1, 1] with ``clip``."""
        s, nd = self.schedule, x.dim()
        out = self.model(x, t, x_self_cond)
        objective = self.config.objective
        if objective == "pred_noise":
            noise = out
            x0 = (extract(s.sqrt_recip_alphas_cumprod, t, nd) * x
                  - extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * noise)
            return (x0.clamp(-1.0, 1.0) if clip else x0), noise
        if objective == "pred_x0":
            x0 = out.clamp(-1.0, 1.0) if clip else out
        else:  # pred_v
            x0 = (extract(s.sqrt_alphas_cumprod, t, nd) * x
                  - extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * out)
            if clip:
                x0 = x0.clamp(-1.0, 1.0)
        noise = ((extract(s.sqrt_recip_alphas_cumprod, t, nd) * x - x0)
                 / extract(s.sqrt_recipm1_alphas_cumprod, t, nd))
        return x0, noise

    def _self_cond(self, x_sc):
        return x_sc if self.config.self_condition else None

    # -- samplers -----------------------------------------------------------

    def ddim_step(self, img, x_sc, time: int, time_next: int, noise):
        """One DDIM update from ``time`` to ``time_next`` (eta from the
        config) with its noise; x_sc is the previous step's x0 (zeros at
        first), read under ``self_condition``.  Returns (img, x0); the
        final step (time_next < 0) returns x0 as the image."""
        t_b = torch.full((img.shape[0],), time, dtype=torch.long, device=img.device)
        x0, pred_noise = self._pred_x0_and_noise(img, t_b, self._self_cond(x_sc))
        if time_next < 0:
            return x0, x0
        # fp32 scalar coefficients, as the JAX step computes them
        alpha, alpha_next = self._alphas_cumprod[time], self._alphas_cumprod[time_next]
        one, zero = np.float32(1.0), np.float32(0.0)
        sigma = np.float32(self.config.ddim_sampling_eta) * np.sqrt(np.maximum(
            (one - alpha / alpha_next) * (one - alpha_next) / (one - alpha), zero))
        c = np.sqrt(np.maximum(one - alpha_next - sigma * sigma, zero))
        nxt = x0 * float(np.sqrt(alpha_next)) + float(c) * pred_noise + float(sigma) * noise
        return nxt, x0

    def ddpm_step(self, img, x_sc, t: int, noise):
        """One ancestral DDPM step at t with its noise (unused at t = 0).
        Returns (img, x0)."""
        t_b = torch.full((img.shape[0],), t, dtype=torch.long, device=img.device)
        x0, _ = self._pred_x0_and_noise(img, t_b, self._self_cond(x_sc))
        s, nd = self.schedule, img.dim()
        mean = (extract(s.posterior_mean_coef1, t_b, nd) * x0
                + extract(s.posterior_mean_coef2, t_b, nd) * img)
        if t == 0:
            return mean + 0.0, x0
        log_var = extract(s.posterior_log_variance_clipped, t_b, nd)
        return mean + torch.exp(0.5 * log_var) * noise, x0

    @torch.inference_mode()
    def sample(self, batch: int, generator: Optional[torch.Generator] = None,
               fixed_noise=None) -> torch.Tensor:
        """``batch`` images in [0, 1], NHWC: DDIM when sampling_timesteps <
        timesteps, else DDPM over every step.  The noise comes from
        ``generator``, or ``fixed_noise`` injects (init (B, S, S, C),
        per-step (steps, B, S, S, C))."""
        cfg = self.config
        dev = self.schedule.betas.device
        shape = (batch, cfg.image_size, cfg.image_size, cfg.channels)
        if fixed_noise is not None:
            img = torch.as_tensor(fixed_noise[0], dtype=torch.float32, device=dev)
            steps = torch.as_tensor(fixed_noise[1], dtype=torch.float32, device=dev)
        else:
            img = torch.randn(shape, generator=generator, device=dev)
            steps = None

        def noise(i):
            if steps is not None:
                return steps[i]
            return torch.randn(shape, generator=generator, device=dev)

        x_sc = torch.zeros(shape, device=dev)
        if cfg.is_ddim_sampling:
            pairs = ddim_time_pairs(cfg.timesteps, cfg.sampling_timesteps)
            for i, (time, time_next) in enumerate(pairs):
                z = noise(i) if time_next >= 0 else None
                img, x_sc = self.ddim_step(img, x_sc, int(time), int(time_next), z)
        else:
            for i, t in enumerate(range(cfg.timesteps - 1, -1, -1)):
                z = noise(i) if t > 0 else None
                img, x_sc = self.ddpm_step(img, x_sc, t, z)
        return unnormalize_to_zero_to_one(img)

    # -- training loss ------------------------------------------------------

    def p_losses(self, x_start, t, noise, use_self_cond=None) -> torch.Tensor:
        """The per-sample L1 (or L2) of the objective, weighted by
        ``p2_loss_weight[t]``, averaged: a 0-d fp32 tensor.  x_start in
        [-1, 1], NHWC; ``use_self_cond`` a 0-d bool tensor (the coin), read
        under ``self_condition``: where set, a stop-gradient x0 estimate
        (one model call on zeros, unclipped) feeds the model's second
        input, else zeros."""
        cfg = self.config
        B = x_start.shape[0]
        x = self.q_sample(x_start, t, noise)
        x_self_cond = None
        if cfg.self_condition:
            with torch.no_grad():
                x0_est, _ = self._pred_x0_and_noise(x, t, torch.zeros_like(x), clip=False)
            x_self_cond = torch.where(use_self_cond, x0_est, torch.zeros_like(x))
        out = self.model(x, t, x_self_cond)
        if cfg.objective == "pred_noise":
            target = noise
        elif cfg.objective == "pred_x0":
            target = x_start
        else:
            s, nd = self.schedule, x_start.dim()
            target = (extract(s.sqrt_alphas_cumprod, t, nd) * noise
                      - extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)
        per = (out - target).abs() if cfg.loss_type == "l1" else (out - target) ** 2
        per = per.reshape(B, -1).mean(dim=1) * self.schedule.p2_loss_weight[t]
        return per.mean()

    def draw(self, shape, generator: Optional[torch.Generator] = None, device=None):
        """(t (B,) int64 in [0, T), noise of the images' ``shape`` (B, S, S,
        C), the self-condition coin: a 0-d bool tensor, True with
        ``self_condition_prob``), from ``generator``, on ``device``."""
        cfg = self.config
        t = torch.randint(0, cfg.timesteps, (shape[0],), generator=generator, device=device)
        noise = torch.randn(tuple(shape), generator=generator, device=device)
        coin = torch.rand((), generator=generator, device=device) < cfg.self_condition_prob
        return t, noise, coin

    def loss(self, img01, generator: Optional[torch.Generator] = None, draws=None):
        """The training loss on (B, S, S, C) images in [0, 1].  ``draws``
        injects (t, noise, coin); otherwise they come from ``generator``."""
        dev = img01.device
        t, noise, coin = draws if draws is not None else self.draw(img01.shape, generator, dev)
        t = torch.as_tensor(t, dtype=torch.long, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        coin = torch.as_tensor(coin, dtype=torch.bool, device=dev)
        return self.p_losses(normalize_to_neg_one_to_one(img01), t, noise, coin)
