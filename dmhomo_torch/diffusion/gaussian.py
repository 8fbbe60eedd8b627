"""Conditional Gaussian diffusion for generation: converters, the
classifier-free-guidance (CFG) model predictions and the DDIM / DDPM
samplers (the JAX package's ``diffusion/gaussian.py``, whose ``lax.scan``
becomes a Python loop here).

The CFG pair (conditional + null class) runs as one doubled-batch UNet
forward.  Layouts are NHWC.  The model is the port's ``ConditionalUNet``,
called as ``model(x, t, classes, rgb_flow, mask, keep_mask)``.  Noise comes
from an explicit ``torch.Generator``, or is injected with ``fixed_noise``
(the parity tests hand both frameworks the same numpy draws).  The
training loss (:meth:`GaussianDiffusion.loss`) draws t, the noise and the
CFG keep-mask from an explicit generator too, or takes them injected.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dmhomo_torch.diffusion.schedules import DiffusionSchedule, ddim_time_pairs, extract
from dmhomo_torch.geometry.warp import warp_by_flow


def normalize_to_neg_one_to_one(x):
    return x * 2.0 - 1.0


def unnormalize_to_zero_to_one(x):
    return (x + 1.0) * 0.5


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    image_size: int = 256
    channels: int = 6
    timesteps: int = 1000
    sampling_timesteps: int = 32
    objective: str = "pred_x0"  # pred_noise | pred_x0 | pred_v
    beta_schedule: str = "cosine"
    loss_type: str = "l1"  # l1 | l2
    ddim_sampling_eta: float = 1.0
    cond_scale: float = 3.0
    cond_drop_prob: float = 0.5
    p2_loss_weight_gamma: float = 0.0
    p2_loss_weight_k: float = 1.0
    photo_loss_weight: float = 1.0

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.timesteps


class GaussianDiffusion:
    """Diffusion wrapper around a conditional denoiser; the schedule lives
    on ``device`` (default: the model's)."""

    def __init__(self, model: torch.nn.Module, config: DiffusionConfig, device=None):
        if device is None:
            device = next(model.parameters()).device
        if config.objective not in ("pred_noise", "pred_x0", "pred_v"):
            raise ValueError(f"unknown objective {config.objective!r}")
        if config.sampling_timesteps > config.timesteps:
            raise ValueError("sampling_timesteps > timesteps")
        self.model = model
        self.config = config
        self.schedule = DiffusionSchedule.create(
            timesteps=config.timesteps, beta_schedule=config.beta_schedule,
            p2_loss_weight_gamma=config.p2_loss_weight_gamma,
            p2_loss_weight_k=config.p2_loss_weight_k, device=device)
        # host fp32 copy for the DDIM step's scalar coefficients
        self._alphas_cumprod = self.schedule.alphas_cumprod.cpu().numpy()

    # -- converters ---------------------------------------------------------

    def predict_start_from_noise(self, x_t, t, noise):
        s, nd = self.schedule, x_t.dim()
        return (extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(s.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        s, nd = self.schedule, x_t.dim()
        return ((extract(s.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
                / extract(s.sqrt_recipm1_alphas_cumprod, t, nd))

    def predict_v(self, x_start, t, noise):
        s, nd = self.schedule, x_start.dim()
        return (extract(s.sqrt_alphas_cumprod, t, nd) * noise
                - extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)

    def predict_start_from_v(self, x_t, t, v):
        s, nd = self.schedule, x_t.dim()
        return (extract(s.sqrt_alphas_cumprod, t, nd) * x_t
                - extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    def q_posterior(self, x_start, x_t, t):
        s, nd = self.schedule, x_t.dim()
        mean = (extract(s.posterior_mean_coef1, t, nd) * x_start
                + extract(s.posterior_mean_coef2, t, nd) * x_t)
        return (mean, extract(s.posterior_variance, t, nd),
                extract(s.posterior_log_variance_clipped, t, nd))

    def q_sample(self, x_start, t, noise):
        s, nd = self.schedule, x_start.dim()
        return (extract(s.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    # -- model wrappers -----------------------------------------------------

    def _forward_with_cond_scale(self, x, t, classes, rgb_flow, mask, cond_scale):
        """``null + (cond - null) * scale`` as ONE forward of the doubled
        batch (conditional half keep_mask True, null half False)."""
        B = x.shape[0]
        if cond_scale == 1.0:
            keep = torch.ones((B,), dtype=torch.bool, device=x.device)
            return self.model(x, t, classes, rgb_flow, mask, keep)
        keep2 = torch.cat([torch.ones((B,), dtype=torch.bool, device=x.device),
                           torch.zeros((B,), dtype=torch.bool, device=x.device)])
        out2 = self.model(*(torch.cat([a, a]) for a in (x, t, classes, rgb_flow, mask)), keep2)
        cond, null = out2[:B], out2[B:]
        return null + (cond - null) * cond_scale

    def model_predictions(self, x, t, classes, rgb_flow, mask, cond_scale=None,
                          clip_x_start=False):
        cfg = self.config
        cond_scale = cfg.cond_scale if cond_scale is None else cond_scale
        model_out = self._forward_with_cond_scale(x, t, classes, rgb_flow, mask, cond_scale)

        def clip(v):
            return v.clamp(-1.0, 1.0) if clip_x_start else v

        if cfg.objective == "pred_noise":
            pred_noise = model_out
            x_start = clip(self.predict_start_from_noise(x, t, pred_noise))
        elif cfg.objective == "pred_x0":
            x_start = clip(model_out)
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        else:
            x_start = clip(self.predict_start_from_v(x, t, model_out))
            pred_noise = self.predict_noise_from_start(x, t, x_start)
        return pred_noise, x_start

    # -- samplers -----------------------------------------------------------

    @torch.inference_mode()
    def ddim_sample(self, classes, rgb_flow, mask, cond_scale=None, clip_denoised: bool = True,
                    generator: Optional[torch.Generator] = None, fixed_noise=None) -> torch.Tensor:
        """DDIM sampling, rgb_flow already in [-1, 1].  ``fixed_noise``
        optionally injects (init (B, S, S, C), per-step (steps, B, S, S, C))
        instead of drawing from ``generator``.  Returns the 6-channel pair
        in [0, 1], NHWC."""
        cfg = self.config
        B, dev = classes.shape[0], rgb_flow.device
        shape = (B, cfg.image_size, cfg.image_size, cfg.channels)
        if fixed_noise is not None:
            img = torch.as_tensor(fixed_noise[0], dtype=torch.float32, device=dev)
            step_noise = torch.as_tensor(fixed_noise[1], dtype=torch.float32, device=dev)
        else:
            img = torch.randn(shape, generator=generator, device=dev)
            step_noise = None
        for i, (time, time_next) in enumerate(ddim_time_pairs(cfg.timesteps,
                                                              cfg.sampling_timesteps)):
            if time_next < 0:
                noise = None
            elif step_noise is not None:
                noise = step_noise[i]
            else:
                noise = torch.randn(shape, generator=generator, device=dev)
            img = self.ddim_step(img, int(time), int(time_next), classes, rgb_flow, mask, noise,
                                 cond_scale, clip_denoised)
        return unnormalize_to_zero_to_one(img)

    def ddim_step(self, img, time: int, time_next: int, classes, rgb_flow, mask, noise,
                  cond_scale=None, clip_denoised: bool = True) -> torch.Tensor:
        """One DDIM update from ``time`` to ``time_next`` (eta from the
        config); the final step (time_next < 0) returns the x0 prediction."""
        t_b = torch.full((img.shape[0],), time, dtype=torch.long, device=img.device)
        pred_noise, x_start = self.model_predictions(img, t_b, classes, rgb_flow, mask,
                                                     cond_scale=cond_scale,
                                                     clip_x_start=clip_denoised)
        if time_next < 0:
            return x_start
        # fp32 scalar coefficients, as the JAX step computes them
        alpha, alpha_next = self._alphas_cumprod[time], self._alphas_cumprod[time_next]
        one, zero = np.float32(1.0), np.float32(0.0)
        sigma = np.float32(self.config.ddim_sampling_eta) * np.sqrt(np.maximum(
            (one - alpha / alpha_next) * (one - alpha_next) / (one - alpha), zero))
        c = np.sqrt(np.maximum(one - alpha_next - sigma * sigma, zero))
        return x_start * float(np.sqrt(alpha_next)) + float(c) * pred_noise + float(sigma) * noise

    @torch.inference_mode()
    def p_sample_loop(self, classes, rgb_flow, mask, cond_scale=None, clip_denoised: bool = True,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Full ancestral DDPM loop over all T steps (the reference's
        conditional DDPM path is broken; this is its intent)."""
        cfg = self.config
        B, dev = classes.shape[0], rgb_flow.device
        shape = (B, cfg.image_size, cfg.image_size, cfg.channels)
        img = torch.randn(shape, generator=generator, device=dev)
        for t in range(cfg.timesteps - 1, -1, -1):
            t_b = torch.full((B,), t, dtype=torch.long, device=dev)
            _, x_start = self.model_predictions(img, t_b, classes, rgb_flow, mask,
                                                cond_scale=cond_scale, clip_x_start=clip_denoised)
            mean, _, log_var = self.q_posterior(x_start, img, t_b)
            noise = torch.randn(shape, generator=generator, device=dev)
            img = mean + (torch.exp(0.5 * log_var) * noise if t > 0 else 0.0)
        return unnormalize_to_zero_to_one(img)

    def sample(self, classes, rgb_flow, mask, cond_scale=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dispatch as the reference ``sample()``: rgb_flow arrives in [0, 1]
        and is normalized here."""
        rgb_flow = normalize_to_neg_one_to_one(rgb_flow)
        fn = self.ddim_sample if self.config.is_ddim_sampling else self.p_sample_loop
        return fn(classes, rgb_flow, mask, cond_scale=cond_scale, generator=generator)

    # -- training loss ------------------------------------------------------

    def _elem_loss(self, a, b):
        if self.config.loss_type == "l1":
            return (a - b).abs()
        return (a - b) ** 2

    def p_losses(self, x_start, t, classes, rgb_flow, flow, mask, noise, keep_mask):
        """The reference's ``p_losses``: the objective's L1 (or L2) on the
        model output, plus ``alphas_cumprod[t]`` times the masked
        photometric loss of ``warp_by_flow(im2, flow, 'border')`` against
        im1.  NHWC; x_start and rgb_flow in [-1, 1]; a 0-d fp32 tensor."""
        cfg = self.config
        B = x_start.shape[0]
        x = self.q_sample(x_start, t, noise)
        model_out = self.model(x, t, classes, rgb_flow, mask, keep_mask).float()
        im1, im2 = model_out[..., :3], model_out[..., 3:]
        im2_warp = warp_by_flow(im2, flow, mode="border")
        if cfg.objective == "pred_noise":
            target = noise
        elif cfg.objective == "pred_x0":
            target = x_start
        else:
            target = self.predict_v(x_start, t, noise)
        loss = self._elem_loss(model_out, target).reshape(B, -1).mean(dim=1)
        photo = (mask * self._elem_loss(im2_warp, im1)).reshape(B, -1).mean(dim=1)
        photo_w = self.schedule.alphas_cumprod[t]
        return loss.mean() + (cfg.photo_loss_weight * photo_w * photo).mean()

    def draw(self, batch: int, image_size: int, generator: Optional[torch.Generator] = None,
             device=None):
        """(t (B,) int64 in [0, T), noise (B, S, S, channels), keep_mask (B,)
        bool, True with probability 1 - cond_drop_prob), from ``generator``."""
        cfg = self.config
        t = torch.randint(0, cfg.timesteps, (batch,), generator=generator, device=device)
        noise = torch.randn((batch, image_size, image_size, cfg.channels), generator=generator,
                            device=device)
        keep = torch.rand((batch,), generator=generator, device=device) < 1.0 - cfg.cond_drop_prob
        return t, noise, keep

    def loss(self, batch_img, classes, generator: Optional[torch.Generator] = None,
             draws=None):
        """The training loss on a (B, S, S, 12) condition batch in [0, 1]:
        img1 (3) img2 (3) mask (1) rgb_flow (3) flow (2).  ``draws`` injects
        (t, noise, keep_mask); otherwise they come from ``generator``."""
        B, S = batch_img.shape[0], batch_img.shape[1]
        dev = batch_img.device
        t, noise, keep = draws if draws is not None else self.draw(B, S, generator, dev)
        t = torch.as_tensor(t, dtype=torch.long, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
        keep = torch.as_tensor(keep, dtype=torch.bool, device=dev)
        data = normalize_to_neg_one_to_one(batch_img[..., :6])
        mask = batch_img[..., 6:7]
        rgb_flow = normalize_to_neg_one_to_one(batch_img[..., 7:10])
        flow = batch_img[..., 10:12]
        return self.p_losses(data, t, classes, rgb_flow, flow, mask, noise, keep)
