"""Beta schedules and the derived diffusion constants (the JAX package's
``diffusion/schedules.py``): computed on the host in float64 with numpy, then
cast to float32 tensors once, as the reference registers its buffers."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear schedule scaled by 1000/T (float64)."""
    scale = 1000.0 / timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, timesteps, dtype=np.float64)


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal), float64, clipped to [0, 0.999]."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """All derived constants, fp32 tensors of shape (T,)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "cosine",
               p2_loss_weight_gamma: float = 0.0, p2_loss_weight_k: float = 1.0,
               device=None) -> "DiffusionSchedule":
        if beta_schedule == "linear":
            betas = linear_beta_schedule(timesteps)
        elif beta_schedule == "cosine":
            betas = cosine_beta_schedule(timesteps)
        else:
            raise ValueError(f"unknown beta schedule {beta_schedule!r}")

        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(np.log(np.clip(posterior_variance, 1e-20, None))),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
            p2_loss_weight=f32(
                (p2_loss_weight_k + alphas_cumprod / (1 - alphas_cumprod)) ** -p2_loss_weight_gamma),
        )


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] reshaped to (B, 1, 1, ...) with ``ndim`` dims in all."""
    out = a[t]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))


def ddim_time_pairs(total_timesteps: int, sampling_timesteps: int) -> np.ndarray:
    """The reference's DDIM time grid, ``torch.linspace(-1, T-1, S+1).int()``
    reversed and paired: a float32 linspace truncated toward zero.  Returns
    (S, 2) int32 rows of (time, time_next); the last time_next is -1."""
    times = np.linspace(-1.0, total_timesteps - 1, sampling_timesteps + 1, dtype=np.float32)
    times = np.trunc(times).astype(np.int32)[::-1]
    return np.stack([times[:-1], times[1:]], axis=1)
