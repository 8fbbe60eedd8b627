"""Unconditional denoising UNet (the JAX package's ``models/unet_uncond.py``,
the reference lucidrains ``Unet`` of ``denoising_diffusion_pytorch.py:315-520``),
with the reference's module tree so that its state dict carries the
reference's key names: ``time_mlp.1`` / ``.3`` (``time_mlp.0.weights`` with
the learned or random Fourier embedding), ``downs.{i}.{0..3}`` with
``downs.{i}.3.1`` the pixel-unshuffle's 1x1 conv, ``mid_attn.fn.fn.*``,
``ups.{i}.3.1`` the up-sampling's conv, ``final_res_block``,
``final_conv``.

The blocks are the conditional UNet's (:mod:`dmhomo_torch.models.unet`):
time-only ResnetBlocks (no class embedding), and each stage's
``Residual(PreNorm(LinearAttention))`` folding its pre-LayerNorm into the
linear-attention kernels on the card (``attn_heads`` / ``attn_dim_head`` pick
the tuned kernels at (4, 32), the generic ones elsewhere).  Beside the
conditional UNet it has optional self-conditioning (the input channels
doubled), the pixel-unshuffle downsample and an optional learned or random
Fourier time embedding.  Public tensors are NHWC; the convolutions run NCHW
inside.  ``UncondUNetConfig.dtype`` is the activation dtype; parameters
stay fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dmhomo_torch.models.unet import (
    Attention,
    LinearAttention,
    PreNorm,
    ResnetBlock,
    Residual,
    SinusoidalPosEmb,
    Upsample,
    _conv,
    seeded_weights_,
)


@dataclasses.dataclass(frozen=True)
class UncondUNetConfig:
    dim: int = 64
    dim_mults: Sequence[int] = (1, 2, 4, 8)
    channels: int = 3
    self_condition: bool = False
    resnet_block_groups: int = 8
    learned_sinusoidal: bool = False
    random_fourier: bool = False
    learned_sinusoidal_dim: int = 16
    attn_heads: int = 4
    attn_dim_head: int = 32
    dtype: torch.dtype = torch.float32


class RandomOrLearnedSinusoidalPosEmb(nn.Module):
    """[t, sin(2 pi t w), cos(2 pi t w)] with w (dim // 2,) a learned
    parameter, or frozen (``random``: ``requires_grad=False``)."""

    def __init__(self, dim: int, random: bool = False):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2), requires_grad=not random)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        tf = t.float()[:, None]
        freqs = tf * self.weights[None, :] * 2 * math.pi
        return torch.cat([tf, torch.sin(freqs), torch.cos(freqs)], dim=-1)


class PixelUnshuffleDownsample(nn.Sequential):
    """'b c (h 2) (w 2) -> b (c 4) h w', then a 1x1 conv (reference
    ``Downsample``): the channel index c*4 + 2*dy + dx, as the reference's
    rearrange orders it."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Identity(), nn.Conv2d(dim * 4, dim_out, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        x = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 1, 3, 5, 2, 4)
        return _conv(self[1], x.reshape(B, C * 4, H // 2, W // 2), x.dtype)


class UncondUNet(nn.Module):
    """The unconditional denoiser: x (B, H, W, channels) NHWC, time (B,)
    ints, x_self_cond (B, H, W, channels) or None (zeros) with
    ``self_condition`` -> (B, H, W, channels) fp32."""

    def __init__(self, config: UncondUNetConfig = UncondUNetConfig()):
        super().__init__()
        self.config = cfg = config
        dim, groups = cfg.dim, cfg.resnet_block_groups
        time_dim = 4 * dim
        in_channels = cfg.channels * (2 if cfg.self_condition else 1)
        self.init_conv = nn.Conv2d(in_channels, dim, 7, padding=3)
        if cfg.learned_sinusoidal or cfg.random_fourier:
            pos_emb = RandomOrLearnedSinusoidalPosEmb(cfg.learned_sinusoidal_dim,
                                                      cfg.random_fourier)
            fourier_dim = cfg.learned_sinusoidal_dim + 1
        else:
            pos_emb, fourier_dim = SinusoidalPosEmb(dim), dim
        self.time_mlp = nn.Sequential(pos_emb, nn.Linear(fourier_dim, time_dim), nn.GELU(),
                                      nn.Linear(time_dim, time_dim))

        def lin_attn(d):
            return Residual(PreNorm(d, LinearAttention(d, cfg.attn_heads, cfg.attn_dim_head)))

        dims = [dim] + [dim * m for m in cfg.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_in, time_dim, groups),
                ResnetBlock(d_in, d_in, time_dim, groups),
                lin_attn(d_in),
                nn.Conv2d(d_in, d_out, 3, padding=1) if last else PixelUnshuffleDownsample(
                    d_in, d_out),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, time_dim, groups)
        self.mid_attn = Residual(PreNorm(mid, Attention(mid, cfg.attn_heads, cfg.attn_dim_head)))
        self.mid_block2 = ResnetBlock(mid, mid, time_dim, groups)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out + d_in, d_out, time_dim, groups),
                ResnetBlock(d_out + d_in, d_out, time_dim, groups),
                lin_attn(d_out),
                nn.Conv2d(d_out, d_in, 3, padding=1) if last else Upsample(d_out, d_in),
            ]))
        self.final_res_block = ResnetBlock(2 * dim, dim, time_dim, groups)
        self.final_conv = nn.Conv2d(dim, cfg.channels, 1)

    def forward(self, x: torch.Tensor, time: torch.Tensor,
                x_self_cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        if cfg.self_condition:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = torch.cat([x_self_cond, x], dim=-1)
        t = self.time_mlp(time).to(dt)

        h = _conv(self.init_conv, x.to(dt).permute(0, 3, 1, 2).contiguous(), dt)
        r = h
        skips = []
        for block1, block2, attn, down in self.downs:
            h = block1(h, t)
            skips.append(h)
            h = attn(block2(h, t))
            skips.append(h)
            h = down(h) if isinstance(down, PixelUnshuffleDownsample) else _conv(down, h, dt)
        h = self.mid_block2(self.mid_attn(self.mid_block1(h, t)), t)
        for block1, block2, attn, up in self.ups:
            h = block1(torch.cat([h, skips.pop()], dim=1), t)
            h = attn(block2(torch.cat([h, skips.pop()], dim=1), t))
            h = up(h) if isinstance(up, Upsample) else _conv(up, h, dt)
        h = self.final_res_block(torch.cat([h, r], dim=1), t)
        out = F.conv2d(h.float(), self.final_conv.weight, self.final_conv.bias)
        return out.permute(0, 2, 3, 1)


def build_uncond_unet(config: UncondUNetConfig = UncondUNetConfig(), device=None,
                      generator: Optional[torch.Generator] = None) -> UncondUNet:
    """An UncondUNet on ``device`` (default: the card; raises without one),
    in eval mode, with weights drawn from ``generator`` where given, as
    :func:`~dmhomo_torch.models.unet.build_unet` draws them."""
    from dmhomo_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = UncondUNet(config)
    if generator is not None:
        seeded_weights_(model, generator)
    return model.to(dev).eval()
