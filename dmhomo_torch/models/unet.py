"""Conditional denoising UNet, the DGM backbone (the JAX package's
``models/unet.py``), with the reference ``Unet``'s module tree so that its
state dict carries the reference's key names (``downs.{i}.{0..3}``,
``mid_attn.fn.fn.to_qkv``, ``ups.{i}.3.1``, ``time_mlp.1/3``,
``classes_mlp.0/2``, ...).

Public tensors are NHWC as in the JAX package; the convolutions run NCHW
inside.  ``UNetConfig.dtype`` is the activation dtype (bf16 for generation)
while parameters stay fp32: weights are cast at each use, as the JAX
modules' ``dtype`` does.  Weight standardization, GroupNorm, the channel
LayerNorms, the time / class MLPs and ``final_conv`` run in fp32.  Each
stage's ``LinearAttention`` folds its pre-LayerNorm into the qkv
projection of :func:`dmhomo_torch.ops.linear_attention.linear_attention`
(the CUDA kernels on the card); the bottleneck's full ``Attention`` is plain
PyTorch.  The up-sampling is nearest x2 then a 3x3 conv (the JAX package
fuses the two into one dilated conv: the same function, rounded elsewhere).
``UNetConfig.remat`` recomputes every ``ResnetBlock`` and every pre-norm
residual attention in the backward (``torch.utils.checkpoint``), where the
JAX package wraps the same modules in ``nn.remat``; the state dict is the
same either way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dmhomo_torch.ops.linear_attention import linear_attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    dim: int = 64
    num_classes: int = 5
    dim_mults: Sequence[int] = (1, 2, 4, 8)
    channels: int = 6
    cond_channels: int = 3
    resnet_block_groups: int = 8
    attn_heads: int = 4
    attn_dim_head: int = 32
    dtype: torch.dtype = torch.float32
    remat: bool = False  # recompute each ResnetBlock and attention in the backward


def _conv(conv: nn.Conv2d, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``conv`` with input, weight and bias in the activation dtype."""
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(x.to(dt), conv.weight.to(dt), bias, conv.stride, conv.padding)


class WeightStandardizedConv(nn.Conv2d):
    """Conv2d whose kernel is standardized per output channel in fp32
    (biased variance, eps 1e-5) before the cast to the activation dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mean) * torch.rsqrt(var + 1e-5)
        dt = x.dtype
        return F.conv2d(x, w.to(dt), self.bias.to(dt), self.stride, self.padding)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channels of each position, gain only, in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = xf.var(dim=1, unbiased=False, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + 1e-5) * self.g).to(dt)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                          * -(math.log(10000.0) / (half - 1)))
        args = t.float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Block(nn.Module):
    """WSConv3x3 -> GroupNorm (fp32) -> scale-shift -> SiLU."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.proj = WeightStandardizedConv(dim, dim_out, 3, padding=1)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)

    def forward(self, x, scale_shift=None):
        dt = x.dtype
        x = self.norm(self.proj(x).float())
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1.0) + shift
        return F.silu(x).to(dt)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, cond_dim: int, groups: int = 8):
        super().__init__()
        self.mlp = nn.Sequential(nn.SiLU(), nn.Linear(cond_dim, dim_out * 2))
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x, cond):
        dt = x.dtype
        lin = self.mlp[1]
        h = F.linear(F.silu(cond), lin.weight.to(dt), lin.bias.to(dt))
        scale_shift = h[:, :, None, None].chunk(2, dim=1)
        h = self.block2(self.block1(x, scale_shift))
        res = x if isinstance(self.res_conv, nn.Identity) else _conv(self.res_conv, x, dt)
        return h + res


class LinearAttention(nn.Module):
    """softmax(q over d) . (softmax(k over tokens) v^T), heads x dim_head,
    through the linear-attention kernels with the pre-LayerNorm folded in."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1), ChannelLayerNorm(dim))

    def forward(self, x: torch.Tensor, norm_gain: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        dt = x.dtype
        w_qkv = self.to_qkv.weight.reshape(-1, C).t().contiguous()  # (C, 3*hidden)
        tokens = x.reshape(B, C, H * W).transpose(1, 2)  # (B, N, C), token stride 1
        out = linear_attention(tokens, w_qkv, self.heads, self.dim_head,
                               prenorm=(norm_gain.reshape(-1),))
        out = out.transpose(1, 2).reshape(B, -1, H, W)
        return self.to_out[1](_conv(self.to_out[0], out, dt), dt)


class Attention(nn.Module):
    """Full softmax attention over all H*W tokens (bottleneck only), plain
    PyTorch: q scaled in the activation dtype, softmax in fp32."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        dt = x.dtype
        qkv = _conv(self.to_qkv, x, dt).reshape(B, 3, self.heads, self.dim_head, H * W)
        q, k, v = qkv.unbind(1)  # (B, heads, d, N)
        q = q * torch.tensor(self.dim_head**-0.5, dtype=dt)
        sim = torch.einsum("bhdi,bhdj->bhij", q, k)
        attn = torch.softmax(sim.float(), dim=-1).to(dt)
        out = torch.einsum("bhij,bhdj->bhdi", attn, v).reshape(B, -1, H, W)
        return _conv(self.to_out, out, dt)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = ChannelLayerNorm(dim)
        self.fn = fn


class Residual(nn.Module):
    """``x + fn(norm(x))``; for LinearAttention the norm's statistics are
    folded into its projection and the normalized tensor is never made."""

    def __init__(self, fn: PreNorm):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inner, norm = self.fn.fn, self.fn.norm
        if isinstance(inner, LinearAttention):
            return inner(x, norm.g) + x
        return inner(norm(x, x.dtype)) + x


class Upsample(nn.Sequential):
    """Nearest x2, then a 3x3 conv (reference ``Upsample``)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__(nn.Upsample(scale_factor=2, mode="nearest"),
                         nn.Conv2d(dim, dim_out, 3, padding=1))

    def forward(self, x):
        return _conv(self[1], F.interpolate(x, scale_factor=2, mode="nearest"), x.dtype)


class ConditionalUNet(nn.Module):
    """The DGM denoiser: x (B, H, W, 6), rgb_flow (B, H, W, 3) and mask
    (B, H, W, 1) NHWC, time (B,) and classes (B,) ints, keep_mask (B,) bool
    (False takes the learned null class) -> (B, H, W, 6) fp32."""

    def __init__(self, config: UNetConfig = UNetConfig()):
        super().__init__()
        self.config = cfg = config
        dim, groups = cfg.dim, cfg.resnet_block_groups
        cond_dim = 8 * dim  # time (4 dim) + classes (4 dim)
        self.init_conv = nn.Conv2d(cfg.channels + cfg.cond_channels, dim, 7, padding=3)
        self.time_mlp = nn.Sequential(SinusoidalPosEmb(dim), nn.Linear(dim, 4 * dim), nn.GELU(),
                                      nn.Linear(4 * dim, 4 * dim))
        self.classes_emb = nn.Embedding(cfg.num_classes, dim)
        self.null_classes_emb = nn.Parameter(torch.randn(dim))
        self.classes_mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(),
                                         nn.Linear(4 * dim, 4 * dim))

        def lin_attn(d):
            return Residual(PreNorm(d, LinearAttention(d, cfg.attn_heads, cfg.attn_dim_head)))

        dims = [dim] + [dim * m for m in cfg.dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.downs = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(in_out):
            last = i == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ResnetBlock(d_in, d_in, cond_dim, groups),
                ResnetBlock(d_in, d_in, cond_dim, groups),
                lin_attn(d_in),
                nn.Conv2d(d_in, d_out, 3, padding=1) if last else nn.Conv2d(d_in, d_out, 4, 2, 1),
            ]))
        mid = dims[-1]
        self.mid_block1 = ResnetBlock(mid, mid, cond_dim, groups)
        self.mid_attn = Residual(PreNorm(mid, Attention(mid, cfg.attn_heads, cfg.attn_dim_head)))
        self.mid_block2 = ResnetBlock(mid, mid, cond_dim, groups)
        self.ups = nn.ModuleList()
        for i, (d_in, d_out) in enumerate(reversed(in_out)):
            last = i == len(in_out) - 1
            self.ups.append(nn.ModuleList([
                ResnetBlock(d_out + d_in, d_out, cond_dim, groups),
                ResnetBlock(d_out + d_in, d_out, cond_dim, groups),
                lin_attn(d_out),
                nn.Conv2d(d_out, d_in, 3, padding=1) if last else Upsample(d_out, d_in),
            ]))
        self.final_res_block = ResnetBlock(2 * dim, dim, cond_dim, groups)
        self.final_conv = nn.Conv2d(dim, cfg.channels, 1)

    def _run(self, module: nn.Module, *args):
        """``module(*args)``, recomputed in the backward under ``remat``."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False, preserve_rng_state=False)
        return module(*args)

    def forward(self, x, time, classes, rgb_flow, mask, keep_mask):
        dt = self.config.dtype
        run = self._run
        ce = self.classes_emb(classes)
        ce = torch.where(keep_mask[:, None], ce, self.null_classes_emb[None, :])
        cond = torch.cat([self.time_mlp(time), self.classes_mlp(ce)], dim=-1).to(dt)

        h = torch.cat([x.to(dt), (rgb_flow * mask).to(dt)], dim=-1).permute(0, 3, 1, 2)
        h = _conv(self.init_conv, h.contiguous(), dt)
        r = h
        skips = []
        for block1, block2, attn, down in self.downs:
            h = run(block1, h, cond)
            skips.append(h)
            h = run(attn, run(block2, h, cond))
            skips.append(h)
            h = _conv(down, h, dt)
        h = run(self.mid_block2, run(self.mid_attn, run(self.mid_block1, h, cond)), cond)
        for block1, block2, attn, up in self.ups:
            h = run(block1, torch.cat([h, skips.pop()], dim=1), cond)
            h = run(attn, run(block2, torch.cat([h, skips.pop()], dim=1), cond))
            h = up(h) if isinstance(up, Upsample) else _conv(up, h, dt)
        h = run(self.final_res_block, torch.cat([h, r], dim=1), cond)
        out = F.conv2d(h.float(), self.final_conv.weight, self.final_conv.bias)
        return out.permute(0, 2, 3, 1)


def seeded_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Draws every parameter of a UNet from ``generator``, in place: a
    normal of std 1/sqrt(fan_in) for every conv and linear weight (LeCun, as
    the JAX package's init), zero biases, unit gains, N(0, 1) for the rest
    (class embeddings, Fourier weights)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".g") or name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif p.dim() >= 2 and "classes_emb" not in name:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
            else:
                p.copy_(torch.randn(p.shape, generator=generator))


def build_unet(config: UNetConfig = UNetConfig(), device=None,
               generator: Optional[torch.Generator] = None) -> ConditionalUNet:
    """A ConditionalUNet on ``device`` (default: the card; raises without
    one), in eval mode, with weights drawn from ``generator`` where given
    (:func:`seeded_weights_`)."""
    from dmhomo_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = ConditionalUNet(config)
    if generator is not None:
        seeded_weights_(model, generator)
    return model.to(dev).eval()
