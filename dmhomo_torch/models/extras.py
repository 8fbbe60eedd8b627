"""Auxiliary reference modules (the JAX package's ``models/extras.py``):
present in the reference, unused by its shipped configs.

* :func:`gradient_reversal` - the identity forward, -alpha x the gradient
  backward (model/GradientReversal);
* :class:`Discriminator` (net.py:326-366) - HomoGAN-legacy conv classifier;
* :class:`SpatialAttention` (net.py:515-562) - channel-transposed attention;
* :func:`pixel_unshuffle` / :func:`pixel_shuffle` - NHWC, in the JAX
  package's channel order ((r, r, C) blocks: channel (i r + j) C + c),
  which is not ``torch.nn.functional``'s ((C, r, r): c r^2 + i r + j);
* :class:`MaskPredictor` (net.py:565-632) - pixel-(un)shuffle mask head;
* :class:`ASPP` (model/module/aspp.py) - atrous spatial pyramid pooling;
* :class:`WindowCrossAttention` (swin_multi.py:607-881) - q from image A's
  windows, k / v from image B's, a shared relative-position bias; an
  ordinary softmax with its max subtracted, in plain ops.

Public tensors are NHWC; convolutions run NCHW inside.  Submodules carry the
JAX modules' names, so ``models/convert.py::module_state_dict_from_jax``
carries JAX weights across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dmhomo_torch.models.swin import (
    BatchNorm2d,
    relative_position_index,
    window_partition,
    window_reverse,
)


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def gradient_reversal(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """x forward; the incoming gradient times -alpha backward."""
    return _GradientReversal.apply(x, alpha)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """5 strided 3x3 convs (32 .. 512) + BN + ReLU, a 1x1 conv to
    ``n_classes`` and a global average pool: (B, H, W, in_channels) ->
    (B, n_classes)."""

    def __init__(self, in_channels: int = 1, n_classes: int = 1):
        super().__init__()
        cin = in_channels
        for i, ch in enumerate((32, 64, 128, 256, 512)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, 3, 2, padding=1, bias=False))
            self.add_module(f"bn{i}", BatchNorm2d(ch, eps=1e-5))
            cin = ch
        self.conv_last = nn.Conv2d(cin, n_classes, 1, bias=False)

    def forward(self, x):
        x = _nchw(x)
        for i in range(5):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.conv_last(x.float()).mean(dim=(2, 3))


class SpatialAttention(nn.Module):
    """Channel-transposed attention with a learned temperature per head:
    (B, H, W, dim) -> (B, H, W, dim)."""

    def __init__(self, dim: int, num_heads: int = 8, use_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Conv2d(dim, 3 * dim, 1, bias=use_bias)
        self.qkv_dwconv = nn.Conv2d(3 * dim, 3 * dim, 3, padding=1, groups=3 * dim,
                                    bias=use_bias)
        self.project_out = nn.Conv2d(dim, dim, 1, bias=use_bias)

    def forward(self, x):
        B, H, W, C = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(_nchw(x))).chunk(3, dim=1)
        hd = C // self.num_heads
        # (B, C, H, W) -> (B, heads, hd, N): channel h * hd + d
        q, k, v = (t.reshape(B, self.num_heads, hd, H * W) for t in (q, k, v))
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        k = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        attn = (q @ k.transpose(-1, -2)) * self.temperature[None]
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).reshape(B, C, H, W)
        return _nhwc(self.project_out(out))


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/r, W/r, r r C), channel (i r + j) C + c."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // r, r, W // r, r, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // r, W // r, C * r * r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """The inverse of :func:`pixel_unshuffle`: (B, H, W, r r C) -> (B, rH, rW, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H, W, r, r, C // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H * r, W * r, C // (r * r))


class MaskPredictor(nn.Module):
    """Legacy mask head: grouped convs, two SpatialAttention blocks at half
    resolution between a pixel unshuffle and shuffle, a sigmoid:
    (B, H, W, in_channels) -> (B, H, W, 1)."""

    def __init__(self, in_channels: int = 2):
        super().__init__()
        self.conv0 = nn.Conv2d(in_channels, 16, 3, padding=1, groups=2, bias=False)
        self.conv1 = nn.Conv2d(16, 16, 3, padding=1, groups=2, bias=False)
        self.attention0 = SpatialAttention(64, 8)
        self.conv2 = nn.Conv2d(64, 64, 3, padding=1, bias=False)
        self.conv3 = nn.Conv2d(64, 64, 3, padding=1, bias=False)
        self.attention1 = SpatialAttention(64, 8)
        self.conv4 = nn.Conv2d(16, 8, 3, padding=1, groups=8, bias=False)
        self.conv5 = nn.Conv2d(8, 1, 1, bias=False)

    def forward(self, x):
        out0 = F.relu(self.conv1(self.conv0(_nchw(x))))
        d = self.attention0(pixel_unshuffle(_nhwc(out0), 2))
        d = _nhwc(self.conv3(self.conv2(_nchw(d))))
        u = pixel_shuffle(self.attention1(d), 2)
        y = self.conv4(_nchw(u) + out0)
        return _nhwc(torch.sigmoid(self.conv5(y.float())))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch and 3x3 branches at the
    given dilations (BN + ReLU each), a global-pool branch, concatenated and
    projected: (B, H, W, in_channels) -> (B, H, W, out_channels)."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 dilations: tuple = (1, 6, 12, 18)):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            k = 1 if d == 1 else 3
            self.add_module(f"branch{i}", nn.Conv2d(in_channels, out_channels, k,
                                                    padding=0 if d == 1 else d, dilation=d,
                                                    bias=False))
            self.add_module(f"bn{i}", BatchNorm2d(out_channels, eps=1e-5))
        self.global_conv = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        self.project = nn.Conv2d(out_channels * (len(self.dilations) + 1), out_channels, 1,
                                 bias=False)

    def forward(self, x):
        x = _nchw(x)
        ys = [F.relu(getattr(self, f"bn{i}")(getattr(self, f"branch{i}")(x)))
              for i in range(len(self.dilations))]
        gp = F.relu(self.global_conv(x.mean(dim=(2, 3), keepdim=True)))
        ys.append(gp.expand(-1, -1, *x.shape[2:]).to(ys[0].dtype))
        return _nhwc(F.relu(self.project(torch.cat(ys, dim=1))))


class WindowCrossAttention(nn.Module):
    """Cross-image windowed attention: (xa, xb) (B, H, W, dim) -> (B, H, W,
    dim), queries from xa's windows, keys and values from xb's."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)).long(), persistent=False)

    def forward(self, xa, xb):
        ws, heads = self.window_size, self.num_heads
        B, H, W, C = xa.shape
        hd = self.dim // heads
        wa, wb = window_partition(xa, ws), window_partition(xb, ws)
        Bn, N, _ = wa.shape
        q = self.q(wa).reshape(Bn, N, heads, hd) * hd**-0.5
        k, v = (t.reshape(Bn, N, heads, hd) for t in self.kv(wb).chunk(2, dim=-1))
        attn = torch.einsum("bihd,bjhd->bhij", q, k)
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = torch.softmax((attn + bias.reshape(N, N, heads).permute(2, 0, 1)[None]).float(),
                             dim=-1).to(xa.dtype)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(Bn, N, C)
        return window_reverse(self.proj(out), ws, H, W)
