"""Multi-scale Swin homography-weight regressor (the HEM ``h_net``).

Reference: ``SwinTransformer`` and its blocks in HEM/model/swin_multi.py,
shipped config crop 320x576, embed_dim 24, depths (2, 4, 6), layer_depth
(3, 2, 1), heads (3, 12, 24), window 8, mlp_ratio 3, qkv_bias.

Conv feature pyramids for both images, coarse-to-fine over 3 levels: at each
level the second image's features are warped by the current flow estimate
(basis . weights), the pair is tokenized and run through W-MSA / SW-MSA Swin
blocks with conv PatchMerging between sub-levels, then 8 learned query
tokens are updated by a class-attention block and regressed to per-basis
weight deltas.  Parameter and module names follow the reference state dict.

Tokens are laid out NHWC-flat (B, H*W, C); convolutions run NCHW inside.
Window attention goes through ``ops.window_attention`` (the CUDA kernels on
the card, forward and backward; their plain versions on the CPU).  With
``SwinConfig.attn_impl == 'fused_block'`` (per encoder level, see
``config.level_impl``) a Swin block whose resolution the window divides runs
as one whole-block kernel instead (``ops.swin_block``, forward and
backward), with the same parameters.  Under autocast each level's tokens
enter the encoder in the autocast dtype, as the JAX package casts them to
its activation dtype.  With ``SwinConfig.remat`` each Swin block is
recomputed in the backward (``torch.utils.checkpoint``), as the JAX
package's ``nn.remat``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dmhomo_torch.config import SwinConfig, level_impl
from dmhomo_torch.geometry.basis import NUM_BASIS, gen_homography_basis
from dmhomo_torch.geometry.warp import upsample_flow_to, warp_by_flow
from dmhomo_torch.ops.swin_block import swin_block
from dmhomo_torch.ops.window_attention import (
    max_abs_logit,
    window_attention,
    window_attention_reference,
)
from dmhomo_torch.parallel.distributed import all_reduce_, is_distributed


def relative_position_index(ws: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2ws-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)  # N, N, 2
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shifted_window_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) additive SW-MSA mask of 0 / -100."""
    img_mask = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C), windows image-major."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    C = wins.shape[-1]
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class _CrossRankBatchNorm(torch.autograd.Function):
    """Training-mode BatchNorm over the rows of every rank: the per-channel
    (count, sum x, sum x^2) in fp32 summed by one ``all_reduce``, the
    variance in Flax's one-pass form ``E[x^2] - E[x]^2`` (clipped at 0);
    the backward sums (sum dy, sum dy*xhat) by one more.  The weight and
    bias gradients are this rank's sums: the step's gradient all-reduce
    adds the other ranks'.  ``nn.SyncBatchNorm`` is not used: it takes the
    unbiased variance into the running statistics, and its backward
    gathers, which gloo does not run on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        C = x.shape[1]
        dims = (0, 2, 3)
        stats = torch.cat([x.new_full((1,), x.numel() // C), x.sum(dims), (x * x).sum(dims)])
        all_reduce_(stats)
        count = stats[:1]
        mean = stats[1:C + 1] / count
        var = (stats[C + 1:] / count - mean * mean).clamp_(min=0.0)
        running_mean.lerp_(mean, momentum)
        running_var.lerp_(var, momentum)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean[:, None, None]) * invstd[:, None, None]
        ctx.save_for_backward(xhat, weight, invstd, count)
        return xhat * weight[:, None, None] + bias[:, None, None]

    @staticmethod
    def backward(ctx, dy):
        xhat, weight, invstd, count = ctx.saved_tensors
        C = dy.shape[1]
        dims = (0, 2, 3)
        local = torch.cat([dy.sum(dims), (dy * xhat).sum(dims)])
        sums = all_reduce_(local.clone())
        mean_dy, mean_dy_xhat = sums[:C] / count, sums[C:] / count
        dx = (dy - mean_dy[:, None, None] - xhat * mean_dy_xhat[:, None, None]) * \
            (weight * invstd)[:, None, None]
        return dx, local[C:], local[:C], None, None, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over NCHW, computed in fp32, with Flax's training update:
    the running statistics move by ``momentum`` 0.1 (Flax's decay 0.9)
    toward the batch mean and the *biased* batch variance (torch's own
    update takes the unbiased one).  Under a process group the statistics
    are those of every rank's rows (:class:`_CrossRankBatchNorm`), as the
    JAX step computes them over the global batch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return super().forward(x)
        if is_distributed():
            self.num_batches_tracked.add_(1)
            return _CrossRankBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                             self.running_var, self.momentum, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact-erf GELU


class WindowAttention(nn.Module):
    """W-MSA over ws*ws-token windows with the max-free clipped softmax.

    With ``logits`` set to a list, the forward runs the plain window
    attention and appends each call's largest |logit| (mask left out) to it:
    the clip-validity diagnostic of ``HEMTrainer.logit_health``, which the
    kernels cannot serve since they never write their logits out."""

    logits = None

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.window_tokens = window_size * window_size
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def position_bias(self) -> torch.Tensor:
        """(heads, N, N) fp32 relative-position bias from the table."""
        N = self.window_tokens
        bias = self.relative_position_bias_table[self.rel_index].reshape(N, N, self.num_heads)
        return bias.permute(2, 0, 1).contiguous().float()

    def forward(self, x: torch.Tensor, mask: "torch.Tensor | None" = None) -> torch.Tensor:
        qkv, bias = self.qkv(x), self.position_bias()
        if self.logits is None:
            return self.proj(window_attention(qkv, bias, mask, num_heads=self.num_heads))
        self.logits.append(max_abs_logit(qkv, bias, num_heads=self.num_heads))
        return self.proj(window_attention_reference(qkv, bias, mask, num_heads=self.num_heads))


class SwinBlock(nn.Module):
    """W-MSA / SW-MSA block: window attention and an MLP, each pre-LayerNorm
    and residual.  ``attn_impl == 'fused_block'`` runs the whole block as
    one kernel where the window divides the resolution."""

    def __init__(self, dim: int, input_resolution: tuple, num_heads: int,
                 window_size: int, shift_size: int, mlp_ratio: float, qkv_bias: bool = True,
                 attn_impl: str = "xla"):
        super().__init__()
        H, W = input_resolution
        if min(H, W) <= window_size:  # the window covers the whole map
            window_size, shift_size = min(H, W), 0
        self.resolution = (H, W)
        self.window_size = window_size
        self.shift_size = shift_size
        self.fused = attn_impl == "fused_block" and H % window_size == 0 and W % window_size == 0
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        mask = (torch.from_numpy(shifted_window_mask(H, W, window_size, shift_size))
                if shift_size > 0 else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            return self._fused_forward(x)
        H, W = self.resolution
        ws, shift = self.window_size, self.shift_size
        B, L, C = x.shape
        y = self.norm1(x).reshape(B, H, W, C)
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        y = window_reverse(self.attn(window_partition(y, ws), self.attn_mask), ws, H, W)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        x = x + y.reshape(B, L, C)
        return x + self.mlp(self.norm2(x))

    def fused_params(self) -> tuple:
        """The block's parameters as ``ops.swin_block`` takes them."""
        attn, mlp = self.attn, self.mlp
        bq = attn.qkv.bias
        if bq is None:
            bq = attn.qkv.weight.new_zeros(attn.qkv.weight.shape[0])
        return (self.norm1.weight, self.norm1.bias, attn.qkv.weight, bq, attn.position_bias(),
                attn.proj.weight, attn.proj.bias, self.norm2.weight, self.norm2.bias,
                mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias)

    def _fused_forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, L, C = x.shape
        y = swin_block(x.reshape(B, H, W, C), self.fused_params(), self.attn_mask,
                       num_heads=self.attn.num_heads, window_size=self.window_size,
                       shift=self.shift_size)
        return y.reshape(B, L, C)


class PatchMerging(nn.Module):
    """Conv downsample merge: conv3s2 + BN + LReLU, conv3 + BN + LReLU."""

    def __init__(self, dim: int, input_resolution: tuple):
        super().__init__()
        self.resolution = input_resolution
        self.conv1 = nn.Conv2d(dim, 2 * dim, 3, stride=2, padding=1, bias=False)
        self.norm1 = BatchNorm2d(2 * dim, eps=1e-5)
        self.conv2 = nn.Conv2d(2 * dim, 2 * dim, 3, padding=1, bias=False)
        self.norm2 = BatchNorm2d(2 * dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.resolution
        B, L, C = x.shape
        x = x.reshape(B, H, W, C).permute(0, 3, 1, 2)
        x = F.leaky_relu(self.norm1(self.conv1(x)), 0.01)
        x = F.leaky_relu(self.norm2(self.conv2(x)), 0.01)
        return x.permute(0, 2, 3, 1).reshape(B, (H // 2) * (W // 2), 2 * C)


class BasicLayer(nn.Module):
    """One encoder stage: ``layer_depth`` sub-levels of Swin blocks, with a
    merge after each but the last, in one Sequential (``layer.{idx}``).
    With ``remat`` the Swin blocks are recomputed in the backward."""

    def __init__(self, dim: int, input_resolution: tuple, depth: int, layer_depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float, qkv_bias: bool = True,
                 remat: bool = False, attn_impl: str = "xla"):
        super().__init__()
        self.remat = remat
        mods = []
        for l in range(layer_depth):
            res = (input_resolution[0] // 2**l, input_resolution[1] // 2**l)
            d = dim * 2**l
            for i in range(depth):
                mods.append(SwinBlock(d, res, num_heads, window_size,
                                      0 if i % 2 == 0 else window_size // 2,
                                      mlp_ratio, qkv_bias, attn_impl))
            if l < layer_depth - 1:
                mods.append(PatchMerging(d, res))
        self.layer = nn.Sequential(*mods)

    def forward(self, x):
        for m in self.layer:
            if self.remat and isinstance(m, SwinBlock) and torch.is_grad_enabled():
                # the blocks draw no random numbers: no RNG state to keep
                # (and none to restore while a CUDA graph is captured)
                x = checkpoint(m, x, use_reentrant=False, preserve_rng_state=False)
            else:
                x = m(x)
        return x


class ClassAttention(nn.Module):
    """``num_queries`` query tokens attend over all tokens."""

    def __init__(self, dim: int, num_heads: int, num_queries: int = 8, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.num_queries = num_queries
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.k = nn.Linear(dim, dim, bias=qkv_bias)
        self.v = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        B, N, C = u.shape
        h, nq = self.num_heads, self.num_queries
        hd = C // h
        q = self.q(u[:, :nq]).reshape(B, nq, h, hd).transpose(1, 2) * (hd**-0.5)
        k = self.k(u).reshape(B, N, h, hd).transpose(1, 2)
        v = self.v(u).reshape(B, N, h, hd).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(B, nq, C))


class LayerScaleBlockCA(nn.Module):
    """Query-token update block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool = True):
        super().__init__()
        init_val = 1e-5 if dim <= 24 else 1e-6
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_val))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_val))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ClassAttention(dim, num_heads, qkv_bias=qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp1 = Mlp(dim, int(dim * mlp_ratio))
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp2 = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x_cls, x):
        u = torch.cat([x_cls, x], dim=1)
        x_cls = x_cls + self.gamma_1 * self.attn(self.norm1(u))
        x_cls = x_cls + self.gamma_2 * self.mlp1(self.norm2(x_cls))
        return self.mlp2(self.norm3(x_cls))


class FeatureExtractor(nn.Module):
    """Conv pyramid: stride-2 conv + GELU + conv + GELU per level.
    (B, H, W, 1) -> list of NHWC levels, coarsest first."""

    def __init__(self, embed_dim: int, num_layers: int):
        super().__init__()
        convs = []
        cin = 1
        for i in range(num_layers):
            cout = int(embed_dim * 2**i)
            convs.append(nn.Sequential(
                nn.Conv2d(cin, cout, 3, stride=2, padding=1), nn.GELU(),
                nn.Conv2d(cout, cout, 3, padding=1), nn.GELU()))
            cin = cout
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        pyramid = []
        for conv in self.convs:
            x = conv(x)
            pyramid.append(x.permute(0, 2, 3, 1))
        return pyramid[::-1]


class SwinTransformer(nn.Module):
    """Coarse-to-fine homography-basis-weight regressor.

    Input (B, hp, wp, 2): the two 1-channel feature maps.  Output
    (B, num_basis, 1) accumulated weights.  ``basis`` is the flow basis in
    the reference checkpoint's layout: (1, num_basis, 2*h*w) flattened from
    (num_basis, 2, h, w).
    """

    def __init__(self, config: SwinConfig = SwinConfig()):
        super().__init__()
        cfg = self.config = config
        nL, nf = cfg.num_layers, cfg.num_features
        self.query_token = nn.Parameter(torch.zeros(1, NUM_BASIS, nf))
        self.feature_pyramid_extractor = FeatureExtractor(cfg.embed_dim // 2, nL)
        self.encoder_layers = nn.ModuleList(
            BasicLayer(
                dim=int(cfg.embed_dim * 2**e),
                input_resolution=(cfg.crop_size[0] // 2 ** (e + 1),
                                  cfg.crop_size[1] // 2 ** (e + 1)),
                depth=cfg.depths[e], layer_depth=cfg.layer_depth[e],
                num_heads=cfg.num_heads[e], window_size=cfg.window_size,
                mlp_ratio=cfg.mlp_ratio, qkv_bias=cfg.qkv_bias, remat=cfg.remat,
                attn_impl=level_impl(cfg.attn_impl, e))
            for e in range(nL))
        blk_heads = list(cfg.num_heads[1:]) + [cfg.num_heads[-1]]
        self.blocks_token_only = nn.ModuleList(
            LayerScaleBlockCA(nf, blk_heads[j], cfg.mlp_ratio, cfg.qkv_bias)
            for j in range(nL))
        self.norm = nn.LayerNorm(nf, eps=1e-5)
        self.head1 = nn.Linear(nf, nf)
        self.head2 = nn.Linear(nf, 1)
        basis = gen_homography_basis(*cfg.crop_size).transpose(0, 3, 1, 2)
        self.register_buffer("basis", torch.from_numpy(
            np.ascontiguousarray(basis).reshape(1, NUM_BASIS, -1)))

    def flow(self, weight: torch.Tensor) -> torch.Tensor:
        """(B, num_basis, 1) weights -> (B, h, w, 2) flow = sum_k w_k basis_k."""
        h, w = self.config.crop_size
        basis = self.basis.reshape(NUM_BASIS, 2, h, w)
        with torch.autocast(weight.device.type, enabled=False):  # flows stay fp32
            return torch.einsum("bk,kchw->bhwc", weight[..., 0].float(), basis).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        B, hp, wp, _ = x.shape
        nL = cfg.num_layers
        query = self.query_token.expand(B, -1, -1)
        x1_pyr = self.feature_pyramid_extractor(x[..., :1])
        x2_pyr = self.feature_pyramid_extractor(x[..., 1:])
        weight = torch.zeros(B, NUM_BASIS, 1, dtype=torch.float32, device=x.device)
        for l, (x1, x2) in enumerate(zip(x1_pyr, x2_pyr)):
            _, h_x, w_x, _ = x1.shape
            if l == 0:
                x2_warp = x2
            else:
                flow_l = upsample_flow_to(self.flow(weight), (h_x, w_x))
                x2_warp = warp_by_flow(x2, flow_l, mode="collapse")
            dev = x1.device.type
            if torch.is_autocast_enabled(dev):  # the warp returns fp32
                dt = torch.get_autocast_dtype(dev)
                x1, x2_warp = x1.to(dt), x2_warp.to(dt)
            tok = torch.cat([x1, x2_warp], dim=-1).reshape(B, h_x * w_x, -1)
            enc_idx = nL - l - 1
            tok = self.encoder_layers[enc_idx](tok)
            query = self.norm(self.blocks_token_only[enc_idx](query, tok))
            delta = self.head2(F.gelu(self.head1(query)))  # (B, 8, 1)
            weight = weight + delta * (hp // h_x)
        return weight
