"""Weights carried across: JAX-package trees and reference checkpoints.

* :func:`estimator_state_dict_from_jax` turns the JAX package's flax
  ``params`` / ``batch_stats`` trees (nested dicts of numpy arrays) into this
  port's state dict: the exact inverse of the JAX package's
  ``import_estimator_state_dict``.
* :func:`load_reference_state_dict` loads a reference OSNet state dict
  (HEM.pth layout) with ``strict=True``, after dropping the reference's dead
  modules and re-derived buffers.
* :func:`unet_state_dict_from_jax` and :func:`uncond_unet_state_dict_from_jax`
  turn the JAX ``ConditionalUNet`` / ``UncondUNet`` params into the port's
  UNet state dicts (reference key names), sharing one stage walk;
  :func:`load_dgm_checkpoint` loads a reference ``DGM.pt``.
* :class:`ChannelProbe` runs a converter on no weights at all: each leaf
  transform then says which torch dim receives the JAX leaf's last dim,
  the dim ``parallel/tp.py`` shards over the mesh's ``model`` axis as the
  JAX package's ``channel_shardings`` does.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import numpy as np
import torch

from dmhomo_torch.config import EstimatorConfig
from dmhomo_torch.geometry.basis import NUM_BASIS, gen_homography_basis

# Reference keys with no counterpart in the port: modules constructed but
# never called on the forward path, and index/mask buffers the port derives
# itself.  BatchNorm's num_batches_tracked is kept: the port's BN has it.
DEAD_KEYS: Tuple[str, ...] = (
    r"^h_net\.patch_embed\.",       # forward uses fea_extra instead
    r"\.attn\.info_flatten\.",      # constructed, never called
    r"\.relative_position_index$",  # derived from window_size
    r"\.attn_mask$",                # SW-MSA mask derived from the resolution
    # PatchMerging's reduction Linear + LayerNorm: its forward only runs
    # conv1/norm1/conv2/norm2
    r"^h_net\.encoder_layers\.\d+\.layer\.\d+\.(reduction\.weight|norm\.(weight|bias))$",
)


_CONV_AXES = (3, 2, 0, 1)  # HWIO -> OIHW
_LIN_AXES = (1, 0)  # (I, O) -> (O, I)


class ChannelProbe(dict):
    """A stand-in for a JAX params tree: every key holds another probe and
    every ``in`` test is true.  A converter run on it returns, in place of
    each tensor, the :class:`ChannelDim` its leaf transform moves the JAX
    leaf's last dim to; it also names keys the module may lack (the bias
    of a conv built without one), which the caller drops."""

    def __missing__(self, key):
        return ChannelProbe()

    def __contains__(self, key) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class ChannelDim:
    """The torch dim holding a JAX leaf's last dim (negative: from the end)."""

    dim: int


def _t(a) -> torch.Tensor:
    if isinstance(a, ChannelProbe):
        return ChannelDim(-1)  # as it is: the last dim stays last
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(k) -> torch.Tensor:
    if isinstance(k, ChannelProbe):
        return ChannelDim(_CONV_AXES.index(len(_CONV_AXES) - 1))
    return _t(np.transpose(np.asarray(k), _CONV_AXES))


def _lin(k) -> torch.Tensor:
    if isinstance(k, ChannelProbe):
        return ChannelDim(_LIN_AXES.index(len(_LIN_AXES) - 1))
    return _t(np.transpose(np.asarray(k), _LIN_AXES))


def _gain(g) -> torch.Tensor:
    """A LayerNorm gain (C,) as (1, C, 1, 1)."""
    if isinstance(g, ChannelProbe):
        return ChannelDim(1)
    return _t(np.asarray(g).reshape(1, -1, 1, 1))


def estimator_state_dict_from_jax(params: Dict, batch_stats: Dict,
                                  config: EstimatorConfig) -> Dict[str, torch.Tensor]:
    """JAX ``HomographyEstimator`` variables -> this port's state dict."""
    sd: Dict[str, torch.Tensor] = {}

    def dense(dst, p):
        sd[f"{dst}.weight"] = _lin(p["kernel"])
        if "bias" in p:
            sd[f"{dst}.bias"] = _t(p["bias"])

    def conv(dst, p):
        sd[f"{dst}.weight"] = _conv(p["kernel"])
        if "bias" in p:
            sd[f"{dst}.bias"] = _t(p["bias"])

    def ln(dst, p):
        sd[f"{dst}.weight"] = _t(p["scale"])
        sd[f"{dst}.bias"] = _t(p["bias"])

    def bn(dst, p, s):
        ln(dst, p)
        sd[f"{dst}.running_mean"] = _t(s["mean"])
        sd[f"{dst}.running_var"] = _t(s["var"])
        sd[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def mlp(dst, p):
        dense(f"{dst}.fc1", p["fc1"])
        dense(f"{dst}.fc2", p["fc2"])

    fe_p, fe_s = params["fea_extra"], batch_stats["fea_extra"]
    for i, base in enumerate((0, 3, 6)):
        conv(f"fea_extra.{base}", fe_p[f"conv{i}"])
        bn(f"fea_extra.{base + 1}", fe_p[f"bn{i}"], fe_s[f"bn{i}"])

    mg = params["mask_generator"]
    for i in range(1, 6):
        conv(f"mask_generator.conv{i}.0", mg[f"conv{i}"])
    conv("mask_generator.conv_last.0", mg["conv_last"])

    swin = config.swin
    h = params["h_net"]
    hbs = batch_stats.get("h_net", {})
    sd["h_net.query_token"] = _t(h["query_token"])
    for i in range(swin.num_layers):
        conv(f"h_net.feature_pyramid_extractor.convs.{i}.0", h["feature_pyramid"][f"conv{i}_0"])
        conv(f"h_net.feature_pyramid_extractor.convs.{i}.2", h["feature_pyramid"][f"conv{i}_1"])

    for enc in range(swin.num_layers):
        enc_p = h[f"encoder_{enc}"]
        enc_s = hbs.get(f"encoder_{enc}", {})
        depth = swin.depths[enc]
        for l in range(swin.layer_depth[enc]):
            for i in range(depth):
                dst = f"h_net.encoder_layers.{enc}.layer.{l * (depth + 1) + i}"
                blk = enc_p[f"sub{l}_block{i}"]
                ln(f"{dst}.norm1", blk["norm1"])
                ln(f"{dst}.norm2", blk["norm2"])
                mlp(f"{dst}.mlp", blk["mlp"])
                sd[f"{dst}.attn.relative_position_bias_table"] = _t(
                    blk["attn"]["relative_position_bias_table"])
                dense(f"{dst}.attn.qkv", blk["attn"]["qkv"])
                dense(f"{dst}.attn.proj", blk["attn"]["proj"])
            if l < swin.layer_depth[enc] - 1:
                dst = f"h_net.encoder_layers.{enc}.layer.{l * (depth + 1) + depth}"
                m_p, m_s = enc_p[f"sub{l}_merge"], enc_s[f"sub{l}_merge"]
                conv(f"{dst}.conv1", m_p["conv1"])
                conv(f"{dst}.conv2", m_p["conv2"])
                bn(f"{dst}.norm1", m_p["norm1"], m_s["norm1"])
                bn(f"{dst}.norm2", m_p["norm2"], m_s["norm2"])

    for j in range(swin.num_layers):
        dst = f"h_net.blocks_token_only.{j}"
        blk = h[f"token_block_{j}"]
        sd[f"{dst}.gamma_1"] = _t(blk["gamma_1"])
        sd[f"{dst}.gamma_2"] = _t(blk["gamma_2"])
        for n in ("norm1", "norm2", "norm3"):
            ln(f"{dst}.{n}", blk[n])
        mlp(f"{dst}.mlp1", blk["mlp1"])
        mlp(f"{dst}.mlp2", blk["mlp2"])
        for n in ("q", "k", "v", "proj"):
            dense(f"{dst}.attn.{n}", blk["attn"][n])

    ln("h_net.norm", h["norm"])
    dense("h_net.head1", h["head1"])
    dense("h_net.head2", h["head2"])
    basis = gen_homography_basis(*config.crop_size).transpose(0, 3, 1, 2)
    sd["h_net.basis"] = _t(basis.reshape(1, NUM_BASIS, -1))
    return sd


def load_reference_state_dict(model: torch.nn.Module, sd: Dict) -> None:
    """Load a reference OSNet state dict into the port, ``strict=True``:
    strips DDP's ``module.`` prefix and drops :data:`DEAD_KEYS`.  The
    checkpoint's own ``h_net.basis`` buffer replaces the computed one."""
    pats = [re.compile(p) for p in DEAD_KEYS]
    clean = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not any(p.search(k) for p in pats):
            clean[k] = v
    model.load_state_dict(clean, strict=True)


def load_hem_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """State dict of a reference HEM checkpoint: the ``state_dict`` or legacy
    ``HNet_state_dict`` entry, or the file itself when it is a bare dict."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "HNet_state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            return ckpt[key]
    return ckpt


def _conv_into(sd: Dict, dst: str, p: Dict) -> None:
    sd[f"{dst}.weight"] = _conv(p["kernel"])
    if "bias" in p:
        sd[f"{dst}.bias"] = _t(p["bias"])


def _dense_into(sd: Dict, dst: str, p: Dict) -> None:
    sd[f"{dst}.weight"] = _lin(p["kernel"])
    sd[f"{dst}.bias"] = _t(p["bias"])


def _gain_into(sd: Dict, dst: str, g) -> None:
    sd[dst] = _gain(g)


def _resblock_into(sd: Dict, dst: str, p: Dict) -> None:
    _dense_into(sd, f"{dst}.mlp.1", p["mlp"])
    for b in ("block1", "block2"):
        _conv_into(sd, f"{dst}.{b}.proj", p[b]["proj"])
        sd[f"{dst}.{b}.norm.weight"] = _t(p[b]["norm"]["scale"])
        sd[f"{dst}.{b}.norm.bias"] = _t(p[b]["norm"]["bias"])
    if "res_conv" in p:
        _conv_into(sd, f"{dst}.res_conv", p["res_conv"])


def _attn_into(sd: Dict, params: Dict, dst: str, wrap: str, inner: str, full=False) -> None:
    _gain_into(sd, f"{dst}.fn.norm.g", params[wrap]["norm"]["g"])
    _conv_into(sd, f"{dst}.fn.fn.to_qkv", params[inner]["to_qkv"])
    if full:
        _conv_into(sd, f"{dst}.fn.fn.to_out", params[inner]["to_out"])
    else:
        _conv_into(sd, f"{dst}.fn.fn.to_out.0", params[inner]["to_out"])
        _gain_into(sd, f"{dst}.fn.fn.to_out.1.g", params[inner]["out_norm"]["g"])


def _unet_body_into(sd: Dict, params: Dict, n: int, downsample_key) -> None:
    """The init conv, the n down and up stages, the middle and the final
    blocks shared by both UNets; ``downsample_key(i)`` names stage i's
    downsample in the port."""
    _conv_into(sd, "init_conv", params["init_conv"])
    _dense_into(sd, "time_mlp.1", params["time_mlp_0"])
    _dense_into(sd, "time_mlp.3", params["time_mlp_1"])
    for i in range(n):
        _resblock_into(sd, f"downs.{i}.0", params[f"down_{i}_block1"])
        _resblock_into(sd, f"downs.{i}.1", params[f"down_{i}_block2"])
        _attn_into(sd, params, f"downs.{i}.2", f"down_{i}_attn_wrap", f"down_{i}_attn")
        _conv_into(sd, downsample_key(i), params[f"down_{i}_downsample"])
    _resblock_into(sd, "mid_block1", params["mid_block1"])
    _attn_into(sd, params, "mid_attn", "mid_attn_wrap", "mid_attn", full=True)
    _resblock_into(sd, "mid_block2", params["mid_block2"])
    for i in range(n):
        _resblock_into(sd, f"ups.{i}.0", params[f"up_{i}_block1"])
        _resblock_into(sd, f"ups.{i}.1", params[f"up_{i}_block2"])
        _attn_into(sd, params, f"ups.{i}.2", f"up_{i}_attn_wrap", f"up_{i}_attn")
        _conv_into(sd, f"ups.{i}.3" if i == n - 1 else f"ups.{i}.3.1", params[f"up_{i}_upsample"])
    _resblock_into(sd, "final_res_block", params["final_res_block"])
    _conv_into(sd, "final_conv", params["final_conv"])


def unet_state_dict_from_jax(params: Dict, config) -> Dict[str, torch.Tensor]:
    """JAX ``ConditionalUNet`` params -> this port's UNet state dict
    (reference key names; LayerNorm gains as (1, C, 1, 1))."""
    sd: Dict[str, torch.Tensor] = {}
    _unet_body_into(sd, params, len(config.dim_mults), lambda i: f"downs.{i}.3")
    _dense_into(sd, "classes_mlp.0", params["classes_mlp_0"])
    _dense_into(sd, "classes_mlp.2", params["classes_mlp_1"])
    sd["classes_emb.weight"] = _t(params["classes_emb"]["embedding"])
    sd["null_classes_emb"] = _t(params["null_classes_emb"])
    return sd


def uncond_unet_state_dict_from_jax(params: Dict, config) -> Dict[str, torch.Tensor]:
    """JAX ``UncondUNet`` params -> this port's ``UncondUNet`` state dict
    (reference key names): the pixel-unshuffle's conv as ``downs.{i}.3.1``
    (the last stage's 3x3 conv as ``downs.{i}.3``), the learned or random
    Fourier weights as ``time_mlp.0.weights``."""
    sd: Dict[str, torch.Tensor] = {}
    n = len(config.dim_mults)
    _unet_body_into(sd, params, n, lambda i: f"downs.{i}.3" if i == n - 1 else f"downs.{i}.3.1")
    if config.learned_sinusoidal or config.random_fourier:
        sd["time_mlp.0.weights"] = _t(params["sinu_pos_emb"]["weights"])
    return sd


# Keys of a reference DGM.pt beside the UNet's: the GaussianDiffusion
# schedule buffers (recomputed from the config) in 'model', and the
# ema_pytorch bookkeeping and wrapped schedule copy in 'ema'.
DGM_MODEL_SKIPS: Tuple[str, ...] = (
    r"^(betas|alphas_cumprod|alphas_cumprod_prev)$",
    r"^sqrt_", r"^log_one_minus_alphas_cumprod$",
    r"^posterior_", r"^(p2_)?loss_weight$",
)
DGM_EMA_SKIPS: Tuple[str, ...] = (
    r"^(initted|step)$",
    r"^online_model\.",
    r"^ema_model\.(?!model\.)",
)


def _unet_part(sd: Dict, prefix: str, skips: Tuple[str, ...], what: str) -> Dict:
    """The ``prefix`` keys of sd with the prefix cut; every other key must be
    on ``skips`` or this raises."""
    pats = [re.compile(p) for p in skips]
    extra = sorted(k for k in sd if not k.startswith(prefix) and not any(p.search(k) for p in pats))
    if extra:
        raise ValueError(f"{what}: unexpected keys {extra[:20]}")
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_dgm_checkpoint(model: torch.nn.Module, path: str, use_ema: bool = True) -> int:
    """Load a reference ``DGM.pt`` (``{'step', 'model', 'ema', ...}``) into
    the port's ConditionalUNet with ``strict=True`` and return its step.

    Takes the EMA weights (``ema_model.model.*``) unless ``use_ema`` is
    False or the file has none, else the online ``model.*`` weights.  The
    schedule buffers and EMA bookkeeping are dropped; the class-embedding
    rows are trimmed, or padded by repeating row 0, to the model's
    ``num_classes`` (the reference trains with 5 classes and samples with 1).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = _unet_part(ckpt["model"], "model.", DGM_MODEL_SKIPS, "DGM checkpoint 'model'")
    if use_ema and ckpt.get("ema") is not None:
        ema = _unet_part(ckpt["ema"], "ema_model.model.", DGM_EMA_SKIPS, "DGM checkpoint 'ema'")
        sd = ema or sd
    emb = sd["classes_emb.weight"]
    n = model.classes_emb.num_embeddings
    if emb.shape[0] > n:
        emb = emb[:n]
    elif emb.shape[0] < n:
        emb = torch.cat([emb, emb[:1].repeat(n - emb.shape[0], 1)], dim=0)
    sd["classes_emb.weight"] = emb
    model.load_state_dict(sd, strict=True)
    return int(ckpt.get("step", 0))
