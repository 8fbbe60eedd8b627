"""Estimator configs and the params.json reader (reference format).

Only the fields the HEM estimator forward reads; shipped defaults from
HEM/experiments/params.json: crop 320x576, embed_dim 24, depths (2, 4, 6),
layer_depth (3, 2, 1), heads (3, 12, 24), window 8, mlp_ratio 3.

``SwinConfig.attn_impl`` takes the JAX package's names: ``'fused_block'``
runs each Swin block as one whole-block kernel (``ops/swin_block.py``);
``'xla'``, ``'pallas'`` and ``'auto'`` all run the window-attention kernel
(its plain version on the CPU).  A comma-separated spec picks one per
encoder level (see :func:`level_impl`).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

ATTN_IMPLS = ("xla", "pallas", "auto", "fused_block")


def level_impl(attn_impl: str, enc_idx: int) -> str:
    """The attention implementation of encoder level ``enc_idx`` from a
    plain name or a comma-separated spec (``'pallas,pallas,fused_block'``,
    the last entry covering the deeper levels); an unknown name raises."""
    impls = attn_impl.split(",")
    impl = impls[min(enc_idx, len(impls) - 1)]
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r} in {attn_impl!r}; expected one of "
                         f"{ATTN_IMPLS}")
    return impl


class Params:
    """JSON -> attribute object (HEM/common/utils.py layout)."""

    def __init__(self, json_path: Optional[str] = None, **kwargs):
        if json_path:
            with open(json_path) as f:
                self.__dict__.update(json.load(f))
        self.__dict__.update(kwargs)

    @property
    def dict(self):
        return self.__dict__


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    crop_size: tuple = (320, 576)
    embed_dim: int = 24
    depths: Sequence[int] = (2, 4, 6)
    layer_depth: Sequence[int] = (3, 2, 1)
    num_heads: Sequence[int] = (3, 12, 24)
    window_size: int = 8
    mlp_ratio: float = 3.0
    qkv_bias: bool = True
    remat: bool = False  # recompute each Swin block in the backward
    attn_impl: str = "xla"  # see level_impl

    @property
    def num_layers(self) -> int:
        return len(self.depths)

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    def __post_init__(self):
        for enc_idx in range(len(self.attn_impl.split(","))):
            level_impl(self.attn_impl, enc_idx)
        # every encoder stage ends at num_features channels so the
        # class-attention query tokens see a constant width
        for i, ld in enumerate(self.layer_depth):
            if ld != self.num_layers - i:
                raise ValueError(
                    f"layer_depth[{i}]={ld} must equal num_layers-{i}="
                    f"{self.num_layers - i} so all stages end at num_features")


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    ori_size: tuple = (360, 640)  # full resolution of the eval view
    swin: SwinConfig = SwinConfig()

    @property
    def crop_size(self) -> tuple:
        """Patch resolution the estimator runs at."""
        return self.swin.crop_size

    @classmethod
    def from_params(cls, params: Params) -> "EstimatorConfig":
        """Estimator part of a reference-format params.json."""
        p = params.dict
        swin = SwinConfig(
            crop_size=tuple(p.get("crop_size", (320, 576))),
            embed_dim=p.get("embed_dim", 24),
            depths=tuple(p.get("depths", (2, 4, 6))),
            layer_depth=tuple(p.get("layer_depth", (3, 2, 1))),
            num_heads=tuple(p.get("num_heads", (3, 12, 24))),
            window_size=p.get("window_size", 8),
            mlp_ratio=p.get("mlp_ratio", 3),
            qkv_bias=p.get("qkv_bias", True),
        )
        return cls(ori_size=tuple(p.get("ori_size", (360, 640))), swin=swin)
