"""HEM homography estimator (the reference's OSNet with the "HomoGAN" config).

* ``fea_extra``: shared 3-conv (1 -> 4 -> 8 -> 1, BN + ReLU) feature extractor;
* ``h_net`` = SwinTransformer -> 8 basis weights; flow = sum_k w_k basis_k,
  run forward and then with the inputs swapped;
* ``mask_generator``: DenseNet-style concat-growth mask head on
  (feat1, warp(feat2)) pairs;
* mask fusion = clamp(warp(mask_b, flow_f), 0, 1) * mask_f, then a
  whole-batch min / absmax normalization.

``upsample_outputs`` gives the full-resolution eval view.  Public layouts
are NHWC: input (B, hp, wp, 2), flows (B, h, w, 2), masks (B, h, w, 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dmhomo_torch.config import EstimatorConfig
from dmhomo_torch.geometry.warp import resize_nearest, upsample_flow_to, warp_by_flow
from dmhomo_torch.models.swin import BatchNorm2d, SwinTransformer
from dmhomo_torch.utils.device import resolve_device


class SharedFeatureExtractor(nn.Sequential):
    """1 -> 4 -> 8 -> 1 conv + BN + ReLU stack; NHWC in and out."""

    def __init__(self):
        layers = []
        cin = 1
        for ch in (4, 8, 1):
            layers += [nn.Conv2d(cin, ch, 3, padding=1, bias=False),
                       BatchNorm2d(ch, eps=1e-5), nn.ReLU()]
            cin = ch
        super().__init__(*layers)

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class FlowMaskEstimator(nn.Module):
    """DenseNet-style concat-growth mask head: (B, h, w, 2) -> (B, h, w, 1)."""

    def __init__(self):
        super().__init__()
        cin = 2  # (feat1, warped feat2)
        f_channels = (8, 16, 32, 16, 8)
        for i, ch in enumerate(f_channels):
            self.add_module(f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(cin, ch, 3, padding=1), nn.LeakyReLU(0.1)))
            cin += ch
        self.n_convs = len(f_channels)
        self.conv_last = nn.Sequential(nn.Conv2d(cin, 1, 3, padding=1))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        if torch.is_autocast_enabled(x.device.type):  # the concat growth in the compute dtype
            x = x.to(torch.get_autocast_dtype(x.device.type))
        for i in range(self.n_convs):
            x = torch.cat([getattr(self, f"conv{i + 1}")(x), x], dim=1)
        return torch.sigmoid(self.conv_last(x).float()).permute(0, 2, 3, 1)


def _normalize_fusion(mask_fusion: torch.Tensor) -> torch.Tensor:
    """Whole-batch min / absmax normalization."""
    return (mask_fusion - mask_fusion.min()) / mask_fusion.abs().max()


class HomographyEstimator(nn.Module):
    """Forward and backward homography flows and uncertainty masks.

    Input: (B, hp, wp, 2) normalized grayscale pair.  Returns the
    patch-resolution outputs; :func:`upsample_outputs` gives the eval view.
    """

    def __init__(self, config: EstimatorConfig = EstimatorConfig()):
        super().__init__()
        self.config = config
        self.fea_extra = SharedFeatureExtractor()
        self.h_net = SwinTransformer(config.swin)
        self.mask_generator = FlowMaskEstimator()

    def forward(self, imgs_gray_patch: torch.Tensor) -> dict:
        f1 = self.fea_extra(imgs_gray_patch[..., :1])
        f2 = self.fea_extra(imgs_gray_patch[..., 1:2])
        w_f = self.h_net(torch.cat([f1, f2], dim=-1))
        w_b = self.h_net(torch.cat([f2, f1], dim=-1))
        flow_f = self.h_net.flow(w_f)
        flow_b = self.h_net.flow(w_b)
        f2_warp = warp_by_flow(f2, flow_f, mode="collapse")
        f1_warp = warp_by_flow(f1, flow_b, mode="collapse")
        mask_f = self.mask_generator(torch.cat([f1, f2_warp], dim=-1))
        mask_b = self.mask_generator(torch.cat([f2, f1_warp], dim=-1))
        mask_b_warp = warp_by_flow(mask_b, flow_f, mode="collapse").clamp(0.0, 1.0)
        return {
            "flow_f": flow_f,
            "flow_b": flow_b,
            "mask_f": mask_f,
            "mask_b": mask_b,
            "mask_fusion": _normalize_fusion(mask_b_warp * mask_f),
            "weight_f": w_f,
            "weight_b": w_b,
            "fil_features": {
                "img1_patch_fea": f1,
                "img2_patch_fea": f2,
                "img1_patch_fea_warp": f1_warp,
                "img2_patch_fea_warp": f2_warp,
            },
        }


def upsample_outputs(outputs: dict, full_hw) -> dict:
    """Eval-resolution view: flows bilinear-upsampled with magnitude rescale,
    masks nearest, fusion recomputed and renormalized at full resolution."""
    flow_f = upsample_flow_to(outputs["flow_f"], full_hw)
    flow_b = upsample_flow_to(outputs["flow_b"], full_hw)
    mask_f = resize_nearest(outputs["mask_f"], full_hw)
    mask_b = resize_nearest(outputs["mask_b"], full_hw)
    mask_b_warp = warp_by_flow(mask_b, flow_f, mode="collapse").clamp(0.0, 1.0)
    return {
        **outputs,
        "flow_f": flow_f,
        "flow_b": flow_b,
        "mask_f": mask_f,
        "mask_b": mask_b,
        "mask_fusion": _normalize_fusion(mask_b_warp * mask_f),
    }


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight from ``generator`` (on the CPU, then copied in):
    conv / linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    position-bias tables and query tokens N(0, 0.02).  Norm gains, layer
    scales, BN statistics and the basis keep their constructed values."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("relative_position_bias_table", "query_token"):
            new = torch.randn(p.shape, generator=generator) * 0.02
        elif leaf == "weight" and p.dim() > 1:
            bound = 1.0 / math.sqrt(p[0].numel())
            new = (torch.rand(p.shape, generator=generator) * 2 - 1) * bound
        elif leaf == "bias" and not _is_norm(model, name):
            new = (torch.rand(p.shape, generator=generator) * 2 - 1) * 0.05
        else:
            continue
        p.copy_(new.to(p.dtype))
    return model


def _is_norm(model: nn.Module, param_name: str) -> bool:
    module = model.get_submodule(param_name.rsplit(".", 1)[0])
    return isinstance(module, (nn.LayerNorm, nn.BatchNorm2d))


def build_estimator(config: EstimatorConfig = EstimatorConfig(), device=None,
                    generator: "torch.Generator | None" = None) -> HomographyEstimator:
    """The estimator in eval mode on ``device`` (default: the CUDA card; raises
    without one).  With ``generator``, weights are drawn from it."""
    dev = resolve_device(device)
    model = HomographyEstimator(config)
    if generator is not None:
        random_init_(model, generator)
    return model.eval().to(dev)
