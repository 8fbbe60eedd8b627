"""BasesHomo, the reference's second HEM model family (the JAX package's
``models/baseshomo.py``; reference ``Net``, HEM/model/net.py:389-512).

* ``share_feature``: 3x conv + BN + ReLU (1 -> 4 -> 8 -> 1), shared by both
  images;
* a ResNet-34-style trunk on the two feature maps stacked: conv 7x7 s2, BN,
  LeakyReLU, max-pool 3x3 s2, BasicBlocks (3, 4, 6, 3) with LeakyReLU, a
  Subspace projection block after layer 3 and after layer 4;
* a grouped 1x1 conv (groups 8) and a global average pool: 8 numbers, the
  4-point corner offsets, turned into H by the exact 4-point DLT.  The trunk
  is built once and runs on (f1, f2), then on (f2, f1), for the forward and
  the backward homography.

Module names follow the reference ``Net``'s state-dict keys, so a reference
checkpoint loads with ``load_state_dict(strict=True)`` once its dead
``subspace_block`` and ``basis`` keys are dropped
(``models/convert.py::load_baseshomo_state_dict``).  Public tensors are
NHWC, convolutions run NCHW inside.  :func:`subspace_project` runs in fp32
(TF32 is off on the card, as the JAX code asks for ``precision=HIGHEST``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dmhomo_torch.config import EstimatorConfig
from dmhomo_torch.geometry.homography import dlt_solve_4pt
from dmhomo_torch.models.estimator import random_init_
from dmhomo_torch.models.swin import BatchNorm2d
from dmhomo_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class BasesHomoConfig:
    crop_size: tuple = (320, 576)
    layers: Sequence[int] = (3, 4, 6, 3)
    basis_vector_num: int = 16
    dtype: str = "float32"  # or "bfloat16": the convolutions under autocast


def _leaky(x):
    return F.leaky_relu(x, 0.01)


def subspace_project_nchw(x: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W), vectors (B, K, H, W) -> x projected onto the span of
    the L1-normalised basis maps, P = V (V^T V)^-1 V^T, in fp32."""
    B, C, H, W = x.shape
    K = vectors.shape[1]
    Vt = vectors.float().reshape(B, K, H * W)
    Vt = Vt / (1e-6 + Vt.abs().sum(dim=2, keepdim=True))
    proj = torch.linalg.solve(Vt @ Vt.transpose(1, 2), Vt)  # (B, K, HW) = (V^T V)^-1 V^T
    coef = proj @ x.float().reshape(B, C, H * W).transpose(1, 2)  # (B, K, C)
    return (Vt.transpose(1, 2) @ coef).transpose(1, 2).reshape(B, C, H, W)


def subspace_project(x: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """NHWC as the JAX function: x (B, H, W, C), vectors (B, H, W, K) ->
    (B, H, W, C)."""
    return subspace_project_nchw(x.permute(0, 3, 1, 2),
                                 vectors.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def vtv_condition(vectors: torch.Tensor) -> torch.Tensor:
    """cond(V^T V) per batch row of the normalised basis maps (B, K, H, W):
    how far :func:`subspace_project` amplifies a rounding."""
    B, K = vectors.shape[:2]
    Vt = vectors.float().reshape(B, K, -1)
    Vt = Vt / (1e-6 + Vt.abs().sum(dim=2, keepdim=True))
    return torch.linalg.cond(Vt @ Vt.transpose(1, 2))


class ShareFeature(nn.Module):
    """1 -> 4 -> 8 -> 1 conv + BN + ReLU, ``layers.{0,1,3,4,6,7}``; NCHW."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 1
        for ch in (4, 8, 1):
            layers += [nn.Conv2d(cin, ch, 3, padding=1, bias=False), BatchNorm2d(ch, eps=1e-5),
                       nn.ReLU()]
            cin = ch
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                                            BatchNorm2d(planes, eps=1e-5))

    def forward(self, x):
        y = _leaky(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return _leaky(y + residual)


class SubspaceBlock(nn.Module):
    """Three 1x1 convs (with bias) + BN, a residual from the first:
    ``conv{0,1,2}.0`` and ``bn{0,1,2}``."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        for i in range(3):
            self.add_module(f"conv{i}", nn.Sequential(
                nn.Conv2d(inplanes if i == 0 else planes, planes, 1)))
            self.add_module(f"bn{i}", BatchNorm2d(planes, eps=1e-5))

    def forward(self, x):
        r = _leaky(self.bn0(self.conv0(x)))
        y = _leaky(self.bn1(self.conv1(r)))
        return self.bn2(self.conv2(y)) + r


class Subspace(nn.Module):
    def __init__(self, inplanes: int, k: int = 16):
        super().__init__()
        self.Block = SubspaceBlock(inplanes, k)

    def forward(self, x):
        v = self.Block(x)
        with torch.autocast(x.device.type, enabled=False):  # the solve in fp32
            return subspace_project_nchw(x, v)


class BasesHomoNet(nn.Module):
    """4-point homography regressor with motion-basis subspace projection:
    ``imgs_gray_patch`` (B, ph, pw, 2) -> {homo_f, homo_b (B, 3, 3),
    offset_f, offset_b (B, 8)}."""

    def __init__(self, config: BasesHomoConfig = BasesHomoConfig()):
        super().__init__()
        self.config = config
        self.share_feature = ShareFeature()
        self.conv1 = nn.Conv2d(2, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), config.layers)):
            blocks = []
            for bi in range(n):
                blocks.append(BasicBlock(inplanes, planes, 2 if bi == 0 and li > 0 else 1))
                inplanes = planes
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.sp_layer3 = Subspace(256, config.basis_vector_num)
        self.sp_layer4 = Subspace(512, config.basis_vector_num)
        self.conv_last = nn.Conv2d(512, 8, 1, groups=8, bias=False)

    def stem(self, x):
        """conv1, BN, LeakyReLU, max-pool: (B, 2, H, W) NCHW."""
        return F.max_pool2d(_leaky(self.bn1(self.conv1(x))), 3, 2, 1)

    def trunk(self, x):
        """The stem, layers 1-4 with the Subspace blocks, conv_last and the
        global average pool: (B, 2, H, W) -> (B, 8)."""
        x = self.layer3(self.layer2(self.layer1(self.stem(x))))
        x = self.sp_layer4(self.layer4(self.sp_layer3(x)))
        with torch.autocast(x.device.type, enabled=False):
            return self.conv_last(x.float()).mean(dim=(2, 3))

    def forward(self, imgs_gray_patch: torch.Tensor) -> dict:
        B, ph, pw, _ = imgs_gray_patch.shape
        x = imgs_gray_patch.permute(0, 3, 1, 2)
        bf16 = self.config.dtype == "bfloat16"
        with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
            f1 = self.share_feature(x[:, :1])
            f2 = self.share_feature(x[:, 1:2])
            # two passes of the one trunk: in training mode a batch of both
            # would mix their BatchNorm statistics
            offset_f = self.trunk(torch.cat([f1, f2], dim=1))
            offset_b = self.trunk(torch.cat([f2, f1], dim=1))
        corners = torch.tensor([[0, 0], [pw - 1, 0], [0, ph - 1], [pw - 1, ph - 1]],
                               dtype=torch.float32, device=x.device)
        h4pt = corners[None].expand(B, 4, 2)
        return {"homo_f": dlt_solve_4pt(h4pt, offset_f.reshape(B, 4, 2)),
                "homo_b": dlt_solve_4pt(h4pt, offset_b.reshape(B, 4, 2)),
                "offset_f": offset_f, "offset_b": offset_b}


def build_baseshomo(config: BasesHomoConfig = BasesHomoConfig(), device=None,
                    generator: "torch.Generator | None" = None) -> BasesHomoNet:
    """BasesHomoNet in eval mode on ``device`` (default: the CUDA card; raises
    without one).  With ``generator``, weights are drawn from it as
    ``models/estimator.py::random_init_`` draws them."""
    dev = resolve_device(device)
    model = BasesHomoNet(config)
    if generator is not None:
        random_init_(model, generator)
    return model.eval().to(dev)


def fetch_model(net_type: str, config=None, device=None,
                generator: "torch.Generator | None" = None) -> nn.Module:
    """Model-family dispatch (the reference's ``fetch_net``, net.py:1019-1026):
    ``"BasesHomo"`` or ``"HomoGAN"`` (the Swin estimator), in eval mode on
    ``device`` (default the card)."""
    if net_type == "BasesHomo":
        return build_baseshomo(config or BasesHomoConfig(), device, generator)
    if net_type == "HomoGAN":
        from dmhomo_torch.models.estimator import build_estimator

        return build_estimator(config or EstimatorConfig(), device, generator)
    raise NotImplementedError(net_type)
