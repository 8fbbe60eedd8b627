"""HEM losses (the JAX package's ``losses/hem_losses.py``; reference
HEM/loss/losses.py).

* :func:`nll_laplace` - Laplace negative log likelihood with the mask as
  log-variance: ``sqrt(2) * exp(-0.5 lv) * |dflow| + 0.5 lv``, the mean over
  the finite (and masked-in) entries; the estimator's ``1 - mask`` feeds lv.
* :func:`mask_bce_loss` - BCE of the mask against a vertical linear-gradient
  target (constant 0 with the shipped weight (1, 1)).
* :func:`compute_losses` - total = sup * L1(mask*flow, mask*flow_gt)
  + mask_reg * BCE + unsup * L1(mask*feat, mask*warped feat) + nll * NLL,
  both directions.  Stage 1 runs nll only; stage 2 adds sup.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from dmhomo_torch.parallel.distributed import all_reduce_, is_distributed, rank_and_world


@dataclasses.dataclass(frozen=True)
class LossWeights:
    sup: float = 0.0
    unsup: float = 0.0
    mask_reg: float = 0.0
    nll: float = 1.0
    normalize_mask: bool = False  # both directions take mask_fusion


def nll_laplace(gt_flow: torch.Tensor, est_flow: torch.Tensor, log_var: torch.Tensor,
                mask: "torch.Tensor | None" = None) -> torch.Tensor:
    """Mean Laplace NLL over the finite entries (and ``mask``, a bool tensor).

    gt_flow / est_flow (B, H, W, 2); log_var (B, H, W, 1).  Non-finite
    entries count neither in the sum nor in the count (at least 1).

    Under a process group the count is that of every rank's entries (one
    ``all_reduce``), and the value is ``world`` times this rank's sum over
    it: its mean over the ranks, as every other loss term's, is the global
    batch's value, and the step's gradient all-reduce (a sum, divided by
    ``world``) gives the gradient of the global mean.
    """
    loss = math.sqrt(2.0) * torch.exp(-0.5 * log_var) * (gt_flow - est_flow).abs()
    loss = loss + 0.5 * log_var
    valid = torch.isfinite(loss)
    if mask is not None:
        valid = valid & mask
    total = torch.where(valid, loss, torch.zeros_like(loss)).sum()
    count = valid.sum()
    if is_distributed():
        all_reduce_(count)
        return total / count.clamp(min=1) * rank_and_world()[1]
    return total / count.clamp(min=1)


def mask_bce_loss(mask: torch.Tensor, weight=(1.0, 1.0), eps: float = 1e-7) -> torch.Tensor:
    """BCE of ``mask`` (B, H, W, 1) against the target
    ``(weight[1] - weight[0]) * row / H + weight[0] - 1``."""
    H = mask.shape[1]
    rows = torch.arange(H, dtype=torch.float32, device=mask.device)
    target = ((weight[1] - weight[0]) * rows / H + weight[0] - 1.0)[None, :, None, None]
    m = mask.clamp(eps, 1.0 - eps)
    return (-(target * torch.log(m) + (1.0 - target) * torch.log(1.0 - m))).mean()


def _l1(a, b):
    return (a - b).abs().mean()


def compute_losses(batch: dict, outputs: dict, weights: LossWeights) -> dict:
    """Loss terms and their total from a train batch and estimator outputs.

    ``batch["flow_gt_patch"]`` (B, H, W, 4): backward flow in channels 0-1,
    forward flow in 2-3 (the reference's channel order).
    """
    flow_gt = batch["flow_gt_patch"]
    flow_b_gt, flow_f_gt = flow_gt[..., :2], flow_gt[..., 2:]
    flow_b, flow_f = outputs["flow_b"], outputs["flow_f"]
    mask_b, mask_f = outputs["mask_b"], outputs["mask_f"]
    if weights.normalize_mask:
        mask_b = mask_f = outputs["mask_fusion"]
    feats = outputs["fil_features"]

    loss = {}
    loss["unsup"] = weights.unsup * (
        _l1(mask_f * feats["img1_patch_fea"], mask_f * feats["img2_patch_fea_warp"])
        + _l1(mask_b * feats["img2_patch_fea"], mask_b * feats["img1_patch_fea_warp"]))
    loss["mask_reg"] = weights.mask_reg * (mask_bce_loss(mask_b) + mask_bce_loss(mask_f))
    loss["nll"] = weights.nll * (nll_laplace(flow_f_gt, flow_f, 1.0 - mask_f)
                                 + nll_laplace(flow_b_gt, flow_b, 1.0 - mask_b))
    loss["supervise"] = weights.sup * (
        _l1(mask_b * flow_b, mask_b * flow_b_gt) + _l1(mask_f * flow_f, mask_f * flow_f_gt))
    loss["total"] = loss["supervise"] + loss["mask_reg"] + loss["unsup"] + loss["nll"]
    return loss
