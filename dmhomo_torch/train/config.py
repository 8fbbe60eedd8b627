"""Training configs (the JAX package's ``train/config.py``): DGM diffusion
training (``DGMTrainConfig``, reference DGM/demo.py) and HEM training
(``HEMTrainConfig``; reference HEM/experiments/params.json and its stage2
variant), and how the HEM trainer resolves its ``attn_impl`` and ``remat``
as the JAX trainer does, with the port's ``'cuda'`` in the place of JAX's
``'tpu'`` backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from dmhomo_torch.config import EstimatorConfig, Params
from dmhomo_torch.diffusion.gaussian import DiffusionConfig
from dmhomo_torch.losses.hem_losses import LossWeights
from dmhomo_torch.models.unet import UNetConfig


@dataclasses.dataclass(frozen=True)
class DGMTrainConfig:
    """DGM diffusion training: Adam(lr, betas (adam_b1, adam_b2)) after a
    global-norm clip, an EMA of the weights, ``gradient_accumulate_every``
    microbatches per step of the global ``train_batch_size``.  ``bf16``
    runs the UNet's activations in bf16 (parameters stay fp32).  One card:
    the JAX config's ``shard_params`` waits for the parallel layer."""

    unet: UNetConfig = UNetConfig(dim=64, num_classes=5)
    diffusion: DiffusionConfig = DiffusionConfig(
        image_size=256, timesteps=1000, sampling_timesteps=32,
        objective="pred_x0", loss_type="l1")
    train_batch_size: int = 128  # global
    lr: float = 5e-4
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    train_num_steps: int = 112_500  # 450k pairs x 32 epochs / bs 128
    gradient_accumulate_every: int = 1
    grad_clip_norm: float = 1.0
    ema_beta: float = 0.995
    ema_update_every: int = 10
    save_every: int = 500
    sample_every: int = 1000
    results_dir: str = "results"
    seed: int = 0
    bf16: bool = True


@dataclasses.dataclass(frozen=True)
class HEMTrainConfig:
    """HEM estimator training: Adam with a per-epoch staircase ExponentialLR,
    eval every ``train_num_steps``.

    ``bf16`` runs the forward under bf16 autocast (parameters, BatchNorm and
    the losses stay fp32).  ``grad_accum`` splits each batch into that many
    microbatches (BatchNorm statistics per microbatch, one optimizer step);
    it is clamped to what divides the batch.  ``attn_impl`` 'auto' is the
    window-attention kernel ('pallas') on the card and 'xla' on the CPU;
    'xla', 'pallas', 'fused_block' or a per-level spec force the choice;
    None keeps ``estimator.swin.attn_impl``.  ``remat`` 'auto' recomputes
    each Swin block in the backward unless the impl is 'pallas' and
    ``grad_accum`` >= 4.
    """

    estimator: EstimatorConfig = EstimatorConfig()
    loss: LossWeights = LossWeights(sup=0.0, unsup=0.0, mask_reg=0.0, nll=1.0)
    lr: float = 1e-4
    gamma: float = 0.8  # ExponentialLR decay per epoch
    train_batch_size: int = 32
    eval_batch_size: int = 32
    num_epochs: int = 10
    train_num_steps: int = 2000  # eval cadence
    rho: int = 16
    major_metric: str = "AVG"
    model_dir: str = "experiments/hem"
    seed: int = 0
    bf16: bool = True
    remat: Union[bool, str] = "auto"
    grad_accum: int = 4
    attn_impl: Optional[str] = "auto"

    @staticmethod
    def stage2(**overrides) -> "HEMTrainConfig":
        """Stage 2: + the mask-weighted supervised L1."""
        base = dict(loss=LossWeights(sup=1.0, nll=1.0))
        base.update(overrides)
        return HEMTrainConfig(**base)

    @classmethod
    def from_params(cls, params: Params, **overrides) -> "HEMTrainConfig":
        """From a reference-format params.json."""
        p = params.dict
        loss = LossWeights(
            sup=p.get("sup_loss_weight", 0.0),
            unsup=p.get("unsup_loss_weight", 0.0),
            mask_reg=p.get("mask_reg_loss_weight", 0.0),
            nll=p.get("mask_nll_loss_weight", 1.0),
            normalize_mask=p.get("normalize_mask", False),
        )
        kw = dict(
            estimator=EstimatorConfig.from_params(params),
            loss=loss,
            lr=p.get("learning_rate", 1e-4),
            gamma=p.get("gamma", 0.8),
            train_batch_size=p.get("train_batch_size", 32),
            eval_batch_size=p.get("eval_batch_size", 32),
            num_epochs=p.get("num_epochs", 10),
            train_num_steps=p.get("train_num_steps", 2000),
            rho=p.get("rho", 16),
            major_metric=p.get("major_metric", "AVG"),
        )
        kw.update(overrides)
        return cls(**kw)


def resolve_attn_impl(requested: Optional[str], device_type: str) -> Optional[str]:
    """'auto' -> 'pallas' (the window-attention kernel) on the card, 'xla'
    on the CPU, as the JAX trainer resolves it on TPU and CPU; other values,
    and None (keep the Swin config's), pass through."""
    if requested != "auto":
        return requested
    return "pallas" if device_type == "cuda" else "xla"


def resolve_remat(requested: Union[bool, str], attn_impl: Optional[str], grad_accum: int) -> bool:
    """'auto' -> off only for ``attn_impl == 'pallas'`` (the whole spec) with
    ``grad_accum`` >= 4, where a microbatch's saved activations fit; on
    otherwise.  Booleans pass through."""
    if requested != "auto":
        return bool(requested)
    return not (attn_impl == "pallas" and grad_accum >= 4)


def estimator_for_training(config: HEMTrainConfig, device_type: str) -> EstimatorConfig:
    """The estimator config with ``attn_impl`` and ``remat`` resolved into
    its Swin config for a trainer on ``device_type`` ('cuda' or 'cpu')."""
    est = config.estimator
    swin = est.swin
    impl = resolve_attn_impl(config.attn_impl, device_type)
    if impl is not None and swin.attn_impl != impl:
        swin = dataclasses.replace(swin, attn_impl=impl)
    if resolve_remat(config.remat, swin.attn_impl, config.grad_accum) and not swin.remat:
        swin = dataclasses.replace(swin, remat=True)
    return dataclasses.replace(est, swin=swin)
