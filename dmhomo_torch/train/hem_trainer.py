"""HEM estimator trainer on the card (the JAX package's
``train/hem_trainer.py``; reference HEM/train.py and common/manager.py).

Adam with a staircase ExponentialLR (``lr * gamma ** (k // steps_per_epoch)``
for step k, counted from 0 as optax counts), the loss of
``compute_losses`` under the stage's weights, microbatch gradient
accumulation with BatchNorm statistics per microbatch, bf16 autocast, eval
every ``train_num_steps`` with best tracking on the major metric, and
checkpoints in the reference Manager layout.  On the card every window
attention of the step runs the CUDA forward and backward kernels; with
``attn_impl='fused_block'`` every Swin block runs the whole-block forward
and backward kernels instead.
"""

from __future__ import annotations

import logging
from typing import Iterator, Optional

import torch

from dmhomo_torch.cli.hem_eval import eval_forward
from dmhomo_torch.data.hem_data import device_build_patches
from dmhomo_torch.data.loader import pad_batch
from dmhomo_torch.evaluation.metrics import bucket_by_category, category_report
from dmhomo_torch.losses.hem_losses import compute_losses
from dmhomo_torch.models.convert import estimator_state_dict_from_jax
from dmhomo_torch.models.estimator import HomographyEstimator, random_init_
from dmhomo_torch.train.config import HEMTrainConfig, estimator_for_training
from dmhomo_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dmhomo_torch.utils.device import resolve_device
from dmhomo_torch.utils.meters import MetricTracker

RAW_KEYS = ("img12", "homo", "homo_inv", "start")


class HEMTrainer:
    """Trains the estimator on ``device`` (default: the CUDA card; raises
    without one)."""

    def __init__(self, config: HEMTrainConfig, steps_per_epoch: Optional[int] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.steps_per_epoch = steps_per_epoch or config.train_num_steps
        self.logger = logging.getLogger("dmhomo_torch.hem")
        self.metrics = MetricTracker(config.major_metric)
        self.model: Optional[HomographyEstimator] = None
        self.step = 0
        self.epoch = 0

    # -- state --------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> HomographyEstimator:
        """A new model with weights drawn from ``torch.Generator().manual_seed(seed)``
        (default ``config.seed``), a fresh optimizer and LR staircase, step 0."""
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        est = estimator_for_training(cfg, self.device.type)
        self.model = random_init_(HomographyEstimator(est), gen)
        self.model.to(self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        spe, gamma = self.steps_per_epoch, cfg.gamma
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda k: gamma ** (k // spe))
        self.step = 0
        self.epoch = 0
        return self.model

    def load_params(self, params: dict, batch_stats: dict) -> None:
        """Weights carried from the JAX package's ``params`` / ``batch_stats``
        trees (nested dicts of arrays)."""
        if self.model is None:
            self.init_state()
        sd = estimator_state_dict_from_jax(params, batch_stats, self.model.config)
        self.model.load_state_dict(sd, strict=True)

    @property
    def lr(self) -> float:
        """The learning rate of the next step."""
        return self.optimizer.param_groups[0]["lr"]

    # -- train step ---------------------------------------------------------

    def _device_batch(self, batch: dict) -> dict:
        dev = self.device
        if "img12" in batch:  # raw schema: the batch is built on the device
            est = self.config.estimator
            raw = {k: torch.as_tensor(batch[k]).to(dev) for k in RAW_KEYS}
            return device_build_patches(raw["img12"], raw["homo"], raw["homo_inv"],
                                        raw["start"], est.crop_size, est.ori_size)
        return {k: torch.as_tensor(batch[k]).to(dev)
                for k in ("imgs_gray_patch", "flow_gt_patch")}

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a batch of either schema; returns the loss
        terms (0-d tensors on the device, means over the microbatches)."""
        cfg = self.config
        batch = self._device_batch(batch)
        imgs, flows = batch["imgs_gray_patch"], batch["flow_gt_patch"]
        B = imgs.shape[0]
        # one card: the per-device batch is the batch
        accum = min(cfg.grad_accum, B)
        while accum > 1 and B % accum:
            accum -= 1
        mb = B // accum
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        sums: dict = {}
        for a in range(accum):
            sl = slice(a * mb, (a + 1) * mb)
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=cfg.bf16):
                outputs = self.model(imgs[sl])
            losses = compute_losses({"flow_gt_patch": flows[sl]}, outputs, cfg.loss)
            (losses["total"] / accum).backward()
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        # epoch-equivalent counter: the reference's per-epoch ExponentialLR
        self.epoch = self.step // self.steps_per_epoch
        return {k: v / accum for k, v in sums.items()}

    # -- eval ---------------------------------------------------------------

    def evaluate(self, eval_batches: Iterator, split: str = "val") -> dict:
        """Point-matching error per category over CAHomo-format batches."""
        cfg = self.config
        self.model.eval()
        self.metrics.reset(split)
        errs, names = [], []
        for batch in eval_batches:
            # one batch shape throughout: pad the tail, keep its valid rows
            batch, n_valid = pad_batch(batch, cfg.eval_batch_size)
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=cfg.bf16):
                e = eval_forward(self.model,
                                 torch.as_tensor(batch["imgs_gray_patch"]).to(self.device),
                                 torch.as_tensor(batch["pt_set"]).to(self.device),
                                 cfg.estimator.ori_size)
            errs.extend(e.float().cpu().numpy()[:n_valid].tolist())
            names.extend(batch["video_names"][:n_valid])
        report = category_report(bucket_by_category(errs, names))
        self.metrics.update(split, report)
        self.logger.info(f"[{split}] " + " ".join(f"{k}:{v:.4f}" for k, v in report.items()))
        return report

    # -- loop ---------------------------------------------------------------

    def train_and_evaluate(self, train_batches: Iterator, eval_loader=None,
                           total_steps: Optional[int] = None, log_every: int = 100):
        """Steps until ``total_steps`` (default ``num_epochs`` epochs); every
        ``train_num_steps`` steps, with an eval loader: evaluate, save
        ``latest``, and ``best`` when the major metric improved.  Returns the
        best report (None without evals)."""
        cfg = self.config
        if self.model is None:
            self.init_state()
        total_steps = total_steps or cfg.num_epochs * self.steps_per_epoch
        best_report = None
        while self.step < total_steps:
            losses = self.train_step(next(train_batches))
            if self.step % log_every == 0:
                self.logger.info(f"step {self.step}/{total_steps} " + " ".join(
                    f"{k}:{float(v):.4f}" for k, v in losses.items()))
            if eval_loader is not None and self.step % cfg.train_num_steps == 0:
                report = self.evaluate(iter(eval_loader))
                is_best = self.metrics.is_best("val")
                self.save(tag="latest")
                if is_best:
                    best_report = report
                    self.save(tag="best")
        return best_report

    # -- checkpoints --------------------------------------------------------

    def save(self, root: Optional[str] = None, tag: str = "latest") -> str:
        return save_checkpoint(root or self.config.model_dir, tag, {
            "state_dict": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
            "epoch": self.epoch,
        })

    def load(self, root: Optional[str] = None, tag: str = "latest",
             weights_only: bool = False) -> None:
        """Restore a checkpoint.  ``weights_only`` (the reference's ``-ow``)
        takes the weights and BatchNorm statistics only and keeps this
        trainer's optimizer, LR staircase and step: stage 2 restarts the
        schedule at ``config.lr``."""
        if self.model is None:
            self.init_state()
        ckpt = load_checkpoint(root or self.config.model_dir, tag)
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        if not weights_only:
            self.optimizer.load_state_dict(ckpt["optimizer"])
            self.scheduler.load_state_dict(ckpt["scheduler"])
            self.step = int(ckpt["step"])
            self.epoch = int(ckpt["epoch"])
