"""DGM diffusion trainer on the card (the JAX package's
``train/dgm_trainer.py``; reference: the accelerate ``Trainer`` of
denoising_diffusion_pytorch.py).

One step: the diffusion loss and its gradients over
``gradient_accumulate_every`` microbatches (summed, then divided), the
global-norm clip in optax's form (``max_norm / max(norm, max_norm)``), Adam
(b1 0.9, b2 0.99, eps 1e-8), then the EMA update.  Parameters stay fp32;
with ``config.bf16`` the UNet's activations are bf16.  On the card each
UNet forward runs the linear-attention kernels at its eight sites under
``LinearAttentionFunction`` (16 launches each with ``unet.remat``).

Checkpoints take the reference layout ``{step, model, opt, ema, scaler,
version}`` at ``<results_dir>/model-<step>.pt``: ``model`` holds
``model.<UNet key>``, ``ema`` holds ``ema_model.model.<UNet key>``, ``step``
and ``initted``, ``opt`` is Adam's state dict and ``scaler`` None, so the
file loads in ``models/convert.py::load_dgm_checkpoint`` and
``dgm_sample --torch-ckpt``.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import re
from typing import Iterator, Optional

import torch

from dmhomo_torch.diffusion.gaussian import GaussianDiffusion
from dmhomo_torch.models.convert import (
    DGM_EMA_SKIPS,
    DGM_MODEL_SKIPS,
    _unet_part,
    unet_state_dict_from_jax,
)
from dmhomo_torch.models.unet import build_unet
from dmhomo_torch.train.config import DGMTrainConfig
from dmhomo_torch.train.ema import ema_init, ema_update
from dmhomo_torch.utils.checkpoint import atomic_save
from dmhomo_torch.utils.device import resolve_device

CHECKPOINT_VERSION = "dmhomo_torch"
KEEP_CHECKPOINTS = 3  # the newest files kept under results_dir, as the JAX trainer keeps
_CKPT_NAME = re.compile(r"^model-(\d+)\.pt$")


class DGMTrainer:
    """Trains the DGM UNet on ``device`` (default: the CUDA card; raises
    without one)."""

    def __init__(self, config: DGMTrainConfig = DGMTrainConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        unet = config.unet
        if config.bf16 and unet.dtype != torch.bfloat16:
            unet = dataclasses.replace(unet, dtype=torch.bfloat16)
        self.unet_config = unet
        self.logger = logging.getLogger("dmhomo_torch.dgm")
        self.model = None
        self.step = 0

    # -- state --------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None):
        """A new UNet with weights drawn from ``torch.Generator().manual_seed(seed)``
        (default ``config.seed``), a fresh Adam, the EMA at the weights, step 0."""
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        self.model = build_unet(self.unet_config, device="cpu", generator=gen)
        self.model.to(self.device).train()
        self.gd = GaussianDiffusion(self.model, cfg.diffusion, device=self.device)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                          betas=(cfg.adam_b1, cfg.adam_b2), eps=1e-8)
        self.ema = ema_init(self.model.parameters())
        self.step = 0
        return self.model

    def load_params(self, params: dict) -> None:
        """Weights carried from the JAX package's UNet ``params`` tree; the
        EMA restarts at them, as the JAX ``ema_init`` of fresh params."""
        if self.model is None:
            self.init_state()
        sd = unet_state_dict_from_jax(params, self.unet_config)
        self.model.load_state_dict(sd, strict=True)
        self.ema = ema_init(self.model.parameters())

    # -- step ---------------------------------------------------------------

    def _microbatches(self, batch_img, classes):
        """(conditions, classes) of each microbatch on the device; the tail
        past ``accum * (B // accum)`` is dropped, as the JAX step drops it."""
        accum = self.config.gradient_accumulate_every
        dev = self.device
        batch_img = torch.as_tensor(batch_img, dtype=torch.float32).to(dev)
        classes = torch.as_tensor(classes, dtype=torch.long).to(dev)
        mb = batch_img.shape[0] // accum
        if mb == 0:
            raise ValueError(f"batch of {batch_img.shape[0]} < {accum} microbatches")
        return [(batch_img[a * mb:(a + 1) * mb], classes[a * mb:(a + 1) * mb])
                for a in range(accum)]

    def loss_and_grads(self, batch_img, classes, generator: Optional[torch.Generator] = None,
                       draws=None) -> torch.Tensor:
        """The step's loss (mean over the microbatches, a 0-d tensor on the
        device) with the gradients left in each parameter's ``.grad``: each
        microbatch's summed, then divided by their count.  ``draws`` injects
        one (t, noise, keep_mask) per microbatch; otherwise they come from
        ``generator``."""
        micro = self._microbatches(batch_img, classes)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=self.device)
        for a, (b, c) in enumerate(micro):
            loss = self.gd.loss(b, c, generator, None if draws is None else draws[a])
            loss.backward()
            total += loss.detach()
        if len(micro) > 1:
            torch._foreach_div_([p.grad for p in self.model.parameters()], float(len(micro)))
        return total / len(micro)

    def apply_gradients(self) -> dict:
        """The update from the gradients in ``.grad``: the global-norm clip,
        Adam, the EMA; counts the step.  Returns the gradients' global norm
        and the clip's scale (0-d tensors on the device)."""
        cfg = self.config
        grads = [p.grad for p in self.model.parameters()]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = cfg.grad_clip_norm / torch.clamp(norm, min=cfg.grad_clip_norm)
        torch._foreach_mul_(grads, scale)
        self.optimizer.step()
        ema_update(self.ema, self.model.parameters(), beta=cfg.ema_beta,
                   update_every=cfg.ema_update_every)
        self.step += 1
        return {"grad_norm": norm, "clip_scale": scale}

    def train_step(self, batch_img, classes, generator: Optional[torch.Generator] = None,
                   draws=None) -> dict:
        """One optimizer step on a (B, S, S, 12) condition batch in [0, 1]
        and (B,) classes; returns the loss, the gradients' global norm and
        the clip's scale (0-d tensors on the device, not synchronised)."""
        loss = self.loss_and_grads(batch_img, classes, generator, draws)
        return {"loss": loss, **self.apply_gradients()}

    # -- loop ---------------------------------------------------------------

    def train(self, batches: Iterator, num_steps: Optional[int] = None,
              save_every: Optional[int] = None, log_every: int = 50):
        """Steps until ``num_steps`` (default ``train_num_steps``) on
        ``(conditions, classes)`` batches, the draws from a generator on the
        device seeded with ``seed + 1``; saves every ``save_every`` steps.
        Returns the last step's metrics."""
        cfg = self.config
        num_steps = num_steps or cfg.train_num_steps
        save_every = save_every or cfg.save_every
        if self.model is None:
            self.init_state()
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        out = None
        while self.step < num_steps:
            batch_img, classes = next(batches)
            out = self.train_step(batch_img, classes, generator=gen)
            if self.step % log_every == 0:
                self.logger.info(f"step {self.step}/{num_steps} loss {float(out['loss']):.4f}")
            if self.step % save_every == 0:
                self.save()
        return out

    # -- sampling -----------------------------------------------------------

    def sample(self, classes, rgb_flow, mask, use_ema: bool = True, cond_scale=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM sampling (``GaussianDiffusion.sample``, rgb_flow in [0, 1])
        with the EMA or the online weights; images (B, S, S, 6) in [0, 1]."""
        model = self.model
        if use_ema:
            model = copy.deepcopy(self.model)
            with torch.no_grad():
                for p, e in zip(model.parameters(), self.ema.params):
                    p.copy_(e)
        model.eval()
        gd = GaussianDiffusion(model, self.config.diffusion, device=self.device)
        try:
            return gd.sample(classes, rgb_flow, mask, cond_scale=cond_scale, generator=generator)
        finally:
            self.model.train()

    # -- checkpoints --------------------------------------------------------

    def state_dict(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        ema = {f"ema_model.model.{n}": e.detach().cpu() for n, e in zip(names, self.ema.params)}
        ema["step"] = torch.tensor(self.ema.step)
        ema["initted"] = torch.tensor(True)
        return {"step": self.step,
                "model": {f"model.{k}": v.detach().cpu() for k, v in self.model.state_dict().items()},
                "opt": self.optimizer.state_dict(),
                "ema": ema, "scaler": None, "version": CHECKPOINT_VERSION}

    def load_state_dict(self, ckpt: dict) -> None:
        """Weights, Adam, EMA and step from a checkpoint in the reference
        layout (the port's, or a reference DGM.pt's with its schedule
        buffers and EMA bookkeeping)."""
        if self.model is None:
            self.init_state()
        sd = _unet_part(ckpt["model"], "model.", DGM_MODEL_SKIPS, "DGM checkpoint 'model'")
        self.model.load_state_dict(sd, strict=True)
        self.optimizer.load_state_dict(ckpt["opt"])
        ema = _unet_part(ckpt["ema"], "ema_model.model.", DGM_EMA_SKIPS, "DGM checkpoint 'ema'")
        self.ema = ema_init(ema[n] for n, _ in self.model.named_parameters())
        self.ema.params = [e.to(self.device) for e in self.ema.params]
        self.ema.step = int(ckpt["ema"].get("step", 0))
        self.step = int(ckpt["step"])

    def save(self, root: Optional[str] = None) -> str:
        """``<root>/model-<step>.pt`` (default root ``results_dir``), written
        atomically; keeps the newest KEEP_CHECKPOINTS files."""
        root = root or self.config.results_dir
        path = atomic_save(self.state_dict(), os.path.join(root, f"model-{self.step}.pt"))
        for old in sorted(checkpoint_steps(root))[:-KEEP_CHECKPOINTS]:
            os.remove(os.path.join(root, f"model-{old}.pt"))
        self.logger.info(f"saved checkpoint at step {self.step}: {path}")
        return path

    def load(self, root: Optional[str] = None, step: Optional[int] = None) -> str:
        """Restore ``<root>/model-<step>.pt`` (default: the newest)."""
        root = root or self.config.results_dir
        steps = checkpoint_steps(root)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {root}")
        path = os.path.join(root, f"model-{max(steps) if step is None else step}.pt")
        self.load_state_dict(torch.load(path, map_location="cpu", weights_only=False))
        self.logger.info(f"restored step {self.step} from {path}")
        return path


def checkpoint_steps(root: str) -> list:
    """Steps of the ``model-<step>.pt`` files under ``root``."""
    if not os.path.isdir(root):
        return []
    return [int(m.group(1)) for m in map(_CKPT_NAME.match, os.listdir(root)) if m]
