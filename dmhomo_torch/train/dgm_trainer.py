"""DGM diffusion trainer on the card (the JAX package's
``train/dgm_trainer.py``; reference: the accelerate ``Trainer`` of
denoising_diffusion_pytorch.py).

One step: the diffusion loss and its gradients over
``gradient_accumulate_every`` microbatches (summed, then divided), the
global-norm clip in optax's form (``max_norm / max(norm, max_norm)``), Adam
(b1 0.9, b2 0.99, eps 1e-8; on the card ``capturable``, its LR a device
tensor), then the EMA update.  Parameters stay fp32; with ``config.bf16``
the UNet's activations are bf16.  On the card each UNet forward runs the
linear-attention kernels at its eight sites under
``LinearAttentionFunction`` (16 launches each with ``unet.remat``).

:meth:`DGMTrainer.train_steps` runs K steps per host call, as the JAX
trainer's scanned ``train_steps`` does: on the card each step is one replay
of a CUDA graph of the whole step (the draws of t, the noise and the CFG
keep-mask from the trainer's generator, every microbatch forward and
backward, the collectives, the clip, Adam and the EMA, whose decay the host
writes to the device before each replay).  :meth:`DGMTrainer.train` chunks
its steps as the JAX loop does, so that checkpoints and the milestone hook
(:meth:`DGMTrainer.save_preview` in ``dgm_train``) land on the exact step.

Checkpoints take the reference layout ``{step, model, opt, ema, scaler,
version}`` at ``<results_dir>/model-<step>.pt``: ``model`` holds
``model.<UNet key>``, ``ema`` holds ``ema_model.model.<UNet key>``, ``step``
and ``initted``, ``opt`` is Adam's state dict and ``scaler`` None, so the
file loads in ``models/convert.py::load_dgm_checkpoint``, ``dgm_sample
--ckpt`` and ``dgm_sample --torch-ckpt``.

Under a process group (``parallel/distributed.py``) the step is parallel
as the JAX step is over its ``('data', 'model')`` mesh
(``parallel/mesh.py``; by default every rank on ``data``): each rank's
batch is its data index's share of the global batch, microbatch by
microbatch (``parallel/mesh.py::shard_batch``), and one ``all_reduce``
over the data group sums the gradients and the loss before the clip, so
that the clip, Adam and the EMA see the global gradient; the weights start
from rank 0's, and only rank 0 writes checkpoints.  With
``config.shard_params`` and a ``model`` axis above 1 the stored state is
channel-sharded over it (``parallel/tp.py``): the step gathers the full
weights over the model group, runs the microbatches, sums the gradients
over the data group, clips by the norm of the whole gradient (the slices'
squares summed over the model group, the replicated leaves' once), and
runs Adam and the EMA on this rank's slices.  ``save`` and ``sample``
gather the slices; ``load`` cuts them from the file's full tensors.
Injected draws are the global microbatch's, of which each data index
takes its rows; draws from a generator in :meth:`DGMTrainer.train` come
from ``seed + 1 + data index``, so that the ranks of one model group, which
hold the same rows, draw the same noise, and the data indices' differ.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import re
from typing import Iterator, Optional

import numpy as np
import torch

from dmhomo_torch.diffusion.gaussian import GaussianDiffusion
from dmhomo_torch.models.convert import (
    DGM_EMA_SKIPS,
    DGM_MODEL_SKIPS,
    _unet_part,
    unet_state_dict_from_jax,
)
from dmhomo_torch.models.unet import build_unet
from dmhomo_torch.ops import linear_attention as la
from dmhomo_torch.parallel.distributed import (
    FlatGradients,
    broadcast_module_,
    check_group_unchanged,
    is_distributed,
    is_main_process,
)
from dmhomo_torch.parallel.mesh import make_mesh, shard_batch
from dmhomo_torch.parallel.tp import ShardedParams, channel_dims, channel_shardings
from dmhomo_torch.train.config import DGMTrainConfig
from dmhomo_torch.train.ema import ema_apply_, ema_init, ema_step_decay, ema_update
from dmhomo_torch.utils.checkpoint import atomic_save
from dmhomo_torch.utils.device import resolve_device

CHECKPOINT_VERSION = "dmhomo_torch"
KEEP_CHECKPOINTS = 3  # the newest files kept under results_dir, as the JAX trainer keeps
_CKPT_NAME = re.compile(r"^model-(\d+)\.pt$")
# the kernel wrappers a DGM step launches, each counting its launches
LAUNCH_COUNTERS = (la.linear_attention_pass1, la.linear_attention_pass2)


@dataclasses.dataclass
class StepGraph:
    """One optimizer step captured as a CUDA graph: the batch shape and
    draws mode it was captured for, its static inputs (the batch, the
    classes, the injected draws or None), its loss output, the generator
    whose state it advances (None: the default one), and the kernel
    launches of one replay by wrapper name, as the wrappers counted them
    while the step was captured (a replay runs no Python)."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    img: torch.Tensor
    classes: torch.Tensor
    draws: Optional[list]
    loss: torch.Tensor
    generator: Optional[torch.Generator]
    launches: dict


class DGMTrainer:
    """Trains the DGM UNet on ``device`` (default: the CUDA card; raises
    without one), over ``mesh`` (default: every rank of the process group on
    the ``data`` axis; one rank without a group)."""

    def __init__(self, config: DGMTrainConfig = DGMTrainConfig(), mesh=None, device=None):
        self.config = config
        self.device = resolve_device(device)
        unet = config.unet
        if config.bf16 and unet.dtype != torch.bfloat16:
            unet = dataclasses.replace(unet, dtype=torch.bfloat16)
        self.unet_config = unet
        self.logger = logging.getLogger("dmhomo_torch.dgm")
        self.mesh = make_mesh() if mesh is None else mesh
        self._grads: Optional[FlatGradients] = None  # under a process group
        self._shards: Optional[ShardedParams] = None  # shard_params over a model axis
        self.model = None
        self.step = 0
        # the captured step train_steps replays; one at a time, since each
        # holds a memory pool the size of a step's working memory
        self.step_graph: Optional[StepGraph] = None
        # the stream of the warm-up step before a capture: one per trainer,
        # since the libraries keep a workspace for each stream they meet
        self._warmup_stream = None

    # -- state --------------------------------------------------------------

    @property
    def masters(self) -> list:
        """The tensors Adam and the EMA hold, in the UNet's parameter order:
        this rank's slices of the sharded parameters, the others whole."""
        return list(self.model.parameters()) if self._shards is None else self._shards.masters

    def init_state(self, seed: Optional[int] = None):
        """A new UNet with weights drawn from ``torch.Generator().manual_seed(seed)``
        (default ``config.seed``), a fresh Adam, the EMA at the weights, step 0."""
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        self.model = build_unet(self.unet_config, device="cpu", generator=gen)
        self.model.to(self.device).train()
        self.gd = GaussianDiffusion(self.model, cfg.diffusion, device=self.device)
        if is_distributed():
            self._grads = FlatGradients(self.model.parameters(), 1)
        broadcast_module_(self.model)  # under a group, rank 0's weights on every rank
        self._shards = None
        if cfg.shard_params and self.mesh.model > 1:
            shapes = {n: tuple(p.shape) for n, p in self.model.named_parameters()}
            dims = channel_dims(self.model, unet_state_dict_from_jax, self.unet_config)
            self._shards = ShardedParams(
                self.model, channel_shardings(shapes, dims, self.mesh.model), self.mesh)
        cuda = self.device.type == "cuda"
        # capturable on the card: Adam keeps its step count there and reads
        # its LR from _lr_dev, so eager steps and graph replays take the
        # same arithmetic from one optimizer
        self.optimizer = torch.optim.Adam(self.masters, lr=cfg.lr, betas=(cfg.adam_b1, cfg.adam_b2),
                                          eps=1e-8, capturable=cuda)
        self._lr_dev = torch.tensor(cfg.lr, device=self.device) if cuda else None
        # the EMA's (decay, 1 - decay) of the next graph replay
        self._ema_factors = torch.zeros(2, device=self.device)
        self.ema = ema_init(self.masters)
        self.step = 0
        self.step_graph = None
        return self.model

    def load_params(self, params: dict) -> None:
        """Weights carried from the JAX package's UNet ``params`` tree; the
        EMA restarts at them, as the JAX ``ema_init`` of fresh params."""
        if self.model is None:
            self.init_state()
        sd = unet_state_dict_from_jax(params, self.unet_config)
        self.model.load_state_dict(sd, strict=True)
        broadcast_module_(self.model)
        if self._shards is not None:
            self._shards.reshard_()
        self.ema = ema_init(self.masters)
        self._drop_graph()  # it updates the replaced EMA

    def stored_elements(self) -> dict:
        """Elements this rank stores between steps: of the parameters (the
        masters), of Adam's two moments and of the EMA, with the full
        elements of each and the sharded parameters' share (the full
        weights gathered for the step are its working buffer, apart)."""
        full = sum(p.numel() for p in self.model.parameters())
        moments = sum(st[k].numel() for st in self.optimizer.state.values()
                      for k in ("exp_avg", "exp_avg_sq") if k in st)
        out = {"params": sum(m.numel() for m in self.masters), "adam": moments,
               "ema": sum(e.numel() for e in self.ema.params), "full_params": full}
        if self._shards is not None:
            out.update(self._shards.stored_elements())
        return out

    # -- step ---------------------------------------------------------------

    def _microbatches(self, batch_img, classes):
        """(conditions, classes) of each microbatch on the device; the tail
        past ``accum * (B // accum)`` is dropped, as the JAX step drops it.
        Under a process group the batch is this rank's rows, which must
        split into ``accum`` microbatches without a tail."""
        accum = self.config.gradient_accumulate_every
        dev = self.device
        batch_img = torch.as_tensor(batch_img, dtype=torch.float32).to(dev)
        classes = torch.as_tensor(classes, dtype=torch.long).to(dev)
        mb = batch_img.shape[0] // accum
        if mb == 0:
            raise ValueError(f"batch of {batch_img.shape[0]} < {accum} microbatches")
        if self._grads is not None and batch_img.shape[0] % accum:
            raise ValueError(f"a global batch of {batch_img.shape[0] * self.mesh.data} does not "
                             f"split into {accum} microbatches over {self.mesh.data} ranks")
        return [(batch_img[a * mb:(a + 1) * mb], classes[a * mb:(a + 1) * mb])
                for a in range(accum)]

    def loss_and_grads(self, batch_img, classes, generator: Optional[torch.Generator] = None,
                       draws=None) -> torch.Tensor:
        """The step's loss (mean over the microbatches, a 0-d tensor on the
        device) with the gradients left in each parameter's ``.grad``: each
        microbatch's summed, then divided by their count (under a process
        group: summed over the data group too, and divided by both; under
        ``shard_params`` the full weights are gathered first).  ``draws``
        injects one (t, noise, keep_mask) per microbatch (under a process
        group the global microbatch's, of which this data index takes its
        rows); otherwise they come from ``generator``."""
        micro = self._microbatches(batch_img, classes)
        mesh = self.mesh
        check_group_unchanged(self._grads)
        self.model.train()
        if self._shards is not None:
            self._shards.gather_params_()
        if self._grads is None:
            self.optimizer.zero_grad(set_to_none=True)
        else:
            self._grads.zero_()
        total = torch.zeros((), device=self.device)
        for a, (b, c) in enumerate(micro):
            d = None if draws is None else draws[a]
            if d is not None and self._grads is not None:
                d = tuple(shard_batch(torch.as_tensor(x), mesh.data_index, mesh.data) for x in d)
            loss = self.gd.loss(b, c, generator, d)
            loss.backward()
            total += loss.detach()
        if self._grads is not None:
            return self._grads.reduce_([total], float(mesh.data * len(micro)),
                                       mesh.data_group)[0].clone()
        if len(micro) > 1:
            torch._foreach_div_([p.grad for p in self.model.parameters()], float(len(micro)))
        return total / len(micro)

    def _adam_step(self) -> None:
        """Adam's update of the masters.  On the card it reads the LR from
        ``_lr_dev``; the param group keeps the float checkpoints hold."""
        if self._lr_dev is None:
            self.optimizer.step()
            return
        group = self.optimizer.param_groups[0]
        lr, group["lr"] = group["lr"], self._lr_dev
        try:
            self.optimizer.step()
        finally:
            group["lr"] = lr

    def _clip_and_adam(self) -> tuple:
        """The global-norm clip of the gradients in ``.grad``, then Adam;
        (norm, scale) as 0-d tensors on the device, no host sync."""
        cfg = self.config
        grads = [m.grad for m in self.masters]
        if self._shards is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        else:
            norm = self._shards.grad_norm()
        scale = cfg.grad_clip_norm / torch.clamp(norm, min=cfg.grad_clip_norm)
        torch._foreach_mul_(grads, scale)
        self._adam_step()
        return norm, scale

    def apply_gradients(self) -> dict:
        """The update from the gradients in ``.grad``: the global-norm clip,
        Adam, the EMA; counts the step.  Returns the gradients' global norm
        and the clip's scale (0-d tensors on the device)."""
        cfg = self.config
        norm, scale = self._clip_and_adam()
        ema_update(self.ema, self.masters, beta=cfg.ema_beta, update_every=cfg.ema_update_every)
        self.step += 1
        return {"grad_norm": norm, "clip_scale": scale}

    def train_step(self, batch_img, classes, generator: Optional[torch.Generator] = None,
                   draws=None) -> dict:
        """One optimizer step on a (B, S, S, 12) condition batch in [0, 1]
        and (B,) classes; returns the loss, the gradients' global norm and
        the clip's scale (0-d tensors on the device, not synchronised)."""
        loss = self.loss_and_grads(batch_img, classes, generator, draws)
        return {"loss": loss, **self.apply_gradients()}

    def train_steps(self, batch_imgs, classes, generator: Optional[torch.Generator] = None,
                    draws=None) -> torch.Tensor:
        """K optimizer steps on a (K, B, S, S, 12) condition stack and (K, B)
        classes (this rank's rows under a process group); returns the (K,)
        losses on the device.  ``draws`` injects K lists of per-microbatch
        draws.  The state afterwards is that of K :meth:`train_step` calls.

        On the card each step replays one CUDA graph of the whole step,
        captured when the batch shape, the draws mode or the generator
        differs from the last call's (the older graph is freed first): that
        call's first step runs eagerly on a side stream (it sets up Adam's
        state, the libraries' handles and the kernels' attributes), then the
        step is captured.  A generator other than the
        default CUDA one is registered with the graph, so that each replay
        draws anew from it.  Before each replay the host copies the step's
        batch into the graph's inputs and writes the EMA's factors; a
        capture or replay that fails raises, and no step falls back to the
        eager path.  Under a process group the graph holds the step's
        collectives (the gathers under ``shard_params``, the gradient sum,
        the clip's norm), which only ``nccl`` captures: under ``gloo`` on the
        card this raises (:meth:`train_step` runs there).  On the CPU (no
        graphs there), K :meth:`train_step` calls."""
        K = len(batch_imgs)
        if self.device.type != "cuda":
            return torch.stack([self.train_step(batch_imgs[k], classes[k], generator,
                                                None if draws is None else draws[k])["loss"]
                                for k in range(K)])
        if self._grads is not None and torch.distributed.get_backend() != "nccl":
            raise RuntimeError(
                "train_steps captures the step's collectives in a CUDA graph, which needs the "
                f"'nccl' backend (this group: {torch.distributed.get_backend()!r}); "
                "use train_step")
        imgs = torch.as_tensor(batch_imgs, dtype=torch.float32).to(self.device)
        cls = torch.as_tensor(classes, dtype=torch.long).to(self.device)
        dev_draws = None if draws is None else [
            [self._static_draw(d) for d in step] for step in draws]
        key = (tuple(imgs.shape[1:]), draws is not None)
        losses, first = [], 0
        sg = self.step_graph
        if sg is None or sg.key != key or sg.generator is not generator:
            sg = None  # the older graph and its pool go before the capture
            self._drop_graph()
            d0 = None if dev_draws is None else dev_draws[0]
            # the warm-up step allocates on its own stream, which cannot take
            # this stream's cached blocks: hand them back first
            torch.cuda.empty_cache()
            if self._warmup_stream is None:
                self._warmup_stream = torch.cuda.Stream(self.device)
            side = self._warmup_stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                losses.append(self.train_step(imgs[0], cls[0], generator, d0)["loss"])
            torch.cuda.current_stream(self.device).wait_stream(side)
            sg = self.step_graph = self._capture(key, imgs[0], cls[0], generator, d0)
            first = 1
        for k in range(first, K):
            sg.img.copy_(imgs[k])
            sg.classes.copy_(cls[k])
            if dev_draws is not None:
                for static, new in zip(sg.draws, dev_draws[k]):
                    for s, n in zip(static, new):
                        s.copy_(n)
            self._set_factors()
            sg.graph.replay()
            losses.append(sg.loss.clone())
            self.step += 1
        return torch.stack(losses)

    def _drop_graph(self) -> None:
        """Free the captured step, with the ``.grad`` tensors made in its
        pool (under a process group they are the flat buffer's views)."""
        if self.step_graph is None:
            return
        self.step_graph = None
        if self._grads is None:
            self.optimizer.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()

    def _static_draw(self, d) -> tuple:
        t, noise, keep = d
        return (torch.as_tensor(t).to(self.device, torch.long),
                torch.as_tensor(noise).to(self.device, torch.float32),
                torch.as_tensor(keep).to(self.device, torch.bool))

    def _set_factors(self) -> None:
        """The LR and the EMA's (decay, 1 - decay) of the next replay into
        their device tensors (outside any graph: the replay reads them);
        counts the EMA's update call on the host."""
        cfg = self.config
        self._lr_dev.fill_(self.optimizer.param_groups[0]["lr"])
        d = ema_step_decay(self.ema, beta=cfg.ema_beta, update_every=cfg.ema_update_every)
        self._ema_factors[0].fill_(d)
        self._ema_factors[1].fill_(1.0 - d)

    def _capture(self, key, img, classes, generator, draws) -> StepGraph:
        """A CUDA graph of one optimizer step (the draws, the gathers, every
        microbatch forward and backward, the gradient sum, the clip, Adam,
        the EMA with device factors) reading static copies of its inputs.
        The ``.grad`` tensors are made inside the graph, from its memory pool
        (under a process group they are the flat buffer's views, zeroed and
        summed inside the graph)."""
        inputs = (img.clone(), classes.clone())
        static_draws = None if draws is None else [tuple(x.clone() for x in d) for d in draws]
        before = {fn.__name__: (fn.launches, fn.generic) for fn in LAUNCH_COUNTERS}
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        launches = {}
        try:
            with torch.cuda.graph(graph):
                loss = self.loss_and_grads(*inputs, generator, static_draws)
                self._clip_and_adam()
                ema_apply_(self.ema, self.masters, self._ema_factors[0], self._ema_factors[1])
        finally:
            for fn in LAUNCH_COUNTERS:
                n, generic = before[fn.__name__]
                launches[fn.__name__] = fn.launches - n
                launches[f"{fn.__name__}_generic"] = fn.generic - generic
                # nothing ran while the step was captured: the counters count
                # launches that run, so they go back to where they were
                fn.launches, fn.generic = n, generic
        return StepGraph(key, graph, inputs[0], inputs[1], static_draws, loss, generator,
                         launches)

    # -- loop ---------------------------------------------------------------

    def train(self, batches: Iterator, num_steps: Optional[int] = None,
              save_every: Optional[int] = None, log_every: int = 50, on_milestone=None,
              fuse_steps: int = 1):
        """Steps until ``num_steps`` (default ``train_num_steps``) on
        ``(conditions, classes)`` batches (this rank's rows under a process
        group), the draws from a generator on the device seeded with
        ``seed + 1 + data index``, in chunks of up to ``fuse_steps`` through
        :meth:`train_steps` (one step: :meth:`train_step`).  A chunk ends at
        every ``save_every`` boundary, as the JAX loop's do, where it saves
        and calls ``on_milestone(trainer, step)``; the loss is logged when a
        chunk crosses a multiple of ``log_every``.  Returns the last step's
        metrics (of a chunk: its last loss)."""
        cfg = self.config
        num_steps = num_steps or cfg.train_num_steps
        save_every = save_every or cfg.save_every
        if self.model is None:
            self.init_state()
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1 + self.mesh.data_index)
        out = None
        while self.step < num_steps:
            k = min(fuse_steps, num_steps - self.step, save_every - self.step % save_every)
            prev = self.step
            if k == 1:
                out = self.train_step(*next(batches), generator=gen)
            else:
                chunk = [next(batches) for _ in range(k)]
                out = {"loss": self.train_steps(_stack([b for b, _ in chunk]),
                                                _stack([c for _, c in chunk]), generator=gen)[-1]}
            if self.step // log_every > prev // log_every:
                self.logger.info(f"step {self.step}/{num_steps} loss {float(out['loss']):.4f}")
            if self.step % save_every == 0:
                self.save()
                if on_milestone is not None:
                    on_milestone(self, self.step)
        return out

    # -- sampling -----------------------------------------------------------

    def _full(self, tensors: list) -> list:
        """Full per-parameter tensors from ``masters``-shaped ones (a gather
        under ``shard_params``)."""
        return list(tensors) if self._shards is None else self._shards.gather(tensors)

    def sample(self, classes, rgb_flow, mask, use_ema: bool = True, cond_scale=None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """DDIM sampling (``GaussianDiffusion.sample``, rgb_flow in [0, 1])
        with the EMA or the online weights (under ``shard_params`` gathered:
        every rank of the model group calls this); images (B, S, S, 6) in
        [0, 1]."""
        weights = self._full(self.ema.params if use_ema else self.masters)
        model = copy.deepcopy(self.model)
        with torch.no_grad():
            for p, w in zip(model.parameters(), weights):
                p.copy_(w)
        model.eval()
        gd = GaussianDiffusion(model, self.config.diffusion, device=self.device)
        try:
            return gd.sample(classes, rgb_flow, mask, cond_scale=cond_scale, generator=generator)
        finally:
            self.model.train()

    def save_preview(self, cond_batch, classes, path: str,
                     generator: Optional[torch.Generator] = None) -> tuple:
        """Sample from the EMA on a condition batch (B, S, S, 12) and write
        the warp-consistency panel grid (``utils/viz.py``; the reference
        Trainer's milestone preview).  Logs the masked photometric error
        ``mean(mask * |warp(img2, flow) - img1|)`` by the JAX formula and
        returns (path, photo_err).  Every rank samples (under
        ``shard_params`` the EMA is gathered); rank 0 alone writes.  The
        draws come from ``generator`` (default: one seeded with 0)."""
        from dmhomo_torch.geometry.warp import warp_by_flow
        from dmhomo_torch.utils.viz import image_grid, sample_panel, save_png

        dev = self.device
        cond = torch.as_tensor(cond_batch, dtype=torch.float32).to(dev)
        cls = torch.as_tensor(classes, dtype=torch.long).to(dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        imgs = self.sample(cls, cond[..., 7:10], cond[..., 6:7], generator=generator).float()
        mask, flow = cond[..., 6:7], cond[..., 10:12]
        warped = warp_by_flow(imgs[..., 3:], flow, mode="border")
        photo_err = float((mask * (warped - imgs[..., :3]).abs()).sum() / (mask.sum() * 3 + 1e-8))
        if is_main_process():
            save_png(path, image_grid(sample_panel(imgs, mask, flow)))
            self.logger.info(f"preview {path}: photometric error {photo_err:.4f}")
        return path, photo_err

    # -- checkpoints --------------------------------------------------------

    def state_dict(self) -> dict:
        """The reference layout, with full tensors (under ``shard_params``
        gathered: every rank of the model group calls this)."""
        if self._shards is not None:
            self._shards.gather_params_()
        names = [n for n, _ in self.model.named_parameters()]
        ema = {f"ema_model.model.{n}": e.detach().cpu()
               for n, e in zip(names, self._full(self.ema.params))}
        ema["step"] = torch.tensor(self.ema.step)
        ema["initted"] = torch.tensor(True)
        opt = self.optimizer.state_dict()
        if self._shards is not None:
            opt = self._map_moments(opt, self._shards.gather)
        return {"step": self.step,
                "model": {f"model.{k}": v.detach().cpu() for k, v in self.model.state_dict().items()},
                "opt": opt, "ema": ema, "scaler": None, "version": CHECKPOINT_VERSION}

    def load_state_dict(self, ckpt: dict) -> None:
        """Weights, Adam, EMA and step from a checkpoint in the reference
        layout (the port's, sharded or not, or a reference DGM.pt's with its
        schedule buffers and EMA bookkeeping), cut to this rank's slices
        under ``shard_params``."""
        if self.model is None:
            self.init_state()
        sd = _unet_part(ckpt["model"], "model.", DGM_MODEL_SKIPS, "DGM checkpoint 'model'")
        self.model.load_state_dict(sd, strict=True)
        broadcast_module_(self.model)
        opt = ckpt["opt"]
        if self._shards is not None:
            self._shards.reshard_()
            opt = self._map_moments(opt, self._shards.shard)
        self.optimizer.load_state_dict(opt)
        # the file may come from the other device: this trainer's Adam form
        cuda = self.device.type == "cuda"
        for group in self.optimizer.param_groups:
            group["capturable"] = cuda
        if cuda:
            for st in self.optimizer.state.values():
                st["step"] = st["step"].to(self.device, torch.float32)
        ema = _unet_part(ckpt["ema"], "ema_model.model.", DGM_EMA_SKIPS, "DGM checkpoint 'ema'")
        full = [ema[n].to(self.device) for n, _ in self.model.named_parameters()]
        self.ema = ema_init(full if self._shards is None else self._shards.shard(full))
        self.ema.step = int(ckpt["ema"].get("step", 0))
        self.step = int(ckpt["step"])
        self._drop_graph()  # it holds the replaced optimizer state and EMA

    def _map_moments(self, opt: dict, fn) -> dict:
        """Adam's state dict with both moments passed through ``fn`` (a
        gather or a cut of per-parameter lists); the live state untouched.
        Before the first step there are no moments."""
        n = len(self.masters)
        if len(opt["state"]) != n:
            return opt
        state = {i: dict(opt["state"][i]) for i in range(n)}
        for k in ("exp_avg", "exp_avg_sq"):
            for i, t in enumerate(fn([state[i][k] for i in range(n)])):
                state[i][k] = t
        return {**opt, "state": state}

    def save(self, root: Optional[str] = None) -> str:
        """``<root>/model-<step>.pt`` (default root ``results_dir``), written
        atomically; keeps the newest KEEP_CHECKPOINTS files.  Under a
        process group only rank 0 writes (under ``shard_params`` after every
        rank has gathered); every rank returns the path."""
        root = root or self.config.results_dir
        path = os.path.join(root, f"model-{self.step}.pt")
        state = self.state_dict() if self._shards is not None or is_main_process() else None
        if not is_main_process():
            return path
        atomic_save(state, path)
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


def _stack(xs: list):
    """A (K, ...) stack of K arrays or tensors."""
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def checkpoint_steps(root: str) -> list:
    """Steps of the ``model-<step>.pt`` files under ``root``."""
    if not os.path.isdir(root):
        return []
    return [int(m.group(1)) for m in map(_CKPT_NAME.match, os.listdir(root)) if m]
