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

:meth:`HEMTrainer.train_steps` runs K steps per host call, as the JAX
trainer's scanned ``train_steps`` does: on the card each step is one replay
of a CUDA graph of the whole step (every microbatch forward and backward,
Adam, the BatchNorm updates), so the host enqueues a step in one call instead
of several thousand.

Under a process group (``parallel/distributed.py``; one process per card,
``torchrun``) the trainer is data-parallel as the JAX trainer is over its
mesh's ``data`` axis: each rank's batch is its share of the global batch
(``parallel/mesh.py::shard_batch``, as the data loader hands it out), the
BatchNorm statistics and the NLL count are those of the global microbatch,
and after the last microbatch one ``all_reduce`` sums the gradients and the
loss terms, which then divide by the world size.  The weights start from
rank 0's; every rank runs the same Adam update.  With no group nothing of
this runs.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Iterator, Optional

import torch

from dmhomo_torch.cli.hem_eval import eval_forward
from dmhomo_torch.data.hem_data import device_build_patches
from dmhomo_torch.data.loader import pad_batch
from dmhomo_torch.evaluation.metrics import (
    bucket_by_category,
    bucket_sums,
    category_report,
    merge_bucket_sums,
)
from dmhomo_torch.losses.hem_losses import compute_losses
from dmhomo_torch.models.convert import estimator_state_dict_from_jax
from dmhomo_torch.models.estimator import HomographyEstimator, random_init_
from dmhomo_torch.models.swin import WindowAttention
from dmhomo_torch.ops.swin_block import swin_block, swin_block_backward
from dmhomo_torch.ops.window_attention import window_attention, window_attention_backward
from dmhomo_torch.parallel.distributed import (
    FlatGradients,
    all_reduce_,
    broadcast_module_,
    check_group_unchanged,
    is_distributed,
)
from dmhomo_torch.parallel.mesh import accum_for, make_mesh
from dmhomo_torch.train.config import HEMTrainConfig, estimator_for_training
from dmhomo_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from dmhomo_torch.utils.device import resolve_device
from dmhomo_torch.utils.meters import MetricTracker

RAW_KEYS = ("img12", "homo", "homo_inv", "start")
PATCH_KEYS = ("imgs_gray_patch", "flow_gt_patch")
LOSS_TERMS = ("unsup", "mask_reg", "nll", "supervise", "total")  # compute_losses' keys
# the kernel wrappers a training step may launch, each counting its launches
LAUNCH_COUNTERS = (window_attention, window_attention_backward, swin_block,
                   swin_block_backward)


@dataclasses.dataclass
class StepGraph:
    """One optimizer step captured as a CUDA graph: its static input buffers
    and loss outputs, and the kernel launches of one replay by wrapper name
    (and by shape), as the wrappers counted them while the step was captured.
    A replay runs no Python, so the wrappers' own counters do not move."""

    graph: "torch.cuda.CUDAGraph"
    inputs: dict
    losses: dict
    launches: dict
    launches_by_shape: dict


class HEMTrainer:
    """Trains the estimator on ``device`` (default: the CUDA card; raises
    without one), data-parallel over the process group's ranks if there is
    one when the trainer is made."""

    def __init__(self, config: HEMTrainConfig, steps_per_epoch: Optional[int] = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.steps_per_epoch = steps_per_epoch or config.train_num_steps
        self.logger = logging.getLogger("dmhomo_torch.hem")
        self.metrics = MetricTracker(config.major_metric)
        self.mesh = make_mesh()  # ('data', 'model') = (world size, 1)
        self._grads: Optional[FlatGradients] = None  # under a process group
        self.model: Optional[HomographyEstimator] = None
        self.step = 0
        self.epoch = 0
        self._lr_dev: Optional[torch.Tensor] = None
        self._copy_stream: Optional["torch.cuda.Stream"] = None  # batches from pinned memory
        self._graphs: dict = {}  # (key, shape, dtype) of each input -> StepGraph
        self.step_graph: Optional[StepGraph] = None  # the graph train_steps last replayed
        self._health_model: Optional[HomographyEstimator] = None

    # -- state --------------------------------------------------------------

    def init_state(self, seed: Optional[int] = None) -> HomographyEstimator:
        """A new model with weights drawn from ``torch.Generator().manual_seed(seed)``
        (default ``config.seed``), a fresh optimizer and LR staircase, step 0."""
        cfg = self.config
        gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
        est = estimator_for_training(cfg, self.device.type)
        self.model = random_init_(HomographyEstimator(est), gen)
        self.model.to(self.device)
        cuda = self.device.type == "cuda"
        # capturable on the card: Adam keeps its step count there and reads
        # its LR from _lr_dev, so eager steps and graph replays take the same
        # arithmetic from one optimizer
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                          betas=(0.9, 0.999), eps=1e-8, capturable=cuda)
        self._lr_dev = torch.tensor(cfg.lr, device=self.device) if cuda else None
        spe, gamma = self.steps_per_epoch, cfg.gamma
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda k: gamma ** (k // spe))
        self.step = 0
        self.epoch = 0
        self._graphs = {}
        self.step_graph = None
        if is_distributed():
            self._grads = FlatGradients(self.model.parameters(), len(LOSS_TERMS))
        broadcast_module_(self.model)  # under a group, rank 0's weights on every rank
        return self.model

    def load_params(self, params: dict, batch_stats: dict) -> None:
        """Weights carried from the JAX package's ``params`` / ``batch_stats``
        trees (nested dicts of arrays)."""
        if self.model is None:
            self.init_state()
        sd = estimator_state_dict_from_jax(params, batch_stats, self.model.config)
        self.model.load_state_dict(sd, strict=True)
        broadcast_module_(self.model)

    @property
    def lr(self) -> float:
        """The learning rate of the next step."""
        return self.optimizer.param_groups[0]["lr"]

    # -- train step ---------------------------------------------------------

    def _stage(self, batch: dict):
        """Start copying a batch (numpy arrays or tensors) to the device.
        Tensors in pinned host memory (``DataLoader(pin_memory=True)``) are
        copied on the trainer's copy stream without waiting for it; the event
        returned marks their arrival.  Anything else is copied as before (a
        copy from pageable memory makes the host wait for it); the event is
        then None.  Returns (tensors on the device, event)."""
        keys = RAW_KEYS if "img12" in batch else PATCH_KEYS
        host = {k: torch.as_tensor(batch[k]) for k in keys}
        if self.device.type != "cuda" or not any(t.is_pinned() for t in host.values()):
            return {k: t.to(self.device) for k, t in host.items()}, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            staged = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return staged, event

    def _device_batch(self, staged: dict, event) -> dict:
        """A staged batch, ready for the current stream: the stream waits for
        its copy, and its tensors (allocated on the copy stream) stay reserved
        until the work the stream has queued on them is done."""
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in staged.values():
                t.record_stream(stream)
        return staged

    def _forward_backward(self, batch: dict) -> dict:
        """The step's gradients, summed over its microbatches into ``.grad``
        (None before; under a process group the flat buffer, zeroed, then
        reduced over the ranks), and its loss terms (means over the
        microbatches and the ranks), from a batch of either schema on the
        device."""
        cfg = self.config
        if "img12" in batch:  # raw schema: the batch is built on the device
            est = cfg.estimator
            batch = device_build_patches(batch["img12"], batch["homo"], batch["homo_inv"],
                                         batch["start"], est.crop_size, est.ori_size)
        imgs, flows = batch["imgs_gray_patch"], batch["flow_gt_patch"]
        B = imgs.shape[0]  # this rank's rows of the global batch
        check_group_unchanged(self._grads)
        accum = accum_for(B, self.mesh.data, cfg.grad_accum)
        mb = B // accum
        if self._grads is None:
            self.optimizer.zero_grad(set_to_none=True)
        else:
            self._grads.zero_()
        sums: dict = {}
        for a in range(accum):
            sl = slice(a * mb, (a + 1) * mb)
            # no cast cache: a captured graph must cast the weights it reads
            with torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=cfg.bf16,
                                cache_enabled=False):
                outputs = self.model(imgs[sl])
            losses = compute_losses({"flow_gt_patch": flows[sl]}, outputs, cfg.loss)
            (losses["total"] / accum).backward()
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + v.detach()
        losses = {k: v / accum for k, v in sums.items()}
        if self._grads is not None:
            reduced = self._grads.reduce_([losses[k] for k in LOSS_TERMS], self.mesh.data)
            losses = {k: reduced[i].clone() for i, k in enumerate(LOSS_TERMS)}
        return losses

    def _set_lr(self) -> None:
        """On the card, the staircase LR of the next step into ``_lr_dev``
        (outside any graph: a replay reads it there)."""
        if self._lr_dev is not None:
            self._lr_dev.fill_(self.lr)

    def _adam_step(self) -> None:
        """Adam's update.  On the card it reads the LR from ``_lr_dev``; the
        param group keeps the float that ``LambdaLR`` steps and checkpoints
        hold."""
        if self._lr_dev is None:
            self.optimizer.step()
            return
        group = self.optimizer.param_groups[0]
        lr, group["lr"] = group["lr"], self._lr_dev
        try:
            self.optimizer.step()
        finally:
            group["lr"] = lr

    def _advance(self) -> None:
        self.scheduler.step()
        self.step += 1
        # epoch-equivalent counter: the reference's per-epoch ExponentialLR
        self.epoch = self.step // self.steps_per_epoch

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a batch of either schema; returns the loss
        terms (0-d tensors on the device, means over the microbatches)."""
        batch = self._device_batch(*self._stage(batch))
        self.model.train()
        losses = self._forward_backward(batch)
        self._set_lr()
        self._adam_step()
        self._advance()
        return losses

    def train_steps(self, batches: list) -> dict:
        """K optimizer steps on a list of K batches of one schema and shape;
        returns the loss terms as (K,) tensors on the device.  The state
        afterwards is that of K :meth:`train_step` calls.

        On the card each step replays one CUDA graph of the whole step, which
        is captured at the first call for each schema and batch shape: that
        call's first step runs eagerly on a side stream (it sets the kernels'
        attributes, the libraries' handles, Adam's state and the resizes'
        device tables), then the step is captured.  The K batches are staged
        first: from pinned memory their copies run on the copy stream while
        earlier replays run, and the call does not wait for them (from
        pageable memory it waits for each).  Then each step waits on the
        device for its batch's copy, copies the batch into the graph's input
        buffers, writes the LR, replays and copies the losses out, with no
        wait for the device.  A capture or replay that fails raises; no step
        falls back to the eager path.  On the CPU (no graphs there), K
        :meth:`train_step` calls.

        Under a process group the graph holds the step's collectives (the
        BatchNorm moments, the NLL counts, the gradient all-reduce), which
        only ``nccl`` can capture: under ``gloo`` on the card this raises
        (:meth:`train_step` runs there).
        """
        if self.device.type == "cuda" and self._grads is not None and \
                torch.distributed.get_backend() != "nccl":
            raise RuntimeError(
                "train_steps captures the step's collectives in a CUDA graph, which needs the "
                f"'nccl' backend (this group: {torch.distributed.get_backend()!r}); "
                "use train_step")
        if self.device.type == "cuda":
            outs = self._graph_steps(batches)
        else:
            outs = [self.train_step(b) for b in batches]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def _graph_steps(self, batches: list) -> list:
        staged = [self._stage(b) for b in batches]
        key = tuple((k, tuple(v.shape), v.dtype) for k, v in staged[0][0].items())
        self.model.train()
        outs, first = [], 0
        if key not in self._graphs:
            # ready on this stream, which the side stream follows and which
            # waits for the side stream before the batch can be freed
            batch = self._device_batch(*staged[0])
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                outs.append(self.train_step(batch))
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._graphs[key] = self._capture(batch)
            first = 1
        sg = self.step_graph = self._graphs[key]
        for batch in staged[first:]:
            batch = self._device_batch(*batch)
            for k, buf in sg.inputs.items():
                buf.copy_(batch[k])
            self._set_lr()
            sg.graph.replay()
            outs.append({k: v.clone() for k, v in sg.losses.items()})
            self._advance()
        return outs

    def _capture(self, batch: dict) -> StepGraph:
        """A CUDA graph of one optimizer step (forward and backward of every
        microbatch, Adam, the BatchNorm updates) reading static copies of
        ``batch``'s tensors.  The ``.grad`` tensors are made inside the graph,
        from its memory pool (under a process group they are the flat
        buffer's views, zeroed and all-reduced inside the graph)."""
        inputs = {k: v.clone() for k, v in batch.items()}
        before = {fn.__name__: (fn.launches, collections.Counter(fn.launches_by_shape))
                  for fn in LAUNCH_COUNTERS}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                losses = self._forward_backward(inputs)
                self._adam_step()
        finally:
            launches, by_shape = {}, {}
            for fn in LAUNCH_COUNTERS:
                n, shapes = before[fn.__name__]
                launches[fn.__name__] = fn.launches - n
                by_shape[fn.__name__] = fn.launches_by_shape - shapes
                # nothing ran while the step was captured: the counters count
                # launches that run, so they go back to where they were
                fn.launches = n
                fn.launches_by_shape.clear()
                fn.launches_by_shape.update(shapes)
        return StepGraph(graph, inputs, losses, launches, by_shape)

    # -- eval ---------------------------------------------------------------

    def evaluate(self, eval_batches: Iterator, split: str = "val") -> dict:
        """Point-matching error per category over CAHomo-format batches
        (under a process group: over every rank's batches)."""
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
        buckets = bucket_by_category(errs, names)
        if is_distributed():
            # each rank evaluated its own rows: sum the per-category (sum,
            # count) over the ranks, as the JAX trainer merges its hosts'
            sums = torch.as_tensor(bucket_sums(buckets), dtype=torch.float64, device=self.device)
            buckets = merge_bucket_sums(all_reduce_(sums).cpu().numpy())
        report = category_report(buckets)
        self.metrics.update(split, report)
        self.logger.info(f"[{split}] " + " ".join(f"{k}:{v:.4f}" for k, v in report.items()))
        return report

    @torch.no_grad()
    def logit_health(self, imgs_gray_patch) -> float:
        """Largest |q k^T scale + bias| over every ``WindowAttention`` of one
        eval forward of ``imgs_gray_patch`` (B, hp, wp, 2), the SW-MSA mask
        left out: the validity check of the max-free softmax's +-60 clip, as
        the JAX trainer's ``logit_health``.

        The kernels keep their logits on chip, so, as JAX runs a non-remat
        XLA twin of its model, this runs a twin with the current weights and
        BatchNorm statistics whose window attention is the plain version
        (``ops/window_attention.py::_logits``), with unfused blocks under
        ``fused_block``, no remat, in fp32 without autocast (JAX's twin takes
        the config's fp32 estimator).  This diagnostic forward is the one
        place where the plain window attention runs on the card; training
        and eval never run it there."""
        if self._health_model is None:
            est = self.model.config
            est = dataclasses.replace(est, swin=dataclasses.replace(
                est.swin, attn_impl="xla", remat=False))
            self._health_model = HomographyEstimator(est).to(self.device).eval()
        twin = self._health_model
        twin.load_state_dict(self.model.state_dict(), strict=True)
        probes = [m for m in twin.modules() if isinstance(m, WindowAttention)]
        for m in probes:
            m.logits = []
        try:
            twin(torch.as_tensor(imgs_gray_patch).to(self.device))
            return float(torch.stack([v for m in probes for v in m.logits]).max())
        finally:
            for m in probes:
                m.logits = None

    # -- loop ---------------------------------------------------------------

    def train_and_evaluate(self, train_batches: Iterator, eval_loader=None,
                           total_steps: Optional[int] = None, log_every: int = 100,
                           fuse_steps: int = 1):
        """Steps until ``total_steps`` (default ``num_epochs`` epochs), in
        chunks of up to ``fuse_steps`` through :meth:`train_steps` (one step:
        :meth:`train_step`); a chunk ends at every ``train_num_steps``
        boundary, where, with an eval loader: evaluate, save ``latest``, and
        ``best`` when the major metric improved.  The loss terms are logged
        when a chunk crosses a multiple of ``log_every``.  Returns the best
        report (None without evals)."""
        cfg = self.config
        if self.model is None:
            self.init_state()
        total_steps = total_steps or cfg.num_epochs * self.steps_per_epoch
        best_report = None
        while self.step < total_steps:
            k = min(fuse_steps, total_steps - self.step,
                    cfg.train_num_steps - self.step % cfg.train_num_steps)
            prev = self.step
            if k == 1:
                losses = self.train_step(next(train_batches))
            else:
                losses = {key: v[-1] for key, v in
                          self.train_steps([next(train_batches) for _ in range(k)]).items()}
            if self.step // log_every > prev // log_every:
                self.logger.info(f"step {self.step}/{total_steps} " + " ".join(
                    f"{key}:{float(v):.4f}" for key, v in losses.items()))
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
        """Write ``<root>/model_<tag>.pth`` (on rank 0 only under a process
        group); returns its path on every rank."""
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
        broadcast_module_(self.model)
        if not weights_only:
            self.optimizer.load_state_dict(ckpt["optimizer"])
            # the file may come from the other device: this trainer's Adam form
            cuda = self.device.type == "cuda"
            for group in self.optimizer.param_groups:
                group["capturable"] = cuda
            if cuda:
                for st in self.optimizer.state.values():
                    st["step"] = st["step"].to(self.device, torch.float32)
            self.scheduler.load_state_dict(ckpt["scheduler"])
            self.step = int(ckpt["step"])
            self.epoch = int(ckpt["epoch"])
            self._graphs = {}  # they hold the replaced optimizer state
