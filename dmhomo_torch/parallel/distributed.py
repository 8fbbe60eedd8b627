"""Process groups (the JAX package's ``parallel/distributed.py``; reference:
``accelerate launch`` over NCCL).

One process per card, started by ``torchrun --nproc_per_node N``: each
process finds ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in its
environment, takes the card ``LOCAL_RANK`` and joins one group, ``nccl``
for the card and ``gloo`` for the CPU.  Without that environment and
without arguments nothing starts, and the trainers run exactly as on one
card: no collective at all.

Under a group (one rank included) the trainers are data-parallel: every
BatchNorm reduces its moments across the ranks, the NLL divides by the
global count of valid entries, and each step all-reduces one flat buffer
of the gradients (over the mesh's ``data`` group, ``parallel/mesh.py``).
Only ``broadcast`` and ``all_reduce`` run, the two collectives gloo also
runs on CUDA tensors; ``parallel/tp.py`` gathers shards with
``all_reduce`` too.  File writes go through
:func:`is_main_process`; every rank computes."""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0  # a collective that waits longer raises instead of hanging


def local_device(device: "str | torch.device | None" = None) -> torch.device:
    """This process's device: for ``None`` or ``"cuda"`` the card
    ``LOCAL_RANK`` when torchrun set it (else the current card), made the
    current one; ``"cpu"`` when asked for."""
    from dmhomo_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.index is not None:
        torch.cuda.set_device(dev)
    return dev


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 init_method: Optional[str] = None,
                                 world_size: Optional[int] = None,
                                 rank: Optional[int] = None,
                                 device: "str | torch.device | None" = None,
                                 timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join a process group when torchrun's ``RANK`` / ``WORLD_SIZE`` are
    set or when ``init_method`` / ``world_size`` / ``rank`` are given;
    otherwise do nothing and return False.  True once a group exists.

    ``backend`` defaults to ``nccl`` for a CUDA ``device`` (the card
    ``LOCAL_RANK``, made current) and ``gloo`` for the CPU; ``gloo`` may be
    named for CUDA tensors (two ranks sharing one card), and then
    ``HEMTrainer.train_steps`` refuses to capture.  A failed init raises:
    no backend stands in for another.  ``timeout_s`` bounds every
    collective."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and world_size is None and rank is None and "WORLD_SIZE" not in env:
        return False
    dev = local_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def is_distributed() -> bool:
    """True under a process group: the data-parallel code paths run."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple:
    """(rank, world size); (0, 1) without a group (the JAX package's
    ``host_shard_info``)."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main_process() -> bool:
    """True on rank 0, the single writer of checkpoints, metric files and
    JSON reports (the reference gates its I/O on accelerate's
    ``is_main_process``).  Every rank still computes: a rank that skipped a
    step would leave the others waiting in its collectives."""
    return rank_and_world()[0] == 0


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` (default: all of them), in
    place; counts its calls in ``calls`` (a CUDA-graph replay runs no
    Python, so only captures and eager steps move it)."""
    all_reduce_.calls += 1
    dist.all_reduce(t, group=group)
    return t


all_reduce_.calls = 0


@torch.no_grad()
def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Under a process group, overwrite ``module``'s parameters and buffers
    on every rank with rank ``src``'s, one broadcast per dtype (flattened
    into one buffer); without a group, nothing."""
    if not is_distributed():
        return
    by_dtype: dict = {}
    for t in (*module.parameters(), *module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def check_group_unchanged(grads: "Optional[FlatGradients]") -> None:
    """Raise unless a trainer made under a process group (``grads``, its
    flat buffer) still runs under one, and one made without still runs
    without: BatchNorm and the NLL read the group at each call, the
    gradient reduction was set up with the trainer."""
    if is_distributed() != (grads is not None):
        raise RuntimeError("a process group was started or ended after the trainer was made")


class FlatGradients:
    """The ``.grad`` of every parameter as a view into one flat buffer,
    with ``n_extra`` slots after the gradients for the step's loss values,
    so that one ``all_reduce`` per step carries both (the gradient
    all-reduce XLA inserts into the JAX step).  The views stay in place
    for the trainer's life: zero them with :meth:`zero_`, never with
    ``zero_grad(set_to_none=True)``; autograd accumulates into them in
    place."""

    def __init__(self, params: Iterable[torch.nn.Parameter], n_extra: int = 0):
        self.params = list(params)
        dtypes = {p.dtype for p in self.params}
        if len(dtypes) != 1:
            raise ValueError(f"one flat gradient buffer takes one dtype, got {dtypes}")
        n = sum(p.numel() for p in self.params)
        self.buffer = torch.zeros(n + n_extra, dtype=dtypes.pop(),
                                  device=self.params[0].device)
        self.extra = self.buffer[n:]
        offset = 0
        for p in self.params:
            p.grad = self.buffer[offset:offset + p.numel()].view_as(p)
            offset += p.numel()

    def zero_(self) -> None:
        self.buffer.zero_()

    def reduce_(self, extras: list, divisor: float, group=None) -> torch.Tensor:
        """Copy ``extras`` (0-d tensors) into their slots, sum the buffer
        over the ranks of ``group`` (default: all of them; a mesh's data
        group) and divide it by ``divisor``; returns the slots."""
        if len(extras) != self.extra.numel():
            raise ValueError(f"{len(extras)} values for {self.extra.numel()} slots")
        if extras:
            self.extra.copy_(torch.stack([e.to(self.extra.dtype) for e in extras]))
        all_reduce_(self.buffer, group)
        self.buffer.div_(divisor)
        return self.extra
