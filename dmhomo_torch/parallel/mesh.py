"""The ``('data', 'model')`` grid and the rows each rank takes (the JAX
package's ``parallel/mesh.py``).

JAX shards the global batch over the ``data`` axis and its step splits the
whole batch into ``accum`` microbatches: microbatch ``a`` is global rows
``[a*mb, (a+1)*mb)``, and its BatchNorm statistics and NLL count are
those of all these rows.  A rank therefore takes, of every microbatch, its
``mb / world`` rows, and holds them microbatch after microbatch, so that its
own microbatch ``a`` (local rows ``[a*mb/world, (a+1)*mb/world)``) is its
share of the global one: :func:`shard_batch` gives that layout, and the
data loader, which hands each rank its own rows, gives the same with
``batch_size = global // world``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from dmhomo_torch.parallel.distributed import rank_and_world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` x ``model`` grid of ranks."""

    data: int
    model: int = 1

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The grid over the process group's ranks (``data`` defaults to the
    world size; 1 without a group)."""
    if model != 1:
        raise NotImplementedError(
            "a 'model' axis (DGMTrainConfig.shard_params: channel-sharded parameters) is not "
            "ported yet; it is the next item of the parallel layer (FSDP2/DTensor)")
    return Mesh(rank_and_world()[1] if data is None else data, model)


def accum_for(local_batch: int, world: int, grad_accum: int) -> int:
    """Microbatches per step by the JAX HEM trainer's rule: at most
    ``grad_accum`` and the per-device batch, dividing both it and the
    global batch."""
    accum = min(grad_accum, local_batch)
    while accum > 1 and (local_batch % accum or (local_batch * world) % accum):
        accum -= 1
    return max(accum, 1)


def _take(x, axis: int, rank: int, world: int, accum: int):
    n = x.shape[axis]
    if n % (accum * world):
        raise ValueError(f"a batch of {n} does not split into {accum} microbatches of a "
                         f"multiple of {world} ranks")
    per = n // (accum * world)
    lead, rest = tuple(x.shape[:axis]), tuple(x.shape[axis + 1:])
    rows = x.reshape(*lead, accum, world, per, *rest)[(slice(None),) * axis + (slice(None), rank)]
    return rows.reshape(*lead, accum * per, *rest)


def shard_batch(batch, rank: int, world: int, accum: int = 1):
    """Rank ``rank``'s rows of a global batch (an array, a tensor, or a dict
    of them; axis 0), microbatch by microbatch: of microbatch ``a`` the
    rows ``a*mb + rank*mb/world`` onward, ``mb/world`` of them.  Raises
    unless ``accum * world`` divides the batch."""
    if isinstance(batch, dict):
        return {k: _take(v, 0, rank, world, accum) for k, v in batch.items()}
    return _take(batch, 0, rank, world, accum)


def shard_stacked_batch(batch, rank: int, world: int, accum: int = 1):
    """:func:`shard_batch` along axis 1 of (K, B, ...) stacks of K batches."""
    if isinstance(batch, dict):
        return {k: _take(v, 1, rank, world, accum) for k, v in batch.items()}
    return _take(batch, 1, rank, world, accum)
