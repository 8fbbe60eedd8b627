"""The ``('data', 'model')`` grid and the rows each rank takes (the JAX
package's ``parallel/mesh.py``).

The ranks of the process group lie on the grid as JAX's
``devices.reshape(data, model)`` lays its devices: rank ``r`` is data
index ``r // model`` and model index ``r % model``.  The ranks of one data
index (a row of the grid) form a ``model`` group, over which
``parallel/tp.py`` gathers channel-sharded parameters; the ranks of one
model index (a column) form a ``data`` group, over which the gradients are
summed.

JAX shards the global batch over the ``data`` axis only (``P('data')``)
and its step splits the whole batch into ``accum`` microbatches:
microbatch ``a`` is global rows ``[a*mb, (a+1)*mb)``, and its BatchNorm
statistics and NLL count are those of all these rows.  A data index
therefore takes, of every microbatch, its ``mb / data`` rows, and holds
them microbatch after microbatch, so that its own microbatch ``a`` (local
rows ``[a*mb/data, (a+1)*mb/data)``) is its share of the global one:
:func:`shard_batch` gives that layout, and the data loader, which hands
each rank its own rows, gives the same with ``batch_size = global // data``.
Every rank of one model group takes the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from dmhomo_torch.parallel.distributed import is_distributed, rank_and_world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` x ``model`` grid of ranks, with this rank's place on it
    and, under a process group, its two subgroups (None: the whole group
    for ``data_group`` when ``model`` is 1; no collective for
    ``model_group`` then)."""

    data: int
    model: int = 1
    data_index: int = 0
    model_index: int = 0
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}


def mesh_coords(rank: int, model: int) -> tuple:
    """(data index, model index) of ``rank`` on a grid ``model`` wide, as
    JAX's row-major ``reshape(data, model)`` places device ``rank``."""
    return rank // model, rank % model


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The grid over the process group's ranks (one rank without a group).
    ``data`` defaults to the world size over ``model``; raises unless
    ``data * model`` is the world size, as the JAX ``make_mesh`` asserts.

    Under a group with ``model > 1`` every rank builds the ``torch.distributed``
    subgroups of every row, then of every column, in that order (each
    ``new_group`` is a collective call of the whole group) and keeps its own
    two; with ``model == 1`` the data group is the whole group and no
    subgroup is made."""
    rank, world = rank_and_world()
    if model < 1 or world % model:
        raise ValueError(f"a 'model' axis of {model} does not divide the {world} rank(s)")
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"{data}x{model} != {world} rank(s)")
    d, m = mesh_coords(rank, model)
    if model == 1 or not is_distributed():
        return Mesh(data, model, d, m)
    import torch.distributed as dist

    data_group = model_group = None
    for row in range(data):
        g = dist.new_group(list(range(row * model, (row + 1) * model)))
        if row == d:
            model_group = g
    for col in range(model):
        g = dist.new_group(list(range(col, world, model)))
        if col == m:
            data_group = g
    return Mesh(data, model, d, m, data_group, model_group)


def accum_for(local_batch: int, world: int, grad_accum: int) -> int:
    """Microbatches per step by the JAX HEM trainer's rule: at most
    ``grad_accum`` and the per-device batch, dividing both it and the
    global batch."""
    accum = min(grad_accum, local_batch)
    while accum > 1 and (local_batch % accum or (local_batch * world) % accum):
        accum -= 1
    return max(accum, 1)


def _take(x, axis: int, index: int, size: int, accum: int):
    n = x.shape[axis]
    if n % (accum * size):
        raise ValueError(f"a batch of {n} does not split into {accum} microbatches of a "
                         f"multiple of {size} data indices")
    per = n // (accum * size)
    lead, rest = tuple(x.shape[:axis]), tuple(x.shape[axis + 1:])
    rows = x.reshape(*lead, accum, size, per, *rest)[(slice(None),) * axis + (slice(None), index)]
    return rows.reshape(*lead, accum * per, *rest)


def shard_batch(batch, index: int, size: int, accum: int = 1):
    """Data index ``index``'s rows (of ``size`` along the ``data`` axis;
    the rank and the world size when ``model`` is 1) of a global batch (an
    array, a tensor, or a dict of them; axis 0), microbatch by microbatch:
    of microbatch ``a`` the rows ``a*mb + index*mb/size`` onward,
    ``mb/size`` of them.  Raises unless ``accum * size`` divides the batch."""
    if isinstance(batch, dict):
        return {k: _take(v, 0, index, size, accum) for k, v in batch.items()}
    return _take(batch, 0, index, size, accum)


def shard_stacked_batch(batch, index: int, size: int, accum: int = 1):
    """:func:`shard_batch` along axis 1 of (K, B, ...) stacks of K batches."""
    if isinstance(batch, dict):
        return {k: _take(v, 1, index, size, accum) for k, v in batch.items()}
    return _take(batch, 1, index, size, accum)
