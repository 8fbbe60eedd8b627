"""Parameters sharded over the mesh's ``model`` axis (the JAX package's
``parallel/tp.py``).

JAX's ``channel_shardings`` shards a leaf's last dim over ``model`` when
the axis size divides it and each shard keeps at least ``MIN_CHANNELS`` (2)
channels, and replicates every other leaf; Adam's moments and the EMA take
the same layout, since the rule reads shapes only.  The port keeps that
channel where ``models/convert.py`` puts JAX's last dim: dim 0 of conv and
linear weights, dim 1 of LayerNorm gains (1, C, 1, 1) and of the class
embedding, the only dim of biases.  :func:`channel_dims` reads those dims
off the converter itself (run on a ``ChannelProbe``), so that one mapping
says both how a JAX leaf becomes a torch tensor and where it is cut.

The collectives are explicit (:class:`ShardedParams`): each rank stores
its slice of every sharded leaf (the optimizer and the EMA hold those
slices and moments of their size), gathers the full weights into the
module before the forward (one ``all_reduce`` over the model group of a
zeroed flat buffer holding its slices; the sums are exact), and after the
backward, whose gradient the data group has summed, steps its own slice of
it.  The full weights and gradients are the step's working buffers.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from dmhomo_torch.models.convert import ChannelProbe
from dmhomo_torch.parallel.distributed import all_reduce_

MIN_CHANNELS = 2  # JAX's channel_shardings default, the least channels a shard keeps


def channel_dims(module: torch.nn.Module, converter: Callable, config) -> Dict[str, int]:
    """For each parameter of ``module``, the torch dim that holds the last
    dim of its JAX leaf, as ``converter`` (a ``models/convert.py`` function
    of (params, config)) maps the JAX tree onto the module's keys."""
    probe = converter(ChannelProbe(), config)
    dims = {}
    for name, p in module.named_parameters():
        if name not in probe:
            raise KeyError(f"{converter.__name__} names no JAX leaf for {name!r}")
        dims[name] = probe[name].dim % p.ndim
    return dims


def channel_shardings(shapes: Dict[str, tuple], dims: Dict[str, int],
                      size: int) -> Dict[str, Optional[int]]:
    """JAX's rule per parameter: the dim to shard over a ``model`` axis of
    ``size``, or None to replicate."""
    out = {}
    for name, shape in shapes.items():
        c = shape[dims[name]]
        out[name] = dims[name] if size > 1 and c % size == 0 and c // size >= MIN_CHANNELS \
            else None
    return out


class ShardedParams:
    """A module's parameters over the mesh's ``model`` axis.

    ``masters`` lists, in the module's parameter order, this rank's slice
    (a tensor of its own) of each sharded parameter and the module's own
    parameter for each replicated one; the optimizer and the EMA take
    ``masters``.  The sharded parameters' full weights become views of one
    flat buffer, refilled by :meth:`gather_params_`.  Each sharded master's
    ``.grad`` is its slice of the full parameter's ``.grad``, which must
    exist and stay in place (``FlatGradients``' views: a ``model`` axis
    above 1 means a process group)."""

    def __init__(self, module: torch.nn.Module, dims: Dict[str, Optional[int]], mesh):
        self.size, self.index, self.group = mesh.model, mesh.model_index, mesh.model_group
        self.names = [n for n, _ in module.named_parameters()]
        self.params = list(module.parameters())
        self.dims = [dims[n] for n in self.names]
        self.sharded = [i for i, d in enumerate(self.dims) if d is not None]
        p0 = self.params[0]
        self._flat = torch.zeros(sum(self.params[i].numel() for i in self.sharded),
                                 dtype=p0.dtype, device=p0.device)
        self.masters: List[torch.Tensor] = list(self.params)
        with torch.no_grad():
            for i, full in zip(self.sharded, self._views(self._flat)):
                p = self.params[i]
                full.copy_(p)
                p.data = full
                self.masters[i] = self._slice(full, i).clone()
                self.masters[i].grad = self._slice(p.grad, i)

    def _slice(self, full: torch.Tensor, i: int) -> torch.Tensor:
        d = self.dims[i]
        n = full.shape[d] // self.size
        return full.narrow(d, self.index * n, n)

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """The sharded parameters' full shapes as views of ``flat``, in order."""
        out, offset = [], 0
        for i in self.sharded:
            p = self.params[i]
            out.append(flat[offset:offset + p.numel()].view(p.shape))
            offset += p.numel()
        return out

    @torch.no_grad()
    def _gather_into(self, flat: torch.Tensor, shards: List[torch.Tensor]) -> List[torch.Tensor]:
        flat.zero_()
        views = self._views(flat)
        for i, full in zip(self.sharded, views):
            self._slice(full, i).copy_(shards[i])
        if self.sharded:
            all_reduce_(flat, self.group)
        return views

    def gather_params_(self) -> None:
        """The full weights of the sharded parameters into the module, from
        every rank's masters (a collective of the model group)."""
        self._gather_into(self._flat, self.masters)

    def gather(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Full tensors from per-parameter lists laid out as ``masters``
        (a slice for each sharded parameter; a collective of the model
        group); the replicated entries pass through."""
        out = list(tensors)
        if not self.sharded:
            return out
        flat = torch.zeros_like(self._flat, dtype=tensors[self.sharded[0]].dtype)
        for i, full in zip(self.sharded, self._gather_into(flat, out)):
            out[i] = full
        return out

    def shard(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's slices (new tensors) of full per-parameter tensors;
        the replicated entries pass through."""
        out = list(tensors)
        for i in self.sharded:
            out[i] = self._slice(tensors[i], i).clone()
        return out

    @torch.no_grad()
    def reshard_(self) -> None:
        """The masters from the module's full weights (after a load)."""
        for i in self.sharded:
            self.masters[i].copy_(self._slice(self.params[i], i))

    def grad_norm(self) -> torch.Tensor:
        """The global norm of the full gradient from the masters' gradients:
        the squares of each sharded slice, summed over the model group, plus
        the replicated gradients' once."""
        def squares(idx):
            grads = [self.masters[i].grad for i in idx]
            if not grads:
                return torch.zeros(1, device=self._flat.device)
            return torch.stack(torch._foreach_norm(grads)).square().sum().reshape(1)

        sq = squares(self.sharded)
        all_reduce_(sq, self.group)
        replicated = [i for i, d in enumerate(self.dims) if d is None]
        return torch.sqrt(sq + squares(replicated))[0]

    def stored_elements(self) -> dict:
        """Elements of the sharded parameters this rank stores (its masters)
        against their full size, and of the replicated ones."""
        return {"sharded_stored": sum(self.masters[i].numel() for i in self.sharded),
                "sharded_full": sum(self.params[i].numel() for i in self.sharded),
                "replicated": sum(p.numel() for i, p in enumerate(self.params)
                                  if self.dims[i] is None),
                "sharded_leaves": len(self.sharded), "leaves": len(self.params)}
