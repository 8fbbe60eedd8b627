"""Exponential moving average of the parameters (the JAX package's
``train/ema.py``; the ``ema_pytorch.EMA`` wrapper of the reference DGM
Trainer with beta 0.995, update_every 10 and the library's defaults
update_after_step 100, inv_gamma 1, power 2/3):

* ``ema_update`` is called every train step and counts ``step``;
* the average moves only when ``step % update_every == 0``;
* the decay warms up as ``1 - (1 + k / inv_gamma) ** -power``, clamped to
  [min_value, beta], with ``k = max(step - update_after_step - 1, 0)``; at
  k = 0 it is 0, so before ``update_after_step`` an update copies the
  parameters.

The average is fp32 copies of the parameters, updated with
``torch._foreach_*`` in the JAX form ``ema * d + p * (1 - d)``.

:func:`ema_step_decay` counts a call and gives its decay (1 where the
average holds); :func:`ema_apply_` moves the average.  ``ema_update`` is
the two on the host; a CUDA graph of the training step, which cannot
branch on the step, runs :func:`ema_apply_` every step with the factors
(d, 1 - d) read from the device (``ema * 1 + p * 0`` is ``ema``, bit for
bit).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch


@dataclasses.dataclass
class EMAState:
    params: List[torch.Tensor]  # fp32 copies, in the model's parameter order
    step: int = 0  # ema_update calls


def ema_init(params: Sequence[torch.Tensor]) -> EMAState:
    return EMAState(params=[p.detach().float().clone() for p in params], step=0)


def ema_decay(step: int, beta: float = 0.995, update_after_step: int = 100,
              inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
              min_value: float = 0.0) -> float:
    """The decay an update at ``step`` (counted from 1) applies, in fp32 as
    the JAX rule computes it."""
    k = np.float32(max(step - (update_after_step + 1), 0))
    value = np.float32(0.0) if k <= 0 else np.float32(1.0) - (
        np.float32(1.0) + k / np.float32(inv_gamma)) ** np.float32(-power)
    return float(np.clip(value, np.float32(min_value), np.float32(beta)))


def ema_step_decay(state: EMAState, beta: float = 0.995, update_every: int = 10,
                   update_after_step: int = 100, inv_gamma: float = 1.0,
                   power: float = 2.0 / 3.0, min_value: float = 0.0) -> float:
    """Count one update call and return the decay it applies:
    :func:`ema_decay` at the steps that move the average, 1.0 at the
    others."""
    state.step += 1
    if state.step % update_every:
        return 1.0
    return ema_decay(state.step, beta, update_after_step, inv_gamma, power, min_value)


def ema_apply_(state: EMAState, params: Sequence[torch.Tensor],
               decay: Union[float, torch.Tensor], one_minus_decay: Union[float, torch.Tensor]
               ) -> None:
    """``ema = ema * decay + p * one_minus_decay``, in place; the factors
    are floats or 0-d tensors on the device (a graph's, read at replay)."""
    torch._foreach_mul_(state.params, decay)
    torch._foreach_add_(state.params, torch._foreach_mul(
        [p.detach().float() for p in params], one_minus_decay))


def ema_update(state: EMAState, params: Sequence[torch.Tensor], beta: float = 0.995,
               update_every: int = 10, update_after_step: int = 100, inv_gamma: float = 1.0,
               power: float = 2.0 / 3.0, min_value: float = 0.0) -> EMAState:
    """One update call, in place: counts the step and, every ``update_every``
    steps, moves the average to ``ema * d + p * (1 - d)``."""
    d = ema_step_decay(state, beta, update_every, update_after_step, inv_gamma, power, min_value)
    if d != 1.0:
        ema_apply_(state, params, d, 1.0 - d)
    return state
