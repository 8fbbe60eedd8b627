"""The precision the kernels' plain PyTorch versions compute in.

A plain version is the port's whole CPU path and the yardstick every kernel
is held to on the card, so it fixes its own arithmetic instead of taking the
process's:

* :func:`exact` runs a block with autocast off and every float32 matrix
  product in full IEEE float32, whatever the process set before:
  ``torch.set_float32_matmul_precision("medium")`` (which on a CPU with
  bf16 units, AVX512-BF16 or AMX, runs float32 products in bf16),
  ``"high"``, ``torch.backends.mkldnn.matmul.fp32_precision``
  ``"bf16"`` or ``"tf32"``, ``torch.backends.fp32_precision``, or TF32
  through ``torch.backends.cuda.matmul`` on the card.  The process's
  settings come back when the block ends.
* :func:`wide` gives a tensor in the working precision: fp32 for fp32 and
  bf16 inputs, float64 for float64 inputs.  A plain version called on
  float64 tensors so evaluates the same steps in float64, which
  ``chip_smoke.py`` takes as the yardstick of both the fp32 kernels and
  the fp32 plain versions.

``torch.backends`` is process-wide: another thread's float32 products while
a block runs are exact too.
"""

from __future__ import annotations

import contextlib

import torch


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in the plain versions' working precision: float64 stays float64,
    every other dtype becomes fp32."""
    return t if t.dtype == torch.float64 else t.float()


@contextlib.contextmanager
def exact(device_type: str):
    """Autocast off and IEEE float32 matrix products (oneDNN on the CPU,
    cuBLAS on the card) for the block; the settings before it restored
    after it."""
    mkldnn, cuda = torch.backends.mkldnn.matmul, torch.backends.cuda.matmul
    saved = mkldnn.fp32_precision, cuda.fp32_precision
    mkldnn.fp32_precision = cuda.fp32_precision = "ieee"
    try:
        with torch.autocast(device_type, enabled=False):
            yield
    finally:
        mkldnn.fp32_precision, cuda.fp32_precision = saved
