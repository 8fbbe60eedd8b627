"""The whole Swin block in CUDA kernels for Hopper, forward and backward, their
plain PyTorch versions, and the autograd Function joining them.

The kernels (``dmhomo_torch/csrc/swin_block.cu``) replace the Pallas TPU
kernels ``dmhomo_tpu/ops/swin_block.py::_fwd_kernel`` and ``::_bwd_kernel``.
Forward, on (B, H, W, C) tokens, with round() the rounding to the I/O dtype
and 8x8 windows:

* ``n1 = round(LN1(x))`` (fp32 statistics, biased variance, eps 1e-5);
* ``qkv = round(n1 . round(Wq) + bq)`` (fp32 accumulation);
* per window and head, the max-free window attention of
  ``ops/window_attention.py`` (q scaled by hd**-0.5 in the I/O dtype;
  ``e = round(exp(clip(q k^T + bias (+ mask), +-60)))``;
  ``round((e v) / sum(e))``);
* ``p = round(att . round(Wp) + bp)``, ``h = round(x + p)``;
* ``n2 = round(LN2(h))``, ``m1 = n2 . round(W1) + c1`` (fp32),
  ``gm = round(gelu(m1))`` with the exact erf;
* ``y = round(h + round(gm . round(W2) + c2))``.

On the card the forward is one launch, one block per window (its grid,
shared memory and blocks per SM: :func:`forward_plan`): the bf16 launches
run every product on tensor cores from bf16 window buffers, the fp32 ones
on fp32 CUDA cores (TF32 stays off).

The backward recomputes that forward from x and follows ``_bwd_kernel`` step
by step (see :func:`swin_block_backward_reference`): dx in the I/O dtype and
the 13 parameter gradients in fp32, each summed over every window.  On the
card it is five kernels that sum the gradients without atomics, in a fixed
order (:func:`backward_plan`; the split's plain versions are
:func:`backward_window_reference` and :func:`weight_gradients_reference`).

A shifted block (SW-MSA) is the same function of ``roll(x, -shift)``, rolled
back by ``+shift``.  The plain versions roll with ``torch.roll``; the kernels
instead read and write each window's tokens at their coordinates shifted
mod (H, W), which is the same function without the copies.  The mask row of
a window is its index within its image.

Two variants, chosen by shape alone (:func:`variant`): the tuned library
above at the shipped shapes (8x8 windows, C in 24, 48, 96, head dims 4-32,
an MLP of 1-4 C); the generic one (``csrc/swin_block_any.cu``) at every other
shape of the envelope: any window ws <= 12 dividing H and W, C = heads x hd
with hd <= 64 and C <= 384, any MLP width 1..4 C, any shift < ws.  It runs
the same function as a fixed sequence of launches (the forward five, the
backward eleven: :func:`generic_forward_plan`,
:func:`generic_backward_plan`): the weights rounded and laid out once per
call, then products that each own a tile of token rows and every output
column (bf16 on tensor cores, fp32 on CUDA cores), every intermediate in
device memory at the plain version's precision, still without atomics.  A
shape outside the envelope raises before any launch.

Parameters come in the port's layout: LayerNorm gains and biases (C,), the
``nn.Linear`` weights (out, in) and biases, all fp32, and the (heads, N, N)
fp32 relative-position bias.  The CUDA library is built with ``nvcc``
at first use into ``build/kernels/`` of the checkout and called through a
plain C interface with ``ctypes``.  :func:`swin_block` runs the plain
versions for CPU tensors only (both directions: the explicit backward, not
autograd of the plain forward); for a CUDA tensor it launches the kernels or
raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import re
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from dmhomo_torch.ops.build import (CSRC, atomic_instructions, build_library, nvcc,
                                    tensor_core_instructions)
from dmhomo_torch.ops.plain import exact, wide
from dmhomo_torch.ops.window_attention import (
    HEAD_DIMS,
    MAX_HEAD_DIM,
    SMS,
    WINDOW_TOKENS,
    _scale_io,
    generic_launch_plan,
    window_attention_backward_reference,
    window_attention_reference,
)

WINDOW = 8
CHANNELS = (24, 48, 96)  # the widths of the shipped estimator's Swin levels
MAX_MLP_RATIO = 4  # hidden = mlp_ratio * C with mlp_ratio in 1..4
LN_EPS = 1e-5
PARAM_NAMES = ("g1", "b1", "wq", "bq", "bias", "wp", "bp", "g2", "b2", "w1", "c1", "w2", "c2")
# the envelope of the generic variant
MAX_WINDOW = 12  # the largest published Swin window
MAX_CHANNELS = 384

_SOURCE = CSRC / "swin_block.cu"
_SOURCE_ANY = CSRC / "swin_block_any.cu"

# The backward's five kernels, in launch order (csrc/swin_block.cu): the
# forward recomputed with the MLP's, LN2's and the projection's backward
# (one block per window); the attention's backward (one block per head and
# chunk of windows); dx (one block per window); the weight gradients over
# token splits; the fixed-order sum of every partial.
BACKWARD_KERNELS = ("recompute", "attention", "input", "weights", "reduce")
# The backward's scratch buffers, in the order the library lays them out in
# one allocation: what the window kernels write for the weight-gradient
# product (token rows in window order), then the partials per window, token
# split and chunk.
SCRATCH = ("n1", "qkv", "ao", "n2", "gm", "dm1", "dh", "dao", "ln", "wpart", "bpart")
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 233472  # bytes of shared memory an SM shares among its blocks
SMEM_PER_BLOCK = 232448  # the most one block may ask for
SMEM_RESERVED = 1024  # bytes the card keeps per resident block
THREADS = 256  # the window kernels' and the weight kernel's blocks
ATT_THREADS = 128  # the attention's backward: four warps, one head
ATT_MAX_BLOCKS = 3  # attention blocks per SM the grid is sized for (its launch bounds)
ELD = WINDOW_TOKENS + 4  # row stride (floats) of a 64 x 64 tile in shared memory


def _ln_stats(xf: torch.Tensor):
    """(xhat, rstd) of an fp32 LayerNorm over the last axis: two-pass
    statistics, eps 1e-5."""
    xc = xf - xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)
    return xc * rstd, rstd


def _layer_norm(xf: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis."""
    return _ln_stats(xf)[0] * wide(g) + wide(b)


def _ln_backward(dn: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor):
    """fp32 LayerNorm input gradient, and the gain and bias gradients summed
    over the tokens."""
    dxh = dn * wide(g)
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    return (rstd * (dxh - m1 - xhat * m2), _tokens(dn * xhat).sum(0), _tokens(dn).sum(0))


def _tokens(t: torch.Tensor) -> torch.Tensor:
    """(..., K) -> (tokens, K)."""
    return t.reshape(-1, t.shape[-1])


def _windows(t: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, K) -> (B * nW, ws * ws, K), windows image-major."""
    B, H, W, K = t.shape
    t = t.reshape(B, H // ws, ws, W // ws, ws, K).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, ws * ws, K)


def _unwindows(t: torch.Tensor, B: int, H: int, W: int, ws: int) -> torch.Tensor:
    """(B * nW, ws * ws, K) -> (B, H, W, K)."""
    t = t.reshape(B, H // ws, W // ws, ws, ws, t.shape[-1]).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(B, H, W, -1)


def _linear(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, dt) -> torch.Tensor:
    """fp32 a . round(W)^T + bias for an (out, in) weight."""
    return torch.matmul(wide(a), wide(w.to(dt)).t()) + wide(bias)


def swin_block_reference(x: torch.Tensor, params, mask: "torch.Tensor | None" = None, *,
                         num_heads: int, window_size: int = WINDOW,
                         shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version: x (B, H, W, C) -> (B, H, W, C) in x.dtype, step
    by step as the Pallas ``_fwd_kernel``.  ``params`` is ``(g1, b1, wq, bq,
    bias, wp, bp, g2, b2, w1, c1, w2, c2)``; mask (nW, N, N) of 0 / -100 or
    None.  Its products are IEEE fp32 (float64 for float64 inputs) with
    autocast off, whatever the process set (``ops/plain.py``)."""
    g1, b1, wq, bq, bias, wp, bp, g2, b2, w1, c1, w2, c2 = params
    dt = x.dtype
    B, H, W, C = x.shape
    ws = window_size
    with exact(x.device.type):
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        n1 = _layer_norm(wide(x), g1, b1).to(dt)
        qkv = _linear(n1, wq, bq, dt).to(dt)
        att = window_attention_reference(_windows(qkv, ws), bias, mask, num_heads=num_heads)
        att = _unwindows(att, B, H, W, ws)
        p = _linear(att, wp, bp, dt).to(dt)
        h = (wide(x) + wide(p)).to(dt)
        n2 = _layer_norm(wide(h), g2, b2).to(dt)
        gm = F.gelu(_linear(n2, w1, c1, dt)).to(dt)
        m2 = _linear(gm, w2, c2, dt).to(dt)
        y = (wide(h) + wide(m2)).to(dt)
        if shift:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    return y


def swin_block_backward_reference(x: torch.Tensor, params, mask: "torch.Tensor | None",
                                  dy: torch.Tensor, *, num_heads: int,
                                  window_size: int = WINDOW, shift: int = 0):
    """Plain PyTorch version of the backward: ``(dx, grads)`` with dx
    (B, H, W, C) in x.dtype and ``grads`` the 13 fp32 parameter gradients in
    ``PARAM_NAMES`` order and the port's layout, each summed over every
    window; step by step as the Pallas ``_bwd_kernel`` (it recomputes the
    forward from x).  Where round() is the rounding to the I/O dtype: the
    weight gradients contract a rounded activation with an fp32 gradient;
    ``dm1 = (dy . round(W2)^T) * gelu'(m1)`` and ``dh = dy + LN2'(round(dm1)
    . round(W1))`` stay fp32; the attention's input gradient is
    ``round(round(dh) . round(Wp))``, and its backward that of
    ``ops/window_attention.py``; ``dx = round(dh + LN1'(dqkv .
    round(Wq)))``.  The mask gets no gradient.  Computes as
    :func:`swin_block_reference`."""
    g1, b1, wq, bq, bias, wp, bp, g2, b2, w1, c1, w2, c2 = params
    dt = x.dtype
    B, H, W, C = x.shape
    ws = window_size
    with exact(x.device.type):
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            dy = torch.roll(dy, shifts=(-shift, -shift), dims=(1, 2))
        # the forward, recomputed
        xhat1, rstd1 = _ln_stats(wide(x))
        n1 = (xhat1 * wide(g1) + wide(b1)).to(dt)
        qkv3 = _windows(_linear(n1, wq, bq, dt).to(dt), ws)
        ao = _unwindows(window_attention_reference(qkv3, bias, mask, num_heads=num_heads),
                        B, H, W, ws)
        h = (wide(x) + wide(_linear(ao, wp, bp, dt).to(dt))).to(dt)
        xhat2, rstd2 = _ln_stats(wide(h))
        n2 = (xhat2 * wide(g2) + wide(b2)).to(dt)
        m1 = _linear(n2, w1, c1, dt)
        cdf = 0.5 * (1.0 + torch.erf(m1 * 0.5**0.5))
        gm = (m1 * cdf).to(dt)
        dgelu = cdf + m1 * torch.exp(-0.5 * m1 * m1) / math.sqrt(2.0 * math.pi)
        # y = h + round(gm . W2^T + c2); dy is in the I/O dtype already
        dyf = wide(dy)
        dw2 = _tokens(dyf).t() @ _tokens(wide(gm))
        dc2 = _tokens(dyf).sum(0)
        dm1 = (dyf @ wide(w2.to(dt))) * dgelu
        dw1 = _tokens(dm1).t() @ _tokens(wide(n2))
        dc1 = _tokens(dm1).sum(0)
        dn2 = wide(dm1.to(dt)) @ wide(w1.to(dt))
        dh_ln, dg2, db2 = _ln_backward(dn2, xhat2, rstd2, g2)
        dh = dyf + dh_ln
        # h = x + round(ao . Wp^T + bp)
        dwp = _tokens(dh).t() @ _tokens(wide(ao))
        dbp = _tokens(dh).sum(0)
        dao = (wide(dh.to(dt)) @ wide(wp.to(dt))).to(dt)
        dqkv3, dbias = window_attention_backward_reference(qkv3, bias, mask, _windows(dao, ws),
                                                           num_heads=num_heads)
        dqkv = wide(_unwindows(dqkv3, B, H, W, ws))
        dwq = _tokens(dqkv).t() @ _tokens(wide(n1))
        dbq = _tokens(dqkv).sum(0)
        dx_ln, dg1, db1 = _ln_backward(dqkv @ wide(wq.to(dt)), xhat1, rstd1, g1)
        dx = (dh + dx_ln).to(dt)
        if shift:
            dx = torch.roll(dx, shifts=(shift, shift), dims=(1, 2))
    return dx, (dg1, db1, dwq, dbq, dbias, dwp, dbp, dg2, db2, dw1, dc1, dw2, dc2)


def backward_window_reference(x: torch.Tensor, params, mask: "torch.Tensor | None",
                              dy: torch.Tensor, *, num_heads: int, window_size: int = WINDOW,
                              shift: int = 0):
    """Plain version of the backward's per-window part, as the card splits
    the work: ``(dx, operands, grads)`` with dx as
    :func:`swin_block_backward_reference` gives it; ``operands`` the
    activations and gradients the weight-gradient product reduces over the
    tokens (``n1``, ``dqkv``, ``ao``, ``n2``, ``gm``, ``dy`` in the I/O dtype,
    ``dm1`` and ``dh`` fp32; (B, H, W, width) in the shifted frame); ``grads``
    the gradients summed with the windows (``g1``, ``b1``, ``bias``, ``g2``,
    ``b2``).  Step by step as the reference, so that with
    :func:`weight_gradients_reference` it gives the reference's gradients."""
    g1, b1, wq, bq, bias, wp, bp, g2, b2, w1, c1, w2, c2 = params
    dt = x.dtype
    B, H, W, C = x.shape
    ws = window_size
    with exact(x.device.type):
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            dy = torch.roll(dy, shifts=(-shift, -shift), dims=(1, 2))
        xhat1, rstd1 = _ln_stats(wide(x))
        n1 = (xhat1 * wide(g1) + wide(b1)).to(dt)
        qkv3 = _windows(_linear(n1, wq, bq, dt).to(dt), ws)
        ao = _unwindows(window_attention_reference(qkv3, bias, mask, num_heads=num_heads),
                        B, H, W, ws)
        h = (wide(x) + wide(_linear(ao, wp, bp, dt).to(dt))).to(dt)
        xhat2, rstd2 = _ln_stats(wide(h))
        n2 = (xhat2 * wide(g2) + wide(b2)).to(dt)
        m1 = _linear(n2, w1, c1, dt)
        cdf = 0.5 * (1.0 + torch.erf(m1 * 0.5**0.5))
        gm = (m1 * cdf).to(dt)
        dgelu = cdf + m1 * torch.exp(-0.5 * m1 * m1) / math.sqrt(2.0 * math.pi)
        dyf = wide(dy)
        dm1 = (dyf @ wide(w2.to(dt))) * dgelu
        dn2 = wide(dm1.to(dt)) @ wide(w1.to(dt))
        dh_ln, dg2, db2 = _ln_backward(dn2, xhat2, rstd2, g2)
        dh = dyf + dh_ln
        dao = (wide(dh.to(dt)) @ wide(wp.to(dt))).to(dt)
        dqkv3, dbias = window_attention_backward_reference(qkv3, bias, mask, _windows(dao, ws),
                                                           num_heads=num_heads)
        dqkv = _unwindows(dqkv3, B, H, W, ws)
        dx_ln, dg1, db1 = _ln_backward(wide(dqkv) @ wide(wq.to(dt)), xhat1, rstd1, g1)
        dx = (dh + dx_ln).to(dt)
        if shift:
            dx = torch.roll(dx, shifts=(shift, shift), dims=(1, 2))
    operands = {"n1": n1, "dqkv": dqkv, "ao": ao, "n2": n2, "gm": gm, "dy": dy, "dm1": dm1,
                "dh": dh}
    return dx, operands, {"g1": dg1, "b1": db1, "bias": dbias, "g2": dg2, "b2": db2}


# weight gradient = left^T right over the tokens; bias vector = column sums of left
WEIGHT_PRODUCTS = {"w2": ("dy", "gm"), "w1": ("dm1", "n2"), "wp": ("dh", "ao"),
                   "wq": ("dqkv", "n1")}
VECTOR_SUMS = {"c2": "dy", "c1": "dm1", "bp": "dh", "bq": "dqkv"}


def weight_gradients_reference(operands: dict, split_tokens: "int | None" = None) -> dict:
    """Plain version of the weight-gradient product: the four weight
    gradients (port layout) and four bias-vector gradients from
    :func:`backward_window_reference`'s operands, fp32.  ``split_tokens``
    None: over the tokens in image order, as the reference sums them;
    otherwise as the card does, over window-ordered tokens in ranges of
    ``split_tokens``, the ranges' partials added in order."""
    def rows(t):
        t = wide(t)
        return _tokens(t) if split_tokens is None else _tokens(_windows(t, WINDOW))

    def ranges(a, fn):
        if split_tokens is None:
            return fn(a, slice(None))
        out = None
        for s in range(0, a.shape[0], split_tokens):
            part = fn(a, slice(s, s + split_tokens))
            out = part if out is None else out + part
        return out

    out = {}
    with exact(operands["dy"].device.type):
        for name, (left, right) in WEIGHT_PRODUCTS.items():
            a, b = rows(operands[left]), rows(operands[right])
            out[name] = ranges(a, lambda a, r: a[r].t() @ b[r])
        for name, left in VECTOR_SUMS.items():
            out[name] = ranges(rows(operands[left]), lambda a, r: a[r].sum(0))
    return out


def _pad(width: int, bf16: bool = False) -> int:
    """Row stride (floats) of a shared buffer ``width`` floats wide: 4 (mod
    8) for the fp32 kernels' float4 reads; the bf16 backward's window
    buffers 8 (mod 16), for the tensor-core fragments' float2 reads."""
    if bf16:
        return width + (8 if (width + 8) % 16 == 8 else 16)
    return width + 4


def _weight_windows(C: int) -> int:
    """Windows of tokens the weight-gradient kernel stages at a time."""
    return 2 if C <= 24 else 1


def _weight_blocks_per_sm(C: int) -> int:
    """Weight-gradient blocks per SM (the kernel's launch bounds): the splits
    fill the card with them once."""
    return 4 if C <= 24 else 2


def _blocks_per_sm(smem: int, threads: int) -> int:
    """Blocks of one kernel an SM holds by shared memory and threads (the
    registers may allow fewer: the build's ptxas report gives them)."""
    return min(SMEM_PER_SM // (smem + SMEM_RESERVED), 2048 // threads)


def old_backward_atomics(windows: int, C: int, heads: int, hidden: int) -> int:
    """Global atomics of one launch of the per-window backward kernel this
    design replaced: every window added its 2C*hidden + 4C^2 weight-gradient
    elements, 5C + hidden bias-vector and 4C LayerNorm elements and
    heads*4096 dbias elements with one atomicAdd each."""
    return windows * (2 * C * hidden + 4 * C * C + 9 * C + hidden + heads * 64 * 64)


@functools.lru_cache(maxsize=None)
def _backward_plan(B: int, H: int, W: int, C: int, heads: int, hidden: int, itemsize: int,
                   masked: bool) -> dict:
    N = WINDOW_TOKENS
    hd = C // heads
    windows = B * (H // WINDOW) * (W // WINDOW)
    tokens = windows * N
    f = 4  # bytes per float
    bf = itemsize == 2
    ld, ldq = _pad(C, bf), _pad(3 * C, bf)
    smem = {
        "recompute": f * (3 * N * ld + N * ldq + (C * ld if bf else max(C * ld, 2 * N * ELD))
                          + 2 * N),
        "attention": f * (3 * N * ELD + 5 * N * (hd + 4)),
        "input": f * (2 * N * ld + N * ldq + C * ld + 2 * N),
        "weights": f * 2 * _weight_windows(C) * N * _pad(C),
    }
    threads = {"recompute": THREADS, "attention": ATT_THREADS, "input": THREADS,
               "weights": THREADS}
    per_sm = {k: _blocks_per_sm(smem[k], threads[k]) for k in smem}
    # the attention: (heads, chunks) blocks filling the card once
    att_sm = min(per_sm["attention"], ATT_MAX_BLOCKS)
    chunks = min(windows, max(1, -(-SMS * att_sm // heads)))
    per_block = -(-windows // chunks)
    chunks = -(-windows // per_block)
    # the weights: 2R + 4 C x C blocks times token splits, about two blocks per SM
    wblocks = 2 * (hidden // C) + 4
    splits = max(1, SMS * min(per_sm["weights"], _weight_blocks_per_sm(C)) // wblocks)
    split_tokens = N * -(-tokens // (splits * N))
    splits = -(-tokens // split_tokens)
    part = 2 * C * hidden + 4 * C * C + 5 * C + hidden  # floats of one split's partial
    widths = {  # (bytes per element, elements)
        "n1": (itemsize, tokens * C), "qkv": (itemsize, tokens * 3 * C),
        "ao": (itemsize, tokens * C), "n2": (itemsize, tokens * C),
        "gm": (itemsize, tokens * hidden), "dm1": (f, tokens * hidden), "dh": (f, tokens * C),
        "dao": (itemsize, tokens * C), "ln": (f, windows * 4 * C), "wpart": (f, splits * part),
        "bpart": (f, chunks * heads * N * N),
    }
    scratch, offset = {}, 0
    for name in SCRATCH:
        nbytes = widths[name][0] * widths[name][1]
        scratch[name] = (offset, nbytes)
        offset += -(-nbytes // 256) * 256
    # the reduction: a warp per element for 64 partials or more, else a thread
    counts = {"ln": windows, "wpart": splits, "bpart": chunks}
    sizes = [("ln", C)] * 4 + [("wpart", n) for n in (3 * C * C, 3 * C, C * C, C, hidden * C,
                                                        hidden, C * hidden, C)]
    sizes.append(("bpart", heads * N * N))
    reduce_blocks = sum(-(-n // (THREADS // (32 if counts[src] >= 64 else 1)))
                        for src, n in sizes)
    kernels = {
        "recompute": {"grid": (windows,), "windows_per_block": 1},
        "attention": {"grid": (heads, chunks), "windows_per_block": per_block},
        "input": {"grid": (windows,), "windows_per_block": 1},
        "weights": {"grid": (splits, wblocks), "tokens_per_block": split_tokens},
        "reduce": {"grid": (reduce_blocks,), "threads": THREADS, "smem": 0},
    }
    for k in smem:
        kernels[k].update(threads=threads[k], smem=smem[k], blocks_per_sm=per_sm[k])
    return {
        "windows": windows, "tokens": tokens, "masked": masked, "kernels": kernels,
        "scratch": scratch, "scratch_bytes": offset,
        "partial_bytes": sum(scratch[k][1] for k in ("ln", "wpart", "bpart")),
        "atomics": 0, "atomics_old": old_backward_atomics(windows, C, heads, hidden),
    }


def backward_plan(x: torch.Tensor, num_heads: int, hidden: int,
                  mask: "torch.Tensor | None" = None, window_size: int = WINDOW) -> dict:
    """How :func:`swin_block_backward` launches its kernels on the card for x
    (B, H, W, C): per kernel (``BACKWARD_KERNELS``) the grid, threads,
    windows (or tokens) per block, dynamic shared memory and blocks per SM
    by shared memory and threads; the scratch (name -> (byte offset, bytes)
    in one buffer) and the partials' bytes; the global atomics per launch (0:
    the kernels hold no atomic instruction) and those of the per-window
    kernel this design replaced (``atomics_old``).  Computed from the shapes
    alone; the library carves the scratch itself
    (:func:`backward_scratch_layout`, which a ``gpu`` test holds this plan's
    ``scratch`` against).  At a generic shape (:func:`variant`),
    :func:`generic_backward_plan`."""
    B, H, W, C = x.shape
    if variant(window_size, C, num_heads, hidden) == "generic":
        return generic_backward_plan(x, num_heads, hidden, window_size)
    return _backward_plan(B, H, W, C, num_heads, hidden, x.element_size(), mask is not None)


@functools.lru_cache(maxsize=None)
def _forward_plan(B: int, H: int, W: int, C: int, itemsize: int) -> dict:
    N = WINDOW_TOKENS
    windows = B * (H // WINDOW) * (W // WINDOW)
    bf = itemsize == 2
    groups = 3 if C >= 96 else 1  # head groups of the qkv product
    group = C // groups
    ld, ldq = _pad(C, bf), _pad(3 * group, bf)  # elements of the I/O dtype
    # two window buffers, a group's q | k | v, one weight block and, for
    # bf16, its fp32 staging area
    smem = itemsize * (2 * N * ld + N * ldq + C * ld) + (4 * C * C if bf else 0)
    return {
        "windows": windows, "grid": (windows,), "threads": THREADS, "smem": smem,
        "blocks_per_sm": _blocks_per_sm(smem, THREADS), "head_groups": groups,
        "row_stride": ld, "qkv_row_stride": ldq,
    }


def forward_plan(x: torch.Tensor, num_heads: int, hidden: int,
                 window_size: int = WINDOW) -> dict:
    """How :func:`swin_block` launches its forward kernel on the card for x
    (B, H, W, C): one block of 256 threads per window (``grid``); its dynamic
    shared memory in bytes (two window buffers, rows ``row_stride`` elements
    apart, one for a head group's q | k | v, rows ``qkv_row_stride`` apart,
    and one C x C weight block, in the I/O dtype; bf16 adds the weight
    block's fp32 staging area); blocks per SM by shared memory and threads
    (the registers may allow fewer: :func:`forward_blocks_per_sm` asks the
    card); the head groups (three at C = 96, one below).  Computed from the
    shapes alone (the heads and the MLP width change none of it); a ``gpu``
    test holds ``smem`` to the library's.  At a generic shape
    (:func:`variant`), :func:`generic_forward_plan`."""
    B, H, W, C = x.shape
    if variant(window_size, C, num_heads, hidden) == "generic":
        return generic_forward_plan(x, num_heads, hidden, window_size)
    return _forward_plan(B, H, W, C, x.element_size())


def variant(window_size: int, C: int, heads: int, hidden: int) -> str:
    """The kernels a block shape takes: ``"tuned"`` at 8x8 windows, C in
    ``CHANNELS``, a head dim in ``HEAD_DIMS`` and an MLP of 1-4 C;
    ``"generic"`` at every other shape."""
    tuned = (window_size == WINDOW and C in CHANNELS and C % heads == 0
             and C // heads in HEAD_DIMS and hidden % C == 0
             and 1 <= hidden // C <= MAX_MLP_RATIO)
    return "tuned" if tuned else "generic"


# the generic variant's launches, in order (csrc/swin_block_any.cu)
# ("proj_fc1": the projection, then LN2 and fc1 on the same rows, one launch)
GENERIC_FORWARD = ("prep", "qkv", "attention", "proj_fc1", "fc2")
GENERIC_BACKWARD = ("prep", "qkv", "attention", "proj_fc1", "dm1", "dn2", "dao",
                    "attention_bwd", "dn1", "weights", "reduce")
# the products with the LayerNorm backward fused after them (dn2: LN2, dn1: LN1)
GENERIC_LNB = ("dn2", "dn1")
# its scratch buffers, in the order the library lays them out in one allocation
# ("w": the prepared weights)
GENERIC_FORWARD_SCRATCH = ("w", "qkv", "ao", "h", "gm")
GENERIC_SCRATCH = ("w", "n1", "qkv", "ao", "h", "n2", "m1", "gm", "dy", "dn", "dh", "dao",
                   "dqkv", "wpart", "lnpart", "bpart")
ANY_THREADS = 256
LN_MAX_BLOCKS = SMS * 8  # the blocks of a product with the fused LayerNorm backward at most
PREP_MAX_BLOCKS = SMS * 8  # the preparing launch's blocks at most
ANY_WEIGHT_BLOCKS_PER_SM = 16  # the weight products' splits aim at
WEIGHT_TILE = 64  # a weight product's output tile side
# a product block: bf16 64 rows x 64 columns a chunk, ring stages 32 deep;
# fp32 4096 outputs a chunk (4 x 4 a thread), ring stages 32 deep (16 where
# 32 does not fit)
TC_ROWS, TC_COLS, TC_DEPTH = 64, 64, 32
F_OUTPUTS, F_DEPTH = 4096, 32
GEMM_BLOCKS_PER_SM = 4  # the products' launch bounds


def _row_lanes(C: int) -> int:
    """Lanes that share a LayerNorm row of C values (at most 12 a lane)."""
    return 32 if C > 192 else 16 if C > 96 else 8


def _align(nbytes: int) -> int:
    return -(-nbytes // 256) * 256


def _offsets(names, sizes) -> tuple:
    scratch, offset = {}, 0
    for name, nbytes in zip(names, sizes):
        scratch[name] = (offset, nbytes)
        offset += _align(nbytes)
    return scratch, offset


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _gemm_tile(products, bf16: bool, M: int, lnb_c: int = 0) -> dict:
    """The block of a launch of chained products ((depth K, width N) each)
    over M rows: rows, columns a chunk, ring stage depth, dynamic shared
    memory (the deepest product's staged rows, a two-stage weight ring, the
    rows' image indices and, with the fused LayerNorm backward of C = lnb_c
    columns, each row group's partials).  fp32: the chunk whose padded work
    an SM takes, in whole waves of the blocks it holds, is least, among
    those that let an SM hold two blocks where any does, ring stages 32
    deep where that fits as well, else 16."""
    extra = ANY_THREADS // _row_lanes(lnb_c) * 2 * lnb_c * 4 if lnb_c else 0

    def smem(bm, bn, kc):
        if bf16:
            return max(bm * (_up(K, 16) + 8) * 2 for K, _ in products) + 2 * kc * (bn + 8) * 2 \
                + bm * 8 + extra
        return max(bm * (_up(_up(K, 4), 8) + 4) * 4 for K, _ in products) + 2 * kc * bn * 4 \
            + bm * 8 + extra

    if bf16:
        return {"rows": TC_ROWS, "cols": TC_COLS, "stage_depth": TC_DEPTH,
                "smem": smem(TC_ROWS, TC_COLS, TC_DEPTH)}
    best = None
    for kc in (F_DEPTH, F_DEPTH // 2):
        for bn in (32, 64, 128, 256, 512):
            bm = F_OUTPUTS // bn
            b = smem(bm, bn, kc)
            if b > SMEM_PER_BLOCK:
                continue
            per_sm = min(GEMM_BLOCKS_PER_SM, SMEM_PER_SM // (b + SMEM_RESERVED))
            waves = -(-(-(-M // bm)) // (SMS * per_sm))
            key = (per_sm < 2, sum(waves * per_sm * bm * _up(N, bn) for _, N in products))
            if best is None or key < best[0]:
                best = (key, {"rows": bm, "cols": bn, "stage_depth": kc, "smem": b})
    return best[1]


def _prepared(C: int, hidden: int, bf16: bool, itemsize: int) -> list:
    """The prepared weight matrices (K, N, padded K, padded N, bytes): the
    forward's four (each W transposed), then the backward's own four."""
    dims = ((C, 3 * C), (C, C), (C, hidden), (hidden, C), (C, hidden), (hidden, C), (C, C),
            (3 * C, C))
    return [(k, n, _up(k, 16 if bf16 else 4), _up(n, 8),
             _up(k, 16 if bf16 else 4) * _up(n, 8) * itemsize) for k, n in dims]


@functools.lru_cache(maxsize=None)
def _generic_plan(B: int, H: int, W: int, C: int, heads: int, hidden: int, ws: int,
                  itemsize: int, backward: bool) -> dict:
    M = B * H * W
    N = ws * ws
    Bn = M // N
    hd = C // heads
    bf16 = itemsize == 2
    att_f = generic_launch_plan(Bn, N, hd, heads, False, itemsize)
    att_b = generic_launch_plan(Bn, N, hd, heads, True, itemsize)
    # the weight products: w2 (C x hidden), w1 (hidden x C), wp (C x C), wq (3C x C),
    # each with a ones column for its bias vector
    jobs = ((C, hidden), (hidden, C), (C, C), (3 * C, C))
    tiles = [-(-n // WEIGHT_TILE) * -(-(k + 1) // WEIGHT_TILE) for n, k in jobs]
    splits = max(1, min(SMS * ANY_WEIGHT_BLOCKS_PER_SM // sum(tiles), -(-M // 256)))
    tokens_per_split = -(-M // splits)
    splits = -(-M // tokens_per_split)
    elems = [n * (k + 1) for n, k in jobs] + [2 * C, 2 * C, heads * N * N]
    reduce_blocks = -(-sum(elems) // (ANY_THREADS // 32))
    mats = _prepared(C, hidden, bf16, itemsize)[:8 if backward else 4]
    prep_elems = sum(kp * np_ for _, _, kp, np_, _ in mats)
    depth = {"qkv": C, "proj": C, "fc1": C, "fc2": hidden, "dm1": C, "dn2": hidden, "dao": C,
             "dn1": 3 * C}
    width = {"qkv": 3 * C, "proj": C, "fc1": hidden, "fc2": C, "dm1": hidden, "dn2": C,
             "dao": C, "dn1": C}
    chains = {"proj_fc1": ("proj", "fc1")}

    def gemm(name):
        products = [(depth[n], width[n]) for n in chains.get(name, (name,))]
        t = _gemm_tile(products, bf16, M, C if name in GENERIC_LNB else 0)
        tiles = -(-M // t["rows"])
        per = 1
        if name in GENERIC_LNB:  # at most LN_MAX_BLOCKS blocks, each consecutive tiles
            per = -(-tiles // min(tiles, LN_MAX_BLOCKS))
        return {"grid": (-(-tiles // per), 1, 1), "threads": ANY_THREADS, "smem": t["smem"],
                "rows": t["rows"], "cols": t["cols"], "stage_depth": t["stage_depth"],
                "products": products, "tiles_per_block": per}

    def att(p):
        return {"grid": p["grid"] + (1,), "threads": p["threads"], "smem": p["smem"],
                "windows_per_block": p["windows_per_block"]}

    it = itemsize
    launches = {"prep": {"grid": (min(-(-prep_elems // ANY_THREADS), PREP_MAX_BLOCKS), 1, 1),
                         "threads": ANY_THREADS, "smem": 0, "matrices": len(mats)},
                "qkv": gemm("qkv"), "attention": att(att_f), "proj_fc1": gemm("proj_fc1")}
    w_bytes = sum(_align(b) for *_, b in mats)
    if not backward:
        launches["fc2"] = gemm("fc2")
        scratch, total = _offsets(GENERIC_FORWARD_SCRATCH, (w_bytes, it * M * 3 * C, it * M * C,
                                                           it * M * C, it * M * hidden))
    else:
        launches.update({
            "dm1": gemm("dm1"), "dn2": gemm("dn2"), "dao": gemm("dao"),
            "attention_bwd": dict(att(att_b), partials=att_b["partials"]), "dn1": gemm("dn1"),
            "weights": {"grid": (max(tiles), splits, 4), "threads": ANY_THREADS, "smem": 0,
                        "tokens_per_split": tokens_per_split},
            "reduce": {"grid": (reduce_blocks, 1, 1), "threads": ANY_THREADS, "smem": 0},
        })
        f = 4
        sizes = (w_bytes, it * M * C, it * M * 3 * C, it * M * C, it * M * C, it * M * C,
                 f * M * hidden, it * M * hidden, it * M * C, f * M * C, f * M * C,
                 it * M * C, it * M * 3 * C, f * splits * sum(n * (k + 1) for n, k in jobs),
                 f * 2 * C * (launches["dn2"]["grid"][0] + launches["dn1"]["grid"][0]),
                 f * att_b["partials"] * heads * N * N)
        scratch, total = _offsets(GENERIC_SCRATCH, sizes)
    return {"variant": "generic", "windows": Bn, "window_tokens": N, "tokens": M,
            "launches": launches, "scratch": scratch, "scratch_bytes": total, "atomics": 0}


def generic_forward_plan(x: torch.Tensor, num_heads: int, hidden: int,
                         window_size: int) -> dict:
    """How the generic forward launches for x (B, H, W, C), from the shapes
    alone, as ``csrc/swin_block_any.cu`` computes it: per launch
    (``GENERIC_FORWARD``, in order) its grid (x, y, z), threads and dynamic
    shared memory (the attention's windows per block too), the scratch (name
    -> (byte offset, bytes) in one buffer, ``GENERIC_FORWARD_SCRATCH``) and
    its size; ``variant`` ``"generic"``.  A description of the library's
    planner, held to it by :func:`generic_library_plan`: the wrappers size
    their scratch from the library's own layout entry point."""
    B, H, W, C = x.shape
    return _generic_plan(B, H, W, C, num_heads, hidden, window_size, x.element_size(), False)


def generic_backward_plan(x: torch.Tensor, num_heads: int, hidden: int,
                          window_size: int) -> dict:
    """The generic backward's eleven launches (``GENERIC_BACKWARD``) as
    :func:`generic_forward_plan` gives the forward's, with the tiles a block
    of dn2 and dn1 (the LayerNorm backward fused) takes, the weight
    products' tokens per split, the attention's dbias slabs (``partials``)
    and the scratch (``GENERIC_SCRATCH``); ``atomics`` 0: the library holds
    none."""
    B, H, W, C = x.shape
    return _generic_plan(B, H, W, C, num_heads, hidden, window_size, x.element_size(), True)


def build() -> Path:
    """Compile the kernel library for sm_90a (once per source content) and
    return its path."""
    return build_library(_SOURCE, "dmh_swin_block")


def build_generic() -> Path:
    """Compile the generic variant's library (``csrc/swin_block_any.cu`` and the
    window-attention header it includes) and return its path."""
    return build_library(_SOURCE_ANY, "dmh_swin_block_any")


def build_log() -> str:
    """nvcc's ptxas report (registers, shared memory, spills) of the build."""
    return build().with_suffix(".log").read_text()


def backward_atomic_instructions() -> dict:
    """Atomic instructions in the built library's machine code of each
    backward kernel (``BACKWARD_KERNELS`` -> count over its instantiations):
    none means no launch of the backward makes a global atomic.  Raises if
    a kernel is missing from the listing."""
    found = atomic_instructions(build(), "swin_block_bwd_")
    out = {}
    for k in BACKWARD_KERNELS:
        names = [n for n in found if f"swin_block_bwd_{k}_kernel" in n]
        if not names:
            raise RuntimeError(f"swin_block_bwd_{k}_kernel is not in the library's machine code")
        out[k] = sum(found[n] for n in names)
    return out


def forward_tensor_core_instructions() -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the built library's machine
    code of each forward instantiation: ``(dtype, C, hd)`` -> count.  The
    bf16 ones run their products on tensor cores, the fp32 ones on CUDA
    cores (TF32 off), so only the bf16 counts are above 0."""
    out = {}
    for name, n in tensor_core_instructions(build(), "swin_block_fwd_kernel").items():
        m = re.search(r"swin_block_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", name)
        if m is None:
            raise RuntimeError(f"unexpected forward instantiation {name}")
        dt = "float32" if m.group(1) == "f" else "bfloat16"
        out[(dt, int(m.group(2)), int(m.group(3)))] = n
    if not out:
        raise RuntimeError("swin_block_fwd_kernel is not in the library's machine code")
    return out


GENERIC_KERNELS = ("prep", "gemm", "weights", "attention_any_fwd", "attention_any_bwd", "reduce")


def generic_atomic_instructions() -> dict:
    """Atomic instructions in the generic library's machine code, per kernel
    (the preparing launch, the products, the weight products, the window
    attention's forward and backward, the reduction): any one fails
    ``chip_smoke.py``."""
    found = atomic_instructions(build_generic(), "_any_")
    for part in GENERIC_KERNELS:
        if not any(part in n for n in found):
            raise RuntimeError(f"the generic {part} kernel is not in the library's machine code")
    return found


_TEMPLATE_DTYPES = {"float": "float32", "__nv_bfloat16": "bfloat16"}


def generic_instantiation(signature: str) -> tuple:
    """``(kernel, dtype)`` of a generic kernel's demangled signature: its
    name in ``GENERIC_KERNELS`` and its first template argument as a dtype
    (``"none"`` for a kernel that is no template).  Raises on any other
    kernel or template argument, so that no instantiation goes unchecked."""
    for kernel in GENERIC_KERNELS:
        m = re.search(rf"{kernel}_kernel(<?)", signature)
        if m is None:
            continue
        if not m.group(1):
            return kernel, "none"
        arg = re.match(r"\s*([\w:]+)\s*[,>]", signature[m.end():])
        if arg is None or arg.group(1) not in _TEMPLATE_DTYPES:
            raise RuntimeError(f"unclassified instantiation {signature} in the generic library")
        return kernel, _TEMPLATE_DTYPES[arg.group(1)]
    raise RuntimeError(f"unexpected kernel {signature} in the generic library")


def generic_tensor_core_instructions() -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the generic library's
    machine code per kernel instantiation: ``(kernel, dtype)`` -> count over
    ``GENERIC_KERNELS``.  The bf16 products (``gemm``, ``weights``) run on
    tensor cores; every fp32 instantiation, and every kernel but the
    products, on CUDA cores (TF32 off)."""
    found = tensor_core_instructions(build_generic(), "_any_")
    tool = Path(nvcc()).with_name("cu++filt")
    proc = subprocess.run([str(tool)], input="\n".join(found), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cu++filt failed ({proc.returncode}): {proc.stderr}")
    out = {}
    for signature, n in zip(proc.stdout.splitlines(), found.values()):
        kernel, dtype = generic_instantiation(signature)
        out[(kernel, dtype)] = out.get((kernel, dtype), 0) + n
    missing = [k for k in ("gemm", "weights") if (k, "bfloat16") not in out]
    if missing:
        raise RuntimeError(f"the generic {missing} kernels are not in the library's machine code")
    return out


@functools.lru_cache(maxsize=None)
def _library_any() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_generic()))
    fn = lib.dmh_swin_block_any_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dmh_swin_block_any_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dmh_swin_block_any_scratch_layout
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    fn = lib.dmh_swin_block_any_plan
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


def generic_library_plan(x: torch.Tensor, num_heads: int, hidden: int, window_size: int,
                         backward: bool = False) -> dict:
    """Each generic launch as the library makes it (name -> grid (x, y, z),
    threads, dynamic shared memory) and its scratch layout (name -> byte
    offset, and ``"bytes"``): what a ``gpu`` test and ``chip_smoke.py`` hold
    :func:`generic_forward_plan` / :func:`generic_backward_plan` to.  Only
    the shape and dtype of x are read."""
    B, H, W, C = x.shape
    names = GENERIC_BACKWARD if backward else GENERIC_FORWARD
    bf16 = int(x.dtype == torch.bfloat16)
    raw = (ctypes.c_int * (5 * len(names)))()
    lib = _library_any()
    err = lib.dmh_swin_block_any_plan(B, H, W, C, num_heads, hidden, window_size, bf16,
                                      int(backward), raw)
    if err != 0:
        raise ValueError(f"the generic library refuses this shape: cudaError {err}")
    launches = {n: {"grid": tuple(raw[5 * i:5 * i + 3]), "threads": raw[5 * i + 3],
                    "smem": raw[5 * i + 4]} for i, n in enumerate(names)}
    return {"launches": launches, "scratch": _generic_layout(B, H, W, C, num_heads, hidden,
                                                             window_size, bf16, backward)}


@functools.lru_cache(maxsize=None)
def _generic_layout(B, H, W, C, heads, hidden, ws, bf16, backward) -> dict:
    names = GENERIC_SCRATCH if backward else GENERIC_FORWARD_SCRATCH
    off = (ctypes.c_longlong * (len(names) + 1))()
    err = _library_any().dmh_swin_block_any_scratch_layout(B, H, W, C, heads, hidden, ws, bf16,
                                                           int(backward), off)
    if err != 0:
        raise ValueError(f"the generic library refuses this shape: cudaError {err}")
    return dict(zip(names + ("bytes",), off))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.dmh_swin_block_fwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dmh_swin_block_bwd
    fn.argtypes = [ctypes.c_void_p] * (3 + 14 + 13 + 1) + [ctypes.c_longlong] + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dmh_swin_block_bwd_scratch_layout
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    lib.dmh_swin_block_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.dmh_swin_block_smem_bytes.restype = ctypes.c_int
    fn = lib.dmh_swin_block_fwd_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    lib.dmh_swin_block_bwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.dmh_swin_block_bwd_smem_bytes.restype = ctypes.c_int
    return lib


def shared_memory_bytes(C: int, hidden: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of the forward kernel asks for at I/O
    ``dtype``, as the library computes it."""
    return _library().dmh_swin_block_smem_bytes(C, hidden, int(dtype == torch.bfloat16))


def forward_blocks_per_sm(C: int, heads: int, dtype: torch.dtype) -> int:
    """Blocks of the forward kernel one SM of the current card holds (shared
    memory, registers and threads), by the CUDA occupancy calculator."""
    out = ctypes.c_int(0)
    err = _library().dmh_swin_block_fwd_blocks_per_sm(C, heads, int(dtype == torch.bfloat16),
                                                      ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return out.value


def backward_shared_memory_bytes(C: int, hd: int, kernel: str, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of a backward kernel (a key of
    ``BACKWARD_KERNELS``) asks for at I/O ``dtype``, as the library computes
    it."""
    return _library().dmh_swin_block_bwd_smem_bytes(C, hd, BACKWARD_KERNELS.index(kernel),
                                                    int(dtype == torch.bfloat16))


@functools.lru_cache(maxsize=None)
def _scratch_layout(B, H, W, C, heads, hidden, per_block, split_tokens, bf16) -> tuple:
    off = (ctypes.c_longlong * (len(SCRATCH) + 1))()
    err = _library().dmh_swin_block_bwd_scratch_layout(B, H, W, C, heads, hidden, per_block,
                                                       split_tokens, int(bf16), off)
    if err != 0:
        raise ValueError(f"the backward refuses this launch: cudaError {err}")
    return tuple(off)


def backward_scratch_layout(x: torch.Tensor, num_heads: int, hidden: int,
                            mask: "torch.Tensor | None" = None,
                            window_size: int = WINDOW) -> dict:
    """The backward's scratch as the library carves it for x (B, H, W, C)
    under :func:`backward_plan`'s grids: name (``SCRATCH``, or
    ``GENERIC_SCRATCH`` at a generic shape) -> byte offset, and ``"bytes"``,
    the size :func:`swin_block_backward` allocates."""
    B, H, W, C = x.shape
    if variant(window_size, C, num_heads, hidden) == "generic":
        return _generic_layout(B, H, W, C, num_heads, hidden, window_size,
                               int(x.dtype == torch.bfloat16), True)
    k = backward_plan(x, num_heads, hidden, mask)["kernels"]
    off = _scratch_layout(B, H, W, C, num_heads, hidden, k["attention"]["windows_per_block"],
                          k["weights"]["tokens_per_block"], x.dtype == torch.bfloat16)
    return dict(zip(SCRATCH + ("bytes",), off))


def _check_cuda_args(x, params, mask, num_heads, window_size, shift):
    """Raises on what no kernel takes.  The envelope: windows ws = 1..12
    dividing H and W, C = heads x hd with hd <= 64 and C <= 384, an MLP width
    1..4 C, 0 <= shift < ws, fp32 or bf16 x, fp32 contiguous 16-byte aligned
    parameters of the block's shapes, a mask (nW, ws^2, ws^2)."""
    ws = window_size
    if not 1 <= ws <= MAX_WINDOW:
        raise ValueError(f"the kernels take windows of 1..{MAX_WINDOW} tokens a side; got "
                         f"window_size={ws}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    B, H, W, C = x.shape
    if B == 0 or H == 0 or W == 0 or H % ws or W % ws:
        raise ValueError(f"H={H} and W={W} must be multiples of {ws} (the window), B={B} "
                         "positive")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"the kernels take C <= {MAX_CHANNELS}; got {C}")
    if num_heads < 1 or C % num_heads or C // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"head dim C/num_heads = {C}/{num_heads} must be a whole number "
                         f"1..{MAX_HEAD_DIM}")
    if not 0 <= shift < ws:
        raise ValueError(f"shift must be in [0, {ws}); got {shift}")
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"params must be {PARAM_NAMES}")
    hidden = params[PARAM_NAMES.index("c1")].shape[0]
    if not 1 <= hidden <= MAX_MLP_RATIO * C:
        raise ValueError(f"the MLP width {hidden} must be 1..{MAX_MLP_RATIO} x C={C}")
    N = ws * ws
    shapes = {"g1": (C,), "b1": (C,), "wq": (3 * C, C), "bq": (3 * C,),
              "bias": (num_heads, N, N), "wp": (C, C), "bp": (C,), "g2": (C,), "b2": (C,),
              "w1": (hidden, C), "c1": (hidden,), "w2": (C, hidden), "c2": (C,)}
    named = [("x", x, None)] + [(n, t, shapes[n]) for n, t in zip(PARAM_NAMES, params)]
    if mask is not None:
        named.append(("mask", mask, ((H // ws) * (W // ws), N, N)))
    for name, t, shape in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if shape is not None and (t.dtype != torch.float32 or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be float32 {shape}; got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_dy(x, dy):
    if dy.device != x.device or dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)} on {x.device}; "
                         f"got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError("dy must be contiguous and 16-byte aligned")


def _takes_generic(x, params, num_heads, window_size, generic: bool) -> bool:
    """Whether a checked launch goes to the generic library: by shape
    (:func:`variant`), or forced by the private ``_generic`` argument."""
    hidden = params[PARAM_NAMES.index("c1")].shape[0]
    return generic or variant(window_size, x.shape[3], num_heads, hidden) == "generic"


def _count(fn, x, num_heads, mask, generic: bool) -> None:
    fn.launches += 1
    fn.launches_by_shape[_shape_key(x, num_heads, mask)] += 1
    fn.launches_by_variant["generic" if generic else "tuned"] += 1


def _pointers(tensors) -> "ctypes.Array":
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _forward(x, params, mask, num_heads, window_size, shift, generic=False):
    if x.device.type == "cpu":
        return swin_block_reference(x, params, mask, num_heads=num_heads,
                                    window_size=window_size, shift=shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args(x, params, mask, num_heads, window_size, shift)
    generic = _takes_generic(x, params, num_heads, window_size, generic)
    B, H, W, C = x.shape
    hidden = params[PARAM_NAMES.index("c1")].shape[0]
    y = torch.empty_like(x)
    scale = _scale_io(C // num_heads, x.dtype)
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if generic:
            nbytes = _generic_layout(B, H, W, C, num_heads, hidden, window_size, bf16, 0)["bytes"]
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            err = _library_any().dmh_swin_block_any_fwd(
                x.data_ptr(), y.data_ptr(), _pointers(params),
                mask.data_ptr() if mask is not None else None, scratch.data_ptr(), nbytes,
                B, H, W, C, num_heads, hidden, window_size, shift, scale, bf16, stream)
        else:
            err = _library().dmh_swin_block_fwd(
                x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in params[:5]),
                mask.data_ptr() if mask is not None else None,
                *(t.data_ptr() for t in params[5:]), B, H, W, C, num_heads, hidden, shift,
                scale, bf16, stream)
    if err != 0:
        raise RuntimeError(f"swin block kernel launch failed: cudaError {err}")
    _count(swin_block, x, num_heads, mask, generic)
    return y


def swin_block_backward(x: torch.Tensor, params, mask: "torch.Tensor | None", dy: torch.Tensor,
                        *, num_heads: int, window_size: int = WINDOW, shift: int = 0,
                        _generic: bool = False):
    """Whole Swin block backward: ``(dx, grads)`` as
    :func:`swin_block_backward_reference` gives them.

    CUDA tensors go through the hand-written kernels of the shape's variant
    (``_generic`` forces the generic one): five launches planned by
    :func:`backward_plan` at the tuned shapes, eleven elsewhere
    (``launches`` counts each backward, ``launches_by_variant`` by
    variant); CPU tensors through :func:`swin_block_backward_reference`.
    """
    if x.device.type == "cpu":
        return swin_block_backward_reference(x, params, mask, dy, num_heads=num_heads,
                                             window_size=window_size, shift=shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args(x, params, mask, num_heads, window_size, shift)
    _check_dy(x, dy)
    generic = _takes_generic(x, params, num_heads, window_size, _generic)
    B, H, W, C = x.shape
    hidden = params[PARAM_NAMES.index("c1")].shape[0]
    dx = torch.empty_like(x)
    grads = tuple(torch.empty_like(p) for p in params)  # the kernels write every element
    hd = C // num_heads
    bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if generic:
            nbytes = _generic_layout(B, H, W, C, num_heads, hidden, window_size, bf16, 1)["bytes"]
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            err = _library_any().dmh_swin_block_any_bwd(
                x.data_ptr(), dy.data_ptr(), dx.data_ptr(), _pointers(params),
                mask.data_ptr() if mask is not None else None, _pointers(grads),
                scratch.data_ptr(), nbytes, B, H, W, C, num_heads, hidden, window_size, shift,
                _scale_io(hd, x.dtype), hd**-0.5, bf16, stream)
        else:
            kernels = backward_plan(x, num_heads, hidden, mask)["kernels"]
            nbytes = backward_scratch_layout(x, num_heads, hidden, mask)["bytes"]
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            err = _library().dmh_swin_block_bwd(
                x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in params[:5]),
                mask.data_ptr() if mask is not None else None,
                *(t.data_ptr() for t in params[5:]), *(g.data_ptr() for g in grads),
                scratch.data_ptr(), nbytes, B, H, W, C, num_heads, hidden, shift,
                _scale_io(hd, x.dtype), hd**-0.5, kernels["attention"]["windows_per_block"],
                kernels["weights"]["tokens_per_block"], bf16, stream)
    if err != 0:
        raise RuntimeError(f"swin block backward kernel launch failed: cudaError {err}")
    _count(swin_block_backward, x, num_heads, mask, generic)
    return dx, grads


def _shape_key(x, num_heads, mask) -> tuple:
    """(B, H, W, C, heads, dtype name, masked): the key of ``launches_by_shape``."""
    return (*x.shape, num_heads, str(x.dtype).split(".")[-1], mask is not None)


swin_block_backward.launches = 0
swin_block_backward.launches_by_shape = collections.Counter()
swin_block_backward.launches_by_variant = collections.Counter()


class SwinBlockFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    ``custom_vjp`` of ``fused_swin_block``).  Under autocast the inputs keep
    their dtypes: x stays as it comes, the parameters fp32."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, mask, num_heads, window_size, shift, generic, *params):
        ctx.save_for_backward(x, mask, *params)
        ctx.config = (num_heads, window_size, shift, generic)
        return _forward(x, params, mask, num_heads, window_size, shift, generic)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, gout):
        x, mask, *params = ctx.saved_tensors
        num_heads, window_size, shift, generic = ctx.config
        dx, grads = swin_block_backward(x, params, mask, gout.contiguous(), num_heads=num_heads,
                                        window_size=window_size, shift=shift, _generic=generic)
        return (dx, None, None, None, None, None, *grads)


def swin_block(x: torch.Tensor, params, mask: "torch.Tensor | None" = None, *,
               num_heads: int, window_size: int = WINDOW, shift: int = 0,
               _generic: bool = False) -> torch.Tensor:
    """One whole Swin block on x (B, H, W, C) fp32 or bf16 -> (B, H, W, C),
    differentiable in x and the parameters.

    CPU tensors go through the plain versions; CUDA tensors through the
    hand-written kernels of the shape's variant (:func:`variant`: the tuned
    ones at 8x8 windows, C in 24, 48, 96, head dims 4-32 and an MLP of 1-4
    times C; the generic ones at every other shape with windows up to 12x12,
    C = heads x hd up to 384 with hd <= 64 and an MLP of 1..4 C; the private
    ``_generic`` forces the generic one at a tuned shape).  ``launches``
    counts each forward call, ``swin_block_backward.launches`` each backward
    one, and each has the same counts by shape in ``launches_by_shape`` and
    by variant in ``launches_by_variant``.
    """
    return SwinBlockFunction.apply(x, mask, num_heads, window_size, shift, _generic, *params)


swin_block.launches = 0
swin_block.launches_by_shape = collections.Counter()
swin_block.launches_by_variant = collections.Counter()
