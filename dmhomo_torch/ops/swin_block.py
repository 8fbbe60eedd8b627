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

Parameters come in the port's layout: LayerNorm gains and biases (C,), the
``nn.Linear`` weights (out, in) and biases, all fp32, and the (heads, 64,
64) fp32 relative-position bias.  The CUDA library is built with ``nvcc``
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
from pathlib import Path

import torch
import torch.nn.functional as F

from dmhomo_torch.ops.build import (CSRC, atomic_instructions, build_library,
                                    tensor_core_instructions)
from dmhomo_torch.ops.window_attention import (
    HEAD_DIMS,
    WINDOW_TOKENS,
    _scale_io,
    window_attention_backward_reference,
    window_attention_reference,
)

WINDOW = 8
CHANNELS = (24, 48, 96)  # the widths of the shipped estimator's Swin levels
MAX_MLP_RATIO = 4  # hidden = mlp_ratio * C with mlp_ratio in 1..4
LN_EPS = 1e-5
PARAM_NAMES = ("g1", "b1", "wq", "bq", "bias", "wp", "bp", "g2", "b2", "w1", "c1", "w2", "c2")

_SOURCE = CSRC / "swin_block.cu"

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
    return _ln_stats(xf)[0] * g.float() + b.float()


def _ln_backward(dn: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor, g: torch.Tensor):
    """fp32 LayerNorm input gradient, and the gain and bias gradients summed
    over the tokens."""
    dxh = dn * g.float()
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
    return torch.matmul(a.float(), w.to(dt).float().t()) + bias.float()


def swin_block_reference(x: torch.Tensor, params, mask: "torch.Tensor | None" = None, *,
                         num_heads: int, window_size: int = WINDOW,
                         shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version: x (B, H, W, C) -> (B, H, W, C) in x.dtype, step
    by step as the Pallas ``_fwd_kernel``.  ``params`` is ``(g1, b1, wq, bq,
    bias, wp, bp, g2, b2, w1, c1, w2, c2)``; mask (nW, N, N) of 0 / -100 or
    None.  Runs with autocast off."""
    g1, b1, wq, bq, bias, wp, bp, g2, b2, w1, c1, w2, c2 = params
    dt = x.dtype
    B, H, W, C = x.shape
    ws = window_size
    with torch.autocast(x.device.type, enabled=False):
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        n1 = _layer_norm(x.float(), g1, b1).to(dt)
        qkv = _linear(n1, wq, bq, dt).to(dt)
        att = window_attention_reference(_windows(qkv, ws), bias, mask, num_heads=num_heads)
        att = _unwindows(att, B, H, W, ws)
        p = _linear(att, wp, bp, dt).to(dt)
        h = (x.float() + p.float()).to(dt)
        n2 = _layer_norm(h.float(), g2, b2).to(dt)
        gm = F.gelu(_linear(n2, w1, c1, dt)).to(dt)
        m2 = _linear(gm, w2, c2, dt).to(dt)
        y = (h.float() + m2.float()).to(dt)
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
    round(Wq)))``.  The mask gets no gradient.  Runs with autocast off."""
    g1, b1, wq, bq, bias, wp, bp, g2, b2, w1, c1, w2, c2 = params
    dt = x.dtype
    B, H, W, C = x.shape
    ws = window_size
    with torch.autocast(x.device.type, enabled=False):
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            dy = torch.roll(dy, shifts=(-shift, -shift), dims=(1, 2))
        # the forward, recomputed
        xhat1, rstd1 = _ln_stats(x.float())
        n1 = (xhat1 * g1.float() + b1.float()).to(dt)
        qkv3 = _windows(_linear(n1, wq, bq, dt).to(dt), ws)
        ao = _unwindows(window_attention_reference(qkv3, bias, mask, num_heads=num_heads),
                        B, H, W, ws)
        h = (x.float() + _linear(ao, wp, bp, dt).to(dt).float()).to(dt)
        xhat2, rstd2 = _ln_stats(h.float())
        n2 = (xhat2 * g2.float() + b2.float()).to(dt)
        m1 = _linear(n2, w1, c1, dt)
        cdf = 0.5 * (1.0 + torch.erf(m1 * 0.5**0.5))
        gm = (m1 * cdf).to(dt)
        dgelu = cdf + m1 * torch.exp(-0.5 * m1 * m1) / math.sqrt(2.0 * math.pi)
        # y = h + round(gm . W2^T + c2); dy is in the I/O dtype already
        dyf = dy.float()
        dw2 = _tokens(dyf).t() @ _tokens(gm.float())
        dc2 = _tokens(dyf).sum(0)
        dm1 = (dyf @ w2.to(dt).float()) * dgelu
        dw1 = _tokens(dm1).t() @ _tokens(n2.float())
        dc1 = _tokens(dm1).sum(0)
        dn2 = dm1.to(dt).float() @ w1.to(dt).float()
        dh_ln, dg2, db2 = _ln_backward(dn2, xhat2, rstd2, g2)
        dh = dyf + dh_ln
        # h = x + round(ao . Wp^T + bp)
        dwp = _tokens(dh).t() @ _tokens(ao.float())
        dbp = _tokens(dh).sum(0)
        dao = (dh.to(dt).float() @ wp.to(dt).float()).to(dt)
        dqkv3, dbias = window_attention_backward_reference(qkv3, bias, mask, _windows(dao, ws),
                                                           num_heads=num_heads)
        dqkv = _unwindows(dqkv3, B, H, W, ws).float()
        dwq = _tokens(dqkv).t() @ _tokens(n1.float())
        dbq = _tokens(dqkv).sum(0)
        dx_ln, dg1, db1 = _ln_backward(dqkv @ wq.to(dt).float(), xhat1, rstd1, g1)
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
    with torch.autocast(x.device.type, enabled=False):
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            dy = torch.roll(dy, shifts=(-shift, -shift), dims=(1, 2))
        xhat1, rstd1 = _ln_stats(x.float())
        n1 = (xhat1 * g1.float() + b1.float()).to(dt)
        qkv3 = _windows(_linear(n1, wq, bq, dt).to(dt), ws)
        ao = _unwindows(window_attention_reference(qkv3, bias, mask, num_heads=num_heads),
                        B, H, W, ws)
        h = (x.float() + _linear(ao, wp, bp, dt).to(dt).float()).to(dt)
        xhat2, rstd2 = _ln_stats(h.float())
        n2 = (xhat2 * g2.float() + b2.float()).to(dt)
        m1 = _linear(n2, w1, c1, dt)
        cdf = 0.5 * (1.0 + torch.erf(m1 * 0.5**0.5))
        gm = (m1 * cdf).to(dt)
        dgelu = cdf + m1 * torch.exp(-0.5 * m1 * m1) / math.sqrt(2.0 * math.pi)
        dyf = dy.float()
        dm1 = (dyf @ w2.to(dt).float()) * dgelu
        dn2 = dm1.to(dt).float() @ w1.to(dt).float()
        dh_ln, dg2, db2 = _ln_backward(dn2, xhat2, rstd2, g2)
        dh = dyf + dh_ln
        dao = (dh.to(dt).float() @ wp.to(dt).float()).to(dt)
        dqkv3, dbias = window_attention_backward_reference(qkv3, bias, mask, _windows(dao, ws),
                                                           num_heads=num_heads)
        dqkv = _unwindows(dqkv3, B, H, W, ws)
        dx_ln, dg1, db1 = _ln_backward(dqkv.float() @ wq.to(dt).float(), xhat1, rstd1, g1)
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
        t = t.float()
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
                  mask: "torch.Tensor | None" = None) -> dict:
    """How :func:`swin_block_backward` launches its kernels on the card for x
    (B, H, W, C): per kernel (``BACKWARD_KERNELS``) the grid, threads,
    windows (or tokens) per block, dynamic shared memory and blocks per SM
    by shared memory and threads; the scratch (name -> (byte offset, bytes)
    in one buffer) and the partials' bytes; the global atomics per launch (0:
    the kernels hold no atomic instruction) and those of the per-window
    kernel this design replaced (``atomics_old``).  Computed from the shapes
    alone; the library carves the scratch itself
    (:func:`backward_scratch_layout`, which a ``gpu`` test holds this plan's
    ``scratch`` against)."""
    B, H, W, C = x.shape
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


def forward_plan(x: torch.Tensor, num_heads: int, hidden: int) -> dict:
    """How :func:`swin_block` launches its forward kernel on the card for x
    (B, H, W, C): one block of 256 threads per window (``grid``); its dynamic
    shared memory in bytes (two window buffers, rows ``row_stride`` elements
    apart, one for a head group's q | k | v, rows ``qkv_row_stride`` apart,
    and one C x C weight block, in the I/O dtype; bf16 adds the weight
    block's fp32 staging area); blocks per SM by shared memory and threads
    (the registers may allow fewer: :func:`forward_blocks_per_sm` asks the
    card); the head groups (three at C = 96, one below).  Computed from the
    shapes alone (the heads and the MLP width change none of it); a ``gpu``
    test holds ``smem`` to the library's."""
    B, H, W, C = x.shape
    return _forward_plan(B, H, W, C, x.element_size())


def build() -> Path:
    """Compile the kernel library for sm_90a (once per source content) and
    return its path."""
    return build_library(_SOURCE, "dmh_swin_block")


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
                            mask: "torch.Tensor | None" = None) -> dict:
    """The backward's scratch as the library carves it for x (B, H, W, C)
    under :func:`backward_plan`'s grids: name (``SCRATCH``) -> byte offset,
    and ``"bytes"``, the size :func:`swin_block_backward` allocates."""
    B, H, W, C = x.shape
    k = backward_plan(x, num_heads, hidden, mask)["kernels"]
    off = _scratch_layout(B, H, W, C, num_heads, hidden, k["attention"]["windows_per_block"],
                          k["weights"]["tokens_per_block"], x.dtype == torch.bfloat16)
    return dict(zip(SCRATCH + ("bytes",), off))


def _check_cuda_args(x, params, mask, num_heads, window_size, shift):
    if window_size * window_size != WINDOW_TOKENS:
        raise ValueError(f"the kernel takes {WINDOW}x{WINDOW} windows ({WINDOW_TOKENS} "
                         f"tokens); got window_size={window_size}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    B, H, W, C = x.shape
    if B == 0 or H % WINDOW or W % WINDOW:
        raise ValueError(f"H={H} and W={W} must be multiples of {WINDOW}, B={B} positive")
    if C not in CHANNELS:
        raise ValueError(f"the kernel takes C in {CHANNELS}; got {C}")
    if C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim C/num_heads = {C}/{num_heads} not in {HEAD_DIMS}")
    if not 0 <= shift < WINDOW:
        raise ValueError(f"shift must be in [0, {WINDOW}); got {shift}")
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f"params must be {PARAM_NAMES}")
    hidden = params[PARAM_NAMES.index("c1")].shape[0]
    if hidden % C or not 1 <= hidden // C <= MAX_MLP_RATIO:
        raise ValueError(f"the MLP width {hidden} must be C={C} times 1..{MAX_MLP_RATIO}")
    N = WINDOW_TOKENS
    shapes = {"g1": (C,), "b1": (C,), "wq": (3 * C, C), "bq": (3 * C,),
              "bias": (num_heads, N, N), "wp": (C, C), "bp": (C,), "g2": (C,), "b2": (C,),
              "w1": (hidden, C), "c1": (hidden,), "w2": (C, hidden), "c2": (C,)}
    named = [("x", x, None)] + [(n, t, shapes[n]) for n, t in zip(PARAM_NAMES, params)]
    if mask is not None:
        named.append(("mask", mask, ((H // WINDOW) * (W // WINDOW), N, N)))
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


def _forward(x, params, mask, num_heads, window_size, shift):
    if x.device.type == "cpu":
        return swin_block_reference(x, params, mask, num_heads=num_heads,
                                    window_size=window_size, shift=shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args(x, params, mask, num_heads, window_size, shift)
    B, H, W, C = x.shape
    hidden = params[PARAM_NAMES.index("c1")].shape[0]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().dmh_swin_block_fwd(
            x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in params[:5]),
            mask.data_ptr() if mask is not None else None,
            *(t.data_ptr() for t in params[5:]), B, H, W, C, num_heads, hidden, shift,
            _scale_io(C // num_heads, x.dtype), int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swin block kernel launch failed: cudaError {err}")
    swin_block.launches += 1
    swin_block.launches_by_shape[_shape_key(x, num_heads, mask)] += 1
    return y


def swin_block_backward(x: torch.Tensor, params, mask: "torch.Tensor | None", dy: torch.Tensor,
                        *, num_heads: int, window_size: int = WINDOW, shift: int = 0):
    """Whole Swin block backward: ``(dx, grads)`` as
    :func:`swin_block_backward_reference` gives them.

    CUDA tensors go through the hand-written kernels, five launches planned
    by :func:`backward_plan` (``launches`` counts each backward); CPU tensors
    through :func:`swin_block_backward_reference`.
    """
    if x.device.type == "cpu":
        return swin_block_backward_reference(x, params, mask, dy, num_heads=num_heads,
                                             window_size=window_size, shift=shift)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_cuda_args(x, params, mask, num_heads, window_size, shift)
    _check_dy(x, dy)
    B, H, W, C = x.shape
    hidden = params[PARAM_NAMES.index("c1")].shape[0]
    kernels = backward_plan(x, num_heads, hidden, mask)["kernels"]
    nbytes = backward_scratch_layout(x, num_heads, hidden, mask)["bytes"]
    dx = torch.empty_like(x)
    grads = tuple(torch.empty_like(p) for p in params)  # the kernels write every element
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    hd = C // num_heads
    with torch.cuda.device(x.device):
        err = _library().dmh_swin_block_bwd(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in params[:5]),
            mask.data_ptr() if mask is not None else None,
            *(t.data_ptr() for t in params[5:]), *(g.data_ptr() for g in grads),
            scratch.data_ptr(), nbytes, B, H, W, C, num_heads, hidden, shift,
            _scale_io(hd, x.dtype), hd**-0.5, kernels["attention"]["windows_per_block"],
            kernels["weights"]["tokens_per_block"], int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swin block backward kernel launch failed: cudaError {err}")
    swin_block_backward.launches += 1
    swin_block_backward.launches_by_shape[_shape_key(x, num_heads, mask)] += 1
    return dx, grads


def _shape_key(x, num_heads, mask) -> tuple:
    """(B, H, W, C, heads, dtype name, masked): the key of ``launches_by_shape``."""
    return (*x.shape, num_heads, str(x.dtype).split(".")[-1], mask is not None)


swin_block_backward.launches = 0
swin_block_backward.launches_by_shape = collections.Counter()


class SwinBlockFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    ``custom_vjp`` of ``fused_swin_block``).  Under autocast the inputs keep
    their dtypes: x stays as it comes, the parameters fp32."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, mask, num_heads, window_size, shift, *params):
        ctx.save_for_backward(x, mask, *params)
        ctx.config = (num_heads, window_size, shift)
        return _forward(x, params, mask, num_heads, window_size, shift)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, gout):
        x, mask, *params = ctx.saved_tensors
        num_heads, window_size, shift = ctx.config
        dx, grads = swin_block_backward(x, params, mask, gout.contiguous(), num_heads=num_heads,
                                        window_size=window_size, shift=shift)
        return (dx, None, None, None, None, *grads)


def swin_block(x: torch.Tensor, params, mask: "torch.Tensor | None" = None, *,
               num_heads: int, window_size: int = WINDOW, shift: int = 0) -> torch.Tensor:
    """One whole Swin block on x (B, H, W, C) fp32 or bf16 -> (B, H, W, C),
    differentiable in x and the parameters.

    CPU tensors go through the plain versions; CUDA tensors through the
    hand-written kernels (``launches`` counts each forward launch,
    ``swin_block_backward.launches`` each backward one, and each has the
    same counts by shape in ``launches_by_shape``), which take 8x8
    windows, C in 24, 48, 96, head dims 4-32 and an MLP of 1-4 times C.
    """
    return SwinBlockFunction.apply(x, mask, num_heads, window_size, shift, *params)


swin_block.launches = 0
swin_block.launches_by_shape = collections.Counter()
