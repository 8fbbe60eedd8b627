"""The whole Swin block in one CUDA kernel for Hopper (forward only), and its
plain PyTorch version.

The kernel (``dmhomo_torch/csrc/swin_block.cu``) replaces the Pallas TPU
kernel ``dmhomo_tpu/ops/swin_block.py::_fwd_kernel``.  On (B, H, W, C)
tokens, with round() the rounding to the I/O dtype and 8x8 windows:

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

A shifted block (SW-MSA) is the same function of ``roll(x, -shift)``, rolled
back by ``+shift``.  The plain version rolls with ``torch.roll``; the kernel
instead reads and writes each window's tokens at their coordinates shifted
mod (H, W), which is the same function without the two copies.  The mask
row of a window is its index within its image.

Parameters come in the port's layout: LayerNorm gains and biases (C,), the
``nn.Linear`` weights (out, in) and biases, all fp32, and the (heads, 64,
64) fp32 relative-position bias.  The CUDA library is built with ``nvcc``
at first use into ``build/kernels/`` of the checkout and called through a
plain C interface with ``ctypes``.  :func:`swin_block` runs the plain
version for CPU tensors only; for a CUDA tensor it launches the kernel or
raises.  The kernel has no backward: on the card an input that requires
grad raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from dmhomo_torch.ops.build import CSRC, build_library
from dmhomo_torch.ops.window_attention import (
    HEAD_DIMS,
    WINDOW_TOKENS,
    _scale_io,
    window_attention_reference,
)

WINDOW = 8
CHANNELS = (24, 48, 96)  # the widths of the shipped estimator's Swin levels
MAX_MLP_RATIO = 4  # hidden = mlp_ratio * C with mlp_ratio in 1..4
LN_EPS = 1e-5
PARAM_NAMES = ("g1", "b1", "wq", "bq", "bias", "wp", "bp", "g2", "b2", "w1", "c1", "w2", "c2")

_SOURCE = CSRC / "swin_block.cu"


def _layer_norm(xf: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm over the last axis: two-pass statistics, eps 1e-5."""
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + LN_EPS)
    return xc * rstd * g.float() + b.float()


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
        wins = qkv.reshape(B, H // ws, ws, W // ws, ws, 3 * C).permute(0, 1, 3, 2, 4, 5)
        att = window_attention_reference(wins.reshape(-1, ws * ws, 3 * C), bias, mask,
                                         num_heads=num_heads)
        att = att.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        p = _linear(att.reshape(B, H, W, C), wp, bp, dt).to(dt)
        h = (x.float() + p.float()).to(dt)
        n2 = _layer_norm(h.float(), g2, b2).to(dt)
        gm = F.gelu(_linear(n2, w1, c1, dt)).to(dt)
        m2 = _linear(gm, w2, c2, dt).to(dt)
        y = (h.float() + m2.float()).to(dt)
        if shift:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    return y


def build() -> Path:
    """Compile the kernel library for sm_90a (once per source content) and
    return its path."""
    return build_library(_SOURCE, "dmh_swin_block")


def build_log() -> str:
    """nvcc's ptxas report (registers, shared memory, spills) of the build."""
    return build().with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.dmh_swin_block_fwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dmh_swin_block_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dmh_swin_block_smem_bytes.restype = ctypes.c_int
    return lib


def shared_memory_bytes(C: int, hidden: int) -> int:
    """Dynamic shared memory one block of the kernel asks for."""
    return _library().dmh_swin_block_smem_bytes(C, hidden)


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
    if torch.is_grad_enabled() and any(t.requires_grad for _, t, _ in named):
        raise NotImplementedError(
            "the whole-block Swin kernel is forward-only: the backward of "
            "dmhomo_tpu/ops/swin_block.py::_bwd_kernel has no kernel in the port yet; "
            "run under torch.no_grad() or torch.inference_mode()")


def swin_block(x: torch.Tensor, params, mask: "torch.Tensor | None" = None, *,
               num_heads: int, window_size: int = WINDOW, shift: int = 0) -> torch.Tensor:
    """One whole Swin block on x (B, H, W, C) fp32 or bf16 -> (B, H, W, C).

    CPU tensors go through :func:`swin_block_reference`; CUDA tensors through
    the hand-written kernel (``launches`` counts each launch), which takes
    8x8 windows, C in 24, 48, 96, head dims 4-32 and an MLP of 1-4 times C.
    """
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
    return y


swin_block.launches = 0
