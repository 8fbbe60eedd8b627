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

The backward recomputes that forward from x and follows ``_bwd_kernel`` step
by step (see :func:`swin_block_backward_reference`): dx in the I/O dtype and
the 13 parameter gradients in fp32, each summed over every window.

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

import ctypes
import functools
import math
from pathlib import Path

import torch
import torch.nn.functional as F

from dmhomo_torch.ops.build import CSRC, build_library
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
    fn = lib.dmh_swin_block_bwd
    fn.argtypes = [ctypes.c_void_p] * 30 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dmh_swin_block_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.dmh_swin_block_smem_bytes.restype = ctypes.c_int
    lib.dmh_swin_block_bwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.dmh_swin_block_bwd_smem_bytes.restype = ctypes.c_int
    return lib


def shared_memory_bytes(C: int, hidden: int, backward: bool = False) -> int:
    """Dynamic shared memory one block of the forward (or backward) kernel
    asks for."""
    if backward:
        return _library().dmh_swin_block_bwd_smem_bytes(C)
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
    return y


def swin_block_backward(x: torch.Tensor, params, mask: "torch.Tensor | None", dy: torch.Tensor,
                        *, num_heads: int, window_size: int = WINDOW, shift: int = 0):
    """Whole Swin block backward: ``(dx, grads)`` as
    :func:`swin_block_backward_reference` gives them.

    CUDA tensors go through the hand-written kernel (``launches`` counts
    each launch); CPU tensors through :func:`swin_block_backward_reference`.
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
    dx = torch.empty_like(x)
    grads = tuple(torch.zeros_like(p) for p in params)  # the kernel adds to them
    hd = C // num_heads
    with torch.cuda.device(x.device):
        err = _library().dmh_swin_block_bwd(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in params[:5]),
            mask.data_ptr() if mask is not None else None,
            *(t.data_ptr() for t in params[5:]), *(g.data_ptr() for g in grads),
            B, H, W, C, num_heads, hidden, shift, _scale_io(hd, x.dtype), hd**-0.5,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"swin block backward kernel launch failed: cudaError {err}")
    swin_block_backward.launches += 1
    return dx, grads


swin_block_backward.launches = 0


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
    ``swin_block_backward.launches`` each backward one), which take 8x8
    windows, C in 24, 48, 96, head dims 4-32 and an MLP of 1-4 times C.
    """
    return SwinBlockFunction.apply(x, mask, num_heads, window_size, shift, *params)


swin_block.launches = 0
