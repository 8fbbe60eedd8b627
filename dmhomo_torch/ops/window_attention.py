"""Window attention (W-MSA / SW-MSA): CUDA kernels for Hopper, forward and
backward, their plain PyTorch versions, and the autograd Function joining them.

The kernels (``dmhomo_torch/csrc/window_attention.cu``) replace the Pallas
TPU kernels ``dmhomo_tpu/ops/window_attention.py::_fwd_kernel`` and
``::_bwd_kernel``.  Forward semantics, per window and head
(``scale = hd**-0.5``, clip 60):

* ``q`` is multiplied by ``scale`` in the input dtype;
* ``sim = q k^T`` (fp32 accumulation) ``+ bias[g]`` ``+ mask[b % nW]``;
* ``e = exp(clip(sim, +-60))`` rounded to the I/O dtype;
* ``out = (e v) / sum(e)`` with fp32 sums, in the I/O dtype.

The backward recomputes ``e`` and follows ``_bwd_kernel`` step by step (see
:func:`window_attention_backward_reference`); ``dbias`` is fp32, summed
over every window.

The CUDA library is built from the sources in ``dmhomo_torch/csrc/`` with
``nvcc`` at first use into ``build/kernels/`` of the checkout, and called
through a plain C interface with ``ctypes``.  :func:`window_attention` runs
the plain versions for CPU tensors only (both directions: the explicit
backward, not autograd of the plain forward); for a CUDA tensor it launches
the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from dmhomo_torch.ops.build import CSRC, build_library

CLIP = 60.0
WINDOW_TOKENS = 64  # 8x8 windows
HEAD_DIMS = (4, 8, 16, 32)

_SOURCE = CSRC / "window_attention.cu"


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(Bn, N, h*hd) -> (Bn, h, N, hd)."""
    Bn, N, C = t.shape
    return t.reshape(Bn, N, h, C // h).transpose(1, 2)


def _tokens(t: torch.Tensor) -> torch.Tensor:
    """(Bn, h, N, hd) -> (Bn, N, h*hd)."""
    Bn, h, N, hd = t.shape
    return t.transpose(1, 2).reshape(Bn, N, h * hd)


def _logits(q, k, bias, mask):
    """fp32 sim = q k^T + bias (+ mask[b % nW]) of (Bn, h, N, hd) q and k."""
    Bn, h, N, _ = q.shape
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        sim = (sim.reshape(Bn // nW, nW, h, N, N)
               + mask.float()[None, :, None]).reshape(Bn, h, N, N)
    return sim


def _split_scaled(qkv, num_heads):
    """q scaled by hd**-0.5 in the I/O dtype, k, v: each (Bn, h, N, hd)."""
    C = qkv.shape[-1] // 3
    q, k, v = qkv.split(C, dim=-1)
    q = q * torch.tensor((C // num_heads)**-0.5, dtype=qkv.dtype)
    return _heads(q, num_heads), _heads(k, num_heads), _heads(v, num_heads)


def window_attention_reference(qkv: torch.Tensor, bias: torch.Tensor,
                               mask: "torch.Tensor | None" = None, *,
                               num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: qkv (Bn, N, 3C) -> (Bn, N, C) in qkv.dtype.

    bias (h, N, N); mask (nW, N, N) of 0 / -100, window b takes row b % nW.
    Runs with autocast off, so the caller's autocast does not change it.
    """
    dt = qkv.dtype
    with torch.autocast(qkv.device.type, enabled=False):
        q, k, v = _split_scaled(qkv, num_heads)
        e = torch.exp(_logits(q, k, bias, mask).clamp(-CLIP, CLIP)).to(dt).float()
        out = torch.matmul(e, v.float()) / e.sum(dim=-1, keepdim=True)
    return _tokens(out.to(dt))


def window_attention_backward_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                        mask: "torch.Tensor | None", gout: torch.Tensor, *,
                                        num_heads: int):
    """Plain PyTorch version of the backward: (dqkv (Bn, N, 3C) in qkv.dtype,
    dbias (h, N, N) fp32 summed over all windows), step by step as the
    Pallas ``_bwd_kernel``.  Runs with autocast off.
    """
    dt = qkv.dtype
    hd = qkv.shape[-1] // 3 // num_heads
    with torch.autocast(qkv.device.type, enabled=False):
        q, k, v = _split_scaled(qkv, num_heads)  # q scaled in the I/O dtype
        q32, k32, v32 = q.float(), k.float(), v.float()
        sim = _logits(q, k, bias, mask)
        inrange = (sim.abs() < CLIP).float()
        e32 = torch.exp(sim.clamp(-CLIP, CLIP))
        e = e32.to(dt).float()
        s = e.sum(dim=-1)  # (Bn, h, N) fp32
        ctx = torch.matmul(e, v32)  # un-normalized out
        gg = _heads(gout, num_heads).float() / s[..., None]
        ds = -(gg * ctx).sum(dim=-1) / s  # dL/ds = -(gg . ctx) / s
        gg_io = gg.to(dt).float()
        de = torch.matmul(gg_io, v32.transpose(-1, -2)) + ds[..., None]
        dsim = (e32 * de * inrange).to(dt).float()
        dq = torch.matmul(dsim, k32) * hd**-0.5  # chain rule through the q scaling
        dk = torch.matmul(dsim.transpose(-1, -2), q32)
        dv = torch.matmul(e.transpose(-1, -2), gg_io)
        dqkv = torch.cat([_tokens(t.to(dt)) for t in (dq, dk, dv)], dim=-1)
        return dqkv, dsim.sum(dim=0)


def build() -> Path:
    """Compile the kernel library for sm_90a (once per source content) and
    return its path."""
    return build_library(_SOURCE, "dmh_window_attention")


def build_log() -> str:
    """nvcc's ptxas report (registers, shared memory, spills) of the build."""
    return build().with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.dmh_window_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dmh_window_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for fn in (lib.dmh_window_attention_smem_bytes, lib.dmh_window_attention_bwd_smem_bytes):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def shared_memory_bytes(hd: int, masked: bool, backward: bool = False) -> int:
    """Dynamic shared memory one block of the forward (or backward) kernel asks for."""
    lib = _library()
    if backward:
        return lib.dmh_window_attention_bwd_smem_bytes(hd, int(masked))
    return lib.dmh_window_attention_smem_bytes(hd, int(masked))


def _check_cuda_args(qkv, bias, mask, num_heads):
    if qkv.dim() != 3 or qkv.shape[1] != WINDOW_TOKENS or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be (Bn, {WINDOW_TOKENS}, 3C); got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16; got {qkv.dtype}")
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads or C // num_heads not in HEAD_DIMS:
        raise ValueError(f"head dim C/num_heads = {C}/{num_heads} not in {HEAD_DIMS}")
    tensors = [("qkv", qkv), ("bias", bias)] + ([("mask", mask)] if mask is not None else [])
    for name, t in tensors:
        if t.device != qkv.device:
            raise ValueError(f"{name} is on {t.device}, qkv on {qkv.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (num_heads, N, N):
        raise ValueError(f"bias must be float32 ({num_heads}, {N}, {N}); "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    if mask is not None:
        if mask.dtype != torch.float32 or mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N):
            raise ValueError(f"mask must be float32 (nW, {N}, {N}); "
                             f"got {mask.dtype} {tuple(mask.shape)}")
        if Bn % mask.shape[0]:
            raise ValueError(f"Bn={Bn} not a multiple of nW={mask.shape[0]}")


def _check_gout(qkv, gout):
    Bn, N, C3 = qkv.shape
    want = (Bn, N, C3 // 3)
    if gout.device != qkv.device or gout.dtype != qkv.dtype or tuple(gout.shape) != want:
        raise ValueError(f"gout must be {qkv.dtype} {want} on {qkv.device}; "
                         f"got {gout.dtype} {tuple(gout.shape)} on {gout.device}")
    if not gout.is_contiguous() or gout.data_ptr() % 16:
        raise ValueError("gout must be contiguous and 16-byte aligned")


def _forward(qkv, bias, mask, num_heads):
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, num_heads=num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    _check_cuda_args(qkv, bias, mask, num_heads)
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    out = torch.empty((Bn, N, C), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _library().dmh_window_attention_fwd(
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
            out.data_ptr(), Bn, C, num_heads, mask.shape[0] if mask is not None else 0,
            _scale_io(C // num_heads, qkv.dtype), int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: cudaError {err}")
    window_attention.launches += 1
    return out


def _scale_io(hd: int, dtype: torch.dtype) -> float:
    """hd**-0.5 as the I/O dtype holds it: the kernels scale q in that dtype."""
    return float(torch.tensor(hd**-0.5, dtype=dtype))


def window_attention_backward(qkv: torch.Tensor, bias: torch.Tensor,
                              mask: "torch.Tensor | None", gout: torch.Tensor, *,
                              num_heads: int):
    """Window attention backward: (dqkv (Bn, 64, 3C), dbias (h, 64, 64) fp32).

    CUDA tensors go through the hand-written kernel (``launches`` counts
    each launch); CPU tensors through
    :func:`window_attention_backward_reference`.
    """
    if qkv.device.type == "cpu":
        return window_attention_backward_reference(qkv, bias, mask, gout, num_heads=num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    _check_cuda_args(qkv, bias, mask, num_heads)
    _check_gout(qkv, gout)
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    dqkv = torch.empty_like(qkv)
    dbias = torch.zeros((num_heads, N, N), dtype=torch.float32, device=qkv.device)
    hd = C // num_heads
    with torch.cuda.device(qkv.device):
        err = _library().dmh_window_attention_bwd(
            qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
            gout.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), Bn, C, num_heads,
            mask.shape[0] if mask is not None else 0, _scale_io(hd, qkv.dtype), hd**-0.5,
            int(qkv.dtype == torch.bfloat16), torch.cuda.current_stream(qkv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention backward kernel launch failed: cudaError {err}")
    window_attention_backward.launches += 1
    return dqkv, dbias


window_attention_backward.launches = 0


class WindowAttentionFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    ``custom_vjp`` of ``fused_window_attention``).  Under autocast the
    inputs keep their dtypes: bf16 qkv stays bf16, the fp32 bias fp32."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, bias, mask, num_heads):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.num_heads = num_heads
        return _forward(qkv, bias, mask, num_heads)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, gout):
        qkv, bias, mask = ctx.saved_tensors
        # the gradient out of the output projection may be a strided view
        dqkv, dbias = window_attention_backward(qkv, bias, mask, gout.contiguous(),
                                                num_heads=ctx.num_heads)
        return dqkv, dbias, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: "torch.Tensor | None" = None, *,
                     num_heads: int) -> torch.Tensor:
    """Window attention, (Bn, 64, 3C) -> (Bn, 64, C), differentiable in qkv
    and bias.

    CUDA tensors go through the hand-written kernels (``launches`` counts
    each forward launch, ``window_attention_backward.launches`` each
    backward one); CPU tensors through the plain versions.
    """
    return WindowAttentionFunction.apply(qkv, bias, mask, num_heads)


window_attention.launches = 0
