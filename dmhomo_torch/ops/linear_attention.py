"""Linear attention of the DGM UNet: two CUDA kernels for Hopper and their
plain PyTorch version.

The kernels (``dmhomo_torch/csrc/linear_attention.cu``) replace the Pallas
TPU kernels ``dmhomo_tpu/ops/linear_attention.py::_pass1_kernel`` (the k
side: exp-sums and the ek^T v cross blocks) and ``::_pass2_kernel`` (the q
side: per-head softmax over d against the context).  Both compute what the
JAX production function ``blockdiag_linear_attention`` computes, max-free,
in this order, with round() the rounding to the I/O dtype dt:

1. ``qkv = round(x . round(W))``, or with a folded pre-LayerNorm of gain g,
   ``round((x . round(diag(g) W) - mean * (g W)) * rstd)`` (fp32 accumulation);
2. ``ek = round(exp(clip(k, +-60)))``, ``s = sum_n ek``, ``E = ek^T v`` (fp32),
   ``context = round(E * blockdiag * dim_head**-0.5 / (s * N))``;
3. ``eq = round(exp(clip(q, +-60)))``,
   ``out = round(round(eq . context) / round(per-head sum eq))``.

Only the four 32x32 diagonal blocks of E exist in the kernels.  Pass 1 adds
each block's share of (E, s) into a zeroed fp32 buffer with atomics, so its
sum order changes between runs.  :func:`linear_attention` runs
:func:`linear_attention_reference` for CPU tensors only; for a CUDA tensor
it launches both kernels or raises.  The kernels are forward-only.

bf16 runs on tensor cores; :func:`launch_plan` picks, from the shapes and
strides, the loader (16-byte asynchronous copies where x has token stride
1 and 16-byte aligned rows, else element loads), the heads per block, the
channels per ring slot and the number of slots.  fp32 runs the CUDA-core
kernels.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from dmhomo_torch.ops.build import CSRC, build_library

CLIP = 60.0
HEADS = 4
DIM_HEAD = 32
HIDDEN = HEADS * DIM_HEAD
SUMS = HEADS * DIM_HEAD * DIM_HEAD + HIDDEN  # per batch: the E blocks, then s
LN_EPS = 1e-5

_SOURCE = CSRC / "linear_attention.cu"


def layer_norm_stats(x: torch.Tensor):
    """fp32 (mean, rstd) of each token of x (..., C) over its channels, as
    ``ChannelLayerNorm(return_stats=True)``: biased variance, eps 1e-5."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return mean, torch.rsqrt(var + LN_EPS)


def _split_prenorm(x, prenorm):
    """(mean (B, N, 1), rstd (B, N, 1), g (C,)) from ``(g,)`` or
    ``(mean, rstd, g)``."""
    if len(prenorm) == 1:
        return (*layer_norm_stats(x), prenorm[0])
    mean, rstd, g = prenorm
    B, N, _ = x.shape
    return mean.reshape(B, N, 1), rstd.reshape(B, N, 1), g


def _projection(x, w, prenorm, dt):
    """x . W for a column slice W of w_qkv, with the pre-LayerNorm folded in:
    round(x . round(W)), or round((x . round(diag(g) W) - mean * (g W)) * rstd)."""
    if prenorm is None:
        return torch.matmul(x.float(), w.to(dt).float()).to(dt)
    mean, rstd, g = _split_prenorm(x, prenorm)
    a = torch.matmul(x.float(), (w * g[:, None]).to(dt).float())
    return ((a - mean * (g @ w)) * rstd).to(dt)


def linear_attention_pass1_reference(x: torch.Tensor, w_qkv: torch.Tensor, heads: int = HEADS,
                                     dim_head: int = DIM_HEAD, prenorm=None) -> torch.Tensor:
    """Plain version of pass 1: (B, heads*dim_head^2 + heads*dim_head) fp32,
    the diagonal blocks of E = ek^T v (head-major, row d, column e), then
    s = sum_n ek, with ek = round(exp(clip(k, +-60)))."""
    B, N, C = x.shape
    hd = heads * dim_head
    with torch.autocast(x.device.type, enabled=False):
        k, v = _projection(x, w_qkv[:, hd:], prenorm, x.dtype).split(hd, dim=-1)
        ek = torch.exp(k.float().clamp(-CLIP, CLIP)).to(x.dtype).float()
        ek = ek.reshape(B, N, heads, dim_head).transpose(1, 2)  # (B, h, N, d)
        vh = v.float().reshape(B, N, heads, dim_head).transpose(1, 2)
        E = torch.matmul(ek.transpose(-1, -2), vh)  # (B, h, d, e)
        return torch.cat([E.reshape(B, -1), ek.sum(dim=2).reshape(B, hd)], dim=1)


def linear_attention_pass2_reference(x: torch.Tensor, w_qkv: torch.Tensor, sums: torch.Tensor,
                                     heads: int = HEADS, dim_head: int = DIM_HEAD,
                                     prenorm=None) -> torch.Tensor:
    """Plain version of pass 2: context_h = round(E_h * dim_head**-0.5 /
    (s_h * N)) from pass 1's ``sums``, eq = round(exp(clip(q, +-60))), out =
    round(round(eq_h . context_h) / round(sum_d eq_h)): (B, N, heads*dim_head)."""
    B, N, C = x.shape
    hd, dt = heads * dim_head, x.dtype
    with torch.autocast(x.device.type, enabled=False):
        E = sums[:, :heads * dim_head * dim_head].reshape(B, heads, dim_head, dim_head)
        s = sums[:, heads * dim_head * dim_head:].reshape(B, heads, dim_head, 1)
        context = (E * (dim_head**-0.5) / (s * N)).to(dt).float()
        q = _projection(x, w_qkv[:, :hd], prenorm, dt)
        eq = torch.exp(q.float().clamp(-CLIP, CLIP)).to(dt).float()
        eq = eq.reshape(B, N, heads, dim_head).transpose(1, 2)  # (B, h, N, d)
        num = torch.matmul(eq, context).to(dt).float()
        den = eq.sum(dim=-1, keepdim=True).to(dt).float()
        return (num / den).to(dt).transpose(1, 2).reshape(B, N, hd)


def linear_attention_reference(x: torch.Tensor, w_qkv: torch.Tensor, heads: int = HEADS,
                               dim_head: int = DIM_HEAD, prenorm=None) -> torch.Tensor:
    """Plain PyTorch version, step by step as ``blockdiag_linear_attention``
    (whose context is zero off the diagonal blocks): x (B, N, C), w_qkv
    (C, 3*heads*dim_head) fp32 -> (B, N, heads*dim_head) in x.dtype.
    ``prenorm`` is ``(g,)`` or ``(mean, rstd, g)``.  Runs with autocast off."""
    sums = linear_attention_pass1_reference(x, w_qkv, heads, dim_head, prenorm)
    return linear_attention_pass2_reference(x, w_qkv, sums, heads, dim_head, prenorm)


def build() -> Path:
    """Compile the kernel library for sm_90a (once per source content) and
    return its path."""
    return build_library(_SOURCE, "dmh_linear_attention")


def build_log() -> str:
    """nvcc's ptxas report (registers, shared memory, spills) of the build."""
    return build().with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.dmh_linear_attention_pass1
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i32, ptr, i32, i32, i32, ptr]
    fn.restype = i32
    fn = lib.dmh_linear_attention_pass2
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                   i32, i32, i32, ptr]
    fn.restype = i32
    fn = lib.dmh_linear_attention_pass1_bf16
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i32, ptr,
                   i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    fn = lib.dmh_linear_attention_pass2_bf16
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                   i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    lib.dmh_linear_attention_smem_bytes.argtypes = [i32]
    lib.dmh_linear_attention_smem_bytes.restype = i32
    for name in ("dmh_linear_attention_bf16_smem_bytes", "dmh_linear_attention_bf16_blocks_per_sm"):
        getattr(lib, name).argtypes = [i32] * 6
        getattr(lib, name).restype = i32
    return lib


def _plan_args(plan: dict):
    return (plan["padded_channels"], plan["heads_per_block"], plan["chunk"], plan["stages"],
            int(plan["weights"] == "streamed"))


def shared_memory_bytes(pass_: int, plan: dict | None = None) -> int:
    """Dynamic shared memory one block of pass 1 or pass 2 asks for: the
    fp32 kernels', or with a bf16 ``plan`` (:func:`launch_plan`) the
    tensor-core kernels' as the library computes it."""
    if plan is None:
        return _library().dmh_linear_attention_smem_bytes(pass_)
    return _library().dmh_linear_attention_bf16_smem_bytes(pass_, *_plan_args(plan))


def blocks_per_sm(pass_: int, plan: dict) -> int:
    """Blocks of the UNet's bf16 variant of ``pass_`` (prenorm, aligned
    loader) that one SM holds under ``plan``, as the card reports it."""
    return _library().dmh_linear_attention_bf16_blocks_per_sm(pass_, *_plan_args(plan))


# the bf16 kernels' tile and shared-memory layout (csrc/linear_attention.cu, namespace tc)
TILE = 64
_ROW_BYTES = (TILE + 8) * 2  # a staged channel row of 64 tokens, padded
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
SM_SMEM = 233472  # bytes of shared memory of an SM, 1 KB of it reserved per block


def _plan_smem(pass_: int, padded: int, heads: int, chunk: int, stages: int,
               streamed: bool = False) -> int:
    slot = chunk * _ROW_BYTES + 2 * TILE * 4  # x rows, then mean and rstd
    row = ((chunk if streamed else padded) + 8) * 2  # a weight row, bf16
    if pass_ == 1:
        return 64 * heads * row + stages * slot + 64 * heads * 4 + 4 * TILE * 4
    context = HEADS * DIM_HEAD * (DIM_HEAD + 8) * 2
    return HIDDEN * row + stages * slot + HIDDEN * _ROW_BYTES + context + HIDDEN * 4


def _aligned_rows(t: torch.Tensor, n_tokens: int) -> bool:
    """16-byte copies reach every 8-token group of t (B, N, C'): token stride
    1, the other strides and N multiples of 8 bf16, a 16-byte aligned base."""
    sb, sn, sc = t.stride()
    return (sn == 1 and sc % 8 == 0 and sb % 8 == 0 and n_tokens % 8 == 0
            and t.data_ptr() % 16 == 0)


def launch_plan(x: torch.Tensor, pass_: int, stats=(), out: torch.Tensor | None = None) -> dict:
    """How the bf16 kernel of ``pass_`` runs on x (B, N, C): ``loader``
    'aligned' (16-byte cp.async copies) or 'elementwise' (element loads
    through any strides), ``store`` likewise for pass 2's ``out``, the
    channels padded to a multiple of 16, ``heads_per_block`` (pass 1: 4, or
    2 where four heads' weights do not fit; 4 takes one chunk), ``chunk``
    channels per ring slot, ``stages`` slots, ``weights`` 'resident' (made
    once per block) or 'streamed' (made again for each chunk of each tile,
    where the resident ones do not fit: C above about 800) and the block's
    ``smem`` bytes.  Among the resident plans of the most heads, one that
    lets two blocks share an SM (at most two chunks) comes first.
    ``stats``: the (B, N) fp32 mean and rstd the kernel reads, if any."""
    B, N, C = x.shape
    padded = -(-C // 16) * 16
    aligned = _aligned_rows(x, N) and all(t.data_ptr() % 16 == 0 for t in stats)
    plan = {"loader": "aligned" if aligned else "elementwise", "padded_channels": padded}
    if out is not None:
        plan["store"] = "aligned" if _aligned_rows(out, N) else "elementwise"
    for heads in ((4, 2) if pass_ == 1 else (4,)):
        fits = []
        for n_chunks in ((1,) if pass_ == 1 and heads == 4 else (1, 2, 4, 8)):
            chunk = -(-padded // (16 * n_chunks)) * 16
            for stages in (3, 2):
                smem = _plan_smem(pass_, padded, heads, chunk, stages)
                if smem <= SMEM_LIMIT:
                    fits.append({**plan, "heads_per_block": heads, "chunk": chunk,
                                 "chunks": -(-padded // chunk), "stages": stages,
                                 "weights": "resident", "smem": smem})
        shared = [p for p in fits if 2 * (p["smem"] + 1024) <= SM_SMEM and p["chunks"] <= 2]
        if fits:
            return (shared or fits)[0]
    heads, chunk = (2 if pass_ == 1 else 4), 64
    return {**plan, "heads_per_block": heads, "chunk": chunk, "chunks": -(-padded // chunk),
            "stages": 3, "weights": "streamed",
            "smem": _plan_smem(pass_, padded, heads, chunk, 3, streamed=True)}


def _check_fp32(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be float32 {shape} on {device}; "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda_args(x, w_qkv, heads, dim_head, g=None, stats=()):
    if (heads, dim_head) != (HEADS, DIM_HEAD):
        raise ValueError(f"the kernels take heads={HEADS}, dim_head={DIM_HEAD}; "
                         f"got {heads}, {dim_head}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    B, N, C = x.shape
    if min(x.stride()) < 0 or B * N * C == 0:
        raise ValueError("x must be non-empty with non-negative strides")
    _check_fp32("w_qkv", w_qkv, (C, 3 * HIDDEN), x.device)
    if g is not None:
        _check_fp32("g", g, (C,), x.device)
    for name, t in stats:
        _check_fp32(name, t, (B, N), x.device)
    if torch.is_grad_enabled() and (x.requires_grad or w_qkv.requires_grad
                                    or (g is not None and g.requires_grad)):
        raise NotImplementedError("the linear-attention kernels are forward-only")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def linear_attention_pass1(x, w_qkv, g, mean, rstd, compute_stats: bool,
                           sums: torch.Tensor) -> None:
    """Kernel A: adds (E blocks, s) of x into ``sums`` (B, 4224) fp32, which
    the caller zeroes.  With ``g``, mean and rstd (B, N) fp32 are computed
    and written (``compute_stats``) or read.  ``launches`` counts each launch."""
    B, N, C = x.shape
    stats = () if g is None else (mean, rstd)
    args = (x.data_ptr(), *x.stride(), w_qkv.data_ptr(), None if g is None else g.data_ptr(),
            *(tuple(t.data_ptr() for t in stats) or (None, None)),
            int(compute_stats), sums.data_ptr(), B, N, C)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            plan = launch_plan(x, 1, () if compute_stats else stats)
            err = _library().dmh_linear_attention_pass1_bf16(
                *args, *_plan_args(plan), int(plan["loader"] == "aligned"), _stream(x))
            linear_attention_pass1.elementwise += plan["loader"] == "elementwise"
        else:
            err = _library().dmh_linear_attention_pass1(*args, _stream(x))
    if err != 0:
        raise RuntimeError(f"linear attention pass 1 launch failed: cudaError {err}")
    linear_attention_pass1.launches += 1


linear_attention_pass1.launches = 0
linear_attention_pass1.elementwise = 0  # bf16 launches that took the element-wise loader


def linear_attention_pass2(x, w_qkv, g, mean, rstd, sums: torch.Tensor,
                           out: torch.Tensor) -> None:
    """Kernel B: out (B, N, 128) in x.dtype, written through its strides,
    from x and pass 1's ``sums`` (and mean, rstd with ``g``).  ``launches``
    counts each launch."""
    B, N, C = x.shape
    stats = () if g is None else (mean, rstd)
    args = (x.data_ptr(), *x.stride(), w_qkv.data_ptr(), None if g is None else g.data_ptr(),
            *(tuple(t.data_ptr() for t in stats) or (None, None)), sums.data_ptr(),
            out.data_ptr(), *out.stride(), B, N, C)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            plan = launch_plan(x, 2, stats, out)
            padded, _, chunk, stages, streamed = _plan_args(plan)
            err = _library().dmh_linear_attention_pass2_bf16(
                *args, padded, chunk, stages, streamed, int(plan["loader"] == "aligned"),
                int(plan["store"] == "aligned"), _stream(x))
            linear_attention_pass2.elementwise += plan["loader"] == "elementwise"
        else:
            err = _library().dmh_linear_attention_pass2(*args, _stream(x))
    if err != 0:
        raise RuntimeError(f"linear attention pass 2 launch failed: cudaError {err}")
    linear_attention_pass2.launches += 1


linear_attention_pass2.launches = 0
linear_attention_pass2.elementwise = 0  # bf16 launches that took the element-wise loader


def linear_attention(x: torch.Tensor, w_qkv: torch.Tensor, heads: int = HEADS,
                     dim_head: int = DIM_HEAD, prenorm=None) -> torch.Tensor:
    """x (B, N, C) fp32 or bf16, any strides; w_qkv (C, 3*heads*dim_head)
    fp32; ``prenorm`` ``(g,)`` or ``(mean, rstd, g)`` -> (B, N,
    heads*dim_head) in x.dtype.

    CPU tensors go through :func:`linear_attention_reference`; CUDA tensors
    through the two kernels.  The output has x's layout: channel-major
    (a transposed (B, 128, N) tensor) when x's token stride is the smaller,
    as for the UNet's NCHW activations.
    """
    if x.device.type == "cpu":
        return linear_attention_reference(x, w_qkv, heads, dim_head, prenorm)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    B, N, C = x.shape
    g = mean = rstd = None
    compute_stats = False
    if prenorm is not None:
        g = prenorm[-1]
        if len(prenorm) == 1:
            compute_stats = True
            mean = torch.empty((B, N), dtype=torch.float32, device=x.device)
            rstd = torch.empty_like(mean)
        else:
            mean, rstd = (t.reshape(B, N) for t in prenorm[:2])
    _check_cuda_args(x, w_qkv, heads, dim_head, g,
                     () if g is None else (("mean", mean), ("rstd", rstd)))
    sums = torch.zeros((B, SUMS), dtype=torch.float32, device=x.device)
    linear_attention_pass1(x, w_qkv, g, mean, rstd, compute_stats, sums)
    if x.stride(1) < x.stride(2):
        out = torch.empty((B, HIDDEN, N), dtype=x.dtype, device=x.device).transpose(1, 2)
    else:
        out = torch.empty((B, N, HIDDEN), dtype=x.dtype, device=x.device)
    linear_attention_pass2(x, w_qkv, g, mean, rstd, sums, out)
    return out
