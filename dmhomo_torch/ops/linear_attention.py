"""Linear attention of the DGM UNet: CUDA kernels for Hopper and their plain
PyTorch version.

The kernels replace the Pallas TPU kernels
``dmhomo_tpu/ops/linear_attention.py::_pass1_kernel`` (the k side:
exp-sums and the ek^T v cross blocks) and ``::_pass2_kernel`` (the q side:
per-head softmax over d against the context).  Both compute what the JAX
production function ``blockdiag_linear_attention`` computes, max-free, in
this order, with round() the rounding to the I/O dtype dt:

1. ``qkv = round(x . round(W))``, or with a folded pre-LayerNorm of gain g,
   ``round((x . round(diag(g) W) - mean * (g W)) * rstd)`` (fp32 accumulation);
2. ``ek = round(exp(clip(k, +-60)))``, ``s = sum_n ek``, ``E = ek^T v`` (fp32),
   ``context = round(E * blockdiag * dim_head**-0.5 / (s * N))``;
3. ``eq = round(exp(clip(q, +-60)))``,
   ``out = round(round(eq . context) / round(per-head sum eq))``.

Two variants, picked by shape alone (:func:`variant`):

* **tuned** (``csrc/linear_attention.cu``) at heads = 4, dim_head = 32, the
  sizes compiled in.  Only the four 32x32 diagonal blocks of E exist.
  Pass 1 writes each block's share of (E, s) to a slot of its own (bf16:
  each warp's) and a second launch sums the slots in a fixed order (no
  atomics: reruns give the same bits).  bf16 runs on tensor
  cores; :func:`launch_plan` picks, from the shapes and strides, the loader
  (16-byte asynchronous copies where x has token stride 1 and 16-byte
  aligned rows, else element loads), the heads per block, the channels per
  ring slot and the number of slots.  fp32 runs the CUDA-core kernels.
* **generic** (``csrc/linear_attention_any.cu``) at every other shape of
  the envelope: 1 <= heads <= 16, 1 <= dim_head <= 128, heads * dim_head <=
  1024, C <= 1024, any N, B <= 65535.  A block holds a group of heads whose
  columns, dim_head padded to 16, 32, 64 or 128, make 128: an x tile staged
  once serves the group, E and s stay in registers across a chunk of tiles.
  Pass 1 (after small launches that prepare round(diag(g) W) and g . W in
  its scratch and, with a prenorm, the LayerNorm statistics, once per call)
  runs over (token chunk, head group, batch) and
  writes each chunk's (E_h, s_h) to a slot of the scratch; a second launch
  sums the chunks in a fixed order (no atomics: reruns give the same bits).
  Pass 2 runs persistent blocks per head group, each rebuilding its
  group's context once per batch row.  bf16 runs every product on tensor
  cores (``mma.sync`` fed by ``ldmatrix``), fp32 on CUDA cores.
  :func:`generic_launch_plan` gives grids, shared memory and the scratch's
  size; the private ``_generic=True`` forces it at (4, 32).

A shape outside the envelope raises ``ValueError`` before any launch.
:func:`linear_attention` runs :func:`linear_attention_reference` for CPU
tensors only; for a CUDA tensor it launches both kernels or raises.

A call that needs a gradient goes through :class:`LinearAttentionFunction`:
its forward is the two kernels (the plain version on the CPU), and it keeps
x, the weights and pass 1's fp32 LayerNorm statistics, nothing of size
(B, N, heads*dim_head) or more.  Its backward,
:func:`linear_attention_backward`, recomputes qkv by one projection and
everything after it, and applies the chain rule of steps 1-3 with plain
tensor ops, rounding each cotangent of a primal in dt to dt, as autodiff of
the JAX production function does (the JAX package has no backward kernel:
XLA differentiates ``blockdiag_linear_attention``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from dmhomo_torch.ops.build import CSRC, atomic_instructions, build_library
from dmhomo_torch.ops.plain import exact, wide

CLIP = 60.0
HEADS = 4  # the tuned kernels' heads and dim_head
DIM_HEAD = 32
HIDDEN = HEADS * DIM_HEAD
SUMS = HEADS * DIM_HEAD * DIM_HEAD + HIDDEN  # per batch: the E blocks, then s
LN_EPS = 1e-5
TOKEN_CHUNK = 1024  # tokens per partial of the plain version's E (_token_products)
# the generic kernels' envelope
MAX_HEADS = 16
MAX_DIM_HEAD = 128
MAX_HIDDEN = 1024  # heads * dim_head
MAX_CHANNELS = 1024
MAX_BATCH = 65535  # the grid's z

_SOURCE = CSRC / "linear_attention.cu"
_SOURCE_ANY = CSRC / "linear_attention_any.cu"


def sums_width(heads: int, dim_head: int) -> int:
    """Floats of pass 1's sums per batch: the heads' dim_head^2 E blocks, then s."""
    return heads * dim_head * (dim_head + 1)


def layer_norm_stats(x: torch.Tensor):
    """fp32 (mean, rstd) of each token of x (..., C) over its channels, as
    ``ChannelLayerNorm(return_stats=True)``: biased variance, eps 1e-5
    (float64 for a float64 x)."""
    xf = wide(x)
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
        return torch.matmul(wide(x), wide(w.to(dt))).to(dt)
    mean, rstd, g = _split_prenorm(x, prenorm)
    a = torch.matmul(wide(x), wide((w * g[:, None]).to(dt)))
    return ((a - mean * (g @ w)) * rstd).to(dt)


def linear_attention_pass1_reference(x: torch.Tensor, w_qkv: torch.Tensor, heads: int = HEADS,
                                     dim_head: int = DIM_HEAD, prenorm=None) -> torch.Tensor:
    """Plain version of pass 1: (B, heads*dim_head^2 + heads*dim_head) fp32,
    the diagonal blocks of E = ek^T v (head-major, row d, column e), then
    s = sum_n ek, with ek = round(exp(clip(k, +-60)))."""
    B, N, C = x.shape
    hd = heads * dim_head
    with exact(x.device.type):
        k, v = _projection(x, w_qkv[:, hd:], prenorm, x.dtype).split(hd, dim=-1)
        ek = wide(torch.exp(wide(k).clamp(-CLIP, CLIP)).to(x.dtype))
        ek = ek.reshape(B, N, heads, dim_head).transpose(1, 2)  # (B, h, N, d)
        vh = wide(v).reshape(B, N, heads, dim_head).transpose(1, 2)
        E = _token_products(ek, vh)  # (B, h, d, e)
        return torch.cat([E.reshape(B, -1), ek.sum(dim=2).reshape(B, hd)], dim=1)


def _token_products(ek: torch.Tensor, vh: torch.Tensor) -> torch.Tensor:
    """E = ek^T v over the tokens of (B, h, N, d) ek and (B, h, N, e) v, as
    the sum of TOKEN_CHUNK-token partial products (zero tokens pad the last
    one).  One fp32 chain over the 65536 tokens of the UNet's first level
    ends about 5e-6 of E's largest value from the exact sum (cuBLAS on the
    card, ``chip_smoke.py`` phase 12): half of the 1e-5 the kernels are held
    to against this plain version."""
    B, h, N, d = ek.shape
    chunks = -(-N // TOKEN_CHUNK)
    if chunks == 1:
        return torch.matmul(ek.transpose(-1, -2), vh)
    pad = chunks * TOKEN_CHUNK - N
    ek = F.pad(ek, (0, 0, 0, pad)).reshape(B, h, chunks, TOKEN_CHUNK, d)
    vh = F.pad(vh, (0, 0, 0, pad)).reshape(B, h, chunks, TOKEN_CHUNK, -1)
    return torch.matmul(ek.transpose(-1, -2), vh).sum(dim=2)


def linear_attention_pass2_reference(x: torch.Tensor, w_qkv: torch.Tensor, sums: torch.Tensor,
                                     heads: int = HEADS, dim_head: int = DIM_HEAD,
                                     prenorm=None) -> torch.Tensor:
    """Plain version of pass 2: context_h = round(E_h * dim_head**-0.5 /
    (s_h * N)) from pass 1's ``sums``, eq = round(exp(clip(q, +-60))), out =
    round(round(eq_h . context_h) / round(sum_d eq_h)): (B, N, heads*dim_head)."""
    B, N, C = x.shape
    hd, dt = heads * dim_head, x.dtype
    with exact(x.device.type):
        E = sums[:, :heads * dim_head * dim_head].reshape(B, heads, dim_head, dim_head)
        s = sums[:, heads * dim_head * dim_head:].reshape(B, heads, dim_head, 1)
        context = wide((E * (dim_head**-0.5) / (s * N)).to(dt))
        q = _projection(x, w_qkv[:, :hd], prenorm, dt)
        eq = wide(torch.exp(wide(q).clamp(-CLIP, CLIP)).to(dt))
        eq = eq.reshape(B, N, heads, dim_head).transpose(1, 2)  # (B, h, N, d)
        num = wide(torch.matmul(eq, context).to(dt))
        den = wide(eq.sum(dim=-1, keepdim=True).to(dt))
        return (num / den).to(dt).transpose(1, 2).reshape(B, N, hd)


def linear_attention_reference(x: torch.Tensor, w_qkv: torch.Tensor, heads: int = HEADS,
                               dim_head: int = DIM_HEAD, prenorm=None) -> torch.Tensor:
    """Plain PyTorch version, step by step as ``blockdiag_linear_attention``
    (whose context is zero off the diagonal blocks): x (B, N, C), w_qkv
    (C, 3*heads*dim_head) fp32 -> (B, N, heads*dim_head) in x.dtype.
    ``prenorm`` is ``(g,)`` or ``(mean, rstd, g)``.  Its products are IEEE
    fp32 (float64 for float64 inputs) with autocast off, whatever the
    process set (``ops/plain.py``)."""
    sums = linear_attention_pass1_reference(x, w_qkv, heads, dim_head, prenorm)
    return linear_attention_pass2_reference(x, w_qkv, sums, heads, dim_head, prenorm)


def build() -> Path:
    """Compile the kernel library for sm_90a (once per source content) and
    return its path."""
    return build_library(_SOURCE, "dmh_linear_attention")


def build_generic() -> Path:
    """Compile the generic variant's library (``csrc/linear_attention_any.cu``)
    for sm_90a and return its path."""
    return build_library(_SOURCE_ANY, "dmh_linear_attention_any")


def build_log(generic: bool = False) -> str:
    """nvcc's ptxas report (registers, shared memory, spills) of the build."""
    return (build_generic() if generic else build()).with_suffix(".log").read_text()


def variant(heads: int, dim_head: int) -> str:
    """The kernels a shape takes: ``"tuned"`` at heads = 4, dim_head = 32,
    ``"generic"`` at every other."""
    return "tuned" if (heads, dim_head) == (HEADS, DIM_HEAD) else "generic"


# the generic variant's plan constants, as csrc/linear_attention_any.cu has them
ANY_THREADS = 256
ANY_GROUP = 128  # padded head columns (heads x padded dim_head) a block holds
ANY_TILE = 64  # tokens per tile (pass 2 at padded dim_head 128: twice that)
ANY_KC = {"bfloat16": 64, "float32": 32}  # channels per ring slot
ANY_TARGET_BLOCKS = 132 * 8  # pass 1's blocks in all, about eight waves of one per SM
ANY_TARGET_PASS2 = 132 * 2  # pass 2's persistent blocks in all
ANY_PREP_ALIGN = 64  # floats: the prepared weights start on this boundary of the scratch


def _any_dim_head_padded(dim_head: int) -> int:
    return next(d for d in (16, 32, 64, 128) if dim_head <= d)


def _any_tile(pass_: int, dp: int) -> int:
    return 2 * ANY_TILE if pass_ == 2 and dp == 128 else ANY_TILE


def _any_smem(pass_: int, fp32: bool, dp: int, cp: int, resident: bool, stages: int) -> int:
    """Dynamic shared memory of a generic block, as the library's smem_bytes."""
    T, es = _any_tile(pass_, dp), 4 if fp32 else 2
    kc = ANY_KC["float32" if fp32 else "bfloat16"]
    slot = kc * (T + (4 if fp32 else 8)) * es + 2 * T * 4  # x rows, mean, rstd
    if pass_ == 1:
        R = 2 * ANY_GROUP
        w_res = cp * R * 4 if fp32 else R * (cp + 8) * 2
        w_slot = kc * R * 4 if fp32 else R * (kc + 8) * 2
        ekv = 2 * T * ANY_GROUP * 4 if fp32 else R * (T + 8) * 2
        return (w_res if resident else 0) + stages * (slot + (0 if resident else w_slot)) + ekv + R * 4
    R = ANY_GROUP
    w_res = cp * R * 4 if fp32 else R * (cp + 8) * 2
    w_str = kc * R * 4 if fp32 else R * (kc + 8) * 2
    tile = (R * (T + 4) + 16) * 4 if fp32 else R * (T + 8) * 2  # eq / output, rows = columns
    ctx = R * dp * 4 if fp32 else R * (dp + 8) * 2
    return (w_res if resident else w_str) + stages * slot + tile + ctx + R * 4


@functools.lru_cache(maxsize=None)
def generic_launch_plan(pass_: int, B: int, N: int, C: int, heads: int, dim_head: int) -> dict:
    """How a generic launch of ``pass_`` goes, from the shapes alone, as
    ``csrc/linear_attention_any.cu`` computes it.  A block holds a group of
    ``heads_per_group`` heads, 128 / ``dim_head_padded`` (dim_head padded to
    16, 32, 64 or 128): ``grid`` is (token chunks, head groups, batch) for
    pass 1 and (persistent blocks per group, head groups, 1) for pass 2;
    ``tile`` tokens per tile; ``tiles_per_chunk`` (pass 2: the most tiles a
    block takes); ``partials``, pass 1's scratch floats: one (E_h, s_h) slot
    per chunk, head and batch, then u = g . W and the prepared weights of
    every group (0 for pass 2).  Per dtype (bf16 unsuffixed, ``_fp32``):
    ``smem`` bytes, ``resident`` (the block's weights staged once, else one
    channel step per ring slot) and ``stages`` (ring slots); the first of
    (resident, 3), (resident, 2), (streamed, 3), (streamed, 2) that fits."""
    dp = _any_dim_head_padded(dim_head)
    hg = ANY_GROUP // dp
    groups = -(-heads // hg)
    cp = -(-C // 16) * 16
    tile = _any_tile(pass_, dp)
    n_tiles = -(-N // tile)
    fit = {}
    for fp32 in (False, True):
        fit[fp32] = next(((res, st) for res in (True, False) for st in (3, 2)
                          if _any_smem(pass_, fp32, dp, cp, res, st) <= SMEM_LIMIT), (False, 2))
    if pass_ == 1:
        want = min(max(1, -(-ANY_TARGET_BLOCKS // (B * groups))), n_tiles)
        per = -(-n_tiles // want)
        grid = (-(-n_tiles // per), groups, B)
        slots = B * heads * grid[0] * (dim_head * dim_head + dim_head)
        partials = (-(-slots // ANY_PREP_ALIGN) * ANY_PREP_ALIGN + groups * 2 * ANY_GROUP
                    + groups * cp * 2 * ANY_GROUP)
    else:
        total = B * n_tiles
        g = min(-(-ANY_TARGET_PASS2 // groups), total)
        grid, per, partials = (g, groups, 1), -(-total // g), 0
    plan = {"grid": grid, "threads": ANY_THREADS, "tile": tile, "tiles_per_chunk": per,
            "partials": partials, "dim_head_padded": dp, "heads_per_group": hg,
            "variant": "generic"}
    for fp32, suffix in ((False, ""), (True, "_fp32")):
        res, st = fit[fp32]
        plan.update({f"smem{suffix}": _any_smem(pass_, fp32, dp, cp, res, st),
                     f"resident{suffix}": int(res), f"stages{suffix}": st})
    return plan


_ANY_PLAN_KEYS = ("grid_x", "grid_y", "grid_z", "threads", "smem", "tile", "tiles_per_chunk",
                  "partials", "dim_head_padded", "heads_per_group", "resident", "stages",
                  "smem_fp32", "resident_fp32", "stages_fp32")


def library_plan_any(pass_: int, B: int, N: int, C: int, heads: int, dim_head: int) -> dict:
    """The plan the generic library launches ``pass_`` with, with the keys
    of :func:`generic_launch_plan` (``partials`` modulo 2^31)."""
    out = (ctypes.c_int * len(_ANY_PLAN_KEYS))()
    err = _library_any().dmh_linear_attention_any_plan(pass_, B, N, C, heads, dim_head, out)
    if err != 0:
        raise RuntimeError(f"linear attention plan refused: cudaError {err}")
    plan = dict(zip(_ANY_PLAN_KEYS, out))
    plan["grid"] = (plan.pop("grid_x"), plan.pop("grid_y"), plan.pop("grid_z"))
    plan["variant"] = "generic"
    return plan


def atomic_instructions_any() -> dict:
    """Atomic instructions in the generic library's machine code of each of
    its kernels (pass 1, the reduction, pass 2): kernel name -> count."""
    found = atomic_instructions(build_generic(), "linear_attention_any_")
    if not all(any(part in n for n in found) for part in ("_pass1_", "_reduce_", "_pass2_")):
        raise RuntimeError("the generic linear-attention kernels are not in the machine code")
    return found


@functools.lru_cache(maxsize=None)
def _library_any() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_generic()))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.dmh_linear_attention_any_pass1
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i32, ptr, ptr, i64,
                   i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    fn = lib.dmh_linear_attention_any_pass2
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                   i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    fn.restype = i32
    fn = lib.dmh_linear_attention_any_plan
    fn.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
    fn.restype = i32
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn = lib.dmh_linear_attention_pass1
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i32, ptr, ptr, i64, i32, i32, i32, ptr]
    fn.restype = i32
    fn = lib.dmh_linear_attention_pass2
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64,
                   i32, i32, i32, ptr]
    fn.restype = i32
    fn = lib.dmh_linear_attention_pass1_bf16
    fn.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i32, ptr, ptr, i64,
                   i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = i32
    fn = lib.dmh_linear_attention_pass1_partials
    fn.argtypes = [i32] * 12 + [ctypes.POINTER(i64)]
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


def _check_cuda_args(x, w_qkv, heads, dim_head, g=None, stats=(), generic: bool = False):
    """Refuses, before any launch, what the shape's kernels do not take."""
    generic = _takes_generic(heads, dim_head, generic)
    if generic:
        for name, value, lo, hi in (("heads", heads, 1, MAX_HEADS),
                                    ("dim_head", dim_head, 1, MAX_DIM_HEAD),
                                    ("heads*dim_head", heads * dim_head, 1, MAX_HIDDEN)):
            if not lo <= value <= hi:
                raise ValueError(f"the generic kernels take {lo} <= {name} <= {hi}; got {value}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    B, N, C = x.shape
    if min(x.stride()) < 0 or B * N * C == 0:
        raise ValueError("x must be non-empty with non-negative strides")
    if generic:
        if C > MAX_CHANNELS:
            raise ValueError(f"the generic kernels take C <= {MAX_CHANNELS}; got {C}")
        if B > MAX_BATCH:
            raise ValueError(f"the generic kernels take B <= {MAX_BATCH}; got {B}")
    _check_fp32("w_qkv", w_qkv, (C, 3 * heads * dim_head), x.device)
    if g is not None:
        _check_fp32("g", g, (C,), x.device)
    for name, t in stats:
        _check_fp32(name, t, (B, N), x.device)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _takes_generic(heads, dim_head, generic: bool) -> bool:
    """Whether a launch goes to the generic library: by shape
    (:func:`variant`), or forced by the private ``_generic`` argument."""
    return generic or variant(heads, dim_head) == "generic"


@functools.lru_cache(maxsize=None)
def _tuned_partials(bf16: bool, prenorm: bool, compute_stats: bool, B: int, N: int, C: int,
                    plan: tuple, aligned: bool) -> int:
    out = ctypes.c_longlong()
    err = _library().dmh_linear_attention_pass1_partials(
        int(bf16), int(prenorm), int(compute_stats), B, N, C, *plan, int(aligned),
        ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"linear attention pass 1 plan refused: cudaError {err}")
    return out.value


def pass1_partials(x: torch.Tensor, g, compute_stats: bool, stats=(), heads: int = HEADS,
                   dim_head: int = DIM_HEAD, _generic: bool = False,
                   plan: dict | None = None) -> int:
    """Floats of the scratch a pass-1 call on x (B, N, C) writes its per-block
    partials to before they are summed: the generic plan's ``partials``, or
    for the tuned kernels the library's count (fp32: B x blocks per batch row
    x (E, s); bf16: a slot of one head's (E_h, s_h) per warp, for each block
    and batch row its tiles meet, the grid following the card's resident
    blocks).  ``stats``: the given mean and rstd, if read; ``plan``: the bf16
    call's :func:`launch_plan`, if made already."""
    B, N, C = x.shape
    if _takes_generic(heads, dim_head, _generic):
        return generic_launch_plan(1, B, N, C, heads, dim_head)["partials"]
    if x.dtype != torch.bfloat16:
        return _tuned_partials(False, g is not None, compute_stats, B, N, C, (0,) * 5, False)
    plan = plan or launch_plan(x, 1, stats)
    return _tuned_partials(True, g is not None, compute_stats, B, N, C, _plan_args(plan),
                           plan["loader"] == "aligned")


def linear_attention_pass1(x, w_qkv, g, mean, rstd, compute_stats: bool, sums: torch.Tensor,
                           heads: int = HEADS, dim_head: int = DIM_HEAD,
                           _generic: bool = False) -> None:
    """Kernel A: (E blocks, s) of x into ``sums`` (B, heads*dim_head*(dim_head+1))
    fp32, written whole (no need to zero it): the blocks write per-block
    partials into a scratch of :func:`pass1_partials` floats, taken from the
    caller's allocator on x's device (under a CUDA graph's capture, from the
    graph's pool), and a second launch sums them in a fixed order.  With ``g``, mean and rstd (B,
    N) fp32 are computed and written (``compute_stats``) or read.
    ``launches`` counts each call (its two launches), ``generic`` those of
    the generic kernel."""
    B, N, C = x.shape
    generic = _takes_generic(heads, dim_head, _generic)
    stats = () if g is None else (mean, rstd)
    read = () if compute_stats else stats
    plan = launch_plan(x, 1, read) if not generic and x.dtype == torch.bfloat16 else None
    partials = torch.empty(pass1_partials(x, g, compute_stats, read, heads, dim_head, generic,
                                          plan), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), *x.stride(), w_qkv.data_ptr(), None if g is None else g.data_ptr(),
            *(tuple(t.data_ptr() for t in stats) or (None, None)),
            int(compute_stats), sums.data_ptr(), partials.data_ptr(), partials.numel())
    with torch.cuda.device(x.device):
        if generic:
            err = _library_any().dmh_linear_attention_any_pass1(
                *args, B, N, C, heads, dim_head, int(x.dtype == torch.bfloat16), _stream(x))
        elif plan is not None:
            err = _library().dmh_linear_attention_pass1_bf16(
                *args, B, N, C, *_plan_args(plan), int(plan["loader"] == "aligned"), _stream(x))
            linear_attention_pass1.elementwise += plan["loader"] == "elementwise"
        else:
            err = _library().dmh_linear_attention_pass1(*args, B, N, C, _stream(x))
    if err != 0:
        raise RuntimeError(f"linear attention pass 1 launch failed: cudaError {err}")
    linear_attention_pass1.launches += 1
    linear_attention_pass1.generic += generic


linear_attention_pass1.launches = 0
linear_attention_pass1.elementwise = 0  # bf16 launches that took the element-wise loader
linear_attention_pass1.generic = 0  # launches of the generic kernel


def linear_attention_pass2(x, w_qkv, g, mean, rstd, sums: torch.Tensor, out: torch.Tensor,
                           heads: int = HEADS, dim_head: int = DIM_HEAD,
                           _generic: bool = False) -> None:
    """Kernel B: out (B, N, heads*dim_head) in x.dtype, written through its
    strides, from x and pass 1's ``sums`` (and mean, rstd with ``g``).
    ``launches`` counts each launch, ``generic`` those of the generic
    kernel."""
    B, N, C = x.shape
    generic = _takes_generic(heads, dim_head, _generic)
    stats = () if g is None else (mean, rstd)
    args = (x.data_ptr(), *x.stride(), w_qkv.data_ptr(), None if g is None else g.data_ptr(),
            *(tuple(t.data_ptr() for t in stats) or (None, None)), sums.data_ptr(),
            out.data_ptr(), *out.stride(), B, N, C)
    with torch.cuda.device(x.device):
        if generic:
            err = _library_any().dmh_linear_attention_any_pass2(
                *args, heads, dim_head, float(dim_head**-0.5), int(x.dtype == torch.bfloat16),
                _stream(x))
        elif x.dtype == torch.bfloat16:
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
    linear_attention_pass2.generic += generic


linear_attention_pass2.launches = 0
linear_attention_pass2.elementwise = 0  # bf16 launches that took the element-wise loader
linear_attention_pass2.generic = 0  # launches of the generic kernel


def _forward(x, w_qkv, g, mean, rstd, heads, dim_head, generic=False):
    """(out, mean, rstd) of one call: on the card both kernels (pass
    1 writes mean and rstd where they are not given), on the CPU the plain
    passes.  mean and rstd are (B, N) fp32, or None without a prenorm."""
    B, N, C = x.shape
    given = mean is not None
    if x.device.type == "cpu":
        if g is None:
            prenorm = None
        else:
            if not given:
                mean, rstd = (t.reshape(B, N) for t in layer_norm_stats(x))
            prenorm = (mean, rstd, g)
        sums = linear_attention_pass1_reference(x, w_qkv, heads, dim_head, prenorm)
        return (linear_attention_pass2_reference(x, w_qkv, sums, heads, dim_head, prenorm),
                mean, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if g is not None and not given:
        mean = torch.empty((B, N), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    elif given:
        mean, rstd = mean.reshape(B, N), rstd.reshape(B, N)
    _check_cuda_args(x, w_qkv, heads, dim_head, g,
                     () if g is None else (("mean", mean), ("rstd", rstd)), generic)
    generic = _takes_generic(heads, dim_head, generic)
    # written whole by pass 1 (its partials are taken from this allocator too:
    # a captured step's from the graph's pool)
    sums = torch.empty((B, sums_width(heads, dim_head)), dtype=torch.float32, device=x.device)
    linear_attention_pass1(x, w_qkv, g, mean, rstd, g is not None and not given, sums,
                           heads, dim_head, generic)
    hd = heads * dim_head
    if x.stride(1) < x.stride(2):
        out = torch.empty((B, hd, N), dtype=x.dtype, device=x.device).transpose(1, 2)
    else:
        out = torch.empty((B, N, hd), dtype=x.dtype, device=x.device)
    linear_attention_pass2(x, w_qkv, g, mean, rstd, sums, out, heads, dim_head, generic)
    return out, mean, rstd


# samples per slice of the backward: its fp32 (B, N, 384) temporaries stay
# near this many bytes each
_BACKWARD_SLICE_BYTES = 1 << 30
# tokens per chunk of the backward's sums over the tokens (where N divides)
_BACKWARD_CHUNK = 1024


def linear_attention_backward(x, w_qkv, g, mean, rstd, dout,
                              heads: int = HEADS, dim_head: int = DIM_HEAD):
    """Gradients of the production function (module docstring, steps 1-3)
    at x (B, N, C), w_qkv (C, 3*heads*dim_head) fp32 and the prenorm gain g
    (C,) with x's fp32 statistics mean and rstd (B, N) from
    ``layer_norm_stats``, or g = mean = rstd = None; ``dout`` the cotangent
    of the output.  Returns (dx, dw_qkv, dg): dx in x's dtype and layout,
    through the statistics too; dg None without g.  With dt = x.dtype, in
    order:

    * qkv recomputed by one projection, then from it ek = exp(clip(k)) and
      eq likewise, before (e32) and after rounding, E = ek^T v, s = sum_n ek,
      the context C, num = round(eq . C) and den = round(sum_d eq) per head.
      Nothing of the kernels' forward is reused: each softmax's two
      cotangent terms below nearly cancel (over d for q, over the tokens for
      k), so both must come from one rounding of qkv, and the kernels round
      theirs elsewhere in last bits (with pass 1's sums, dW of the UNet's
      C = 512 site moved by 2.4e-2 of its largest value in bf16);
    * dnum = round(dout / den), dden = round(-sum_e dout * num / den^2);
    * deq = round(dnum . C^T) + dden; dq = round(deq * eq32 * [|q| < 60]);
      dC = round(eq^T . dnum) on the diagonal blocks;
    * dE = dC * dim_head^-1/2 / (s * N); ds = -sum_e dC * C32 / s, with C32
      the context before rounding;
    * dek = round(v . dE^T) + round(ds); dv = round(ek . dE);
      dk = round(dek * ek32 * [|k| < 60]);
    * then through the projection: without g, dx = round(dqkv . round(W)^T)
      and dW = round(x^T . dqkv); with g, through (a - mean * (g W)) * rstd,
      a = x . round(diag(g) W) (fp32), to dx (with the paths through mean
      and rstd), dW and dg.
    """
    B, N, C = x.shape
    dt = x.dtype
    hd = heads * dim_head
    with torch.autocast(x.device.type, enabled=False):
        if g is None:
            wd = w_qkv.to(dt).float()
        else:
            wd = (w_qkv * g[:, None]).to(dt).float()  # round(diag(g) W)
            u = g @ w_qkv
        dx = torch.empty_like(x)
        dwd = torch.zeros_like(w_qkv)
        du = torch.zeros_like(w_qkv[0]) if g is not None else None
        F = 3 * hd
        wt = wd.t().contiguous()  # (F, C)
        L = _BACKWARD_CHUNK if N % _BACKWARD_CHUNK == 0 else N
        nc = N // L
        step = max(1, _BACKWARD_SLICE_BYTES // (N * F * 4))
        # (samples, chunks of L tokens, features, tokens): each head's block is
        # contiguous, every product a plain batched matmul, and the sums over
        # the tokens (E, s, dC, dW) run per chunk, then over the chunks
        for b0 in range(0, B, step):
            sl = slice(b0, b0 + step)
            Bs = x[sl].shape[0]

            def chunked(t, rows):  # (Bs, N, rows) -> (Bs, nc, rows, L), fp32, a copy
                return (t.transpose(1, 2).reshape(Bs, rows, nc, L).transpose(1, 2)
                        .to(torch.float32, memory_format=torch.contiguous_format))

            xc = chunked(x[sl], C)
            a = torch.matmul(wt, xc)  # (Bs, nc, F, L) fp32
            if g is not None:
                m = mean[sl].reshape(Bs, nc, 1, L)
                r = rstd[sl].reshape(Bs, nc, 1, L)
                a.addcmul_(u[:, None], m, value=-1.0)  # centred: a - (g W) mean
                qkv = torch.mul(a, r, out=torch.empty(a.shape, dtype=dt, device=a.device))
            else:
                qkv = a.to(dt)
                del a
            q, k, v = (t.reshape(Bs, nc, heads, dim_head, L) for t in qkv.split(hd, dim=2))
            # copies (in fp32 ``float()`` would be q itself), then in place
            eq32 = q.to(torch.float32, copy=True).clamp_(-CLIP, CLIP).exp_()
            ek32 = k.to(torch.float32, copy=True).clamp_(-CLIP, CLIP).exp_()
            # the products in fp32 (one rounding to dt, as JAX's), on dt values;
            # E and s again from this ek and v (see the docstring)
            eq, ek, vf = eq32.to(dt).float(), ek32.to(dt).float(), v.float()
            E = torch.matmul(ek, vf.transpose(-1, -2)).sum(dim=1, keepdim=True)  # (Bs,1,h,d,e)
            s = ek.sum(dim=-1, keepdim=True).sum(dim=1, keepdim=True)  # (Bs, 1, h, d, 1)
            ctx32 = E * (dim_head**-0.5) / (s * N)
            ctx = ctx32.to(dt).float()
            num = torch.matmul(ctx.transpose(-1, -2), eq).to(dt).float()  # (Bs,nc,h,e,L)
            den = eq.sum(dim=3, keepdim=True).to(dt).float()  # (Bs, nc, h, 1, L)
            go = chunked(dout[sl], hd).reshape(Bs, nc, heads, dim_head, L)
            dnum = (go / den).to(dt).float()
            dden = (-(go * num).sum(dim=3, keepdim=True) / den**2).to(dt).float()
            del num, go
            deq = torch.matmul(ctx, dnum).to(dt).float().add_(dden).to(dt)  # (Bs,nc,h,d,L)
            dctx = (torch.matmul(eq, dnum.transpose(-1, -2)).sum(dim=1, keepdim=True)
                    .to(dt).float())  # (Bs, 1, h, d, e)
            del eq, dnum, dden
            dE = dctx * (dim_head**-0.5) / (s * N)
            ds = -(dctx * ctx32).sum(dim=-1, keepdim=True) / s  # (Bs, 1, h, d, 1)
            dek = torch.matmul(dE, vf).to(dt).float().add_(ds.to(dt).float()).to(dt)
            # the cotangent of qkv, each part rounded to dt
            dy = torch.empty((Bs, nc, F, L), dtype=torch.float32, device=x.device)
            dq_, dk_, dv_ = (t.view(Bs, nc, heads, dim_head, L) for t in dy.split(hd, dim=2))
            torch.mul(deq, eq32, out=dq_).masked_fill_(q.abs() >= CLIP, 0.0)
            torch.mul(dek, ek32, out=dk_).masked_fill_(k.abs() >= CLIP, 0.0)
            torch.matmul(dE.transpose(-1, -2), ek, out=dv_)
            del eq32, ek32, ek, vf, deq, dek, q, k, v, qkv
            dy.copy_(dy.to(dt))
            # dx[sl] (x's layout) viewed as (Bs, nc, C, L)
            dx_c = dx[sl].transpose(1, 2).reshape(Bs, C, nc, L).transpose(1, 2)
            if g is None:
                dx_c.copy_(torch.matmul(wd, dy))
                dwd += torch.matmul(dy, xc.transpose(-1, -2)).sum(dim=(0, 1)).t()
                continue
            dm = torch.matmul(u, dy).unsqueeze(2).mul_(r).neg_()  # (Bs, nc, 1, L)
            du -= torch.matmul(dy, (m * r).transpose(-1, -2)).sum(dim=(0, 1, 3))
            dr = a.mul_(dy).sum(dim=2, keepdim=True)  # (Bs, nc, 1, L)
            del a
            da = dy.mul_(r)
            dwd += torch.matmul(da, xc.transpose(-1, -2)).sum(dim=(0, 1)).t()
            dxc = torch.matmul(wd, da)  # (Bs, nc, C, L)
            del da, dy
            # mean = sum_c x / C, rstd = (sum_c (x - mean)^2 / C + eps)^-1/2; dx
            # rounds the projection's part to dt first, as JAX sums cotangents
            dvar = dr * (-0.5) * r**3
            dx_c.copy_(dxc.to(dt).float().add_(dm / C).add_(dvar * (2.0 / C) * (xc - m)))
        dwd = dwd.to(dt).float()  # the cotangent of the weights in dt
        if g is None:
            return dx, dwd, None
        dw = dwd * g[:, None] + g[:, None] * du[None, :]
        dg = (dwd * w_qkv).sum(dim=1) + w_qkv @ du
        return dx, dw, dg


class LinearAttentionFunction(torch.autograd.Function):
    """The linear attention under autograd, without a prenorm or with
    ``prenorm=(g,)``: forward by :func:`_forward` (the two kernels on the
    card; pass 1 computes the statistics), backward by
    :func:`linear_attention_backward`.  Saves x (the caller's view, not a
    copy), w_qkv, g and the fp32 mean and rstd (B, N); the backward
    recomputes the rest."""

    @staticmethod
    def forward(ctx, x, w_qkv, g, heads, dim_head, generic=False):
        out, mean, rstd = _forward(x, w_qkv, g, None, None, heads, dim_head, generic)
        ctx.save_for_backward(x, w_qkv, g, mean, rstd)
        ctx.heads, ctx.dim_head = heads, dim_head
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w_qkv, g, mean, rstd = ctx.saved_tensors
        # a profiler range: a step's profile reads the backward's device time from it
        with torch.profiler.record_function("linear_attention_backward"):
            dx, dw, dg = linear_attention_backward(x, w_qkv, g, mean, rstd, dout,
                                                   ctx.heads, ctx.dim_head)
        return dx, dw, dg, None, None, None


def linear_attention(x: torch.Tensor, w_qkv: torch.Tensor, heads: int = HEADS,
                     dim_head: int = DIM_HEAD, prenorm=None,
                     _generic: bool = False) -> torch.Tensor:
    """x (B, N, C) fp32 or bf16, any strides; w_qkv (C, 3*heads*dim_head)
    fp32; ``prenorm`` ``(g,)`` or ``(mean, rstd, g)`` -> (B, N,
    heads*dim_head) in x.dtype.

    CPU tensors go through :func:`linear_attention_reference`; CUDA tensors
    through the two kernels of the shape's variant (:func:`variant`; the
    private ``_generic`` forces the generic one at (4, 32)).  Where a gradient is needed the call goes
    through :class:`LinearAttentionFunction` on either device; it takes
    ``prenorm`` None or ``(g,)`` (given statistics raise).  The output
    has x's layout: channel-major (a transposed (B, heads*dim_head, N) tensor) when
    x's token stride is the smaller, as for the UNet's NCHW activations.
    """
    g = mean = rstd = None
    if prenorm is not None:
        g = prenorm[-1]
        if len(prenorm) == 3:
            mean, rstd = prenorm[:2]
    inputs = (x, w_qkv, g, mean, rstd)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        if mean is not None:
            raise ValueError("a gradient of linear_attention needs prenorm None or (g,): "
                             "the statistics are computed, not given")
        return LinearAttentionFunction.apply(x, w_qkv, g, heads, dim_head, _generic)
    return _forward(x, w_qkv, g, mean, rstd, heads, dim_head, _generic)[0]
