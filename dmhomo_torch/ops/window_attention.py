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
over every window.  On the card each block of the backward sums its head's
``dbias`` over a chunk of windows into a slab of its own, and a second
launch adds the slabs in a fixed order (:func:`window_attention_backward_split_reference`
is that split as plain PyTorch); :func:`launch_plan` gives both kernels'
grids, shared memory and partials from the shapes alone.

Two variants, chosen by shape alone (:func:`variant`): the tuned library
(``csrc/window_attention.cu``) at the shipped 8x8 windows (N = 64) and head
dims 4, 8, 16, 32; the generic one (``csrc/window_attention_any.cu``) at every
other shape of the envelope the Pallas kernels take here: any N up to 144
(windows up to 12x12) and any head dim up to 64 (its plan:
:func:`generic_launch_plan`).  A shape outside the envelope raises before
any launch.  Each CUDA library is built from its source in
``dmhomo_torch/csrc/`` with ``nvcc`` at first use into ``build/kernels/`` of
the checkout, and called through a plain C interface with ``ctypes``.
:func:`window_attention` runs the plain versions for CPU tensors only (both
directions: the explicit backward, not autograd of the plain forward); for a
CUDA tensor it launches the kernels or raises.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import re
from pathlib import Path

import torch

from dmhomo_torch.ops.build import CSRC, atomic_instructions, build_library
from dmhomo_torch.ops.build import tensor_core_instructions as tensor_core_instructions_in
from dmhomo_torch.ops.plain import exact, wide

CLIP = 60.0
WINDOW_TOKENS = 64  # 8x8 windows
HEAD_DIMS = (4, 8, 16, 32)
# the envelope of the generic variant: windows up to 12x12 (the largest
# published Swin window), head dims up to 64
MAX_WINDOW_TOKENS = 144
MAX_HEAD_DIM = 64

_SOURCE = CSRC / "window_attention.cu"
_SOURCE_ANY = CSRC / "window_attention_any.cu"

# the launch plan's constants, as csrc/window_attention.cu has them
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 233472  # bytes of shared memory an SM shares among its blocks
SMEM_PER_BLOCK = 232448  # the most one block may ask for
SMEM_RESERVED = 1024  # bytes the card keeps per resident block
TEAM = 128  # four warps, 16 query rows each
ELD = WINDOW_TOKENS + 4  # row stride of the backward's fp32 e and dsim tiles
BLD = WINDOW_TOKENS + 8  # of a bias or mask tile
FWD_MAX_WINDOWS = 32  # windows a forward block takes at most
FWD_WAVES = 2  # forward blocks per SM slot the chunks aim at
ROW_GROUPS = 4  # the fp32 row kernel (hd >= 8): windows in flight per block
RLD = WINDOW_TOKENS + 1  # its bias and mask rows
GROUP_BYTES = {4: 32, 2: 16}  # q (k, v) bytes per token of a forward head group, by itemsize
DBIAS_PARTS = 4  # ranges of slabs the dbias reduction sums apart, then adds


def _heads(t: torch.Tensor, h: int) -> torch.Tensor:
    """(Bn, N, h*hd) -> (Bn, h, N, hd)."""
    Bn, N, C = t.shape
    return t.reshape(Bn, N, h, C // h).transpose(1, 2)


def _tokens(t: torch.Tensor) -> torch.Tensor:
    """(Bn, h, N, hd) -> (Bn, N, h*hd)."""
    Bn, h, N, hd = t.shape
    return t.transpose(1, 2).reshape(Bn, N, h * hd)


def _logits(q, k, bias, mask):
    """fp32 sim = q k^T + bias (+ mask[b % nW]) of (Bn, h, N, hd) q and k
    (float64 for float64 inputs)."""
    Bn, h, N, _ = q.shape
    sim = torch.matmul(wide(q), wide(k).transpose(-1, -2)) + wide(bias)[None]
    if mask is not None:
        nW = mask.shape[0]
        sim = (sim.reshape(Bn // nW, nW, h, N, N)
               + wide(mask)[None, :, None]).reshape(Bn, h, N, N)
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
    Its products are IEEE fp32 (float64 for float64 inputs) with autocast
    off, whatever the caller's process set (``ops/plain.py``).
    """
    dt = qkv.dtype
    with exact(qkv.device.type):
        q, k, v = _split_scaled(qkv, num_heads)
        e = wide(torch.exp(_logits(q, k, bias, mask).clamp(-CLIP, CLIP)).to(dt))
        out = torch.matmul(e, wide(v)) / e.sum(dim=-1, keepdim=True)
    return _tokens(out.to(dt))


def max_abs_logit(qkv: torch.Tensor, bias: torch.Tensor, *, num_heads: int) -> torch.Tensor:
    """0-d fp32 max |q k^T + bias| over every window and head of qkv
    (Bn, N, 3C), q scaled as the forward scales it, without the SW-MSA mask
    (its -100 entries are meant to clip): the plain logits, which the
    kernels never write out."""
    with exact(qkv.device.type):
        q, k, _ = _split_scaled(qkv, num_heads)
        return _logits(q, k, bias, None).abs().max()


def window_attention_backward_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                        mask: "torch.Tensor | None", gout: torch.Tensor, *,
                                        num_heads: int):
    """Plain PyTorch version of the backward: (dqkv (Bn, N, 3C) in qkv.dtype,
    dbias (h, N, N) fp32 summed over all windows), step by step as the
    Pallas ``_bwd_kernel``.  Computes as :func:`window_attention_reference`.
    """
    dqkv, dsim = _backward_terms(qkv, bias, mask, gout, num_heads)
    return dqkv, dsim.sum(dim=0)


def _backward_terms(qkv, bias, mask, gout, num_heads):
    """dqkv and the per-window dsim (Bn, h, N, N) fp32 of the plain backward."""
    dt = qkv.dtype
    hd = qkv.shape[-1] // 3 // num_heads
    with exact(qkv.device.type):
        q, k, v = _split_scaled(qkv, num_heads)  # q scaled in the I/O dtype
        q32, k32, v32 = wide(q), wide(k), wide(v)
        sim = _logits(q, k, bias, mask)
        inrange = (sim.abs() < CLIP).to(sim.dtype)
        e32 = torch.exp(sim.clamp(-CLIP, CLIP))
        e = wide(e32.to(dt))
        s = e.sum(dim=-1)  # (Bn, h, N) fp32
        ctx = torch.matmul(e, v32)  # un-normalized out
        gg = wide(_heads(gout, num_heads)) / s[..., None]
        ds = -(gg * ctx).sum(dim=-1) / s  # dL/ds = -(gg . ctx) / s
        gg_io = wide(gg.to(dt))
        de = torch.matmul(gg_io, v32.transpose(-1, -2)) + ds[..., None]
        dsim = wide((e32 * de * inrange).to(dt))
        dq = torch.matmul(dsim, k32) * hd**-0.5  # chain rule through the q scaling
        dk = torch.matmul(dsim.transpose(-1, -2), q32)
        dv = torch.matmul(e.transpose(-1, -2), gg_io)
        dqkv = torch.cat([_tokens(t.to(dt)) for t in (dq, dk, dv)], dim=-1)
        return dqkv, dsim


def dbias_partials_reference(dsim: torch.Tensor, windows_per_block: int) -> torch.Tensor:
    """The backward blocks' dbias slabs: (chunks, h, N, N), slab c the sum of
    dsim over windows c * windows_per_block .. (+ windows_per_block), added
    in window order from 0 as each block sums them."""
    Bn = dsim.shape[0]
    chunks = -(-Bn // windows_per_block)
    out = torch.zeros((chunks,) + tuple(dsim.shape[1:]), dtype=torch.float32)
    for i in range(windows_per_block):
        idx = torch.arange(chunks) * windows_per_block + i
        keep = idx < Bn
        out[keep] = out[keep] + dsim[idx[keep]]
    return out


def reduce_dbias_partials(partials: torch.Tensor) -> torch.Tensor:
    """The slabs summed as the reduction launch sums them: ``DBIAS_PARTS``
    contiguous ranges of slabs, each added in slab order from 0, then the
    ranges' sums added in order.  One slab is taken as it is (no launch)."""
    P = partials.shape[0]
    if P == 1:
        return partials[0].clone()
    span = -(-P // DBIAS_PARTS)
    sums = []
    for part in range(DBIAS_PARTS):
        acc = torch.zeros_like(partials[0])
        for c in range(part * span, min(P, (part + 1) * span)):
            acc = acc + partials[c]
        sums.append(acc)
    total = sums[0]
    for acc in sums[1:]:
        total = total + acc
    return total


def window_attention_backward_split_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                              mask: "torch.Tensor | None", gout: torch.Tensor,
                                              *, num_heads: int, windows_per_block: int):
    """The plain backward with dbias summed as the card sums it: per-chunk
    slabs (:func:`dbias_partials_reference`), then the fixed-order reduction
    (:func:`reduce_dbias_partials`).  dqkv is the reference's."""
    dqkv, dsim = _backward_terms(qkv, bias, mask, gout, num_heads)
    return dqkv, reduce_dbias_partials(dbias_partials_reference(dsim, windows_per_block))


def _fwd_rows(hd: int, itemsize: int) -> bool:
    """Whether the forward takes the fp32 row kernel (a thread per query
    row): fp32 from hd 8 up."""
    return itemsize == 4 and hd >= 8


def _fwd_heads(hd: int, itemsize: int) -> int:
    """Heads per forward block: their q (k, v) columns per token fill
    ``GROUP_BYTES`` (a 32-byte sector in fp32, half of one in bf16) for
    small heads; one head from that width up (and in the row kernel)."""
    group = GROUP_BYTES[itemsize]
    if _fwd_rows(hd, itemsize) or hd * itemsize >= group:
        return 1
    return group // (hd * itemsize)


def _stage_ld(width: int, bf16: bool) -> int:
    """Row stride (elements) of a forward block's staged q, k or v slice."""
    return width + 8 if bf16 or width != 8 else 8


def _smem_blocks(smem: int) -> int:
    return SMEM_PER_SM // (smem + SMEM_RESERVED)


@functools.lru_cache(maxsize=None)
def _launch_plan(Bn: int, C: int, heads: int, nW: int, itemsize: int, backward: bool) -> dict:
    N = WINDOW_TOKENS
    hd = C // heads
    if backward:
        # bias tile; q, k, v, gout and round(gg) of one head (fp32); the e
        # and dsim tiles and the next window's q, k, v, gout in the I/O dtype
        smem = (4 * (N * BLD + 5 * N * (hd + 4))
                + itemsize * (2 * N * (N + 8 if itemsize == 2 else ELD) + 4 * N * hd))
        per_sm = min(_smem_blocks(smem), 3 if hd < 32 else 2)  # and the launch bounds
        chunks = min(max(SMS * per_sm // heads, 1), Bn)  # the card's slots filled once
        per = -(-Bn // chunks)
        chunks = -(-Bn // per)
        return {"grid": (heads, chunks), "threads": TEAM, "smem": smem, "heads_per_block": 1,
                "windows_per_block": per, "blocks_per_sm": per_sm, "partials": chunks,
                "variant": "tuned"}
    hg = _fwd_heads(hd, itemsize)
    groups = -(-heads // hg)
    rows = _fwd_rows(hd, itemsize)
    if rows:  # the head's bias tile, the mask row, k and v of ROW_GROUPS windows
        threads = ROW_GROUPS * N
        smem = 4 * ((2 if nW else 1) * N * RLD + ROW_GROUPS * 2 * N * hd)
    else:  # the group's bias tiles and the mask row (fp32), two windows' q, k, v slices
        threads = 2 * TEAM if hg > 1 else TEAM
        smem = (4 * (hg + (1 if nW else 0)) * N * BLD
                + itemsize * 2 * 3 * N * _stage_ld(hg * hd, itemsize == 2))
    per_sm = min(_smem_blocks(smem), 2048 // threads)
    n_mask = nW if nW else 1
    n_per = Bn // n_mask
    unit = ROW_GROUPS if rows else 1  # the row kernel takes whole rounds of windows
    want = n_mask * n_per * groups // (SMS * per_sm * FWD_WAVES)
    want = unit if want < unit else (FWD_MAX_WINDOWS if want > FWD_MAX_WINDOWS
                                     else want // unit * unit)
    chunks = -(-n_per // want)
    per = -(-n_per // chunks)
    per = -(-per // unit) * unit
    chunks = -(-n_per // per)
    return {"grid": (n_mask * chunks, groups), "threads": threads, "smem": smem,
            "heads_per_block": hg, "windows_per_block": per, "blocks_per_sm": per_sm,
            "partials": 0, "variant": "tuned"}


def variant(N: int, hd: int) -> str:
    """The kernels a shape takes: ``"tuned"`` at N = 64 tokens and a head dim
    in ``HEAD_DIMS``, ``"generic"`` at every other shape."""
    return "tuned" if N == WINDOW_TOKENS and hd in HEAD_DIMS else "generic"


# the generic variant's plan constants, as csrc/window_attention_any.cuh has them
ANY_THREADS = 256  # the most an attention block takes; the reduction's blocks
ANY_MAX_WARPS = ANY_THREADS // 32
ANY_GROUP_BYTES = 128  # q (k, v) bytes per token a head group aims at, N <= 16
ANY_TASKS_PER_WARP = 2  # windows a warp takes per stage, N <= 16
ANY_SMALL_SMEM = 65536  # the shared memory a block aims under, N <= 16
_ANY_PLAN_KEYS = ("grid_x", "grid_y", "threads", "smem", "windows_per_stage",
                  "windows_per_block", "blocks_per_sm", "partials", "heads_per_block",
                  "warps_per_head", "stages", "tasks_per_warp", "padded_tokens", "padded_hd",
                  "ld")


def _any_pad_hd(hd: int, itemsize: int) -> int:
    if itemsize == 4 and hd <= 4:
        return 4
    return next(p for p in (8, 16, 32, 64) if hd <= p)


def _any_stage_ld(hdp: int, itemsize: int) -> int:
    """Row stride (elements) of a staged slice: bf16 rows an odd number of
    16-byte units (ldmatrix without bank conflicts); fp32 rows 4 floats past
    a multiple of 8 (hd 4 and 64 unpadded)."""
    if itemsize == 2:
        return hdp if (hdp // 8) % 2 else hdp + 8
    return hdp if hdp in (4, 64) else hdp + 4


def _any_reg_cap(hdp: int, itemsize: int) -> int:
    """Registers a thread may take under the kernels' launch bounds: blocks
    of ``ANY_THREADS`` an SM promised three in bf16 and at hd <= 4 (80
    registers, allocated 8 at a time), two in fp32 at hd 5-16 (128), one
    above."""
    blocks = 1 if hdp > 16 else 3 if itemsize == 2 or hdp <= 4 else 2
    return 65536 // (ANY_THREADS * blocks) // 8 * 8 if blocks > 1 else 256


def _any_tile_ld(np_: int, hdp: int, itemsize: int) -> int:
    """Row stride (floats) of a backward warp's e32 / dsim tile."""
    return np_ if itemsize == 4 and hdp == 64 and np_ > 128 else np_ + 4


@functools.lru_cache(maxsize=None)
def generic_launch_plan(Bn: int, N: int, hd: int, heads: int, backward: bool,
                        itemsize: int = 4) -> dict:
    """How a generic launch goes for Bn windows of N tokens and ``heads`` heads
    of ``hd`` in an I/O dtype of ``itemsize`` bytes, from the shapes alone, as
    ``csrc/window_attention_any.cuh`` computes it.  A warp owns a (window,
    head) pair whole; a block a group of ``heads_per_block`` heads (at N <=
    16 their q columns of a token up to 128 bytes, or all heads where there
    are at most 8 making at most twice that; one head above) and a chunk of
    ``windows_per_block`` windows, walked a stage of
    ``windows_per_stage`` (``warps_per_head`` x ``tasks_per_warp``) windows
    at a time, ``stages`` slots (2: double-buffered).  The staged slices are
    ``padded_tokens`` (N up to a multiple of 16) x ``ld`` elements, the head
    dim padded to ``padded_hd``; the backward adds a warp's fp32 tile
    (padded_tokens^2 and its rows' ds).  Halving the windows a warp takes,
    then the warps a head, then the stages until the block fits 64 KB (N <=
    16) or a block's 227 KB.  ``grid`` (chunks, head groups), ``threads``,
    dynamic shared memory ``smem`` (bytes), ``blocks_per_sm`` by shared
    memory, threads and the registers the launch bounds allow, the
    backward's dbias ``partials`` (a slab per chunk and warp of a head; 0
    for the forward)."""
    np_ = -(-N // 16) * 16
    hdp = _any_pad_hd(hd, itemsize)
    ld = _any_stage_ld(hdp, itemsize)
    small = np_ == 16
    task = (4 if backward else 3) * np_ * ld * itemsize
    scratch = 4 * (np_ * _any_tile_ld(np_, hdp, itemsize) + np_) if backward else 0
    nh = min(max(1, ANY_GROUP_BYTES // (hd * itemsize)) if small else 1, ANY_MAX_WARPS)
    if small and heads <= ANY_MAX_WARPS and heads <= 2 * nh:  # no group left half idle
        nh = heads
    nh = min(nh, heads)
    groups = -(-heads // nh)
    nh = -(-heads // groups)
    R, tpw, stages = ANY_MAX_WARPS // nh, ANY_TASKS_PER_WARP if small else 1, 2
    budget = ANY_SMALL_SMEM if small else SMEM_PER_BLOCK

    def size():
        return stages * R * tpw * nh * task + nh * R * scratch

    while size() > budget:
        if tpw > 1:
            tpw = 1
        elif R > 1:
            R //= 2
        elif stages > 1:
            stages = 1
        else:
            break
    smem = min(size(), SMEM_PER_BLOCK + 1)
    threads = 32 * nh * R
    per_sm = min(_smem_blocks(smem), 2048 // threads, 65536 // (_any_reg_cap(hdp, itemsize) * threads))
    G = R * tpw
    rounds = -(-Bn // G)
    chunks = SMS * max(per_sm, 1) // groups
    chunks = max(1, min(chunks, rounds))
    per = -(-Bn // chunks)
    per = -(-per // G) * G
    chunks = -(-Bn // per)
    return {"grid": (chunks, groups), "threads": threads, "smem": smem,
            "windows_per_stage": G, "windows_per_block": per, "blocks_per_sm": per_sm,
            "partials": chunks * R if backward else 0, "heads_per_block": nh,
            "warps_per_head": R, "stages": stages, "tasks_per_warp": tpw,
            "padded_tokens": np_, "padded_hd": hdp, "ld": ld, "variant": "generic"}


def launch_plan(qkv: torch.Tensor, num_heads: int, backward: bool = False,
                mask: "torch.Tensor | None" = None) -> dict:
    """How the forward (or backward) kernel launches for qkv (Bn, N, 3C) on
    the card, from the shapes alone.  At the tuned shapes (:func:`variant`),
    as ``csrc/window_attention.cu`` computes it: ``grid``, ``threads``,
    dynamic shared memory ``smem`` (bytes), ``heads_per_block``,
    ``windows_per_block``, ``blocks_per_sm`` by shared memory and the launch
    bounds (the registers may allow fewer), and the backward's dbias
    ``partials`` (slabs, one per chunk of windows, added by a second launch
    where there are more than one; 0 for the forward); elsewhere
    :func:`generic_launch_plan`.  ``variant`` says which.  The
    libraries compute their launches themselves; a ``gpu`` test and
    ``chip_smoke.py`` hold this plan to the library's (:func:`library_plan`)
    key for key."""
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    if variant(N, C // num_heads) == "generic":
        return generic_launch_plan(Bn, N, C // num_heads, num_heads, backward,
                                   qkv.element_size())
    return _launch_plan(Bn, C, num_heads, 0 if mask is None else mask.shape[0],
                        qkv.element_size(), backward)


def build() -> Path:
    """Compile the kernel library for sm_90a (once per source content) and
    return its path."""
    return build_library(_SOURCE, "dmh_window_attention")


def build_generic() -> Path:
    """Compile the generic variant's library (``csrc/window_attention_any.cu``
    and its header) for sm_90a and return its path."""
    return build_library(_SOURCE_ANY, "dmh_window_attention_any")


def build_log(generic: bool = False) -> str:
    """nvcc's ptxas report (registers, shared memory, spills) of the build."""
    return (build_generic() if generic else build()).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def _library_any() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_generic()))
    fn = lib.dmh_window_attention_any_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dmh_window_attention_any_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dmh_window_attention_any_plan
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


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
    fn = lib.dmh_window_attention_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


_PLAN_KEYS = ("grid_x", "grid_y", "threads", "smem", "heads_per_block", "windows_per_block",
              "blocks_per_sm", "partials")


@functools.lru_cache(maxsize=None)
def _library_plan(Bn: int, C: int, heads: int, nW: int, bf16: bool, backward: bool) -> dict:
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    err = _library().dmh_window_attention_plan(Bn, C, heads, nW, int(bf16), int(backward), out)
    if err != 0:
        raise RuntimeError(f"window attention plan refused: cudaError {err}")
    plan = dict(zip(_PLAN_KEYS, out))
    plan["grid"] = (plan.pop("grid_x"), plan.pop("grid_y"))
    plan["variant"] = "tuned"
    return plan


@functools.lru_cache(maxsize=None)
def _library_plan_any(Bn: int, N: int, C: int, heads: int, backward: bool, bf16: bool) -> dict:
    n = len(_ANY_PLAN_KEYS)
    out = (ctypes.c_int * (2 * n))()  # the fp32 plan, then the bf16 one
    err = _library_any().dmh_window_attention_any_plan(Bn, N, C, heads, int(backward), out)
    if err != 0:
        raise RuntimeError(f"window attention plan refused: cudaError {err}")
    plan = dict(zip(_ANY_PLAN_KEYS, out[n:] if bf16 else out[:n]))
    plan["grid"] = (plan.pop("grid_x"), plan.pop("grid_y"))
    plan["variant"] = "generic"
    return plan


def library_plan(qkv: torch.Tensor, num_heads: int, backward: bool = False,
                 mask: "torch.Tensor | None" = None, _generic: bool = False) -> dict:
    """The plan the library of the shape's variant launches with, with the
    keys of :func:`launch_plan`; only the shapes and dtype of ``qkv`` and
    ``mask`` are read, so they may lie on the CPU."""
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    if _generic or variant(N, C // num_heads) == "generic":
        return _library_plan_any(Bn, N, C, num_heads, backward, qkv.dtype == torch.bfloat16)
    return _library_plan(Bn, C, num_heads, 0 if mask is None else mask.shape[0],
                         qkv.dtype == torch.bfloat16, backward)


def tensor_core_instructions(generic: bool = False) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in the built library's machine
    code of each kernel instantiation: ``(direction, dtype, hd, mask)`` ->
    count (``mask`` None for the backward, whose mask is a runtime
    argument).  The bf16 kernels run their products on tensor cores, the
    fp32 ones on CUDA cores (TF32 off).  With ``generic``, the generic
    library's kernels, one instantiation per padded head dim, keyed
    ``(direction, dtype, "generic", padded head dim)``: the same rule holds
    (``mma.sync`` in every bf16 one, no tensor-core instruction in an fp32
    one)."""
    out = {}
    lib = build_generic() if generic else build()
    for name, n in tensor_core_instructions_in(lib, "window_attention_").items():
        key = kernel_key(name)
        if key is not None:
            out[key] = n
    if not any(k[0] == "bwd" for k in out) or not any(k[0] == "fwd" for k in out):
        raise RuntimeError("the window-attention kernels are not in the library's machine code")
    return out


def atomic_instructions_by_kernel(generic: bool = False) -> dict:
    """Atomic instructions in the built library's machine code of every
    window-attention kernel (the forward's, the backward and its dbias
    reduction): kernel name -> count.  With ``generic``, the generic
    library's (forward, backward, the slabs' reduction)."""
    if generic:
        found = atomic_instructions(build_generic(), "window_attention_any_")
        parts = ("_fwd_", "_bwd_", "_reduce_")
    else:
        found = atomic_instructions(build(), "window_attention_")
        parts = ("_fwd_", "_bwd_", "_dbias_")
    if not all(any(part in n for n in found) for part in parts):
        raise RuntimeError("the window-attention kernels are not in the library's machine code")
    return found


# window_attention_fwd_kernel<T, HD, MASK>, window_attention_fwd_rows_kernel<HD,
# MASK> (fp32), window_attention_bwd_kernel<T, HD>
_KERNEL_NAME = re.compile(
    r"window_attention_(fwd|bwd)(?:_rows)?_kernelI(f|13__nv_bfloat16)?Li(\d+)E(?:Lb([01])E)?")
# the generic wa_any::window_attention_any_{fwd,bwd}_kernel<T, padded hd>
_ANY_KERNEL_NAME = re.compile(
    r"window_attention_any_(fwd|bwd)_kernelI(f|13__nv_bfloat16)Li(\d+)EE")


def kernel_key(name: str):
    """(direction, dtype, hd, mask or None) of a kernel's mangled name; for
    the generic variant's, hd ``"generic"`` and its padded head dim in place
    of the mask; None for the dbias reductions."""
    m = _ANY_KERNEL_NAME.search(name)
    if m is not None:
        return (m.group(1), "bfloat16" if m.group(2) == "13__nv_bfloat16" else "float32",
                "generic", int(m.group(3)))
    m = _KERNEL_NAME.search(name)
    if m is None:
        return None
    return (m.group(1), "bfloat16" if m.group(2) == "13__nv_bfloat16" else "float32",
            int(m.group(3)), None if m.group(4) is None else m.group(4) == "1")


def _check_cuda_args(qkv, bias, mask, num_heads):
    """Raises on what no kernel takes: N = 1..144 tokens, head dims 1..64,
    fp32 or bf16, contiguous 16-byte aligned tensors, bias (heads, N, N) and
    mask (nW, N, N) fp32, Bn a multiple of nW."""
    if (qkv.dim() != 3 or not 1 <= qkv.shape[1] <= MAX_WINDOW_TOKENS or qkv.shape[2] % 3
            or qkv.shape[0] == 0):
        raise ValueError(f"qkv must be (Bn, N, 3C) with 1 <= N <= {MAX_WINDOW_TOKENS} "
                         f"(windows up to 12x12); got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv must be float32 or bfloat16; got {qkv.dtype}")
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    if num_heads < 1 or C % num_heads or not 1 <= C // num_heads <= MAX_HEAD_DIM:
        raise ValueError(f"head dim C/num_heads = {C}/{num_heads} must be a whole number "
                         f"1..{MAX_HEAD_DIM}")
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


def _takes_generic(qkv, num_heads, generic: bool) -> bool:
    """Whether a checked launch goes to the generic library: by shape
    (:func:`variant`), or forced by the private ``_generic`` argument."""
    N, C = qkv.shape[1], qkv.shape[2] // 3
    return generic or variant(N, C // num_heads) == "generic"


def _count(fn, qkv, num_heads, mask, generic: bool) -> None:
    fn.launches += 1
    fn.launches_by_shape[_shape_key(qkv, num_heads, mask)] += 1
    fn.launches_by_variant["generic" if generic else "tuned"] += 1


def _forward(qkv, bias, mask, num_heads, generic=False):
    if qkv.device.type == "cpu":
        return window_attention_reference(qkv, bias, mask, num_heads=num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    _check_cuda_args(qkv, bias, mask, num_heads)
    generic = _takes_generic(qkv, num_heads, generic)
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    out = torch.empty((Bn, N, C), dtype=qkv.dtype, device=qkv.device)
    nW = mask.shape[0] if mask is not None else 0
    args = (qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
            out.data_ptr(), Bn)
    tail = (_scale_io(C // num_heads, qkv.dtype), int(qkv.dtype == torch.bfloat16),
            torch.cuda.current_stream(qkv.device).cuda_stream)
    with torch.cuda.device(qkv.device):
        if generic:
            err = _library_any().dmh_window_attention_any_fwd(*args, N, C, num_heads, nW, *tail)
        else:
            err = _library().dmh_window_attention_fwd(*args, C, num_heads, nW, *tail)
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: cudaError {err}")
    _count(window_attention, qkv, num_heads, mask, generic)
    return out


def _shape_key(qkv, num_heads, mask) -> tuple:
    """(Bn, C, heads, nW (0 without a mask), dtype name): the key of
    ``launches_by_shape``."""
    return (qkv.shape[0], qkv.shape[2] // 3, num_heads, 0 if mask is None else mask.shape[0],
            str(qkv.dtype).split(".")[-1])


def _scale_io(hd: int, dtype: torch.dtype) -> float:
    """hd**-0.5 as the I/O dtype holds it: the kernels scale q in that dtype."""
    return float(torch.tensor(hd**-0.5, dtype=dtype))


def window_attention_backward(qkv: torch.Tensor, bias: torch.Tensor,
                              mask: "torch.Tensor | None", gout: torch.Tensor, *,
                              num_heads: int, _generic: bool = False):
    """Window attention backward: (dqkv (Bn, N, 3C), dbias (h, N, N) fp32).

    CUDA tensors go through the hand-written kernels of the shape's variant
    (``_generic`` forces the generic one; ``launches`` counts each call,
    ``launches_by_shape`` the same by :func:`_shape_key`,
    ``launches_by_variant`` by variant); CPU tensors through
    :func:`window_attention_backward_reference`.
    """
    if qkv.device.type == "cpu":
        return window_attention_backward_reference(qkv, bias, mask, gout, num_heads=num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    _check_cuda_args(qkv, bias, mask, num_heads)
    _check_gout(qkv, gout)
    generic = _takes_generic(qkv, num_heads, _generic)
    Bn, N, C3 = qkv.shape
    C = C3 // 3
    dqkv = torch.empty_like(qkv)
    hd = C // num_heads
    nW = mask.shape[0] if mask is not None else 0
    with torch.cuda.device(qkv.device):
        # the blocks' dbias slabs, summed in a fixed order into slab 0 by the
        # library's second launch
        slabs = library_plan(qkv, num_heads, True, mask, generic)["partials"]
        dbias = torch.empty((slabs, num_heads, N, N), dtype=torch.float32, device=qkv.device)
        args = (qkv.data_ptr(), bias.data_ptr(), mask.data_ptr() if mask is not None else None,
                gout.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(), Bn)
        tail = (_scale_io(hd, qkv.dtype), hd**-0.5, int(qkv.dtype == torch.bfloat16),
                torch.cuda.current_stream(qkv.device).cuda_stream)
        if generic:
            err = _library_any().dmh_window_attention_any_bwd(*args, N, C, num_heads, nW, *tail)
        else:
            err = _library().dmh_window_attention_bwd(*args, C, num_heads, nW, *tail)
    if err != 0:
        raise RuntimeError(f"window attention backward kernel launch failed: cudaError {err}")
    _count(window_attention_backward, qkv, num_heads, mask, generic)
    return dqkv, dbias[0]  # the slabs' sum; autograd frees the buffer once it is taken


window_attention_backward.launches = 0
window_attention_backward.launches_by_shape = collections.Counter()
window_attention_backward.launches_by_variant = collections.Counter()


class WindowAttentionFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (the
    ``custom_vjp`` of ``fused_window_attention``).  Under autocast the
    inputs keep their dtypes: bf16 qkv stays bf16, the fp32 bias fp32."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, bias, mask, num_heads, generic):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.config = (num_heads, generic)
        return _forward(qkv, bias, mask, num_heads, generic)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, gout):
        qkv, bias, mask = ctx.saved_tensors
        num_heads, generic = ctx.config
        # the gradient out of the output projection may be a strided view
        dqkv, dbias = window_attention_backward(qkv, bias, mask, gout.contiguous(),
                                                num_heads=num_heads, _generic=generic)
        return dqkv, dbias, None, None, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     mask: "torch.Tensor | None" = None, *,
                     num_heads: int, _generic: bool = False) -> torch.Tensor:
    """Window attention, (Bn, N, 3C) -> (Bn, N, C), differentiable in qkv
    and bias.

    CUDA tensors go through the hand-written kernels of the shape's variant
    (:func:`variant`; the private ``_generic`` forces the generic one at a
    tuned shape, to hold the two against each other): ``launches`` counts
    each forward call, ``window_attention_backward.launches`` each backward
    one, and each has the same counts by shape in ``launches_by_shape`` and
    by variant in ``launches_by_variant``.  CPU tensors go through the plain
    versions.
    """
    return WindowAttentionFunction.apply(qkv, bias, mask, num_heads, _generic)


window_attention.launches = 0
window_attention.launches_by_shape = collections.Counter()
window_attention.launches_by_variant = collections.Counter()
