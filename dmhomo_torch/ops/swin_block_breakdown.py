"""Where the whole-block Swin kernels spend their time, on the card.

  python -m dmhomo_torch.ops.swin_block_breakdown [--direction bwd|fwd] [--source PATH ...]
                                                  [--whole] [--iters 10]
  python -m dmhomo_torch.ops.swin_block_breakdown --generic --whole [--source PATH ...]
                                                  [--rounds 2]
  python -m dmhomo_torch.ops.swin_block_breakdown --generic --launches

Builds copies of a ``swin_block.cu`` source (this checkout's by default, or
earlier revisions' given by ``--source``) with one part of the backward
(``--direction bwd``, the default) or of the forward (``fwd``) removed, each
removal a textual edit checked to apply, then times each copy with CUDA
events.  The backward: at the six Swin-block shapes of a shipped training
microbatch (B=8), each at the dtype the bf16 training step gives it, with
and without the shift and its mask.  The forward: at the same six shapes
twice, at the eval forward's (B=32, fp32; 40 launches a forward) and at the
training step's (B=8, each block at its step dtype; 320 launches a step:
160 forwards and their remat recomputes).  A copy's outputs are
meaningless; the difference of its time to the unchanged source's is the
cost of the removed part, where the parts overlap less than fully.
``--whole`` times each source unchanged only, to compare sources.

``--generic --whole [--source PARENT.cu NEW.cu ...] [--rounds 2]`` times
revisions of the generic library (``dmhomo_torch/csrc/swin_block_any.cu``,
the default source; each built with the ``window_attention_any.cuh`` beside
it, its revision's, else with ``csrc/``'s) at the window-4 sites: the six levels above with 4x4
windows and an MLP of 3C, the eval forward at B=32 in fp32 (40 launches)
and the training step at B=8 with each level at its step dtype, forward
(320 launches) and backward (160), half of each shifted by 2 with a mask,
each shape weighted by its launches.  The sources run in turns (A, B, B, A
per round) in one process; each revision's scratch is the size its own
layout entry point reports.  ``--generic --launches`` splits this
checkout's generic block at the same sites into its launches
(``GENERIC_FORWARD`` / ``GENERIC_BACKWARD``): each launch's device time by
torch.profiler over 5 calls, per site and weighted by launches.

Two designs are known by their source: the five-kernel backward (the copies
skip one launch each, or drop the recompute kernel's attention, MLP or
scratch stores) and the single per-window kernel it replaced, with
global atomics for every gradient (the copies drop the atomics, keeping the
sums they add; the attention's backward; the weight-gradient products).
Two forward designs are known by their source, the first port's fp32-buffer
kernel and the head-grouped one with buffers in the I/O dtype; the copies
drop the attention, the qkv projection's products, the MLP (y = h + c2),
the weight staging (the products read whatever the weight buffer holds) or
both LayerNorms.  Prints one line per copy and
shape, the launch-weighted ms per eval forward and per training step of
each copy, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from dmhomo_torch.ops import swin_block as sb
from dmhomo_torch.ops.build import CSRC, nvcc
from dmhomo_torch.ops.window_attention import _scale_io

B = B_TRAIN = 8  # a training microbatch
# (H, W, C, heads, backward launches per step (half of them shifted), step dtype)
LEVELS = [(160, 288, 24, 3, 16, torch.bfloat16), (80, 144, 48, 12, 32, torch.bfloat16),
          (40, 72, 96, 24, 48, torch.bfloat16), (80, 144, 48, 3, 16, torch.float32),
          (40, 72, 96, 3, 16, torch.float32), (40, 72, 96, 12, 32, torch.float32)]

# (H, W, C, heads, forward launches per eval forward at B=32 (fp32), per
# training step at B=8 (160 forwards and their remat recomputes), step dtype)
FWD_LEVELS = [(160, 288, 24, 3, 4, 32, torch.bfloat16), (80, 144, 48, 12, 8, 64, torch.bfloat16),
              (40, 72, 96, 24, 12, 96, torch.bfloat16), (80, 144, 48, 3, 4, 32, torch.float32),
              (40, 72, 96, 3, 4, 32, torch.float32), (40, 72, 96, 12, 8, 64, torch.float32)]
EVAL_B = 32

_NOT = "true ? cudaSuccess : "
_FAKE_ADD = ("namespace {\n\n// keeps the sum it is given live, adds nothing\n"
             "__device__ __forceinline__ void fake_add(float* p, float v) {\n"
             "  if (v == 1.2345e-37f) *p = v;\n}\n")


def variants(src: str) -> dict:
    """Copies of the source with one part of the backward removed: name ->
    source."""
    if "swin_block_bwd_kernel<" in src:  # the per-window kernel with atomics
        edits = {
            "without its global atomics": [("namespace {\n", _FAKE_ADD, 1),
                                           ("atomicAdd(", "fake_add(", None)],
            "without the attention's backward": [
                ("  attention_bwd<T, C, HD>(qs, xs, os, dss, p, gr.bias, w, scale_io, scale, tid);\n",
                 "", 1)],
            "without the weight-gradient products": [
                ("  using Wt = WTiling<C>;\n  const int rg = tid / Wt::CG, cg = tid % Wt::CG;\n"
                 "  float acc[Wt::TR][Wt::TC];\n",
                 "  return;\n  using Wt = WTiling<C>;\n  const int rg = tid / Wt::CG, "
                 "cg = tid % Wt::CG;\n  float acc[Wt::TR][Wt::TC];\n", 1)],
        }
    else:
        # a launch's expression made one that never launches
        edits = {f"without the {part} kernel": [(call, skip + call, 1)] for part, call, skip in (
            ("recompute", "launch<swin_block_bwd_recompute_kernel<T, C, HD>>(", _NOT),
            ("attention", "launch<swin_block_bwd_attention_kernel<T, C, HD>>(", _NOT),
            ("input", "launch<swin_block_bwd_input_kernel<T, C>>(", _NOT),
            ("weights", "launch<swin_block_bwd_weights_kernel<T, C>>(", _NOT),
            ("reduce", "swin_block_bwd_reduce_kernel<<<", "if (0) "))}
        edits.update({
            "the recompute kernel without its attention": [
                ("  attention_fwd<T, C, HD>(qs, as, p, w, scale_io, ws, 0, tid);\n", "", 1)],
            "the recompute kernel without its MLP": [
                ("  Proj<T, C> dn2(tid);\n  for (int blk = 0; blk < mlp_blocks; ++blk) {",
                 "  Proj<T, C> dn2(tid);\n  for (int blk = 0; blk < mlp_blocks * 0; ++blk) {", 1)],
            "the recompute kernel without its scratch stores": [
                ("    IO<S>::store4(dst + static_cast<size_t>(t) * ldd + c, src + t * lds + c);",
                 "    if (ldd < 0) IO<S>::store4(dst + static_cast<size_t>(t) * ldd + c, "
                 "src + t * lds + c);", 1)],
        })
    return _apply(src, edits)


def forward_variants(src: str) -> dict:
    """Copies of the source with one part of the forward kernel removed:
    name -> source."""
    if "project_qkv<T, C>(cs, hs, ldh, p, ws, tid);" in src:  # the first port's kernel
        edits = {
            "without the attention": [
                ("  attention<T, C, HD>(hs, ldh, cs, p, w, scale, tid);\n", "", 1)],
            "without the qkv products": [
                ("    mma_block<C>(n1, LD, 0, ws, acc, rg, cg);\n", "", 1)],
            "without the MLP": [
                ("  const int mlp_blocks = hidden / C;\n\n  extern __shared__ float4 smem4[];\n"
                 "  float* xs = reinterpret_cast<float*>(smem4);  // N x LD: x, then h\n"
                 "  float* cs",
                 "  const int mlp_blocks = 0 * (hidden / C);\n\n  extern __shared__ float4 "
                 "smem4[];\n  float* xs = reinterpret_cast<float*>(smem4);  // N x LD: x, then "
                 "h\n  float* cs", 1)],
            "without the weight staging": [
                ("  for (int e = tid; e < C * Q; e += THREADS) {\n    const int n = e / Q",
                 "  for (int e = tid; e < C * Q * 0; e += THREADS) {\n    const int n = e / Q",
                 1)],
            "without the LayerNorms": [
                ("  layer_norm<T, C>(xs, cs, p.g1, p.b1, tid);\n", "", 1),
                ("  layer_norm<T, C>(xs, cs, p.g2, p.b2, tid);\n", "", 1)],
        }
    elif "struct FwdWeights" in src:  # the head-grouped kernel with buffers in the I/O dtype
        edits = {
            "without the attention": [
                ("    if (GROUPS == 3 || blk == 2)\n      attention_fwd<",
                 "    if (false)\n      attention_fwd<", 1)],
            "without the qkv products": [
                ("      pr.mma(as, LD, ws);\n      pr.for_each([&](int r, int n, float v) {\n"
                 "        // q kept scaled",
                 "      pr.for_each([&](int r, int n, float v) {\n        // q kept scaled", 1)],
            "without the MLP": [
                ("  for (int blk = 0; blk < mlp_blocks; ++blk) {\n    {\n"
                 "      Proj<T, C> pr(tid);\n      pr.mma(xs, LD, ws);",
                 "  for (int blk = 0; blk < 0 * mlp_blocks; ++blk) {\n    {\n"
                 "      Proj<T, C> pr(tid);\n      pr.mma(xs, LD, ws);", 1)],
            "without the weight staging": [
                ("    for (int e = tid; e < C * Q; e += THREADS) {\n      const int n = e / Q, "
                 "k = 4 * (e % Q);\n      const int row = r0",
                 "    for (int e = tid; e < C * Q * 0; e += THREADS) {\n      const int n = e / Q, "
                 "k = 4 * (e % Q);\n      const int row = r0", 1),
                ("      for (int e = tid; e < C * Q; e += THREADS)\n"
                 "        st4(ws + (e / Q) * LD",
                 "      for (int e = tid; e < C * Q * 0; e += THREADS)\n"
                 "        st4(ws + (e / Q) * LD", 1)],
            "without the LayerNorms": [
                ("  layer_norm<T, C, LD>(xs, as, p.g1, p.b1, tid);\n  wt.wait();\n",
                 "  wt.wait();\n", 1),
                ("  layer_norm<T, C, LD>(as, xs, p.g2, p.b2, tid);\n", "", 1)],
        }
    else:
        raise ValueError("not a whole-block forward this tool knows")
    return _apply(src, edits)


def _apply(src: str, edits: dict) -> dict:
    out = {"unchanged": src}
    for name, pairs in edits.items():
        text = src
        for old, new, count in pairs:
            found = text.count(old)
            if found == 0 or (count is not None and found != count):
                raise ValueError(f"{name}: the edit no longer applies to the source")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(item, workdir: Path) -> Path:
    i, text = item
    cu, so = workdir / f"v{i}.cu", workdir / f"v{i}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                           "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o",
                           str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return so


def _ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _inputs(H, W, C, heads, dtype, shift, gen, B=B):
    dev = torch.device("cuda")
    x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    dy = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    hidden = 3 * C
    shapes = {"g1": (C,), "b1": (C,), "wq": (3 * C, C), "bq": (3 * C,), "bias": (heads, 64, 64),
              "wp": (C, C), "bp": (C,), "g2": (C,), "b2": (C,), "w1": (hidden, C),
              "c1": (hidden,), "w2": (C, hidden), "c2": (C,)}
    params = tuple(0.1 * torch.randn(shapes[n], generator=gen, device=dev) + (n in ("g1", "g2"))
                   for n in sb.PARAM_NAMES)
    mask = None
    if shift:
        nW = (H // 8) * (W // 8)
        mask = torch.where(torch.rand(nW, 64, 64, generator=gen, device=dev) < 0.3, -100.0, 0.0)
    return x, dy, params, mask


def time_shape(lib, new: bool, H, W, C, heads, dtype, shift, gen, iters: int) -> float:
    """ms per backward launch of ``lib`` at one shape."""
    x, dy, params, mask = _inputs(H, W, C, heads, dtype, shift, gen)
    dx = torch.empty_like(x)
    grads = tuple(torch.zeros_like(p) for p in params)
    hd = C // heads
    ptr = [x.data_ptr(), dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in params[:5]),
           mask.data_ptr() if mask is not None else None, *(t.data_ptr() for t in params[5:]),
           *(g.data_ptr() for g in grads)]
    dims = [B, H, W, C, heads, 3 * C, shift, _scale_io(hd, dtype), hd**-0.5]
    is_bf16 = int(dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    fn = lib.dmh_swin_block_bwd
    scratch_args = []  # the scratch and its bytes
    if new:
        k = sb.backward_plan(x, heads, 3 * C, mask)["kernels"]
        nbytes = sb.backward_scratch_layout(x, heads, 3 * C, mask)["bytes"]
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        scratch_args = [scratch.data_ptr(), nbytes]
        tail = [k["attention"]["windows_per_block"], k["weights"]["tokens_per_block"], is_bf16,
                stream]
    else:
        tail = [is_bf16, stream]
    fn.argtypes = ([ctypes.c_void_p] * len(ptr)
                   + [ctypes.c_void_p, ctypes.c_longlong][:len(scratch_args)]
                   + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * (len(tail) - 1) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run():
        if fn(*ptr, *scratch_args, *dims, *tail) != 0:
            raise RuntimeError("launch failed")

    run()
    torch.cuda.synchronize()
    return _ms(run, iters)


def time_forward(lib, B, H, W, C, heads, dtype, shift, gen, iters: int) -> float:
    """ms per forward launch of ``lib`` at one shape."""
    x, _, params, mask = _inputs(H, W, C, heads, dtype, shift, gen, B)
    y = torch.empty_like(x)
    hd = C // heads
    fn = lib.dmh_swin_block_fwd
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    args = [x.data_ptr(), y.data_ptr(), *(t.data_ptr() for t in params[:5]),
            mask.data_ptr() if mask is not None else None, *(t.data_ptr() for t in params[5:]),
            B, H, W, C, heads, 3 * C, shift, _scale_io(hd, dtype),
            int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream]

    def run():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")

    run()
    torch.cuda.synchronize()
    return _ms(run, iters)


def _forward_main(name: str, lib, label: str, iters: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_fwd = per_step = 0.0
    for H, W, C, heads, eval_n, step_n, dtype in FWD_LEVELS:
        for shift in (0, 4):
            for B, dt, n, tag in ((EVAL_B, torch.float32, eval_n, "eval"),
                                  (B_TRAIN, dtype, step_n, "step")):
                ms = time_forward(lib, B, H, W, C, heads, dt, shift, gen, iters)
                if tag == "eval":
                    per_fwd += ms * n / 2
                else:
                    per_step += ms * n / 2
                print(f"{label}, {name}: forward {H}x{W} C={C} h={heads} B={B} "
                      f"{str(dt)[6:]} shift={shift} ({tag}): {ms:.4f} ms", flush=True)
    print(f"{label}, {name}: {per_fwd:.2f} ms per eval forward (B={EVAL_B}, fp32, 40 launches), "
          f"{per_step:.2f} ms per training step (B={B_TRAIN}, step dtypes, 320 launches)",
          flush=True)


GENERIC_WS = 4  # the params.json window the generic sites come from


def _bind_any(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dmh_swin_block_any_fwd.argtypes = [ptr] * 5 + [ctypes.c_longlong] + [i32] * 8 + [
        f32, i32, ptr]
    lib.dmh_swin_block_any_bwd.argtypes = [ptr] * 7 + [ctypes.c_longlong] + [i32] * 8 + [
        f32, f32, i32, ptr]
    lib.dmh_swin_block_any_scratch_layout.argtypes = [i32] * 9 + [
        ctypes.POINTER(ctypes.c_longlong)]
    return lib


def _any_scratch_bytes(lib, B, H, W, C, heads, hidden, bf16: int, backward: int) -> int:
    """The scratch a revision's own layout entry point asks for (its total
    is the largest offset it writes)."""
    out = (ctypes.c_longlong * 32)()
    if lib.dmh_swin_block_any_scratch_layout(B, H, W, C, heads, hidden, GENERIC_WS, bf16,
                                             backward, out):
        raise RuntimeError("the library refuses the shape")
    return max(out)


def _generic_inputs(B, H, W, C, heads, dtype, shift, gen):
    """x, dy, the 13 parameters (an MLP of 3C) and the mask of a window-4 site."""
    dev = torch.device("cuda")
    N, hidden = GENERIC_WS * GENERIC_WS, 3 * C
    x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    dy = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    shapes = {"g1": (C,), "b1": (C,), "wq": (3 * C, C), "bq": (3 * C,), "bias": (heads, N, N),
              "wp": (C, C), "bp": (C,), "g2": (C,), "b2": (C,), "w1": (hidden, C),
              "c1": (hidden,), "w2": (C, hidden), "c2": (C,)}
    params = [0.1 * torch.randn(shapes[n], generator=gen, device=dev) + (n in ("g1", "g2"))
              for n in sb.PARAM_NAMES]
    mask = None
    if shift:
        nW = (H // GENERIC_WS) * (W // GENERIC_WS)
        mask = torch.where(torch.rand(nW, N, N, generator=gen, device=dev) < 0.3, -100.0, 0.0)
    return x, dy, params, mask


def time_generic(lib, B, H, W, C, heads, dtype, shift, backward: bool, gen, iters: int) -> float:
    """ms per generic forward or backward call of ``lib`` at one window-4 shape."""
    dev = torch.device("cuda")
    hidden = 3 * C
    x, dy, params, mask = _generic_inputs(B, H, W, C, heads, dtype, shift, gen)
    bf16 = int(dtype == torch.bfloat16)
    nbytes = _any_scratch_bytes(lib, B, H, W, C, heads, hidden, bf16, int(backward))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    pp = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in params))
    hd = C // heads
    stream = torch.cuda.current_stream().cuda_stream
    mp = mask.data_ptr() if mask is not None else None
    if backward:
        dx = torch.empty_like(x)
        grads = [torch.empty_like(t) for t in params]
        gp = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in grads))
        args = (x.data_ptr(), dy.data_ptr(), dx.data_ptr(), pp, mp, gp, scratch.data_ptr(),
                nbytes, B, H, W, C, heads, hidden, GENERIC_WS, shift, _scale_io(hd, dtype),
                hd**-0.5, bf16, stream)
        fn = lib.dmh_swin_block_any_bwd
    else:
        y = torch.empty_like(x)
        args = (x.data_ptr(), y.data_ptr(), pp, mp, scratch.data_ptr(), nbytes, B, H, W, C,
                heads, hidden, GENERIC_WS, shift, _scale_io(hd, dtype), bf16, stream)
        fn = lib.dmh_swin_block_any_fwd

    def run():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")

    run()
    torch.cuda.synchronize()
    return _ms(run, iters)


def generic_whole(sources, rounds: int, iters: int) -> None:
    """Times each revision of the generic library as it is, A B B A per
    round, at the window-4 sites; prints each shape and, per round, kernel 5
    per eval forward and per step and kernel 6 per step."""
    copies = {str(src): Path(src).read_text() for src in sources}

    def build(item, tmp):
        # a source with a window-attention header beside it is built with
        # that one (its revision's), any other with this checkout's
        i, src = item
        d = tmp / f"s{i}"
        d.mkdir()
        header = Path(src).parent / "window_attention_any.cuh"
        if header.exists():
            (d / header.name).write_text(header.read_text())
        return _build((i, copies[src]), d)

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(copies)) as pool:
        libs = list(pool.map(lambda item: build(item, Path(tmp)), enumerate(copies)))
        order = list(zip(copies, libs))
        order = [o for _ in range(rounds) for o in order + order[::-1]]
        totals = {}
        for name, so in order:
            lib = _bind_any(so)
            gen = torch.Generator(device="cuda").manual_seed(0)
            t = {"kernel 5 per eval forward": 0.0, "kernel 5 per step": 0.0,
                 "kernel 6 per step": 0.0}
            for (H, W, C, heads, eval_n, step_n, dtype), lv in zip(FWD_LEVELS, LEVELS):
                for shift in (0, GENERIC_WS // 2):
                    for key, B, dt, n, bwd in (
                            ("kernel 5 per eval forward", EVAL_B, torch.float32, eval_n, False),
                            ("kernel 5 per step", B_TRAIN, dtype, step_n, False),
                            ("kernel 6 per step", B_TRAIN, dtype, lv[4], True)):
                        ms = time_generic(lib, B, H, W, C, heads, dt, shift, bwd, gen, iters)
                        t[key] += ms * n / 2
                        print(f"{Path(name).name} ({name}): {'backward' if bwd else 'forward'} "
                              f"{H}x{W} C={C} h={heads} ws={GENERIC_WS} B={B} {str(dt)[6:]} "
                              f"shift={shift}: {ms:.4f} ms", flush=True)
                    torch.cuda.empty_cache()
            totals.setdefault(name, []).append(t)
        for name, ts in totals.items():
            for key in ts[0]:
                print(f"{name}: {key}, per round {', '.join(f'{v[key]:.3f}' for v in ts)} ms",
                      flush=True)


def generic_launches() -> None:
    """Each launch of this checkout's generic block at the window-4 sites:
    its device time per call (torch.profiler over 5 calls after one), per
    site, and summed per eval forward and per step, weighted by launches."""
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    totals = {}
    for (H, W, C, heads, eval_n, step_n, sdt), lv in zip(FWD_LEVELS, LEVELS):
        for shift in (0, GENERIC_WS // 2):
            for tag, B, dt, n, bwd in (("eval forward", EVAL_B, torch.float32, eval_n, False),
                                       ("step, kernel 5", B_TRAIN, sdt, step_n, False),
                                       ("step, kernel 6", B_TRAIN, sdt, lv[4], True)):
                x, dy, params, mask = _generic_inputs(B, H, W, C, heads, dt, shift, gen)
                kw = dict(num_heads=heads, window_size=GENERIC_WS, shift=shift)
                names = sb.GENERIC_BACKWARD if bwd else sb.GENERIC_FORWARD
                call = ((lambda: sb.swin_block_backward(x, params, mask, dy, **kw)) if bwd
                        else (lambda: sb.swin_block(x, params, mask, **kw)))
                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                events = [e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA and "_any_" in e.name]
                if len(events) != 5 * len(names):
                    raise RuntimeError(f"{len(events)} kernels in 5 calls, not 5 x {len(names)}")
                ms = dict.fromkeys(names, 0.0)
                for i, e in enumerate(events):
                    ms[names[i % len(names)]] += e.device_time / 1e3 / 5
                print(f"{tag} {H}x{W} C={C} h={heads} B={B} {str(dt)[6:]} shift={shift}: "
                      + " ".join(f"{k} {v:.4f}" for k, v in ms.items()) + " ms", flush=True)
                t = totals.setdefault(tag, dict.fromkeys(names, 0.0))
                for k, v in ms.items():
                    t[k] += v * n / 2
    for tag, t in totals.items():
        print(f"per {tag}: {sum(t.values()):.3f} ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in t.items()), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--direction", choices=("bwd", "fwd"), default="bwd")
    ap.add_argument("--source", type=Path, nargs="+", default=[sb._SOURCE],
                    help="the swin_block.cu sources to take apart (default: this checkout's)")
    ap.add_argument("--whole", action="store_true",
                    help="time each source unchanged, without the copies with parts removed")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--generic", action="store_true",
                    help="with --whole: revisions of the generic library at the window-4 sites")
    ap.add_argument("--rounds", type=int, default=2, help="--generic: rounds of A, B, B, A")
    ap.add_argument("--launches", action="store_true",
                    help="with --generic: this checkout's block split into its launches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if args.generic and args.launches:
        generic_launches()
        return
    if args.generic:
        if not args.whole:
            raise SystemExit("--generic takes --whole (whole revisions, no copies with parts "
                             "removed)")
        generic_whole([sb._SOURCE_ANY] if args.source == [sb._SOURCE] else args.source,
                      args.rounds, args.iters)
        return
    copies = []  # (source, name of the copy, text)
    for source in args.source:
        src = source.read_text()
        found = ({"unchanged": src} if args.whole else
                 forward_variants(src) if args.direction == "fwd" else variants(src))
        copies += [(source, name, text) for name, text in found.items()]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(copies)) as pool:
        libs = list(pool.map(lambda item: _build((item[0], item[1][2]), Path(tmp)),
                             enumerate(copies)))
        for (source, name, text), so in zip(copies, libs):
            if args.direction == "fwd":
                _forward_main(name, ctypes.CDLL(str(so)), source.name, args.iters)
                continue
            new = "swin_block_bwd_kernel<" not in text
            lib = ctypes.CDLL(str(so))
            gen = torch.Generator(device="cuda").manual_seed(0)
            step = 0.0
            for H, W, C, heads, launches, dtype in LEVELS:
                for shift in (0, 4):
                    ms = time_shape(lib, new, H, W, C, heads, dtype, shift, gen, args.iters)
                    step += ms * launches / 2
                    print(f"{source.name} {'five kernels' if new else 'per-window kernel'}, "
                          f"{name}: {H}x{W} C={C} h={heads} B={B} {str(dtype)[6:]} "
                          f"shift={shift}: {ms:.4f} ms", flush=True)
            print(f"{source.name}, {name}: {step:.2f} ms per training step (launch-weighted)",
                  flush=True)


if __name__ == "__main__":
    main()
