"""Where the whole-block Swin backward spends its time, on the card.

  python -m dmhomo_torch.ops.swin_block_breakdown [--source PATH] [--iters 10]

Builds copies of a ``swin_block.cu`` source (this checkout's by default, or
an earlier revision's given by ``--source``) with one part of the backward
removed, each removal a textual edit checked to apply, then times each copy
with CUDA events at the six Swin-block shapes of a shipped training
microbatch (B=8), each at the dtype the bf16 training step gives it, with
and without the shift and its mask.  A copy's outputs are meaningless; the
difference of its time to the unchanged source's is the cost of the removed
part, where the parts overlap less than fully.

Two designs are known by their source: the five-kernel backward (the copies
skip one launch each, or drop the recompute kernel's attention, MLP or
scratch stores) and the single per-window kernel it replaced, with
global atomics for every gradient (the copies drop the atomics, keeping the
sums they add; the attention's backward; the weight-gradient products).
Prints one line per copy and shape, the launch-weighted ms per training
step of each copy, and the card's name and power limit.
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
from dmhomo_torch.ops.build import nvcc
from dmhomo_torch.ops.window_attention import _scale_io

B = 8  # a training microbatch
# (H, W, C, heads, backward launches per step (half of them shifted), step dtype)
LEVELS = [(160, 288, 24, 3, 16, torch.bfloat16), (80, 144, 48, 12, 32, torch.bfloat16),
          (40, 72, 96, 24, 48, torch.bfloat16), (80, 144, 48, 3, 16, torch.float32),
          (40, 72, 96, 3, 16, torch.float32), (40, 72, 96, 12, 32, torch.float32)]

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
                ("  attention_fwd<T, C, HD>(qs, as, p, w, scale_io, ws, tid);\n", "", 1)],
            "the recompute kernel without its MLP": [
                ("  Proj<T, C> dn2(tid);\n  for (int blk = 0; blk < mlp_blocks; ++blk) {",
                 "  Proj<T, C> dn2(tid);\n  for (int blk = 0; blk < mlp_blocks * 0; ++blk) {", 1)],
            "the recompute kernel without its scratch stores": [
                ("    IO<S>::store4(dst + static_cast<size_t>(t) * ldd + c, src + t * lds + c);",
                 "    if (ldd < 0) IO<S>::store4(dst + static_cast<size_t>(t) * ldd + c, "
                 "src + t * lds + c);", 1)],
        })
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
                           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)],
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


def _inputs(H, W, C, heads, dtype, shift, gen):
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, default=sb._SOURCE,
                    help="the swin_block.cu to take apart (default: this checkout's)")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    src = args.source.read_text()
    new = "swin_block_bwd_kernel<" not in src
    copies = variants(src)
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(copies)) as pool:
        libs = list(pool.map(lambda item: _build(item, Path(tmp)), enumerate(copies.values())))
        for name, so in zip(copies, libs):
            lib = ctypes.CDLL(str(so))
            gen = torch.Generator(device="cuda").manual_seed(0)
            step = 0.0
            for H, W, C, heads, launches, dtype in LEVELS:
                for shift in (0, 4):
                    ms = time_shape(lib, new, H, W, C, heads, dtype, shift, gen, args.iters)
                    step += ms * launches / 2
                    print(f"{args.source.name} {'five kernels' if new else 'per-window kernel'}, "
                          f"{name}: {H}x{W} C={C} h={heads} B={B} {str(dtype)[6:]} "
                          f"shift={shift}: {ms:.4f} ms", flush=True)
            print(f"{args.source.name}, {name}: {step:.2f} ms per training step (launch-weighted)",
                  flush=True)


if __name__ == "__main__":
    main()
