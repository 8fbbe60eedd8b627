"""Where the window-attention kernels spend their time, on the card.

  python -m dmhomo_torch.ops.window_attention_breakdown [--source PATH ...] [--whole]
                                                        [--iters 20]

Builds copies of a ``window_attention.cu`` source (this checkout's by
default, or earlier revisions' given by ``--source``, all built at once)
with one part removed, each removal a textual edit checked to apply, then
times each copy with CUDA events at the window-attention shapes of the
shipped HEM estimator: the forward at the eval forward's (B=32, fp32; 40
launches a forward) and at the training step's (B=8, bf16; 160 launches a
step), the backward at the step's (B=8, bf16; 160 launches), each shape
with and without the SW-MSA mask (half the launches each).  The parts: the
exp (the clipped logit kept in its place), the products (each q.k, e.v and
gradient product cut to nothing), the loads (every window reads the
first window's q, k, v and gout, which stay in cache) and dbias (neither
summed nor stored, the slabs not added).  A copy's outputs are
meaningless; the difference of its time to the unchanged source's is the
cost of the removed part, where the parts overlap less than fully.  The
warp-tiled source has one more copy, which removes nothing: its backward
takes the exp by ``ex2.approx`` as its bf16 forward does, where it ships
with ``expf``.  ``--whole`` times each source unchanged only.  Two designs
are known by their source: the first port's (a thread per query row, then
per key row, dbias by atomics) and the warp-tiled one (four warps of 16
query rows, logits once, dbias partials summed in a second launch).
Prints one line per copy, direction and shape, the launch-weighted ms per
eval forward and per training step of each copy, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from dmhomo_torch.models.swin import shifted_window_mask
from dmhomo_torch.ops import window_attention as wa
from dmhomo_torch.ops.build import nvcc

EVAL_B, STEP_B = 32, 8
# (H, W, C, heads, launches per eval forward (half of them masked)): the Swin
# levels of the shipped estimator, h_net twice per forward; a training step
# runs four microbatches of 8, so four times as many
LEVELS = [(160, 288, 24, 3, 4), (80, 144, 48, 12, 8), (40, 72, 96, 24, 12),
          (80, 144, 48, 3, 4), (40, 72, 96, 3, 4), (40, 72, 96, 12, 8)]
STEPS_PER_BATCH = 4

_FAKE_ADD = ("namespace {\n\n// keeps the sum it is given live, adds nothing\n"
             "__device__ __forceinline__ void fake_add(float* p, float v) {\n"
             "  if (v == 1.2345e-37f) *p = v;\n}\n")


def variants(src: str) -> dict:
    """Copies of the source with one part removed: name -> source."""
    if "atomicAdd(dbias" in src:  # the first port's kernels
        edits = {
            "without the exp": [("expf(fminf(fmaxf(sim, -CLIP), CLIP))",
                                 "(fminf(fmaxf(sim, -CLIP), CLIP))", None)],
            "without the products": [("  for (int d = 0; d < HD / 4; ++d) {\n",
                                      "  for (int d = 0; d < (HD < 0 ? 1 : 0); ++d) {\n", 2)],
            "without the loads": [
                ("const T* src = qkv + row * C3 + g * HD;",
                 "const T* src = qkv + static_cast<size_t>(i) * C3 + g * HD;", 2),
                ("const T* gsrc = gout + row * C + g * HD;",
                 "const T* gsrc = gout + static_cast<size_t>(i) * C + g * HD;", 1)],
            "without dbias": [("namespace {\n", _FAKE_ADD, 1),
                              ("atomicAdd(acc_s + r * LD + i, dsim);",
                               "fake_add(acc_s + r * LD + i, dsim);", 1),
                              ("atomicAdd(dbias + ", "fake_add(dbias + ", 1)],
        }
    elif "window_attention_dbias_kernel" in src:  # the warp-tiled kernels
        run = "  static __device__ __forceinline__ void run(float (&acc)[NT][4], FA a, FB b) {\n"
        edits = {
            "without the exp": [("  const float x = fminf(fmaxf(v, -CLIP), CLIP);\n",
                                 "  return fminf(fmaxf(v, -CLIP), CLIP);\n"
                                 "  const float x = 0.0f;\n", 1)],
            "without the products": [
                (run, run + "    return;\n", 2),  # WarpMma, both dtypes
                ("uint32_t b1) {\n  asm volatile(", "uint32_t b1) {\n  return;\n  asm volatile(", 1),
                ("uint32_t b0) {\n  asm volatile(", "uint32_t b0) {\n  return;\n  asm volatile(", 1),
                ("for (int d = 0; d < HD / 4; ++d) {", "for (int d = 0; d < (HD < 0 ? 1 : 0); ++d) {",
                 2),  # the fp32 row kernel's q.k and e.v
                ("for (int d = 0; d < HD; d += 4) {\n            const float4 kk = ld4(kr + d);",
                 "for (int d = 0; d < (HD < 0 ? 4 : 0); d += 4) {\n"
                 "            const float4 kk = ld4(kr + d);", 1),  # the fp32 warp tiles' q.k
                ("for (int d = 0; d < HD; d += 4) {\n            const float4 vv = ld4(vr + d);",
                 "for (int d = 0; d < (HD < 0 ? 4 : 0); d += 4) {\n"
                 "            const float4 vv = ld4(vr + d);", 1)],  # and e.v
            "without the loads": [
                ("return qkv + ((static_cast<size_t>(k) * n_mask",
                 "return qkv + ((static_cast<size_t>(k0) * n_mask", 1),
                ("const T* src = qkv + (static_cast<size_t>(k) * n_mask",
                 "const T* src = qkv + (static_cast<size_t>(k0) * n_mask", 1),
                ("fetch(raw, qkv + static_cast<size_t>(win) * N * LQ",
                 "fetch(raw, qkv + static_cast<size_t>(w_begin) * N * LQ", 1),
                ("gout + static_cast<size_t>(win) * N * C + h * HD, C, tid);",
                 "gout + static_cast<size_t>(w_begin) * N * C + h * HD, C, tid);", 1)],
            "without dbias": [
                ("  float* part = dbias + ", "  return;\n  float* part = dbias + ", 1),
                ("if (err != cudaSuccess || p.partials == 1) return err;",
                 "if (err != cudaSuccess || p.partials >= 1) return err;", 1)],
            # not a part removed: the backward's exp as the bf16 forward takes it
            "backward exp by ex2.approx": [
                ("clipped_exp<float>(x0), e1 = clipped_exp<float>(x1);  // expf",
                 "clipped_exp<T>(x0), e1 = clipped_exp<T>(x1);", 1)],
        }
    else:
        raise ValueError("not a window-attention source this tool knows")
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


def _build(i: int, text: str, workdir: Path) -> Path:
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


def _bind(lib) -> None:
    fn = lib.dmh_window_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.dmh_window_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _partials(lib, Bn, C, heads, nW, is_bf16) -> int:
    """dbias slabs a backward launch of ``lib`` writes (1: the first port's
    kernel adds into one)."""
    try:
        fn = lib.dmh_window_attention_plan
    except AttributeError:
        return 1
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 8)()
    if fn(Bn, C, heads, nW, is_bf16, 1, out) != 0:
        raise RuntimeError("plan refused")
    return out[7]


def time_shape(lib, backward: bool, B, H, W, C, heads, dtype, masked, gen, iters) -> float:
    """ms per launch of ``lib``'s forward or backward at one shape."""
    dev = torch.device("cuda")
    nW = (H // 8) * (W // 8)
    Bn = B * nW
    hd = C // heads
    qkv = torch.randn(Bn, 64, 3 * C, generator=gen, device=dev).to(dtype)
    bias = 0.5 * torch.randn(heads, 64, 64, generator=gen, device=dev)
    mask = torch.from_numpy(shifted_window_mask(H, W, 8, 4)).to(dev) if masked else None
    is_bf16 = int(dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    mptr = mask.data_ptr() if masked else None
    if backward:
        gout = torch.randn(Bn, 64, C, generator=gen, device=dev).to(dtype)
        dqkv = torch.empty_like(qkv)
        dbias = torch.zeros(_partials(lib, Bn, C, heads, nW if masked else 0, is_bf16), heads,
                            64, 64, device=dev)
        args = (qkv.data_ptr(), bias.data_ptr(), mptr, gout.data_ptr(), dqkv.data_ptr(),
                dbias.data_ptr(), Bn, C, heads, nW if masked else 0,
                wa._scale_io(hd, dtype), hd**-0.5, is_bf16, stream)
        fn = lib.dmh_window_attention_bwd
    else:
        out = torch.empty(Bn, 64, C, dtype=dtype, device=dev)
        args = (qkv.data_ptr(), bias.data_ptr(), mptr, out.data_ptr(), Bn, C, heads,
                nW if masked else 0, wa._scale_io(hd, dtype), is_bf16, stream)
        fn = lib.dmh_window_attention_fwd

    def run():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")

    run()
    torch.cuda.synchronize()
    return _ms(run, iters)


# (direction, batch, dtype, launches per level's eval count, unit)
RUNS = (("forward", EVAL_B, torch.float32, 1, "per eval forward (B=32, fp32, 40 launches)"),
        ("forward", STEP_B, torch.bfloat16, STEPS_PER_BATCH,
         "per training step (B=8, bf16, 160 launches)"),
        ("backward", STEP_B, torch.bfloat16, STEPS_PER_BATCH,
         "per training step (B=8, bf16, 160 launches)"))


def time_library(lib, label: str, iters: int) -> dict:
    """Launch-weighted ms of each run in ``RUNS``: (direction, batch) -> ms."""
    _bind(lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for direction, B, dtype, per, unit in RUNS:
        total = 0.0
        for H, W, C, heads, n in LEVELS:
            for masked in (False, True):
                ms = time_shape(lib, direction == "backward", B, H, W, C, heads, dtype, masked,
                                gen, iters)
                total += ms * per * n / 2
                print(f"{label}: {direction} {H}x{W} C={C} h={heads} hd={C // heads} B={B} "
                      f"{str(dtype)[6:]} mask={int(masked)}: {ms:.4f} ms", flush=True)
        totals[(direction, B)] = total
        print(f"{label}: {direction} {total:.3f} ms {unit}", flush=True)
    return totals


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, nargs="+", default=[wa._SOURCE],
                    help="the window_attention.cu sources to take apart (default: this checkout's)")
    ap.add_argument("--whole", action="store_true",
                    help="time each source unchanged, without the copies with parts removed")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    copies = []  # (source, name of the copy, text)
    for source in args.source:
        src = source.read_text()
        found = {"unchanged": src} if args.whole else variants(src)
        copies += [(source, name, text) for name, text in found.items()]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(copies)) as pool:
        libs = list(pool.map(lambda item: _build(item[0], item[1][2], Path(tmp)),
                             enumerate(copies)))
        summary = []
        for (source, name, _), so in zip(copies, libs):
            label = f"{source.parent.name}/{source.name}, {name}"
            totals = time_library(ctypes.CDLL(str(so)), label, args.iters)
            summary.append((label, totals))
    print(smi, flush=True)
    for label, t in summary:
        print(f"{label}: forward {t[('forward', EVAL_B)]:.3f} ms per eval forward, "
              f"{t[('forward', STEP_B)]:.3f} per step; backward {t[('backward', STEP_B)]:.3f} "
              "per step", flush=True)


if __name__ == "__main__":
    main()
