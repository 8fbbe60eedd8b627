"""Where the window-attention kernels spend their time, on the card.

  python -m dmhomo_torch.ops.window_attention_breakdown [--source PATH ...] [--whole]
                                                        [--iters 20]
  python -m dmhomo_torch.ops.window_attention_breakdown --generic [--whole]
                                                        [--source PATH ...] [--rounds 2]

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

``--generic`` does the same for the generic variant
(``csrc/window_attention_any.cu`` and the ``window_attention_any.cuh``
beside it; ``--source`` names entry files, each built with the header in
its own directory) at the window-4 sites: the six levels above with 4x4
windows (N = 16), the eval forward at B=32 in fp32 (40 launches) and the
training step at B=8 with each level at its step dtype (bf16 for the first
three, fp32 for the rest), forward (160 launches) and backward (160), half
of each with a random 0 / -100 mask.  Its copies remove the loads (every
stage copies its chunk's first windows again, which stay in cache), the
exp (the clipped logit kept in its place), the products (every mma.sync
and every FMA loop of a product) or dbias (no slab summed or written, no
reduction launch).  A source of an earlier design is timed whole.
Sources and copies run in turns, A B B A per round.
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


GENERIC_WS = 4  # the params.json window the generic sites come from
GENERIC_STEP_DTYPES = (torch.bfloat16,) * 3 + (torch.float32,) * 3  # LEVELS' step dtypes


def generic_variants(cu: str, cuh: str) -> dict:
    """Copies of a generic (entry file, header) pair with one part removed:
    name -> (entry text, header text)."""
    if "backward_pair" not in cuh:
        raise ValueError("not a generic window-attention header this tool takes apart")
    edits = {
        "without the loads": [("static_cast<long long>(window_of(w0 + wl)) * N + n;",
                               "static_cast<long long>(window_of(begin + wl)) * N + n;", 1)],
        "without the exp": [("  const float x = fminf(fmaxf(v, -CLIP), CLIP);\n",
                             "  return fminf(fmaxf(v, -CLIP), CLIP);\n  const float x = 0.0f;\n",
                             1)],
        "without the products": [
            ("uint32_t b1) {\n  asm volatile(", "uint32_t b1) {\n  return;\n  asm volatile(", 1),
            ("uint32_t b0) {\n  asm volatile(", "uint32_t b0) {\n  return;\n  asm volatile(", 1),
            ("for (int d = 0; d < HDP; d += 4) {\n      float4 qa[2];",
             "for (int d = 0; d < (HDP < 0 ? 4 : 0); d += 4) {\n      float4 qa[2];", 1),
            ("for (int d = 0; d < HDP; d += 4) {\n        const float4 bb",
             "for (int d = 0; d < (HDP < 0 ? 4 : 0); d += 4) {\n        const float4 bb", 1),
            ("for (int k = 16 * kq; k < 16 * kq + 16; k += 2) {",
             "for (int k = 16 * kq; k < 16 * kq + (HDP < 0 ? 16 : 0); k += 2) {", 1)],
        "without dbias": [
            ("            db[j][2 * hr] += d0;\n            db[j][2 * hr + 1] += d1;\n", "", 1),
            ("} else if (row < N && key < N) {", "} else if (row < N && key < N && N < 0) {", 1),
            ("if (BWD && chunks == 1 && active) {", "if (BWD && chunks == 1 && active && N < 0) {",
             1)],
    }
    out = {"unchanged": (cu, cuh)}
    for name, pairs in edits.items():
        text = cuh
        for old, new, count in pairs:
            if text.count(old) != count:
                raise ValueError(f"{name}: the edit no longer applies to the header")
            text = text.replace(old, new)
        entry = cu
        if name == "without dbias":
            old = "if (p.partials == 1) return 0;"
            if entry.count(old) != 1:
                raise ValueError(f"{name}: the edit no longer applies to the entry file")
            entry = entry.replace(old, "if (p.partials >= 1) return 0;")
        out[name] = (entry, text)
    return out


def _build_generic(i: int, texts, workdir: Path) -> Path:
    """Builds an entry file and its header in a directory of their own."""
    d = workdir / f"g{i}"
    d.mkdir()
    (d / "window_attention_any.cuh").write_text(texts[1])
    return _build(i, texts[0], d)


def _bind_any(lib) -> None:
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


def _any_partials(lib, Bn, N, C, heads) -> int:
    """dbias slabs a generic backward of ``lib`` writes at most: the slab
    count sits at index 7 of each plan its entry point fills (one plan before
    the redesign, one per dtype after it)."""
    out = (ctypes.c_int * 64)()
    if lib.dmh_window_attention_any_plan(Bn, N, C, heads, 1, out) != 0:
        raise RuntimeError("plan refused")
    return max(out[7], out[22])


def generic_inputs(B, H, W, C, heads, dtype, masked, gen):
    """qkv, bias, mask (a random 0 / -100 one, or None), gout at a window-4 site."""
    dev = torch.device("cuda")
    N = GENERIC_WS * GENERIC_WS
    Bn = B * (H // GENERIC_WS) * (W // GENERIC_WS)
    qkv = torch.randn(Bn, N, 3 * C, generator=gen, device=dev).to(dtype)
    bias = 0.5 * torch.randn(heads, N, N, generator=gen, device=dev)
    gout = torch.randn(Bn, N, C, generator=gen, device=dev).to(dtype)
    mask = None
    if masked:
        nW = (H // GENERIC_WS) * (W // GENERIC_WS)
        mask = torch.where(torch.rand(nW, N, N, generator=gen, device=dev) < 0.3, -100.0, 0.0)
    return qkv, bias, mask, gout


def time_generic(lib, backward, B, H, W, C, heads, dtype, masked, gen, iters) -> float:
    """ms per generic launch of ``lib`` at one window-4 site."""
    qkv, bias, mask, gout = generic_inputs(B, H, W, C, heads, dtype, masked, gen)
    Bn, N = qkv.shape[:2]
    hd = C // heads
    nW = mask.shape[0] if masked else 0
    is_bf16 = int(dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    mptr = mask.data_ptr() if masked else None
    if backward:
        dqkv = torch.empty_like(qkv)
        dbias = torch.empty(_any_partials(lib, Bn, N, C, heads), heads, N, N, device=qkv.device)
        args = (qkv.data_ptr(), bias.data_ptr(), mptr, gout.data_ptr(), dqkv.data_ptr(),
                dbias.data_ptr(), Bn, N, C, heads, nW, wa._scale_io(hd, dtype), hd**-0.5,
                is_bf16, stream)
        fn = lib.dmh_window_attention_any_bwd
    else:
        out = torch.empty(Bn, N, C, dtype=dtype, device=qkv.device)
        args = (qkv.data_ptr(), bias.data_ptr(), mptr, out.data_ptr(), Bn, N, C, heads, nW,
                wa._scale_io(hd, dtype), is_bf16, stream)
        fn = lib.dmh_window_attention_any_fwd

    def run():
        if fn(*args) != 0:
            raise RuntimeError("launch failed")

    run()
    torch.cuda.synchronize()
    return _ms(run, iters)


GENERIC_RUNS = (("kernel 1 per eval forward", False, EVAL_B, 1),
                ("kernel 1 per step", False, STEP_B, STEPS_PER_BATCH),
                ("kernel 2 per step", True, STEP_B, STEPS_PER_BATCH))


def generic_time_library(lib, label: str, iters: int) -> dict:
    """Launch-weighted ms of each of ``GENERIC_RUNS``: key -> ms."""
    _bind_any(lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for key, backward, B, per in GENERIC_RUNS:
        total = 0.0
        for (H, W, C, heads, n), sdt in zip(LEVELS, GENERIC_STEP_DTYPES):
            dtype = torch.float32 if B == EVAL_B else sdt
            for masked in (False, True):
                ms = time_generic(lib, backward, B, H, W, C, heads, dtype, masked, gen, iters)
                total += ms * per * n / 2
                print(f"{label}: {'backward' if backward else 'forward'} {H}x{W} C={C} "
                      f"h={heads} hd={C // heads} ws={GENERIC_WS} B={B} {str(dtype)[6:]} "
                      f"mask={int(masked)}: {ms:.4f} ms", flush=True)
            torch.cuda.empty_cache()
        totals[key] = total
    return totals


def generic_main(sources, whole: bool, rounds: int, iters: int) -> None:
    copies = []  # (label, (entry text, header text))
    for source in sources:
        cu = source.read_text()
        cuh = (source.parent / "window_attention_any.cuh").read_text()
        # an earlier design (no copies known for it) is timed whole
        known = "backward_pair" in cuh
        found = {"unchanged": (cu, cuh)} if whole or not known else generic_variants(cu, cuh)
        copies += [(f"{source.parent.name}/{source.name}, {name}", texts)
                   for name, texts in found.items()]
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(copies)) as pool:
        libs = list(pool.map(lambda item: _build_generic(item[0], item[1][1], Path(tmp)),
                             enumerate(copies)))
        order = [(label, so) for (label, _), so in zip(copies, libs)]
        order = [o for _ in range(rounds) for o in order + order[::-1]]
        totals = {}
        for label, so in order:
            t = generic_time_library(ctypes.CDLL(str(so)), label, iters)
            totals.setdefault(label, []).append(t)
            print(f"{label}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()), flush=True)
    for label, ts in totals.items():
        for key, *_ in GENERIC_RUNS:
            print(f"{label}: {key}, per turn {', '.join(f'{t[key]:.3f}' for t in ts)} ms",
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path, nargs="+", default=[wa._SOURCE],
                    help="the window_attention.cu sources to take apart (default: this checkout's)")
    ap.add_argument("--whole", action="store_true",
                    help="time each source unchanged, without the copies with parts removed")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--generic", action="store_true",
                    help="the generic variant (window_attention_any.cu) at the window-4 sites")
    ap.add_argument("--rounds", type=int, default=1, help="--generic: rounds of A, B, B, A")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if args.generic:
        generic_main([wa._SOURCE_ANY] if args.source == [wa._SOURCE] else args.source,
                     args.whole, args.rounds, args.iters)
        print(smi, flush=True)
        return
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
