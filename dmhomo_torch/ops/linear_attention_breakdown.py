"""Where the bf16 linear-attention kernels spend their time, on the card.

  python -m dmhomo_torch.ops.linear_attention_breakdown [--sites 65536:64,16384:128]
      [--source PATH ...] [--whole] [--batch 50] [--rounds 2]

Builds copies of ``dmhomo_torch/csrc/linear_attention.cu`` with one part of
a kernel removed (each removal is a textual edit of the source, checked to
apply), then times pass 1 and pass 2 of every copy with CUDA events at the
given (N, C) sites: B = 50, channel-major bf16 x, prenorm, the launch plan
the UNet's call takes.  A copy's outputs are meaningless; the difference of
its time to the unchanged source's is the cost of the removed part, where
the parts overlap less than fully.  Prints one line per copy and site, and
the card's name and power limit.

``--whole`` times each source (``--source``, default this checkout's) as it
is, in turns over ``--rounds`` rounds (A, B, B, A, ...), to compare
revisions in one call: a source whose pass 1 adds into zeroed sums with
atomics (an earlier revision, without per-block partials) is bound by its
own arguments.  ``--batch`` sets B (50: generation; 32: a DGM microbatch).

``--generic --whole --heads H --dim-head D [--source A.cu B.cu ...]`` does
the same for revisions of the generic library
(``dmhomo_torch/csrc/linear_attention_any.cu``, the default source) at the
UNet's eight sites, as the UNet calls it (channel-major x, prenorm, pass 1
computing the statistics): B = 50 bf16 at 256x256 (conditional generation)
and B = 16 fp32 at 128x128 (the unconditional twin).  Each revision's
scratch is the size its own plan entry point reports.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from dmhomo_torch.ops import linear_attention as la
from dmhomo_torch.ops.build import nvcc

B = 50  # the generation batch (CFG-doubled 25); --batch changes it
_PROJECTION = "for (int kk = 0; kk < kv; kk += 16) {"
_NO_LOOP = "for (int kk = 0; kk < kv * 0; kk += 16) {"


def _nth_replaced(src: str, old: str, new: str, n: int) -> str:
    i = -1
    for _ in range(n + 1):
        i = src.index(old, i + 1)
    return src[:i] + new + src[i + len(old):]


def variants(src: str) -> dict:
    """Copies of the source with one part removed: name -> source."""
    edits = {
        "pass 1 without its LayerNorm statistics": [
            ("    if (PRENORM && STATS) chunk_stats(", "    if (PRENORM && STATS && ch < 0) chunk_stats(")],
        "pass 1 without its exp": [
            ("a0 = clipped_exp_fast(lo(k));\n              a1 = clipped_exp_fast(hi(k));",
             "a0 = lo(k);\n              a1 = hi(k);")],
        "pass 1 without its epilogue and E product": [
            ("mma(e_acc[mi][ni], af, pk[i][0][hq], pk[i][1][hq]);", ""),
            ("for (int j = 0; j < 2; ++j) s_acc[mi][qr] += lo(pk[mi][j][qr]) + hi(pk[mi][j][qr]);", "")],
        "pass 2 without its exp": [
            ("pq[j][qr] = pack(clipped_exp_fast(lo(q)), clipped_exp_fast(hi(q)));", "pq[j][qr] = q;")],
        "pass 2 without its output stores": [
            ("    if (aligned_out) {", "    if (N > 0) continue;\n    if (aligned_out) {")],
    }
    out = {"unchanged": src,
           "pass 1 without its projection": _nth_replaced(src, _PROJECTION, _NO_LOOP, 0),
           "pass 2 without its projection": _nth_replaced(src, _PROJECTION, _NO_LOOP, 1)}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if text.count(old) != 1:
                raise ValueError(f"{name}: the edit no longer applies to the source")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(item, workdir: Path):
    i, text = item
    cu, so = workdir / f"v{i}.cu", workdir / f"v{i}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    return so


def _partials(lib) -> bool:
    """Whether the library's pass 1 writes per-block partials (else it adds
    into zeroed sums with atomics)."""
    return hasattr(lib, "dmh_linear_attention_pass1_partials")


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dmh_linear_attention_pass1_bf16.argtypes = (
        [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i32, ptr]
        + ([ptr, i64] if _partials(lib) else []) + [i32] * 9 + [ptr])
    lib.dmh_linear_attention_pass2_bf16.argtypes = (
        [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, i64] + [i32] * 9 + [ptr])
    return lib


def _ms(fn, iters: int = 20) -> float:
    """ms per call of ``fn`` by CUDA events over ``iters`` calls after 3."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_site(lib, N: int, C: int, gen: torch.Generator):
    """(pass 1 ms, pass 2 ms) of ``lib`` at one site (pass 1 with its
    reduction launch, or with the zeroing of the sums an atomic pass 1
    needs)."""
    dev = torch.device("cuda")
    x = (1.5 * torch.randn(B, C, N, generator=gen, device=dev) + 0.3).to(torch.bfloat16)
    x = x.transpose(1, 2)
    w = torch.randn(C, 3 * la.HIDDEN, generator=gen, device=dev) / C**0.5
    g = 0.5 + torch.rand(C, generator=gen, device=dev)
    mean, rstd = (torch.empty(B, N, device=dev) for _ in range(2))
    sums = torch.zeros(B, la.SUMS, device=dev)
    partials = torch.empty(la.pass1_partials(x, g, True), device=dev)
    out = torch.empty(B, la.HIDDEN, N, dtype=torch.bfloat16, device=dev).transpose(1, 2)
    stream = torch.cuda.current_stream().cuda_stream
    padded, heads, chunk, stages, streamed = la._plan_args(la.launch_plan(x, 1))
    p2 = la._plan_args(la.launch_plan(x, 2, (mean, rstd), out))
    common = (x.data_ptr(), *x.stride(), w.data_ptr(), g.data_ptr(), mean.data_ptr(),
              rstd.data_ptr())

    scratch = (partials.data_ptr(), partials.numel()) if _partials(lib) else ()

    def pass1():
        if not scratch:
            sums.zero_()
        return lib.dmh_linear_attention_pass1_bf16(
            *common, 1, sums.data_ptr(), *scratch, B, N, C, padded, heads, chunk, stages,
            streamed, 1, stream)

    def pass2():
        return lib.dmh_linear_attention_pass2_bf16(
            *common, sums.data_ptr(), out.data_ptr(), *out.stride(), B, N, C, p2[0], p2[2], p2[3],
            p2[4], 1, 1, stream)

    for fn in (pass1, pass2):
        if fn() != 0:
            raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    return _ms(pass1), _ms(pass2)


def _bind_any(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dmh_linear_attention_any_pass1.argtypes = [ptr, i64, i64, i64, ptr, ptr, ptr, ptr, i32,
                                                   ptr, ptr, i64] + [i32] * 6 + [ptr]
    lib.dmh_linear_attention_any_pass2.argtypes = ([ptr, i64, i64, i64, ptr, ptr, ptr, ptr, ptr,
                                                    ptr, i64, i64, i64] + [i32] * 5
                                                   + [ctypes.c_float, i32, ptr])
    lib.dmh_linear_attention_any_plan.argtypes = [i32] * 6 + [ctypes.POINTER(i32)]
    return lib


# the generic comparison's configurations: (B, dtype, image size)
GENERIC_PATHS = ((50, torch.bfloat16, 256), (16, torch.float32, 128))


def unet_sites(size: int):
    """(N, C) of the UNet's eight linear attentions (dim 64, mults (1, 2, 4,
    8)) at a ``size`` x ``size`` input, down path then up path."""
    dims = [64, 64, 128, 256, 512]
    return ([((size >> i) ** 2, dims[i]) for i in range(4)]
            + [((size >> (3 - i)) ** 2, dims[4 - i]) for i in range(4)])


def time_site_any(lib, B: int, N: int, C: int, heads: int, dim_head: int, dtype,
                  gen: torch.Generator):
    """(pass 1 ms, pass 2 ms) of a generic library at one site: pass 1 with
    its preparing and reduction launches, computing the statistics; pass 2
    reading them."""
    dev = torch.device("cuda")
    hd = heads * dim_head
    x = (1.5 * torch.randn(B, C, N, generator=gen, device=dev) + 0.3).to(dtype).transpose(1, 2)
    w = torch.randn(C, 3 * hd, generator=gen, device=dev) / C**0.5
    g = 0.5 + torch.rand(C, generator=gen, device=dev)
    mean, rstd = (torch.empty(B, N, device=dev) for _ in range(2))
    sums = torch.empty(B, la.sums_width(heads, dim_head), device=dev)
    plan = (ctypes.c_int * 32)()
    if lib.dmh_linear_attention_any_plan(1, B, N, C, heads, dim_head, plan) != 0:
        raise RuntimeError("plan refused")
    partials = torch.empty(plan[7], device=dev)  # the scratch floats, in every revision
    out = torch.empty(B, hd, N, dtype=dtype, device=dev).transpose(1, 2)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(dtype == torch.bfloat16)
    common = (x.data_ptr(), *x.stride(), w.data_ptr(), g.data_ptr(), mean.data_ptr(),
              rstd.data_ptr())

    def pass1():
        return lib.dmh_linear_attention_any_pass1(
            *common, 1, sums.data_ptr(), partials.data_ptr(), partials.numel(), B, N, C, heads,
            dim_head, bf16, stream)

    def pass2():
        return lib.dmh_linear_attention_any_pass2(
            *common, sums.data_ptr(), out.data_ptr(), *out.stride(), B, N, C, heads, dim_head,
            float(dim_head**-0.5), bf16, stream)

    for fn in (pass1, pass2):
        if fn() != 0:
            raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    return _ms(pass1), _ms(pass2)


def generic_whole(sources, heads: int, dim_head: int, rounds: int) -> None:
    """Times each revision of the generic library as it is, A B B A per
    round, at the UNet's sites of each of GENERIC_PATHS; prints each site
    and, per round, each pass summed over the sites (one UNet forward)."""
    copies = {src: Path(src).read_text() for src in sources}
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(copies)) as pool:
        libs = list(pool.map(lambda item: _build(item, Path(tmp)), enumerate(copies.values())))
        order = list(zip(copies, libs))
        order = [o for _ in range(rounds) for o in order + order[::-1]]
        totals = {}
        for name, so in order:
            lib = _bind_any(so)
            for B, dtype, size in GENERIC_PATHS:
                t = [0.0, 0.0]
                for N, C in unet_sites(size):
                    gen = torch.Generator(device="cuda").manual_seed(N + C)
                    t1, t2 = time_site_any(lib, B, N, C, heads, dim_head, dtype, gen)
                    t[0] += t1
                    t[1] += t2
                    print(f"N={N} C={C} B={B} {str(dtype)[6:]} ({heads}, {dim_head}) prenorm, "
                          f"{name}: pass 1 {t1:.4f} ms, pass 2 {t2:.4f} ms", flush=True)
                    torch.cuda.empty_cache()
                totals.setdefault((name, B), []).append(t)
        for (name, B), ts in totals.items():
            for p in (0, 1):
                print(f"{name} B={B}: pass {p + 1} per UNet forward, per round "
                      f"{', '.join(f'{v[p]:.4f}' for v in ts)} ms", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sites", default="65536:64,16384:128,4096:256",
                    help="comma-separated N:C")
    ap.add_argument("--source", nargs="+", default=None,
                    help="linear_attention.cu revisions (default: this checkout's)")
    ap.add_argument("--whole", action="store_true",
                    help="time each source as it is (no copies), in turns")
    ap.add_argument("--batch", type=int, default=B)
    ap.add_argument("--rounds", type=int, default=2, help="--whole: rounds of A, B, B, A")
    ap.add_argument("--generic", action="store_true",
                    help="with --whole: revisions of the generic library at the UNet's sites")
    ap.add_argument("--heads", type=int, default=8, help="--generic: attention heads")
    ap.add_argument("--dim-head", type=int, default=64, help="--generic: dim_head")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    globals()["B"] = args.batch
    sites = [tuple(int(v) for v in s.split(":")) for s in args.sites.split(",")]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    if args.generic:
        if not args.whole:
            raise SystemExit("--generic takes --whole (whole revisions, no copies with parts removed)")
        generic_whole(args.source or [str(la._SOURCE_ANY)], args.heads, args.dim_head,
                      args.rounds)
        return
    sources = args.source or [str(la._SOURCE)]
    if args.whole:
        copies = {src: Path(src).read_text() for src in sources}
    else:
        copies = variants(Path(sources[0]).read_text())
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(copies)) as pool:
        libs = list(pool.map(lambda item: _build(item, Path(tmp)), enumerate(copies.values())))
        order = list(zip(copies, libs))
        if args.whole:  # A, B, B, A: drifts of the card cancel in each pair
            order = [o for _ in range(args.rounds) for o in order + order[::-1]]
        totals = {}
        for name, so in order:
            lib = _bind(so)
            for N, C in sites:
                gen = torch.Generator(device="cuda").manual_seed(N + C)
                t1, t2 = time_site(lib, N, C, gen)
                totals.setdefault(name, []).append((t1, t2))
                print(f"N={N} C={C} B={B} bf16 prenorm, {name}: pass 1 {t1:.4f} ms, "
                      f"pass 2 {t2:.4f} ms", flush=True)
        if args.whole:
            for name, ts in totals.items():
                rounds = 2 * args.rounds
                per = [sum(t[0] for t in ts[r * len(sites):(r + 1) * len(sites)])
                       for r in range(rounds)]
                print(f"{name}: pass 1 summed over the {len(sites)} sites, per round "
                      f"{', '.join(f'{v:.4f}' for v in per)} ms", flush=True)


if __name__ == "__main__":
    main()
