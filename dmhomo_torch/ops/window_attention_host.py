"""Host time of the window-attention kernels' calls and the shipped training
step on the card, for the package of a given checkout.

  python3 dmhomo_torch/ops/window_attention_host.py [--root CHECKOUT] [--calls 40] [--steps 10]

``--root`` puts that checkout's ``dmhomo_torch`` first on the path (default:
the checkout this file is in), so that one command can time two revisions
one process after the other; it uses only entry points both have.  Per
call, at the six window-attention shapes of a shipped training microbatch
(B=8, bf16), without and with the mask: the host's wall-clock and CPU
(thread) time for ``window_attention`` (no grad) and
``window_attention_backward`` to return, which is the time to check the
arguments, allocate and enqueue the launches (the card runs behind): the
median of 11 rounds of ``--calls`` calls, and the CPU time over all of
them.  Then the shipped training step (``attn_impl='auto'``: the window
kernels) on 32 synthetic pairs: the median step of ``--steps`` after 3
warm-up steps, the host's time for ``train_step`` to return (the time to
enqueue the step: with no wait inside the step the card runs behind it), and over
3 more steps the wall-clock and CPU time the host spends inside the
backward's calls per step.  Prints the card's name and
power limit, one line per shape and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# (H, W, C, heads, launches per training step, each way, half of them masked)
LEVELS = [(160, 288, 24, 3, 16), (80, 144, 48, 12, 32), (40, 72, 96, 24, 48),
          (80, 144, 48, 3, 16), (40, 72, 96, 3, 16), (40, 72, 96, 12, 32)]
B = 8
BATCH = 32
WARMUP = 3


def _host_us(fn, calls: int, rounds: int = 11):
    """(wall, cpu) µs per call of ``fn``: the median over ``rounds`` of the
    wall-clock time for ``calls`` calls to return, the card synchronized
    around each round only; and the thread's CPU time over all rounds per
    call."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls, cpu = [], 0.0
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(calls):
            fn()
        walls.append(1e6 * (time.perf_counter() - t0) / calls)
        cpu += time.thread_time() - c0
        torch.cuda.synchronize()
    return statistics.median(walls), 1e6 * cpu / (rounds * calls)


def per_call(calls: int) -> list:
    import torch

    from dmhomo_torch.models.swin import shifted_window_mask
    from dmhomo_torch.ops import window_attention as wa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for H, W, C, heads, launches in LEVELS:
        nW = (H // 8) * (W // 8)
        qkv = torch.randn(B * nW, 64, 3 * C, generator=gen, device=dev).to(torch.bfloat16)
        gout = torch.randn(B * nW, 64, C, generator=gen, device=dev).to(torch.bfloat16)
        bias = 0.5 * torch.randn(heads, 64, 64, generator=gen, device=dev)
        for masked in (False, True):
            mask = torch.from_numpy(shifted_window_mask(H, W, 8, 4)).to(dev) if masked else None
            bwd = _host_us(lambda: wa.window_attention_backward(qkv, bias, mask, gout,
                                                                num_heads=heads), calls)
            with torch.no_grad():
                fwd = _host_us(lambda: wa.window_attention(qkv, bias, mask, num_heads=heads),
                               calls)
            rows.append({"H": H, "W": W, "C": C, "heads": heads, "mask": masked,
                         "launches_per_step": launches // 2, "bwd_wall_us": bwd[0],
                         "bwd_cpu_us": bwd[1], "fwd_wall_us": fwd[0], "fwd_cpu_us": fwd[1]})
            print(f"[host] {H}x{W} C={C} h={heads} B={B} bf16 mask={int(masked)}: backward "
                  f"{bwd[0]:.1f} µs wall, {bwd[1]:.1f} µs CPU per call; forward {fwd[0]:.1f} / "
                  f"{fwd[1]:.1f} µs", flush=True)
    return rows


def step(steps: int) -> dict:
    import numpy as np
    import torch

    from dmhomo_torch.data.hem_data import SyntheticHomoPairs
    from dmhomo_torch.data.loader import collate
    from dmhomo_torch.ops import window_attention as wa
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    ds = SyntheticHomoPairs(n=BATCH, crop_size=(320, 576), ori_size=(360, 640), seed=0)
    items = [ds[i] for i in range(BATCH)]
    batch = {k: collate([it[k] for it in items]) for k in ("imgs_gray_patch", "flow_gt_patch")}
    trainer = HEMTrainer(HEMTrainConfig(), steps_per_epoch=1000, device=torch.device("cuda"))
    trainer.init_state(0)

    def one():
        t0 = time.perf_counter()
        out = trainer.train_step(batch)
        enqueued = time.perf_counter()
        loss = float(out["total"])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), loss, 1e3 * (enqueued - t0)

    runs = [one() for _ in range(WARMUP + steps)]
    times = [t for t, _, _ in runs[WARMUP:]]
    enqueue = [t for _, _, t in runs[WARMUP:]]
    # the host's time inside the backward's calls (WindowAttentionFunction.backward
    # looks window_attention_backward up in its module at each call)
    inner = wa.window_attention_backward
    spent = {"wall": 0.0, "cpu": 0.0, "calls": 0}

    def timed(*args, **kw):
        t0, c0 = time.perf_counter(), time.thread_time()
        out = inner(*args, **kw)
        spent["wall"] += time.perf_counter() - t0
        spent["cpu"] += time.thread_time() - c0
        spent["calls"] += 1
        return out

    # the call counts itself under its module name (launches_by_shape: not
    # in every checkout)
    for name in ("launches", "launches_by_shape"):
        if hasattr(inner, name):
            setattr(timed, name, getattr(inner, name))
    wa.window_attention_backward = timed
    try:
        for _ in range(3):
            one()
    finally:
        wa.window_attention_backward = inner
    losses = [loss for _, loss, _ in runs]
    if not np.isfinite(losses).all():
        raise SystemExit(f"training loss not finite: {losses}")
    return {"step_ms": statistics.median(times), "step_ms_all": times,
            "enqueue_ms": statistics.median(enqueue), "enqueue_ms_all": enqueue,
            "bwd_calls_per_step": spent["calls"] / 3,
            "bwd_host_wall_ms_per_step": 1e3 * spent["wall"] / 3,
            "bwd_host_cpu_ms_per_step": 1e3 * spent["cpu"] / 3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                    help="the checkout whose dmhomo_torch to time")
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    import dmhomo_torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    print(f"[host] package {Path(dmhomo_torch.__file__).parent}", flush=True)
    rows = per_call(args.calls)
    weighted = {k: sum(r[k] * r["launches_per_step"] for r in rows) / 1e3
                for k in ("fwd_wall_us", "fwd_cpu_us", "bwd_wall_us", "bwd_cpu_us")}
    st = step(args.steps)
    print(f"[host] a step's calls, weighted by shape: forward {weighted['fwd_wall_us']:.2f} ms "
          f"wall, backward {weighted['bwd_wall_us']:.2f} ms wall; step {st['step_ms']:.2f} ms "
          f"(train_step returns after {st['enqueue_ms']:.2f} ms), "
          f"inside the backward's {st['bwd_calls_per_step']:.0f} calls "
          f"{st['bwd_host_wall_ms_per_step']:.2f} ms wall, {st['bwd_host_cpu_ms_per_step']:.2f} "
          f"ms CPU", flush=True)
    print(json.dumps({"root": str(args.root), "smi": smi, "shapes": rows,
                      "ms_per_step_by_shape": weighted, **st}), flush=True)


if __name__ == "__main__":
    main()
