"""Host time of the whole-block Swin kernels and of the ``fused_block``
training step on the card, for the package of a given checkout.

  python3 dmhomo_torch/ops/swin_block_host.py [--root CHECKOUT] [--calls 40] [--steps 10]

``--root`` puts that checkout's ``dmhomo_torch`` first on the path (default:
the checkout this file is in), so that one script times two revisions in
one call; it uses only entry points both have.  Per call, at the six Swin
block shapes of a shipped training microbatch (B=8), each at its step
dtype, without and with the shift and its mask: the host's wall-clock and
CPU (thread) time for ``swin_block_backward`` and for the forward
``swin_block`` to return, which is the time to check the arguments,
allocate and enqueue the launches (the card runs behind): the median of 11
rounds of ``--calls`` calls, and the CPU time over all of them.  Then the
shipped training step with ``attn_impl='fused_block'`` on 32 synthetic
pairs: the median step of
``--steps`` after 3 warm-up steps, and over 3 more steps the wall-clock
and CPU time the host spends inside the backward's calls per step.
Prints the card's name and power limit, one line per shape and one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# (H, W, C, heads, backward launches per step, step dtype)
LEVELS = [(160, 288, 24, 3, 16, "bfloat16"), (80, 144, 48, 12, 32, "bfloat16"),
          (40, 72, 96, 24, 48, "bfloat16"), (80, 144, 48, 3, 16, "float32"),
          (40, 72, 96, 3, 16, "float32"), (40, 72, 96, 12, 32, "float32")]
B = 8
BATCH = 32
WARMUP = 3


def _host_us(fn, calls: int, rounds: int = 11):
    """(wall, cpu) µs per call of ``fn``: the median over ``rounds`` of the
    wall-clock time for ``calls`` calls to return, the card synchronized
    around each round only; and the thread's CPU time over all rounds per
    call (a coarse clock: summed, not per round)."""
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


def _inputs(H, W, C, heads, dtype, shift, gen):
    import torch

    dev = torch.device("cuda")
    x = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    dy = torch.randn(B, H, W, C, generator=gen, device=dev).to(dtype)
    hidden = 3 * C
    shapes = [(C,), (C,), (3 * C, C), (3 * C,), (heads, 64, 64), (C, C), (C,), (C,), (C,),
              (hidden, C), (hidden,), (C, hidden), (C,)]
    params = tuple(0.1 * torch.randn(s, generator=gen, device=dev) + (i in (0, 7))
                   for i, s in enumerate(shapes))
    mask = None
    if shift:
        nW = (H // 8) * (W // 8)
        mask = torch.where(torch.rand(nW, 64, 64, generator=gen, device=dev) < 0.3, -100.0, 0.0)
    return x, dy, params, mask


def per_call(calls: int) -> list:
    import torch

    from dmhomo_torch.ops import swin_block as sb

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for H, W, C, heads, launches, dtype in LEVELS:
        for shift in (0, 4):
            x, dy, params, mask = _inputs(H, W, C, heads, getattr(torch, dtype), shift, gen)
            kw = dict(num_heads=heads, shift=shift)
            bwd = _host_us(lambda: sb.swin_block_backward(x, params, mask, dy, **kw), calls)
            with torch.no_grad():
                fwd = _host_us(lambda: sb.swin_block(x, params, mask, **kw), calls)
            rows.append({"H": H, "W": W, "C": C, "heads": heads, "dtype": dtype, "shift": shift,
                         "launches_per_step": launches // 2, "bwd_wall_us": bwd[0],
                         "bwd_cpu_us": bwd[1], "fwd_wall_us": fwd[0], "fwd_cpu_us": fwd[1]})
            print(f"[host] {H}x{W} C={C} h={heads} B={B} {dtype} shift={shift}: backward "
                  f"{bwd[0]:.1f} µs wall, {bwd[1]:.1f} µs CPU per call; forward {fwd[0]:.1f} / "
                  f"{fwd[1]:.1f} µs", flush=True)
    return rows


def step(steps: int) -> dict:
    import numpy as np
    import torch

    from dmhomo_torch.data.hem_data import SyntheticHomoPairs
    from dmhomo_torch.data.loader import collate
    from dmhomo_torch.ops import swin_block as sb
    from dmhomo_torch.train.config import HEMTrainConfig
    from dmhomo_torch.train.hem_trainer import HEMTrainer

    ds = SyntheticHomoPairs(n=BATCH, crop_size=(320, 576), ori_size=(360, 640), seed=0)
    items = [ds[i] for i in range(BATCH)]
    batch = {k: collate([it[k] for it in items]) for k in ("imgs_gray_patch", "flow_gt_patch")}
    trainer = HEMTrainer(HEMTrainConfig(attn_impl="fused_block"), steps_per_epoch=1000,
                         device=torch.device("cuda"))
    trainer.init_state(0)

    def one():
        t0 = time.perf_counter()
        out = trainer.train_step(batch)
        loss = float(out["total"])
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), loss

    runs = [one() for _ in range(WARMUP + steps)]
    times = [t for t, _ in runs[WARMUP:]]
    # the host's time inside the backward's calls (SwinBlockFunction.backward
    # looks swin_block_backward up in its module at each call)
    inner = sb.swin_block_backward
    spent = {"wall": 0.0, "cpu": 0.0, "calls": 0}

    def timed(*args, **kw):
        t0, c0 = time.perf_counter(), time.thread_time()
        out = inner(*args, **kw)
        spent["wall"] += time.perf_counter() - t0
        spent["cpu"] += time.thread_time() - c0
        spent["calls"] += 1
        return out

    timed.launches = inner.launches  # the call counts itself under its module name
    sb.swin_block_backward = timed
    try:
        for _ in range(3):
            one()
    finally:
        sb.swin_block_backward = inner
    losses = [loss for _, loss in runs]
    if not np.isfinite(losses).all():
        raise SystemExit(f"training loss not finite: {losses}")
    return {"step_ms": statistics.median(times), "step_ms_all": times,
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
                for k in ("bwd_wall_us", "bwd_cpu_us")}
    st = step(args.steps)
    print(f"[host] backward calls of a step, weighted by shape: {weighted['bwd_wall_us']:.2f} ms "
          f"wall, {weighted['bwd_cpu_us']:.2f} ms CPU; fused_block step {st['step_ms']:.2f} ms, "
          f"inside the backward's {st['bwd_calls_per_step']:.0f} calls "
          f"{st['bwd_host_wall_ms_per_step']:.2f} ms wall, {st['bwd_host_cpu_ms_per_step']:.2f} "
          f"ms CPU", flush=True)
    print(json.dumps({"root": str(args.root), "smi": smi, "shapes": rows,
                      "bwd_ms_per_step_by_shape": weighted, **st}), flush=True)


if __name__ == "__main__":
    main()
