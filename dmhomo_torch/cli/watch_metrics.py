"""Experiment metrics watcher (the JAX package's ``cli/watch_metrics.py``;
reference: HEM/common/illustrate_results.py): polls metric-JSON snapshots
under experiment directories and prints one table.  Host only.

Example:
  python -m dmhomo_torch.cli.watch_metrics --glob 'experiments/*/val_metrics*.json' --once
"""

from __future__ import annotations

import argparse
import glob
import json
import time


def render(paths) -> None:
    """Print a table: one row per readable metric file (its path's last 24
    characters), one column per metric name (4 decimals, nan where absent)."""
    rows = []
    for p in sorted(paths):
        try:
            with open(p) as f:
                rows.append((p, json.load(f)))
        except (OSError, json.JSONDecodeError):
            continue
    if not rows:
        print("(no metric files)")
        return
    keys = sorted({k for _, m in rows for k in m})
    header = ["experiment"] + keys
    widths = [max(len(h), 24) for h in header]
    line = " | ".join(h.ljust(w) for h, w in zip(header, widths))
    print(line)
    print("-" * len(line))
    for p, m in rows:
        cells = [p[-24:]] + [f"{m.get(k, float('nan')):.4f}" for k in keys]
        print(" | ".join(c.ljust(w) for c, w in zip(cells, widths)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--glob", type=str, required=True)
    parser.add_argument("--interval", type=float, default=600.0)
    parser.add_argument("--once", action="store_true")
    args = parser.parse_args(argv)
    while True:
        render(glob.glob(args.glob))
        if args.once:
            break
        time.sleep(args.interval)


if __name__ == "__main__":
    main()
