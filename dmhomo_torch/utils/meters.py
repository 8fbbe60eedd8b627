"""Running averages and best-metric tracking (the JAX package's
``utils/meters.py``; reference HEM/common/utils.py and Manager)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricTracker:
    """Per-split meters and the best score of the major metric (lower is better)."""

    def __init__(self, major_metric: str = "AVG"):
        self.major_metric = major_metric
        self.meters: Dict[str, Dict[str, AverageMeter]] = defaultdict(
            lambda: defaultdict(AverageMeter))
        self.best: Dict[str, float] = {}

    def update(self, split: str, metrics: Dict[str, float], n: int = 1):
        for k, v in metrics.items():
            self.meters[split][k].update(v, n)

    def reset(self, split: str):
        self.meters[split].clear()

    def current(self, split: str) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters[split].items()}

    def is_best(self, split: str, score: Optional[float] = None) -> bool:
        score = self.meters[split][self.major_metric].avg if score is None else score
        prev = self.best.get(split)
        if prev is None or score < prev:
            self.best[split] = score
            return True
        return False
