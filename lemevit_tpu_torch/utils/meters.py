"""Training meters (host-side): counterpart of lemevit_tpu/utils/meters.py."""
from __future__ import annotations

import collections
from typing import Dict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class MetricTracker:
    """Dict of AverageMeters."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = collections.defaultdict(
            AverageMeter)

    def update(self, metrics: Dict[str, float], n: int = 1):
        for k, v in metrics.items():
            self.meters[k].update(float(v), n)

    def summary(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}
