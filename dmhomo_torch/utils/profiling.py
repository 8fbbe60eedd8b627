"""Profiling and tracing helpers (the JAX package's ``utils/profiling.py``).

* :func:`trace` - a context manager around ``torch.profiler`` (host and, on
  a card, device activity) writing a Chrome trace into a directory;
* :func:`annotate` - a named range inside a step (``record_function``);
* :class:`StepTimer` - a rolling wall-clock timer: steps/s and samples/s
  over the last ``window`` intervals between ticks.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed code and write ``log_dir/trace_<pid>.json``
    (open it in chrome://tracing or Perfetto).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """A named range in the trace (a context manager)."""
    return torch.profiler.record_function(name)


class StepTimer:
    def __init__(self, window: int = 50, clock=time.perf_counter):
        self.times: deque = deque(maxlen=window)
        self._last: Optional[float] = None
        self._clock = clock

    def tick(self) -> Optional[float]:
        """Seconds since the previous tick (None on the first)."""
        now = self._clock()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.times.append(dt)
        self._last = now
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    def samples_per_sec(self, batch_size: int) -> float:
        return self.steps_per_sec * batch_size
