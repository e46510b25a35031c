"""Stage timing + aggregated metrics (reference: src/utils/timer.hpp,
src/utils/time_metric.hpp).

The port's own copy of ``xlayer_prover_tpu/utils/timer.py``.
``timer(label)`` context manager replaces TimerStart/TimerStopAndLog;
``TimeMetrics`` aggregates (count, total) per label like TimeMetricStorage.
Work on the card is asynchronous — pass a tensor via ``timer(...,
block=tensor)`` to wait for its device before the clock stops.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch

from .log import zklog


class TimeMetrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._acc: Dict[str, list] = {}

    def add(self, label: str, seconds: float):
        with self._lock:
            e = self._acc.setdefault(label, [0, 0.0])
            e[0] += 1
            e[1] += seconds

    def print_summary(self, prefix: str = ""):
        with self._lock:
            for label, (n, total) in sorted(self._acc.items(),
                                            key=lambda kv: -kv[1][1]):
                zklog.info(f"{prefix}{label}: n={n} total={total:.3f}s "
                           f"avg={total / max(n, 1) * 1e3:.2f}ms")

    def as_dict(self):
        with self._lock:
            return {k: {"count": n, "total_s": t}
                    for k, (n, t) in self._acc.items()}


metrics = TimeMetrics()


@contextlib.contextmanager
def timer(label: str, block=None, log: bool = True):
    """Time a stage; optionally wait for the device of the tensor `block`
    for true timing."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block is not None and block.is_cuda:
            torch.cuda.synchronize(block.device)
        dt = time.perf_counter() - t0
        metrics.add(label, dt)
        if log:
            zklog.info(f"{label}: {dt:.3f} s")
