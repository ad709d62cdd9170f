"""Fault tolerance primitives: heartbeats, failure detection, stragglers.

Port of `repro.runtime.fault` (pure Python; the port keeps its own copy).
A serving or training driver keeps:
  * a HeartbeatMonitor — every worker stamps a monotonic timestamp;
    a worker silent for `timeout_s` is declared failed;
  * a StragglerDetector — per-step durations per worker; a worker whose
    rolling step time exceeds mean + k*std of the rest of the cohort is
    flagged so the driver can exclude it or rebalance.

Both are transport-agnostic (timestamps come from any source), so the
logic is testable on one host with simulated clocks.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 10.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._last: dict[str, float] = {}
        self._lock = threading.Lock()

    def beat(self, worker: str, at: float | None = None) -> None:
        with self._lock:
            self._last[worker] = self.clock() if at is None else at

    def workers(self) -> list[str]:
        with self._lock:
            return sorted(self._last)

    def failed(self) -> list[str]:
        now = self.clock()
        with self._lock:
            return sorted(w for w, t in self._last.items()
                          if now - t > self.timeout_s)

    def alive(self) -> list[str]:
        dead = set(self.failed())
        return [w for w in self.workers() if w not in dead]

    def remove(self, worker: str) -> None:
        with self._lock:
            self._last.pop(worker, None)


@dataclasses.dataclass
class StragglerDetector:
    window: int = 20
    k_sigma: float = 3.0
    min_steps: int = 5

    def __post_init__(self):
        self._times: dict[str, list[float]] = {}

    def record(self, worker: str, step_time_s: float) -> None:
        hist = self._times.setdefault(worker, [])
        hist.append(step_time_s)
        if len(hist) > self.window:
            del hist[0]

    def remove(self, worker: str) -> None:
        """Forget a worker (dropped from the mesh after a failure)."""
        self._times.pop(worker, None)

    def _mean(self, xs):
        return sum(xs) / len(xs)

    def stragglers(self) -> list[str]:
        """Workers whose recent mean step time is an outlier against the
        REST of the cohort (leave-one-out: including the straggler in mu
        and sigma masks it at small cohort sizes)."""
        means = {w: self._mean(h) for w, h in self._times.items()
                 if len(h) >= self.min_steps}
        if len(means) < 3:
            return []
        out = []
        for w, v in means.items():
            others = [x for ww, x in means.items() if ww != w]
            mu = self._mean(others)
            var = self._mean([(x - mu) ** 2 for x in others])
            sigma = max(var ** 0.5, 0.05 * mu, 1e-9)
            if v > mu + self.k_sigma * sigma:
                out.append(w)
        return sorted(out)
