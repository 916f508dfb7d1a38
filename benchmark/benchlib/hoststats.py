"""What the host did in a window, for a run's lines on standard output: the
interpreter's collector pauses in this process (``gc.callbacks``), and
readings by windows of a few seconds. None enters a metric."""

from __future__ import annotations

import gc
import time
from typing import List, Tuple


class HostWatch:
    def __init__(self):
        self.pauses: List[Tuple[int, float]] = []  # (generation, seconds)
        self._t = None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((int(info["generation"]), time.perf_counter() - self._t))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False

    def line(self) -> str:
        gen2 = [s for g, s in self.pauses if g == 2]
        return (f"host: collector {len(self.pauses)} pauses, "
                f"{1e3 * sum(s for _, s in self.pauses):.1f} ms in all, longest "
                f"{1e3 * max((s for _, s in self.pauses), default=0.0):.1f} ms; "
                f"{len(gen2)} of generation 2, {1e3 * sum(gen2):.1f} ms")


def percentile(values: List[float], q: float) -> float:
    """The ``q``-quantile (0-1) by linear interpolation between order
    statistics."""
    v = sorted(values)
    if not v:
        return float("nan")
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def segments(times: List[float], values: List[float], start: float, seconds: float,
             width: float = 5.0) -> List[List[float]]:
    """``values`` split by their ``times`` into windows of ``width`` seconds
    from ``start``."""
    n = max(1, int(round(seconds / width)))
    out: List[List[float]] = [[] for _ in range(n)]
    for t, v in zip(times, values):
        out[min(n - 1, max(0, int((t - start) / width)))].append(v)
    return out
