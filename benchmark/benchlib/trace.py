"""The traced window: a ``torch.profiler`` recording of part of the measured
window, read back from its Chrome trace, and the benchmark's own host spans.

Spans are the benchmark's ranges around its calls into each layer of the
program (``Spans``): host clock intervals kept in memory on whatever thread
makes the call. The recording brackets itself with a ``bench.trace_window``
range, which gives the offset between the host clock and the trace's clock,
so the spans and the device's operations (kernels, copies, fills) share one
timeline. ``Trace`` holds both, clipped to that range.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

WINDOW_SPAN = "bench.trace_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans, (name, start s, end s) on ``time.perf_counter``; a
    disabled log records nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t, time.perf_counter()))  # one append: thread-safe


@dataclass
class Trace:
    window: Tuple[float, float]  # µs, trace clock
    ops: List[Tuple[str, float, float]]  # (name, start µs, duration µs), by start
    spans: List[Tuple[str, float, float]]  # (name, start µs, duration µs), by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        total, end = 0.0, self.window[0]
        for _, start, dur in self.ops:
            lo, hi = max(start, end), min(start + dur, self.window[1])
            if hi > lo:
                total += hi - lo
            end = max(end, min(start + dur, self.window[1]))
        return total / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start µs, length µs) of each stretch with no device operation."""
        gaps, end = [], self.window[0]
        for _, start, dur in self.ops:
            if start > end:
                gaps.append((end, start - end))
            end = max(end, start + dur)
        if self.window[1] > end:
            gaps.append((end, self.window[1] - end))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost benchmark span open at trace time ``t``."""
        best, best_len = "host (no span)", None
        for name, start, dur in self.spans:
            if start > t:
                break
            if t < start + dur and (best_len is None or dur < best_len):
                best, best_len = name, dur
        return best

    def breakdown(self, n: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the idle time by
        the host span open when each gap began."""
        by_op: Dict[str, float] = {}
        for name, _, dur in self.ops:
            by_op[short(name)] = by_op.get(short(name), 0.0) + dur / 1e6
        by_host: Dict[str, float] = {}
        for start, length in self.idle_gaps():
            key = self.host_at(start)
            by_host[key] = by_host.get(key, 0.0) + length / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    return name.replace("(anonymous namespace)::", "").split("(", 1)[0][:120]


def read_chrome_trace(path: str, spans: List[Tuple[str, float, float]],
                      window_host_start: float) -> Trace:
    """The device operations and the window range of the exported trace;
    ``spans`` (host clock) are put on the trace's clock by the window range's
    start, which the host clock read as ``window_host_start``."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops, window = [], None
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        start, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            ops.append((name, start, dur))
        elif cat == "user_annotation" and name == WINDOW_SPAN:
            window = (start, start + dur)
    if window is None:
        raise RuntimeError(f"{path}: no {WINDOW_SPAN} range in the trace")
    shift = window[0] - window_host_start * 1e6
    inside = lambda s, d: s + d > window[0] and s < window[1]
    ops = sorted((op for op in ops if inside(op[1], op[2])), key=lambda o: o[1])
    host = sorted(((n, a * 1e6 + shift, (b - a) * 1e6) for n, a, b in spans),
                  key=lambda s: s[1])
    return Trace(window, ops, [s for s in host if inside(s[1], s[2])])


class Recorder:
    """Records the profiler over ``seconds`` from ``start_s`` into the
    window, driven by ``poll()`` calls from the thread that starts it (the
    profiler's host side is that thread's; the device side is the whole
    card's). ``result()`` exports and reads the trace."""

    def __init__(self, out_dir: str, start_s: float, seconds: float, spans: Spans):
        self.out_dir, self.start_s, self.seconds, self.spans = out_dir, start_s, seconds, spans
        self.prof = self.window_cm = self.t0 = None
        self.t_asked = self.t_on = self.t_off = None
        self.done = False

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once in set-up: its first start
        initialises the card's tracing, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)

    def begin(self, t0: float) -> None:
        self.t0 = t0

    def poll(self) -> None:
        if self.done or self.t0 is None:
            return
        now = time.perf_counter()
        if self.prof is None and now - self.t0 >= self.start_s:
            self._on()
        elif self.prof is not None and now >= self.t_on + self.seconds:
            self._off()

    def _on(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.t_asked = time.perf_counter()
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()
        self.t_on = time.perf_counter()
        self.window_cm = record_function(WINDOW_SPAN)
        self.window_cm.__enter__()

    def _off(self) -> None:
        import torch

        self.window_cm.__exit__(None, None, None)
        self.t_off = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.done = True

    def finish(self) -> None:
        """Close a recording that the window's end cut short."""
        if self.prof is not None and not self.done:
            self._off()

    def result(self) -> Optional[Trace]:
        if self.prof is None:
            return None
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        trace = read_chrome_trace(path, self.spans.items, self.t_on)
        os.remove(path)
        return trace
