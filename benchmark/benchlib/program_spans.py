"""The program's own spans (``vct_tpu_torch.tracing``), for the per-layer
readers in ``benchmark/metrics``.

They are read in the measuring process once the cell has run: the
program keeps them in a ring in memory. A span's times are
``time.perf_counter_ns``; ``to_trace_clock`` puts them on the traced window's
clock by the window range that ``trace.Recorder`` brackets the recording
with, at its end: the host clock's reading just after the range closed
(``records["trace_host"][1]``) against the range's end (``trace.window[1]``).
Its start is no anchor: the recording's first ``record_function`` takes
0.2-4 ms to set up between the host clock's reading
(``records["trace_host"][0]``) and the range's start, so spans put on the
trace's clock by it land that much late (measured on an H100 host against
each span's own profiler range). Each reader gives None, not an error,
where the program has no ``tracing`` module, a span it needs is missing, or
the host clock is not CLOCK_MONOTONIC (the clock of the serving cell's due
times, which the generator takes in another process).
"""

from __future__ import annotations

import bisect
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

MONOTONIC = "clock_gettime(CLOCK_MONOTONIC)"


def program_spans() -> Optional[list]:
    """The program's spans, oldest first, or None."""
    if time.get_clock_info("perf_counter").implementation != MONOTONIC:
        return None
    try:
        from vct_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def named(spans: Sequence, name: str) -> list:
    return [s for s in spans if s.name == name]


# -- serving latency by request ---------------------------------------------

def second_half_requests(spans: Sequence, rows: List[Dict],
                         seconds: float) -> Dict[int, Dict[str, float]]:
    """{request id: {"request" / "queue" / "await": ms}} of the requests
    whose ``serve.request`` began in the window's second half (the half
    ``serve.p50_ms`` reads: from the first request's due time plus half the
    window to the last answer) and that recorded all three spans."""
    if not rows:
        return {}
    half = min(r["due"] for r in rows) + seconds / 2
    end = max(r["done"] for r in rows)
    by_id: Dict[int, Dict[str, float]] = {}
    for s in named(spans, "serve.request"):
        if half <= s.start_ns / 1e9 <= end:
            by_id[s.ids["request"]] = {"request": (s.end_ns - s.start_ns) / 1e6}
    for part in ("queue", "await"):
        for s in named(spans, "serve." + part):
            got = by_id.get(s.ids.get("request"))
            if got is not None:
                got[part] = (s.end_ns - s.start_ns) / 1e6
    return {k: v for k, v in by_id.items() if len(v) == 3}


def request_median(ctx, out, part) -> Optional[float]:
    """The median over ``second_half_requests`` of ``part(times)``."""
    spans = program_spans()
    rows = out.records.get("rows")
    if not spans or not rows:
        return None
    got = second_half_requests(spans, rows, ctx.seconds)
    return statistics.median(part(t) for t in got.values()) if got else None


# -- the card's idle time under program spans -------------------------------

def to_trace_clock(out, spans: Sequence) -> List[Tuple[object, float, float]]:
    """(span, start µs, end µs) on the traced window's clock."""
    shift = out.trace.window[1] - out.records["trace_host"][1] * 1e6
    return [(s, s.start_ns / 1e3 + shift, s.end_ns / 1e3 + shift) for s in spans]


class IdleTime:
    """The traced window's idle gaps, for the idle time inside any interval
    of the trace's clock."""

    def __init__(self, trace):
        self.gaps = trace.idle_gaps()  # (start µs, length µs), in order, apart
        self.starts = [g[0] for g in self.gaps]

    def within(self, lo: float, hi: float) -> float:
        """µs of [lo, hi] with no operation on the card."""
        total = 0.0
        i = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        while i < len(self.gaps) and self.gaps[i][0] < hi:
            start, length = self.gaps[i]
            total += max(0.0, min(hi, start + length) - max(lo, start))
            i += 1
        return total


def traced(out) -> bool:
    host = out.records.get("trace_host")
    return out.trace is not None and bool(host) and host[1] is not None \
        and out.trace.window_s > 0


def stall_share(out, name: str) -> Optional[float]:
    """% of the traced window with no operation on the card while a span
    ``name`` was open (its spans are one thread's, so they do not overlap)."""
    spans = program_spans()
    if not spans or not traced(out):
        return None
    of_name = named(spans, name)
    if not of_name:
        return None
    lo_w, hi_w = out.trace.window
    idle = IdleTime(out.trace)
    stalled = sum(idle.within(max(a, lo_w), min(b, hi_w))
                  for _, a, b in to_trace_clock(out, of_name) if b > lo_w and a < hi_w)
    return 100.0 * stalled / (hi_w - lo_w)


def decode_idle_ms(out) -> Optional[float]:
    """The median, over the decode runners' ``graph.run`` calls (more than
    one stage) that lie in the traced window, of the card's idle ms inside
    the call's span."""
    spans = program_spans()
    if not spans or not traced(out):
        return None
    runs = [s for s in named(spans, "graph.run") if s.ids.get("stages", 1) > 1]
    lo_w, hi_w = out.trace.window
    idle = IdleTime(out.trace)
    inside = [idle.within(a, b) / 1e3 for _, a, b in to_trace_clock(out, runs)
              if a >= lo_w and b <= hi_w]
    return statistics.median(inside) if inside else None
