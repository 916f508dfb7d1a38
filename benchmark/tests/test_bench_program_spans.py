"""The readers of the program's spans (``benchlib/program_spans.py`` and the
metrics that use it) on a planted timeline: a synthetic traced window and
spans recorded into the program's ring with chosen times.

    python3 -m pytest benchmark/tests/test_bench_program_spans.py -q
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401 (puts the benchmark on sys.path)
from benchlib import cells, program_spans  # noqa: E402
from benchlib.trace import Trace  # noqa: E402

SERVE = ["serve.queue_wait_ms", "serve.answer_wait_ms", "serve.handler_ms",
         "serve.stall_share", "serve.decode_idle_ms"]
READERS = SERVE + ["eval.decode_idle_ms"]

HOST_ON = 5.0  # the host clock (s) at trace µs 1000; the window range ends at 11000
# the host clock's reading before the range opened: its set-up lies between
ASKED = HOST_ON - 0.0012


def ns(trace_us: float) -> int:
    """A trace-clock time as the program's host clock reads it."""
    return int(round((trace_us - 1000.0) * 1e3 + HOST_ON * 1e9))


@pytest.fixture
def ring():
    from vct_tpu_torch import tracing

    tracing.clear()
    yield tracing
    tracing.clear()


def planted(tracing):
    """Window 1000-11000 µs; the card busy 1000-3000, 4000-5000 and
    8000-9000, so idle 6000 µs (60%)."""
    trace = Trace((1000.0, 11000.0),
                  [("k", 1000.0, 2000.0), ("k", 4000.0, 1000.0), ("k", 8000.0, 1000.0)], [])
    # two batches: idle 3000-4000 and 7000-8000 under them, 20% of the window
    for b, (lo, hi) in enumerate([(2500.0, 4500.0), (7000.0, 8500.0)]):
        tracing.record("serve.batch", ns(lo), ns(hi), batch=b, rows=1)
    # decode calls, idle 1.0, 3.0 and 0.5 ms inside; one past the window's
    # end and a one-stage runner left out
    for call, (lo, hi, stages) in enumerate([(1500.0, 4200.0, 4), (4800.0, 8100.0, 4),
                                             (9500.0, 10000.0, 4), (10500.0, 11500.0, 4),
                                             (5000.0, 8000.0, 1)]):
        tracing.record("graph.run", ns(lo), ns(hi), call=call, new=0, stages=stages)
    # requests: (handler start s, request, await, queue ms); the one at
    # 104 s lies in the first half, the one at 108 s has no queue span
    for rid, (t, req, wait, queue) in enumerate([(104.0, 100, 90, 80), (105.5, 10, 8, 3),
                                                 (106.0, 20, 15, 5), (107.0, 12, 11, 4),
                                                 (108.0, 9, 8, None)]):
        start = int(t * 1e9)
        tracing.record("serve.request", start, start + int(req * 1e6), request=rid)
        tracing.record("serve.await", start, start + int(wait * 1e6), request=rid)
        if queue is not None:
            tracing.record("serve.queue", start, start + int(queue * 1e6), request=rid,
                           batch=0)
    rows = [{"due": 100.0 + i, "done": 100.5 + i} for i in range(11)]  # halfway: 105 s
    out = SimpleNamespace(trace=trace, records={"trace_host": (ASKED, HOST_ON + 0.01),
                                                "rows": rows})
    return SimpleNamespace(seconds=10.0), out


def read(name, ctx, out):
    return cells.metric_reader(name).read(ctx, out)


def test_each_reader_gives_the_planted_value(ring):
    ctx, out = planted(ring)
    got = {name: read(name, ctx, out) for name in READERS}
    assert got == pytest.approx({"serve.queue_wait_ms": 4.0, "serve.answer_wait_ms": 7.0,
                                 "serve.handler_ms": 2.0, "serve.stall_share": 20.0,
                                 "serve.decode_idle_ms": 1.0, "eval.decode_idle_ms": 1.0},
                                abs=1e-6)


def test_stall_share_is_part_of_the_idle_share(ring):
    ctx, out = planted(ring)
    idle = cells.metric_reader("serve.idle_share").read(ctx, out)
    assert idle == pytest.approx(60.0)
    assert read("serve.stall_share", ctx, out) <= idle


def test_idle_time_within_an_interval():
    idle = program_spans.IdleTime(Trace((0.0, 100.0), [("k", 10.0, 10.0), ("k", 50.0, 20.0)],
                                        []))
    assert idle.within(0.0, 100.0) == pytest.approx(70.0)
    assert idle.within(15.0, 60.0) == pytest.approx(30.0)
    assert idle.within(55.0, 65.0) == 0.0
    assert idle.within(80.0, 90.0) == pytest.approx(10.0)


def test_readers_give_none_without_the_programs_spans(ring, monkeypatch):
    ctx, out = planted(ring)
    import vct_tpu_torch

    monkeypatch.delattr(vct_tpu_torch, "tracing")  # a program without the module
    monkeypatch.setitem(sys.modules, "vct_tpu_torch.tracing", None)
    assert all(read(name, ctx, out) is None for name in READERS)
    monkeypatch.undo()
    ring.clear()
    assert all(read(name, ctx, out) is None for name in READERS)


def test_readers_give_none_on_another_clock(ring, monkeypatch):
    ctx, out = planted(ring)
    monkeypatch.setattr(program_spans.time, "get_clock_info",
                        lambda name: SimpleNamespace(implementation="QueryPerformanceCounter()"))
    assert all(read(name, ctx, out) is None for name in READERS)


def test_readers_give_none_on_an_untraced_run(ring):
    ctx, out = planted(ring)
    out.trace = None
    for name in ("serve.stall_share", "serve.decode_idle_ms", "eval.decode_idle_ms"):
        assert read(name, ctx, out) is None
