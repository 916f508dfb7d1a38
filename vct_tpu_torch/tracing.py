"""Spans of the program's own work, kept in memory.

A span is one piece of host work with its start and end on
``time.perf_counter_ns`` (CLOCK_MONOTONIC on Linux), the thread that did it,
the span open on that thread when it began (``parent``, by name) and small
integer ids that tie spans together (``request``, ``batch``, ``call``,
``stage``; the spans of one request share its id)::

    with tracing.span("graph.run", call=tracing.next_id()):
        ...
    tracing.record("serve.queue", t_put, t_close, request=r, batch=b)

Spans go to one bounded ring (``MAXLEN``, the newest kept), on from import:
a span costs two clock reads and one append. ``spans()`` returns a copy of
the ring and ``clear()`` empties it; ``enabled = False`` turns every span
into one shared object that records nothing. While a ``torch.profiler``
records, each span also opens a ``record_function`` range of its name, so
the profiler's trace (``cli.train --profile`` included) shows it on the
device trace's clock.

The spans, where they are recorded: ``serve.request`` / ``serve.parse`` /
``serve.queue`` / ``serve.await`` / ``serve.batch`` / ``serve.collate`` /
``serve.finish`` (``serve.py``), ``graph.run`` / ``graph.capture`` /
``graph.stage`` / ``graph.sync`` (``graphs.Staged``), ``data.to_device``
(``train.step.batch_to_arrays``), ``decode.detokenize``
(``decode.detokenize_batch``), ``train.fetch`` / ``train.step``
(``Trainer.train_epoch``), ``moe.layer`` (an LFM2 MoE layer's call outside a
graph capture, ``models/lfm2.py``), ``lm.prefill`` / ``lm.decode``
(``decode.lm_greedy_generate``).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

MAXLEN = 65536
enabled = True
now = time.perf_counter_ns

_ring: "collections.deque[tuple]" = collections.deque(maxlen=MAXLEN)  # Span's fields
_local = threading.local()
_ident = threading.get_ident
_ids = itertools.count(1)


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]
    ids: Dict[str, int]


def next_id() -> int:
    """A new id, unique in the process (requests, batches and calls draw
    from one count)."""
    return next(_ids)


def _stack() -> List[str]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Open:
    """One span being recorded; ``start_ns`` is its start once entered."""

    __slots__ = ("name", "ids", "start_ns", "parent", "_range")

    def __init__(self, name: str, ids: Dict[str, int]):
        self.name, self.ids = name, ids

    def __enter__(self) -> "_Open":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = now()
        return self

    def __exit__(self, *exc) -> None:
        end = now()
        if self._range is not None:
            self._range.__exit__(*exc)
        _local.stack.pop()
        _ring.append((self.name, self.start_ns, end, _ident(), self.parent, self.ids))


class _Off:
    """The span of ``enabled = False``: one object for every call."""

    start_ns = 0

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def span(name: str, **ids: int):
    """A context manager that records the block as the span ``name``."""
    return _Open(name, ids) if enabled else _OFF


def record(name: str, start_ns: int, end_ns: int, **ids: int) -> None:
    """Record a span whose start was stamped earlier (``now()``), under the
    span open on this thread."""
    if enabled:
        stack = _stack()
        _ring.append((name, start_ns, end_ns, _ident(), stack[-1] if stack else None, ids))


def spans() -> List[Span]:
    """A copy of the ring, oldest first."""
    return [Span(*s) for s in list(_ring)]


def clear() -> None:
    _ring.clear()
