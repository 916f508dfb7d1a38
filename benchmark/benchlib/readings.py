"""Shared arithmetic of the per-layer readers (``benchmark/metrics``)."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from benchlib import counts
from benchlib.trace import Trace

# the encoder's LayerNorm runs in a decode call's prologue and nowhere in its
# token stages (the stack kernels norm inside): it marks a call's start
CALL_START = "layer_norm"


def ident(name: str) -> str:
    """A kernel's function name: no ``void``, namespace, template or
    argument list (``void ns::k<0>(int)`` -> ``k``)."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    head = head[5:] if head.startswith("void ") else head
    return head.rsplit("::", 1)[-1].strip()


def launches(trace: Trace, names: Sequence[str]) -> List[Tuple[str, float, float]]:
    """Operations whose function name is one of ``names``."""
    return [op for op in trace.ops if ident(op[0]) in names]


def seconds(ops) -> float:
    return sum(op[2] for op in ops) / 1e6


def idle_share(trace: Optional[Trace]) -> Optional[float]:
    """% of the traced window in which no operation ran on the device."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def positions(trace: Trace, names: Sequence[str]) -> List[Tuple[float, int]]:
    """(device µs, position in its decode call) of each launch of ``names``;
    positions count from 0 after each call's prologue."""
    out, pos = [], 0
    for name, _, dur in trace.ops:
        if CALL_START in name:
            pos = 0
        elif ident(name) in names:
            out.append((dur, pos))
            pos += 1
    return out


def token_roofline(trace: Optional[Trace], step_names: Sequence[str],
                   other_names: Sequence[str], bound_at: Callable[[int], dict]) -> Optional[float]:
    """% of the bound of a decode's token steps: each launch of
    ``step_names`` is one token at its position, whose least time is
    ``bound_at(position)`` (bytes and operations); the time is that of those
    launches and of ``other_names`` (the step's other kernels)."""
    if trace is None:
        return None
    steps = positions(trace, step_names)
    spent = sum(d for d, _ in steps) / 1e6 + seconds(launches(trace, other_names))
    if not steps or spent <= 0:
        return None
    bound = 0.0
    for _, pos in steps:
        c = bound_at(pos)
        bound += counts.bound_s(c["bytes"], c["flops"])
    return 100.0 * bound / spent


def decode_calls_in(records, trace_host) -> list:
    """The launch records whose host time (their last field) falls in the
    traced window."""
    if trace_host is None:
        return []
    on, off = trace_host
    return [rec for rec in records if on <= rec[-1] <= off]
