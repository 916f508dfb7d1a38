#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vct_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The cell's driver makes the weights and inputs from ``--seed``, sets up
and warms the program, measures for ``--seconds``, then checks what the
timed path produced against the plain reference (``benchmark/reference``).
The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, holds each number compared beside
its limit, which the last lines on standard error repeat.

Exit codes: 0 a result was printed; 2 bad arguments; 3 no CUDA card, or fewer
than the cell asks for; 4 the program (``vct_tpu_torch``) is not in the
checkout; 5 the JAX package or JAX was loaded. No result is printed unless 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vct_tpu")


def forbidden_loaded() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: ``vct_tpu_torch`` is not ``vct_tpu``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc build lives in ``vct_tpu_torch/_build``)."""
    base = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device, t_process: float):
    """Drive ``cell`` once on ``device`` -> (context, outcome, result dict)."""
    from benchlib import cells as cells_mod
    from benchlib.context import Context
    from benchlib.weights import dims_of

    tmp = tempfile.mkdtemp(prefix="bench-run-")
    try:
        ctx = Context(cell, int(seed), float(seconds), bool(trace), device, tmp, t_process,
                      dims_of(cell.config))
        out = cells_mod.driver(cell).run(ctx)
        return ctx, out, assemble(ctx, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def assemble(ctx, out) -> dict:
    """The result line's object (``checks`` last)."""
    from benchlib import cells as cells_mod

    cell = ctx.cell
    limits = cell.limits
    checks = {}
    for name, value in out.checks.items():
        if name not in limits:
            raise KeyError(f"{cell.name}: no limit for the check {name!r} in its file")
        checks[name] = {"value": value, "limit": limits[name]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if ctx.trace:
        for m in cell.per_layer:
            value = cells_mod.metric_reader(m["name"]).read(ctx, out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.e2e[m["name"]], "unit": m["unit"]}
    import torch

    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                       else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(out.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics, "device": device}
    if ctx.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s()
        device["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = checks
    return result


def trace_summary(trace) -> str:
    """One line on the traced window: its length, busy time, and the most
    launched device operations by name."""
    from collections import Counter

    from benchlib.readings import ident

    names = Counter(ident(op[0]) for op in trace.ops)
    top = ", ".join(f"{n} x{c}" for n, c in names.most_common(25))
    return (f"traced window: {trace.window_s:.3f} s, busy {trace.busy_s():.3f} s, "
            f"{len(trace.ops)} device operations, {len(trace.spans)} host spans; {top}")


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, HERE)
    cache_dirs(ROOT)
    from benchlib.cells import load_cell

    cell = load_cell(args.workload)
    sys.path.insert(0, ROOT)
    import importlib.util

    if importlib.util.find_spec("vct_tpu_torch") is None:
        print(f"no vct_tpu_torch package under {ROOT}: nothing to measure", file=sys.stderr)
        return 4
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 3
    _, out, result = run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                           device=torch.device("cuda", 0), t_process=T_PROCESS)
    loaded = forbidden_loaded()
    if loaded:
        print(f"loaded in the measuring process: {', '.join(loaded)}", file=sys.stderr)
        return 5
    for line in out.lines:
        print(line, flush=True)
    if out.trace is not None:
        print(trace_summary(out.trace), flush=True)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
