"""Served captions: open-loop Poisson requests to ``vct_tpu_torch.serve`` over
HTTP on localhost.

Set-up makes the weights on the card, writes them as the reference-format
checkpoint the server loads, starts ``serve.serve(...)`` (which warms its
decode at ``max_batch`` rows) and sends warm-up requests. The load generator
(``benchlib/loadgen.py``) runs in a child process that dies with the run.
The window is the schedule's ``seconds``: every request due in it is timed
from when it was due until its caption arrived. Afterwards the served
tokens of a sample of the requests (the longest among them) are judged by
the float32 reference, teacher-forced on them.
"""

from __future__ import annotations

import ctypes
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List

import numpy as np

from benchlib import data, trace
from benchlib.context import Context, Outcome, release
from benchlib.hoststats import HostWatch, percentile, segments

LOADGEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "benchlib", "loadgen.py")


def _die_with_parent() -> None:
    libc = ctypes.CDLL("libc.so.6", use_errno=True)
    libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG


class LaunchLog:
    """The benchmark's span around the batcher's call into the decode: keeps
    each launch's token tensor (the decode's own result) with a key of its
    requests' features, to judge the served tokens after the window."""

    def __init__(self, service, spans: trace.Spans):
        self.launches: List[tuple] = []
        self._inner, self._finish = service._launch, service._finish
        self.spans = spans
        self.recorder = None  # polled here, on the batcher's thread, which launches the work
        service._launch = self.launch
        if spans.enabled:
            service._finish = self.finish

    def launch(self, batch):
        if self.recorder is not None:
            self.recorder.poll()
        with self.spans("bench.batcher.launch"):
            tokens = self._inner(batch)
        self.launches.append(([r.feats[0][0, :4].tobytes() for r in batch], tokens,
                              time.perf_counter()))
        return tokens

    def finish(self, batch, tokens, n):
        with self.spans("bench.batcher.finish"):
            return self._finish(batch, tokens, n)


def _start_generator(ctx: Context, port: int, rate: float) -> subprocess.Popen:
    t = ctx.traffic
    args = {"seed": ctx.seed, "rate": rate, "seconds": ctx.seconds, "frames": t["frames"],
            "dim": ctx.dims["feat_dim"], "threads": int(t["threads"]), "host": "127.0.0.1",
            "port": port, "timeout": float(t["timeout_s"]),
            "out": os.path.join(ctx.tmp, "loadgen.jsonl")}
    proc = subprocess.Popen([sys.executable, LOADGEN, json.dumps(args)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, preexec_fn=_die_with_parent)
    if proc.stdout.readline().strip() != "ready":
        proc.kill()
        proc.wait()
        raise RuntimeError("the load generator failed to start")
    return proc


def _collect(ctx: Context, proc, deadline_s: float) -> List[Dict]:
    try:
        proc.wait(timeout=max(1.0, deadline_s - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError("the load generator outlived the run's time")
    with open(os.path.join(ctx.tmp, "loadgen.jsonl")) as f:
        return sorted((json.loads(line) for line in f), key=lambda r: r["i"])


def warm(port: int, ctx: Context, n: int) -> None:
    """Requests of every frame count of the mix, one at a time and then
    together, before the window (the server's handler and batcher paths)."""
    from benchlib.loadgen import post, request_features

    lo, hi = ctx.traffic["frames"]
    bodies = [data.request_body(request_features(ctx.seed ^ 0x5EED, 10 ** 7 + i,
                                                 lo + i % (hi - lo + 1), ctx.dims["feat_dim"]))
              for i in range(n)]
    for b in bodies[:8]:
        post("127.0.0.1", port, b, 60.0)
    threads = [threading.Thread(target=post, args=("127.0.0.1", port, b, 60.0)) for b in bodies]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def serve_window(ctx: Context, service, port: int, rate: float, recorder=None) -> dict:
    """One window at ``rate`` requests/s -> the generator's rows and the
    server's counters before and after. A recorder is started and stopped
    by the batcher's thread (``LaunchLog``), at its launches."""
    proc = _start_generator(ctx, port, rate)
    try:
        before = dict(service.stats)
        start = time.monotonic() + 0.05
        t0 = time.perf_counter() + 0.05
        proc.stdin.write(f"{start!r}\n")
        proc.stdin.flush()
        if recorder is not None:
            recorder.begin(t0)
        rows = _collect(ctx, proc, start + ctx.seconds + ctx.traffic["timeout_s"] + 60)
        after = dict(service.stats)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"rows": rows, "before": before, "after": after}


def summarize(rows: List[Dict], seconds: float, timeout_s: float) -> Dict[str, float]:
    """Latency from due to answer (a request never answered counts as the
    client's time limit, past any latency), lateness of the generator, and
    the completed rate."""
    lat = [(r["done"] - r["due"]) * 1e3 if r["status"] == 200 else timeout_s * 1e3
           for r in rows]
    late = [(r["sent"] - r["due"]) * 1e3 for r in rows]
    ok = [r for r in rows if r["status"] == 200]
    start = min(r["due"] for r in rows) if rows else 0.0
    last = max((r["done"] for r in ok), default=start)
    return {"requests": len(rows), "answered": len(ok),
            "p50_ms": percentile(lat, 0.5), "p90_ms": percentile(lat, 0.9),
            "p95_ms": percentile(lat, 0.95), "p99_ms": percentile(lat, 0.99),
            "max_ms": max(lat, default=float("nan")),
            "late_p50_ms": percentile(late, 0.5), "late_p99_ms": percentile(late, 0.99),
            "late_max_ms": max(late, default=0.0),
            "completed_per_s": len(ok) / max(last - start, seconds)}


def by_due(rows: List[Dict], timeout_s: float, seconds: float) -> List[List[float]]:
    """Latencies (ms, as ``summarize`` counts them) in windows of 5 s of
    their due times."""
    start = min((r["due"] for r in rows), default=0.0)
    lat = [(r["done"] - r["due"]) * 1e3 if r["status"] == 200 else timeout_s * 1e3
           for r in rows]
    return segments([r["due"] for r in rows], lat, start, seconds)


def run(ctx: Context) -> Outcome:
    import torch

    from benchlib.weights import make_weights

    t = ctx.traffic
    vocab_path = os.path.join(ctx.tmp, "vocab.txt")
    data.write_vocab(vocab_path, ctx.dims["vocab"])
    weights = make_weights(ctx.dims, ctx.seed, ctx.device)
    ckpt = os.path.join(ctx.tmp, "weights.pth")
    torch.save({k: v.cpu() for k, v in weights.items()}, ckpt)
    del weights

    from vct_tpu_torch.config import Config
    from vct_tpu_torch.serve import serve

    cfg = Config.from_dict(ctx.program_config(vocab_path))
    server = serve(cfg, ckpt, device=ctx.device, host="127.0.0.1", port=0,
                   max_batch=int(t["max_batch"]), batch_timeout_ms=float(t["batch_timeout_ms"]),
                   log=lambda *_: None)
    os.remove(ckpt)
    service = server.service
    spans = trace.Spans(ctx.trace)
    launches = LaunchLog(service, spans)
    th = threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                          daemon=True)
    th.start()
    port = server.server_address[1]
    try:
        warm(port, ctx, int(t["warm_requests"]))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        launches.launches.clear()
        recorder = None
        if ctx.trace:
            trace.Recorder.warm()
            recorder = launches.recorder = trace.Recorder(
                ctx.tmp, float(t["trace_start_s"]), float(t["trace_seconds"]), spans)
        setup_s = time.perf_counter() - ctx.t_process
        with HostWatch() as host:
            win = serve_window(ctx, service, port, float(t["rate_per_s"]), recorder)
        if recorder is not None:
            recorder.finish()
        peak = (torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    rows = win["rows"]
    s = summarize(rows, ctx.seconds, float(t["timeout_s"]))
    lines = (f"serve window: {s['requests']} requests due in {ctx.seconds} s at "
             f"{t['rate_per_s']}/s, {s['answered']} answered, completed {s['completed_per_s']:.1f}/s, "
             f"p50 {s['p50_ms']:.2f} ms, p90 {s['p90_ms']:.2f}, p95 {s['p95_ms']:.2f}, "
             f"p99 {s['p99_ms']:.2f}, max {s['max_ms']:.2f}; generator late p50 "
             f"{s['late_p50_ms']:.3f} ms, p99 {s['late_p99_ms']:.3f} ms, max {s['late_max_ms']:.3f} ms",
             "serve window by 5 s of due times, p50 / p95 / max ms: " + "; ".join(
                 f"{percentile(v, 0.5):.1f} / {percentile(v, 0.95):.1f} / {max(v, default=0):.1f}"
                 for v in by_due(rows, float(t["timeout_s"]), ctx.seconds)),
             host.line())
    trace_obj = recorder.result() if recorder is not None else None
    records = {"launches": launches.launches, "stats_before": win["before"],
               "stats_after": win["after"], "rows": rows,
               "trace_host": (recorder.t_on, recorder.t_off) if recorder and recorder.t_on else None}
    # the program's state goes before the reference runs
    launches._inner = launches._finish = None
    del service, server, th
    release(ctx.device)
    checks = judge(ctx, rows, launches.launches)
    # the per-layer latencies take the requests due in the window's second
    # half: in a traced run the profiler's start stalls the server for
    # about 2 s, and the queue it leaves drains within some seconds more
    half = min((r["due"] for r in rows), default=0.0) + ctx.seconds / 2
    late = summarize([r for r in rows if r["due"] >= half], ctx.seconds / 2,
                     float(t["timeout_s"]))
    records.update(p50_ms=late["p50_ms"], p95_ms=late["p95_ms"])
    return Outcome(e2e={"serve_captions_per_s": s["completed_per_s"], "setup_s": setup_s},
                   attempted=len(rows), failed=len(rows) - s["answered"], checks=checks,
                   memory_peak_bytes=peak, trace=trace_obj, records=records, lines=lines)


def judge_control(ctx: Context, out: Outcome) -> Dict[str, float]:
    """The control's readings on this run's prompts and served tokens."""
    return judge(ctx, out.records["rows"], out.records["launches"], precision="fp8")


def served_tokens(launches) -> Dict[bytes, np.ndarray]:
    """{feature key: the token row the decode produced for that request}."""
    out = {}
    for keys, tokens, _ in launches:
        host = tokens.cpu().numpy()
        for row, key in enumerate(keys):
            out[key] = host[row]
    return out


def judge(ctx: Context, rows: List[Dict], launches, precision: str = "float32") -> Dict[str, float]:
    """The numbers that decide ``correct``: requests never answered; answered
    captions that are not their served tokens' text; over a sample of them,
    the widest gap by which a served token's logit lies below the
    reference's best (``precision`` "fp8" reads the control instead: the gap
    of the token the fp8 reference puts first, on the same prompts and
    tokens)."""
    from benchlib.loadgen import request_features, schedule
    from reference import checks as ref_checks

    answered = [r for r in rows if r["status"] == 200]
    tokens_by_key = served_tokens(launches)
    _, sizes = schedule(ctx.seed, float(ctx.traffic["rate_per_s"]), ctx.seconds,
                        ctx.traffic["frames"])
    feats, toks, mismatched = [], [], 0
    for r in answered:
        f = request_features(ctx.seed, r["i"], int(sizes[r["i"]]), ctx.dims["feat_dim"])
        tok = tokens_by_key.get(f[0, :4].tobytes())
        if tok is None or data.caption_text(tok, ctx.dims["vocab"]) != r["caption"]:
            mismatched += 1
            continue
        feats.append(f)
        toks.append(tok)
    sample = ref_checks.sample_rows(ctx.seed, [ref_checks.greedy_length(t) for t in toks],
                                    int(ctx.traffic["check_requests"]))
    gap = ref_checks.greedy_gap(ctx.dims, ctx.seed, [feats[i] for i in sample],
                                [toks[i] for i in sample], ctx.device, precision)
    return {"unanswered": float(len(rows) - len(answered)),
            "caption_mismatches": float(mismatched),
            "served_logit_gap": gap}
