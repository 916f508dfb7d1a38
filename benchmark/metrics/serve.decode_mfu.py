"""The served decode's share of the card's bf16 peak: the useful operations
of the decode calls launched in the traced window (the rows actually served,
each with its encoder pass and its tokens through its end) over the device's
busy time in that window. Moves ``serve_p50_ms``."""

from benchlib import counts
from benchlib.readings import decode_calls_in
from reference.checks import greedy_length


def read(ctx, out):
    trace = out.trace
    calls = decode_calls_in(out.records["launches"], out.records["trace_host"])
    if trace is None or not calls or trace.busy_s() <= 0:
        return None
    d = ctx.dims
    flops = 0.0
    for keys, tokens, _ in calls:
        host = tokens.cpu().numpy()
        flops += sum(counts.greedy_row_flops(d, d["max_frames"], greedy_length(host[r]))
                     for r in range(len(keys)))
    return 100.0 * flops / trace.busy_s() / counts.PEAK_FLOPS["bfloat16"]
