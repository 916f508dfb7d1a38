"""The eval decode's share of the card's bf16 peak: the useful operations of
the beam calls launched in the traced window (each real video's encoder
pass and its beams' steps through its chosen caption's end) over the
device's busy time there. Moves ``eval_captions_per_s``."""

from benchlib import counts
from benchlib.readings import decode_calls_in
from reference.checks import greedy_length


def read(ctx, out):
    trace = out.trace
    calls = decode_calls_in(out.records["launches"], out.records["trace_host"])
    if trace is None or not calls or trace.busy_s() <= 0:
        return None
    d, beam = ctx.dims, out.records["beam"]
    t_mem = d["max_frames"] + 1
    front = counts.encoder_flops(d, 1, d["max_frames"]) + 4.0 * t_mem * d["embed_dim"] ** 2 * d["decoder_layers"]
    flops = 0.0
    for n_valid, tokens, _ in calls:
        host = tokens.cpu().numpy()
        for r in range(n_valid):
            flops += front + beam * sum(counts.stack_step(d, 1, p, t_mem)["flops"]
                                        + counts.head_step(d, 1)["flops"]
                                        for p in range(greedy_length(host[r])))
    return 100.0 * flops / trace.busy_s() / counts.PEAK_FLOPS["bfloat16"]
