"""The LFM2 train step's share of the card's bf16 peak: the model operations
of the window's steps (forward and backward of the MME encoder, the
projector, the LM's layers with each token's experts counted as routed, 4 of
32, and the tied head; ``benchlib.lfm2.train_step_flops``) over the window's
seconds before the recording started. Moves ``train_samples_per_s``."""

from benchlib import counts, lfm2


def read(ctx, out):
    r = out.records
    if r.get("window_s", 0) <= 0 or r.get("steps", 0) <= 0:
        return None
    d = lfm2.dims_of(ctx.cell.config)
    flops = r["steps"] * lfm2.train_step_flops(d, r["batch"])
    return 100.0 * flops / r["window_s"] / counts.PEAK_FLOPS["bfloat16"]
