"""The train step's share of the card's bf16 peak: the model operations of
the steps in the window (forward and backward of encoder, decoder and LM
head at the config's shapes, ``counts.train_step_flops``) over the window's
seconds. Moves ``train_samples_per_s``."""

from benchlib import counts


def read(ctx, out):
    r, d = out.records, ctx.dims
    if r["window_s"] <= 0 or r["steps"] <= 0:
        return None
    flops = r["steps"] * counts.train_step_flops(d, r["batch"], d["max_frames"],
                                                 d["max_caption_len"])
    return 100.0 * flops / r["window_s"] / counts.PEAK_FLOPS["bfloat16"]
