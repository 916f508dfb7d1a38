"""% of the traced window in which no operation ran on the card while the
batcher held a batch (a ``serve.batch`` span open, from the batch's close
until its decode is launched): idle that the host causes with work in hand.
``serve.idle_share`` less this is the card waiting for requests. Moves
``serve_captions_per_s``."""

from benchlib.program_spans import stall_share


def read(ctx, out):
    return stall_share(out, "serve.batch")
