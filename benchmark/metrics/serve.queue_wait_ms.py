"""The median wait in the server's queue, from a request's enqueue to its
batch's close (the program's ``serve.queue`` span), over the requests whose
handler began in the window's second half (the half ``serve.p50_ms``
reads). Moves ``serve_captions_per_s``: a request waits for the batcher to
come back from the previous batch and for its batching window."""

from benchlib.program_spans import request_median


def read(ctx, out):
    return request_median(ctx, out, lambda t: t["queue"])
