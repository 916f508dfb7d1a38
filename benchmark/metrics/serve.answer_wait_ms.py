"""The median time from a request's batch's close to its answer: the
handler's wait (``serve.await``) less its queue wait (``serve.queue``), by
request id, over the requests whose handler began in the window's second
half. It holds the decode call, the wait while the batch is in flight and
``_finish``. Moves ``serve_captions_per_s``."""

from benchlib.program_spans import request_median


def read(ctx, out):
    return request_median(ctx, out, lambda t: t["await"] - t["queue"])
