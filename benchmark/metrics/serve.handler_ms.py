"""The median of the handler's own host time: its ``serve.request`` span
less its wait for the answer (``serve.await``), by request id (reading the
body, ``np.load``, orienting, the reply), over the requests whose handler
began in the window's second half. Moves ``serve_captions_per_s``."""

from benchlib.program_spans import request_median


def read(ctx, out):
    return request_median(ctx, out, lambda t: t["request"] - t["await"])
