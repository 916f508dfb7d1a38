"""Rows a served decode carries: requests answered over decode launches in
the window, from the server's own counters (``CaptionService.stats``).
Moves ``serve_p50_ms``: fuller batches mean fewer launches a request, and a
longer wait to fill them."""


def read(ctx, out):
    before, after = out.records["stats_before"], out.records["stats_after"]
    batches = after["batches"] - before["batches"]
    return None if batches <= 0 else (after["requests"] - before["requests"]) / batches
