"""The 95th percentile of serving latency, from due to answer, over every
request due in the window's second half (the first holds a traced run's
profiler start; a request never answered counts as the client's time
limit). Moves ``serve_captions_per_s``: the tail grows first where the front
end and batcher fall behind, before the completed rate drops."""


def read(ctx, out):
    return out.records.get("p95_ms")
