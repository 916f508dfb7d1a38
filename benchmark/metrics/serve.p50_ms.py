"""The median serving latency, from due to answer, over every request due in
the window's second half (the first holds a traced run's profiler start; a
request never answered counts as the client's time limit). Moves
``serve_captions_per_s``: a server whose every request takes longer keeps
up with the offered rate only while its queue does not grow."""


def read(ctx, out):
    return out.records.get("p50_ms")
