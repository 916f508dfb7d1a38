"""The median, over the decode runner's calls (``graph.run`` spans) in the
traced window, of the card's idle ms inside the call's span: the copy into
the static buffers, and at each stage boundary the host's read of
``all_done`` (``graph.sync``) and the next replay's enqueue. Moves
``serve_captions_per_s``."""

from benchlib.program_spans import decode_idle_ms


def read(ctx, out):
    return decode_idle_ms(out)
