"""% of the traced window in which no operation ran on the card, from the
profiler's timeline of the window itself. Moves ``serve_p50_ms``."""

from benchlib.readings import idle_share


def read(ctx, out):
    return idle_share(out.trace)
