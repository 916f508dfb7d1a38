"""% of the traced window in which no operation ran on the card, from the
profiler's timeline of the window itself. Moves ``eval_captions_per_s``."""

from benchlib.readings import idle_share


def read(ctx, out):
    return idle_share(out.trace)
