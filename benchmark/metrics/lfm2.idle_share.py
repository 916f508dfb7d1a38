"""% of the LFM2 training cell's traced window in which no operation ran on
the card, from the profiler's timeline of the window itself. Moves
``train_samples_per_s``."""

from benchlib.readings import idle_share


def read(ctx, out):
    return idle_share(out.trace)
