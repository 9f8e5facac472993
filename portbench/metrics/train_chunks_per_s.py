"""Every chunk of every optimizer step completed in the window, over the
whole window (the data wait included)."""

LAYER = "end to end"
UNIT = "chunks/s"
MOVES = None
SOURCE = "host_clock"


def read(run):
    if not run.units or "chunks" not in run.units[0]:
        return None
    return sum(u["chunks"] for u in run.units) / run.window_s
