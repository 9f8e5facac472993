"""Mean host time of the window's ``next()`` calls on the port's
``PrefetchIterator``: how long a step waited for its batch."""

LAYER = "host data"
UNIT = "ms"
MOVES = "train_chunks_per_s"
SOURCE = "host_clock"


def read(run):
    waits = [u["wait_s"] for u in run.units if "wait_s" in u]
    return 1e3 * sum(waits) / len(waits) if waits else None
