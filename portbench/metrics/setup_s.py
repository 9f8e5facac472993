"""Process start to the first timed unit: imports, the scenes, the model
and its weights, the kernels' build or load, the warm-up units."""

LAYER = "end to end"
UNIT = "s"
MOVES = None
SOURCE = "host_clock"


def read(run):
    return run.setup_s
