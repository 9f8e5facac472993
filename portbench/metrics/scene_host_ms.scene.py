"""Mean of a scene's wall time less its forwards' time (each forward timed
through ``predict_scene``'s ``forward_fn`` up to a synchronize, in traced
runs only): chunk building and view selection, accumulation, the read-back
and NN fill."""

LAYER = "scene evaluator"
UNIT = "ms"
MOVES = "scenes_per_hour"
SOURCE = "host_clock"


def read(run):
    rows = [u["scene_s"] - u["forward_s"] for u in run.units if "forward_s" in u]
    return 1e3 * sum(rows) / len(rows) if rows else None
