"""Scenes fully labelled in the window (``predict_scene`` returned, the
uncovered points filled) times 3600, over the whole window."""

LAYER = "end to end"
UNIT = "scenes/h"
MOVES = None
SOURCE = "host_clock"


def read(run):
    if not run.units or "scene_s" not in run.units[0]:
        return None
    return len(run.units) * 3600.0 / run.window_s
