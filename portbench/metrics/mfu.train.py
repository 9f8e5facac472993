"""Model FLOPs of the window's optimizer steps (``counts.train_step_flops``:
convolutions and linear layers, forward and backward as 3x the forward) over
the window's seconds and the published bf16 dense peak of one H100."""
from portbench import counts

LAYER = "model step"
UNIT = "%"
MOVES = "train_chunks_per_s"
SOURCE = "host_clock"


def read(run):
    steps = sum(1 for u in run.units if "step_s" in u)
    if not steps:
        return None
    return 100.0 * steps * counts.train_step_flops(run.cfg) / run.window_s / counts.BF16_DENSE_FLOPS
