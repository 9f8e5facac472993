"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start."""

LAYER = "device"
UNIT = "GiB"
MOVES = "train_chunks_per_s"
SOURCE = "program_counter"


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
