"""Mean time a ``PrefetchIterator`` worker thread took to build one batch
(``train.batch_size`` chunks, their points and views): the program's
``data.build`` spans that lie inside the traced window
(``mvpnet_torch/tracing.py``). None without a trace or without the spans."""

LAYER = "host data"
UNIT = "ms"
MOVES = "train_chunks_per_s"
SOURCE = "program_counter"


def read(run):
    if run.trace is None:
        return None
    try:
        from mvpnet_torch import tracing
    except ImportError:  # a program without spans
        return None
    builds = [s.seconds for s in tracing.spans(run.trace.start, run.trace.end) if s.name == "data.build"]
    return 1e3 * sum(builds) / len(builds) if builds else None
