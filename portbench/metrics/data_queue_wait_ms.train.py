"""Mean time a step's ``next()`` on the port's ``PrefetchIterator`` spent
blocked on an empty queue: the program's ``data.queue_wait`` spans inside the
traced window over its count of ``data.next`` spans
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
    spans = tracing.spans(run.trace.start, run.trace.end)
    steps = sum(s.name == "data.next" for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s.seconds for s in spans if s.name == "data.queue_wait") / steps
