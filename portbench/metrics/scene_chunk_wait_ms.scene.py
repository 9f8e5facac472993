"""Time a scene's ``predict_scene`` waited for its chunk samples (blocked on
the pool's next future, or building inline without a pool): the program's
``scene.chunk_wait`` spans inside the traced window over its count of
``scene.predict`` spans (``mvpnet_torch/tracing.py``). None without a trace or
without the spans."""

LAYER = "scene evaluator"
UNIT = "ms"
MOVES = "scenes_per_hour"
SOURCE = "program_counter"


def read(run):
    if run.trace is None:
        return None
    try:
        from mvpnet_torch import tracing
    except ImportError:  # a program without spans
        return None
    spans = tracing.spans(run.trace.start, run.trace.end)
    scenes = sum(s.name == "scene.predict" for s in spans)
    if not scenes:
        return None
    return 1e3 * sum(s.seconds for s in spans if s.name == "scene.chunk_wait") / scenes
