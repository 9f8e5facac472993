"""Spans and counters inside the port, recorded while a ``torch.profiler`` records.

The switch is the profiler: ``span(name)`` records only while a
``torch.profiler`` (or the autograd profiler) is recording in this process,
which ``torch.autograd.profiler._is_profiler_enabled`` says, and never while
``torch.compile`` or ``torch.export`` traces. Otherwise it returns one shared
no-op context manager, so an unprofiled run pays one flag check a span and
allocates nothing.

A recorded span keeps its name, its thread, its parent (the innermost span
open on its thread, or the one passed as ``parent``, which carries a span
over to a worker thread) and its root, the outermost span of the request
(one ``train.step`` or ``data.next``, one ``scene.predict``), with its start
and end in ``time.time_ns()``: the clock of the profiler's own event
timestamps, so a span lies on the device trace's time axis. Each span also
opens a ``torch.profiler.record_function`` of its name, so an exported chrome
trace shows the spans beside the kernels. Finished spans are appended to one
list in memory; ``spans(start_s, end_s)`` returns those inside a window.

Counters: ``counters()`` gives each span name's count;
``knn_fusion.pairs_scanned``, the (query, ref) pairs the fusion kNN's
kernels scanned while recording, a one-element int64 tensor on the queries'
device (``pairs_counter``) that the kernels add to, read with ``.item()``
only when ``counters()`` is called; and the host counters that ``count``
adds to while recording: ``scene.nn_fill_points``, the points
``predict_scene`` and ``predict_scene_fused`` filled from their nearest
scored point.

The spans, by where the work happens:
  data.next > data.queue_wait, data.transfer   PrefetchIterator.__next__
  data.build, data.put_wait                    PrefetchIterator's workers
  data.view_select                             make_chunk_sample
  train.step > train.prepare, train.forward,   make_train_step's step
    train.backward (a microbatch each), train.optimizer
  model.net_2d, model.fusion_knn,              MVPNet3D.forward
    model.aggregation, model.net_3d
  scene.predict > scene.windows, scene.chunk_wait, scene.transfer,
    scene.forward, scene.accumulate, scene.nn_fill, scene.readback
                                               predict_scene
  scene.chunk_build                            predict_scene's pool, under
                                               the submitting scene.predict
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

PAIRS_SCANNED = "knn_fusion.pairs_scanned"

_NOOP = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_spans: list = []
_pairs: dict = {}  # device -> one-element int64 counter
_counts: Counter = Counter()  # host counters, by name
_counts_lock = threading.Lock()


class Span(NamedTuple):
    """A finished span. ``parent`` is None for a root, whose ``root`` is its
    own ``id``; ``thread`` is ``threading.get_ident()``."""

    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def recording() -> bool:
    """Whether a profiler records in this process (and no compiler traces)."""
    return _profiler._is_profiler_enabled and not torch.compiler.is_compiling()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded; ``id`` and ``root`` are what a child needs."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "_range")

    def __init__(self, name: str, parent):
        self.name = name
        self.id = next(_ids)
        self.parent = parent

    def __enter__(self):
        stack = _stack()
        parent = self.parent if self.parent is not None else (stack[-1] if stack else None)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        stack.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self._range.__exit__(*exc)
        _stack().pop()
        _spans.append(Span(self.name, self.id, self.parent, self.root, threading.get_ident(), self.start_ns, end_ns))
        return False


def span(name: str, parent=None):
    """A context manager that records the span ``name`` while a profiler
    records (the shared no-op otherwise). ``parent``, a span that
    ``current()`` returned on another thread, makes this span its child."""
    if not recording():
        return _NOOP
    return _Open(name, parent)


def current():
    """The innermost span open on this thread (None when none is, or when
    nothing records): pass it as ``parent`` to a span on another thread."""
    if not recording():
        return None
    stack = _stack()
    return stack[-1] if stack else None


def spans(start_s: float | None = None, end_s: float | None = None) -> list[Span]:
    """The finished spans that start at or after ``start_s`` and end at or
    before ``end_s`` (seconds of ``time.time_ns()``), in the order they ended."""
    lo = -1 if start_s is None else start_s * 1e9
    hi = float("inf") if end_s is None else end_s * 1e9
    return [s for s in list(_spans) if s.start_ns >= lo and s.end_ns <= hi]


def pairs_counter(device) -> torch.Tensor | None:
    """The ``knn_fusion.pairs_scanned`` counter on ``device`` while
    recording, else None; the fusion kNN passes it to its kernels."""
    if not recording():
        return None
    device = torch.device(device)
    counter = _pairs.get(device)
    if counter is None:
        counter = _pairs[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return counter


def count(name: str, n: int) -> None:
    """Add ``n`` to the host counter ``name`` while recording."""
    if recording():
        with _counts_lock:
            _counts[name] += n


def counters() -> dict[str, int]:
    """Each span name's count over every recorded span, each host counter
    that ``count`` added to, and ``knn_fusion.pairs_scanned`` (waits for the
    devices that hold it)."""
    out = dict(Counter(s.name for s in list(_spans)))
    with _counts_lock:
        out.update(_counts)
    out[PAIRS_SCANNED] = sum(int(c.item()) for c in list(_pairs.values()))
    return out


def clear() -> None:
    """Forget every recorded span and zero the counters."""
    _spans.clear()
    with _counts_lock:
        _counts.clear()
    for counter in _pairs.values():
        counter.zero_()
