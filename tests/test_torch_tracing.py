"""The port's spans and counters (mvpnet_torch.tracing), on the CPU.

Off (no profiler records): ``span`` is one shared no-op and nothing is kept.
On, under a CPU ``torch.profiler``: spans nest, carry their thread and their
root over to worker threads, lie on the profiler's own clock, and the
program's layers (the data path, the train step, the model, the whole-scene
evaluator) record the spans ``tracing``'s docstring lists, without changing
a single result.
"""
from __future__ import annotations

import contextlib
import math
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvpnet_torch import ops, tracing
from mvpnet_torch.config import load_config
from mvpnet_torch.data import pipeline
from mvpnet_torch.data.synthetic import make_scene
from mvpnet_torch.entry import TRAIN_CONFIG
from mvpnet_torch.eval import whole_scene
from mvpnet_torch.models import build_model
from mvpnet_torch.train.solver import build_optimizer
from mvpnet_torch.train.step import make_train_step

TINY = [
    "data.name=synthetic", "data.num_points=256", "data.image_height=24", "data.image_width=32",
    "data.num_views_train=2", "data.num_views_eval=2", "data.max_candidate_frames=4", "data.num_workers=2",
    "data.num_classes=5", "data.chunk_size=2.0", "data.chunk_stride=1.5",
    "model.unet.num_classes=5", "model.unet.base_channels=8", "model.unet.stage_channels=[8,16,16,32]",
    "model.unet.stage_blocks=[1,1,1,1]", "model.unet.decoder_channels=[16,16,8,8]", "model.unet.feature_channels=8",
    "model.unet.dtype=float32", "model.aggregation.mlp_channels=[8,8]", "model.pn2.num_classes=5",
    "model.pn2.in_channels=8", "model.pn2.dtype=float32", "model.pn2.head_channels=16", "model.pn2.dropout=0.0",
    "model.pn2.sa=[{npoint: 32, radius: 0.2, nsample: 8, mlp_channels: [16,16]}, {npoint: 8, radius: 0.4, nsample: 8, mlp_channels: [16,32]}]",
    "model.pn2.fp_channels=[[32],[32,16]]", "train.batch_size=4", "eval.batch_size=2",
]
SCENE = dict(num_points=6000, num_frames=6, height=24, width=32, num_classes=5)
SCENE_SPANS = ("scene.predict", "scene.windows", "scene.chunk_wait", "scene.transfer", "scene.forward",
               "scene.accumulate", "scene.readback", "scene.nn_fill", "scene.chunk_build")
MODEL_SPANS = ("model.net_2d", "model.fusion_knn", "model.aggregation", "model.net_3d")


def tiny_cfg(*extra):
    return load_config(TRAIN_CONFIG, TINY + list(extra))


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def recorded():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans):
    out: dict = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def fusion_search(recording: bool):
    """A fusion-size kNN (>= 2^15 refs, >= 256 queries) on the CPU, with or
    without a profiler recording."""
    g = torch.Generator().manual_seed(0)
    q, r = torch.rand(1, 256, 3, generator=g), torch.rand(1, 1 << 15, 3, generator=g)
    if not recording:
        return ops.knn(q, r, 3)
    with recorded():
        return ops.knn(q, r, 3)


def test_off_a_span_is_the_shared_noop_and_nothing_is_kept():
    assert not tracing.recording()
    assert tracing.span("a") is tracing.span("b") is tracing._NOOP
    with tracing.span("a"):
        assert tracing.current() is None
    assert tracing.spans() == [] and tracing.pairs_counter("cpu") is None
    assert tracing.counters() == {tracing.PAIRS_SCANNED: 0}


@pytest.mark.parametrize("recording", [False, True])
def test_a_cpu_knn_leaves_the_pair_counter_alone(recording):
    d, _ = fusion_search(recording)
    assert d.shape == (1, 256, 3)
    assert tracing.counters()[tracing.PAIRS_SCANNED] == 0


def test_a_span_is_a_noop_while_a_compiler_traces(monkeypatch):
    with recorded():
        assert tracing.recording()
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert tracing.span("x") is tracing._NOOP and tracing.pairs_counter("cpu") is None
    assert tracing.spans() == []


def test_nesting_gives_each_span_its_parent_and_root():
    with recorded():
        with tracing.span("outer") as outer:
            with tracing.span("middle") as middle:
                assert tracing.current() is middle
                with tracing.span("inner"):
                    pass
            with tracing.span("second"):
                pass
        with tracing.span("next_root"):
            pass
    s = {x.name: x for x in tracing.spans()}
    assert s["outer"].parent is None and s["outer"].root == outer.id == s["outer"].id
    assert s["middle"].parent == outer.id and s["inner"].parent == middle.id
    assert s["second"].parent == outer.id
    assert {s[n].root for n in ("middle", "inner", "second")} == {outer.id}
    assert s["next_root"].parent is None and s["next_root"].root == s["next_root"].id
    assert s["outer"].start_ns <= s["middle"].start_ns <= s["inner"].start_ns <= s["inner"].end_ns
    assert s["inner"].end_ns <= s["middle"].end_ns <= s["second"].start_ns <= s["outer"].end_ns
    assert [x.name for x in tracing.spans()][-1] == "next_root"
    assert tracing.counters()["outer"] == 1


def test_a_worker_threads_spans_carry_their_thread_and_the_submitters_root():
    got = {}

    def work(parent):
        with tracing.span("carried", parent):
            with tracing.span("below"):
                pass
        with tracing.span("own_root"):
            pass
        got["thread"] = threading.get_ident()

    with recorded():
        with tracing.span("request") as request:
            t = threading.Thread(target=work, args=(tracing.current(),))
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    s = {x.name: x for x in tracing.spans()}
    assert s["request"].thread == threading.get_ident() != got["thread"]
    assert s["carried"].thread == s["below"].thread == s["own_root"].thread == got["thread"]
    assert s["carried"].parent == request.id and s["carried"].root == request.id
    assert s["below"].parent == s["carried"].id and s["below"].root == request.id
    assert s["own_root"].parent is None


def test_spans_lie_on_the_profilers_clock():
    """Each span's start and end within 1 ms of its record_function event."""
    names = [f"clock.{i}" for i in range(5)]
    with recorded() as prof:
        for name in names:
            with tracing.span(name):
                torch.ones(1000).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in names}
    assert set(events) == set(names)
    for s in tracing.spans():
        e = events[s.name]
        assert abs(s.start_ns - e.start_ns()) < 1e6 and abs(s.end_ns - e.end_ns()) < 1e6, s
    window = tracing.spans(events[names[1]].start_ns() / 1e9, events[names[3]].end_ns() / 1e9)
    assert [s.name for s in window] == names[1:4]


def test_spans_from_many_threads_are_all_kept():
    """More threads than cores, a short switch interval: every span is kept
    once, with its parent on its own thread."""
    threads, per = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with tracing.span("stress.outer"):
                    with tracing.span("stress.inner"):
                        pass

        with recorded():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    spans = tracing.spans()
    assert len(spans) == 2 * threads * per and len({s.id for s in spans}) == len(spans)
    outer = {s.id: s.thread for s in spans if s.name == "stress.outer"}
    assert all(outer[s.parent] == s.thread for s in spans if s.name == "stress.inner")
    assert tracing.counters()["stress.inner"] == threads * per


@pytest.fixture(scope="module")
def scene_model():
    cfg = tiny_cfg()
    model, _, _ = build_model(cfg, seed=0)
    return cfg, model.eval(), make_scene(3, **SCENE)


@pytest.mark.parametrize("workers", [0, 2])
def test_predict_scene_records_every_scene_span(scene_model, workers):
    cfg, model, scene = scene_model
    windows = len(whole_scene.scene_windows(scene, cfg))
    assert windows > cfg.eval.batch_size
    with recorded():
        whole_scene.predict_scene(model, cfg, scene, batch_size=cfg.eval.batch_size, num_workers=workers)
    s = by_name(tracing.spans())
    assert set(SCENE_SPANS) <= set(s)
    (predict,) = s["scene.predict"]
    assert len(s["scene.forward"]) == math.ceil(windows / cfg.eval.batch_size) == len(s["model.net_3d"])
    assert len(s["scene.chunk_build"]) == windows == len(s["data.view_select"])
    assert len(s["scene.chunk_wait"]) == windows + 1  # the last wait finds the end
    assert all(x.root == predict.id for x in s["scene.chunk_build"] + s["data.view_select"])
    builders = {x.thread for x in s["scene.chunk_build"]}
    assert (builders == {predict.thread}) == (workers == 0)
    assert all(x.root == predict.id for n in SCENE_SPANS + MODEL_SPANS for x in s[n])


def test_prefetch_records_one_data_next_a_batch_and_builds_on_the_workers(scene_model):
    cfg, _, scene = scene_model
    ds = pipeline.ChunkDataset([scene], cfg.data, batch_size=2, training=True, seed=1)
    it = pipeline.PrefetchIterator(ds, prefetch=2, num_threads=2)
    try:
        with recorded():
            for _ in range(3):
                next(it)
            # keep recording until a worker has built a whole batch inside
            # the window: the three batches may all have been built before it
            deadline = time.monotonic() + 60
            while not any(x.name == "data.build" for x in tracing.spans()) and time.monotonic() < deadline:
                time.sleep(0.01)
    finally:
        it.close()
    s = by_name(tracing.spans())
    main = threading.get_ident()
    assert len(s["data.next"]) == 3 and all(x.thread == main and x.parent is None for x in s["data.next"])
    assert s["data.build"] and all(x.thread != main and x.parent is None for x in s["data.build"])
    builds = {x.id for x in s["data.build"]}
    # a build already running when the profiler started left its view
    # selections roots
    nested = [x for x in s["data.view_select"] if x.parent is not None]
    assert nested and all(x.parent in builds for x in nested)
    below = s.get("data.queue_wait", []) + s.get("data.transfer", [])
    assert below and all(x.root in {n.id for n in s["data.next"]} for x in below)


def _train(cfg, seed=0):
    model, loss_fn, metric_fn = build_model(cfg, seed=seed)
    model.train()
    return model, build_optimizer(cfg.solver, list(model.parameters())), make_train_step(cfg, loss_fn, metric_fn)


def _batch(cfg, seed=2):
    ds = pipeline.ChunkDataset([make_scene(3, **SCENE)], cfg.data, batch_size=cfg.train.batch_size, training=True,
                               seed=seed)
    return {k: torch.from_numpy(v) for k, v in next(iter(ds)).items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_a_train_step_records_each_microbatch_and_one_optimizer_update(accum):
    cfg = tiny_cfg(f"train.grad_accum={accum}")
    model, optimizer, step = _train(cfg)
    batch = _batch(cfg)
    with recorded():
        step(model, optimizer, batch, torch.Generator().manual_seed(0))
    s = by_name(tracing.spans())
    (root,) = s["train.step"]
    for name in ("train.prepare", "train.forward", "train.backward"):
        assert len(s[name]) == accum and all(x.parent == root.id for x in s[name])
    assert len(s["train.optimizer"]) == 1 and s["train.optimizer"][0].parent == root.id
    forwards = {x.id for x in s["train.forward"]}
    for name in MODEL_SPANS:
        assert len(s[name]) == accum and all(x.parent in forwards for x in s[name])


def test_results_are_bit_identical_with_tracing_on_and_off(scene_model):
    cfg = tiny_cfg("train.grad_accum=2")
    batch = _batch(cfg)
    runs = []
    for on in (False, True):
        model, optimizer, step = _train(cfg)
        with recorded() if on else contextlib.nullcontext():
            loss = step(model, optimizer, batch, torch.Generator().manual_seed(0))["loss"]
        runs.append((loss, [p.detach().clone() for p in model.parameters()]))
    assert tracing.spans()
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

    ecfg, emodel, scene = scene_model
    logits = []
    for on in (False, True):
        with recorded() if on else contextlib.nullcontext():
            logits.append(whole_scene.predict_scene(emodel, ecfg, scene, batch_size=ecfg.eval.batch_size))
    np.testing.assert_array_equal(logits[0], logits[1])
