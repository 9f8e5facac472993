"""The readers of the program's spans and counters: a traced tiny run on the
CPU reports every span metric of its cell, the fusion kNN's pair share reads
nothing where no kernel ran, and a program without spans leaves every reader
empty (as a version of the program from before the spans does)."""
from __future__ import annotations

import sys

import pytest

from portbench import harness
from portbench.tests import tiny

SPAN_METRICS = {
    tiny.TRAIN: ("data_queue_wait_ms.train", "data_build_ms.train", "idle_in_spans.train"),
    tiny.SCENE: ("scene_chunk_wait_ms.scene", "scene_nn_fill_ms.scene", "idle_in_spans.scene"),
}
COUNTER_METRICS = ("knn_fusion_scanned_share",)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")), extra_metric=False)


@pytest.fixture(scope="module")
def runs(root):
    from mvpnet_torch import tracing
    from portbench import run as bench_run

    tracing.clear()
    return {cell: bench_run.run_cell(root, cell, 9876543210987, 0.5, True, "cpu") for cell in (tiny.TRAIN, tiny.SCENE)}


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SCENE])
def test_a_traced_run_reports_every_span_metric_of_its_cell(runs, cell):
    result, _ = runs[cell]
    assert result["correct"], result["checks"]
    for name in SPAN_METRICS[cell]:
        assert name in result["metrics"], (name, result["metrics"])
        assert result["metrics"][name]["value"] >= 0
    for name in ("idle_in_spans.train", "idle_in_spans.scene"):
        if name in SPAN_METRICS[cell]:
            # on the CPU the whole window is idle: the spans name nearly all of it
            assert 50 < result["metrics"][name]["value"] <= 100


def test_the_pair_share_reads_nothing_without_the_kernel(runs):
    result, rec = runs[tiny.SCENE]
    assert rec.launches.get("knn_fusion", 0) == 0 and rec.forwards
    assert "knn_fusion_scanned_share" not in result["metrics"]


@pytest.mark.parametrize("name", [n for names in SPAN_METRICS.values() for n in names] + list(COUNTER_METRICS))
def test_a_program_without_spans_leaves_the_reader_empty(root, runs, monkeypatch, name):
    cell = tiny.TRAIN if name.endswith(".train") else tiny.SCENE
    _, rec = runs[cell]
    reader = harness.Manifest(root).reader(name)
    if name in COUNTER_METRICS:
        rec = _with_launches(rec)
    else:
        assert reader.read(rec) is not None
    import mvpnet_torch

    monkeypatch.delattr(mvpnet_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "mvpnet_torch.tracing", None)
    assert reader.read(rec) is None


def _with_launches(rec):
    """The record as if row 1 had run once a forward."""
    import copy

    rec = copy.copy(rec)
    rec.launches = {**rec.launches, "knn_fusion": len(rec.forwards)}
    return rec


@pytest.mark.parametrize("cell,tiny_cell", [("mvpnet3d_32k.train", tiny.TRAIN), ("mvpnet3d_highres.scene", tiny.SCENE)])
def test_the_new_metrics_are_listed_for_their_cell(cell, tiny_cell):
    names = {m["name"] for m in harness.Manifest(tiny.REPO).metrics_of(cell, True)}
    want = set(SPAN_METRICS[tiny_cell]) | (set(COUNTER_METRICS) if tiny_cell == tiny.SCENE else set())
    assert want <= names
