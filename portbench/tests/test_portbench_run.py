"""Whole runs of tiny cells on the CPU, dropped in as new files; the check
seeing each fault of the timed path; the card and import rules.

The tiny cells compute in float32, where a sound run agrees with the
reference to round-off; ``tiny.make_root`` sets their limits. These tests
skip the harness's look for a card (``run_cell(..., "cpu")``); the card's own
runs are ``portbench/run.py`` and ``portbench/control.py``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import compare, harness
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")))


def run(root, cell, seed=1234567890123, trace=False):
    from portbench import run as bench_run

    return bench_run.run_cell(root, cell, seed, 0.5, trace, "cpu")[0]


@pytest.mark.parametrize("cell", [tiny.TRAIN, tiny.SCENE])
def test_a_dropped_in_cell_runs_correct(root, cell):
    res = run(root, cell, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "units.tiny" in res["metrics"] and list(res["checks"]) == sorted(res["checks"])
    assert list(res)[-1] == "checks" and "breakdown" in res
    assert not harness.forbidden_modules()


def test_end_to_end_metrics_of_an_untraced_run(root):
    res = run(root, tiny.TRAIN, seed=7)
    assert set(res["metrics"]) == {"train_chunks_per_s", "setup_s"}
    assert res["metrics"]["train_chunks_per_s"]["value"] > 0


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(root, monkeypatch):
    from mvpnet_torch.train import solver

    monkeypatch.setattr(solver.Optimizer, "step", lambda self: None)
    res = run(root, tiny.TRAIN)
    assert not res["correct"] and res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(root, monkeypatch):
    """A step that runs the first half of its microbatches and takes the mean
    over them: its first forward is whole, and the training cells' own
    ``bias_grad_err`` limit catches it."""
    import dataclasses

    from mvpnet_torch.train import step as step_mod

    make = step_mod.make_train_step

    def halved(cfg, *args, **kwargs):
        accum = max(1, cfg.train.grad_accum)
        inner = make(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, grad_accum=max(1, accum // 2))),
                     *args, **kwargs)

        def train_step(model, optimizer, batch, generator=None):
            rows = len(batch["points"]) // 2
            return inner(model, optimizer, {k: v[:rows] for k, v in batch.items()}, generator)

        return train_step

    monkeypatch.setattr(step_mod, "make_train_step", halved)
    res = run(root, tiny.TRAIN)
    limit = harness.Manifest(tiny.REPO).cell("mvpnet3d_32k.train")["limits"]["bias_grad_err"]
    assert not res["correct"] and res["checks"]["bias_grad_err"]["value"] > limit
    assert res["checks"]["logit2d_err"]["value"] <= res["checks"]["logit2d_err"]["limit"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(root, monkeypatch):
    from mvpnet_torch.eval import whole_scene

    make = whole_scene.make_forward

    def altered(model, cfg):
        forward = make(model, cfg)

        def forward_fn(batch):
            logits = forward(batch).clone()
            logits[0, 0, 0] += 10.0 * float(logits.abs().max())
            return logits

        return forward_fn

    monkeypatch.setattr(whole_scene, "make_forward", altered)
    res = run(root, tiny.SCENE)
    assert not res["correct"]


def test_half_of_the_windows_left_out_is_not_correct(root, monkeypatch):
    """A forward that computes the first half of its windows and hands their
    logits out for the rest too."""
    from mvpnet_torch.eval import whole_scene

    make = whole_scene.make_forward

    def halved(model, cfg):
        forward = make(model, cfg)

        def forward_fn(batch):
            rows = len(batch["points"])
            half = forward({k: v[: max(rows // 2, 1)] for k, v in batch.items()})
            return half.repeat_interleave(2, dim=0)[:rows] if rows > 1 else half

        return forward_fn

    monkeypatch.setattr(whole_scene, "make_forward", halved)
    res = run(root, tiny.SCENE)
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["mvpnet3d_32k.train", "mvpnet3d_highres.scene"])
def test_the_control_fails_the_cells_limits(cell):
    """fp8 in place of the program (and, for training, the reference that
    leaves half of each step's microbatches out), at a size a CPU holds, read
    against the limits of the cell it controls."""
    from portbench import control
    from portbench.traffic.synthetic import Corpus

    cfg = tiny.tiny_config()
    scenes = Corpus({"scenes": 2, "points": 3000, "frames": 6, "objects": 3, "room": 3.0}, cfg, 5).scenes()
    reading = control.train_readings if cell.endswith(".train") else control.scene_readings
    readings = reading(cfg, scenes, 5, torch.device("cpu"))
    limits = harness.Manifest(tiny.REPO).cell(cell)["limits"]
    for kind, numbers in readings.items():
        assert not compare.judge(numbers, {k: v for k, v in limits.items() if k in numbers})[0], (kind, numbers)


def test_no_cuda_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run([sys.executable, os.path.join(tiny.REPO, "portbench", "run.py"), "--workload",
                           "mvpnet3d_32k.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_it_exits_nonzero_and_prints_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/: the cell cannot
    run, on any machine."""
    root = tmp_path / "bare"
    import shutil

    shutil.copytree(os.path.join(tiny.REPO, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), root / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mvpnet3d_32k.train", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_loaded_jax_module_is_found_by_its_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "mvpnet_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    found = harness.forbidden_modules()
    assert "mvpnet_tpu.ops" in found and "jaxtyping_like" not in found
    assert not any(name.startswith("mvpnet_torch") for name in found)
    assert json.dumps(found)
