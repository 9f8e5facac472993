"""Whole-scene cells: scenes labelled one after another, one client.

Set-up builds the port's model with the seed's weights in eval mode and
labels the first scene once through ``eval/whole_scene.predict_scene`` (the
warm-up: every window shape of the cell's scenes). The window then labels the
cell's scenes in turn, cycling, until ``seconds`` have passed: each call
builds the chunks of every occupied window and their views on the host (the
port's thread pool), runs the forwards of ``eval.batch_size`` windows,
accumulates the logits on the device, reads them back and fills the points
no window sampled. The forwards go through ``predict_scene``'s own
``forward_fn``; in a traced run each is also timed on the host clock ending
in a synchronize (for ``scene_host_ms``), while an untraced run lets the host
build the next group as ``cli/test_3d`` does. After the
window a sample of the labelled scenes, drawn from the seed, is held to the
reference's labelling of the same scenes (``compare.scene_numbers``).
"""
from __future__ import annotations

import time

import numpy as np

from portbench import compare, harness
from portbench.reference import run as R


def run(ctx) -> harness.Run:
    from mvpnet_torch import ops
    from mvpnet_torch.eval import whole_scene

    rec, dev, cfg = ctx.record, ctx.device, ctx.program_cfg
    model, _, _ = harness.program_model(cfg, ctx.seed, dev)
    model.eval()
    plain_forward = whole_scene.make_forward(model, cfg)
    spent = []

    def forward_fn(batch):
        rec.forwards.append(int(batch["points"].shape[0]))
        if not ctx.tracer.enabled:
            return plain_forward(batch)
        t0 = time.perf_counter()
        with ctx.tracer.range("forward"):
            out = plain_forward(batch)
            ctx.sync()
        spent.append(time.perf_counter() - t0)
        return out

    ctx.mark("model with the seed's weights")
    scenes = ctx.corpus.scenes()
    ctx.mark("scenes")
    program_scenes = harness.program_scenes(scenes)
    bs = cfg.eval.batch_size
    whole_scene.predict_scene(model, cfg, program_scenes[0], batch_size=bs, forward_fn=forward_fn)
    ctx.sync()
    ctx.mark("warm-up scene")
    rec.forwards.clear()
    rec.setup_s = time.perf_counter() - ctx.t0
    rec.peak_bytes = ctx.peak_bytes()
    ctx.reset_peak()
    before = ops.launch_counts()
    outputs = []
    with ctx.tracer as tracer:
        start = time.perf_counter()
        while True:
            k = len(rec.units) % len(program_scenes)
            spent.clear()
            t0 = time.perf_counter()
            with tracer.range("chunk_build_and_fill"):
                logits = whole_scene.predict_scene(model, cfg, program_scenes[k], batch_size=bs, forward_fn=forward_fn)
            t1 = time.perf_counter()
            rec.units.append({"scene": k, "scene_s": t1 - t0, "finite": bool(np.isfinite(logits).all())})
            if tracer.enabled:
                rec.units[-1]["forward_s"] = sum(spent)
            outputs.append(logits)
            if t1 - start >= ctx.seconds:
                break
        rec.window_s = time.perf_counter() - start
    rec.launches = harness.launch_delta(before, ops.launch_counts())
    rec.window_peak_bytes = ctx.peak_bytes()
    rec.peak_bytes = max(rec.peak_bytes, rec.window_peak_bytes)
    rec.attempted = len(rec.units)
    rec.failed = sum(not u["finite"] for u in rec.units)
    del model, plain_forward
    ctx.free()

    picks = np.random.default_rng([int(ctx.seed), 2]).choice(len(outputs), min(ctx.traffic["check_units"], len(outputs)),
                                                            replace=False)
    numbers: dict = {}
    labelled: dict = {}
    for i in sorted(int(p) for p in picks):
        k = rec.units[i]["scene"]
        if k not in labelled:
            labelled[k] = R.predict_scene(ctx.cfg, dict(scenes[k]), ctx.seed, dev)
            ctx.mark(f"reference labelled scene {k}")
        for name, value in compare.scene_numbers(outputs[i], labelled[k]).items():
            numbers[name] = max(numbers.get(name, 0.0), value)
    rec.numbers = numbers
    return rec
