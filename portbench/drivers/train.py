"""Training cells: optimizer steps back to back, one client.

Set-up builds the one training object: the port's model with the seed's
weights, its optimizer, ``make_train_step``, and the port's own data path
(``ChunkDataset`` over the cell's scenes into a ``PrefetchIterator``, with
the config's prefetch depth, workers and packed transfer), as
``entry.train_entry`` wires them. It drives that object through its first
``CHECK_STEPS`` steps by the window's own calls (the warm-up, which builds
and loads every kernel of the step's shapes), keeping their batches, losses,
the first forward's 2D logits, the first gradient as the optimizer got it and
the parameters before and after. The window then takes a batch and makes a step until ``seconds``
have passed, reading each step's loss (a closed loop, as the port's train
loop is). After the window the reference re-derives the checked steps'
batches from the scenes and the data seed, follows the steps, and the
numbers of ``compare.train_numbers`` decide ``correct``.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import compare, harness
from portbench.reference import data as D
from portbench.reference import run as R

CHECK_STEPS = 3
ADAM_BETA1 = 0.9


def seeds(seed: int) -> tuple[int, int]:
    """(data seed, augmentation seed) of a run."""
    data_seed, aug_seed = np.random.SeedSequence([int(seed), 1]).generate_state(2, np.uint32)
    return int(data_seed), int(aug_seed)


def run(ctx) -> harness.Run:
    from mvpnet_torch import ops
    from mvpnet_torch.data.pipeline import ChunkDataset, PrefetchIterator
    from mvpnet_torch.train.checkpoint import trainable_parameters
    from mvpnet_torch.train.solver import build_optimizer
    from mvpnet_torch.train.step import make_train_step

    rec, dev, cfg = ctx.record, ctx.device, ctx.program_cfg
    data_seed, aug_seed = seeds(ctx.seed)
    model, loss_fn, metric_fn = harness.program_model(cfg, ctx.seed, dev)
    model.train()
    optimizer = build_optimizer(cfg.solver, trainable_parameters(model, cfg.model.freeze_2d))
    train_step = make_train_step(cfg, loss_fn, metric_fn)
    ctx.mark("model with the seed's weights")
    scenes = ctx.corpus.scenes()
    ctx.mark("scenes")
    dataset = ChunkDataset(harness.program_scenes(scenes), cfg.data, batch_size=cfg.train.batch_size,
                           training=True, seed=data_seed)
    batches = PrefetchIterator(dataset, prefetch=cfg.data.prefetch, num_threads=cfg.data.num_workers, device=dev,
                               pack=cfg.data.packed_transfer)
    generator = torch.Generator().manual_seed(aug_seed)
    params = dict(model.named_parameters())
    first: list = []
    hook = model.register_forward_hook(lambda module, args, out: first.append(out[1].detach().float().cpu()))
    try:
        prog = {"losses": [], "start": {k: p.detach().cpu().clone() for k, p in params.items()}}
        kept = []
        for i in range(CHECK_STEPS):
            batch = next(batches)
            kept.append({k: v.cpu().numpy().copy() for k, v in batch.items()})
            ctx.mark(f"checked step {i + 1}: batch")
            prog["losses"].append(float(train_step(model, optimizer, batch, generator)["loss"]))
            ctx.mark(f"checked step {i + 1}: step")
            if i == 0:
                hook.remove()
                prog["logits_2d"] = first[0]
                state = optimizer.inner.state
                prog["grad"] = {k: (state[p]["exp_avg"] / (1 - ADAM_BETA1)).cpu() if p in state
                                else torch.zeros_like(p, device="cpu") for k, p in params.items()}
        prog["end"] = {k: p.detach().cpu().clone() for k, p in params.items()}

        ctx.sync()
        rec.setup_s = time.perf_counter() - ctx.t0
        rec.peak_bytes = ctx.peak_bytes()
        ctx.reset_peak()
        before = ops.launch_counts()
        accum = max(1, cfg.train.grad_accum)
        with ctx.tracer as tracer:
            start = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                with tracer.range("data_wait"):
                    batch = next(batches)
                t1 = time.perf_counter()
                with tracer.range("step"):
                    loss = float(train_step(model, optimizer, batch, generator)["loss"])
                t2 = time.perf_counter()
                rec.units.append({"wait_s": t1 - t0, "step_s": t2 - t1, "chunks": cfg.train.batch_size, "loss": loss})
                rec.forwards.extend([cfg.train.batch_size // accum] * accum)
                if t2 - start >= ctx.seconds:
                    break
            rec.window_s = time.perf_counter() - start
        rec.launches = harness.launch_delta(before, ops.launch_counts())
        rec.window_peak_bytes = ctx.peak_bytes()
        rec.peak_bytes = max(rec.peak_bytes, rec.window_peak_bytes)
    finally:
        batches.close()
    rec.attempted = len(rec.units)
    rec.failed = sum(not math.isfinite(u["loss"]) for u in rec.units)
    del model, optimizer, batches, params, train_step
    ctx.free()

    ctx.mark("window closed, program freed")
    rec.numbers = check(ctx, scenes, kept, prog, data_seed, aug_seed)
    ctx.mark("reference check")
    return rec


def match_batches(scenes: list[dict], data: dict, data_seed: int, workers: int, kept: list[dict]) -> list[dict] | None:
    """The reference's batches of the checked steps: each kept batch must be
    the next batch of one worker's stream, re-derived from the scenes;
    None when one is not."""
    streams = [D.WorkerStream(scenes, data, data_seed, w) for w in range(workers)]
    heads: list = [None] * workers
    out = []
    for batch in kept:
        rows = len(batch["points"])
        found = None
        for w, stream in enumerate(streams):
            if heads[w] is None:
                heads[w] = stream.next_sample()
            if _same(heads[w], {k: v[0] for k, v in batch.items()}):
                found = D.collate([heads[w]] + [stream.next_sample() for _ in range(rows - 1)])
                heads[w] = None
                break
        if found is None or not _same(found, batch):
            return None
        out.append(found)
    return out


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def check(ctx, scenes, kept, prog, data_seed, aug_seed) -> dict:
    cfg = ctx.cfg
    ref_scenes = [dict(s) for s in scenes]
    batches = match_batches(ref_scenes, cfg["data"], data_seed, cfg["data"]["num_workers"], kept)
    ctx.mark("batches re-derived")
    if batches is None:
        return {"batch_rederived": float("inf")}
    dev = ctx.device
    on_dev = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
    ref = R.train_steps(cfg, on_dev, ctx.seed, aug_seed, dev)
    numbers = compare.train_numbers({k: _to(v, dev) for k, v in prog.items()}, ref)
    numbers["batch_rederived"] = 0.0
    return numbers


def _to(v, dev):
    if isinstance(v, dict):
        return {k: t.to(dev) for k, t in v.items()}
    return v.to(dev) if isinstance(v, torch.Tensor) else v
