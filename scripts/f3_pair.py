"""Paired 3D training of the JAX package and the port on the CPU.

Both packages train ``mvpnet_3d`` from the same configuration on the same
host batches, STEPS steps a run, to tell a semantic difference between
their training steps from floating-point chaos. Four subcommands:

    JAX_PLATFORMS=cpu python scripts/f3_pair.py strict --size small --out runs/f3_pair/strict_small.json

(a) strict pairing: f32 nets, dropout 0, the recipe's solver (Adam, the step
schedule with its ``clip_lr`` floor). The port starts from the JAX model's
weights (``nnx.Rngs(0)``, carried across with ``load_jax_params``), both
take their batches from their own ``build_dataset`` with one seed (asserted
equal), and the port is fed the augmentation parameters that the JAX step
draws from its key (``chunk_draws``, patched into
``mvpnet_torch.train.step.sample_chunk_params``). Beside the pair runs a
chaos baseline: the port against itself with one weight moved by 1 ulp.
Per step: each side's loss, and every DIST_EVERY steps the parameter
distance per top-level module (``net_2d``, ``aggregation``, ``net_3d``) and
that of the BatchNorm statistics; chunk validation through each package's
``evaluate`` halfway and at the end.

    JAX_PLATFORMS=cpu python scripts/f3_pair.py modes --size small --side jax --seed 0 \
        --out runs/f3_pair/modes_small/jax_seed0.json

(b) one run in the recipe's own modes: the nets in bf16, dropout 0.5, each
package drawing its own weights (seeded ``--seed``), augmentation and
dropout. The data are the same for one seed on either side.

    python scripts/f3_pair.py summary --runs runs/f3_pair/modes_small --out runs/f3_pair/modes_small.json

gathers (b)'s runs: each side's mean train loss over steps WINDOW_START to
the end and final chunk-val mIoU, over its seeds, each held to the other
side's mean plus or minus the seeds' spread. ``modes --side port --init jax``
starts the port from the JAX model of its seed, which takes the seeds' own
initial weights out of that comparison, and

    JAX_PLATFORMS=cpu python scripts/f3_pair.py init --size small --seeds 30 --out runs/f3_pair/init_small.json

compares the loss at each package's own initial weights over many seeds.

``--warm`` (``strict``, ``modes``) first runs the recipe's 2D stage in the
package whose weights the run starts from (``pretrain_2d``, checkpoint under
``outputs/f3_pair/``) and warm-starts the 3D net's 2D part from it, as the
recipe does: the regime where the 3D stage learns fast enough for a gap of
the recipe's size to show within STEPS steps.

Sizes (``SIZES``) cut the recipe's chunk, images and nets so that a JAX step
takes seconds on a CPU: the JAX side runs its jnp references there (no
Pallas), the port its plain versions. Run it from the repository's root, one
run a process, in the background: the seconds each side took are in the
output. ``tests/test_torch_pair_train.py`` runs ``paired_run`` at the tests'
tiny widths.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

# The recipe's nets cut to size. "tiny" is tests/test_torch_train.py's
# (tests/test_models.tiny_config, tests/test_pipeline.small_data_cfg);
# "small" keeps the recipe's corpus, views, batch, classes, solver, four SA and
# FP levels and ResNet34's block counts at 1/8 of the points, a quarter of
# the image side and half the widths or less.
SIZES = {
    "tiny": [
        "data.num_points=256", "data.num_views_train=2", "data.num_views_eval=3", "data.image_height=24",
        "data.image_width=32", "data.num_classes=5", "data.max_candidate_frames=8", "train.batch_size=4",
        "model.unet.num_classes=5", "model.unet.base_channels=8", "model.unet.stage_channels=[8,16,16,32]",
        "model.unet.stage_blocks=[1,1,1,1]", "model.unet.decoder_channels=[16,16,8,8]",
        "model.unet.feature_channels=8", "model.aggregation.mlp_channels=[8,8]", "model.pn2.num_classes=5",
        "model.pn2.in_channels=8",
        "model.pn2.sa=[{npoint: 32, radius: 0.2, nsample: 8, mlp_channels: [16,16]}, "
        "{npoint: 8, radius: 0.4, nsample: 8, mlp_channels: [16,32]}]",
        "model.pn2.fp_channels=[[32],[32,16]]", "model.pn2.head_channels=16",
    ],
    "small": [
        "data.num_points=1024", "data.num_views_train=3", "data.num_views_eval=5", "data.image_height=30",
        "data.image_width=40", "data.num_classes=20", "data.synthetic_scenes=16", "data.synthetic_objects=12",
        "train.batch_size=8",
        "model.unet.num_classes=20", "model.unet.base_channels=16", "model.unet.stage_channels=[16,32,64,128]",
        "model.unet.stage_blocks=[3,4,6,3]", "model.unet.decoder_channels=[64,32,16,16]",
        "model.unet.feature_channels=16", "model.aggregation.mlp_channels=[32,32,32]", "model.pn2.num_classes=20",
        "model.pn2.in_channels=32",
        "model.pn2.sa=[{npoint: 256, radius: 0.1, nsample: 16, mlp_channels: [16,16,32]}, "
        "{npoint: 64, radius: 0.2, nsample: 16, mlp_channels: [32,32,64]}, "
        "{npoint: 16, radius: 0.4, nsample: 16, mlp_channels: [64,64,128]}, "
        "{npoint: 8, radius: 0.8, nsample: 16, mlp_channels: [128,128,256]}]",
        "model.pn2.fp_channels=[[128,128],[128,64],[64,64],[64,64,64]]", "model.pn2.head_channels=64",
    ],
}
F32 = ["model.unet.dtype=float32", "model.pn2.dtype=float32"]
STRICT = F32 + ["model.pn2.dropout=0.0"]
MODES = ["model.unet.dtype=bfloat16", "model.pn2.dtype=bfloat16", "model.pn2.dropout=0.5"]
MODULES = ("net_2d", "aggregation", "net_3d")
STEPS = 400  # every run's horizon; the full-scale curves part by step 200
VAL_STEPS = 10  # chunk-validation batches, as the recipe's
DIST_EVERY = 10  # steps between (a)'s parameter distances
WINDOW_START = 200  # the train-loss window of (b)'s comparison starts here
INIT_BATCHES = 3  # training batches each ``init`` seed's loss is taken on
PRETRAIN_STEPS = 1500  # ``--warm``'s 2D stage, as long as the recipe's


def configs(size: str, extra=()):
    """The JAX and the port Config of ``SIZES[size]`` and ``extra``
    overrides (``model.name=mvpnet_3d``, synthetic data)."""
    from mvpnet_tpu.config import load_config as jax_load_config
    from mvpnet_torch.config import load_config

    over = ["model.name=mvpnet_3d", "data.name=synthetic"] + SIZES[size] + list(extra)
    return jax_load_config(None, over), load_config(None, over)


def chunk_draws(key, batch: int, accum: int, data) -> list[dict]:
    """The augmentation parameters that the JAX train step draws from
    ``key``, one dict of (rows,) tensors a microbatch in the order the port
    asks for them: ``split(key, accum)`` when accumulating
    (``mvpnet_tpu/train/step.py``), ``split(key, rows)`` a sample, then
    ``augment_chunk``'s ``k1, k2, k3`` (angle; ``kx, ky`` flips; ``kb, kc``
    brightness and contrast)."""
    import torch

    out = _draw_program()(key, batch, accum, float(data.flip_prob), float(data.color_jitter))
    return [{n: torch.from_numpy(np.array(v[a])) for n, v in out.items()} for a in range(accum)]


@functools.cache
def _draw_program():
    """``_draw_body`` as one compiled program: its arrays are (accum, rows)."""
    import jax

    return jax.jit(_draw_body, static_argnums=(1, 2, 3, 4))


def _draw_body(key, batch, accum, flip_prob, jitter):
    import jax
    import jax.numpy as jnp

    def draw(k):
        k1, k2, k3 = jax.random.split(k, 3)
        kx, ky = jax.random.split(k2)
        kb, kc = jax.random.split(k3)
        return {
            "angle": jax.random.uniform(k1, (), minval=0.0, maxval=2.0 * jnp.pi),
            "flip_x": jax.random.bernoulli(kx, flip_prob),
            "flip_y": jax.random.bernoulli(ky, flip_prob),
            "brightness": jax.random.uniform(kb, (), minval=1.0 - jitter, maxval=1.0 + jitter),
            "contrast": jax.random.uniform(kc, (), minval=1.0 - jitter, maxval=1.0 + jitter),
        }

    keys = key[None] if accum == 1 else jax.random.split(key, accum)
    return jax.vmap(lambda k: jax.vmap(draw)(jax.random.split(k, batch // accum)))(keys)


@contextlib.contextmanager
def fed_draws(queue: list):
    """The port's train step takes its augmentation parameters from the
    front of ``queue`` instead of its generator."""
    import mvpnet_torch.train.step as port_step

    def take(gen, batch, *, flip_prob, jitter):
        params = queue.pop(0)
        if len(params["angle"]) != batch:
            raise ValueError(f"draws for {len(params['angle'])} rows, the step asks for {batch}")
        return params

    saved = port_step.sample_chunk_params
    port_step.sample_chunk_params = take
    try:
        yield
    finally:
        port_step.sample_chunk_params = saved


def pretrain_2d(side: str, size: str, seed: int) -> dict:
    """The recipe's first stage in package ``side``: its own ``train()`` of
    ``sem_seg_2d`` on frames, PRETRAIN_STEPS steps from seed ``seed``, at
    ``SIZES[size]`` and the recipe's bf16. Returns the checkpoint directory
    (under ``outputs/f3_pair/``), the validation mIoU and the seconds."""
    over = ["model.name=sem_seg_2d", "data.name=synthetic", "data.sampling=frames", *SIZES[size],
            f"train.max_steps={PRETRAIN_STEPS}", f"train.val_every={PRETRAIN_STEPS}", f"train.val_steps={VAL_STEPS}",
            f"train.ckpt_every={PRETRAIN_STEPS}", f"train.seed={seed}",
            f"output_dir=outputs/f3_pair/{side}_{size}_seed{seed}_2d"]
    t0 = time.perf_counter()
    if side == "jax":
        from mvpnet_tpu.config import load_config
        from mvpnet_tpu.train.loop import train

        cfg = load_config(None, over)
        _, val = train(cfg, resume=False)
    else:
        from mvpnet_torch.config import load_config
        from mvpnet_torch.train.loop import train

        cfg = load_config(None, over)
        _, val = train(cfg, resume=False, device="cpu")
    return {"side": side, "steps": PRETRAIN_STEPS, "ckpt": f"{cfg.output_dir}/checkpoints",
            "val_miou": float(val["miou"]), "seconds": time.perf_counter() - t0}


class JaxSide:
    """The JAX package's model (from ``nnx.Rngs(seed)``, its 2D net then
    warm-started from the checkpoint directory ``warm``, or a copy of
    ``model``), optimizer, train and eval steps; the step key advances as
    ``mvpnet_tpu/train/loop.py``'s does."""

    def __init__(self, cfg, seed: int, model=None, warm: str | None = None):
        import jax
        from flax import nnx
        from mvpnet_tpu.models import build_model
        from mvpnet_tpu.train.checkpoint import warm_start_2d
        from mvpnet_tpu.train.solver import build_optimizer
        from mvpnet_tpu.train.step import make_eval_step, make_train_step

        self.cfg = cfg
        fns = []

        def build():
            m, loss_fn, metric_fn = build_model(cfg, rngs=nnx.Rngs(seed))
            fns[:] = loss_fn, metric_fn
            return m

        if model is None:  # every initializer in one compiled program: the weights eager init gives
            self.model = nnx.jit(build)()
            if warm is not None and not warm_start_2d(self.model, warm):
                raise FileNotFoundError(f"no 2D checkpoint in {warm}")
        else:  # a copy of ``model``; the losses of an abstract build
            nnx.eval_shape(build)
            self.model = nnx.clone(model)
        loss_fn, metric_fn = self.loss_fn, _ = fns
        self.optimizer = nnx.Optimizer(self.model, build_optimizer(cfg.solver), wrt=nnx.Param)
        self.train_step = make_train_step(cfg, loss_fn, metric_fn)
        self.eval_step = make_eval_step(cfg, loss_fn, metric_fn)
        self.key = jax.random.key(seed)
        self.seconds = 0.0

    def step(self, batch) -> float:
        """One step on a host batch; returns the loss (``step_key``: the
        step's key)."""
        import jax

        t0 = time.perf_counter()
        self.key, self.step_key = jax.random.split(self.key)
        loss = float(self.train_step(self.model, self.optimizer, jax.device_put(batch), self.step_key)["loss"])
        self.seconds += time.perf_counter() - t0
        return loss

    def evaluate(self, batches: list) -> dict:
        """``mvpnet_tpu.train.loop.evaluate`` over ``batches``, with the
        summed confusion matrix."""
        import jax
        from mvpnet_tpu.train.loop import evaluate

        t0 = time.perf_counter()
        cms = []

        def eval_step(model, batch):
            m = self.eval_step(model, jax.device_put(batch))
            cms.append(np.asarray(m["confusion"]))
            return m

        out = evaluate(self.model, eval_step, iter(batches), len(batches), self.cfg.data.num_classes)
        self.seconds += time.perf_counter() - t0
        return {"miou": out["miou"], "loss": out["loss"], "confusion": np.sum(cms, axis=0)}

    def flat(self) -> dict:
        """Parameters and BatchNorm statistics under their JAX keys (what
        ``load_jax_params`` takes)."""
        from flax import nnx

        flat = nnx.to_flat_state(nnx.state(self.model, nnx.Any(nnx.Param, nnx.BatchStat)))
        return {"/".join(map(str, k)): np.asarray(v[...]) for k, v in flat}

    def state(self) -> dict:
        """The same under the port's keys."""
        from mvpnet_torch import convert

        return dict(convert._torch_key(k, v) for k, v in self.flat().items())


class PortSide:
    """The port's model (``init``: a JAX flat state to start from, else its
    own weights from ``seed``, its 2D net then warm-started from the
    checkpoint directory ``warm``), optimizer, train and eval steps;
    augmentation from a generator seeded ``seed`` unless draws are fed."""

    def __init__(self, cfg, seed: int, init: dict | None = None, warm: str | None = None):
        import torch
        from mvpnet_torch import convert
        from mvpnet_torch.models import build_model
        from mvpnet_torch.train import solver
        from mvpnet_torch.train.checkpoint import warm_start_2d
        from mvpnet_torch.train.step import make_eval_step, make_train_step

        self.cfg = cfg
        self.model, self.loss_fn, metric_fn = build_model(cfg, seed=seed)
        loss_fn = self.loss_fn
        if init is not None:
            convert.load_jax_params(self.model, init)
        elif warm is not None and not warm_start_2d(self.model, warm):
            raise FileNotFoundError(f"no 2D checkpoint in {warm}")
        self.model.train()
        self.optimizer = solver.build_optimizer(cfg.solver, self.model.parameters())
        self.train_step = make_train_step(cfg, loss_fn, metric_fn)
        self.eval_step = make_eval_step(cfg, loss_fn, metric_fn)
        self.generator = torch.Generator().manual_seed(seed)
        self.seconds = 0.0

    def step(self, batch, draws: list | None = None) -> float:
        """One step on a host batch; ``draws`` (``chunk_draws``) replace the
        generator's augmentation parameters."""
        import torch

        t0 = time.perf_counter()
        tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
        with fed_draws(list(draws)) if draws is not None else contextlib.nullcontext():
            loss = float(self.train_step(self.model, self.optimizer, tensors, self.generator)["loss"])
        self.seconds += time.perf_counter() - t0
        return loss

    def evaluate(self, batches: list) -> dict:
        """``mvpnet_torch.train.loop.evaluate`` over ``batches`` (then train
        mode again), with the summed confusion matrix."""
        import torch
        from mvpnet_torch.train.loop import evaluate, set_train_mode

        t0 = time.perf_counter()
        cms = []

        def eval_step(model, batch):
            m = self.eval_step(model, {k: torch.from_numpy(v) for k, v in batch.items()})
            cms.append(m["confusion"].numpy())
            return m

        out = evaluate(self.model, eval_step, iter(batches), len(batches))
        set_train_mode(self.model, self.cfg)
        self.seconds += time.perf_counter() - t0
        return {"miou": out["miou"], "loss": out["loss"], "confusion": np.sum(cms, axis=0)}

    def state(self) -> dict:
        return {k: v.detach().numpy().copy() for k, v in self.model.state_dict().items()}


def nudge_one_weight(port: PortSide) -> str:
    """Move the first element of the 3D head's weight up by 1 ulp (the chaos
    baseline's only difference); returns its key."""
    import torch

    with torch.no_grad():
        w = port.model.net_3d.head.weight.view(-1)
        w[0] = torch.nextafter(w[0], torch.tensor(math.inf))
    return "net_3d.head.weight[0]"


def distances(a: dict, b: dict, start: dict) -> dict:
    """Per top-level module, ||a - b|| over its parameters, relative to
    ||b - start|| (the way ``b`` travelled), and the same over its
    BatchNorm statistics (``bn/<module>``)."""
    out = {}
    for mod in MODULES:
        for kind in ("param", "bn"):
            keys = [k for k in b if k.startswith(mod + ".") and
                    (k.rsplit(".", 1)[-1] in ("running_mean", "running_var")) == (kind == "bn")]
            gap = math.sqrt(sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2)) for k in keys))
            way = math.sqrt(sum(float(np.sum((b[k].astype(np.float64) - start[k]) ** 2)) for k in keys))
            out[mod if kind == "param" else "bn/" + mod] = {"gap": gap, "travel": way, "rel": gap / max(way, 1e-30)}
    return out


def host_batches(jax_ds, port_ds, n: int) -> list:
    """``n`` batches from each package's dataset, asserted equal key for
    key; the JAX side's copies (the port takes its own tensors of them)."""
    out = []
    for _ in range(n):
        want, got = next(jax_ds), next(port_ds)
        if set(want) != set(got) or any(not np.array_equal(want[k], got[k]) for k in want):
            raise AssertionError("the packages' host batches differ")
        out.append(want)
    return out


def paired_run(jax_cfg, port_cfg, train_sets, val_sets, *, steps: int, eval_at, dist_every: int = 0,
               baseline: bool = False, jax_model=None, log=None) -> dict:
    """The strict pairing of (a): ``steps`` steps of each package on the
    batches of ``train_sets`` (a (JAX, port) pair of dataset iterators), JAX's
    augmentation draws fed to the port, chunk validation on ``val_sets``'s
    batches (``cfg.train.val_steps`` of them) after each step in ``eval_at``
    (1-based). With ``baseline`` a second port, one weight nudged by 1 ulp,
    runs beside. ``jax_model``: a JAX model to start from (a copy), else one
    from ``nnx.Rngs(0)``. Returns per-step losses, the distances every ``dist_every``
    steps and at the end, each validation, the start and final states and
    seconds."""
    jax_side = JaxSide(jax_cfg, 0, model=jax_model)
    init = jax_side.flat()
    port = PortSide(port_cfg, 0, init=init)
    start = port.state()
    base = None
    if baseline:
        base = PortSide(port_cfg, 0, init=init)
        nudged = nudge_one_weight(base)
    accum = max(1, int(jax_cfg.train.grad_accum))
    B = jax_cfg.train.batch_size
    rec = {"loss_jax": [], "loss_port": [], "lr": [], "dist": [], "val": []}
    if base is not None:
        rec.update(loss_baseline=[], dist_baseline=[], nudged=nudged)
    for step in range(steps):
        (batch,) = host_batches(*train_sets, 1)
        rec["loss_jax"].append(jax_side.step(batch))
        draws = chunk_draws(jax_side.step_key, B, accum, jax_cfg.data)
        rec["loss_port"].append(port.step(batch, draws))
        rec["lr"].append(float(port.optimizer.schedule(step)))
        if base is not None:
            rec["loss_baseline"].append(base.step(batch, draws))
        last = step + 1 == steps
        if (dist_every and (step + 1) % dist_every == 0) or last:
            ps = port.state()
            rec["dist"].append({"step": step + 1, **distances(jax_side.state(), ps, start)})
            if base is not None:
                rec["dist_baseline"].append({"step": step + 1, **distances(base.state(), ps, start)})
        if step + 1 in eval_at:
            batches = host_batches(*val_sets, jax_cfg.train.val_steps)
            val = {"step": step + 1, "jax": jax_side.evaluate(batches), "port": port.evaluate(batches)}
            if base is not None:
                val["baseline"] = base.evaluate(batches)
            rec["val"].append(val)
        if log is not None:
            log(step, rec)
    rec["state_start"], rec["state_jax"], rec["state_port"] = start, jax_side.state(), port.state()
    rec["seconds"] = {"jax": jax_side.seconds, "port": port.seconds}
    if base is not None:
        rec["seconds"]["baseline"] = base.seconds
    return rec


def own_run(side: str, jax_cfg, port_cfg, *, seed: int, jax_init: bool = False, warm: str | None = None,
            log=None) -> dict:
    """One run of (b) on ``side`` ("jax" or "port"), STEPS steps: its own weights
    (``jax_init``: the port starts from the JAX model of ``seed`` instead),
    augmentation and dropout from ``seed``, the data of ``build_dataset`` at
    ``seed`` (the same on either side), validation at the end. ``warm``: a
    2D checkpoint directory of the package whose weights the run starts
    from, to warm-start the 2D net."""
    if side == "jax":
        from mvpnet_tpu.data.pipeline import build_dataset

        runner, cfg = JaxSide(jax_cfg, seed, warm=warm), jax_cfg
    else:
        from mvpnet_torch.data.pipeline import build_dataset

        init = JaxSide(jax_cfg, seed, warm=warm).flat() if jax_init else None
        runner, cfg = PortSide(port_cfg, seed, init=init, warm=None if jax_init else warm), port_cfg
    train = iter(build_dataset(cfg.data, batch_size=cfg.train.batch_size, training=True, seed=seed))
    val = iter(build_dataset(cfg.data, batch_size=cfg.train.batch_size, training=False, seed=seed + 1000))
    losses = []
    for step in range(STEPS):
        losses.append(runner.step(next(train)))
        if log is not None:
            log(step, losses)
    val_out = runner.evaluate([next(val) for _ in range(cfg.train.val_steps)])
    return {"side": side, "seed": seed, "loss": losses, "val": _jsonable(val_out), "seconds": runner.seconds}


def _jsonable(o):
    if isinstance(o, dict):
        return {k: _jsonable(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_jsonable(v) for v in o]
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    return o


def datasets(jax_cfg, port_cfg, seed: int, training: bool):
    """(JAX, port) batch iterators of each package's ``build_dataset``."""
    from mvpnet_tpu.data.pipeline import build_dataset as jax_build_dataset
    from mvpnet_torch.data.pipeline import build_dataset

    s = seed if training else seed + 1000
    B = jax_cfg.train.batch_size
    return (iter(jax_build_dataset(jax_cfg.data, batch_size=B, training=training, seed=s)),
            iter(build_dataset(port_cfg.data, batch_size=B, training=training, seed=s)))


def window_stats(rec: dict, lo: int) -> dict:
    """The signed and absolute loss gaps over steps ``lo``..end, JAX minus
    port and baseline minus port."""
    lp = np.array(rec["loss_port"][lo:])
    out = {}
    for name, key in (("jax", "loss_jax"), ("baseline", "loss_baseline")):
        if key in rec:
            d = np.array(rec[key][lo:]) - lp
            out[name] = {"mean_signed": float(d.mean()), "sem_signed": float(d.std(ddof=1) / math.sqrt(len(d))),
                         "mean_abs": float(np.abs(d).mean()), "mean_rel": float(np.mean(np.abs(d) / lp)),
                         "mean_loss": float(np.mean(rec[key][lo:]))}
    out["port_mean_loss"] = float(lp.mean())
    return out


def cmd_strict(args):
    extra = STRICT + [f"train.val_steps={VAL_STEPS}"]
    jax_cfg, port_cfg = configs(args.size, extra)
    t0 = time.perf_counter()

    def log(step, rec):
        if (step + 1) % 10 == 0 or step == 0:
            print(f"step {step + 1}: jax {rec['loss_jax'][-1]:.6f} port {rec['loss_port'][-1]:.6f} "
                  f"baseline {rec['loss_baseline'][-1]:.6f} ({time.perf_counter() - t0:.0f} s)", flush=True)

    pre = pretrain_2d("jax", args.size, 0) if args.warm else None
    start = JaxSide(jax_cfg, 0, warm=pre["ckpt"]).model if pre else None
    rec = paired_run(jax_cfg, port_cfg, datasets(jax_cfg, port_cfg, 0, True), datasets(jax_cfg, port_cfg, 0, False),
                     steps=STEPS, eval_at=(STEPS // 2, STEPS), dist_every=DIST_EVERY, baseline=True, jax_model=start,
                     log=log)
    for key in ("state_start", "state_jax", "state_port"):
        rec.pop(key)
    windows = {f"{lo}-{STEPS}": window_stats(rec, lo) for lo in (0, 50, WINDOW_START)}
    out = {"mode": "strict", "size": args.size, "overrides": SIZES[args.size] + extra, "steps": STEPS,
           "seed": 0, "pretrain_2d": pre, "windows": windows, "device": "CPU (JAX jnp references / port plain versions)",
           "wall_seconds": time.perf_counter() - t0, **_jsonable(rec)}
    _write(args.out, out)
    print(json.dumps({"windows": windows, "seconds": rec["seconds"], "val": [
        {"step": v["step"], **{s: v[s]["miou"] for s in ("jax", "port", "baseline")}} for v in out["val"]]}))


def cmd_modes(args):
    extra = MODES + [f"train.val_steps={VAL_STEPS}"]
    jax_cfg, port_cfg = configs(args.size, extra)
    t0 = time.perf_counter()

    def log(step, losses):
        if (step + 1) % 20 == 0 or step == 0:
            print(f"{args.side} seed {args.seed} step {step + 1}: loss {losses[-1]:.5f} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)

    owner = "jax" if args.side == "jax" or args.init == "jax" else "port"
    pre = pretrain_2d(owner, args.size, args.seed) if args.warm else None
    rec = own_run(args.side, jax_cfg, port_cfg, seed=args.seed, jax_init=args.init == "jax",
                  warm=pre and pre["ckpt"], log=log)
    out = {"mode": "modes", "size": args.size, "overrides": SIZES[args.size] + extra, "steps": STEPS, "init": args.init,
           "pretrain_2d": pre, "device": "CPU (JAX jnp references / port plain versions)", "wall_seconds": time.perf_counter() - t0,
           **rec}
    _write(args.out, out)
    print(json.dumps({"side": args.side, "seed": args.seed, "miou": rec["val"]["miou"],
                      "seconds": rec["seconds"]}))


def cmd_init(args):
    """Each package's loss at its own initial weights, seeds ``--seeds``,
    on the first INIT_BATCHES training batches (no augmentation, no
    update): whether the two draw their weights from one distribution."""
    import torch
    from flax import nnx
    from mvpnet_tpu.data.pipeline import build_dataset
    from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
    from mvpnet_torch.train.step import prepare_batch

    jax_cfg, port_cfg = configs(args.size, STRICT + ["data.augment=false"])
    data = iter(build_dataset(jax_cfg.data, batch_size=jax_cfg.train.batch_size, training=True, seed=0))
    batches = [next(data) for _ in range(INIT_BATCHES)]
    losses = {"jax": [], "port": []}
    t0 = time.perf_counter()
    for seed in range(args.seeds):
        side = JaxSide(jax_cfg, seed)
        loss = nnx.jit(lambda m, mb: side.loss_fn(m(mb), mb))
        losses["jax"].append([float(loss(side.model, jax_prepare_batch(jax_cfg, b, training=False))) for b in batches])
        port = PortSide(port_cfg, seed)
        with torch.no_grad():
            mbs = [prepare_batch(port_cfg, {k: torch.from_numpy(v) for k, v in b.items()}, training=False)
                   for b in batches]
            losses["port"].append([float(port.loss_fn(port.model(mb), mb)) for mb in mbs])
    means = {k: np.mean(v, axis=1) for k, v in losses.items()}
    stats = {k: {"mean": float(m.mean()), "std": float(m.std(ddof=1))} for k, m in means.items()}
    gap = stats["jax"]["mean"] - stats["port"]["mean"]
    se = math.sqrt(sum(float(m.var(ddof=1)) / len(m) for m in means.values()))
    out = {"mode": "init", "size": args.size, "seeds": args.seeds, "batches": INIT_BATCHES, "losses": losses,
           "stats": stats, "gap": gap, "gap_se": se, "device": "CPU (JAX jnp references / port plain versions)",
           "wall_seconds": time.perf_counter() - t0}
    _write(args.out, out)
    print(json.dumps({"stats": stats, "gap": gap, "gap_se": se}))


def cmd_summary(args):
    """(b)'s verdict over the ``modes`` outputs in ``--runs`` (the loss
    curves stay in those files)."""
    runs = []
    for name in sorted(os.listdir(args.runs)):
        if name.endswith(".json"):
            with open(os.path.join(args.runs, name)) as f:
                runs.append(json.load(f))
    sides = {}
    for side in ("jax", "port"):
        mine = [r for r in runs if r["side"] == side]
        tail = [float(np.mean(r["loss"][WINDOW_START:])) for r in mine]
        miou = [r["val"]["miou"] for r in mine]
        sides[side] = {"seeds": [r["seed"] for r in mine], "tail_loss": tail, "val_miou": miou,
                       "val_loss": [r["val"]["loss"] for r in mine], "seconds": [r["seconds"] for r in mine]}
        for metric in ("tail_loss", "val_miou"):
            v = np.array(sides[side][metric])
            sides[side][metric + "_mean"] = float(v.mean())
            sides[side][metric + "_spread"] = float(v.max() - v.min())
    verdict = {}
    for metric in ("tail_loss", "val_miou"):
        for side, other in (("jax", "port"), ("port", "jax")):
            o = sides[other]
            lo, hi = o[metric + "_mean"] - o[metric + "_spread"], o[metric + "_mean"] + o[metric + "_spread"]
            verdict[f"{metric}: {side} mean within {other} mean +- spread"] = bool(lo <= sides[side][metric + "_mean"] <= hi)
    out = {"mode": "modes", "size": runs[0]["size"], "overrides": runs[0]["overrides"], "steps": runs[0]["steps"],
           "tail_window": f"{WINDOW_START}-{runs[0]['steps']}", "device": runs[0]["device"], "sides": sides,
           "verdict": verdict}
    _write(args.out, out)
    print(json.dumps({"sides": {s: {k: v for k, v in d.items() if k.endswith(("_mean", "_spread"))}
                                for s, d in sides.items()}, "verdict": verdict}))


def _write(path: str, out: dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("strict", "modes", "init"):
        p = sub.add_parser(name)
        p.add_argument("--size", default="small", choices=sorted(SIZES))
        p.add_argument("--out", required=True)
        if name != "init":
            p.add_argument("--warm", action="store_true",
                           help="warm-start the 2D net from a PRETRAIN_STEPS 2D stage, as the recipe does")
    p = sub.choices["modes"]
    p.add_argument("--side", required=True, choices=("jax", "port"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", default="own", choices=("own", "jax"),
                   help="the port's weights: its own from --seed, or the JAX model's of --seed")
    sub.choices["init"].add_argument("--seeds", type=int, default=30)
    p = sub.add_parser("summary")
    p.add_argument("--runs", required=True, help="directory of `modes` outputs")
    p.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.cmd != "summary":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
    {"strict": cmd_strict, "modes": cmd_modes, "init": cmd_init, "summary": cmd_summary}[args.cmd](args)


if __name__ == "__main__":
    main()
