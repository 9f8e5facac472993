"""The port's training path (mvpnet_torch.train, core.augment, the train-mode
blocks, the pipeline's dataset and prefetcher, the checkpointer and the
train_3d CLI) against the JAX package, on the CPU.

Inputs are made from a numpy seed and given to both packages; weights go
across with mvpnet_torch.convert.load_jax_params. Both sides run float32 on
the CPU with different conv/matmul libraries, so results agree to float32
accumulation noise: losses to rtol 1e-5 (one step), gradients to cosine >
0.9999 and norm within 1% (tests/test_parity.py's gate), parameters and BN
statistics after an update to 1e-4 absolute. Over three steps the noise
compounds through Adam, whose first updates are about lr * sign(g): the
same tolerance holds because the test repeats one batch (on a new batch a
near-tied activation can flip, and the trajectories part by up to 2 lr).
"""
import dataclasses
import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import nnx

from mvpnet_tpu.config import SolverConfig as JaxSolverConfig
from mvpnet_tpu.core.augment import augment_chunk
from mvpnet_tpu.data.pipeline import ChunkDataset as JaxChunkDataset
from mvpnet_tpu.data.synthetic import make_scene as jax_make_scene
from mvpnet_tpu.models import build_model as jax_build_model
from mvpnet_tpu.train.solver import build_optimizer as jax_build_optimizer
from mvpnet_tpu.train.solver import build_schedule as jax_build_schedule
from mvpnet_tpu.train.step import make_train_step as jax_make_train_step
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import convert
from mvpnet_torch.config import SolverConfig, load_config
from mvpnet_torch.core.augment import apply_chunk_augment
from mvpnet_torch.data import pipeline
from mvpnet_torch.data.synthetic import make_scene
from mvpnet_torch.entry import TRAIN_CONFIG, train_entry
from mvpnet_torch.models import build_model
from mvpnet_torch.models.blocks import BatchNorm, Dropout
from mvpnet_torch.train import checkpoint, solver
from mvpnet_torch.train.step import make_eval_step, make_train_step, prepare_batch
from tests.test_models import tiny_config
from tests.test_pipeline import small_data_cfg
from tests.test_torch_models import _flat_params, _port_cfg

ATOL = 1e-4
STEPS = 3


def _torch_batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _jax_cfg(grad_accum=1):
    cfg = tiny_config()
    pn2 = dataclasses.replace(cfg.model.pn2, dropout=0.0)
    return dataclasses.replace(
        cfg,
        data=small_data_cfg(augment=False),
        model=dataclasses.replace(cfg.model, pn2=pn2),
        train=dataclasses.replace(cfg.train, batch_size=4, grad_accum=grad_accum),
    )


def _port_state(model):
    """The port model's tensors under the JAX flat keys."""
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _assert_state_close(model, flat, atol=ATOL):
    state = _port_state(model)
    for key, value in flat.items():
        tkey, arr = convert._torch_key(key, value)
        np.testing.assert_allclose(state[tkey], arr, atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX make_train_step at tiny_config (dropout 0, no augmentation,
    B=4): the initial weights, the first step's gradients, the state after
    each of three steps on one batch, and one grad_accum=2 step."""
    jcfg = _jax_cfg()
    jmodel, loss_fn, metric_fn = jax_build_model(jcfg, rngs=nnx.Rngs(0))
    init = _flat_params(jmodel)
    scene = jax_make_scene(7, num_points=20000, num_frames=6, height=24, width=32, num_classes=5)
    raw = next(iter(JaxChunkDataset([scene], jcfg.data, batch_size=4, training=True, seed=3)))
    mb = jax_prepare_batch(jcfg, jax.device_put(raw), training=True)

    @nnx.jit  # the batch is an argument: as a closed-over constant XLA folds the kNN sort for minutes
    def value_and_grad(m, mb):
        return nnx.value_and_grad(lambda m: loss_fn(m(mb), mb))(m)

    loss0, grads = value_and_grad(nnx.clone(jmodel), mb)
    grads = {"/".join(map(str, k)): np.asarray(v[...]) for k, v in nnx.to_flat_state(grads)}
    optimizer = nnx.Optimizer(jmodel, jax_build_optimizer(jcfg.solver), wrt=nnx.Param)
    step = jax_make_train_step(jcfg, loss_fn, metric_fn)
    losses, states = [], []
    for _ in range(STEPS):
        m = step(jmodel, optimizer, jax.device_put(raw), jax.random.key(0))
        losses.append(float(m["loss"]))
        states.append(_flat_params(jmodel))

    acfg = _jax_cfg(grad_accum=2)
    amodel, aloss, ametric = jax_build_model(acfg, rngs=nnx.Rngs(0))
    aopt = nnx.Optimizer(amodel, jax_build_optimizer(acfg.solver), wrt=nnx.Param)
    am = jax_make_train_step(acfg, aloss, ametric)(amodel, aopt, jax.device_put(raw), jax.random.key(0))
    accum = {
        "metrics": {k: np.asarray(v) for k, v in am.items()},
        "state": _flat_params(amodel),
    }
    return dict(cfg=jcfg, raw=raw, init=init, loss0=float(loss0), grads=grads, losses=losses, states=states,
                accum=accum)


def _port_model(jcfg, init):
    cfg = _port_cfg(jcfg)
    model, loss_fn, metric_fn = build_model(cfg)
    convert.load_jax_params(model, init)
    return cfg, model.train(), loss_fn, metric_fn


@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_step_matches_jax(jax_run, steps):
    cfg, model, loss_fn, metric_fn = _port_model(jax_run["cfg"], jax_run["init"])
    optimizer = solver.build_optimizer(cfg.solver, model.parameters())
    step = make_train_step(cfg, loss_fn, metric_fn)
    batch = _torch_batch(jax_run["raw"])
    for i in range(steps):
        m = step(model, optimizer, batch)
        np.testing.assert_allclose(float(m["loss"]), jax_run["losses"][i], rtol=1e-5)
        assert m["confusion"].sum() == 4 * cfg.data.num_points
    assert optimizer.count == steps
    # parameters after the update(s) and the BN running statistics
    _assert_state_close(model, jax_run["states"][steps - 1])


def test_train_step_grads_match_jax(jax_run):
    cfg, model, loss_fn, metric_fn = _port_model(jax_run["cfg"], jax_run["init"])
    optimizer = solver.build_optimizer(cfg.solver, model.parameters())
    m = make_train_step(cfg, loss_fn, metric_fn)(model, optimizer, _torch_batch(jax_run["raw"]))
    np.testing.assert_allclose(float(m["loss"]), jax_run["loss0"], rtol=1e-5)
    named = dict(model.named_parameters())
    assert len(jax_run["grads"]) == len(named)
    for key, jg in jax_run["grads"].items():
        tkey, jg = convert._torch_key(key, jg)
        g = named[tkey].grad.numpy()
        cos = float(np.dot(g.ravel(), jg.ravel()) / (np.linalg.norm(g) * np.linalg.norm(jg) + 1e-30))
        assert cos > 0.9999, f"{key}: grad cosine {cos}"
        ratio = np.linalg.norm(g) / (np.linalg.norm(jg) + 1e-30)
        assert 0.99 < ratio < 1.01, f"{key}: grad norm ratio {ratio}"


def test_grad_accum_matches_jax(jax_run):
    """grad_accum=2 over the B=4 batch: two microbatches of 2, gradients
    averaged, one update; confusion summed, loss and accuracy averaged."""
    jcfg = _jax_cfg(grad_accum=2)
    cfg, model, loss_fn, metric_fn = _port_model(jcfg, jax_run["init"])
    optimizer = solver.build_optimizer(cfg.solver, model.parameters())
    m = make_train_step(cfg, loss_fn, metric_fn)(model, optimizer, _torch_batch(jax_run["raw"]))
    want = jax_run["accum"]["metrics"]
    np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(m["accuracy"]), want["accuracy"], rtol=1e-6)
    np.testing.assert_array_equal(m["confusion"].numpy(), want["confusion"])
    assert optimizer.count == 1
    _assert_state_close(model, jax_run["accum"]["state"])
    with pytest.raises(ValueError):  # the batch must split evenly
        make_train_step(cfg, loss_fn, metric_fn)(model, optimizer, {k: v[:3] for k, v in _torch_batch(jax_run["raw"]).items()})


def test_eval_step_runs_without_grad(jax_run):
    cfg, model, loss_fn, metric_fn = _port_model(jax_run["cfg"], jax_run["init"])
    model.eval()
    m = make_eval_step(cfg, loss_fn, metric_fn)(model, _torch_batch(jax_run["raw"]))
    assert not m["loss"].requires_grad and torch.isfinite(m["loss"])
    assert all(p.grad is None for p in model.parameters())


# ---------------------------------------------------------------------------
# Train-mode blocks
# ---------------------------------------------------------------------------


def test_batchnorm_train_mode_matches_flax(rng):
    """Batch statistics over all leading dims, biased variance for both the
    normalization and the running update (momentum 0.9)."""
    x = rng.normal(1.5, 2.0, size=(3, 7, 5, 6)).astype(np.float32)
    jbn = nnx.BatchNorm(6, use_running_average=False, momentum=0.9, epsilon=1e-5, rngs=nnx.Rngs(0))
    bn = BatchNorm(6).train()
    for _ in range(2):  # two updates of the running statistics
        want = jbn(jnp.asarray(x.reshape(-1, 6))).reshape(x.shape)
        got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(jbn.mean[...]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jbn.var[...]), rtol=1e-5, atol=1e-6)
    bn.eval()  # eval mode: the running statistics, unchanged by the call
    before = bn.running_var.clone()
    bn(torch.from_numpy(x))
    assert torch.equal(bn.running_var, before)


def test_dropout_draws_from_its_generator():
    x = torch.ones(4096)
    a, b = Dropout(0.25).train(), Dropout(0.25).train()
    ya, yb = a(x), b(x)
    assert torch.equal(ya, yb)  # one seed, one mask
    kept = ya != 0
    assert 0.7 < kept.float().mean() < 0.8
    assert torch.allclose(ya[kept], torch.tensor(1 / 0.75))
    assert not torch.equal(a(x), ya)  # the stream moves on
    a.generator = None
    assert torch.equal(a(x), ya)  # and starts again
    assert torch.equal(a.eval()(x), x)


def test_remat_matches_plain_backward(jax_run):
    """cfg.train.remat: torch.utils.checkpoint over the 2D net gives the same
    loss and gradients, and BN running statistics move once, not twice."""
    out = {}
    for remat in (False, True):
        cfg, model, loss_fn, _ = _port_model(jax_run["cfg"], jax_run["init"])
        model.remat_2d = remat
        batch = prepare_batch(cfg, _torch_batch(jax_run["raw"]), training=True)
        loss = loss_fn(model(batch), batch)
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()},
                      model.net_2d.encoder.stem_norm.running_mean.clone())
    assert out[True][0] == out[False][0]
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(out[True][2], out[False][2], rtol=0, atol=0)


def test_build_model_sets_remat_and_leaves_mode(jax_run):
    cfg = _port_cfg(dataclasses.replace(jax_run["cfg"], train=dataclasses.replace(jax_run["cfg"].train, remat=True)))
    model, _, _ = build_model(cfg)
    assert model.remat_2d and model.training


# ---------------------------------------------------------------------------
# Augmentation
# ---------------------------------------------------------------------------


def _jax_chunk_params(key, flip_prob, jitter):
    """The draws augment_chunk makes from ``key``, in its order."""
    k1, k2, k3 = jax.random.split(key, 3)
    kx, ky = jax.random.split(k2)
    kb, kc = jax.random.split(k3)
    return {
        "angle": float(jax.random.uniform(k1, (), minval=0.0, maxval=2.0 * jnp.pi)),
        "flip_x": bool(jax.random.bernoulli(kx, flip_prob)),
        "flip_y": bool(jax.random.bernoulli(ky, flip_prob)),
        "brightness": float(jax.random.uniform(kb, (), minval=1.0 - jitter, maxval=1.0 + jitter)),
        "contrast": float(jax.random.uniform(kc, (), minval=1.0 - jitter, maxval=1.0 + jitter)),
    }


@pytest.mark.parametrize("z_rot,flip_prob,jitter", [(True, 0.5, 0.4), (False, 0.9, 0.0), (True, 0.0, 0.2)])
def test_augment_application_matches_jax(rng, z_rot, flip_prob, jitter):
    """The same parameters through apply_chunk_augment and JAX's
    augment_chunk (whose own key draws are read out and injected)."""
    B = 4
    points = rng.uniform(-2, 2, (B, 64, 3)).astype(np.float32)
    image_xyz = rng.uniform(-2, 2, (B, 2, 6, 8, 3)).astype(np.float32)
    image_xyz[:, 0, :2] = 1e6  # invalid pixels move with the rest
    images = rng.uniform(size=(B, 2, 6, 8, 3)).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), B)
    per = [_jax_chunk_params(k, flip_prob, jitter) for k in keys]
    params = {name: torch.tensor([p[name] for p in per]) for name in per[0]}
    want = jax.vmap(
        lambda k, p, x, im: augment_chunk(k, p, x, im, z_rot=z_rot, flip_prob=flip_prob, jitter=jitter)
    )(keys, jnp.asarray(points), jnp.asarray(image_xyz), jnp.asarray(images))
    got = apply_chunk_augment(
        torch.from_numpy(points), torch.from_numpy(image_xyz), torch.from_numpy(images), params,
        z_rot=z_rot, flip_prob=flip_prob, jitter=jitter,
    )
    # f32 on both sides, matmul vs XLA dot: 1e-5 at unit scale; the 1e6
    # sentinel pixels keep a relative 1e-6 (one f32 ulp of 1e6 is 0.06)
    sentinel = np.zeros(image_xyz.shape[:-1], bool)
    sentinel[:, 0, :2] = True
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy()[~sentinel], np.asarray(want[1])[~sentinel], atol=1e-5)
    np.testing.assert_allclose(got[1].numpy()[sentinel], np.asarray(want[1])[sentinel], atol=1.0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)


def test_prepare_batch_training_draws_and_applies(jax_run):
    cfg = _port_cfg(dataclasses.replace(jax_run["cfg"], data=small_data_cfg(augment=True)))
    batch = _torch_batch(jax_run["raw"])
    plain = prepare_batch(cfg, batch, training=False)
    a = prepare_batch(cfg, batch, training=True, generator=torch.Generator().manual_seed(0))
    b = prepare_batch(cfg, batch, training=True, generator=torch.Generator().manual_seed(0))
    for k in ("points", "image_xyz", "images"):
        assert torch.equal(a[k], b[k])  # one seed, one draw
        assert not torch.equal(a[k], plain[k])
    assert torch.equal(a["seg_label_2d"], plain["seg_label_2d"])
    # rotations and flips keep distances: the chunk's spread is unchanged
    def spread(p):
        return (p[:, :, None] - p[:, None]).norm(dim=-1)

    torch.testing.assert_close(spread(a["points"]), spread(plain["points"]), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


SCHEDULES = [
    dict(scheduler="step", step_size=3, gamma=0.5, clip_lr=1e-4),
    dict(scheduler="multistep", milestones=(2, 5), gamma=0.1, clip_lr=0.0),
    dict(scheduler="cosine", step_size=6, clip_lr=1e-5),
    dict(scheduler="none", warmup_steps=4),
    dict(scheduler="step", step_size=2, gamma=0.5, clip_lr=1e-5, warmup_steps=3),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw["scheduler"] + ("+warmup" if kw.get("warmup_steps") else ""))
def test_schedule_matches_optax(kw):
    want = jax_build_schedule(JaxSolverConfig(**kw))
    got = solver.build_schedule(SolverConfig(**kw))
    for step in range(10):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


OPTIMIZERS = [
    dict(optimizer="adam", scheduler="step", step_size=2, gamma=0.5),
    dict(optimizer="adamw", weight_decay=0.01, warmup_steps=2),
    dict(optimizer="sgd", momentum=0.9, weight_decay=0.005, base_lr=0.05, max_grad_norm=1.0),
    dict(optimizer="adam", max_grad_norm=0.5, scheduler="cosine", step_size=4),
    dict(optimizer="sgd", momentum=0.0, base_lr=0.1, max_grad_norm=100.0),  # norm below max: no clip
]


@pytest.mark.parametrize("kw", OPTIMIZERS, ids=["adam", "adamw", "sgd+wd+clip", "adam+clip", "sgd-noclip"])
def test_optimizer_matches_optax_step_by_step(rng, kw):
    params = {"w": rng.normal(size=(7, 5)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jax_build_optimizer(JaxSolverConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = solver.build_optimizer(SolverConfig(**kw), tp.values())
    g_rng = np.random.default_rng(7)
    for _ in range(6):
        grads = {k: (g_rng.normal(size=v.shape) * 3).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert opt.count == 6


def test_clip_by_global_norm_is_optax_rule():
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    norm = solver.clip_by_global_norm_(g, 5.0)  # norm == max_norm: clipped, by optax's rule
    assert norm.item() == 5.0 and g[0].tolist() == [3.0, 4.0]
    solver.clip_by_global_norm_(g, 1.0)
    torch.testing.assert_close(g[0], torch.tensor([0.6, 0.8]))
    with pytest.raises(ValueError):
        solver.build_optimizer(SolverConfig(optimizer="lamb"), [torch.nn.Parameter(torch.zeros(1))])


# ---------------------------------------------------------------------------
# Pipeline (ports of tests/test_pipeline.py's prefetch and packing tests)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    return make_scene(0, num_points=20000, num_frames=6, height=24, width=32, num_classes=5)


def _data_cfg(**kw):
    return _port_cfg(dataclasses.replace(tiny_config(), data=small_data_cfg(**kw))).data


def test_dataset_iteration_and_prefetch(scene):
    ds = pipeline.ChunkDataset([scene], _data_cfg(), batch_size=2, training=True, seed=0)
    it = pipeline.PrefetchIterator(ds, prefetch=2, num_threads=2)
    b1, b2 = next(it), next(it)
    assert b1["points"].shape == (2, 256, 3) and isinstance(b1["points"], torch.Tensor)
    assert not torch.equal(b1["points"], b2["points"])  # random chunks
    it.close()


def test_chunk_dataset_matches_jax(scene):
    """One seed, the same host batch as the JAX ChunkDataset."""
    jcfg = small_data_cfg()
    jscene = jax_make_scene(0, num_points=20000, num_frames=6, height=24, width=32, num_classes=5)
    want = next(iter(JaxChunkDataset([jscene], jcfg, batch_size=2, training=True, seed=4)))
    got = next(iter(pipeline.ChunkDataset([scene], _data_cfg(), batch_size=2, training=True, seed=4)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_prefetch_propagates_worker_errors():
    class Boom:
        def worker_iter(self, worker_id):
            def gen():
                raise ValueError("synthetic failure")
                yield  # pragma: no cover

            return gen()

    it = pipeline.PrefetchIterator(Boom(), prefetch=1, num_threads=2)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        next(it)
    it.close()


def test_prefetch_workers_run_concurrently():
    class Slow:
        def worker_iter(self, worker_id):
            def gen():
                while True:
                    time.sleep(0.05)
                    yield {"x": np.zeros(1, np.float32)}

            return gen()

    it = pipeline.PrefetchIterator(Slow(), prefetch=8, num_threads=4)
    t0 = time.perf_counter()
    for _ in range(8):
        next(it)
    dt = time.perf_counter() - t0
    it.close()
    # serial: 8 * 0.05 = 0.4 s; 4 workers: ~0.1 s
    assert dt < 0.3, f"prefetch appears serialized ({dt:.3f}s for 8 batches)"


def test_prefetch_close_joins_threads(scene):
    ds = pipeline.ChunkDataset([scene], _data_cfg(), batch_size=1, training=True, seed=0)
    it = pipeline.PrefetchIterator(ds, prefetch=1, num_threads=2)
    next(it)
    it.close()
    assert all(not t.is_alive() for t in it._threads)


def test_packed_transfer_roundtrip(rng):
    batch = {
        "images": rng.integers(0, 255, (2, 3, 8, 8, 3)).astype(np.uint8),
        "depth": rng.integers(0, 4000, (2, 3, 8, 8)).astype(np.uint16),
        "points": rng.normal(size=(2, 16, 3)).astype(np.float32),
        "points_mm": rng.integers(-3000, 3000, (2, 16, 3)).astype(np.int16),
        "seg_label": np.array([[-100, 3]], np.int8),
        "n_real": 2,
        "meta": {"scene": "a"},
    }
    packed, layout, extras = pipeline.pack_batch(batch)
    assert packed.dtype == np.uint8 and extras == {"n_real": 2, "meta": {"scene": "a"}}
    hash(layout)
    out = pipeline.unpack_batch(torch.from_numpy(packed), layout)
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            assert out[k].numpy().dtype == v.dtype
            np.testing.assert_array_equal(out[k].numpy(), v)


def test_prefetch_packed_batches(scene):
    ds = pipeline.ChunkDataset([scene], _data_cfg(num_points=64), batch_size=2, training=False, seed=5)
    it_plain = pipeline.PrefetchIterator(ds, prefetch=1, num_threads=1)
    it_packed = pipeline.PrefetchIterator(ds, prefetch=1, num_threads=1, pack=True)
    try:
        a, b = next(it_plain), next(it_packed)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    finally:
        it_plain.close()
        it_packed.close()


def test_build_dataset_splits_and_rejects_frames():
    """Disjoint train and val scenes; frame sampling, once a raise, now
    builds the frame dataset over the same scenes (tests/test_torch_frames.py
    holds it against JAX's)."""
    from mvpnet_torch.data.frames import FrameDataset

    cfg = _data_cfg()
    train, val = (pipeline.build_dataset(cfg, batch_size=1, training=t, seed=1) for t in (True, False))
    assert len(train.scenes) == cfg.synthetic_scenes and len(val.scenes) == 2
    assert not np.array_equal(train.scenes[0].points, val.scenes[0].points)
    frames = pipeline.build_dataset(dataclasses.replace(cfg, sampling="frames"), batch_size=3, training=True, seed=1)
    assert isinstance(frames, FrameDataset)
    assert all(np.array_equal(a.rgb, b.rgb) for a, b in zip(frames.scenes, train.scenes))
    batch = next(iter(frames))
    assert set(batch) == {"images", "seg_label_2d"} and batch["images"].shape == (3, 24, 32, 3)


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------


def test_checkpointer_retention_and_restore(tmp_path, jax_run):
    cfg, model, _, _ = _port_model(jax_run["cfg"], jax_run["init"])
    opt = solver.build_optimizer(cfg.solver, model.parameters())
    ckpt = checkpoint.Checkpointer(str(tmp_path / "ck"), keep=2)
    for step, miou in [(0, 0.5), (1, 0.2), (2, 0.5), (3, 0.1)]:
        ckpt.save(step, model, opt, metrics={"miou": miou, "iou": np.zeros(3)})
    # the two best by mIoU stay; of the equal 0.5 ones the later ranks higher
    assert ckpt.steps() == [0, 2]
    ckpt.save(4, model)  # no metrics: never removed
    ckpt.save(5, model, metrics={"miou": 0.9})
    assert ckpt.steps() == [2, 4, 5]
    want = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    assert ckpt.restore(model) == 5  # the latest, model only
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    fresh_opt = solver.build_optimizer(cfg.solver, model.parameters())
    assert ckpt.restore(model, fresh_opt, step=2) == 2 and fresh_opt.count == 0
    assert checkpoint.Checkpointer(str(tmp_path / "empty")).restore(model) is None


def test_warm_start_2d_and_freeze(tmp_path, jax_run):
    cfg, model, _, _ = _port_model(jax_run["cfg"], jax_run["init"])
    checkpoint.Checkpointer(str(tmp_path / "2d")).save(0, model)
    other, _, _ = build_model(cfg, seed=1)
    assert not torch.equal(other.net_2d.encoder.stem.weight, model.net_2d.encoder.stem.weight)
    assert checkpoint.warm_start_2d(other, str(tmp_path / "2d"))
    assert torch.equal(other.net_2d.encoder.stem.weight, model.net_2d.encoder.stem.weight)
    assert not torch.equal(other.net_3d.head.weight, model.net_3d.head.weight)
    assert not checkpoint.warm_start_2d(other, str(tmp_path / "missing"))
    params = checkpoint.trainable_parameters(other, freeze_2d=True)
    assert params and all(not p.requires_grad for p in other.net_2d.parameters())
    assert len(params) == len(list(other.aggregation.parameters())) + len(list(other.net_3d.parameters()))


# ---------------------------------------------------------------------------
# Entry points: train_entry and the train_3d CLI
# ---------------------------------------------------------------------------


TINY = [
    "data.name=synthetic", "data.num_points=256", "data.image_height=24", "data.image_width=32",
    "data.num_views_train=2", "data.num_views_eval=2", "data.max_candidate_frames=8", "data.num_workers=2",
    "data.synthetic_scenes=2", "data.num_classes=5",
    "model.unet.num_classes=5", "model.unet.base_channels=8", "model.unet.stage_channels=[8,16,16,32]",
    "model.unet.stage_blocks=[1,1,1,1]", "model.unet.decoder_channels=[16,16,8,8]", "model.unet.feature_channels=8",
    "model.unet.dtype=float32", "model.aggregation.mlp_channels=[8,8]", "model.pn2.num_classes=5",
    "model.pn2.in_channels=8", "model.pn2.dtype=float32", "model.pn2.head_channels=16", "model.pn2.dropout=0.0",
    "model.pn2.sa=[{npoint: 32, radius: 0.2, nsample: 8, mlp_channels: [16,16]}, {npoint: 8, radius: 0.4, nsample: 8, mlp_channels: [16,32]}]",
    "model.pn2.fp_channels=[[32],[32,16]]",
]


def test_train_entry_on_cpu():
    cfg = load_config(TRAIN_CONFIG, TINY + ["train.batch_size=2"])
    step, (model, optimizer, batches) = train_entry(device="cpu", cfg=cfg)
    try:
        before = model.net_3d.head.weight.detach().clone()
        m = step()
        assert torch.isfinite(m["loss"]) and optimizer.count == 1
        assert not torch.equal(model.net_3d.head.weight, before)
        assert model.training
    finally:
        batches.close()


def test_single_device_surfaces_raise(tmp_path):
    """Without a launcher, a mesh over several ranks raises (train() and
    train_entry: one process is one rank); model.unet.torch_weights, once a
    raise, imports the torchvision encoder before training."""
    from mvpnet_torch.dist.mesh import make_mesh
    from mvpnet_torch.train.loop import train
    from tests.test_torch_models_2d import _torchvision_sd

    for over in (["mesh.space=2"], ["mesh.data=4"]):
        with pytest.raises(ValueError, match="ranks, have 1"):
            train(load_config(TRAIN_CONFIG, TINY + over + [f"output_dir={tmp_path / 'mesh'}"]), device="cpu")
        with pytest.raises(ValueError, match="python -m torch.distributed.run"):
            train_entry(device="cpu", cfg=load_config(TRAIN_CONFIG, over))
    unet = dict(base_channels=8, stage_channels=(8, 16, 16, 32), stage_blocks=(1, 1, 1, 1))
    sd = _torchvision_sd(np.random.default_rng(0), unet)
    np.savez(tmp_path / "r34.npz", **sd)
    cfg = load_config(TRAIN_CONFIG, TINY + [f"model.unet.torch_weights={tmp_path / 'r34.npz'}",
                                            f"output_dir={tmp_path / 'run'}", "model.pretrained_2d="])
    assert make_mesh(cfg.mesh).world == 1
    model, _ = train(cfg, max_steps=0, device="cpu")
    enc = model.net_2d.encoder
    assert torch.equal(enc.stem.weight, torch.from_numpy(sd["conv1.weight"]))
    assert torch.equal(enc.stages[3][0].down.norm.running_mean, torch.from_numpy(sd["layer4.0.downsample.1.running_mean"]))


def test_cli_train_3d_loss_falls_and_resumes(tmp_path):
    """The synthetic smoke config at tiny widths: 24 steps lower the loss; a
    second call resumes from the last checkpoint and runs only the rest."""
    from mvpnet_torch.cli import train_3d

    out = str(tmp_path / "run")
    args = ["--cfg", "configs/scannet/mvpnet_3d_synthetic_smoke.yaml", "--device", "cpu", *TINY,
            "train.batch_size=2", "train.log_every=1", "train.val_every=100", "train.val_steps=1",
            "train.ckpt_every=12", "solver.base_lr=0.003", f"output_dir={out}"]
    # steps 2-3 under torch.profiler (train.profile_start/stop)
    train_3d.main(args + ["train.max_steps=24", "train.profile_start=2", "train.profile_stop=4"])
    assert os.path.getsize(os.path.join(out, "profile", "trace.json")) > 0
    with open(os.path.join(out, "metrics.jsonl")) as f:
        losses = [r["train/loss"] for r in map(json.loads, f) if "train/loss" in r]
    assert len(losses) == 24
    assert np.mean(losses[-6:]) < np.mean(losses[:6]), losses
    assert checkpoint.Checkpointer(os.path.join(out, "checkpoints")).steps() == [11, 23]
    train_3d.main(args + ["train.max_steps=26"])  # resumes at step 24
    with open(os.path.join(out, "metrics.jsonl")) as f:
        steps = [r["step"] for r in map(json.loads, f) if "train/loss" in r]
    assert steps[24:] == [25, 26]
    assert checkpoint.Checkpointer(os.path.join(out, "checkpoints")).latest_step() == 25
