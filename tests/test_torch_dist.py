"""The port's multi-device layer (mvpnet_torch.dist, the mesh-aware train
step and loop, the sharded CLI) on the CPU: gloo ranks in worker processes
against the port on one process and against the JAX package on its
8-device virtual mesh, at tests/test_dist.py's tolerances.

The rank workers live in this module and import only torch, numpy and
mvpnet_torch; JAX runs in the test process, imported inside the tests.
Workers start with torch.multiprocessing's spawn, meet through a
``file://`` rendezvous under the test's tmp_path (no ports), take weights
and inputs from files there and write their results back there. Every spawn
has a join deadline after which its workers are killed and the test fails,
and every gloo group has a finite timeout, so a hung collective fails a
test instead of the suite.

This file: the mesh layout and batch slices, the bootstrap without a
launcher and with an unreachable coordinator, merge_topk, the ring on the
loopback mesh, and 2 ranks: the data-parallel train step with unequal
valid-label counts, ``train()`` on a data mesh with its resume, and
``cli.train_3d`` then ``cli.test_3d --sharded``. tests/test_torch_dist_sp.py
runs 4 ranks: the ring, the space-sharded step, the sharded scene.
"""
import dataclasses
import datetime
import logging
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from mvpnet_torch import convert, ops
from mvpnet_torch.config import MeshConfig
from mvpnet_torch.dist import bootstrap, fusion, train_sp
from mvpnet_torch.dist import mesh as mesh_mod

GLOO_TIMEOUT = datetime.timedelta(seconds=60)
JOIN_TIMEOUT = 240.0  # seconds a spawn may take before its workers are killed


# ---------------------------------------------------------------------------
# Rank workers
# ---------------------------------------------------------------------------


def _rank_entry(rank, fn, world, workdir):
    # TensorBoard's import (tensorflow, where installed) costs a worker many
    # seconds; the metric writer falls back to its JSONL, which the tests read
    sys.modules["torch.utils.tensorboard"] = None
    torch.set_num_threads(1)
    inputs = _wait_for_inputs(workdir)
    bootstrap.initialize(f"file://{workdir}/rendezvous", world, rank, device="cpu", timeout=GLOO_TIMEOUT)
    try:
        out = fn(rank, world, workdir, **inputs)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        bootstrap.shutdown()


def _wait_for_inputs(workdir) -> dict:
    path = os.path.join(workdir, "inputs.pt")
    deadline = time.monotonic() + JOIN_TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def start_ranks(fn, nprocs: int, workdir):
    """Spawn ``nprocs`` gloo ranks; each starts (imports) at once, then
    waits for ``publish``'s inputs and runs ``fn(rank, world, workdir,
    **inputs)``, saving what it returns. Returns the spawn context."""
    os.makedirs(workdir, exist_ok=True)
    return mp.start_processes(_rank_entry, args=(fn, nprocs, str(workdir)), nprocs=nprocs, join=False,
                              start_method="spawn")


def publish(workdir, **inputs) -> None:
    """Hand the ranks their inputs (written whole, then renamed)."""
    tmp = os.path.join(workdir, "inputs.tmp")
    torch.save(inputs, tmp)
    os.replace(tmp, os.path.join(workdir, "inputs.pt"))


def join_ranks(ctx, workdir, timeout: float = JOIN_TIMEOUT) -> list:
    """Wait for every rank (a worker's exception fails here); past the
    deadline the workers are killed and the test fails. Returns each rank's
    result."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"ranks did not finish within {timeout:.0f} s")
    finally:
        kill_ranks(ctx)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(len(ctx.processes))]


def kill_ranks(ctx) -> None:
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
            p.join(5.0)


def port_model(cfg, params: dict):
    """The port's model of ``cfg`` with the JAX weights ``params``."""
    from mvpnet_torch.models.build import build_model

    model, _, _ = build_model(cfg)
    convert.load_jax_params(model, params)
    return model


def state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def run_step(cfg, params, batch, mesh=None, aug=None):
    """One train step (SGD in the tests' configs) of the port: on one
    process, or on this rank of ``mesh`` as train() runs it (DDP, the mesh
    on BN, loss and metrics, the ring when space-sharded). ``aug``: the
    global batch's augmentation parameters, injected for the generator's
    draws. Returns (metrics, state after the step)."""
    from mvpnet_torch.models.build import loss_and_metrics
    from mvpnet_torch.train import loop, solver
    from mvpnet_torch.train import step as step_mod

    model = port_model(cfg, params).train()
    step_model = model
    if mesh is not None:
        step_model, specs = loop.distribute(model, mesh, torch.device("cpu"))
        batch = train_sp.shard_batch_sp(mesh, batch) if specs else mesh_mod.shard_batch(mesh, batch)
    loss_fn, metric_fn = loss_and_metrics(cfg, mesh)
    optimizer = solver.build_optimizer(cfg.solver, model.parameters())
    train_step = step_mod.make_train_step(cfg, loss_fn, metric_fn, mesh)
    sample_chunk_params = step_mod.sample_chunk_params
    if aug is not None:
        rows = next(iter(aug.values())).shape[0]

        def injected(gen, n, **kw):
            assert n == rows, (n, rows)  # drawn for the global batch on every rank
            return {k: torch.from_numpy(np.array(v)) for k, v in aug.items()}

        step_mod.sample_chunk_params = injected
    try:
        m = train_step(step_model, optimizer, tensors(batch), torch.Generator())
    finally:
        step_mod.sample_chunk_params = sample_chunk_params
    return {k: v.detach().clone() for k, v in m.items()}, state(model)


def _capture_log() -> list:
    """The messages the port's logger takes from now on."""
    from mvpnet_torch.utils.logger import setup_logger

    records: list = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    setup_logger().addHandler(Keep())
    return records


def _two_rank_worker(rank, world, workdir, cfg, cfg_dropout, params, batch, train_cfg, cli):
    out = {"describe": bootstrap.describe(), "device": str(bootstrap.device())}
    # mesh layout: data=-1 takes every rank; (1, 2); a mesh that does not fit
    for data, space in ((-1, 1), (1, 2), (4, 1)):
        try:
            m = mesh_mod.make_mesh(MeshConfig(data, space))
            out[f"mesh_{data}_{space}"] = (m.data, m.space, m.data_rank, m.space_rank, m.space_ranks, m.syncs)
        except ValueError as e:
            out[f"mesh_{data}_{space}"] = str(e)
    mesh = mesh_mod.make_mesh(MeshConfig(2, 1))
    out["dp"] = run_step(cfg, params, batch, mesh)
    out["dp_dropout"] = run_step(cfg_dropout, params, batch, mesh)

    # train() on the data mesh, then resumed for one more step
    from mvpnet_torch.train.loop import train

    log = _capture_log()
    model, val = train(train_cfg, max_steps=2, resume=True, device="cpu")
    out["train"] = {"val_loss": val["loss"], "state": state(model)}
    model, _ = train(train_cfg, max_steps=3, resume=True, device="cpu")
    out["resume"] = {"state": state(model), "log": list(log)}

    # the command lines: cli.train_3d on the data mesh, cli.test_3d --sharded
    # over (data=1, space=2)
    from mvpnet_torch.cli import test_3d, train_3d

    train_3d.main(cli["train"])
    out["test_3d"] = test_3d.main(cli["test"])
    return out


# ---------------------------------------------------------------------------
# Fixtures: the 2-rank spawn runs while the test process computes JAX's side
# ---------------------------------------------------------------------------


def _dp_cfgs(dropout=0.0):
    from tests.test_models import tiny_config
    from tests.test_torch_models import _port_cfg

    jcfg = tiny_config()
    jcfg = dataclasses.replace(
        jcfg,
        data=dataclasses.replace(jcfg.data, augment=False),
        model=dataclasses.replace(jcfg.model, pn2=dataclasses.replace(jcfg.model.pn2, dropout=dropout)),
        train=dataclasses.replace(jcfg.train, donate=False),
        solver=dataclasses.replace(jcfg.solver, optimizer="sgd", momentum=0.0),
    )
    return jcfg, _port_cfg(jcfg)


def dp_batch(B=8, V=2, H=8, W=8, N=32):
    """tests/test_dist.py's DP batch, with most labels of the second half
    (rank 1's chunks) ignored: unequal valid counts across the ranks."""
    rng = np.random.default_rng(0)
    batch = {
        "points": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
        "seg_label": rng.integers(0, 5, (B, N)).astype(np.int32),
        "images": rng.uniform(size=(B, V, H, W, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 2, (B, V, H, W)).astype(np.float32),
        "poses": np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1)),
        "intrinsics": np.tile(np.eye(3, dtype=np.float32) * 8, (B, 1, 1)),
        "seg_label_2d": rng.integers(0, 5, (B, V, H, W)).astype(np.int32),
    }
    batch["seg_label"][B // 2 :, 5:] = -100
    batch["seg_label_2d"][B // 2 :, :, 2:] = -100
    return batch


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The 2-rank run and everything it is compared with."""
    import jax
    from flax import nnx

    from mvpnet_tpu.config import MeshConfig as JaxMeshConfig
    from mvpnet_tpu.dist.mesh import make_mesh as jax_make_mesh
    from mvpnet_tpu.dist.mesh import shard_batch as jax_shard_batch
    from mvpnet_tpu.models import build_model as jax_build_model
    from mvpnet_tpu.train.solver import build_optimizer as jax_build_optimizer
    from mvpnet_tpu.train.step import make_train_step as jax_make_train_step
    from mvpnet_torch.config import load_config
    from tests.test_torch_cli import CFG_3D, RUN, WINDOWS
    from tests.test_torch_models import _flat_params
    from tests.test_torch_train import TINY

    workdir = tmp_path_factory.mktemp("dist2")
    ctx = start_ranks(_two_rank_worker, 2, workdir / "ranks")
    try:
        jcfg, cfg = _dp_cfgs()
        jmodel, loss_fn, metric_fn = jax_build_model(jcfg, rngs=nnx.Rngs(0))
        params = _flat_params(jmodel)
        batch = dp_batch()
        run_dir, cli_dir = str(workdir / "run"), str(workdir / "cli")
        train_over = [*TINY, "train.batch_size=4", "train.log_every=1", "train.val_every=2", "train.val_steps=1",
                      "train.ckpt_every=2", "data.num_workers=1", "mesh.data=2"]
        train_cfg = load_config(CFG_3D, train_over + [f"output_dir={run_dir}"])
        cli_over = [*TINY, *WINDOWS, f"output_dir={cli_dir}"]
        cli = {
            "train": ["--cfg", CFG_3D, "--device", "cpu", *cli_over, *RUN, "train.batch_size=4", "mesh.data=2"],
            "test": ["--cfg", CFG_3D, "--device", "cpu", "--sharded", *cli_over, "mesh.data=1", "mesh.space=2"],
        }
        cfg_dropout = _dp_cfgs(dropout=0.5)[1]
        publish(workdir / "ranks", cfg=cfg, cfg_dropout=cfg_dropout, params=params, batch=batch,
                train_cfg=train_cfg, cli=cli)

        # meanwhile: the port on one process and JAX's DP step on 2 devices
        single = {0.0: run_step(cfg, params, batch), 0.5: run_step(cfg_dropout, params, batch)}
        jmesh = jax_make_mesh(JaxMeshConfig(data=2, space=1), devices=jax.devices()[:2])
        optimizer = nnx.Optimizer(jmodel, jax_build_optimizer(jcfg.solver), wrt=nnx.Param)
        jm = jax_make_train_step(jcfg, loss_fn, metric_fn)(jmodel, optimizer, jax_shard_batch(jmesh, batch),
                                                            jax.random.key(0))
        jax_out = {"loss": float(jm["loss"]), "state": _flat_params(jmodel)}
        ranks = join_ranks(ctx, workdir / "ranks")
    finally:
        kill_ranks(ctx)
    return dict(cfg=cfg, single=single, jax=jax_out, ranks=ranks, run_dir=run_dir, cli_dir=cli_dir,
                cli_over=cli_over, batch=batch)


def assert_state_close(got: dict, want: dict, atol=3e-4, rtol=3e-3):
    """Port state against a port state (same keys) or JAX's flat state."""
    if set(want) == set(got):
        for k in want:
            np.testing.assert_allclose(got[k].float().numpy(), want[k].float().numpy(), atol=atol, rtol=rtol, err_msg=k)
        return
    for key, value in want.items():
        tkey, arr = convert._torch_key(key, value)
        np.testing.assert_allclose(got[tkey].float().numpy(), arr, atol=atol, rtol=rtol, err_msg=key)


# ---------------------------------------------------------------------------
# The mesh and the bootstrap, in this process
# ---------------------------------------------------------------------------


def test_rank_layout_matches_jax_mesh(devices):
    """Rank r sits where JAX's reshape(data, space) puts device r; its
    shard_batch and shard_batch_sp slices are that device's shards of JAX's
    shard_batch and shard_batch_sp (a leading dim that does not divide
    stays whole)."""
    from mvpnet_tpu.config import MeshConfig as JaxMeshConfig
    from mvpnet_tpu.dist.mesh import make_mesh as jax_make_mesh
    from mvpnet_tpu.dist.mesh import shard_batch as jax_shard_batch
    from mvpnet_tpu.dist.train_sp import shard_batch_sp as jax_shard_batch_sp

    rng = np.random.default_rng(0)
    batch = {
        "points": rng.normal(size=(8, 16, 3)).astype(np.float32),
        "images": rng.normal(size=(8, 4, 2, 2, 3)).astype(np.float32),
        "poses": rng.normal(size=(8, 4, 4, 4)).astype(np.float32),
        "intrinsics": rng.normal(size=(8, 3, 3)).astype(np.float32),
    }
    odd = {"points": batch["points"][:3], "intrinsics": rng.normal(size=(3, 3)).astype(np.float32)}
    for data, space in ((8, 1), (4, 2), (2, 4)):
        jmesh = jax_make_mesh(JaxMeshConfig(data=-1 if data == 8 else data, space=space))
        assert dict(jmesh.shape) == {"data": data, "space": space}
        jdp, jsp = jax_shard_batch(jmesh, batch), jax_shard_batch_sp(jmesh, batch)
        jodd = jax_shard_batch(jmesh, odd)
        for rank in range(8):
            mesh = mesh_mod.Mesh(data=data, space=space, rank=rank, world=8)
            device = jmesh.devices[mesh.data_rank, mesh.space_rank]
            assert device.id == rank
            dp, sp = mesh_mod.shard_batch(mesh, batch), train_sp.shard_batch_sp(mesh, batch)
            for k in batch:
                (want,) = [s.data for s in jdp[k].addressable_shards if s.device == device]
                np.testing.assert_array_equal(dp[k], np.asarray(want))
                (want,) = [s.data for s in jsp[k].addressable_shards if s.device == device]
                np.testing.assert_array_equal(sp[k], np.asarray(want))
            for k, v in mesh_mod.shard_batch(mesh, odd).items():
                np.testing.assert_array_equal(v, odd[k])
                assert jodd[k].sharding.is_fully_replicated
    specs = train_sp.batch_specs({**batch, "seg_label_2d": batch["images"][..., 0], "step": np.zeros(())})
    assert specs["images"] == specs["seg_label_2d"] == ("data", "space")
    assert specs["points"] == specs["intrinsics"] == ("data",) and specs["step"] == ()
    local = bootstrap.make_global_batch(mesh_mod.Mesh(data=2, space=2, rank=3, world=4), batch, specs)
    np.testing.assert_array_equal(local["images"], batch["images"][:, 2:])
    np.testing.assert_array_equal(local["points"], batch["points"])


def test_without_a_launcher_nothing_changes(monkeypatch):
    """No launcher environment: initialize creates no group, make_mesh is
    one rank (a mesh over several raises), and BN keeps F.batch_norm's code
    even with that mesh installed: bit-equal outputs and statistics."""
    from mvpnet_torch.models.blocks import BatchNorm, Dropout

    for name in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert bootstrap.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized() and bootstrap.is_primary() and bootstrap.device() is None
    mesh = mesh_mod.make_mesh(MeshConfig())
    assert (mesh.data, mesh.space, mesh.world, mesh.syncs, mesh.ddp_group) == (1, 1, 1, False, None)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_mod.make_mesh(MeshConfig(data=2, space=1))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 5, 6)).astype(np.float32))
    plain, meshed = BatchNorm(6), mesh_mod.install(torch.nn.Sequential(BatchNorm(6), Dropout(0.5)), mesh)
    assert meshed[0].mesh is mesh and meshed[1].mesh is mesh
    assert torch.equal(plain(x), meshed[0](x))
    assert torch.equal(plain.running_var, meshed[0].running_var)
    assert bootstrap.global_batch_to_local(8, mesh) == 8


def test_dropout_keeps_each_ranks_rows_of_one_global_mask():
    """Dropout(0.5) over ones(8, 64, 16) on fake ranks (a Mesh without
    groups) gives the one-process output: data ranks keep their slice of
    the global batch's mask; space ranks after the all_to_all keep their
    share of their data rank's chunks (``train_sp.local_rows``), and after
    the all-gather (a local batch that space does not divide) all of them.
    Every rank draws the global shape, so a second call agrees too."""
    from mvpnet_torch.models.blocks import Dropout

    def ranks(data, space, B):
        x = torch.ones(B, 64, 16)
        want = Dropout(0.5).train()
        want = [want(x), want(x)]
        b_local = B // data
        for rank in range(data * space):
            mesh = mesh_mod.Mesh(data=data, space=space, rank=rank, world=data * space)
            drop = mesh_mod.install(Dropout(0.5).train(), mesh)
            rows = None if space == 1 else train_sp.local_rows(mesh, b_local)
            first, total = rows or (mesh.data_rank * b_local, B)
            n = b_local // space if b_local % space == 0 else b_local
            assert total == B
            for w in want:
                assert torch.equal(drop(x[first : first + n], rows=rows), w[first : first + n]), (data, space, rank)

    ranks(2, 1, 8)  # data-parallel: rank 1's rows drew rank 1's own mask before
    ranks(2, 2, 8)  # space-sharded, all_to_all: 2 chunks a rank
    ranks(2, 2, 6)  # space-sharded, all-gather: 3 chunks on each space rank
    ranks(1, 4, 8)


def test_unreachable_coordinator_raises(monkeypatch):
    """JAX's environment names with a coordinator nobody serves: initialize
    fails instead of carrying on as one process."""
    with socket.socket() as s:  # a localhost port that nothing listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("COORDINATOR_ADDRESS", f"127.0.0.1:{port}")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="coordinator was configured"):
        bootstrap.initialize(device="cpu", timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()


def test_merge_topk_is_stable_like_jax(devices):
    """merge_topk against JAX's _merge_topk on rows full of equal distances:
    the same picks (best first, then the earlier entry)."""
    import jax.numpy as jnp

    from mvpnet_tpu.dist.fusion import _merge_topk

    rng = np.random.default_rng(1)
    d = rng.integers(0, 3, (2, 7, 8)).astype(np.float32)  # many ties
    xyz = rng.normal(size=(2, 7, 8, 3)).astype(np.float32)
    feat = np.arange(2 * 7 * 8 * 2, dtype=np.float32).reshape(2, 7, 8, 2)
    halves = [(d[..., :4], xyz[..., :4, :], feat[..., :4, :]), (d[..., 4:], xyz[..., 4:, :], feat[..., 4:, :])]
    want = _merge_topk(*[tuple(jnp.asarray(a) for a in h) for h in halves], 4)
    got = fusion.merge_topk(*[tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in h) for h in halves], 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def ring_inputs(S, seed=0, C=6):
    """tests/test_dist.py's ring inputs at ``space`` S."""
    rng = np.random.default_rng(seed)
    N, P = 64 * S, 128 * S
    return (rng.uniform(-2, 2, (N, 3)).astype(np.float32), rng.uniform(-2, 2, (P, 3)).astype(np.float32),
            rng.normal(size=(P, C)).astype(np.float32))


def tie_inputs(S):
    """Ring inputs whose pixels repeat across shards (block 0's positions
    in every block), each feature its global pixel index: the ring's picks
    on exact ties are visible."""
    points, pix, _ = ring_inputs(S, seed=2)
    block = len(pix) // S
    pix = np.tile(pix[:block], (S, 1))
    return points, pix, np.arange(len(pix), dtype=np.float32)[:, None]


def unsharded(points, pix, feat, k=3):
    d, idx = ops.knn(torch.from_numpy(points)[None], torch.from_numpy(pix)[None], k)
    gx = ops.group_points(torch.from_numpy(pix)[None], idx)
    gf = ops.group_points(torch.from_numpy(feat)[None], idx)
    return d[0].numpy(), gx[0].numpy(), gf[0].numpy()


def jax_ring(S, points, pix, feat, k=3):
    import jax
    import jax.numpy as jnp

    from mvpnet_tpu.dist.fusion import sharded_fusion_knn

    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:S]).reshape(1, S), ("data", "space"))
    out = sharded_fusion_knn(mesh, jnp.asarray(points), jnp.asarray(pix), jnp.asarray(feat), k)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("space", [2, 4])
def test_loopback_ring_matches_unsharded_and_jax(devices, space):
    """The ring on the loopback mesh (S shards in this process) against
    ops.knn + group_points over the whole cloud and JAX's
    sharded_fusion_knn (atol 1e-5); with pixels repeated across shards, the
    same picks as JAX's ring."""
    mesh = mesh_mod.make_mesh(local=space)
    args = ring_inputs(space)
    got = fusion.sharded_fusion_knn(mesh, *map(torch.from_numpy, args), 3)
    for want in (unsharded(*args), jax_ring(space, *args)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
    ties = tie_inputs(space)
    got = fusion.sharded_fusion_knn(mesh, *map(torch.from_numpy, ties), 3)
    want = jax_ring(space, *ties)
    np.testing.assert_array_equal(got[2].numpy(), want[2])  # the pixel indices
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5)


def test_loopback_mesh_is_explicit():
    """Only make_mesh(local=S) builds it; space-sharded training refuses it."""
    mesh = mesh_mod.make_mesh(local=3)
    assert mesh.loopback and list(mesh.shards) == [0, 1, 2] and not mesh.syncs
    assert not mesh_mod.make_mesh(MeshConfig(data=-1, space=1)).loopback
    with pytest.raises(ValueError, match="at least one shard"):
        mesh_mod.make_mesh(local=0)

    class Fusion(torch.nn.Module):
        aggregation = None

    with pytest.raises(ValueError, match="loopback"):
        train_sp.install_space_fusion(Fusion(), mesh)


# ---------------------------------------------------------------------------
# 2 gloo ranks
# ---------------------------------------------------------------------------


def test_two_ranks_bootstrap_and_mesh(two_ranks):
    for rank, out in enumerate(two_ranks["ranks"]):
        assert out["describe"] == f"distributed: backend gloo, rank {rank}, world 2, device cpu"
        assert out["mesh_-1_1"] == (2, 1, rank, 0, (rank,), True)
        assert out["mesh_1_2"] == (1, 2, 0, rank, (0, 1), True)
        assert "needs 4 ranks, have 2" in out["mesh_4_1"]


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_dp_step_matches_one_process_and_jax(two_ranks, dropout):
    """The data-parallel step at 2 ranks, with unequal valid counts, against
    the port on one process and JAX's DP step: loss rtol 2e-4, params and
    BN statistics after one SGD step atol 3e-4, rtol 3e-3; both ranks end
    with the same state. At dropout 0.5 each rank keeps its rows of the
    global batch's mask, so the step is the one-process step; JAX's masks
    come from another generator, so JAX is held at dropout 0 only."""
    key = "dp" if dropout == 0.0 else "dp_dropout"
    single_m, single_state = two_ranks["single"][dropout]
    for m, st in (out[key] for out in two_ranks["ranks"]):
        np.testing.assert_allclose(float(m["loss"]), float(single_m["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(m["accuracy"]), float(single_m["accuracy"]), atol=1e-6)
        assert torch.equal(m["confusion"], single_m["confusion"])
        assert_state_close(st, single_state)
        if dropout == 0.0:
            np.testing.assert_allclose(float(m["loss"]), two_ranks["jax"]["loss"], rtol=2e-4)
            assert_state_close(st, two_ranks["jax"]["state"])
    a, b = (out[key][1] for out in two_ranks["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the local losses differ: the counts were unequal
    valid = two_ranks["batch"]["seg_label"] != -100
    assert valid[:4].sum() > 2 * valid[4:].sum()


def test_train_on_a_data_mesh_and_resume(two_ranks):
    """train() at mesh.data=2: a finite val loss; config, metrics and
    checkpoints written once (rank 0); both ranks hold the same parameters;
    a second train() resumes on both ranks."""
    ranks, run = two_ranks["ranks"], two_ranks["run_dir"]
    assert all(np.isfinite(out["train"]["val_loss"]) for out in ranks)
    assert os.path.exists(os.path.join(run, "config.yaml"))
    from mvpnet_torch.train.checkpoint import Checkpointer

    assert Checkpointer(os.path.join(run, "checkpoints")).steps() == [1, 2]
    import json

    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [r["step"] for r in map(json.loads, f) if "train/loss" in r]
    assert steps == [1, 2, 3]  # one writer
    for key in ("train", "resume"):
        a, b = (out[key]["state"] for out in ranks)
        assert all(torch.equal(a[k], b[k]) for k in a), key
    for out in ranks:
        assert "resumed from step 1" in out["resume"]["log"]
        assert any(line.startswith("distributed: backend gloo") for line in out["resume"]["log"])


def test_cli_test_3d_sharded_on_a_two_rank_checkpoint(two_ranks):
    """cli.train_3d on 2 ranks, then cli.test_3d --sharded over space=2:
    both ranks print the results that evaluate_scenes gives with the
    loopback mesh on the restored model, in this process."""
    from mvpnet_torch.cli.test_3d import restore
    from mvpnet_torch.config import load_config
    from mvpnet_torch.data.pipeline import build_dataset
    from mvpnet_torch.eval.whole_scene import evaluate_scenes
    from tests.test_torch_cli import CFG_3D

    cfg = load_config(CFG_3D, two_ranks["cli_over"] + ["mesh.data=1", "mesh.space=2"])
    model, step = restore(cfg, "cpu")
    assert step == 1
    scenes = build_dataset(cfg.data, batch_size=1, training=False, seed=0).scenes
    want = evaluate_scenes(model, cfg, scenes, mesh=mesh_mod.make_mesh(local=2))
    for out in two_ranks["ranks"]:
        got = out["test_3d"]
        assert set(got) == set(want)
        np.testing.assert_allclose(got["miou"], want["miou"], atol=1e-6)
        np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-6)
        np.testing.assert_allclose(list(got["class_iou"].values()), list(want["class_iou"].values()), atol=1e-6)
