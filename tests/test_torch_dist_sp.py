"""The port's space axis on 4 gloo ranks, on the CPU: the ring fusion, the
space-sharded train step and the space-sharded whole-scene estimator,
against the port on one process and the JAX package on its 8-device virtual
mesh for the same MeshConfig, at tests/test_dist.py's tolerances; and the
per-rank index ops against the unsharded slice.

The workers and their harness are tests/test_torch_dist.py's (spawned gloo
ranks, a file:// rendezvous, a join deadline); this file runs in another
xdist worker, in parallel with that one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mvpnet_torch import ops
from mvpnet_torch.config import MeshConfig
from mvpnet_torch.dist import mesh as mesh_mod
from mvpnet_torch.dist.fusion import ring_knn_local
from tests.test_torch_dist import (
    assert_state_close,
    jax_ring,
    join_ranks,
    kill_ranks,
    port_model,
    publish,
    ring_inputs,
    run_step,
    start_ranks,
    tie_inputs,
    unsharded,
)

RING_MESHES = ((1, 4), (2, 2))  # (data, space) on 4 ranks
SP_CASES = {"d2s2": ((2, 2), 8), "d1s4": ((1, 4), 8), "d2s2_gather": ((2, 2), 6)}  # mesh, global batch
SCENE_MESHES = ((2, 2), (1, 4))
SCENE = dict(num_points=12000, num_frames=6, height=16, width=24, num_classes=5)


def _shard(a, S, s):
    n = len(a) // S
    return torch.from_numpy(np.ascontiguousarray(a[s * n : (s + 1) * n]))


def _four_rank_worker(rank, world, workdir, sp_cfg, sp_cfg_dropout, sp_params, sp_batches, sp_aug, scene_cfg,
                      scene_params):
    from mvpnet_torch.data.synthetic import make_scene
    from mvpnet_torch.eval.sharded_scene import predict_scene_sharded

    out = {"ring": {}, "sp": {}, "sp_dropout": {}, "scene": {}}
    for data, space in RING_MESHES:
        mesh = mesh_mod.make_mesh(MeshConfig(data, space))
        for name, args in (("random", ring_inputs(space)), ("ties", tie_inputs(space))):
            shards = [_shard(a, space, mesh.space_rank) for a in args]
            out["ring"][(data, space, name)] = (mesh.space_rank, ring_knn_local(*shards, k=3, mesh=mesh))

    for name, ((data, space), _) in SP_CASES.items():
        mesh = mesh_mod.make_mesh(MeshConfig(data, space))
        out["sp"][name] = run_step(sp_cfg, sp_params, sp_batches[name], mesh, aug=sp_aug[name])
        out["sp_dropout"][name] = run_step(sp_cfg_dropout, sp_params, sp_batches[name], mesh, aug=sp_aug[name])

    scene = make_scene(3, **SCENE)
    model = port_model(scene_cfg, scene_params).eval()
    for data, space in SCENE_MESHES:
        mesh = mesh_mod.make_mesh(MeshConfig(data, space))
        out["scene"][(data, space)] = predict_scene_sharded(model, scene_cfg, scene, mesh)

    # the per-rank index ops on this data rank's slice (data=4), and on a
    # batch of 3 rows, which stays whole on every rank
    mesh = mesh_mod.make_mesh(MeshConfig(4, 1))
    out["ops"] = {name: _ops(mesh_mod.shard_batch(mesh, b)) for name, b in _ops_batches().items()}
    return out


def _ops_batches() -> dict:
    rng = np.random.default_rng(0)
    full = {
        "pts": rng.uniform(-2, 2, (8, 256, 3)).astype(np.float32),
        "refs": rng.uniform(-2, 2, (8, 512, 3)).astype(np.float32),
        "feat": rng.normal(size=(8, 64, 16)).astype(np.float32),
    }
    return {"full": full, "odd": {k: v[:3] for k, v in full.items()}}


def _ops(b: dict) -> dict:
    pts, refs, feat = (torch.from_numpy(np.ascontiguousarray(b[k])) for k in ("pts", "refs", "feat"))
    d, idx = ops.knn(pts, refs, 3)
    idx_bq, cnt = ops.ball_query(pts[:, :32], pts, 0.4, 8)
    return {
        "knn_d": d, "knn_idx": idx,
        "fps": ops.farthest_point_sample(pts, 32),
        "bq_idx": idx_bq, "bq_cnt": cnt,
        "tnn": ops.three_nn_interpolate(pts, refs[:, :64], feat),
    }


def _sp_jax_cfg(dropout=0.0):
    from tests.test_models import tiny_config

    cfg = tiny_config()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, augment=True),
        model=dataclasses.replace(cfg.model, pn2=dataclasses.replace(cfg.model.pn2, dropout=dropout)),
        train=dataclasses.replace(cfg.train, donate=False),
        solver=dataclasses.replace(cfg.solver, optimizer="sgd", momentum=0.0),
    )


def sp_batch(B, V=4, H=8, W=8, N=64, seed=0):
    """tests/test_dist.py's space-sharded batch."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    poses[..., :3, 3] = rng.uniform(-1, 1, (B, V, 3))
    return {
        "points": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
        "seg_label": rng.integers(0, 5, (B, N)).astype(np.int32),
        "images": rng.uniform(size=(B, V, H, W, 3)).astype(np.float32),
        "depth": rng.uniform(0.5, 2, (B, V, H, W)).astype(np.float32),
        "poses": poses,
        "intrinsics": np.tile(np.eye(3, dtype=np.float32) * 8, (B, 1, 1)),
        "seg_label_2d": rng.integers(0, 5, (B, V, H, W)).astype(np.int32),
    }


def _scene_jax_cfg():
    from mvpnet_tpu.config import EvalConfig
    from tests.test_models import tiny_config
    from tests.test_pipeline import small_data_cfg

    # 3 scene views: padded to 4, so at space 4 the last shard's block is
    # padding alone (fewer than k real refs)
    return dataclasses.replace(
        tiny_config(),
        data=small_data_cfg(num_points=128, chunk_size=2.0, chunk_stride=1.5),
        eval=EvalConfig(scene_views=3, chunks_per_shard=1, batch_size=2),
    )


def _jax_chunk_draws(key, B: int, data) -> dict:
    """The augmentation parameters JAX's prepare_batch draws for a batch of
    B chunks from ``key`` (tests/test_torch_train._jax_chunk_params for each
    of its per-chunk keys, in one vmapped call)."""
    import jax
    import jax.numpy as jnp

    def draws(k):
        k1, k2, k3 = jax.random.split(k, 3)
        kx, ky = jax.random.split(k2)
        kb, kc = jax.random.split(k3)
        lo, hi = 1.0 - data.color_jitter, 1.0 + data.color_jitter
        return {
            "angle": jax.random.uniform(k1, (), minval=0.0, maxval=2.0 * jnp.pi),
            "flip_x": jax.random.bernoulli(kx, data.flip_prob),
            "flip_y": jax.random.bernoulli(ky, data.flip_prob),
            "brightness": jax.random.uniform(kb, (), minval=lo, maxval=hi),
            "contrast": jax.random.uniform(kc, (), minval=lo, maxval=hi),
        }

    return {k: np.asarray(v) for k, v in jax.vmap(draws)(jax.random.split(key, B)).items()}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    import jax
    from flax import nnx

    from mvpnet_tpu.config import MeshConfig as JaxMeshConfig
    from mvpnet_tpu.data.synthetic import make_scene as jax_make_scene
    from mvpnet_tpu.dist.mesh import make_mesh as jax_make_mesh
    from mvpnet_tpu.dist.train_sp import install_space_fusion, shard_batch_sp
    from mvpnet_tpu.eval.sharded_scene import predict_scene_sharded as jax_predict_scene_sharded
    from mvpnet_tpu.models import build_model as jax_build_model
    from mvpnet_tpu.train.solver import build_optimizer as jax_build_optimizer
    from mvpnet_tpu.train.step import make_train_step as jax_make_train_step
    from tests.test_torch_models import _flat_params, _port_cfg

    workdir = tmp_path_factory.mktemp("dist4") / "ranks"
    ctx = start_ranks(_four_rank_worker, 4, workdir)
    try:
        jcfg = _sp_jax_cfg()
        jmodel0, loss_fn, metric_fn = jax_build_model(jcfg, rngs=nnx.Rngs(0))
        params = _flat_params(jmodel0)  # the scene's model too: the same model config
        key = jax.random.key(7)
        batches = {name: sp_batch(B) for name, (_, B) in SP_CASES.items()}
        aug = {name: _jax_chunk_draws(key, B, jcfg.data) for name, (_, B) in SP_CASES.items()}
        scfg_jax = _scene_jax_cfg()
        cfg, scfg = _port_cfg(jcfg), _port_cfg(scfg_jax)
        cfg_dropout = _port_cfg(_sp_jax_cfg(dropout=0.5))
        publish(workdir, sp_cfg=cfg, sp_cfg_dropout=cfg_dropout, sp_params=params, sp_batches=batches, sp_aug=aug,
                scene_cfg=scfg, scene_params=params)

        # meanwhile: the port on one process, JAX's mesh
        single = {(name, dropout): run_step(c, params, batches[name], aug=aug[name])
                  for name in SP_CASES for dropout, c in ((0.0, cfg), (0.5, cfg_dropout))}
        jax_sp = {}
        for name, ((data, space), _) in SP_CASES.items():
            if name.endswith("gather"):
                continue  # B % (data * space) != 0: JAX keeps data-only sharding there; held against one process
            jmodel = nnx.clone(jmodel0)
            jmesh = jax_make_mesh(JaxMeshConfig(data=data, space=space), devices=jax.devices()[: data * space])
            install_space_fusion(jmodel, jmesh)
            opt = nnx.Optimizer(jmodel, jax_build_optimizer(jcfg.solver), wrt=nnx.Param)
            m = jax_make_train_step(jcfg, loss_fn, metric_fn)(jmodel, opt, shard_batch_sp(jmesh, batches[name]), key)
            jax_sp[name] = {"loss": float(m["loss"]), "accuracy": float(m["accuracy"]),
                            "confusion": np.asarray(m["confusion"]), "state": _flat_params(jmodel)}
        jscene = jax_make_scene(3, **SCENE)
        smodel = nnx.clone(jmodel0)
        smodel.eval()
        jax_scene = {}
        for data, space in SCENE_MESHES:
            jmesh = jax_make_mesh(JaxMeshConfig(data=data, space=space), devices=jax.devices()[: data * space])
            jax_scene[(data, space)] = jax_predict_scene_sharded(smodel, scfg_jax, jscene, jmesh)
        ranks = join_ranks(ctx, workdir)
    finally:
        kill_ranks(ctx)
    return dict(ranks=ranks, single=single, jax_sp=jax_sp, jax_scene=jax_scene, scene_cfg=scfg,
                scene_params=params)


def _ring_result(ranks, data, space, name):
    """The ring's output over every point: the space ranks' shards of the
    first data rank, in order (the other data ranks repeat them)."""
    parts = sorted(out["ring"][(data, space, name)] for out in ranks[:space])
    assert [p[0] for p in parts] == list(range(space))
    for out in ranks[space:]:  # another space group, the same answer
        s, got = out["ring"][(data, space, name)]
        for g, w in zip(got, parts[s][1]):
            assert torch.equal(g, w)
    return [torch.cat([p[1][i] for p in parts]).numpy() for i in range(3)]


@pytest.mark.parametrize("data,space", RING_MESHES)
def test_ring_fusion_on_gloo_ranks(four_ranks, devices, data, space):
    """The ring over gloo ranks against ops.knn + group_points over the
    whole cloud and JAX's sharded_fusion_knn (d, xyz, feat atol 1e-5); with
    pixels repeated across shards, JAX's ring's picks."""
    args = ring_inputs(space)
    got = _ring_result(four_ranks["ranks"], data, space, "random")
    for want in (unsharded(*args), jax_ring(space, *args)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=1e-5)
    ties = tie_inputs(space)
    got = _ring_result(four_ranks["ranks"], data, space, "ties")
    want = jax_ring(space, *ties)
    np.testing.assert_array_equal(got[2], want[2])  # the pixel indices
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
@pytest.mark.parametrize("name", list(SP_CASES))
def test_sp_step_grad_parity(four_ranks, name, dropout):
    """The space-sharded step (views split over space, the differentiable
    ring, the 3D net re-split by all_to_all, or by all-gather when the local
    batch does not divide), augmentation on, SGD: loss rtol 2e-4, accuracy
    atol 1e-6, equal confusion, every parameter and BN statistic atol 3e-4,
    rtol 3e-3, against one process and JAX's mesh; every rank ends with the
    same state. At dropout 0.5 the head's mask is the global batch's, each
    rank keeping the rows its 3D net runs; JAX's masks come from another
    generator, so it is held at dropout 0 only."""
    single_m, single_state = four_ranks["single"][(name, dropout)]
    want_jax = four_ranks["jax_sp"].get(name) if dropout == 0.0 else None
    states = []
    for out in four_ranks["ranks"]:
        m, st = out["sp" if dropout == 0.0 else "sp_dropout"][name]
        for want in [single_m] + ([want_jax] if want_jax else []):
            np.testing.assert_allclose(float(m["loss"]), float(want["loss"]), rtol=2e-4)
            np.testing.assert_allclose(float(m["accuracy"]), float(want["accuracy"]), atol=1e-6)
            np.testing.assert_array_equal(np.asarray(m["confusion"]), np.asarray(want["confusion"]))
        assert_state_close(st, single_state)
        if want_jax:
            assert_state_close(st, want_jax["state"])
        states.append(st)
    assert all(torch.equal(states[0][k], st[k]) for st in states[1:] for k in st)


def _scene_oracle(model, cfg, scene):
    """tests/test_dist.py's single-device oracle in the port: the same view
    set and windows, ops.knn over the whole (unpadded) scene cloud."""
    from mvpnet_torch.core.camera import unproject_views
    from mvpnet_torch.eval.sharded_scene import enumerate_scene_chunks, select_scene_views
    from mvpnet_torch.eval.whole_scene import nn_fill_uncovered

    frames = select_scene_views(scene, cfg.eval.scene_views)
    with torch.no_grad():
        xyz, _ = unproject_views(torch.from_numpy(scene.depth[frames]), torch.from_numpy(scene.intrinsics),
                                 torch.from_numpy(scene.poses[frames]))
        feat, _ = model.net_2d(torch.from_numpy(scene.rgb[frames].astype(np.float32)))
        pixel_xyz, pixel_feat = xyz.reshape(1, -1, 3), feat.reshape(1, xyz[..., 0].numel(), -1)
        acc = np.zeros((len(scene.points), cfg.data.num_classes), np.float32)
        counts = np.zeros(len(scene.points), np.int32)
        for sel, pts in enumerate_scene_chunks(scene, cfg):
            q = torch.from_numpy(pts)[None]
            _, idx = ops.knn(q, pixel_xyz, cfg.model.aggregation.k)
            fused = model.aggregation(q, ops.group_points(pixel_xyz, idx), ops.group_points(pixel_feat, idx))
            np.add.at(acc, sel, model.net_3d(q, fused)[0].numpy())
            np.add.at(counts, sel, 1)
    nn_fill_uncovered(scene.points, acc, counts)
    return acc


@pytest.mark.parametrize("data,space", SCENE_MESHES)
def test_sharded_scene_matches_oracle_jax_and_fused(four_ranks, data, space):
    """predict_scene_sharded over gloo ranks (3 views padded to 4) against
    its single-device oracle, JAX's predict_scene_sharded on the same mesh
    and the port's predict_scene_fused (atol 2e-4, rtol 1e-4); every rank
    returns the same logits."""
    from mvpnet_torch.data.synthetic import make_scene
    from mvpnet_torch.eval.scene_fused import predict_scene_fused

    got = [out["scene"][(data, space)] for out in four_ranks["ranks"]]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    cfg = four_ranks["scene_cfg"]
    model = port_model(cfg, four_ranks["scene_params"]).eval()
    scene = make_scene(3, **SCENE)
    for want in (_scene_oracle(model, cfg, scene), four_ranks["jax_scene"][(data, space)],
                 predict_scene_fused(model, cfg, scene)):
        np.testing.assert_allclose(got[0], want, atol=2e-4, rtol=1e-4)


def test_sharded_scene_on_the_loopback_mesh_equals_the_ranks(four_ranks, monkeypatch):
    """The loopback mesh (the shards in one process) gives the logits of the
    gloo ranks bit for bit; a scene without a window is filled with zeros."""
    from mvpnet_torch.data.synthetic import make_scene
    from mvpnet_torch.eval import sharded_scene

    cfg = four_ranks["scene_cfg"]
    model = port_model(cfg, four_ranks["scene_params"]).eval()
    scene = make_scene(3, **SCENE)
    got = sharded_scene.predict_scene_sharded(model, cfg, scene, mesh_mod.make_mesh(local=4))
    np.testing.assert_array_equal(got, four_ranks["ranks"][0]["scene"][(1, 4)])
    monkeypatch.setattr(sharded_scene, "enumerate_scene_chunks", lambda scene, cfg: [])
    empty = sharded_scene.predict_scene_sharded(model, cfg, scene, mesh_mod.make_mesh(local=2))
    assert empty.shape == got.shape and not empty.any()


def test_per_rank_ops_equal_the_unsharded_slice(four_ranks, devices):
    """The index ops on each data rank's slice (data=4) equal the unsharded
    batch's rows, and JAX's unmeshed ops (indices equal, distances and
    interpolation to 1e-5); a batch of 3 rows stays whole on every rank."""
    import jax.numpy as jnp

    from mvpnet_tpu import ops as jops

    batches = _ops_batches()
    want = _ops(batches["full"])
    b = {k: jnp.asarray(v) for k, v in batches["full"].items()}
    jd, jidx = jops.knn(b["pts"], b["refs"], 3)
    jbq, jcnt = jops.ball_query(b["pts"][:, :32], b["pts"], 0.4, 8)
    jwant = {"knn_d": jd, "knn_idx": jidx, "fps": jops.farthest_point_sample(b["pts"], 32), "bq_idx": jbq,
             "bq_cnt": jcnt, "tnn": jops.three_nn_interpolate(b["pts"], b["refs"][:, :64], b["feat"])}
    odd = _ops(batches["odd"])
    for rank, out in enumerate(four_ranks["ranks"]):
        rows = slice(2 * rank, 2 * rank + 2)
        for k, v in out["ops"]["full"].items():
            assert torch.equal(v, want[k][rows]), k
            if k in ("knn_d", "tnn"):  # test_torch_ops.py's port-vs-JAX tolerance
                np.testing.assert_allclose(v.numpy(), np.asarray(jwant[k])[rows], rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_array_equal(v.numpy(), np.asarray(jwant[k])[rows])
        for k, v in out["ops"]["odd"].items():
            assert torch.equal(v, odd[k]), k
