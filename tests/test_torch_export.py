"""The port's deployment path on the CPU at tests/test_eval.py's eval_cfg
(float32, tiny widths): the kernels as torch.library ops (opcheck on each),
the torch.export artifact (eval/export_model.py) against the eager forward
and against the JAX package's jax.export artifact on the same weights,
cli.export_3d and cli.serve_3d.

The JAX model first runs one train-mode forward so every BN has nontrivial
running statistics, and its weights go to the port's model through
mvpnet_torch.convert.load_jax_params, as tests/test_torch_models.py does;
the two artifacts are held to that file's parity tolerances (_agree).
"""
import io
import json
import os
import shutil
import threading
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from flax import nnx
from torch.library import opcheck

from mvpnet_tpu.eval import export_model as jexport_model
from mvpnet_tpu.models import build_model as jax_build_model
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import convert, ops
from mvpnet_torch.cli import export_3d, serve_3d
from mvpnet_torch.entry import example_batch
from mvpnet_torch.eval import export_model
from mvpnet_torch.models import build_model
from mvpnet_torch.ops import _cuda, _library, ballquery, fps, knn_gated, knn_resident, morton
from mvpnet_torch.train.checkpoint import Checkpointer
from mvpnet_torch.train.step import prepare_batch
from tests.test_eval import eval_cfg
from tests.test_torch_cli import CFG_3D
from tests.test_torch_models import _agree, _flat_params, _port_cfg, jax_keys
from tests.test_torch_train import TINY

B = 2


def _pts(rng, b, n):
    return torch.from_numpy(rng.uniform(-2, 2, (b, n, 3)).astype(np.float32))


def _op_cases(rng):
    """Small CPU arguments of each mvpnet:: op (masks, the pair counter and
    padded tiles included)."""
    q, r = _pts(rng, 2, 40), _pts(rng, 2, 300)
    mask = torch.from_numpy(rng.random((2, 300)) > 0.2)
    scanned = torch.zeros(1, dtype=torch.int64)
    p = morton.prepare_refs(r, 64)
    return {
        "knn_fusion": (q, r, 3, "brute", None),
        "knn_prepared": (q, p.r4, p.boxes, p.refs, p.n, p.tile_n, 3, scanned),
        "fps": (r, 16, mask),
        "fps_perrow": (r, 16, None),
        "ball_query": (q, r, 0.8, 8, mask),
        "knn": (q, r, 3),
        "knn_gated": (q, r, 3, True, scanned),
        "knn_resident": (q, r, 3, False, None),
        "morton_prep": (q, r, 32, 64, True),
    }


@pytest.mark.parametrize("name", sorted(_library.OPS))
def test_opcheck(rng, name):
    """Schema, fake (shape-only) implementation, autograd registration and
    tracing of each op, on its CPU implementation (the plain version)."""
    opcheck(_library.OPS[name], _op_cases(rng)[name])


# each op's C entry points (csrc/<lib>.cu) and the ops.KERNELS counter its launch adds to
CUDA_ENTRIES = {
    "knn_fusion": (["knn_fusion.knn_fusion"], "knn_fusion"),
    "knn_prepared": (["knn_fusion.knn_fusion_demand"], "knn_fusion"),
    "fps": (["fps.fps"], "fps"),
    "fps_perrow": (["fps.fps_perrow"], "fps_perrow"),
    "ball_query": (["ballquery.ball_query"], "ball_query"),
    "knn": (["knn.knn_brute"], "knn"),
    # the prep is the op mvpnet::morton_prep, dispatched by the tensors' real device
    "knn_gated": (["knn_gated.knn_gated"], "knn_gated"),
    "knn_resident": (["knn_resident.knn_resident"], "knn_resident"),
    "morton_prep": (["morton.morton_sort", "morton.morton_tiles"], "morton_prep"),
}


def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("name", sorted(_library.OPS))
def test_cuda_implementation_host_code(rng, monkeypatch, name):
    """Each op's CUDA implementation up to its launches, on CPU tensors with
    the card stood in for (no launch runs): it calls its C entry points,
    adds one to its kernel's count, and returns outputs of the fake
    implementation's shapes and dtypes (what an exported graph expects)."""
    args = _op_cases(rng)[name]
    want = getattr(torch.ops.mvpnet, name)(*map(_meta, args))
    launched = []
    monkeypatch.setattr(_cuda, "function", lambda lib, fn: types.SimpleNamespace(name=f"{lib}.{fn}"))
    monkeypatch.setattr(_cuda, "launch", lambda fn, *a: launched.append(fn.name))
    monkeypatch.setattr(_cuda, "stream", lambda t: 0)
    for mod in (ops.KERNELS["knn"], ballquery, knn_gated, knn_resident):
        monkeypatch.setattr(mod, "_sms", lambda device: 132)
    monkeypatch.setattr(fps, "shared_bytes", lambda device: 232448)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: types.SimpleNamespace(multi_processor_count=132))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    routes = ("brute", "demand") if name == "knn_fusion" else (None,)
    try:
        for route in routes:
            launched.clear()
            ops.reset_launch_counts()
            call = args if route is None else (*args[:3], route, torch.zeros(1, dtype=torch.int64))
            got = _library.OPS[name]._init_fn(*call)
            entries, kernel = CUDA_ENTRIES[name]
            assert launched == (["knn_fusion.knn_fusion_demand"] if route == "demand" else entries)
            assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0) | {kernel: 1}
            got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
            assert [(tuple(g.shape), g.dtype) for g in got] == [(tuple(w.shape), w.dtype) for w in want]
    finally:
        ops.reset_launch_counts()  # no stand-in launch may reach another test's counts


def test_ops_cover_every_kernel():
    assert set(ops.KERNELS) | {"knn_prepared"} == set(_library.OPS)
    assert all(op._opoverload.namespace == "mvpnet" for op in _library.OPS.values())


@pytest.mark.parametrize("sort_refs", [True, False], ids=["sorted_refs", "refs_in_order"])
def test_morton_prep_plain_layout_matches_prepare(rng, sort_refs):
    """mvpnet::morton_prep's CPU implementation is the plain chain in the
    card's layout: viewed as floats, it gives prepare's operands back."""
    q, r = _pts(rng, 2, 40), _pts(rng, 2, 300)
    q4, r4, *rest = torch.ops.mvpnet.morton_prep(q, r, 32, 64, sort_refs)
    got = morton.DevicePrepared(q4.view(torch.float32), r4.view(torch.float32), *rest, 40, 300, sort_refs, 32, 64)
    want = morton.prepare(q, r, 32, 64, sort_refs)
    for g, w in zip(got.plain_view()[:6], want[:6]):
        assert (g is None and w is None) or torch.equal(g, w)
    assert (q4[:, 40:, 3] == -1).all()  # pad query rows
    assert (r4[:, 300:, 3] == r4[:, 299:300, 3]).all()  # pad refs name the last ref


@pytest.fixture(scope="module")
def models():
    """(jcfg, jmodel, cfg, model): the JAX model at eval_cfg after one
    train-mode forward, and the port's with its weights, both in eval mode."""
    jcfg = eval_cfg()
    jmodel = nnx.jit(lambda: jax_build_model(jcfg, rngs=nnx.Rngs(3))[0])()
    raw = _example(jcfg, np.random.default_rng(5))
    jmodel.train()
    jmodel(jax_prepare_batch(jcfg, jax.device_put(raw), training=False))
    jmodel.eval()
    cfg = _port_cfg(jcfg)
    model, _, _ = build_model(cfg)
    model.eval()
    convert.load_jax_params(model, _flat_params(jmodel))
    return jcfg, jmodel, cfg, model


def _example(cfg, rng, batch=B):
    d = cfg.data
    raw = example_batch(rng, B=batch, N=d.num_points, V=d.num_views_eval, H=d.image_height, W=d.image_width)
    return {k: raw[k] for k in export_model._BATCH_KEYS}


def _eager(cfg, model, batch):
    with torch.no_grad():
        return model(prepare_batch(cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, training=False))[0]


@pytest.fixture(scope="module")
def artifact(models, tmp_path_factory):
    _, _, cfg, model = models
    return export_model.export_inference(model, cfg, str(tmp_path_factory.mktemp("port_art")), batch_size=B)


def test_artifact_reproduces_the_eager_forward(models, artifact, rng):
    """After save and load, without the model objects: the eager logits to
    1e-5, and each kernel one mvpnet:: node (at these sizes the fusion kNN
    routes to the brute kNN: one knn node beside each FP level's)."""
    _, _, cfg, model = models
    loaded = export_model.load_inference(artifact)
    batch = _example(cfg, rng)
    ops.reset_launch_counts()
    got = loaded(batch)
    assert got.shape == (B, cfg.data.num_points, cfg.data.num_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _eager(cfg, model, batch).numpy(), atol=1e-5, rtol=1e-5)
    levels = len(cfg.model.pn2.sa)
    assert export_model.kernel_nodes(loaded.program) == {"fps": levels, "ball_query": levels, "knn": levels + 1}
    assert not any(ops.launch_counts().values())  # CPU implementations: the plain versions


@pytest.fixture(scope="module")
def jax_artifact(models, tmp_path_factory):
    jcfg, jmodel, _, _ = models
    return jexport_model.export_inference(jmodel, jcfg, str(tmp_path_factory.mktemp("jax_art")), batch_size=B)


def test_artifact_matches_the_jax_artifact(models, artifact, jax_artifact, rng):
    """The same weights and numpy batch through JAX's load_inference and the
    port's: the parity tolerances of tests/test_torch_models.py."""
    batch = _example(models[0], rng)
    want = np.asarray(jexport_model.load_inference(jax_artifact)(batch))
    got = export_model.load_inference(artifact)(batch).numpy()
    _agree(got, want)


def test_meta_matches_the_jax_artifact(artifact, jax_artifact):
    def meta(path):
        with open(os.path.join(path, "meta.json")) as fh:
            return json.load(fh)

    got, want = meta(artifact), meta(jax_artifact)
    assert set(want) <= set(got)
    got["config"] = jax_keys(got["config"])  # the port's own config key aside
    for key in ("batch_keys", "input_spec", "output", "class_names", "config"):
        assert got[key] == want[key], key
    assert got["platforms"] == ["cpu"] and got["requires"] == ["mvpnet_torch.ops"] and "device" not in got


def test_cuda_artifact_without_cuda_raises(artifact, tmp_path, monkeypatch):
    art = str(tmp_path / "cuda_art")
    shutil.copytree(artifact, art)
    with open(os.path.join(art, "meta.json")) as fh:
        meta = json.load(fh)
    meta["platforms"] = ["cuda"]
    with open(os.path.join(art, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export_model.load_inference(art)


def test_cli_export_3d(tmp_path):
    """No checkpoint: SystemExit (never random weights). On a checkpoint the
    Checkpointer saved, --check reloads the artifact and passes the margin
    rule with the eager forward's logits to the last bit on the CPU."""
    overrides = [*TINY, f"output_dir={tmp_path / 'run'}"]
    argv = ["--cfg", CFG_3D, "--device", "cpu", "--batch-size", "1", "--check", *overrides]
    with pytest.raises(SystemExit, match="no checkpoint"):
        export_3d.main(["--out", str(tmp_path / "none"), *argv])
    cfg = export_3d.load_config(CFG_3D, overrides)
    model, _, _ = build_model(cfg, seed=1)
    Checkpointer(f"{cfg.output_dir}/checkpoints").save(0, model)
    art = str(tmp_path / "art")
    result = export_3d.main(["--out", art, *argv])
    assert result["agreement"] == 1.0 and result["confident_agreement"] == 1.0 and result["max_abs"] <= 1e-5
    assert export_model.load_inference(art).meta["input_spec"]["points"]["shape"] == [1, cfg.data.num_points, 3]


def test_agreement_gates_on_confident_decisions():
    want = np.array([[[2.0, 0.0], [1.0, 0.9]]], np.float32)  # one confident decision, one near tie
    flipped_tie = np.array([[[2.0, 0.0], [0.9, 1.0]]], np.float32)
    r = export_3d.agreement(flipped_tie, want)
    assert r["agreement"] == 0.5 and r["confident_agreement"] == 1.0 and r["confident_share"] == 0.5
    assert export_3d.agreement(want[..., ::-1].copy(), want)["confident_agreement"] == 0.0


def test_bf16_tie_band_scales_with_the_top_logit():
    """The band is BF16_TIE_STEPS bf16 grid steps at the top logit (16 at
    |3216|, 2^-7 of 2^11), never below TAU; agreement takes it a decision."""
    want = np.array([[[3216.0, 3190.0], [3216.0, 3100.0], [10.0, 9.0], [-3.0, -50.0]]], np.float32)
    band = export_3d.bf16_tie_band(want)
    np.testing.assert_array_equal(band, [[4 * 16.0, 4 * 16.0, export_3d.TAU, export_3d.TAU]])
    got = want[..., ::-1].copy()  # every decision flipped
    r = export_3d.agreement(got, want, tau=band)
    assert r["agreement"] == 0.0 and r["confident_agreement"] == 0.0 and r["confident_share"] == 0.75
    got[0, 1], got[0, 2], got[0, 3] = want[0, 1], want[0, 2], want[0, 3]  # only the tie inside the band flips
    r = export_3d.agreement(got, want, tau=band)
    assert r["agreement"] == 0.75 and r["confident_agreement"] == 1.0
    assert export_3d.agreement(got, want)["confident_agreement"] == 0.75  # TAU alone counts the tie


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.read()


def _post(url, body):
    with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"), timeout=120) as resp:
        return resp.status, resp.read()


def _status(fn, *args):
    try:
        return fn(*args)[0]
    except urllib.error.HTTPError as e:
        return e.code


def test_serve_artifact_http(models, artifact, rng):
    """cli.serve_3d on 127.0.0.1, port 0: /meta is meta.json, /healthz
    answers, /predict gives the eager logits; junk gets 400 and the server
    stays up; an unknown path gets 404."""
    _, _, cfg, model = models
    httpd = serve_3d.serve(artifact, port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        with open(os.path.join(artifact, "meta.json")) as fh:
            assert json.loads(_get(f"{base}/meta")[1]) == json.load(fh)
        assert _get(f"{base}/healthz") == (200, b"ok")
        batch = _example(cfg, rng)
        buf = io.BytesIO()
        np.savez(buf, **batch)
        status, body = _post(f"{base}/predict", buf.getvalue())
        with np.load(io.BytesIO(body)) as z:
            logits = z["logits"]
        assert status == 200 and logits.dtype == np.float32
        np.testing.assert_allclose(logits, _eager(cfg, model, batch).numpy(), atol=1e-5, rtol=1e-5)
        assert _status(_post, f"{base}/predict", b"junk") == 400
        missing = io.BytesIO()
        np.savez(missing, points=batch["points"])
        assert _status(_post, f"{base}/predict", missing.getvalue()) == 400
        assert _get(f"{base}/healthz")[0] == 200
        assert _status(_get, f"{base}/nope") == 404 and _status(_post, f"{base}/nope", b"") == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
