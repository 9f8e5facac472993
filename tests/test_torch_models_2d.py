"""The port's 2D pretraining model (SemSeg2D), PointNet++ baseline (PN2Seg),
their train steps and the torchvision ResNet34 import against the JAX
package, on the CPU.

Weights go across with mvpnet_torch.convert.load_jax_params at
tests/test_models.py's tiny_config in float32. Tolerances are the ROADMAP's
(tests/test_parity.py's): logits < 5e-3 absolute and cosine > 0.99999;
gradients cosine > 0.999 with a norm ratio within 1%; a step's loss to rtol
1e-5 and the state after it to 1e-4 absolute (tests/test_torch_train.py's),
except where Adam's update follows the sign of rounding noise (see
test_train_step_matches_jax).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from mvpnet_tpu.config import UNetConfig as JaxUNetConfig
from mvpnet_tpu.data.frames import FrameDataset as JaxFrameDataset
from mvpnet_tpu.data.pipeline import ChunkDataset as JaxChunkDataset
from mvpnet_tpu.data.synthetic import make_scene as jax_make_scene
from mvpnet_tpu.models import build_model as jax_build_model
from mvpnet_tpu.models.unet import ResNet34Encoder as JaxEncoder
from mvpnet_tpu.models.unet import load_torch_resnet34 as jax_load_torch_resnet34
from mvpnet_tpu.train.solver import build_optimizer as jax_build_optimizer
from mvpnet_tpu.train.step import make_train_step as jax_make_train_step
from mvpnet_tpu.train.step import prepare_batch as jax_prepare_batch
from mvpnet_torch import convert
from mvpnet_torch.config import UNetConfig
from mvpnet_torch.models import build_model
from mvpnet_torch.models.build import PN2Seg, SemSeg2D
from mvpnet_torch.models.unet import ResNet34Encoder, load_torch_resnet34, load_torch_resnet34_file
from mvpnet_torch.train import solver
from mvpnet_torch.train.step import make_train_step, prepare_batch
from tests.test_models import tiny_config
from tests.test_pipeline import small_data_cfg
from tests.test_torch_models import _agree, _flat_params, _port_cfg

ATOL = 1e-4
# a gradient element at most this share of its leaf's largest is float32
# rounding noise around nought
NOISE = 1e-5


def _jax_cfg(name, in_channels=0):
    """tiny_config as ``name`` (dropout 0, no augmentation); pn2ssg at
    ``in_channels`` with colors shipped for 3."""
    cfg = tiny_config()
    pn2 = dataclasses.replace(cfg.model.pn2, dropout=0.0, in_channels=in_channels)
    data = small_data_cfg(augment=False, include_colors=in_channels == 3,
                          sampling="frames" if name == "sem_seg_2d" else "chunks")
    return dataclasses.replace(
        cfg, data=data, model=dataclasses.replace(cfg.model, name=name, pn2=pn2),
        train=dataclasses.replace(cfg.train, batch_size=4),
    )


@pytest.fixture(scope="module")
def scene():
    return jax_make_scene(7, num_points=20000, num_frames=6, height=24, width=32, num_classes=5)


def _raw_batch(jcfg, scene):
    if jcfg.data.sampling == "frames":
        return next(iter(JaxFrameDataset([scene], jcfg.data, batch_size=4, training=True, seed=3)))
    return next(iter(JaxChunkDataset([scene], jcfg.data, batch_size=4, training=True, seed=3)))


def _torch_batch(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


@nnx.jit
def _jax_forward(model, batch):
    return model(batch)


def _pair(jcfg, scene):
    """JAX and port models with the same weights (nontrivial BN statistics
    from one JAX train-mode forward), both in eval mode."""
    # built and run under nnx.jit: the eager weights, in a fraction of the time
    jmodel = nnx.jit(lambda: jax_build_model(jcfg, rngs=nnx.Rngs(0))[0])()
    raw = _raw_batch(jcfg, scene)
    jmodel.train()
    _jax_forward(jmodel, jax_prepare_batch(jcfg, jax.device_put(raw), training=False))
    jmodel.eval()
    model, _, _ = build_model(_port_cfg(jcfg))
    convert.load_jax_params(model, _flat_params(jmodel))
    return jmodel, model.eval(), raw


@pytest.fixture(scope="module")
def semseg(scene):
    return _pair(_jax_cfg("sem_seg_2d"), scene)


@pytest.mark.parametrize("sampling", ["frames", "chunks"])
@torch.no_grad()
def test_semseg2d_matches_jax(scene, semseg, sampling):
    """Per-view features and logits on a frame batch (views axis added by
    the frame preparation) and on a chunk batch (V views)."""
    jcfg = _jax_cfg("sem_seg_2d")
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, sampling=sampling))
    jmodel, model, _ = semseg
    raw = _raw_batch(jcfg, scene)
    assert isinstance(model, SemSeg2D)
    jbatch = jax_prepare_batch(jcfg, jax.device_put(raw), training=False)
    batch = prepare_batch(_port_cfg(jcfg), _torch_batch(raw), training=False)
    jfeat, jlogits = _jax_forward(jmodel, jbatch)
    feat, logits = model(batch)
    V = 1 if sampling == "frames" else jcfg.data.num_views_train
    assert logits.shape == (4, V, 24, 32, 5) and logits.dtype == torch.float32
    _agree(feat.numpy(), jfeat, argmax=False)
    _agree(logits.numpy(), jlogits)


@pytest.mark.parametrize("in_channels", [0, 3])
@torch.no_grad()
def test_pn2seg_matches_jax(scene, in_channels):
    jcfg = _jax_cfg("pn2ssg", in_channels)
    jmodel, model, raw = _pair(jcfg, scene)
    assert isinstance(model, PN2Seg) and ("colors" in raw) == (in_channels == 3)
    jlogits, jnone = _jax_forward(jmodel, jax_prepare_batch(jcfg, jax.device_put(raw), training=False))
    logits, none = model(prepare_batch(_port_cfg(jcfg), _torch_batch(raw), training=False))
    assert none is None and jnone is None
    _agree(logits.numpy(), jlogits)


def test_pn2seg_needs_colors_and_valid_channels(scene):
    jcfg = _jax_cfg("pn2ssg", 3)
    cfg = _port_cfg(jcfg)
    model, _, _ = build_model(cfg)
    raw = _raw_batch(jcfg, scene)
    raw.pop("colors")
    batch = prepare_batch(cfg, _torch_batch(raw), training=False)
    with pytest.raises(KeyError, match="include_colors"):
        model(batch)
    bad = dataclasses.replace(cfg.model, pn2=dataclasses.replace(cfg.model.pn2, in_channels=8))
    with pytest.raises(ValueError, match="in_channels"):
        build_model(dataclasses.replace(cfg, model=bad))


@pytest.mark.parametrize("name,in_channels", [("sem_seg_2d", 0), ("pn2ssg", 0), ("pn2ssg", 3)])
def test_train_step_matches_jax(scene, name, in_channels):
    """One make_train_step step from the same weights on the same batch, no
    augmentation: the loss, every gradient and the state after the update
    (parameters and BN running statistics), with the config's optimizer
    (Adam). Adam's first update is lr * g / (|g| + eps), about lr * sign(g):
    an element whose reference gradient is nought up to float32 rounding
    (at most NOISE of its leaf's largest; dead channels at these widths) can
    take either sign in either package, so it is held to 2 lr instead."""
    jcfg = _jax_cfg(name, in_channels)
    fns = {}

    def build():  # under nnx.jit; the loss and metric functions kept aside
        jmodel, fns["loss"], fns["metric"] = jax_build_model(jcfg, rngs=nnx.Rngs(0))
        return jmodel

    jmodel = nnx.jit(build)()
    loss_fn, metric_fn = fns["loss"], fns["metric"]
    init = _flat_params(jmodel)
    raw = _raw_batch(jcfg, scene)
    mb = jax_prepare_batch(jcfg, jax.device_put(raw), training=True)

    @nnx.jit  # the batch is an argument, not a closed-over constant
    def value_and_grad(m, mb):
        return nnx.value_and_grad(lambda m: loss_fn(m(mb), mb))(m)

    jloss, grads = value_and_grad(nnx.clone(jmodel), mb)
    grads = {"/".join(map(str, k)): np.asarray(v[...]) for k, v in nnx.to_flat_state(grads)}
    optimizer = nnx.Optimizer(jmodel, jax_build_optimizer(jcfg.solver), wrt=nnx.Param)
    jm = jax_make_train_step(jcfg, loss_fn, metric_fn)(jmodel, optimizer, jax.device_put(raw), jax.random.key(0))
    want_state = _flat_params(jmodel)

    cfg = _port_cfg(jcfg)
    model, ploss, pmetric = build_model(cfg)
    convert.load_jax_params(model, init)
    model.train()
    opt = solver.build_optimizer(cfg.solver, model.parameters())
    m = make_train_step(cfg, ploss, pmetric)(model, opt, _torch_batch(raw))
    np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(m["confusion"].numpy(), np.asarray(jm["confusion"]))
    named = dict(model.named_parameters())
    assert len(grads) == len(named)
    for key, jg in grads.items():
        tkey, jg = convert._torch_key(key, jg)
        g = named[tkey].grad.numpy()
        cos = float(np.dot(g.ravel(), jg.ravel()) / (np.linalg.norm(g) * np.linalg.norm(jg) + 1e-30))
        assert cos > 0.999, f"{key}: grad cosine {cos}"
        ratio = np.linalg.norm(g) / (np.linalg.norm(jg) + 1e-30)
        assert 0.99 < ratio < 1.01, f"{key}: grad norm ratio {ratio}"
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    lr = jcfg.solver.base_lr
    for key, value in want_state.items():
        tkey, arr = convert._torch_key(key, value)
        tol = ATOL
        if key in grads:  # a parameter; BN running statistics have no gradient
            jg = np.abs(convert._torch_key(key, grads[key])[1])
            tol = np.where(jg <= NOISE * jg.max(), 2 * lr + ATOL, ATOL)
        err = np.abs(state[tkey] - arr)
        assert (err <= tol).all(), f"{key}: {(err > tol).sum()} elements off, max {err.max():.3g}"


# ---------------------------------------------------------------------------
# torchvision ResNet34 import
# ---------------------------------------------------------------------------

# tiny widths under torchvision's key names; two blocks a stage, so a stage
# has a block with a projection shortcut and one without
UNET = dict(base_channels=8, stage_channels=(8, 16, 16, 32), stage_blocks=(2, 2, 2, 2), dtype="float32")


def _torchvision_sd(rng, unet=UNET):
    """Random state dict with torchvision resnet34's key names, at the
    widths of ``unet``, as numpy arrays."""
    sd = {}

    def conv(name, o, i, k):
        sd[name] = (rng.normal(size=(o, i, k, k)) * 0.1).astype(np.float32)

    def bn(prefix, c):
        sd[prefix + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[prefix + ".bias"] = (rng.normal(size=c) * 0.1).astype(np.float32)
        sd[prefix + ".running_mean"] = (rng.normal(size=c) * 0.1).astype(np.float32)
        sd[prefix + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[prefix + ".num_batches_tracked"] = np.array(0)

    base = unet["base_channels"]
    conv("conv1.weight", base, 3, 7)
    bn("bn1", base)
    c_in = base
    for L, (c, n) in enumerate(zip(unet["stage_channels"], unet["stage_blocks"]), start=1):
        for b in range(n):
            cin = c_in if b == 0 else c
            conv(f"layer{L}.{b}.conv1.weight", c, cin, 3)
            bn(f"layer{L}.{b}.bn1", c)
            conv(f"layer{L}.{b}.conv2.weight", c, c, 3)
            bn(f"layer{L}.{b}.bn2", c)
            if b == 0 and (L > 1 or cin != c):
                conv(f"layer{L}.{b}.downsample.0.weight", c, cin, 1)
                bn(f"layer{L}.{b}.downsample.1", c)
        c_in = c
    sd["fc.weight"] = np.zeros((1000, c_in), np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


@functools.cache
def _jax_encoder(norm="batch"):
    """One JAX encoder a norm, shared: every load overwrites all it reads."""
    return nnx.jit(lambda: JaxEncoder(JaxUNetConfig(**UNET, norm=norm), dtype=jnp.float32, rngs=nnx.Rngs(0)))()


def _encoder(norm="batch"):
    return ResNet34Encoder(UNetConfig(**UNET, norm=norm), dtype="float32", gen=torch.Generator().manual_seed(0))


@torch.no_grad()
def test_load_torch_resnet34_matches_jax(rng):
    """One torchvision-named dict into both encoders: the same keys
    consumed, and equal features at every stage in eval mode."""
    sd = _torchvision_sd(rng)
    jenc, enc = _jax_encoder(), _encoder()
    want_keys = jax_load_torch_resnet34(jenc, sd)
    got_keys = load_torch_resnet34(enc, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    assert got_keys == want_keys
    assert set(got_keys) == {k for k in sd if not k.startswith("fc.") and "num_batches" not in k}
    assert torch.equal(enc.stem.weight, torch.from_numpy(sd["conv1.weight"]))  # OIHW as it is
    assert torch.equal(enc.stages[1][0].down.norm.running_var, torch.from_numpy(sd["layer2.0.downsample.1.running_var"]))
    jenc.eval()
    enc.eval()
    x = rng.uniform(size=(2, 26, 34, 3)).astype(np.float32)
    for got, want in zip(enc(torch.from_numpy(x)), _jax_forward(jenc, jnp.asarray(x))):
        _agree(got.numpy(), want, argmax=False)


def test_load_torch_resnet34_file_npz_and_pth(rng, tmp_path):
    sd = _torchvision_sd(rng)
    np.savez(tmp_path / "r34.npz", **sd)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tmp_path / "r34.pth")
    for name in ("r34.npz", "r34.pth"):
        enc = _encoder()
        used = load_torch_resnet34_file(enc, str(tmp_path / name))
        assert len(used) == len(sd) - 2 - sum("num_batches" in k for k in sd)
        assert torch.equal(enc.stages[3][1].conv2.norm.weight, torch.from_numpy(sd["layer4.1.bn2.weight"]))


@pytest.mark.parametrize("fault", ["missing", "shape", "leftover", "group_norm"])
def test_load_torch_resnet34_raises_as_jax(rng, fault):
    sd = _torchvision_sd(rng)
    norm = "batch"
    if fault == "missing":
        sd.pop("layer3.1.bn1.running_mean")
        err = KeyError
    elif fault == "shape":
        sd["conv1.weight"] = sd["conv1.weight"][:, :1]
        err = ValueError
    elif fault == "leftover":  # a projection where the encoder has none
        sd["layer1.1.downsample.0.weight"] = np.zeros((8, 8, 1, 1), np.float32)
        err = ValueError
    else:
        norm = "group"
        err = ValueError
    jenc, enc = _jax_encoder(norm), _encoder(norm)
    with pytest.raises(err):
        jax_load_torch_resnet34(jenc, sd)
    with pytest.raises(err):
        load_torch_resnet34(enc, sd)
