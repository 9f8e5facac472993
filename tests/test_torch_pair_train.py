"""The port's 3D training held to the JAX package's over a horizon of paired
steps, on the CPU (``scripts/f3_pair.py``'s strict pairing at the tiny
widths of tests/test_torch_train.py).

Both packages start from the JAX model's weights (``nnx.Rngs(0)``, carried
across with ``load_jax_params``), take each step's host batch from their own
``ChunkDataset`` with one seed (asserted equal), and train through their own
``make_train_step`` and optimizer for STEPS steps: f32 nets, dropout 0,
augmentation on, the step schedule halving the rate at steps 8 and 16 down to
its ``clip_lr`` floor at 16. The port is fed the augmentation parameters that
the JAX step draws from its key (``mvpnet_torch.train.step.sample_chunk_params``
patched). Chunk validation runs through each package's ``evaluate`` after
steps 12 and 24. One case steps with ``grad_accum=2``.

Tolerances. The first step is test_torch_train.py's: loss to rtol 1e-5.
After it the two trajectories part as floating-point chaos makes any two
runs part. Each package rounds the augmentation's rotation and means in its
own order (1 ulp of a coordinate), which moves a few FPS and fusion-kNN picks
at near ties; Adam's first update is about lr * sign(g), so gradient elements
near nought turn those into 2 lr steps; and the gap then grows about
threefold a step until it saturates near the batch-to-batch noise of the loss
(by step ~10 here). The port against itself with one weight moved by 1 ulp
parts as far a few steps later. Measured on a CPU over three realizations
(seed 0 at grad_accum 1 and 2, seed 1 at 1; the 1-ulp baseline beside each):
the first step's gap at most 4.3e-7, steps 2-4 at most 1.6e-3, any later
step at most 0.050 of the loss, the mean signed gap at most 0.005; the
parameters' gap at most 0.62 of the way they travelled and the BatchNorm
statistics' 0.16; the validations' mIoU at most 0.012 apart, their loss 1.5%
(the baseline's 2.0%), and the confusion matrices' half L1 distance at most
0.111 of the points (the baseline's 0.108). The tolerances below are two to
four times those:
EARLY_RTOL for steps 1-4, LOSS_RTOL for every step, MEAN_GAP for the mean
signed gap (a systematic offset, which set JAX's recipe run of record apart
from the port's, would show there), PARAM_REL and BN_REL per top-level
module, VAL_* for each validation. A BatchNorm momentum of 0.8 in the port
(0.9 in both packages) fails VAL_CM_SHARE; Adam's beta2 (0.99 for 0.999)
acts over ~100 steps and stays inside them (``runs/f3_pair/`` holds 400).
"""
import numpy as np
import pytest

from mvpnet_tpu.data.pipeline import ChunkDataset as JaxChunkDataset
from mvpnet_tpu.data.synthetic import make_scene as jax_make_scene
from mvpnet_torch.data.pipeline import ChunkDataset
from mvpnet_torch.data.synthetic import make_scene
from scripts import f3_pair

STEPS = 24
EVAL_AT = (12, 24)
SOLVER = ["solver.scheduler=step", "solver.step_size=8", "solver.gamma=0.5", "solver.clip_lr=0.0003"]
SCENE = dict(num_points=20000, num_frames=6, height=24, width=32, num_classes=5)
B = 4

FIRST_RTOL = 1e-5
EARLY_STEPS, EARLY_RTOL = 4, 5e-3
LOSS_RTOL = 0.1
MEAN_GAP = 0.02
PARAM_REL = 1.0
BN_REL = 0.35
VAL_MIOU = 0.05
VAL_LOSS_RTOL = 0.05
VAL_CM_SHARE = 0.2


@pytest.fixture(scope="module")
def scenes():
    """(JAX, port) training scenes and validation scenes, made once."""
    return {split: ([jax_make_scene(s, **SCENE) for s in seeds], [make_scene(s, **SCENE) for s in seeds])
            for split, seeds in (("train", (7, 8)), ("val", (9,)))}


@pytest.fixture(scope="module")
def jax_start():
    """The JAX model both sides start from in every case."""
    jax_cfg, _ = f3_pair.configs("tiny", f3_pair.STRICT)
    return f3_pair.JaxSide(jax_cfg, 0).model


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def pair(request, scenes, jax_start):
    jax_cfg, port_cfg = f3_pair.configs(
        "tiny", f3_pair.STRICT + SOLVER + [f"train.grad_accum={request.param}", "train.val_steps=2"])

    def sets(split, seed):
        js, ps = scenes[split]
        training = split == "train"
        return (iter(JaxChunkDataset(js, jax_cfg.data, batch_size=B, training=training, seed=seed)),
                iter(ChunkDataset(ps, port_cfg.data, batch_size=B, training=training, seed=seed)))

    return f3_pair.paired_run(jax_cfg, port_cfg, sets("train", 3), sets("val", 4), steps=STEPS, eval_at=EVAL_AT,
                              jax_model=jax_start)


def test_pair_schedule_and_first_steps(pair):
    """The rate halves at 8 and 16 and stops at the floor; the first step's
    loss (the same weights, batch and augmentation on both sides) agrees,
    and the next few before the gap has grown."""
    np.testing.assert_allclose(pair["lr"], [1e-3] * 8 + [5e-4] * 8 + [3e-4] * 8, rtol=1e-6)
    np.testing.assert_allclose(pair["loss_port"][0], pair["loss_jax"][0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(pair["loss_port"][:EARLY_STEPS], pair["loss_jax"][:EARLY_STEPS], rtol=EARLY_RTOL)


def test_pair_losses_track_jax(pair):
    lj, lp = np.array(pair["loss_jax"]), np.array(pair["loss_port"])
    assert np.isfinite(lp).all() and len(lp) == STEPS
    rel = np.abs(lj - lp) / lp
    assert rel.max() < LOSS_RTOL, f"loss gaps {np.round(rel, 4).tolist()}"
    gap = float(np.mean(lj - lp))
    assert abs(gap) < MEAN_GAP, f"mean signed gap (JAX - port) {gap:.4f}"
    # both learn: the last quarter's loss below the first quarter's on each side
    q = STEPS // 4
    assert lj[-q:].mean() < lj[:q].mean() and lp[-q:].mean() < lp[:q].mean()


def test_pair_final_state_tracks_jax(pair):
    """Parameters and BatchNorm running statistics after STEPS steps: the
    gap between the sides, per top-level module, against the way the port's
    travelled from the common start."""
    dist = f3_pair.distances(pair["state_jax"], pair["state_port"], pair["state_start"])
    assert set(pair["state_jax"]) == set(pair["state_port"])
    for name, d in dist.items():
        assert d["travel"] > 0, name
        limit = BN_REL if name.startswith("bn/") else PARAM_REL
        assert d["rel"] < limit, f"{name}: gap {d['gap']:.4g} is {d['rel']:.3f} of the way {d['travel']:.4g}"


def test_pair_validation_tracks_jax(pair):
    """Chunk validation through each package's evaluate, twice."""
    assert [v["step"] for v in pair["val"]] == list(EVAL_AT)
    for v in pair["val"]:
        j, p = v["jax"], v["port"]
        assert j["confusion"].sum() == p["confusion"].sum() > 0  # the same labelled points
        assert abs(j["miou"] - p["miou"]) < VAL_MIOU, (v["step"], j["miou"], p["miou"])
        np.testing.assert_allclose(p["loss"], j["loss"], rtol=VAL_LOSS_RTOL)
        # half the L1 distance of the confusion matrices: at least the share of
        # points whose prediction differs
        share = np.abs(j["confusion"] - p["confusion"]).sum() / 2 / p["confusion"].sum()
        assert share < VAL_CM_SHARE, (v["step"], share)
