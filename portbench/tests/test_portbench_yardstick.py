"""The yardstick's frozen copies against the port's originals, and the
counts against a hand count, on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import counts, weights
from portbench.reference import data as D
from portbench.reference import model as M
from portbench.reference import ops as RO
from portbench.tests.tiny import tiny_config
from portbench.traffic import synthetic

SMALL = dict(num_points=4000, num_frames=8, num_objects=4, room=3.0, height=24, width=32)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(77, **SMALL)


def test_frozen_make_scene_equals_the_port(scene):
    from mvpnet_torch.data.synthetic import make_scene

    port = make_scene(77, **SMALL)
    for key, value in scene.items():
        assert np.array_equal(getattr(port, key), value), key


def test_grid_query_order_equals_the_native_index(scene):
    from mvpnet_torch.data.native import GridIndex

    native, ours = GridIndex(scene["points"], cell=D.GRID_CELL), D.Grid(scene["points"])
    for center in ([0.4, 0.4], [1.5, 1.7], [2.9, 0.1], [5.0, 5.0]):
        assert np.array_equal(native.query_box(np.asarray(center, np.float32), 0.95), ours.query_box(center, 0.95))


@pytest.mark.parametrize("rng_seed", [None, 3])
def test_chunk_sample_equals_the_port(scene, rng_seed):
    from mvpnet_torch.config import DataConfig
    from mvpnet_torch.data.pipeline import make_chunk_sample
    from mvpnet_torch.data.synthetic import Scene

    data = dict(tiny_config()["data"], max_candidate_frames=5)
    port_scene = Scene(**scene)
    rng = None if rng_seed is None else np.random.default_rng(rng_seed)
    center = None if rng_seed is not None else np.array([1.2, 1.4])
    ref = D.make_chunk_sample(dict(scene), data, center_xy=center, num_views=3,
                              rng=None if rng_seed is None else np.random.default_rng(rng_seed))
    port = make_chunk_sample(port_scene, DataConfig(**{k: v for k, v in data.items()}), center_xy=center, num_views=3,
                             rng=rng)
    port.pop("colors")
    assert port.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(port[k], ref[k]), k


def test_reference_model_matches_the_port_in_float32():
    from mvpnet_torch.config import Config, _merge_dataclass
    from mvpnet_torch.models.build import build_model
    from mvpnet_torch.train.step import prepare_batch

    cfg = tiny_config()
    port, _, _ = build_model(_merge_dataclass(Config(), cfg))
    ref = M.build(cfg["model"], "cpu")
    assert weights.shapes_of(port) == weights.shapes_of(ref)
    weights.load(port, 5, "cpu")
    weights.load(ref, 5, "cpu")
    scene = synthetic.make_scene(3, **SMALL)
    batch = D.collate([D.make_chunk_sample(scene, cfg["data"], center_xy=np.array([1.0 + i, 1.5]), num_views=2)
                       for i in range(2)])
    batch.pop("point_idx")
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    port.eval()
    ref.eval()
    with torch.no_grad():
        want, _ = ref(D.prepare(tensors, cfg["data"]))
        got, _ = port(prepare_batch(_merge_dataclass(Config(), cfg), tensors, training=False))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


def test_knn_pruned_search_equals_the_exhaustive_order():
    g = torch.Generator().manual_seed(0)
    q = torch.rand(1, 3000, 3, generator=g) * 4
    r = torch.rand(1, RO._PRUNED_REFS + 5, 3, generator=g) * 4
    r[0, 7] = r[0, 3]  # an exact tie: the lower index first
    q[0, 0] = r[0, 3]
    r[0, -50:] = 1e6  # invalid pixels at the sentinel
    d2, idx = RO.knn(q, r, 3)
    full = RO.sqdist(q, r)
    want_d, want_i = torch.sort(full, dim=-1, stable=True)
    assert torch.equal(idx.long(), want_i[..., :3]) and torch.equal(d2, want_d[..., :3])


def test_counts_against_a_hand_count():
    unet = dict(in_channels=3, base_channels=2, stage_channels=[2, 4], stage_blocks=[1, 1], decoder_channels=[3, 2],
                feature_channels=2, num_classes=5)
    # 8x8 view: stem 7x7/2 3->2 at 4x4; pool to 2x2; stage 1 two 3x3 2->2 at 2x2;
    # stage 2 3x3/2 2->4 at 1x1, 3x3 4->4, 1x1 down 2->4; decoder 3x3 (4+2)->3 at 2x2,
    # 3x3 (3+2)->2 at 4x4; final 3x3 2->2 at 8x8; head 1x1 2->5 at 8x8
    macs = (49 * 3 * 2 * 16 + 2 * 9 * 2 * 2 * 4 + 9 * 2 * 4 + 9 * 4 * 4 + 2 * 4 + 9 * 6 * 3 * 4 + 9 * 5 * 2 * 16
            + 9 * 2 * 2 * 64 + 2 * 5 * 64)
    assert counts.unet_flops(unet, 8, 8) == 2 * macs
    assert counts.fps_seconds(2, 100, 10) == (2 * 100 * 12 + 2 * 10 * 4) / counts.HBM_BYTES_PER_S
    b, m, r, k = 2, 50, 1000, 3
    assert counts.knn_seconds(b, m, r, k) == max((b * (m + r) * 12 + b * m * k * 8) / counts.HBM_BYTES_PER_S,
                                                 b * m * k * 8 / counts.FP32_FLOPS)
