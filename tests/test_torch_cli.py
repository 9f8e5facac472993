"""The port's command lines on the CPU at tiny widths (cli.train_2d,
cli.test_2d, cli.train_3d with the 2D warm start and the PointNet++
baselines, cli.test_3d with its export) against the library calls they
wrap, and the port's copies of the host tools (data.preprocess,
utils.visualize) against the JAX package's, exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

from mvpnet_tpu.data import preprocess as jpreprocess
from mvpnet_tpu.utils import visualize as jvisualize
from mvpnet_torch.cli import test_2d, test_3d, train_2d, train_3d
from mvpnet_torch.config import load_config
from mvpnet_torch.data import preprocess, synthetic
from mvpnet_torch.data.frames import FrameDataset
from mvpnet_torch.data.pipeline import build_dataset
from mvpnet_torch.eval.whole_scene import Evaluator, evaluate_scenes
from mvpnet_torch.models import build_model
from mvpnet_torch.train.checkpoint import Checkpointer
from mvpnet_torch.utils import visualize
from tests.test_torch_train import TINY

CFG_2D = "configs/scannet/sem_seg_2d_unet_resnet34.yaml"
CFG_3D = "configs/scannet/mvpnet_3d_synthetic_smoke.yaml"
# steps of a training run, and fewer windows a validation scene for test_3d
RUN = ["train.batch_size=2", "train.max_steps=2", "train.log_every=1", "train.val_steps=1"]
WINDOWS = ["data.chunk_stride=1.5"]


def _printed(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _restored(cfg):
    model, _, _ = build_model(cfg)
    assert Checkpointer(f"{cfg.output_dir}/checkpoints").restore(model) is not None
    return model.eval()


@pytest.fixture(scope="module")
def run_2d(tmp_path_factory):
    """A cli.train_2d run at tiny widths: its output directory."""
    out = str(tmp_path_factory.mktemp("sem_seg_2d"))
    train_2d.main(["--cfg", CFG_2D, "--device", "cpu", *TINY, *RUN, f"output_dir={out}"])
    return out


def test_cli_train_2d_then_test_2d(run_2d, capsys):
    """train_2d trains sem_seg_2d on frames and checkpoints it; test_2d
    prints what Evaluator gives over iter_epoch on the restored model."""
    cfg = load_config(CFG_2D, ["model.name=sem_seg_2d", *TINY, f"output_dir={run_2d}"])
    with open(os.path.join(run_2d, "config.yaml")) as f:
        saved = f.read()
    assert "sampling: frames" in saved and "name: sem_seg_2d" in saved
    assert Checkpointer(os.path.join(run_2d, "checkpoints")).steps() == [1]
    capsys.readouterr()
    test_2d.main(["--cfg", CFG_2D, "--device", "cpu", "--batch-size", "5", *TINY, f"output_dir={run_2d}"])
    got = _printed(capsys)

    model = _restored(cfg)
    frames = FrameDataset(build_dataset(cfg.data, batch_size=1, training=False).scenes, cfg.data, batch_size=5,
                          training=False)
    evaluator = Evaluator(cfg.data.num_classes, cfg.data.ignore_label)
    n_frames = 0
    with torch.no_grad():
        for batch in frames.iter_epoch():
            n = batch["n_real"]
            images = torch.from_numpy(batch["images"][:n].astype(np.float32) / 255.0)
            _, logits = model({"images": images[:, None]})
            evaluator.update(logits[:, 0].argmax(-1).numpy(), batch["seg_label_2d"][:n])
            n_frames += n
    assert n_frames == len(frames.index)
    assert got == evaluator.results()
    assert 0.0 <= got["miou"] <= 1.0 and len(got["class_iou"]) == cfg.data.num_classes


def test_evaluator_counts_compact_frame_labels(rng):
    """The frames' int8 labels at 20 classes: label * 20 wraps in int8 (JAX's
    Evaluator.update raises on the negative index); the port counts them as
    the int64 labels JAX's counts."""
    from mvpnet_tpu.eval.whole_scene import Evaluator as JaxEvaluator

    label = rng.integers(0, 20, (3, 24, 32)).astype(np.int8)
    label[0, :4] = -100
    pred = rng.integers(0, 20, label.shape)
    got, want = Evaluator(20), JaxEvaluator(20)
    got.update(pred, label)
    want.update(pred, label.astype(np.int64))
    np.testing.assert_array_equal(got.cm, want.cm)
    assert got.cm.sum() == label.size - 4 * 32


def test_cli_warm_start_from_a_2d_run(run_2d, tmp_path):
    """train_3d with model.pretrained_2d at a train_2d run: net_2d holds the
    2D checkpoint's tensors before the first step."""
    state = torch.load(os.path.join(run_2d, "checkpoints", "1", "state.pt"), weights_only=True)["model"]
    model, _ = train_3d.main(["--cfg", CFG_3D, "--device", "cpu", *TINY, "train.max_steps=0",
                              f"model.pretrained_2d={run_2d}/checkpoints", f"output_dir={tmp_path / 'run'}"])
    got = model.net_2d.state_dict()
    assert set(got) == {k[len("net_2d."):] for k in state}
    for k, v in got.items():
        assert torch.equal(v, state["net_2d." + k]), k


def test_cli_train_3d_then_test_3d_export(tmp_path, capsys):
    """test_3d restores the run's checkpoint and prints what evaluate_scenes
    gives on the restored model; --export writes one NYU40 file a scene;
    --sharded prints what the space-sharded estimator gives on one rank."""
    out, export = str(tmp_path / "run"), str(tmp_path / "export")
    overrides = [*TINY, *WINDOWS, f"output_dir={out}"]
    train_3d.main(["--cfg", CFG_3D, "--device", "cpu", *overrides, *RUN])
    capsys.readouterr()
    test_3d.main(["--cfg", CFG_3D, "--device", "cpu", "--export", export, "--batch-size", "3", *overrides])
    got = _printed(capsys)

    cfg = load_config(CFG_3D, overrides)
    scenes = build_dataset(cfg.data, batch_size=1, training=False).scenes
    assert got == evaluate_scenes(_restored(cfg), cfg, scenes, batch_size=3)
    assert sorted(os.listdir(export)) == sorted(f"{s.name}.txt" for s in scenes)
    nyu = np.loadtxt(os.path.join(export, f"{scenes[0].name}.txt"), dtype=np.int64)
    assert len(nyu) == len(scenes[0].points) and nyu.min() >= 0 and nyu.max() <= 40

    # --sharded without a launcher: the space-sharded estimator on one rank
    capsys.readouterr()
    test_3d.main(["--cfg", CFG_3D, "--device", "cpu", "--sharded", *overrides])
    from mvpnet_torch.dist.mesh import make_mesh

    assert _printed(capsys) == evaluate_scenes(_restored(cfg), cfg, scenes, mesh=make_mesh(cfg.mesh))
    with pytest.raises(SystemExit):
        test_3d.main(["--cfg", CFG_3D, "--device", "cpu", *TINY, f"output_dir={tmp_path / 'untrained'}"])


@pytest.mark.parametrize("rgb", [False, True], ids=["xyz", "rgb"])
def test_cli_pn2ssg_train_and_test(tmp_path, capsys, rgb):
    """The PointNet++ baselines through train_3d, then test_3d (colors go
    through the scene path for xyz+RGB)."""
    cfg_path = f"configs/scannet/pn2ssg_{'rgb' if rgb else 'xyz'}.yaml"
    overrides = [*TINY, f"model.pn2.in_channels={3 if rgb else 0}", *WINDOWS, f"output_dir={tmp_path}"]
    model, val = train_3d.main(["--cfg", cfg_path, "--device", "cpu", *overrides, *RUN])
    assert type(model).__name__ == "PN2Seg" and model.in_channels == (3 if rgb else 0)
    assert 0.0 <= val["miou"] <= 1.0
    capsys.readouterr()
    test_3d.main(["--cfg", cfg_path, "--device", "cpu", *overrides])
    got = _printed(capsys)
    assert np.isfinite(got["miou"]) and 0.0 <= got["miou"] <= 1.0


@pytest.mark.parametrize("cfg_path,extra", [
    (CFG_2D, ["data.sampling=frames"]),
    ("configs/scannet/pn2ssg_rgb.yaml", ["model.pn2.in_channels=3"]),
], ids=["sem_seg_2d", "pn2ssg_rgb"])
def test_train_entry_runs_the_recipe_models(cfg_path, extra):
    """train_entry takes any config: the 2D model on frames, the baseline on
    chunks with colors; one step moves the weights."""
    from mvpnet_torch.entry import train_entry

    cfg = load_config(cfg_path, [*TINY, "train.batch_size=2", *extra])
    step, (model, optimizer, batches) = train_entry(device="cpu", cfg=cfg)
    try:
        before = [p.detach().clone() for p in optimizer.params]
        batch = next(batches)
        assert ("depth" in batch) == (cfg.model.name == "pn2ssg") and ("colors" in batch) == (cfg.model.name == "pn2ssg")
        m = step(batch)
        assert torch.isfinite(m["loss"]) and optimizer.count == 1 and model.training
        assert all(not torch.equal(p, b) for p, b in zip(optimizer.params, before))
    finally:
        batches.close()


def test_cli_train_3d_rejects_a_2d_model():
    with pytest.raises(SystemExit):
        train_3d.main(["--device", "cpu", "model.name=sem_seg_2d"])


# ---------------------------------------------------------------------------
# Host tools: the port's copies against the JAX package's
# ---------------------------------------------------------------------------


SCANS = [f"scene{i:04d}_00" for i in range(20)]


@pytest.mark.parametrize("official", [(), ("train", "val"), ("val",), ("train",)], ids=["none", "both", "val", "train"])
def test_write_split_lists_matches_jax(tmp_path, capsys, official):
    """The fallback split, copied official lists, and one official list
    (the other split takes every scene it left, none of its own)."""
    raw = tmp_path / "raw"
    os.makedirs(raw / "Tasks" / "Benchmark")
    for split in official:
        ids = SCANS[:15] if split == "train" else SCANS[15:]
        (raw / "Tasks" / "Benchmark" / f"scannetv2_{split}.txt").write_text("\n".join(ids) + "\n")
    printed = {}
    for name, fn in (("jax", jpreprocess.write_split_lists), ("port", preprocess.write_split_lists)):
        os.makedirs(tmp_path / name / "meta")
        fn(str(raw), str(tmp_path / name), SCANS)
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    files = sorted(os.listdir(tmp_path / "jax" / "meta"))
    assert files == sorted(os.listdir(tmp_path / "port" / "meta")) and {"scannetv2_train.txt", "scannetv2_val.txt"} <= set(files)
    for f in files:
        assert (tmp_path / "port" / "meta" / f).read_bytes() == (tmp_path / "jax" / "meta" / f).read_bytes(), f
    train = (tmp_path / "port" / "meta" / "scannetv2_train.txt").read_text().split()
    val = (tmp_path / "port" / "meta" / "scannetv2_val.txt").read_text().split()
    assert not set(train) & set(val) and set(train) | set(val) == set(SCANS)


def _binary_ply(path, points, colors, labels):
    dtype = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"), ("blue", "u1"),
                      ("label", "<u2")])
    v = np.empty(len(points), dtype)
    for i, n in enumerate("xyz"):
        v[n] = points[:, i]
    for i, n in enumerate(("red", "green", "blue")):
        v[n] = colors[:, i]
    v["label"] = labels
    header = (
        f"ply\nformat binary_little_endian 1.0\nelement vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\nproperty ushort label\n"
        "element face 0\nproperty list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(v.tobytes())


def test_read_ply_matches_jax(tmp_path, rng):
    points = rng.uniform(-3, 3, (50, 3)).astype(np.float32)
    colors = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    labels = rng.integers(0, 41, 50).astype(np.uint16)
    visualize.write_ply(str(tmp_path / "a.ply"), points, colors)
    _binary_ply(tmp_path / "b.ply", points, colors, labels)
    for name in ("a.ply", "b.ply"):
        got = preprocess._read_ply_numpy(str(tmp_path / name))
        want = jpreprocess._read_ply_numpy(str(tmp_path / name))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        xyz = np.stack([got["x"], got["y"], got["z"]], 1)
        np.testing.assert_allclose(xyz, points, atol=1e-4 if name == "a.ply" else 0)
        np.testing.assert_array_equal(np.stack([got["red"], got["green"], got["blue"]], 1), colors)
    assert np.array_equal(preprocess._read_ply_numpy(str(tmp_path / "b.ply"))["label"], labels)
    (tmp_path / "c.ply").write_text("obj\n")
    with pytest.raises(ValueError, match="not a PLY"):
        preprocess._read_ply_numpy(str(tmp_path / "c.ply"))


def test_visualize_matches_jax(tmp_path, rng):
    scene = synthetic.make_scene(1, num_points=300, num_frames=1, height=8, width=8)
    labels = np.concatenate([scene.labels[:40], [-100, 25, 19, 0]])
    np.testing.assert_array_equal(visualize.labels_to_colors(labels), jvisualize.labels_to_colors(labels))
    for colors in (None, visualize.labels_to_colors(scene.labels)):
        visualize.write_ply(str(tmp_path / "port.ply"), scene.points, colors)
        jvisualize.write_ply(str(tmp_path / "jax.ply"), scene.points, colors)
        assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    visualize.export_prediction(str(tmp_path / "port.ply"), scene.points, scene.labels)
    jvisualize.export_prediction(str(tmp_path / "jax.ply"), scene.points, scene.labels)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()


def test_setup_logger_follows_the_output_dir(tmp_path):
    """A second run in one process logs into its own output_dir; a call
    without one keeps the file it has."""
    import logging

    from mvpnet_torch.utils.logger import setup_logger

    name = "mvpnet_torch.test_setup_logger"
    try:
        setup_logger(name, str(tmp_path / "a")).info("first run")
        setup_logger(name, str(tmp_path / "b")).info("second run")
        setup_logger(name).info("no output_dir")
        setup_logger(name, str(tmp_path / "b")).info("second run again")
        files = [h for h in logging.getLogger(name).handlers if isinstance(h, logging.FileHandler)]
        assert len(files) == 1
    finally:
        for h in list(logging.getLogger(name).handlers):
            logging.getLogger(name).removeHandler(h)
            h.close()
    a = (tmp_path / "a" / "log.txt").read_text()
    b = (tmp_path / "b" / "log.txt").read_text()
    assert "first run" in a and "second run" not in a
    assert "first run" not in b
    assert all(m in b for m in ("second run", "no output_dir", "second run again"))
