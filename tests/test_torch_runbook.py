"""The port's ScanNet runbook (``mvpnet_torch/runbook.py``) on the CPU: the
dry run, a smoke run of every stage on a fake raw ScanNet tree, and its
markers against a fake stage runner (a second run runs nothing, a changed
command re-runs its stage and every later one, an eval result counts only
beside its own marker written after train_3d's, a failed stage writes no
report). No test may touch the JAX package's committed
``runs/scannet_smoke_*.json``."""
import glob
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

from mvpnet_torch import runbook

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its fake raw-tree writer)

# tools/scannet_runbook.py's report keys
JAX_REPORT_KEYS = ["reference_val_miou_band", "parity_margin", "measured", "best_miou", "parity_pass", "smoke", "note"]
STAGES = ["preprocess", "train_2d", "train_3d", "test_3d_chunkviews", "test_3d_fused", "test_3d_sharded"]
# narrow widths at the frames' 120x160; one 3 m window a scene
TINY = [
    "data.num_points=256", "data.num_views_train=2", "data.num_views_eval=2", "data.num_workers=1",
    "data.chunk_size=3.0", "data.chunk_stride=3.0", "eval.batch_size=1",
    "model.unet.base_channels=16", "model.unet.stage_channels=[16,16,32,32]", "model.unet.stage_blocks=[1,1,1,1]",
    "model.unet.decoder_channels=[32,32,16,16]", "model.unet.feature_channels=16", "model.unet.dtype=float32",
    "model.aggregation.mlp_channels=[16,16]", "model.pn2.in_channels=16", "model.pn2.dtype=float32",
    "model.pn2.head_channels=16", "model.pn2.dropout=0.0",
    "model.pn2.sa=[{npoint: 32, radius: 0.2, nsample: 8, mlp_channels: [16,16]}, "
    "{npoint: 8, radius: 0.4, nsample: 8, mlp_channels: [16,32]}]",
    "model.pn2.fp_channels=[[32],[32,16]]",
    "train.max_steps=2", "train.val_every=2", "train.ckpt_every=2", "train.val_steps=1",
]


def _digests():
    return {f: hashlib.sha256(open(f, "rb").read()).hexdigest()
            for f in sorted(glob.glob(str(ROOT / "runs" / "scannet_smoke_*.json")))}


@pytest.fixture(autouse=True)
def jax_artifacts_unchanged():
    before = _digests()
    yield
    assert _digests() == before


class FakeRunner:
    """Stands in for the stages: records each command, makes the outputs a
    stage leaves (meta/, checkpoints/) and prints test_3d's results line;
    ``fail`` names a stage that exits 1."""

    def __init__(self, fail=None):
        self.ran, self.fail = [], fail

    def __call__(self, cmd, log_path):
        module = cmd[2].rsplit(".", 1)[1]
        name = module if module != "test_3d" else "test_3d_" + (
            "fused" if "--fused" in cmd else "sharded" if "--sharded" in cmd else "chunkviews")
        self.ran.append(name)
        if name == self.fail:
            return 1
        opts = dict(a.split("=", 1) for a in cmd if "=" in a and not a.startswith("-"))
        if module == "preprocess":
            os.makedirs(os.path.join(cmd[cmd.index("--out") + 1], "meta"), exist_ok=True)
        elif module.startswith("train"):
            os.makedirs(os.path.join(opts["output_dir"], "checkpoints", "1"), exist_ok=True)
        with open(log_path, "w") as f:
            f.write("log line\n")
            if module == "test_3d":
                f.write(json.dumps({"miou": 0.1 + 0.01 * len(self.ran), "accuracy": 0.5, "class_iou": {}}) + "\n")
        return 0


def _argv(tmp_path, *extra):
    return ["--raw", str(tmp_path / "raw"), "--smoke", "--root", str(tmp_path), "--device", "cpu", *extra]


def _smoke_dir(tmp_path):
    return tmp_path / "outputs" / "torch_runbook_smoke"


def test_dry_run_starts_no_subprocess(tmp_path, monkeypatch, capsys):
    def refuse(*a, **kw):
        raise AssertionError("the dry run started a process")

    for name in ("call", "run", "Popen", "check_call", "check_output"):
        monkeypatch.setattr(subprocess, name, refuse)
    assert runbook.main(_argv(tmp_path, "--dry-run")) is None
    out = capsys.readouterr().out
    for stage in STAGES:
        assert f"{stage}: to run" in out
    assert not (tmp_path / "outputs").exists() and not (tmp_path / "runs").exists()
    # a real run's trees are the port's own, never the JAX package's
    assert runbook.main(["--raw", str(tmp_path / "raw"), "--dry-run", "--root", str(tmp_path)]) is None
    out = capsys.readouterr().out
    assert "mvpnet_torch.cli.test_3d" in out and "mvpnet_tpu" not in out and "runbook_logs" not in out


def test_real_run_trees():
    args = runbook.parse_args(["--raw", "/data/scannet"])
    p = runbook.paths(args)
    assert p.results == os.path.join(runbook.REPO, "runs", "torch_runbook")
    assert p.logs == os.path.join(runbook.REPO, "runs", "torch_runbook", "logs")
    assert p.markers.startswith(os.path.join(runbook.REPO, "outputs", "torch_runbook"))
    assert p.data == os.path.join(runbook.REPO, "data", "scannet") and p.tag == "scannet"
    stages = runbook.plan(args, p)
    assert [s.name for s in stages] == STAGES
    assert all("--device" in s.cmd and s.cmd[s.cmd.index("--device") + 1] == "cuda" for s in stages[1:])
    assert not any("mesh.space=1" in s.cmd for s in stages)  # only the smoke pins one card
    smoke = runbook.plan(runbook.parse_args(["--raw", "/data/scannet", "--smoke"]),
                         runbook.paths(runbook.parse_args(["--raw", "/data/scannet", "--smoke"])))
    assert "mesh.space=1" in smoke[-1].cmd and all(o in smoke[1].cmd for o in runbook.SMOKE)


def test_smoke_on_a_fake_raw_tree(tmp_path, monkeypatch):
    """Every stage as a real process on the CPU, a report with JAX's keys,
    then a second invocation that runs nothing."""
    for i in range(3):
        chip_smoke.write_raw_scan(str(tmp_path / "raw"), f"scene{i:04d}_00", seed=i, points=3000, frames=21)
    # the stages' processes must not import tensorboard (it pulls tensorflow in)
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text("import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    report = runbook.main(_argv(tmp_path, *TINY))
    assert list(report) == JAX_REPORT_KEYS
    assert report["smoke"] is True and sorted(report["measured"]) == ["chunkviews", "fused", "sharded"]
    assert all(0.0 <= m <= 1.0 for m in report["measured"].values())
    smoke = _smoke_dir(tmp_path)
    with open(smoke / "scannet_smoke_parity.json") as f:
        assert json.load(f) == report
    for mode in ("chunkviews", "fused", "sharded"):
        with open(smoke / f"scannet_smoke_eval_{mode}.json") as f:
            assert json.load(f)["miou"] == report["measured"][mode]
        marker = json.loads((smoke / "markers" / f"test_3d_{mode}.json").read_text())
        assert marker["status"] == "done"
    assert (smoke / "scannet" / "meta" / "scannetv2_val.txt").exists()
    assert (smoke / "mvpnet_3d" / "checkpoints").exists()
    runner = FakeRunner()
    runbook.main(_argv(tmp_path, *TINY), runner=runner)
    assert runner.ran == []


def test_second_invocation_runs_nothing(tmp_path, capsys):
    runner = FakeRunner()
    first = runbook.main(_argv(tmp_path), runner=runner)
    assert runner.ran == STAGES
    assert list(first) == JAX_REPORT_KEYS and first["parity_pass"] is False
    again = FakeRunner()
    assert runbook.main(_argv(tmp_path), runner=again) == first
    assert again.ran == []
    stages_line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith('{"stages"')][-1]
    assert set(json.loads(stages_line)["stages"].values()) == {"done"}


def test_changed_weights_rerun_train_2d_and_after(tmp_path):
    runbook.main(_argv(tmp_path), runner=FakeRunner())
    weights = tmp_path / "resnet34.pth"
    weights.write_bytes(b"weights")
    runner = FakeRunner()
    runbook.main(_argv(tmp_path, "--resnet34-weights", str(weights)), runner=runner)
    assert runner.ran == STAGES[1:]
    # the stage that re-ran from another command started from an empty output directory
    checkpoints = _smoke_dir(tmp_path) / "sem_seg_2d" / "checkpoints"
    assert sorted(os.listdir(checkpoints)) == ["1"]
    runner = FakeRunner()
    runbook.main(_argv(tmp_path, "--resnet34-weights", str(weights)), runner=runner)
    assert runner.ran == []


def test_eval_result_without_its_marker_is_not_taken(tmp_path):
    smoke = _smoke_dir(tmp_path)
    smoke.mkdir(parents=True)
    stale = {"miou": 0.99, "accuracy": 0.99, "class_iou": {}}
    (smoke / "scannet_smoke_eval_fused.json").write_text(json.dumps(stale))  # as a committed artifact would be
    runner = FakeRunner()
    report = runbook.main(_argv(tmp_path), runner=runner)
    assert runner.ran == STAGES and report["measured"]["fused"] != 0.99
    (smoke / "markers" / "test_3d_fused.json").unlink()
    runner = FakeRunner()
    runbook.main(_argv(tmp_path), runner=runner)
    assert runner.ran == ["test_3d_fused"]
    # a result that is not the one its marker names
    (smoke / "scannet_smoke_eval_sharded.json").write_text(json.dumps(stale))
    runner = FakeRunner()
    report = runbook.main(_argv(tmp_path), runner=runner)
    assert runner.ran == ["test_3d_sharded"] and report["measured"]["sharded"] != 0.99


def test_eval_older_than_train_3d_is_not_taken(tmp_path):
    runbook.main(_argv(tmp_path), runner=FakeRunner())
    path = _smoke_dir(tmp_path) / "markers" / "train_3d.json"
    marker = json.loads(path.read_text())
    marker["written_ns"] += 10**12  # train_3d written again after the evals
    path.write_text(json.dumps(marker))
    runner = FakeRunner()
    runbook.main(_argv(tmp_path), runner=runner)
    assert runner.ran == ["test_3d_chunkviews", "test_3d_fused", "test_3d_sharded"]


def test_failed_stage_exits_nonzero_and_writes_no_report(tmp_path):
    with pytest.raises(SystemExit) as exc:
        runbook.main(_argv(tmp_path), runner=FakeRunner(fail="train_3d"))
    assert exc.value.code not in (0, None)
    smoke = _smoke_dir(tmp_path)
    assert not (smoke / "scannet_smoke_parity.json").exists()
    assert json.loads((smoke / "markers" / "train_3d.json").read_text())["status"] == "running"
    # the next invocation resumes train_3d from its checkpoints, then runs what follows
    os.makedirs(smoke / "mvpnet_3d" / "checkpoints" / "0")
    runner = FakeRunner()
    runbook.main(_argv(tmp_path), runner=runner)
    assert runner.ran == STAGES[2:]
    assert sorted(os.listdir(smoke / "mvpnet_3d" / "checkpoints")) == ["0", "1"]
