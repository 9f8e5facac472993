"""The ScanNet runbook: a raw ScanNet tree to the parity report, one command.

Counterpart of ``tools/scannet_runbook.py`` (the same stages, configs, flags
and smoke overrides), driving the port's command lines:

    python -m mvpnet_torch.runbook --raw /path/to/scannet [--tsv scannetv2-labels.combined.tsv] \\
        [--out data/scannet] [--resnet34-weights resnet34.pth] [--skip-2d] [--device cuda] \\
        [--dry-run] [--smoke] [key=value ...]

Stages, each skipped when its marker says it is done:
  1. preprocess  raw scans -> per-scene npz + resized frames
                 (``python -m mvpnet_torch.data.preprocess``; host only)
  2. train_2d    ``cli.train_2d`` at configs/scannet/sem_seg_2d_unet_resnet34.yaml
                 (100k steps B32 from scratch; with ``--resnet34-weights`` the
                 torchvision encoder import, ``model.unet.torch_weights``, and
                 40k steps)
  3. train_3d    ``cli.train_3d`` at configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml
                 warm-started from stage 2 (``model.pretrained_2d``)
  4. test_3d     whole-scene val mIoU in the three estimator modes: per-chunk
                 views, ``--fused``, ``--sharded`` (one process through
                 ``cli.test_3d``'s bootstrap; the smoke passes ``mesh.space=1``)
  5. report      the parity gate: the best mode's mIoU against
                 REFERENCE_VAL_MIOU - PARITY_MARGIN

Trees: a real run writes its checkpoints under ``outputs/torch_runbook/``, its
markers under ``outputs/torch_runbook/markers/``, its stage logs under
``runs/torch_runbook/logs/`` (git-ignored) and its eval results and report
(``scannet_eval_<mode>.json``, ``scannet_parity.json``) under
``runs/torch_runbook/``. ``--smoke`` (tiny step counts and shapes: the chain
in minutes, on a fake or partial raw tree) keeps all of it, the preprocessed
data too unless ``--out`` is given, under the git-ignored
``outputs/torch_runbook_smoke/`` (``scannet_smoke_*.json``). Neither reads or
writes the JAX package's ``runs/scannet_smoke_*.json`` or
``runs/runbook_logs/``. Paths are relative to ``--root`` (the repository).

Markers: each stage's ``markers/<stage>.json`` holds a hash of its full
command and of the hashes of the stages it depends on, its status and when it
was written. A stage is done when its marker is "done" with the hash of the
stage as planned now and its outputs exist; otherwise it runs, and so does
every stage that depends on it. A training stage whose marker is "running"
with the same hash (an earlier invocation failed) resumes from its
checkpoints; any other training stage that runs starts from an empty output
directory. An eval result counts as done only beside its own marker, written
after ``train_3d``'s and holding the result's sha256; a result file without
one (as a committed artifact would be) is not taken.

``--device`` (CUDA by default) goes to every stage that runs a model; trailing
dotted overrides go to every model stage, last. ``--dry-run`` prints the plan,
each stage's state and command, and starts nothing. A failed stage exits
nonzero and writes no report. Each invocation prints a ``{"stages": ...}``
line (each stage "ran" or "done") before the report.

The real run needs ScanNet on disk; it is not in the repository.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's copy of tools/scannet_runbook.py's gate: the paper's val-mIoU
# band for full MVPNet (SURVEY.md §6: re-read the exact value from the
# paper's val table before quoting the gate; 64.1 is the benchmark test value)
REFERENCE_VAL_MIOU = 0.665
PARITY_MARGIN = 0.005  # BASELINE.md: within 0.5 points
CONFIG_2D = "configs/scannet/sem_seg_2d_unet_resnet34.yaml"
CONFIG_3D = "configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml"
# tools/scannet_runbook.py's smoke overrides
SMOKE = [
    "train.max_steps=30", "train.val_every=30", "train.val_steps=2", "train.ckpt_every=30", "train.log_every=10",
    "data.num_points=2048", "data.max_candidate_frames=8", "train.batch_size=4",
]
EVAL_MODES = (("chunkviews", []), ("fused", ["--fused"]), ("sharded", ["--sharded"]))
REPORT_KEYS = ("reference_val_miou_band", "parity_margin", "measured", "best_miou", "parity_pass", "smoke", "note")
PLAN = [
    ("preprocess", "~1-2 h on the host (1513 scans)"),
    ("train_2d", "100k steps B32 (40k with --resnet34-weights)"),
    ("train_3d", "30k steps B8"),
    ("test_3d x3 modes", "312 val scenes a mode"),
    ("parity report", "<1 min"),
]


@dataclasses.dataclass
class Stage:
    name: str
    cmd: list
    deps: tuple = ()
    clear: str | None = None  # output directory a fresh run starts empty
    outputs: tuple = ()  # paths that must exist for the stage to count as done
    result: str | None = None  # the eval result JSON a test_3d stage writes


@dataclasses.dataclass
class Paths:
    data: str
    out2d: str
    out3d: str
    markers: str
    logs: str
    results: str
    tag: str


def paths(args) -> Paths:
    def at(*parts):
        return os.path.join(os.path.abspath(args.root), *parts)

    if args.smoke:
        base = at("outputs", "torch_runbook_smoke")
        return Paths(data=at(args.out) if args.out else os.path.join(base, "scannet"),
                     out2d=os.path.join(base, "sem_seg_2d"), out3d=os.path.join(base, "mvpnet_3d"),
                     markers=os.path.join(base, "markers"), logs=os.path.join(base, "logs"), results=base,
                     tag="scannet_smoke")
    base = at("outputs", "torch_runbook")
    return Paths(data=at(args.out or os.path.join("data", "scannet")), out2d=os.path.join(base, "sem_seg_2d"),
                 out3d=os.path.join(base, "mvpnet_3d"), markers=os.path.join(base, "markers"),
                 logs=at("runs", "torch_runbook", "logs"), results=at("runs", "torch_runbook"), tag="scannet")


def plan(args, p: Paths) -> list:
    """The stages of this invocation, in order."""
    py = sys.executable
    cmd = [py, "-m", "mvpnet_torch.data.preprocess", "--raw", os.path.abspath(args.raw), "--out", p.data]
    if args.tsv:
        cmd += ["--tsv", os.path.abspath(args.tsv)]
    stages = [Stage("preprocess", cmd, outputs=(os.path.join(p.data, "meta"),))]
    common = ["--device", args.device, f"data.root={p.data}"] + (SMOKE if args.smoke else [])
    if not args.skip_2d:
        cmd = [py, "-m", "mvpnet_torch.cli.train_2d", "--cfg", CONFIG_2D, *common]
        if args.resnet34_weights:
            cmd += [f"model.unet.torch_weights={os.path.abspath(args.resnet34_weights)}"]
            if not args.smoke:  # warm-started: shorter than the 100k-step schedule from scratch
                cmd += ["train.max_steps=40000"]
        stages.append(Stage("train_2d", cmd + [f"output_dir={p.out2d}", *args.opts], deps=("preprocess",),
                            clear=p.out2d, outputs=(os.path.join(p.out2d, "checkpoints"),)))
    stages.append(Stage(
        "train_3d",
        [py, "-m", "mvpnet_torch.cli.train_3d", "--cfg", CONFIG_3D, *common, f"output_dir={p.out3d}",
         f"model.pretrained_2d={p.out2d}/checkpoints", *args.opts],
        deps=("preprocess",) if args.skip_2d else ("preprocess", "train_2d"),
        clear=p.out3d, outputs=(os.path.join(p.out3d, "checkpoints"),)))
    for mode, flags in EVAL_MODES:
        one_card = ["mesh.space=1"] if mode == "sharded" and args.smoke else []
        stages.append(Stage(
            f"test_3d_{mode}",
            [py, "-m", "mvpnet_torch.cli.test_3d", "--cfg", CONFIG_3D, *flags, *common, f"output_dir={p.out3d}",
             *one_card, *args.opts],
            deps=("train_3d",), result=os.path.join(p.results, f"{p.tag}_eval_{mode}.json")))
    return stages


def stage_hash(stage: Stage, hashes: dict) -> str:
    """sha256 of the stage's command (its arguments after the interpreter)
    and of the hashes of the stages it depends on."""
    body = json.dumps({"command": stage.cmd[1:], "deps": [hashes[d] for d in stage.deps]})
    return hashlib.sha256(body.encode()).hexdigest()


def file_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def read_marker(p: Paths, name: str) -> dict | None:
    path = os.path.join(p.markers, f"{name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def write_marker(p: Paths, stage: Stage, digest: str, status: str, result_sha256: str | None = None) -> None:
    os.makedirs(p.markers, exist_ok=True)
    marker = {"stage": stage.name, "hash": digest, "status": status, "command": stage.cmd[1:],
              "deps": list(stage.deps), "written_ns": time.time_ns(),
              "written": time.strftime("%Y-%m-%dT%H:%M:%S")}
    if result_sha256 is not None:
        marker["result_sha256"] = result_sha256
    tmp = os.path.join(p.markers, f".{stage.name}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(marker, f, indent=2)
    os.replace(tmp, os.path.join(p.markers, f"{stage.name}.json"))


def stale(stage: Stage, digest: str, p: Paths, ran: set) -> str | None:
    """Why ``stage`` must run (None: it is done)."""
    if any(d in ran for d in stage.deps):
        return "a stage it depends on ran"
    marker = read_marker(p, stage.name)
    if marker is None:
        return "no marker"
    if marker["hash"] != digest:
        return "its command or a stage it depends on changed"
    if marker["status"] != "done":
        return f"marker {marker['status']}"
    for path in stage.outputs:
        if not os.path.exists(path):
            return f"{path} is missing"
    for dep in stage.deps:
        dep_marker = read_marker(p, dep)
        if dep_marker is None or dep_marker["written_ns"] > marker["written_ns"]:
            return f"{dep} was written after it"
    if stage.result is not None:
        if not os.path.exists(stage.result):
            return f"{stage.result} is missing"
        if file_sha256(stage.result) != marker.get("result_sha256"):
            return f"{stage.result} is not the result its marker names"
    return None


def last_json(log_path: str) -> dict | None:
    """The last line of a stage's log that is a JSON object with a "miou"
    (``cli.test_3d`` prints its results so)."""
    found = None
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{"):
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(obj, dict) and "miou" in obj:
                    found = obj
    return found


def run_command(cmd: list, log_path: str) -> int:
    """Run one stage's command from the repository root, its output into
    ``log_path``; the exit code."""
    with open(log_path, "w") as log:
        return subprocess.call(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)


def run_stage(stage: Stage, digest: str, p: Paths, runner) -> None:
    marker = read_marker(p, stage.name)
    resume = marker is not None and marker["hash"] == digest and marker["status"] == "running"
    if stage.clear and not resume and os.path.exists(stage.clear):
        shutil.rmtree(stage.clear)
    write_marker(p, stage, digest, "running")
    log_path = os.path.join(p.logs, f"{stage.name}.log")
    print(f"+ {' '.join(stage.cmd)}  (log: {log_path}{', resuming' if resume else ''})", flush=True)
    t0 = time.time()
    rc = runner(stage.cmd, log_path)
    if rc != 0:
        raise SystemExit(f"stage {stage.name} failed (rc={rc}, {time.time() - t0:.0f} s); see {log_path}")
    result_sha = None
    if stage.result is not None:
        result = last_json(log_path)
        if result is None:
            raise SystemExit(f"stage {stage.name} printed no results line; see {log_path}")
        os.makedirs(os.path.dirname(stage.result), exist_ok=True)
        with open(stage.result, "w") as f:
            json.dump(result, f, indent=2)
        result_sha = file_sha256(stage.result)
    write_marker(p, stage, digest, "done", result_sha)
    print(f"  {stage.name}: done in {(time.time() - t0) / 60:.1f} min", flush=True)


def report(args, p: Paths, stages: list) -> dict:
    results = {}
    for stage in stages:
        if stage.result is not None:
            with open(stage.result) as f:
                results[stage.name.removeprefix("test_3d_")] = json.load(f)
    mious = {m: r["miou"] for m, r in results.items() if r.get("miou") is not None}
    best = max(mious.values()) if mious else None
    out = {
        "reference_val_miou_band": REFERENCE_VAL_MIOU,
        "parity_margin": PARITY_MARGIN,
        "measured": mious,
        "best_miou": best,
        "parity_pass": best is not None and best >= REFERENCE_VAL_MIOU - PARITY_MARGIN,
        "smoke": bool(args.smoke),
        "note": "re-ground REFERENCE_VAL_MIOU from the paper's val table before quoting the gate (SURVEY.md §6 [A] "
                "tag)" + ("; SMOKE run: chain validation only, not a parity claim" if args.smoke else ""),
    }
    os.makedirs(p.results, exist_ok=True)
    with open(os.path.join(p.results, f"{p.tag}_parity.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--raw", required=True, help="raw ScanNet root (contains scans/)")
    ap.add_argument("--out", default=None,
                    help="preprocessed output root (default: data/scannet; under --smoke "
                    "outputs/torch_runbook_smoke/scannet)")
    ap.add_argument("--tsv", default=None, help="scannetv2-labels.combined.tsv path")
    ap.add_argument("--resnet34-weights", default=None,
                    help="torchvision resnet34 state_dict (.pth) for the 2D encoder import (model.unet.torch_weights)")
    ap.add_argument("--skip-2d", action="store_true", help="reuse the existing 2D checkpoint of this tree")
    ap.add_argument("--device", default="cuda", help="torch device of the model stages (default: cuda)")
    ap.add_argument("--dry-run", action="store_true", help="print the plan and each stage's state; run nothing")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny step counts and shapes: the whole chain in minutes (e.g. on a fake raw tree)")
    ap.add_argument("--root", default=REPO, help="directory the trees are relative to (default: the repository)")
    ap.add_argument("opts", nargs="*", help="key=value overrides of every model stage, last")
    return ap.parse_intermixed_args(argv)


def main(argv=None, runner=run_command) -> dict | None:
    """Run the runbook; the report (None with ``--dry-run``). ``runner(cmd,
    log_path) -> exit code`` runs one stage's command."""
    args = parse_args(argv)
    p = paths(args)
    stages = plan(args, p)
    hashes: dict = {}
    for stage in stages:
        hashes[stage.name] = stage_hash(stage, hashes)
    print("ScanNet parity runbook (mvpnet_torch) plan:")
    for name, eta in PLAN:
        print(f"  {name:20s} {eta}")
    ran: set = set()
    if args.dry_run:
        for stage in stages:
            why = stale(stage, hashes[stage.name], p, ran)
            if why is not None:
                ran.add(stage.name)  # what it would run, and so every stage after it
            print(f"  {stage.name}: {'done' if why is None else 'to run: ' + why}\n    {' '.join(stage.cmd)}")
        return None
    os.makedirs(p.logs, exist_ok=True)
    for stage in stages:
        why = stale(stage, hashes[stage.name], p, ran)
        if why is None:
            print(f"{stage.name}: done, skipping", flush=True)
            continue
        print(f"{stage.name}: {why}", flush=True)
        run_stage(stage, hashes[stage.name], p, runner)
        ran.add(stage.name)
    print(json.dumps({"stages": {s.name: "ran" if s.name in ran else "done" for s in stages}}), flush=True)
    out = report(args, p, stages)
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
