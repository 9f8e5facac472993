"""Readings that the cells' limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--program-seconds 1] [--control-seeds 11 12 13]

At the cell's own sizes, for each of ``--control-seeds``:
  * ``control``: the reference computed in fp8 (the step below the configs'
    bfloat16), put in the program's place and judged by the cell's numbers
    against the float32 reference on the same inputs. Training cells take
    the first steps' batches of data worker 0; scene cells the first scene.
  * ``half_batch`` (training cells): the float32 reference stepping on the
    first half of each step's microbatches only (the first microbatch whole),
    the mean taken over them, judged the same way;
  * ``reference_bf16`` (training cells, ``--bf16``): the reference in bf16,
    what the configs' precision does with no program in the way.
and for each of ``--seeds`` (with ``--program-seconds``): ``program``, one run
of the cell itself with that window, in this process, with every number its
check computed (``--float32``: the program's networks in float32, TF32 off,
a witness that its gaps from the reference are round-off).
One JSON line a seed and kind. A step that leaves its state unchanged reads
``update_gap`` 1 by the measure itself and needs no run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import compare, harness  # noqa: E402
from portbench.reference import data as D  # noqa: E402
from portbench.reference import run as R  # noqa: E402


def train_readings(cfg: dict, scenes: list[dict], seed: int, device, bf16: bool = False) -> dict:
    import torch

    from portbench.drivers.train import CHECK_STEPS, seeds

    data_seed, aug_seed = seeds(seed)
    stream = D.WorkerStream(scenes, cfg["data"], data_seed, 0)
    rows = cfg["train"]["batch_size"]
    host = [D.collate([stream.next_sample() for _ in range(rows)]) for _ in range(CHECK_STEPS)]
    accum = max(1, cfg["train"]["grad_accum"])

    def on_device(batches):
        return [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in batches]

    ref = R.train_steps(cfg, on_device(host), seed, aug_seed, device)
    fp8 = R.train_steps(cfg, on_device(host), seed, aug_seed, device, precision="fp8")
    half_cfg = {**cfg, "train": {**cfg["train"], "batch_size": rows // 2, "grad_accum": max(1, accum // 2)}}
    halved = R.train_steps(half_cfg, on_device([{k: v[: rows // 2] for k, v in b.items()} for b in host]), seed,
                           aug_seed, device)
    out = {"control": compare.train_numbers(fp8, ref), "half_batch": compare.train_numbers(halved, ref)}
    if bf16:
        out["reference_bf16"] = compare.train_numbers(R.train_steps(cfg, on_device(host), seed, aug_seed, device,
                                                                    precision="bf16"), ref)
    return out


def scene_readings(cfg: dict, scenes: list[dict], seed: int, device, bf16: bool = False) -> dict:
    ref = R.predict_scene(cfg, dict(scenes[0]), seed, device)
    fp8 = R.predict_scene(cfg, dict(scenes[0]), seed, device, precision="fp8")
    return {"control": compare.scene_numbers(fp8, ref)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--program-seconds", type=float, default=1.0)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--bf16", action="store_true",
                        help="with the control, the reference in bf16 (a witness of what the configs' rounding does)")
    parser.add_argument("--float32", action="store_true",
                        help="run the program in float32 with TF32 off (a witness: its gaps from the reference are round-off)")
    args = parser.parse_args(argv)
    import torch

    from portbench import run as bench_run
    from portbench.traffic.synthetic import Corpus

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    manifest = harness.Manifest(ROOT)
    cell = manifest.cell(args.workload)
    cfg = manifest.config(cell["config"])["config"]
    traffic = manifest.traffic(cell["traffic"])
    if args.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for seed in args.seeds:
        res, rec = bench_run.run_cell(ROOT, args.workload, seed, args.program_seconds, False, "cuda", t0=0.0,
                                      program_dtype="float32" if args.float32 else None)
        print(json.dumps({"seed": seed, "float32": args.float32, "program": rec.numbers, "correct": res["correct"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items() if k != "setup_s"}}), flush=True)
        torch.cuda.empty_cache()
    readings = train_readings if traffic["driver"] == "train" else scene_readings
    for seed in args.control_seeds:
        scenes = Corpus(traffic, cfg, seed).scenes()
        print(json.dumps({"seed": seed, **readings(cfg, scenes, seed, torch.device("cuda"), args.bf16)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
