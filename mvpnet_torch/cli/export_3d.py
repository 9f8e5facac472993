"""CLI: export a trained 3D model to a serialized inference artifact.

Counterpart of ``python -m mvpnet_tpu.cli.export_3d``: restore the latest
checkpoint under ``<output_dir>/checkpoints`` and write a self-contained
``torch.export`` artifact (parameters baked in) and its meta sidecar, which
a serving process loads without the model code (eval/export_model.py):

  python -m mvpnet_torch.cli.export_3d --cfg configs/scannet/mvpnet_3d_unet_resnet34_pn2ssg.yaml \\
      data.name=synthetic output_dir=outputs/cli_run --out artifacts/mvpnet3d [--batch-size 4] [--check]

``--check`` reloads the artifact and holds its logits on a seeded example
batch against the restored model's eager forward (``agreement``). ``main``
returns the export's seconds and, with ``--check``, the agreement.
``--device cpu`` exports on the CPU (tiny configs only); the artifact then
runs on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from mvpnet_torch.cli.test_3d import restore
from mvpnet_torch.config import load_config
from mvpnet_torch.entry import example_batch, resolve_device, to_device
from mvpnet_torch.eval.export_model import export_inference, load_inference
from mvpnet_torch.train.step import prepare_batch
from mvpnet_torch.utils.logger import setup_logger

# logits within this margin of the runner-up are ties at bf16 precision: the
# artifact's argmax must equal the eager one on every decision above it
TAU = 0.5
MIN_CONFIDENT_AGREEMENT = 0.9999
# bf16 keeps 8 significant bits, so a logit x lies on a grid of step
# 2^(floor(log2 |x|) - 7); two forwards that sum in another order part by a
# few steps, which at large logits exceeds TAU
BF16_TIE_STEPS = 4


def agreement(got: np.ndarray, want: np.ndarray, tau: float = TAU) -> dict:
    """The artifact's logits ``got`` against the eager ``want`` (B, N, C):
    argmax agreement overall and on the decisions whose top-2 margin in
    ``want`` exceeds ``tau`` (a scalar, or one a decision as
    ``bf16_tie_band`` gives; 1.0 when there is none), the share of those
    decisions, and max |delta|."""
    same = got.argmax(-1) == want.argmax(-1)
    top2 = np.partition(want, -2, axis=-1)
    confident = top2[..., -1] - top2[..., -2] > tau
    return {
        "agreement": float(same.mean()),
        "confident_agreement": float(same[confident].mean()) if confident.any() else 1.0,
        "confident_share": float(confident.mean()),
        "max_abs": float(np.abs(got - want).max()),
    }


def bf16_tie_band(want: np.ndarray) -> np.ndarray:
    """``agreement``'s tau for each decision of ``want`` (..., C) at bf16:
    BF16_TIE_STEPS bf16 grid steps at its top logit, and never less than TAU."""
    top = np.abs(want.max(-1)).astype(np.float64)
    grid = np.exp2(np.floor(np.log2(np.maximum(top, np.finfo(np.float32).tiny))) - 7)
    return np.maximum(TAU, BF16_TIE_STEPS * grid)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cfg", default=None)
    ap.add_argument("--out", required=True, help="artifact output dir")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--check", action="store_true", help="reload the artifact and verify it reproduces the live model")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    cfg = load_config(args.cfg, args.opts)
    dev = resolve_device(args.device)
    logger = setup_logger(output_dir=None)
    model, step = restore(cfg, dev)
    logger.info("restored checkpoint step=%s", step)
    t0 = time.perf_counter()
    out = export_inference(model, cfg, args.out, batch_size=args.batch_size or cfg.eval.batch_size)
    result = {"export_s": time.perf_counter() - t0}
    logger.info("exported inference artifact to %s in %.1f s", out, result["export_s"])
    if not args.check:
        return result

    loaded = load_inference(out)
    spec = loaded.meta["input_spec"]
    B, N, _ = spec["points"]["shape"]
    _, V, H, W = spec["depth"]["shape"]
    raw = example_batch(np.random.default_rng(0), B=B, N=N, V=V, H=H, W=W)
    batch = {k: raw[k] for k in spec}
    got = loaded(batch).float().cpu().numpy()
    with torch.no_grad():
        want = model(prepare_batch(cfg, to_device(batch, dev), training=False))[0].float().cpu().numpy()
    # the program replays the eager forward's ATen ops, so equal logits are
    # expected; the gate is the JAX export's margin rule all the same
    result.update(agreement(got, want))
    logger.info(
        "artifact check: argmax agreement %.4f (%.4f on margin>%.1f decisions, %.0f%% of points), "
        "max |delta| %.3e",
        result["agreement"], result["confident_agreement"], TAU, 100 * result["confident_share"], result["max_abs"],
    )
    if result["confident_agreement"] < MIN_CONFIDENT_AGREEMENT:
        raise SystemExit(
            f"artifact disagrees beyond bf16 tie noise: confident-decision agreement "
            f"{result['confident_agreement']:.4f}, max |delta| {result['max_abs']:.3e}"
        )
    return result


if __name__ == "__main__":
    main()
