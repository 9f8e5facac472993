"""The numbers that decide ``correct``, each held to its cell's limit.

Training cells (the first optimizer steps of the run, against the reference
following them):
  * ``logit2d_err``: the first forward's 2D logits (the UNet's), the norm
    of the difference over the reference's norm (another shape reads
    infinite);
  * ``bias_grad_err``: the first gradient of the 3D head's bias as the
    optimizer got it (Adam's first moment after one step over 1 - beta1),
    the norm of the difference over the reference's norm: the mean over the
    batch's labelled points of softmax minus one-hot, so every row of every
    microbatch of the step counts in it;
  * ``update_gap``: the parameters' change over the checked steps, by the
    worst leaf: the gap of the program's norm from the reference's, over the
    larger of the reference leaf's norm and the median leaf's; leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out (they move by round-off alone);
  * ``loss_gap`` (the largest relative gap of a step's loss) and
    ``grad_gap`` (the first gradient by the worst leaf, as ``update_gap``).
The cell's limits choose which numbers are compared (``PERF.md`` §4 says why).
Scene cells (each sampled scene's accumulated logits, against the
reference's labelling of that scene), over the reference's logit RMS:
  * ``logit_gap``: the largest absolute gap of a logit;
  * ``label_gap``: the widest gap by which the reference's logit of the
    program's label lies below the reference's best.
"""
from __future__ import annotations

import numpy as np
import torch

TINY_GRAD = 1e-3
HEAD_BIAS = "net_3d.head.bias"


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def leaf_gaps(program: dict, reference: dict) -> dict:
    """Each leaf's |norm(program) - norm(reference)| over
    max(norm(reference), median leaf norm)."""
    names = list(reference)
    p, r = _norms({k: program[k] for k in names}), _norms({k: reference[k] for k in names})
    med = float(np.median([r[k] for k in names]))
    return {k: abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in names}


def rel_err(program: torch.Tensor, reference: torch.Tensor) -> float:
    """norm(program - reference) / norm(reference); another shape reads
    infinite."""
    p, r = program.float(), reference.float()
    if p.shape != r.shape:
        return float("inf")
    return float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r).clamp_min(1e-30))


def train_numbers(program: dict, reference: dict) -> dict:
    """``program`` and ``reference``: losses (per step), grad (first step's,
    by leaf), start and end parameters by leaf, the first forward's 2D
    logits."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program["losses"], reference["losses"])]
    if len(program["losses"]) != len(reference["losses"]):
        losses.append(float("inf"))
    grad_norms = _norms(reference["grad"])
    med = float(np.median(list(grad_norms.values())))
    moving = {k for k, n in grad_norms.items() if n >= TINY_GRAD * med}

    def change(side):
        return {k: side["end"][k].float() - side["start"][k].float() for k in moving}

    return {
        "logit2d_err": rel_err(program["logits_2d"], reference["logits_2d"]),
        "bias_grad_err": rel_err(program["grad"][HEAD_BIAS], reference["grad"][HEAD_BIAS]),
        "update_gap": max(leaf_gaps(change(program), change(reference)).values()),
        "loss_gap": max(losses),
        "grad_gap": max(leaf_gaps(program["grad"], reference["grad"]).values()),
    }


def scene_numbers(program: np.ndarray, reference: np.ndarray) -> dict:
    p, r = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    if p.shape != r.shape or not np.isfinite(p).all():
        return {"logit_gap": float("inf"), "label_gap": float("inf")}
    scale = max(float(np.sqrt(np.mean(r * r))), 1e-30)
    label = p.argmax(axis=1)
    below = r.max(axis=1) - r[np.arange(len(r)), label]
    return {"logit_gap": float(np.abs(p - r).max()) / scale, "label_gap": float(below.max()) / scale}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number the cell limits is within its limit, {name: {value,
    limit}}); a limit without a number, or without a value, fails. The cell's
    limits choose which of the numbers are compared."""
    checks = {k: {"value": numbers.get(k, float("inf")), "limit": limits[k]} for k in sorted(limits)}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
