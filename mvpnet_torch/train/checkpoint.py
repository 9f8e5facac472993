"""Checkpointing on torch ``state_dict``s: model + optimizer + step,
auto-resume, keep-N retention by the best metric, 2D warm start.

Counterpart of ``mvpnet_tpu/train/checkpoint.py`` (orbax). Each save writes
``<directory>/<step>/state.pt`` (model, optimizer and metrics); a step
directory is complete once it exists, as it is renamed into place. Retention
follows orbax's ``max_to_keep`` under ``best_fn = metrics["miou"]``,
``best_mode = "max"``: while more than ``keep`` checkpoints exist, those with
metrics are ranked by mIoU (a stable sort in step order, so the later of two
equal ones ranks higher) and only the ``keep`` best stay; checkpoints saved
without metrics are never removed.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

_STATE = "state.pt"
_METRICS = "metrics.json"


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        """Steps with a complete checkpoint, ascending."""
        return sorted(
            int(n) for n in os.listdir(self.directory)
            if n.isdigit() and os.path.exists(os.path.join(self.directory, n, _STATE))
        )

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model, optimizer=None, metrics: dict | None = None) -> None:
        # scalar metrics only, as the JAX checkpointer keeps them; none -> None
        metrics = {
            k: float(v) for k, v in (metrics or {}).items() if np.isscalar(v) or getattr(v, "ndim", 1) == 0
        } or None
        state = {"model": model.state_dict()}
        if optimizer is not None:
            state["opt"] = optimizer.state_dict()
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        with open(os.path.join(tmp, _METRICS), "w") as f:
            json.dump(metrics, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        self._remove_old()

    def _metrics(self, step: int):
        with open(os.path.join(self.directory, str(step), _METRICS)) as f:
            return json.load(f)

    def _remove_old(self) -> None:
        steps = self.steps()
        if len(steps) <= self.keep:
            return
        ranked = sorted(
            (s for s in steps if self._metrics(s) is not None),
            key=lambda s: self._metrics(s).get("miou", 0.0),
        )
        keep = set(ranked[-self.keep :] if self.keep > 0 else [])
        keep |= {s for s in steps if self._metrics(s) is None}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)))

    def restore(self, model, optimizer=None, step: int | None = None) -> int | None:
        """Restore in place (the latest step by default); returns the step,
        or None when there is no checkpoint. With ``optimizer=None`` only
        the model is restored."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        state = torch.load(os.path.join(self.directory, str(step), _STATE), map_location="cpu", weights_only=True)
        model.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["opt"])
        return step


def warm_start_2d(model_3d, ckpt_dir_2d: str) -> bool:
    """Load the ``net_2d.*`` tensors of the latest port checkpoint in
    ``ckpt_dir_2d`` into ``model_3d.net_2d``. Returns True if loaded, False
    when the directory or a checkpoint is missing."""
    directory = os.path.abspath(ckpt_dir_2d)
    if not os.path.isdir(directory):
        return False
    ckpt = Checkpointer(directory)
    step = ckpt.latest_step()
    if step is None:
        return False
    state = torch.load(os.path.join(directory, str(step), _STATE), map_location="cpu", weights_only=True)
    prefix = "net_2d."
    sub = {k[len(prefix):]: v for k, v in state["model"].items() if k.startswith(prefix)}
    model_3d.net_2d.load_state_dict(sub)
    return True


def freeze_filter(freeze_2d: bool):
    """Predicate over parameter names: True for the trainable ones (all, or
    all but ``net_2d.*`` when the 2D net is frozen)."""
    if not freeze_2d:
        return lambda name: True
    return lambda name: not name.startswith("net_2d.")


def trainable_parameters(model, freeze_2d: bool) -> list:
    """The parameters the optimizer updates; frozen ones stop requiring
    gradients."""
    keep = freeze_filter(freeze_2d)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(keep(name))
        if keep(name):
            params.append(p)
    return params
