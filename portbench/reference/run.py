"""The reference's runs: the first training steps, and whole-scene labels.

``train_steps`` follows a training run's first steps from the seed's
weights: each microbatch prepared and augmented from the run's augmentation
seed, the forward and loss, the summed gradients divided by the microbatch
count, Adam's update at the schedule's rate. ``predict_scene`` labels a scene
as the sliding-window evaluator does: every occupied window's chunk and
views, forwards of ``eval.batch_size`` windows, logits added per point,
points no window sampled filled from their nearest scored point.

Both run in float32 with TF32 off (``float32_math``), or in fp8 for the
control (``precision``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import weights
from portbench.reference import data as D
from portbench.reference import model as M
from portbench.reference import ops


@contextlib.contextmanager
def float32_math():
    """TF32 off for matmuls and convolutions while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def lr_at(solver: dict, step: int) -> float:
    """The step schedule with its floor (the configs' scheduler)."""
    if solver["scheduler"] != "step" or solver["optimizer"] != "adam" or solver["max_grad_norm"] > 0 \
            or solver["warmup_steps"] > 0 or solver["weight_decay"] > 0:
        raise ValueError("the reference follows Adam under the step schedule only")
    lr = solver["base_lr"] * solver["gamma"] ** (step // solver["step_size"])
    return max(lr, solver["clip_lr"]) if solver["clip_lr"] > 0 else lr


def train_steps(cfg: dict, batches: list[dict], seed: int, aug_seed: int, device, precision="float32") -> dict:
    """Follow ``len(batches)`` optimizer steps on device batches of the
    compact format. Returns the losses, the first forward's 2D logits, the
    first step's gradients and the parameters before and after, by name
    (float32, on the device)."""
    with float32_math():
        model = M.build(cfg["model"], device, precision)
        weights.load(model, seed, device)
        model.train()
        params = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        m = {k: torch.zeros_like(p) for k, p in params.items()}
        v = {k: torch.zeros_like(p) for k, p in params.items()}
        gen = torch.Generator().manual_seed(aug_seed)
        accum = max(1, int(cfg["train"]["grad_accum"]))
        losses, first_grad, logits_2d = [], None, None
        for t, batch in enumerate(batches):
            model.zero_grad(set_to_none=True)
            B = batch["points"].shape[0]
            size = B // accum
            step_loss = []
            for a in range(accum):
                micro = {k: x[a * size : (a + 1) * size] for k, x in batch.items()}
                inputs = D.prepare(micro, cfg["data"], generator=gen)
                out = model(inputs)
                if logits_2d is None:
                    logits_2d = out[1].detach().clone()
                value = M.loss(out, inputs, cfg["model"], cfg["data"]["ignore_label"])
                value.backward()
                step_loss.append(float(value.detach()))
            losses.append(float(np.mean(step_loss)))
            lr = lr_at(cfg["solver"], t)
            with torch.no_grad():
                grads = {k: p.grad / accum for k, p in params.items()}
                if first_grad is None:
                    first_grad = {k: g.clone() for k, g in grads.items()}
                n = t + 1
                for k, p in params.items():
                    m[k].mul_(0.9).add_(grads[k], alpha=0.1)
                    v[k].mul_(0.999).addcmul_(grads[k], grads[k], value=0.001)
                    denom = (v[k].sqrt() / np.sqrt(1 - 0.999**n)).add_(1e-8)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - 0.9**n))
        end = {k: p.detach().clone() for k, p in params.items()}
    return {"losses": losses, "logits_2d": logits_2d, "grad": first_grad, "start": start, "end": end}


@torch.no_grad()
def predict_scene(cfg: dict, scene: dict, seed: int, device, precision="float32") -> np.ndarray:
    """(P, num_classes) float32 logits of every scene point."""
    data = cfg["data"]
    with float32_math():
        model = M.build(cfg["model"], device, precision)
        weights.load(model, seed, device)
        model.eval()
        P = len(scene["points"])
        acc = torch.zeros((P, data["num_classes"]), device=device)
        cnt = torch.zeros(P, dtype=torch.int64, device=device)
        windows = D.scene_windows(scene, data)
        bs = int(cfg["eval"]["batch_size"])
        for s in range(0, len(windows), bs):
            group = D.collate(windows[s : s + bs])
            idx = torch.from_numpy(group.pop("point_idx")).to(device).reshape(-1)
            batch = {k: torch.from_numpy(x).to(device) for k, x in group.items()}
            logits, _ = model(D.prepare(batch, data))
            acc.index_add_(0, idx, logits.reshape(-1, logits.shape[-1]))
            cnt.index_add_(0, idx, torch.ones_like(idx))
        covered = cnt > 0
        if (~covered).any() and covered.any():
            pts = torch.from_numpy(scene["points"]).to(device)
            ref_idx = torch.nonzero(covered)[:, 0]
            nn_ = ops.nearest(pts[~covered], pts[ref_idx])
            acc[~covered] = acc[ref_idx[nn_]]
    return acc.cpu().numpy()
