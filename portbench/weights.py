"""Weights made from a run's seed, on the device, in one draw.

Both the program's model and the reference load the same tensors: one
``torch.randn`` of every weight's elements from a generator on the device
seeded with ``--seed``, cut in the order of the model's ``state_dict`` and
scaled by kind. Convolutions and linear layers get He-normal scales (the
heads LeCun-normal), BatchNorm scales 1 + 0.1 r and shifts 0.1 r, the heads'
biases 0.01 r; running statistics start at mean 0 and variance 1, as a fresh
model's do.
"""
from __future__ import annotations

import math

import torch

HEADS = ("seg_head", "net_3d.head.")


def _is_norm(name: str) -> bool:
    return "norm" in name.rsplit(".", 1)[0]


def make(shapes: list[tuple[str, tuple[int, ...]]], seed: int, device) -> dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for each (name, shape)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    total = sum(math.prod(s) for _, s in shapes)
    draw = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        r = draw[at : at + n].view(shape)
        at += n
        head = any(h in name for h in HEADS)
        if name.endswith("running_mean"):
            t = torch.zeros(shape, device=device)
        elif name.endswith("running_var"):
            t = torch.ones(shape, device=device)
        elif len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            t = r * math.sqrt((1.0 if head else 2.0) / fan_in)
        elif _is_norm(name) and name.endswith("weight"):
            t = 1.0 + 0.1 * r
        else:
            t = (0.01 if head else 0.1) * r
        out[name] = t.clone()
    return out


def shapes_of(module: torch.nn.Module) -> list[tuple[str, tuple[int, ...]]]:
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def load(module: torch.nn.Module, seed: int, device) -> None:
    """Make the weights of ``module`` from ``seed`` and load them (strict)."""
    module.load_state_dict(make(shapes_of(module), seed, device), strict=True)
