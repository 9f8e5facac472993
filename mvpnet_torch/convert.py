"""Weight bridge: load a flax NNX state of the JAX model into the port.

``load_jax_params(model, flat)`` takes a dict of numpy arrays keyed by NNX
paths joined with "/" — the keys of
``nnx.to_flat_state(nnx.state(model, nnx.Any(nnx.Param, nnx.BatchStat)))``,
for example ``net_3d/sa_layers/0/mlp/layers/0/kernel`` or
``net_2d/encoder/stem_norm/mean`` — and writes them into the module of the
same path:

  Linear kernel (in, out)          -> weight (out, in): transpose
  Conv kernel (kh, kw, in, out)    -> weight (out, in, kh, kw): HWIO -> OIHW
  norm scale / bias / mean / var   -> weight / bias / running_mean / running_var

It raises on a missing key, an unconsumed key or a shape mismatch, so a
partial or differently-shaped state never loads silently.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {"scale": "weight", "mean": "running_mean", "var": "running_var", "bias": "bias"}


def _torch_key(jax_key: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    *path, leaf = jax_key.split("/")
    if leaf == "kernel":
        if value.ndim == 2:  # Linear (in, out)
            value = value.T
        elif value.ndim == 4:  # Conv HWIO
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"{jax_key}: kernel of rank {value.ndim}")
        name = "weight"
    elif leaf in _LEAF_NAMES:
        name = _LEAF_NAMES[leaf]
    else:
        raise KeyError(f"{jax_key}: no port counterpart for leaf {leaf!r}")
    return ".".join(path + [name]), value


def load_jax_params(model: nn.Module, flat: dict) -> list[str]:
    """Copy every entry of ``flat`` into ``model``; returns the torch keys set."""
    state = model.state_dict()
    consumed: list[str] = []
    for jax_key, value in flat.items():
        tkey, arr = _torch_key(jax_key, np.asarray(value))
        if tkey not in state:
            raise KeyError(f"{jax_key}: the port has no {tkey!r}")
        if tuple(state[tkey].shape) != arr.shape:
            raise ValueError(f"{jax_key}: shape {arr.shape} != port {tkey} {tuple(state[tkey].shape)}")
        with torch.no_grad():
            state[tkey].copy_(torch.tensor(arr, dtype=state[tkey].dtype))
        consumed.append(tkey)
    missing = sorted(set(state) - set(consumed))
    if missing:
        raise KeyError(f"{len(missing)} port tensors have no JAX counterpart: {missing[:8]}")
    return consumed
