"""Serialized inference artifacts (``torch.export``).

Counterpart of ``mvpnet_tpu/eval/export_model.py``: the chunk-inference
forward (``prepare_batch``, then the model's 3D logits) is exported with
its parameters baked in to a self-contained artifact that a serving process
loads without the model-building code.

Artifact layout (one directory):
  forward.pt2   ``torch.export.save`` of the exported program
  meta.json     shapes, dtypes, config echo, class names, the platform; for
                a CUDA artifact the exporting card (``nvidia-smi`` name and
                power limit: the kernels' layouts were chosen for it)

The program holds each kernel as one node, a ``torch.ops.mvpnet.*`` custom
op (``ops/_library.py``), so loading needs ``mvpnet_torch.ops`` imported
(``meta["requires"]``): its CUDA implementation builds the kernel at first
use and launches it at every call, and ``ops.launch_counts()`` counts them.
A CUDA artifact runs on CUDA only: without a card, loading raises.
"""
from __future__ import annotations

import json
import os
import subprocess

import torch
from torch import nn

from mvpnet_torch.config import Config, to_dict
from mvpnet_torch.data.meta import CLASS_NAMES
from mvpnet_torch.train.step import prepare_batch

# the raw eval chunk batch (host wire layout, before the lift; see
# data/pipeline.make_chunk_sample and train/step.prepare_batch)
_BATCH_KEYS = ("points", "images", "depth", "poses", "intrinsics")
_PROGRAM = "forward.pt2"
_META = "meta.json"


def _batch_spec(cfg: Config, batch_size: int) -> dict:
    B = batch_size
    N = cfg.data.num_points
    V = cfg.data.num_views_eval
    H, W = cfg.data.image_height, cfg.data.image_width
    shapes = {"points": (B, N, 3), "images": (B, V, H, W, 3), "depth": (B, V, H, W), "poses": (B, V, 4, 4),
              "intrinsics": (B, 3, 3)}
    return {k: {"shape": list(shapes[k]), "dtype": "float32"} for k in _BATCH_KEYS}


class _Forward(nn.Module):
    """The eval forward on a raw chunk batch: 3D logits (B, N, C) f32."""

    def __init__(self, model: nn.Module, cfg: Config):
        super().__init__()
        self.model = model
        self.cfg = cfg

    def forward(self, batch: dict) -> torch.Tensor:
        logits_3d, _ = self.model(prepare_batch(self.cfg, batch, training=False))
        return logits_3d


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def export_inference(model, cfg: Config, out_dir: str, *, batch_size: int | None = None) -> str:
    """Export the eval forward (logits over chunk points) with the parameters
    baked in, traced on the model's device. Returns the artifact directory."""
    model.eval()
    B = batch_size or cfg.eval.batch_size
    device = next(model.parameters()).device
    spec = _batch_spec(cfg, B)
    example = {k: torch.zeros(v["shape"], dtype=torch.float32, device=device) for k, v in spec.items()}
    with torch.no_grad():
        program = torch.export.export(_Forward(model, cfg), (example,))
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _PROGRAM))
    meta = {
        "batch_keys": list(_BATCH_KEYS),
        "input_spec": spec,
        "output": {
            "shape": [B, cfg.data.num_points, cfg.data.num_classes],
            "dtype": "float32",
            "semantics": "per-point class logits",
        },
        "platforms": [device.type],
        "class_names": list(CLASS_NAMES[: cfg.data.num_classes]),
        "config": to_dict(cfg),
        "requires": ["mvpnet_torch.ops"],
    }
    if device.type == "cuda":
        meta["device"] = _card()
    with open(os.path.join(out_dir, _META), "w") as fh:
        json.dump(meta, fh, indent=2)
    return out_dir


def kernel_nodes(program) -> dict[str, int]:
    """Nodes of each ``mvpnet::`` op in an exported program's graph."""
    counts: dict[str, int] = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and getattr(node.target, "namespace", None) == "mvpnet":
            name = node.target.name().split("::")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


class LoadedModel:
    """A loaded inference artifact: ``__call__(batch) -> logits`` (a tensor
    on the artifact's device)."""

    def __init__(self, art_dir: str):
        import mvpnet_torch.ops  # noqa: F401  (registers the mvpnet:: ops the program calls)

        with open(os.path.join(art_dir, _META)) as fh:
            self.meta = json.load(fh)
        (platform,) = self.meta["platforms"]
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{art_dir} is a CUDA artifact (exported on {self.meta.get('device')}); "
                               "no CUDA device found")
        self.device = torch.device(platform)
        self.program = torch.export.load(os.path.join(art_dir, _PROGRAM))
        self._forward = self.program.module()

    def __call__(self, batch: dict) -> torch.Tensor:
        spec = self.meta["input_spec"]
        inputs = {
            k: torch.as_tensor(batch[k]).to(self.device, dtype=getattr(torch, spec[k]["dtype"])) for k in spec
        }
        with torch.no_grad():
            return self._forward(inputs)


def load_inference(art_dir: str) -> LoadedModel:
    return LoadedModel(art_dir)
