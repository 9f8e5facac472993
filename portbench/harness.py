"""What every cell shares: the manifest, the run record, the program's model
with the benchmark's weights, the metric readers.

Everything is found by name. A cell is ``workloads/<cell>.json`` (its
configuration, traffic, chips, limits); a configuration is
``configs/<config>.json`` (the config as run, in full); a traffic mix is
``traffic/<traffic>.json`` (the parameters the generator and the cell's
driver read; ``driver`` names ``drivers/<driver>.py``); a metric is
``metrics/<metric>.py``. ``BENCHMARK.json`` says which metrics a cell
reports. Adding a cell, a configuration, a traffic mix or a metric adds
files and entries, and edits no file.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field

PKG = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "mvpnet_tpu")


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Manifest:
    root: str

    @property
    def bench(self) -> dict:
        return _json(os.path.join(self.root, "BENCHMARK.json"))

    def _dir(self, sub: str) -> str:
        return os.path.join(self.root, "portbench", sub)

    def cell(self, name: str) -> dict:
        return _json(os.path.join(self._dir("workloads"), f"{name}.json"))

    def config(self, name: str) -> dict:
        return _json(os.path.join(self._dir("configs"), f"{name}.json"))

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self._dir("traffic"), f"{name}.json"))

    def metrics_of(self, cell: str, trace: bool) -> list[dict]:
        """The BENCHMARK.json metrics a cell reports: its end-to-end ones, or
        with ``trace`` its per-layer ones. A metric without ``workloads`` is
        reported by every cell that reports the end-to-end metric it moves."""
        bench = self.bench
        e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in bench["per_layer"] if cell in m.get("workloads", [cell] if m["moves"] in names else [])]

    def reader(self, metric: str):
        return _load(os.path.join(self._dir("metrics"), f"{metric}.py"), f"portbench_metric_{metric}")

    def driver(self, name: str):
        return _load(os.path.join(self._dir("drivers"), f"{name}.py"), f"portbench_driver_{name}")


def _load(path: str, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Run:
    """One run's record, which the metric readers read.

    ``units``: one dict a timed unit (a step or a scene) with its host
    seconds; ``forwards``: the rows of each model forward in the window;
    ``launches``: the program's kernel launch counters over the window;
    ``trace``: the ``trace.Trace`` of a traced window, else None."""

    cell: str
    cfg: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    units: list = field(default_factory=list)
    forwards: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    peak_bytes: int = 0
    window_peak_bytes: int = 0
    trace: object = None
    attempted: int = 0
    failed: int = 0
    numbers: dict = field(default_factory=dict)


def program_config(cfg: dict, dtype: str | None = None):
    """The port's ``Config`` of a configuration file's ``config``; with
    ``dtype``, both networks compute in it instead of the file's."""
    from mvpnet_torch.config import Config, _merge_dataclass

    if dtype is not None:
        model = cfg["model"]
        cfg = {**cfg, "model": {**model, "unet": {**model["unet"], "dtype": dtype},
                                "pn2": {**model["pn2"], "dtype": dtype}}}
    return _merge_dataclass(Config(), cfg)


def program_model(cfg, seed: int, device):
    """The port's model of ``cfg`` on ``device`` with the seed's weights;
    (model, loss_fn, metric_fn)."""
    from mvpnet_torch.models.build import build_model

    from portbench import weights

    model, loss_fn, metric_fn = build_model(cfg, seed=0)
    model = model.to(device)
    weights.load(model, seed, device)
    return model, loss_fn, metric_fn


def program_scenes(arrays: list[dict]):
    """The port's ``Scene`` objects over the corpus's arrays (no copy)."""
    from mvpnet_torch.data.synthetic import Scene

    return [Scene(**{k: v for k, v in a.items() if not k.startswith("_")}) for a in arrays]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({name for name in list(sys.modules) if name.split(".", 1)[0] in FORBIDDEN})


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}
