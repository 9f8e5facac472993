"""Package rules of the PyTorch port: no JAX anywhere in it, CUDA unless the
caller asks for the CPU, kernels built from sources the repo ships, and a
chip smoke test that fails where it cannot run."""
import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from mvpnet_torch import entry as entry_mod
from mvpnet_torch import ops
from mvpnet_torch.ops import _cuda

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "mvpnet_tpu"}
# the package's sources, not what is generated under its git-ignored build dir
PORT_FILES = sorted(
    p for p in (ROOT / "mvpnet_torch").rglob("*.py") if not p.is_relative_to(_cuda.BUILD_DIR)
) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path, top_level_only=False):
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_config_imports_yaml_lazily():
    # the machine with the card may lack PyYAML: a default Config must build
    assert "yaml" not in set(_imported_roots(ROOT / "mvpnet_torch" / "config.py", top_level_only=True))


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry_mod.train_entry()
    assert entry_mod.resolve_device("cpu") == torch.device("cpu")


def test_gitignore_lists_kernel_build_dir():
    lines = (ROOT / ".gitignore").read_text().split()
    assert "mvpnet_torch/build/" in lines
    assert os.path.relpath(_cuda.BUILD_DIR, ROOT) == os.path.join("mvpnet_torch", "build")


@pytest.mark.parametrize("name", _cuda.SOURCES)
def test_kernel_sources_ship_with_the_repo(name):
    src = (ROOT / "mvpnet_torch" / "csrc" / f"{name}.cu").read_text()
    assert "mvpnet_tpu/ops/pallas/" in src  # names the TPU kernel it replaces
    assert 'extern "C"' in src and "cudaGetLastError" in src
    assert "sm_90a" in " ".join(_cuda.NVCC_FLAGS)


def _c_kind(param: str) -> str:
    param = param.replace("const ", "").strip()
    return "ptr" if "*" in param else param.split()[0]


_CTYPES_KIND = {_cuda._PTR: "ptr", _cuda._INT_OUT: "ptr", _cuda._INT: "int", _cuda._FLOAT: "float"}


@pytest.mark.parametrize("lib,fn", sorted(_cuda._SIGNATURES), ids=lambda x: x)
def test_ctypes_signatures_match_the_sources(lib, fn):
    """The argtypes the wrappers declare equal the C entry point's
    parameters, kind for kind: a ctypes call with another count fails only
    on the card."""
    src = (ROOT / "mvpnet_torch" / "csrc" / f"{lib}.cu").read_text()
    match = re.search(r'extern "C" int\s+' + fn + r"\s*\(([^)]*)\)", src)
    assert match, f'no extern "C" int {fn}(...) in csrc/{lib}.cu'
    want = [_c_kind(p) for p in match.group(1).split(",")]
    assert [_CTYPES_KIND[t] for t in _cuda._SIGNATURES[(lib, fn)]] == want


def test_every_kernel_has_a_counted_wrapper():
    assert set(ops.KERNELS) == {
        "knn_fusion", "fps", "fps_perrow", "ball_query", "knn", "knn_gated", "knn_resident", "morton_prep",
    }
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def _run_smoke(cwd):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA here: the smoke test must exit nonzero and print no result,
    in the repo and in a directory holding chip_smoke.py alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
