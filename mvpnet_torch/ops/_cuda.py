"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``mvpnet_torch/csrc/<name>.cu`` has a plain C interface and compiles on
its own into ``mvpnet_torch/build/lib<name>.so`` at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

A library is rebuilt when its source (or a header in csrc/) is newer. The
output is written to a temporary name and renamed into place, so processes
that build at once never load a half-written file. ``build_all`` starts one
nvcc per source, all together, and waits for every one.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("knn", "knn_fusion", "knn_gated", "knn_resident", "morton", "fps", "ballquery")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # no a*b+c contraction: distances round exactly as the plain versions'
    # separate elementwise ops do (the sources also spell __fmul_rn/__fadd_rn)
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    deps = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    ]
    return any(os.path.getmtime(d) > built for d in deps)


def _start(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_lib_path(name)}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))


def build_all(names=SOURCES) -> None:
    """Compile every stale source, one nvcc process each, all at once."""
    with _lock:
        started = [(n, *_start(n)) for n in names if _stale(n)]
        errors = []
        for name, proc, tmp in started:  # wait for every process
            try:
                _finish(name, proc, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_INT_OUT = ctypes.POINTER(ctypes.c_int)
_FLOAT = ctypes.c_float
# C signatures of the kernels' entry points (see each csrc/<name>.cu)
_SIGNATURES = {
    ("knn", "knn_brute"): (_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR),
    ("knn_fusion", "knn_fusion"): (
        _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR,
    ),
    ("knn_fusion", "knn_fusion_demand"): (
        _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT,
        _PTR, _PTR, _PTR, _PTR,
    ),
    ("knn_gated", "knn_gated"): (
        _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR,
    ),
    ("knn_resident", "knn_resident"): (
        _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR,
    ),
    ("morton", "morton_sort"): (_PTR, _PTR, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR),
    ("morton", "morton_tiles"): (
        _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
    ),
    ("fps", "fps"): (_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR),
    ("fps", "fps_perrow"): (_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR),
    ("fps", "fps_shared_bytes"): (_INT_OUT,),
    ("fps", "fps_cluster_occupancy"): (_INT, _INT_OUT),
    ("ballquery", "ball_query"): (
        _PTR, _PTR, _INT, _INT, _INT, _FLOAT, _INT, _INT, _PTR, _PTR, _PTR,
    ),
}
_functions: dict = {}


def function(lib_name: str, fn_name: str):
    """The typed ctypes entry point ``fn_name`` of csrc/<lib_name>.cu."""
    key = (lib_name, fn_name)
    fn = _functions.get(key)
    if fn is None:
        lib = load(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = list(_SIGNATURES[key])
        fn.restype = ctypes.c_int
        err_string = lib.mvp_error_string
        err_string.argtypes = [ctypes.c_int]
        err_string.restype = ctypes.c_char_p
        fn.error_string = err_string
        _functions[key] = fn
    return fn


def launch(fn, *args) -> None:
    """Call a kernel's C entry point; raise on a nonzero cudaError_t."""
    err = fn(*args)
    if err != 0:
        msg = fn.error_string(err).decode()
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed: {msg} ({err})")


def stream(t) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_xyz(t, name: str, batch: int | None = None) -> None:
    """Raise unless ``t`` is a (B, N, 3) floating tensor (of batch ``batch``)."""
    if t.ndim != 3 or t.shape[-1] != 3 or not t.is_floating_point():
        raise ValueError(f"{name} must be a (B, N, 3) float tensor, got {tuple(t.shape)} {t.dtype}")
    if batch is not None and t.shape[0] != batch:
        raise ValueError(f"{name} has batch {t.shape[0]}, expected {batch}")


def same_device(*tensors) -> None:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")


def counter_ptr(counter, like) -> int:
    """Pointer of a one-element int64 counter on ``like``'s device (a kernel
    adds to it as an unsigned long long); raises otherwise."""
    import torch

    if counter.dtype != torch.int64 or counter.numel() != 1 or counter.device != like.device:
        raise ValueError("a kernel counter must be a one-element int64 tensor on the inputs' device")
    return counter.data_ptr()
