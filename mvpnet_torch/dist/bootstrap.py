"""Process-group bootstrap: one process per rank, one device per process.

Counterpart of ``mvpnet_tpu/dist/bootstrap.py`` over ``torch.distributed``:

  * ``initialize()`` — idempotent ``init_process_group``. Its sources, in
    priority order: explicit arguments; the launcher's environment
    (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, as
    ``python -m torch.distributed.run`` sets it); JAX's names
    (``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``). With none of
    them it creates no group and every path runs on one process as before.
    The backend follows from the device: ``nccl`` for CUDA (each rank takes
    ``cuda:{LOCAL_RANK}`` and sets it before any allocation), ``gloo`` for
    the CPU; nothing is tried and then swapped. A configured coordinator
    that cannot be reached raises.
  * ``is_primary()`` — rank 0 (or no group): the rank that writes the
    config, logs, metrics and checkpoints.
  * ``global_batch_to_local(...)`` — the per-rank batch: the ranks of one
    space group load the same chunks, so the global batch splits over
    ``data`` only.
  * ``make_global_batch(...)`` — this rank's arrays under ``specs`` (its
    view slice for space-sharded training; ``dist/train_sp.batch_specs``).
  * ``barrier()``.
"""
from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from mvpnet_torch.dist.mesh import DATA_AXIS, SPACE_AXIS

logger = logging.getLogger("mvpnet_torch.dist")

# a collective that waits longer than this fails the run instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)

_state: dict = {"device": None, "timeout": TIMEOUT}


def _sources(init_method, world_size, rank):
    """(init_method, world_size, rank) from the arguments, else torchrun's
    environment, else JAX's names; None when there is no launcher."""
    env = os.environ
    if init_method is not None:
        return init_method, world_size, rank
    if "RANK" in env and "WORLD_SIZE" in env:
        return "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
    if env.get("COORDINATOR_ADDRESS"):
        return f"tcp://{env['COORDINATOR_ADDRESS']}", int(env["NUM_PROCESSES"]), int(env["PROCESS_ID"])
    return None


def _rank_device(device, rank: int) -> torch.device:
    from mvpnet_torch.entry import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    return dev


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    *,
    device=None,
    timeout: datetime.timedelta | None = None,
) -> bool:
    """Create the default process group (idempotent). Returns True iff a
    group is active after the call.

    ``device`` is the caller's device request (None: CUDA); the backend
    follows from it. Raises RuntimeError when a configured coordinator
    cannot be reached, and ValueError when a group already exists with the
    other backend."""
    if dist.is_initialized():
        if device is not None:
            want = _backend_for(torch.device(device))
            if dist.get_backend() != want:
                raise ValueError(f"process group has backend {dist.get_backend()}, device {device} needs {want}")
        return True
    found = _sources(init_method, world_size, rank)
    if found is None:
        return False
    init_method, world_size, rank = found
    if world_size is None or rank is None:
        raise ValueError(f"init_method {init_method!r} needs world_size and rank")
    timeout = timeout or TIMEOUT
    dev = _rank_device(device, rank)
    backend = _backend_for(dev)
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size, rank=rank, timeout=timeout, **kwargs
        )
    except (RuntimeError, ValueError) as e:  # DistNetworkError, DistStoreError, timeouts
        raise RuntimeError(
            f"torch.distributed initialization over {init_method} failed although a coordinator was configured "
            f"(rank {rank} of {world_size}): {e}"
        ) from e
    _state.update(device=dev, timeout=timeout)
    logger.info("%s", describe())
    return True


def describe() -> str:
    """One line: backend, rank, world and device of this process."""
    if not dist.is_initialized():
        return "distributed: no process group (one process)"
    return (
        f"distributed: backend {dist.get_backend()}, rank {dist.get_rank()}, world {dist.get_world_size()}, "
        f"device {_state['device']}"
    )


def device() -> torch.device | None:
    """This rank's device once ``initialize`` made a group, else None."""
    return _state["device"] if dist.is_initialized() else None


def group_timeout() -> datetime.timedelta:
    """The timeout of the default group, which ``mesh.make_mesh`` gives
    every group it makes."""
    return _state["timeout"]


def is_primary() -> bool:
    """True on the rank that owns logging, checkpoints and metrics."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_device_count() -> int:
    """CUDA devices of this host (1 on a host without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def global_batch_to_local(global_batch: int, mesh) -> int:
    """Per-rank batch: the global batch split over the mesh's data ranks
    (the ranks of one space group load the same chunks)."""
    if global_batch % mesh.data:
        raise ValueError(f"global batch {global_batch} not divisible by data={mesh.data}")
    return global_batch // mesh.data


def take(v, dim: int, index: int, parts: int):
    """Part ``index`` of ``parts`` equal parts of ``v`` along ``dim``."""
    if v.shape[dim] % parts:
        raise ValueError(f"axis {dim} of shape {tuple(v.shape)} not divisible by {parts}")
    n = v.shape[dim] // parts
    return v[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]


def make_global_batch(mesh, batch: dict, specs: dict | None = None) -> dict:
    """This rank's arrays of a batch the host loaded for its data rank.

    ``specs`` (key -> tuple of axis names, one a dim) says which dims are
    split over the mesh: a dim named ``SPACE_AXIS`` is cut to this rank's
    part; ``DATA_AXIS`` was already cut by the loading. Without ``specs``
    the batch is this rank's as it is."""
    if not specs:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        for dim, axis in enumerate(specs.get(k, (DATA_AXIS,))):
            if axis == SPACE_AXIS:
                v = take(v, dim, mesh.space_rank, mesh.space)
        out[k] = v
    return out


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Destroy the process group (end of a launched command line)."""
    if dist.is_initialized():
        dist.destroy_process_group()
