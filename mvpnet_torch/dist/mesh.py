"""The (data, space) mesh over ``torch.distributed``.

Counterpart of ``mvpnet_tpu/dist/mesh.py``. JAX lays its devices out as
``reshape(data, space)`` and lets GSPMD emit the collectives; here every
rank is one process with one device, laid out the same way (space fastest:
rank = data_rank * space + space_rank), and the collectives are explicit:

  * ``data`` splits batches of chunks (DDP over ``ddp_group``);
  * ``space`` splits a chunk's views and pixel cloud, or a whole scene's
    windows, over the ranks of one space group (``space_group``): the ring
    kNN of ``dist/fusion.py`` rotates pixel blocks around it.

``bn_group`` (the default group: every rank) carries the global sums:
BatchNorm statistics, the loss's valid count, accuracy and the confusion
matrix. DDP, the global sums and each space ring have groups of their own,
so the three kinds of traffic of one backward pass (DDP's bucketed
all-reduce, BN's backward all-reduce, the ring's backward P2P) can never be
matched in a different order on two ranks.

``make_mesh(local=S)`` builds the loopback mesh: S space shards in one
process on one device, whose ring hop rotates a list. Only the tests and
``chip_smoke.py`` build it (the ring at space > 1 on a one-card machine);
nothing chooses it on its own.

The JAX package's ``ops.set_data_mesh`` has no counterpart: a rank's ops
only ever see its local batch.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, space) mesh and its process groups.

    ``rank`` and ``world`` are the global rank and the number of ranks; the
    groups are None without a process group and on the loopback mesh."""

    data: int
    space: int
    rank: int = 0
    world: int = 1
    ddp_group: object = None
    bn_group: object = None
    space_group: object = None
    space_ranks: tuple = ()  # global ranks of this rank's space group, in ring order
    loopback: bool = False

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, SPACE_AXIS: self.space}

    @property
    def data_rank(self) -> int:
        return self.rank // self.space

    @property
    def space_rank(self) -> int:
        return self.rank % self.space

    @property
    def syncs(self) -> bool:
        """True when ranks in other processes share the batch: global sums
        are all-reduced. False on one rank and on the loopback mesh."""
        return self.world > 1

    @property
    def shards(self) -> range:
        """Space shards this process holds: every one on the loopback mesh,
        else its own."""
        return range(self.space) if self.loopback else range(self.space_rank, self.space_rank + 1)

    def all_sum(self, t: torch.Tensor, *, grad: bool = False) -> torch.Tensor:
        """Sum of ``t`` over every rank (``bn_group``); ``t`` itself when the
        mesh does not sync. With ``grad`` the sum is differentiable: its
        backward all-reduces the gradient."""
        if not self.syncs:
            return t
        if grad:
            return _AllSum.apply(self.bn_group, t)
        out = t.detach().clone()
        dist.all_reduce(out, group=self.bn_group)
        return out

    def world_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean of ``t`` over every rank (no gradient)."""
        return self.all_sum(t) / self.world if self.syncs else t

    def rotate(self, blocks: list, differentiable: bool = False) -> list:
        """One ring hop: ``blocks`` holds a tuple of tensors for each shard of
        ``shards``; afterwards shard s holds what shard s - 1 held. On
        processes this is one batch of P2P sends and receives in the space
        group; with ``differentiable`` its backward sends the gradient one
        hop the other way (``ppermute``'s transpose)."""
        if self.loopback:
            return [blocks[(i - 1) % self.space] for i in range(self.space)]
        (tensors,) = blocks
        if differentiable and any(t.requires_grad for t in tensors):
            return [_RingHop.apply(self, *tensors)]
        return [tuple(self.hop(tensors, 1))]

    def hop(self, tensors, step: int) -> list:
        """Send ``tensors`` ``step`` places along the space ring and receive
        the same shapes from ``step`` places back."""
        ring = self.space_ranks
        dst = ring[(self.space_rank + step) % self.space]
        src = ring[(self.space_rank - step) % self.space]
        sends = [t.contiguous() for t in tensors]
        bufs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, dst, self.space_group) for t in sends]
        ops += [dist.P2POp(dist.irecv, b, src, self.space_group) for b in bufs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return bufs

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Differentiable ``all_to_all_single`` over the space group: part t
        of ``x`` (dim 0, ``space`` equal parts) goes to space rank t, and
        part t of the result came from space rank t."""
        return _AllToAll.apply(self.space_group, x)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Differentiable all-gather over the space group, concatenated along
        ``dim`` in space-rank order; the backward sums the gradient over the
        group and keeps this rank's part."""
        return _AllGather.apply(self, dim, x)

    def gather_space(self, x: torch.Tensor) -> list:
        """Every space rank's ``x`` (same shape), in space-rank order."""
        if self.space == 1:
            return [x]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.space)]
        dist.all_gather(parts, x, group=self.space_group)
        return parts


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


class _RingHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(mesh.hop(tensors, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.mesh.hop(grads, -1))


def _all_to_all(x, group):
    x = x.contiguous()  # (empty_like keeps a view's strides; the op writes dense rows)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, _all_to_all(g, ctx.group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, dim, x):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        return torch.cat(mesh.gather_space(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.space_group)
        return None, None, g.narrow(ctx.dim, ctx.mesh.space_rank * ctx.size, ctx.size)


def make_mesh(cfg=None, *, local: int | None = None) -> Mesh:
    """This rank's mesh for a ``MeshConfig`` (``data=-1``: every rank not
    taken by ``space``), over the process group that
    ``bootstrap.initialize`` made, or one rank without one; ``local=S``: the
    loopback mesh of S space shards in this process.

    Raises ValueError when the mesh does not fit the ranks. Every rank must
    call it (the groups are made collectively)."""
    if local is not None:
        if local < 1:
            raise ValueError(f"loopback mesh needs at least one shard, got {local}")
        return Mesh(data=1, space=local, loopback=True)
    space = cfg.space if cfg else 1
    data = cfg.data if cfg else -1
    active = dist.is_available() and dist.is_initialized()
    n, rank = (dist.get_world_size(), dist.get_rank()) if active else (1, 0)
    launch = "(launch one process a rank under python -m torch.distributed.run)"
    if space < 1 or n % space:
        raise ValueError(f"mesh space={space} needs a multiple of {space} ranks, have {n} {launch}")
    if data == -1:
        data = n // space
    if data * space != n:
        raise ValueError(f"mesh data={data} space={space} needs {data * space} ranks, have {n} {launch}")
    mesh = Mesh(data=data, space=space, rank=rank, world=n)
    if not active:
        return mesh
    from mvpnet_torch.dist import bootstrap

    timeout = bootstrap.group_timeout()
    mesh.bn_group = dist.group.WORLD
    mesh.ddp_group = dist.new_group(list(range(n)), timeout=timeout)
    for d in range(data):  # every rank makes every space group, in one order
        ranks = tuple(d * space + s for s in range(space))
        group = dist.new_group(list(ranks), timeout=timeout)
        if d == mesh.data_rank:
            mesh.space_group, mesh.space_ranks = group, ranks
    return mesh


def install(model, mesh: Mesh):
    """Give the model's BatchNorm layers the mesh (train-mode statistics
    over every rank when it syncs) and its Dropout layers too (each rank
    draws the global batch's mask, the same on every rank, and keeps its
    rows). Returns the model."""
    from mvpnet_torch.models.blocks import BatchNorm, Dropout

    for m in model.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.mesh = mesh
    return model


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's slice of a global host batch: the leading dim split over
    ``data``; arrays whose leading dim does not divide stay whole
    (replicated)."""
    out = {}
    for k, v in batch.items():
        if v.ndim >= 1 and v.shape[0] % mesh.data == 0:
            n = v.shape[0] // mesh.data
            out[k] = v[mesh.data_rank * n : (mesh.data_rank + 1) * n]
        else:
            out[k] = v
    return out
