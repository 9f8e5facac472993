"""NN building blocks: SharedMLP, ConvBNRelu, norm helpers.

Counterpart of ``mvpnet_tpu/models/blocks.py``. Tensors stay channels-last
at every block boundary, as in the JAX package: a 1x1 "conv" over points is
a Linear over the trailing dim, and a 2D conv reads an (N, H, W, C) tensor
through a channels-last NCHW view (no copy). Parameters are f32; each block
casts its weights to the compute dtype at use (``dtype``, bf16 by default in
the configs). Normalization runs in f32 and returns the compute dtype.

BatchNorm follows flax's ``nnx.BatchNorm`` (momentum 0.9, eps 1e-5): in
train mode it normalizes with the batch statistics (biased variance, in f32,
over all leading dims) and moves its running statistics by
``ra = 0.9 * ra + 0.1 * stat``, with the biased variance too. Given a
mesh that syncs (``dist.mesh.install``), its train-mode statistics are
global: it all-reduces the per-channel sum, sum of squares and count over
every rank, with a gradient through them, and normalizes with flax's mean
and E[x^2] - E[x]^2; without one it runs ``F.batch_norm`` as before.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """Config dtype name ("bfloat16", ...) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def variance_scaling_(weight: torch.Tensor, fan_in: int, scale: float, gen: torch.Generator) -> None:
    """Truncated-normal init of flax's ``variance_scaling(scale, "fan_in",
    "truncated_normal")``: kaiming_normal is scale 2, lecun_normal scale 1."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def make_linear(c_in: int, c_out: int, *, bias: bool, gen: torch.Generator, scale: float = 2.0) -> nn.Linear:
    lin = nn.utils.skip_init(nn.Linear, c_in, c_out, bias=bias)
    variance_scaling_(lin.weight, c_in, scale, gen)
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


def make_conv(c_in: int, c_out: int, kernel: int, *, bias: bool, gen: torch.Generator, scale: float = 2.0) -> nn.Conv2d:
    conv = nn.utils.skip_init(nn.Conv2d, c_in, c_out, kernel, bias=bias)
    variance_scaling_(conv.weight, c_in * kernel * kernel, scale, gen)
    if bias:
        with torch.no_grad():
            conv.bias.zero_()
    return conv


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def same_pad(x_nhwc: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """TF/flax 'SAME' padding of an NHWC tensor (asymmetric for even sizes)."""
    h, w = x_nhwc.shape[1], x_nhwc.shape[2]
    ph = max((math.ceil(h / s) - 1) * s + k - h, 0)
    pw = max((math.ceil(w / s) - 1) * s + k - w, 0)
    if ph == 0 and pw == 0:
        return x_nhwc
    return F.pad(x_nhwc, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=value)


def conv2d_same(conv: nn.Conv2d, x_nhwc: torch.Tensor, stride: int, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nnx.Conv(padding="SAME")`` on an NHWC tensor, in ``dtype``."""
    k = conv.weight.shape[-1]
    x = same_pad(x_nhwc.to(dtype), k, stride).permute(0, 3, 1, 2)
    bias = None if conv.bias is None else conv.bias.to(dtype)
    y = F.conv2d(x, conv.weight.to(dtype), bias, stride=stride)
    return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel of any (..., C) tensor, pooling
    over all leading dims (flax ``nnx.BatchNorm`` on channels-last).

    ``track_running_stats = False`` keeps the running statistics as they are
    in train mode (the recomputed forward of a rematerialized 2D net,
    ``models/fusion.py``). ``mesh`` (``dist.mesh.install``): train-mode
    statistics over every rank when it syncs."""

    momentum = 0.9  # flax's: ra = momentum * ra + (1 - momentum) * stat

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.track_running_stats = True
        self.mesh = None
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).float()
        if self.training and self.mesh is not None and self.mesh.syncs:
            y = self._global_batch_norm(x2)
        elif self.training:
            # normalize with the biased batch variance (F.batch_norm does);
            # its running update would take the unbiased one, so the update
            # is computed here
            y = F.batch_norm(x2, None, None, self.weight, self.bias, True, 0.0, self.eps)
            if self.track_running_stats:
                with torch.no_grad():
                    var, mean = torch.var_mean(x2, dim=0, correction=0)
                    self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                    self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            y = F.batch_norm(x2, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        return y.reshape(shape).to(x.dtype)

    def _global_batch_norm(self, x2: torch.Tensor) -> torch.Tensor:
        """Train-mode BN over the global batch: one all-reduce of [sum,
        sum of squares, count], differentiable in the sums."""
        c = x2.shape[1]
        count = torch.full((1,), float(x2.shape[0]), device=x2.device)
        stats = self.mesh.all_sum(torch.cat([x2.sum(0), (x2 * x2).sum(0), count]), grad=True)
        n = stats[2 * c].detach()
        mean = stats[:c] / n
        var = (stats[c : 2 * c] / n - mean * mean).clamp_min(0.0)
        if self.track_running_stats:
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        return (x2 - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class GroupNorm(nn.Module):
    """flax ``nnx.GroupNorm`` on a channels-last tensor: per sample, over all
    non-batch dims within each of min(32, C) channel groups; eps 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.groups = min(32, features)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.movedim(-1, 1).float(), self.groups, self.weight, self.bias, self.eps)
        return y.movedim(1, -1).to(x.dtype)


class Dropout(nn.Module):
    """flax ``nnx.Dropout``: in train mode keep each value with probability
    1 - rate and scale kept values by 1 / (1 - rate). The mask draws from an
    explicit ``torch.Generator`` (``generator``, on the input's device),
    seeded with 0 at the first train-mode call; setting it to None starts
    the masks again.

    On a mesh (``dist.mesh.install``) every rank draws the mask of the
    global batch from the same generator and keeps the rows it holds, so a
    sharded step drops what the one-process step on that batch drops, and
    the ranks' generators stay in step. ``rows=(first, total)`` says that
    ``x`` holds rows [first, first + len(x)) of a global batch of ``total``
    rows; by default they are this data rank's slice (``shard_batch``), or
    the whole batch without a mesh."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.mesh = None
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor, rows: tuple[int, int] | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None or self.generator.device != x.device:
            self.generator = torch.Generator(device=x.device).manual_seed(0)
        n = x.shape[0]
        if rows is None:
            rows = (0, n) if self.mesh is None else (self.mesh.data_rank * n, self.mesh.data * n)
        first, total = rows
        keep_prob = 1.0 - self.rate
        draw = torch.rand((total, *x.shape[1:]), generator=self.generator, device=x.device)
        keep = draw[first : first + n] < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def make_norm(norm: str, features: int) -> nn.Module:
    if norm == "batch":
        return BatchNorm(features)
    if norm == "group":
        return GroupNorm(features)
    if norm == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {norm!r}")


def apply_norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a norm layer to a (..., C) tensor (kept for the JAX API's shape)."""
    return norm(x)


class SharedMLP(nn.Module):
    """Per-point MLP: Linear -> norm -> ReLU stacks over the trailing dim."""

    def __init__(
        self,
        in_channels: int,
        channels: Sequence[int],
        *,
        norm: str = "batch",
        dtype=torch.float32,
        gen: torch.Generator,
    ):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        layers, norms = [], []
        c_in = in_channels
        for c_out in channels:
            layers.append(make_linear(c_in, c_out, bias=(norm == "none"), gen=gen))
            norms.append(make_norm(norm, c_out))
            c_in = c_out
        self.layers = nn.ModuleList(layers)
        self.norms = nn.ModuleList(norms)
        self.out_channels = c_in

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for lin, norm in zip(self.layers, self.norms):
            x = F.relu(apply_norm(norm, linear(lin, x, self.dtype)))
        return x


class ConvBNRelu(nn.Module):
    """k x k conv ('SAME') -> norm -> optional ReLU on NHWC tensors."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        *,
        kernel: int = 3,
        stride: int = 1,
        norm: str = "batch",
        use_relu: bool = True,
        dtype=torch.float32,
        gen: torch.Generator,
    ):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.stride = stride
        self.use_relu = use_relu
        self.conv = make_conv(in_channels, out_channels, kernel, bias=False, gen=gen)
        self.norm = make_norm(norm, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.norm, conv2d_same(self.conv, x, self.stride, self.dtype))
        return F.relu(x) if self.use_relu else x
