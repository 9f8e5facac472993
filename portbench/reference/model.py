"""The plain reference of MVPNet3D: UNet-ResNet34, the kNN fusion, PN2SSG.

Frozen from the port's model code (``mvpnet_torch/models/*``) as the
benchmark was written, with its module names and parameter order, so that
one weight set (``portbench.weights``) loads into both. It computes in
float32 with TF32 off, or, for the control, in fp8 (``precision="fp8"``):
every convolution and linear layer then takes its input and its weight
through float8 e4m3 with a per-tensor scale, and its gradients through e5m2
the same way, the step below the configurations' bfloat16. ``precision="bf16"``
rounds them to bfloat16 instead: a witness of what the configurations' own
precision does, with no program in the way.

Semantics kept from the port: channels-last tensors; TF/flax 'SAME'
padding; the 3x3/2 max-pool padded with -inf; bilinear resizes with
half-pixel centers; BatchNorm over all leading dims with the biased batch
variance in train mode and the running statistics in eval mode; the head
dropout's mask drawn as ``torch.rand`` of the global batch's shape from a
generator on the input's device seeded with 0 at the first train-mode call.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import ops

PRECISIONS = ("float32", "bf16", "fp8")


def _scaled_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through ``dtype`` with the per-tensor scale that maps its largest
    magnitude onto the format's largest value; back in float32."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).clamp(-top, top).to(dtype).float()) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _scaled_cast(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _scaled_cast(g, torch.float8_e5m2)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


class Compute:
    """How the reference multiplies: float32; fp8 for the control; bf16, the
    configs' own precision, as a witness of what rounding alone does."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.cast = {"float32": None, "bf16": _Bf16, "fp8": _Fp8}[precision]

    def q(self, x):
        return self.cast.apply(x) if self.cast is not None else x.float()

    def linear(self, lin: nn.Linear, x):
        return F.linear(self.q(x), self.q(lin.weight), None if lin.bias is None else lin.bias.float())

    def conv(self, conv: nn.Conv2d, x_nhwc, stride: int):
        k = conv.weight.shape[-1]
        x = same_pad(self.q(x_nhwc), k, stride).permute(0, 3, 1, 2)
        bias = None if conv.bias is None else conv.bias.float()
        return F.conv2d(x, self.q(conv.weight), bias, stride=stride).permute(0, 2, 3, 1)


def same_pad(x_nhwc, k: int, s: int, value: float = 0.0):
    h, w = x_nhwc.shape[1], x_nhwc.shape[2]
    ph = max((math.ceil(h / s) - 1) * s + k - h, 0)
    pw = max((math.ceil(w / s) - 1) * s + k - w, 0)
    if ph == 0 and pw == 0:
        return x_nhwc
    return F.pad(x_nhwc, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2), value=value)


class BatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.empty(features))
        self.register_buffer("running_var", torch.empty(features))

    def forward(self, x):
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).float()
        if self.training:
            y = F.batch_norm(x2, None, None, self.weight, self.bias, True, 0.0, self.eps)
        else:
            y = F.batch_norm(x2, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
        return y.reshape(shape)


def _linear(c_in, c_out, bias):
    return nn.Linear(c_in, c_out, bias=bias)


def _conv(c_in, c_out, k, bias):
    return nn.Conv2d(c_in, c_out, k, bias=bias)


class SharedMLP(nn.Module):
    def __init__(self, c_in, channels):
        super().__init__()
        layers, norms = [], []
        for c_out in channels:
            layers.append(_linear(c_in, c_out, False))
            norms.append(BatchNorm(c_out))
            c_in = c_out
        self.layers = nn.ModuleList(layers)
        self.norms = nn.ModuleList(norms)
        self.out_channels = c_in

    def forward(self, x, cp: Compute):
        for lin, norm in zip(self.layers, self.norms):
            x = F.relu(norm(cp.linear(lin, x)))
        return x


class ConvBNRelu(nn.Module):
    def __init__(self, c_in, c_out, *, kernel=3, stride=1, use_relu=True):
        super().__init__()
        self.stride = stride
        self.use_relu = use_relu
        self.conv = _conv(c_in, c_out, kernel, False)
        self.norm = BatchNorm(c_out)

    def forward(self, x, cp: Compute):
        x = self.norm(cp.conv(self.conv, x, self.stride))
        return F.relu(x) if self.use_relu else x


class BasicBlock(nn.Module):
    def __init__(self, c_in, c_out, *, stride=1):
        super().__init__()
        self.conv1 = ConvBNRelu(c_in, c_out, stride=stride)
        self.conv2 = ConvBNRelu(c_out, c_out, use_relu=False)
        self.down = ConvBNRelu(c_in, c_out, kernel=1, stride=stride, use_relu=False) if (stride != 1 or c_in != c_out) else None

    def forward(self, x, cp):
        identity = x if self.down is None else self.down(x, cp)
        return F.relu(self.conv2(self.conv1(x, cp), cp) + identity)


class ResNet34Encoder(nn.Module):
    def __init__(self, u: dict):
        super().__init__()
        self.stem = _conv(u["in_channels"], u["base_channels"], 7, False)
        self.stem_norm = BatchNorm(u["base_channels"])
        stages = []
        c_in = u["base_channels"]
        for s, (c_out, blocks) in enumerate(zip(u["stage_channels"], u["stage_blocks"])):
            stage = []
            for b in range(blocks):
                stage.append(BasicBlock(c_in, c_out, stride=2 if (b == 0 and s > 0) else 1))
                c_in = c_out
            stages.append(nn.ModuleList(stage))
        self.stages = nn.ModuleList(stages)

    def forward(self, x, cp):
        x = F.relu(self.stem_norm(cp.conv(self.stem, x, 2)))
        feats = [x]
        x = same_pad(x, 3, 2, value=float("-inf")).permute(0, 3, 1, 2)
        x = F.max_pool2d(x, 3, stride=2).permute(0, 2, 3, 1)
        for stage in self.stages:
            for block in stage:
                x = block(x, cp)
            feats.append(x)
        return feats


def _resize_to(x_nhwc, hw):
    y = F.interpolate(x_nhwc.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class UNetResNet34(nn.Module):
    def __init__(self, u: dict):
        super().__init__()
        self.encoder = ResNet34Encoder(u)
        skip_channels = (u["base_channels"],) + tuple(u["stage_channels"][:-1])
        decoders = []
        c_in = u["stage_channels"][-1]
        for skip_c, dec_c in zip(reversed(skip_channels), u["decoder_channels"]):
            decoders.append(ConvBNRelu(c_in + skip_c, dec_c))
            c_in = dec_c
        self.decoders = nn.ModuleList(decoders)
        self.final = ConvBNRelu(c_in, u["feature_channels"])
        self.seg_head = _conv(u["feature_channels"], u["num_classes"], 1, True)

    def forward(self, images, cp):
        feats = self.encoder(images.float(), cp)
        y = feats[-1]
        for dec, skip in zip(self.decoders, reversed(feats[:-1])):
            y = _resize_to(y, skip.shape[1:3])
            y = dec(torch.cat([y, skip], dim=-1), cp)
        y = _resize_to(y, images.shape[1:3])
        features = self.final(y, cp)
        return features, cp.conv(self.seg_head, features, 1)


class FeatureAggregation(nn.Module):
    def __init__(self, c_in, a: dict):
        super().__init__()
        self.relative = a["use_relative_xyz"]
        self.reduction = a["reduction"]
        self.mlp = SharedMLP(c_in + (3 if self.relative else 0), a["mlp_channels"])
        self.out_channels = self.mlp.out_channels

    def forward(self, points, grouped_xyz, grouped_feat, cp):
        if self.relative:
            grouped_feat = torch.cat([grouped_feat, grouped_xyz - points[:, :, None, :]], dim=-1)
        out = self.mlp(grouped_feat, cp)
        if self.reduction == "max":
            return out.amax(dim=2)
        if self.reduction == "sum":
            return out.sum(dim=2)
        return out.mean(dim=2)


class SetAbstraction(nn.Module):
    def __init__(self, c_in, sa: dict, use_xyz: bool):
        super().__init__()
        self.npoint, self.radius, self.nsample = sa["npoint"], sa["radius"], sa["nsample"]
        self.use_xyz = use_xyz
        self.mlp = SharedMLP(c_in + (3 if use_xyz else 0), sa["mlp_channels"])
        self.out_channels = self.mlp.out_channels

    def forward(self, xyz, features, cp):
        with torch.no_grad():
            new_xyz = ops.gather_points(xyz, ops.farthest_point_sample(xyz, self.npoint))
            group_idx = ops.ball_query(new_xyz, xyz, self.radius, self.nsample)
        local_xyz = ops.group_points(xyz, group_idx) - new_xyz[:, :, None, :]
        if features is not None:
            grouped = ops.group_points(features, group_idx)
            if self.use_xyz:
                grouped = torch.cat([local_xyz, grouped], dim=-1)
        else:
            grouped = local_xyz
        return new_xyz, self.mlp(grouped, cp).amax(dim=2)


class FeaturePropagation(nn.Module):
    def __init__(self, c_in, channels):
        super().__init__()
        self.mlp = SharedMLP(c_in, channels)
        self.out_channels = self.mlp.out_channels

    def forward(self, dense_xyz, sparse_xyz, dense_feat, sparse_feat, cp):
        interp = ops.three_nn_interpolate(dense_xyz, sparse_xyz, sparse_feat)
        if dense_feat is not None:
            interp = torch.cat([interp, dense_feat], dim=-1)
        return self.mlp(interp, cp)


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None or self.generator.device != x.device:
            self.generator = torch.Generator(device=x.device).manual_seed(0)
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class PN2SSG(nn.Module):
    def __init__(self, p: dict):
        super().__init__()
        c_in = p["in_channels"]
        sa_out = [c_in]
        layers = []
        for sa in p["sa"]:
            layer = SetAbstraction(c_in, sa, p["use_xyz"])
            layers.append(layer)
            c_in = layer.out_channels
            sa_out.append(c_in)
        self.sa_layers = nn.ModuleList(layers)
        fps_ = []
        c_sparse = sa_out[-1]
        for i, ch in enumerate(p["fp_channels"]):
            fp = FeaturePropagation(c_sparse + sa_out[-(i + 2)], ch)
            fps_.append(fp)
            c_sparse = fp.out_channels
        self.fp_layers = nn.ModuleList(fps_)
        self.head_mlp = SharedMLP(c_sparse, (p["head_channels"],))
        self.dropout = Dropout(p["dropout"])
        self.head = _linear(p["head_channels"], p["num_classes"], True)

    def forward(self, xyz, features, cp):
        xyz = xyz.float()
        xyzs, feats = [xyz], [features]
        for sa in self.sa_layers:
            xyz, features = sa(xyz, features, cp)
            xyzs.append(xyz)
            feats.append(features)
        sparse = feats[-1]
        for i, fp in enumerate(self.fp_layers):
            sparse = fp(xyzs[-(i + 2)], xyzs[-(i + 1)], feats[-(i + 2)], sparse, cp)
        return cp.linear(self.head, self.dropout(self.head_mlp(sparse, cp)))


class MVPNet3D(nn.Module):
    """batch: points (B,N,3), images (B,V,H,W,3) in [0, 1], image_xyz
    (B,V,H,W,3) -> logits_3d (B,N,C), logits_2d (B,V,H,W,C), float32."""

    def __init__(self, model_cfg: dict, precision: str = "float32"):
        super().__init__()
        self.cp = Compute(precision)
        self.k = model_cfg["aggregation"]["k"]
        self.net_2d = UNetResNet34(model_cfg["unet"])
        self.aggregation = FeatureAggregation(model_cfg["unet"]["feature_channels"], model_cfg["aggregation"])
        self.net_3d = PN2SSG(model_cfg["pn2"])

    def forward(self, batch):
        points, images, image_xyz = batch["points"].float(), batch["images"], batch["image_xyz"].float()
        B, V, H, W, _ = images.shape
        feat2d, logits_2d = self.net_2d(images.reshape(B * V, H, W, 3), self.cp)
        pixel_feat = feat2d.reshape(B, V * H * W, feat2d.shape[-1])
        pixel_xyz = image_xyz.reshape(B, V * H * W, 3)
        with torch.no_grad():
            _, idx = ops.knn(points, pixel_xyz, self.k)
        fused = self.aggregation(points, ops.group_points(pixel_xyz, idx), ops.group_points(pixel_feat, idx), self.cp)
        return self.net_3d(points, fused, self.cp), logits_2d.reshape(B, V, H, W, -1)


def build(model_cfg: dict, device, precision: str = "float32") -> MVPNet3D:
    """The reference model with uninitialized weights on ``device``; load
    ``portbench.weights.make`` into it."""
    with torch.device("meta"):
        model = MVPNet3D(model_cfg, precision)
    return model.to_empty(device=device)


def cross_entropy(logits, labels, ignore_label: int):
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    losses = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]), safe.reshape(-1), reduction="none")
    losses = torch.where(valid.reshape(-1), losses, 0.0)
    return losses.sum() / valid.sum().clamp(min=1)


def loss(out, batch, model_cfg: dict, ignore_label: int):
    """3D cross-entropy plus ``aux_2d_loss_weight`` times the 2D one."""
    value = cross_entropy(out[0], batch["seg_label"], ignore_label)
    aux = model_cfg["aux_2d_loss_weight"]
    if aux > 0:
        value = value + aux * cross_entropy(out[1], batch["seg_label_2d"], ignore_label)
    return value
