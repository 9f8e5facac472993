"""UNet over a ResNet-34 encoder (NHWC at every boundary).

Counterpart of ``mvpnet_tpu/models/unet.py``: an encoder-decoder over posed
RGB frames that returns a full-resolution feature map for the 3D fusion and
per-pixel seg logits. Spatial semantics follow flax: 'SAME' padding is
TF-style (asymmetric for even sizes under stride 2), the 3x3/2 max-pool
pads with -inf, and the decoder upsamples bilinearly with half-pixel
centers to each skip's exact size.

``load_torch_resnet34`` imports torchvision ``resnet34`` weights into the
encoder.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvpnet_torch.config import UNetConfig
from mvpnet_torch.models.blocks import (
    BatchNorm,
    ConvBNRelu,
    apply_norm,
    conv2d_same,
    make_conv,
    make_norm,
    same_pad,
    torch_dtype,
)


class BasicBlock(nn.Module):
    """ResNet v1 BasicBlock: two 3x3 convs + identity/projection shortcut."""

    def __init__(self, c_in, c_out, *, stride=1, norm="batch", dtype=torch.float32, gen: torch.Generator):
        super().__init__()
        self.conv1 = ConvBNRelu(c_in, c_out, stride=stride, norm=norm, dtype=dtype, gen=gen)
        self.conv2 = ConvBNRelu(c_out, c_out, norm=norm, use_relu=False, dtype=dtype, gen=gen)
        if stride != 1 or c_in != c_out:
            self.down = ConvBNRelu(c_in, c_out, kernel=1, stride=stride, norm=norm, use_relu=False, dtype=dtype, gen=gen)
        else:
            self.down = None

    def forward(self, x):
        identity = x if self.down is None else self.down(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class ResNet34Encoder(nn.Module):
    """Stages of BasicBlocks: (3, 4, 6, 3) x channels (64, 128, 256, 512)."""

    def __init__(self, cfg: UNetConfig, *, dtype, gen: torch.Generator):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        self.stem = make_conv(cfg.in_channels, cfg.base_channels, 7, bias=False, gen=gen)
        self.stem_norm = make_norm(cfg.norm, cfg.base_channels)
        stages = []
        c_in = cfg.base_channels
        for stage_idx, (c_out, blocks) in enumerate(zip(cfg.stage_channels, cfg.stage_blocks)):
            stage = []
            for b in range(blocks):
                stride = 2 if (b == 0 and stage_idx > 0) else 1
                stage.append(BasicBlock(c_in, c_out, stride=stride, norm=cfg.norm, dtype=dtype, gen=gen))
                c_in = c_out
            stages.append(nn.ModuleList(stage))
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        """Returns [stem_out, stage1, stage2, stage3, stage4] (coarsening)."""
        x = F.relu(apply_norm(self.stem_norm, conv2d_same(self.stem, x, 2, self.dtype)))
        feats = [x]
        x = same_pad(x, 3, 2, value=float("-inf")).permute(0, 3, 1, 2)
        x = F.max_pool2d(x, 3, stride=2).permute(0, 2, 3, 1)
        for stage in self.stages:
            for block in stage:
                x = block(x)
            feats.append(x)
        return feats


def load_torch_resnet34(encoder: ResNet34Encoder, state_dict) -> list[str]:
    """Import torchvision ``resnet34`` weights into the encoder, in place.

    ``state_dict`` maps torchvision's key names to tensors or numpy arrays
    (a ``torch.load``-ed .pth state_dict, or an .npz with the same keys):

      conv1/layerL.B.convN weights: OIHW, the port's layout, copied as they are;
      bn weight/bias/running_mean/running_var -> the same names;
      layerL.B.downsample.{0,1} -> stages[L-1][B].down.{conv,norm}.

    Head keys (fc.*) and num_batches_tracked are ignored. Returns the list
    of consumed keys; raises KeyError on a missing expected key, and
    ValueError on a shape mismatch, on an encoder whose norm is not
    BatchNorm, and on unconsumed non-head keys, as
    ``mvpnet_tpu/models/unet.py::load_torch_resnet34`` does: a partial or
    differently-shaped checkpoint fails loudly instead of loading silently
    wrong."""
    used: list[str] = []

    def arr(name):
        if name not in state_dict:
            raise KeyError(f"torch resnet34 state_dict missing key {name!r}")
        used.append(name)
        return torch.as_tensor(state_dict[name])

    def put(slot: torch.Tensor, name: str):
        v = arr(name)
        if tuple(slot.shape) != tuple(v.shape):
            raise ValueError(f"{name}: shape {tuple(v.shape)} != encoder {tuple(slot.shape)}")
        with torch.no_grad():
            slot.copy_(v.to(slot.dtype))

    def set_bn(norm, prefix):
        if not isinstance(norm, BatchNorm):
            raise ValueError(
                f"{prefix}: torchvision weights carry BatchNorm stats but the "
                f"encoder was built with norm={type(norm).__name__}"
            )
        for key in ("weight", "bias", "running_mean", "running_var"):
            put(getattr(norm, key), f"{prefix}.{key}")

    put(encoder.stem.weight, "conv1.weight")
    set_bn(encoder.stem_norm, "bn1")
    for s, stage in enumerate(encoder.stages):
        for b, block in enumerate(stage):
            p = f"layer{s + 1}.{b}"
            put(block.conv1.conv.weight, f"{p}.conv1.weight")
            set_bn(block.conv1.norm, f"{p}.bn1")
            put(block.conv2.conv.weight, f"{p}.conv2.weight")
            set_bn(block.conv2.norm, f"{p}.bn2")
            if block.down is not None:
                put(block.down.conv.weight, f"{p}.downsample.0.weight")
                set_bn(block.down.norm, f"{p}.downsample.1")
    # a structurally mismatched checkpoint (downsample weights where the
    # encoder has none) must not load with weights silently dropped
    leftover = [
        k for k in state_dict
        if k not in used and not k.startswith("fc.") and not k.endswith("num_batches_tracked")
    ]
    if leftover:
        raise ValueError(
            f"torch resnet34 state_dict has {len(leftover)} unconsumed "
            f"non-head keys (encoder structure mismatch): {leftover[:8]}..."
        )
    return used


def load_torch_resnet34_file(encoder: ResNet34Encoder, path: str) -> list[str]:
    """``load_torch_resnet34`` from a .pth (``torch.load``, weights only) or
    an .npz file."""
    if path.endswith(".npz"):
        import numpy as np

        with np.load(path) as f:
            return load_torch_resnet34(encoder, dict(f))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return load_torch_resnet34(encoder, sd)


def interp_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) f32 weights of 1-D linear resizing with half-pixel
    centers, as ``F.interpolate(mode="bilinear", align_corners=False)``
    computes them for an output size: source = (dst + 0.5) n_in / n_out -
    0.5, clamped at 0, split between its floor and the next index (the last
    index alone at the edge)."""
    dst = torch.arange(n_out, device=device, dtype=torch.float32)
    src = ((dst + 0.5) * (n_in / n_out) - 0.5).clamp_min(0.0)
    i0 = src.long()
    i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
    w1 = (src - i0)[:, None]
    cols = torch.arange(n_in, device=device)
    return torch.where(cols == i0[:, None], 1.0 - w1, 0.0) + torch.where(cols == i1[:, None], w1, 0.0)


class BilinearResize(torch.autograd.Function):
    """``F.interpolate(x, size, mode="bilinear", align_corners=False)`` on an
    NCHW tensor with a backward that sums in a fixed order: the separable
    product A_h^T g A_w of the two interpolation matrices
    (``interp_matrix``), in f32. CUDA's own backward of the resize adds
    with atomics, which the deterministic mode refuses; the forward is the
    same call in both modes."""

    @staticmethod
    def forward(ctx, x, size):
        ctx.in_hw, ctx.dtype = x.shape[2:], x.dtype
        return F.interpolate(x, size=size, mode="bilinear", align_corners=False)

    @staticmethod
    def backward(ctx, g):
        a_h = interp_matrix(ctx.in_hw[0], g.shape[2], g.device)
        a_w = interp_matrix(ctx.in_hw[1], g.shape[3], g.device)
        return (a_h.t() @ (g.float() @ a_w)).to(ctx.dtype), None


def _resize_to(x_nhwc, hw):
    x = x_nhwc.permute(0, 3, 1, 2)
    if torch.are_deterministic_algorithms_enabled():
        y = BilinearResize.apply(x, tuple(hw))
    else:
        y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


class UNetResNet34(nn.Module):
    """Encoder-decoder producing (features, logits), both at input resolution."""

    def __init__(self, cfg: UNetConfig, *, gen: torch.Generator):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = ResNet34Encoder(cfg, dtype=dtype, gen=gen)
        skip_channels = (cfg.base_channels,) + tuple(cfg.stage_channels[:-1])
        decoders = []
        c_in = cfg.stage_channels[-1]
        for skip_c, dec_c in zip(reversed(skip_channels), cfg.decoder_channels):
            decoders.append(ConvBNRelu(c_in + skip_c, dec_c, norm=cfg.norm, dtype=dtype, gen=gen))
            c_in = dec_c
        self.decoders = nn.ModuleList(decoders)
        self.final = ConvBNRelu(c_in, cfg.feature_channels, norm=cfg.norm, dtype=dtype, gen=gen)
        # flax's default init for the head: lecun_normal (scale 1), zero bias
        self.seg_head = make_conv(cfg.feature_channels, cfg.num_classes, 1, bias=True, gen=gen, scale=1.0)

    def forward(self, images):
        """images (B, H, W, 3) in [0, 1] -> features (B, H, W, C_feat) in
        the compute dtype, logits (B, H, W, num_classes) f32."""
        feats = self.encoder(images.to(self.dtype))
        skips = feats[:-1]  # stem, s1, s2, s3
        y = feats[-1]
        for dec, skip in zip(self.decoders, reversed(skips)):
            y = _resize_to(y, skip.shape[1:3])
            y = dec(torch.cat([y, skip], dim=-1))
        y = _resize_to(y, images.shape[1:3])
        features = self.final(y)
        logits = conv2d_same(self.seg_head, features, 1, self.dtype).float()
        return features, logits
