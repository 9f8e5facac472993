"""UNet over a ResNet-34 encoder (NHWC at every boundary).

Counterpart of ``mvpnet_tpu/models/unet.py``: an encoder-decoder over posed
RGB frames that returns a full-resolution feature map for the 3D fusion and
per-pixel seg logits. Spatial semantics follow flax: 'SAME' padding is
TF-style (asymmetric for even sizes under stride 2), the 3x3/2 max-pool
pads with -inf, and the decoder upsamples bilinearly with half-pixel
centers to each skip's exact size.

``load_torch_resnet34`` (the torchvision weight import) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mvpnet_torch.config import UNetConfig
from mvpnet_torch.models.blocks import (
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


def _resize_to(x_nhwc, hw):
    y = F.interpolate(x_nhwc.permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear", align_corners=False)
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
