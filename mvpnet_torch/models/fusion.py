"""2D-3D fusion: FeatureAggregation + MVPNet3D.

Counterpart of ``mvpnet_tpu/models/fusion.py``:

  images (B,V,H,W,3) -> UNet features (B*V,H,W,C2d) -> pixel feature cloud
  (B, V*H*W, C2d) at the unprojected positions image_xyz -> for each chunk
  point, its k=3 nearest pixels (the fusion kNN, a CUDA kernel on the card)
  -> SharedMLP over concat(feature, relative xyz) -> max over k -> PN2SSG.

Invalid pixels sit at the 1e6 sentinel from ``unproject_views``, so masking
is positional. ``remat_2d`` (set by ``models.build`` from
``cfg.train.remat``) recomputes the 2D net in the backward pass through
``torch.utils.checkpoint`` instead of storing its activations.
``fusion_mesh`` (set by ``dist.train_sp.install_space_fusion``) routes the
fusion kNN through the space group's ring (``sharded_fusion_gather``) and
re-splits the 3D net's batch to whole chunks (``dist.train_sp.resplit``);
the 3D logits are then this rank's ``local_share`` of the chunks.
The forward's spans (``tracing``): ``model.net_2d``, ``model.fusion_knn``,
``model.aggregation``, ``model.net_3d``.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mvpnet_torch import ops, tracing
from mvpnet_torch.config import AggregationConfig, ModelConfig
from mvpnet_torch.models.blocks import BatchNorm, SharedMLP
from mvpnet_torch.models.pointnet2 import PN2SSG
from mvpnet_torch.models.unet import UNetResNet34


class FeatureAggregation(nn.Module):
    """Fuse K gathered multi-view pixel features into one per-point feature."""

    def __init__(self, in_channels: int, cfg: AggregationConfig, *, norm="batch", dtype=torch.float32, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        c_in = in_channels + (3 if cfg.use_relative_xyz else 0)
        self.mlp = SharedMLP(c_in, cfg.mlp_channels, norm=norm, dtype=dtype, gen=gen)
        self.out_channels = self.mlp.out_channels

    def forward(self, points, grouped_xyz, grouped_feat):
        """points (B,N,3); grouped_xyz (B,N,K,3); grouped_feat (B,N,K,C)
        -> fused per-point features (B, N, C')."""
        if self.cfg.use_relative_xyz:
            rel = grouped_xyz - points[:, :, None, :]
            grouped_feat = torch.cat([grouped_feat, rel.to(grouped_feat.dtype)], dim=-1)
        out = self.mlp(grouped_feat)  # (B, N, K, C')
        if self.cfg.reduction == "max":
            return out.amax(dim=2)
        if self.cfg.reduction == "sum":
            return out.sum(dim=2)
        if self.cfg.reduction == "mean":
            return out.mean(dim=2)
        raise ValueError(f"unknown reduction {self.cfg.reduction!r}")


class MVPNet3D(nn.Module):
    """End-to-end 2D-3D fusion network for 3D semantic segmentation."""

    def __init__(self, cfg: ModelConfig, *, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.net_2d = UNetResNet34(cfg.unet, gen=gen)
        self.aggregation = FeatureAggregation(
            cfg.unet.feature_channels, cfg.aggregation, norm=cfg.pn2.norm, dtype=cfg.pn2.dtype, gen=gen
        )
        if cfg.pn2.in_channels != self.aggregation.out_channels:
            raise ValueError(
                "pn2.in_channels must equal the aggregation output "
                f"({cfg.pn2.in_channels} != {self.aggregation.out_channels})"
            )
        self.net_3d = PN2SSG(cfg.pn2, gen=gen)
        self.remat_2d = False
        self.fusion_mesh = None

    def _net_2d(self, x):
        if not (self.remat_2d and self.training and torch.is_grad_enabled()):
            return self.net_2d(x)
        # the backward pass runs the 2D net a second time: that run must not
        # move the BN running statistics again (flax's remat recomputes
        # without touching state)
        calls = []

        def run(images):
            keep = contextlib.nullcontext() if not calls else _frozen_running_stats(self.net_2d)
            calls.append(1)
            with keep:
                return self.net_2d(images)

        return checkpoint(run, x, use_reentrant=False)

    def forward(self, batch):
        """batch: points (B,N,3), images (B,V,H,W,3) in [0, 1], image_xyz
        (B,V,H,W,3) with invalid pixels at the sentinel.

        Returns logits_3d (B, N, num_classes) f32 and logits_2d
        (B, V, H, W, num_classes) f32."""
        points = batch["points"]
        images = batch["images"]
        image_xyz = batch["image_xyz"]
        B, V, H, W, _ = images.shape

        with tracing.span("model.net_2d"):
            feat2d, logits_2d = self._net_2d(images.reshape(B * V, H, W, 3))
        pixel_feat = feat2d.reshape(B, V * H * W, feat2d.shape[-1])
        pixel_xyz = image_xyz.reshape(B, V * H * W, 3)

        mesh = self.fusion_mesh
        if mesh is not None and mesh.space > 1:
            logits_3d = self._sharded_3d(mesh, points, pixel_xyz, pixel_feat)
        else:
            with tracing.span("model.fusion_knn"):
                _, knn_idx = ops.knn(points, pixel_xyz, self.cfg.aggregation.k)
                grouped_feat = ops.group_points(pixel_feat, knn_idx)  # (B,N,K,C2d)
                grouped_xyz = ops.group_points(pixel_xyz, knn_idx)  # (B,N,K,3)
            with tracing.span("model.aggregation"):
                fused = self.aggregation(points, grouped_xyz, grouped_feat)
            with tracing.span("model.net_3d"):
                logits_3d = self.net_3d(points, fused)
        return logits_3d, logits_2d.reshape(B, V, H, W, -1)

    def _sharded_3d(self, mesh, points, pixel_xyz, pixel_feat):
        """Space-sharded fusion and 3D net: this rank's N/S points of each
        chunk fuse over the ring, then the 3D net runs on whole chunks;
        returns the logits of this rank's ``local_share``."""
        from mvpnet_torch.dist import train_sp

        with tracing.span("model.fusion_knn"):
            grouped_xyz, grouped_feat = train_sp.sharded_fusion_gather(
                mesh, points, pixel_xyz, pixel_feat, self.cfg.aggregation.k
            )
        with tracing.span("model.aggregation"):
            fused = self.aggregation(train_sp.point_slice(mesh, points), grouped_xyz, grouped_feat)
        with tracing.span("model.net_3d"):
            pts_3d, fused_3d = train_sp.resplit(mesh, points, fused)
            logits_3d = self.net_3d(pts_3d, fused_3d, rows=train_sp.local_rows(mesh, points.shape[0]))
        if points.shape[0] % mesh.space:  # every chunk ran here: keep this rank's points
            logits_3d = train_sp.point_slice(mesh, logits_3d)
        return logits_3d


@contextlib.contextmanager
def _frozen_running_stats(module: nn.Module):
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.track_running_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.track_running_stats = True
