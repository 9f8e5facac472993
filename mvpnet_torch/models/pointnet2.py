"""PointNet++ SSG segmentation network (channels-last).

Counterpart of ``mvpnet_tpu/models/pointnet2.py``:

  SA x4:  FPS -> ball query -> group -> SharedMLP -> max-pool
  FP x4:  three-NN inverse-distance interpolation -> skip concat -> SharedMLP
  head:   per-point MLP -> dropout (identity in eval; in train mode it draws
          from an explicit torch.Generator) -> linear

FPS, ball query and the three-NN search come from ``mvpnet_torch.ops``: CUDA
kernels on the card, the plain versions on the CPU.
"""
from __future__ import annotations

import torch
from torch import nn

from mvpnet_torch import ops
from mvpnet_torch.config import PN2SSGConfig
from mvpnet_torch.models.blocks import Dropout, SharedMLP, linear, make_linear, torch_dtype


def gather_points(xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows picked by (B, M) int32 indices -> (B, M, C)."""
    return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, xyz.shape[-1]))


class SetAbstraction(nn.Module):
    """FPS -> ball query -> grouping -> per-group SharedMLP -> max-pool."""

    def __init__(self, in_channels, npoint, radius, nsample, mlp_channels, *, use_xyz=True, norm="batch", dtype=torch.float32, gen: torch.Generator):
        super().__init__()
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.use_xyz = use_xyz
        c_in = in_channels + (3 if use_xyz else 0)
        self.mlp = SharedMLP(c_in, mlp_channels, norm=norm, dtype=dtype, gen=gen)
        self.out_channels = self.mlp.out_channels

    def forward(self, xyz, features, valid_mask=None):
        """xyz (B, N, 3); features (B, N, C) or None; valid_mask optional
        (B, N) bool. Returns (new_xyz (B, M, 3), new_features (B, M, C'))."""
        centroid_idx = ops.farthest_point_sample(xyz, self.npoint, valid_mask=valid_mask)
        new_xyz = gather_points(xyz, centroid_idx)
        group_idx, _ = ops.ball_query(new_xyz, xyz, self.radius, self.nsample, valid_mask=valid_mask)
        local_xyz = ops.group_points(xyz, group_idx) - new_xyz[:, :, None, :]
        if features is not None:
            grouped = ops.group_points(features, group_idx)  # (B, M, K, C)
            if self.use_xyz:
                grouped = torch.cat([local_xyz.to(grouped.dtype), grouped], dim=-1)
        else:
            grouped = local_xyz
        return new_xyz, self.mlp(grouped).amax(dim=2)


class FeaturePropagation(nn.Module):
    """three-NN interpolate sparse features up to dense points + skip MLP."""

    def __init__(self, in_channels, mlp_channels, *, norm="batch", dtype=torch.float32, gen: torch.Generator):
        super().__init__()
        self.mlp = SharedMLP(in_channels, mlp_channels, norm=norm, dtype=dtype, gen=gen)
        self.out_channels = self.mlp.out_channels

    def forward(self, dense_xyz, sparse_xyz, dense_feat, sparse_feat):
        interp = ops.three_nn_interpolate(dense_xyz, sparse_xyz, sparse_feat)
        if dense_feat is not None:
            interp = torch.cat([interp, dense_feat.to(interp.dtype)], dim=-1)
        return self.mlp(interp)


class PN2SSG(nn.Module):
    """Full PointNet++ SSG segmentation net over (B, N, 3) (+ features)."""

    def __init__(self, cfg: PN2SSGConfig, *, gen: torch.Generator):
        super().__init__()
        dtype = torch_dtype(cfg.dtype)
        self.cfg = cfg
        self.dtype = dtype
        sa_layers = []
        c_in = cfg.in_channels
        sa_out = [c_in]
        for sa_cfg in cfg.sa:
            sa = SetAbstraction(
                c_in, sa_cfg.npoint, sa_cfg.radius, sa_cfg.nsample, sa_cfg.mlp_channels,
                use_xyz=cfg.use_xyz, norm=cfg.norm, dtype=dtype, gen=gen,
            )
            sa_layers.append(sa)
            c_in = sa.out_channels
            sa_out.append(c_in)
        self.sa_layers = nn.ModuleList(sa_layers)

        # FP goes coarsest -> finest: fp[i] fuses sa_out[-(i+1)] (interp)
        # with the skip sa_out[-(i+2)]
        fp_layers = []
        c_sparse = sa_out[-1]
        for i, fp_channels in enumerate(cfg.fp_channels):
            fp = FeaturePropagation(c_sparse + sa_out[-(i + 2)], fp_channels, norm=cfg.norm, dtype=dtype, gen=gen)
            fp_layers.append(fp)
            c_sparse = fp.out_channels
        self.fp_layers = nn.ModuleList(fp_layers)

        self.head_mlp = SharedMLP(c_sparse, (cfg.head_channels,), norm=cfg.norm, dtype=dtype, gen=gen)
        self.dropout = Dropout(cfg.dropout)
        # flax's default Linear init: lecun_normal (scale 1), zero bias
        self.head = make_linear(cfg.head_channels, cfg.num_classes, bias=True, gen=gen, scale=1.0)

    def forward(self, xyz, features=None, valid_mask=None, rows=None):
        """xyz (B, N, 3); features (B, N, C_in) or None; valid_mask optional
        (B, N) bool for padded inputs, used at SA level 0 only (masked FPS
        selects only valid centroids, so coarser levels are all valid);
        rows: the head dropout's place of these B chunks in the global
        batch (``Dropout``). Returns per-point logits (B, N, num_classes)
        f32."""
        xyz = xyz.float()
        if features is not None:
            features = features.to(self.dtype)
        xyzs, feats = [xyz], [features]
        for i, sa in enumerate(self.sa_layers):
            xyz, features = sa(xyz, features, valid_mask if i == 0 else None)
            xyzs.append(xyz)
            feats.append(features)
        sparse_feat = feats[-1]
        for i, fp in enumerate(self.fp_layers):
            sparse_feat = fp(xyzs[-(i + 2)], xyzs[-(i + 1)], feats[-(i + 2)], sparse_feat)
        out = self.dropout(self.head_mlp(sparse_feat), rows=rows)
        return linear(self.head, out, self.dtype).float()
