"""Operations and bytes that the MFU and roofline metrics divide by.

Computed from a configuration's shapes and the inputs alone, never from the
program's tiles, gates, Morton boxes or routing, so they read the same work
whatever implements a function. Peaks are NVIDIA's published figures for one
H100 SXM at its 700 W limit (dense, no sparsity).

Model FLOPs count the convolutions and linear layers at their shapes, 2 per
multiply-add; a training step counts 3x the forward (forward and backward),
recomputation not counted.

A kernel's least possible time is the larger of its bytes over the HBM peak
and its FLOPs over the float32 peak, where the bytes read every input once
and write every output once, and the FLOPs are only such arithmetic as no
exact method can skip: the squared distances of the answers a search
returns (3 subtractions, 3 multiplications, 2 additions each). Farthest
point sampling counts no arithmetic: a pruned method can skip updates.
"""
from __future__ import annotations

import math

BF16_DENSE_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
DISTANCE_FLOPS = 8


def _same(n: int, stride: int) -> int:
    return math.ceil(n / stride)


def unet_flops(unet: dict, height: int, width: int) -> float:
    """Forward FLOPs of the UNet over one view."""
    total = 0.0

    def conv(k, c_in, c_out, h, w):
        nonlocal total
        total += 2.0 * k * k * c_in * c_out * h * w

    h, w = _same(height, 2), _same(width, 2)
    conv(7, unet["in_channels"], unet["base_channels"], h, w)
    res = [(h, w)]
    h, w = _same(h, 2), _same(w, 2)  # max-pool
    c_in = unet["base_channels"]
    for s, (c_out, blocks) in enumerate(zip(unet["stage_channels"], unet["stage_blocks"])):
        for b in range(blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            h, w = _same(h, stride), _same(w, stride)
            conv(3, c_in, c_out, h, w)
            conv(3, c_out, c_out, h, w)
            if stride != 1 or c_in != c_out:
                conv(1, c_in, c_out, h, w)
            c_in = c_out
        res.append((h, w))
    skips = (unet["base_channels"],) + tuple(unet["stage_channels"][:-1])
    c_in = unet["stage_channels"][-1]
    for (sh, sw), skip_c, dec_c in zip(reversed(res[:-1]), reversed(skips), unet["decoder_channels"]):
        conv(3, c_in + skip_c, dec_c, sh, sw)
        c_in = dec_c
    conv(3, c_in, unet["feature_channels"], height, width)
    conv(1, unet["feature_channels"], unet["num_classes"], height, width)
    return total


def _mlp(rows: float, c_in: int, channels) -> float:
    total = 0.0
    for c_out in channels:
        total += 2.0 * rows * c_in * c_out
        c_in = c_out
    return total


def net3d_flops(model: dict, n_points: int) -> float:
    """Forward FLOPs of the fusion MLP and PN2SSG over one chunk."""
    agg, pn2, unet = model["aggregation"], model["pn2"], model["unet"]
    total = _mlp(n_points * agg["k"], unet["feature_channels"] + (3 if agg["use_relative_xyz"] else 0),
                 agg["mlp_channels"])
    c_in = pn2["in_channels"]
    sa_out, sizes = [c_in], [n_points]
    for sa in pn2["sa"]:
        total += _mlp(sa["npoint"] * sa["nsample"], c_in + (3 if pn2["use_xyz"] else 0), sa["mlp_channels"])
        c_in = sa["mlp_channels"][-1]
        sa_out.append(c_in)
        sizes.append(sa["npoint"])
    c_sparse = sa_out[-1]
    for i, ch in enumerate(pn2["fp_channels"]):
        total += _mlp(sizes[-(i + 2)], c_sparse + sa_out[-(i + 2)], ch)
        c_sparse = ch[-1]
    total += _mlp(n_points, c_sparse, (pn2["head_channels"], pn2["num_classes"]))
    return total


def chunk_forward_flops(cfg: dict, views: int) -> float:
    """Forward FLOPs of MVPNet3D over one chunk of ``views`` views."""
    data = cfg["data"]
    return views * unet_flops(cfg["model"]["unet"], data["image_height"], data["image_width"]) + net3d_flops(
        cfg["model"], data["num_points"]
    )


def train_step_flops(cfg: dict) -> float:
    """Model FLOPs of one optimizer step: every chunk of the batch, forward
    and backward."""
    return 3.0 * cfg["train"]["batch_size"] * chunk_forward_flops(cfg, cfg["data"]["num_views_train"])


def window_forward_flops(cfg: dict) -> float:
    """Model FLOPs of one whole-scene window's forward."""
    return chunk_forward_flops(cfg, cfg["data"]["num_views_eval"])


def least_seconds(bytes_: float, flops: float = 0.0) -> float:
    return max(bytes_ / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def fps_seconds(rows: int, n: int, npoint: int) -> float:
    """Least time of farthest point sampling of ``rows`` rows of ``n``
    float32 points to ``npoint`` int32 indices."""
    return least_seconds(rows * n * 12 + rows * npoint * 4)


def knn_seconds(rows: int, queries: int, refs: int, k: int) -> float:
    """Least time of a k-nearest search: float32 xyz queries and refs in,
    k float32 distances and int32 indices a query out."""
    answers = rows * queries * k
    return least_seconds(rows * (queries + refs) * 12 + answers * 8, answers * DISTANCE_FLOPS)


def fps_calls(cfg: dict, rows: int) -> list[tuple[int, int, int]]:
    """(rows, n, npoint) of each set-abstraction level's FPS in one forward
    over ``rows`` chunks, coarsening."""
    out, n = [], cfg["data"]["num_points"]
    for sa in cfg["model"]["pn2"]["sa"]:
        out.append((rows, n, sa["npoint"]))
        n = sa["npoint"]
    return out


def fusion_knn_call(cfg: dict, rows: int, views: int) -> tuple[int, int, int, int]:
    """(rows, queries, refs, k) of the fusion kNN in one forward."""
    d = cfg["data"]
    return rows, d["num_points"], views * d["image_height"] * d["image_width"], cfg["model"]["aggregation"]["k"]
