"""Point-cloud / label visualization helpers.

The port's copy of ``mvpnet_tpu/utils/visualize.py`` (NumPy only; matplotlib
is imported where it is needed).

Capability-equivalent of the reference's optional visualization utilities
(mvpnet/utils/visualize.py [U], SURVEY.md §2.2 last row). Open3D is not a
dependency, so outputs are PLY files (any viewer opens them) and matplotlib
figures when available.
"""
from __future__ import annotations

import numpy as np

from mvpnet_torch.data.meta import CLASS_COLORS


def labels_to_colors(labels: np.ndarray, ignore_label: int = -100) -> np.ndarray:
    """(N,) train ids -> (N, 3) uint8 colors (ignored points gray)."""
    colors = np.full((len(labels), 3), 128, np.uint8)
    valid = (labels >= 0) & (labels < len(CLASS_COLORS))
    colors[valid] = CLASS_COLORS[labels[valid]]
    return colors


def write_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> None:
    """Write an ascii PLY point cloud ((N,3) float, optional (N,3) uint8)."""
    n = len(points)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {n}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            fh.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        fh.write("end_header\n")
        if colors is None:
            for p in points:
                fh.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            for p, c in zip(points, colors):
                fh.write(
                    f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n"
                )


def export_prediction(
    path: str, points: np.ndarray, pred: np.ndarray, ignore_label: int = -100
) -> None:
    """Scene prediction -> colored PLY."""
    write_ply(path, points, labels_to_colors(pred, ignore_label))


def save_seg_image(path: str, label_map: np.ndarray, ignore_label: int = -100):
    """2D label map (H, W) -> color PNG via matplotlib (if available)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # pragma: no cover
        return False
    rgb = labels_to_colors(label_map.reshape(-1), ignore_label).reshape(
        label_map.shape + (3,)
    )
    plt.imsave(path, rgb)
    return True
