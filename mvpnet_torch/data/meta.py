"""ScanNet v2 label metadata.

The port's copy of ``mvpnet_tpu/data/meta.py``, with the same tables:
capability-equivalent of the reference's ``mvpnet/data/meta_files/``
(UNVERIFIED; SURVEY.md §2.2 "Meta files"): 20-class benchmark names, the
NYU40 id remap used for ScanNet benchmark-format exports (test_3d.py [A]),
and the standard color palette for visualization.
"""
from __future__ import annotations

import numpy as np

# The 20 ScanNet v2 benchmark classes (in train-label order 0..19).
CLASS_NAMES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)

# train id (0..19) -> NYU40 id, for benchmark .txt export.
NYU40_IDS = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39,
)

# Standard ScanNet benchmark color palette (one RGB per train id).
CLASS_COLORS = np.array(
    [
        (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
        (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
        (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
        (247, 182, 210), (219, 219, 141), (255, 127, 14), (158, 218, 229),
        (44, 160, 44), (112, 128, 144), (227, 119, 194), (82, 84, 163),
    ],
    dtype=np.uint8,
)

NUM_CLASSES = len(CLASS_NAMES)


def remap_to_nyu40(train_ids: np.ndarray, ignore_label: int = -100) -> np.ndarray:
    """Map train ids (0..19, ignore_label) to NYU40 ids (0 for ignored)."""
    table = np.zeros(NUM_CLASSES + 1, dtype=np.int32)
    table[:NUM_CLASSES] = NYU40_IDS
    safe = np.where(train_ids == ignore_label, NUM_CLASSES, train_ids)
    return table[safe]


def parse_label_mapping(tsv_path: str, from_col: str = "id", to_col: str = "nyu40id"):
    """Parse scannetv2-labels.combined.tsv into a raw->value dict.

    Used by offline preprocessing to map raw ScanNet label ids to the
    20-class train ids (reference: preprocess scripts consuming the same
    tsv — SURVEY.md §2.2 "Preprocessing").
    """
    mapping = {}
    with open(tsv_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        fi, ti = header.index(from_col), header.index(to_col)
        for line in fh:
            row = line.rstrip("\n").split("\t")
            if len(row) <= max(fi, ti) or not row[fi]:
                continue
            try:
                mapping[int(row[fi])] = int(row[ti]) if row[ti] else 0
            except ValueError:
                continue
    return mapping


# NYU40 id -> train id (0..19) or ignore; inverse of NYU40_IDS.
def nyu40_to_train(ignore_label: int = -100) -> np.ndarray:
    table = np.full(41, ignore_label, dtype=np.int32)
    for train_id, nyu_id in enumerate(NYU40_IDS):
        table[nyu_id] = train_id
    return table
