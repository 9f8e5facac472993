"""Offline ScanNet preprocessing: raw scans -> flat npz layout.

The port's copy of ``mvpnet_tpu/data/preprocess.py`` (NumPy only; PIL and
plyfile are imported where they are needed): one preprocessed tree serves
both packages.

Capability-equivalent of the reference's offline preprocess scripts
(mvpnet/data/preprocess/*.py, UNVERIFIED; SURVEY.md §2.2 "Preprocessing"):
  (a) resize extracted color/depth frames to the training resolution,
  (b) bundle per-scene point clouds + 20-class labels,
  (c) record poses/intrinsics per frame.

Expected raw layout (the standard ScanNet extraction):
  <raw>/scans/<scene_id>/
    <scene_id>_vh_clean_2.ply              mesh/point cloud with rgb
    <scene_id>_vh_clean_2.labels.ply       per-vertex raw label ids
    color/<i>.jpg  depth/<i>.png  pose/<i>.txt  intrinsic/intrinsic_depth.txt

Run:  python -m mvpnet_torch.data.preprocess --raw <raw> --out <root> \
          --tsv scannetv2-labels.combined.tsv [--height 120 --width 160]

Requires real ScanNet data on disk.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from mvpnet_torch.data.meta import nyu40_to_train, parse_label_mapping


_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _read_ply_numpy(path: str):
    """Pure-numpy PLY vertex reader (ascii + binary_little_endian), covering
    the ScanNet vh_clean_2 layout: flat vertex properties, no lists."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = 0
        fields: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = fh.readline().decode("ascii").strip()
            if line == "end_header":
                break
            tok = line.split()
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                in_vertex = tok[1] == "vertex"
                if in_vertex:
                    count = int(tok[2])
            elif tok[0] == "property" and in_vertex:
                if tok[1] == "list":
                    raise ValueError(f"{path}: list vertex properties unsupported")
                fields.append((tok[2], _PLY_TYPES[tok[1]]))
        if fmt == "ascii":
            rows = [fh.readline().split() for _ in range(count)]
            data = np.array(
                [tuple(r[: len(fields)]) for r in rows],
                dtype=[(n, t) for n, t in fields],
            )
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(n, "<" + t) for n, t in fields])
            data = np.frombuffer(fh.read(count * dtype.itemsize), dtype=dtype)
        else:
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return data


def _read_ply_vertices(path: str):
    """Minimal binary/ascii PLY vertex reader (x,y,z[,r,g,b][,label])."""
    try:
        from plyfile import PlyData  # optional dependency

        v = PlyData.read(path)["vertex"].data
    except ImportError:  # plyfile is optional: numpy fallback
        v = _read_ply_numpy(path)
    names = v.dtype.names
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    rgb = None
    if "red" in names:
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.uint8)
    label = np.asarray(v["label"]).astype(np.int32) if "label" in names else None
    return xyz, rgb, label


def _resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


def preprocess_scene(
    raw_dir: str,
    out_root: str,
    scene_id: str,
    label_table: np.ndarray,
    raw_to_nyu: dict[int, int] | None,
    *,
    height: int,
    width: int,
    frame_skip: int = 1,
    ignore_label: int = -100,
) -> None:
    from PIL import Image

    scan = os.path.join(raw_dir, "scans", scene_id)
    xyz, rgb, raw_label = _read_ply_vertices(
        os.path.join(scan, f"{scene_id}_vh_clean_2.labels.ply")
    )
    if rgb is None:
        _, rgb, _ = _read_ply_vertices(
            os.path.join(scan, f"{scene_id}_vh_clean_2.ply")
        )
    if raw_to_nyu is not None and raw_label is not None:
        nyu = np.vectorize(lambda r: raw_to_nyu.get(int(r), 0))(raw_label)
    else:
        nyu = raw_label if raw_label is not None else np.zeros(len(xyz), np.int64)
    labels = label_table[np.clip(nyu, 0, 40)]

    os.makedirs(os.path.join(out_root, "scenes"), exist_ok=True)
    np.savez_compressed(
        os.path.join(out_root, "scenes", f"{scene_id}.npz"),
        points=xyz,
        colors=rgb if rgb is not None else np.zeros((len(xyz), 3), np.uint8),
        labels=labels.astype(np.int32),
    )

    color_dir = os.path.join(scan, "color")
    if not os.path.isdir(color_dir):
        return
    frame_ids = sorted(
        int(os.path.splitext(f)[0]) for f in os.listdir(color_dir)
    )[::frame_skip]
    depths, rgbs, poses, labels_2d = [], [], [], []
    label_dir = os.path.join(scan, "label")
    for fid in frame_ids:
        pose = np.loadtxt(os.path.join(scan, "pose", f"{fid}.txt")).astype(np.float32)
        if not np.all(np.isfinite(pose)):
            continue
        col = np.asarray(Image.open(os.path.join(scan, "color", f"{fid}.jpg")))
        dep = np.asarray(Image.open(os.path.join(scan, "depth", f"{fid}.png")))
        rgbs.append(_resize_nearest(col, height, width))
        depths.append(_resize_nearest(dep, height, width))
        poses.append(pose)
        # optional 2D label maps, nearest-resized like the reference's
        # ScanNet2D label path (SURVEY.md §2.2 "2D dataset"). `label/`
        # exports carry nyu40 ids; `label-filt/` exports carry raw ScanNet
        # ids — detect by range and remap instead of silently clipping.
        lab_path = os.path.join(label_dir, f"{fid}.png")
        if os.path.isfile(lab_path):
            lab_img = _resize_nearest(
                np.asarray(Image.open(lab_path)).astype(np.int64), height, width
            )
            if lab_img.max() > 40:  # raw ScanNet ids, not nyu40
                if raw_to_nyu is None:
                    raise ValueError(
                        f"{lab_path}: label ids exceed 40 (raw ScanNet ids?) "
                        "but no --tsv label mapping was provided"
                    )
                lab_img = np.vectorize(lambda r: raw_to_nyu.get(int(r), 0))(lab_img)
            labels_2d.append(label_table[lab_img])
    intr = np.loadtxt(
        os.path.join(scan, "intrinsic", "intrinsic_depth.txt")
    ).astype(np.float32)[:3, :3]
    # rescale intrinsics from the raw depth resolution to (height, width)
    raw_dep = np.asarray(
        Image.open(os.path.join(scan, "depth", f"{frame_ids[0]}.png"))
    )
    sy, sx = height / raw_dep.shape[0], width / raw_dep.shape[1]
    intr = intr * np.array([[sx, 0, sx], [0, sy, sy], [0, 0, 1]], np.float32)

    os.makedirs(os.path.join(out_root, "frames"), exist_ok=True)
    extra = (
        {"label_2d": np.stack(labels_2d).astype(np.int16)}
        if len(labels_2d) == len(depths)
        else {}
    )
    np.savez_compressed(
        os.path.join(out_root, "frames", f"{scene_id}.npz"),
        depth=np.stack(depths).astype(np.uint16),
        rgb=np.stack(rgbs).astype(np.uint8),
        poses=np.stack(poses),
        intrinsics=intr,
        depth_scale=np.float32(1000.0),
        **extra,
    )


def write_split_lists(raw: str, out: str, scans: list[str]) -> None:
    """Materialize meta/scannetv2_{train,val,test}.txt for data/scannet.py.

    The split lists are ScanNet distribution files (Tasks/Benchmark/ in the
    official release), not derivable from the scans themselves; copy them if
    the raw tree carries them. Otherwise fall back to a DETERMINISTIC
    ~90/10 train/val split by scene number so the pipeline still runs —
    with a loud warning, because mIoU measured on a non-official split is
    not comparable to published numbers."""
    import shutil

    copied = set()
    for split in ("train", "val", "test"):
        dst = os.path.join(out, "meta", f"scannetv2_{split}.txt")
        for cand in (
            os.path.join(raw, f"scannetv2_{split}.txt"),
            os.path.join(raw, "Tasks", "Benchmark", f"scannetv2_{split}.txt"),
            os.path.join(raw, "splits", f"scannetv2_{split}.txt"),
        ):
            if os.path.exists(cand):
                shutil.copyfile(cand, dst)
                copied.add(split)
                break
    if {"train", "val"} <= copied:
        return
    missing = [s for s in ("train", "val") if s not in copied]
    print(
        f"WARNING: official scannetv2_{{{','.join(missing)}}}.txt not found "
        "in the raw tree — writing a deterministic fallback for the missing "
        "split(s). Do NOT quote mIoU from a fallback split against "
        "published numbers."
    )
    # Scenes already claimed by a COPIED official list must not reappear in
    # a fallback list — otherwise a raw tree carrying only one of the two
    # lists would get a train/val overlap (data leak inflating val mIoU).
    claimed = set()
    for split in copied:
        with open(os.path.join(out, "meta", f"scannetv2_{split}.txt")) as fh:
            claimed.update(line.strip() for line in fh if line.strip())
    pool = [sid for sid in scans if sid not in claimed]
    if len(missing) == 1:
        # one official list exists: everything it didn't claim belongs to
        # the other split — no re-splitting (which would drop scenes).
        train = val = pool
    else:
        train, val = [], []
        for sid in pool:
            # scene0123_01 -> 123; every 10th scene number goes to val
            digits = "".join(c for c in sid if c.isdigit())
            (val if digits and int(digits[:4]) % 10 == 9 else train).append(sid)
        if not val and len(train) > 1:  # tiny corpora: keep val non-empty
            val.append(train.pop())
    for split, ids in (("train", train), ("val", val)):
        if split in copied:
            continue
        with open(os.path.join(out, "meta", f"scannetv2_{split}.txt"), "w") as fh:
            fh.write("\n".join(ids) + "\n")


def main(argv=None):  # pragma: no cover - requires real ScanNet on disk
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--raw", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--tsv", default=None, help="scannetv2-labels.combined.tsv")
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--frame-skip", type=int, default=10)
    args = ap.parse_args(argv)

    table = nyu40_to_train()
    raw_to_nyu = parse_label_mapping(args.tsv) if args.tsv else None
    scans = sorted(os.listdir(os.path.join(args.raw, "scans")))
    os.makedirs(os.path.join(args.out, "meta"), exist_ok=True)
    write_split_lists(args.raw, args.out, scans)
    for i, scene_id in enumerate(scans):
        print(f"[{i + 1}/{len(scans)}] {scene_id}")
        preprocess_scene(
            args.raw,
            args.out,
            scene_id,
            table,
            raw_to_nyu,
            height=args.height,
            width=args.width,
            frame_skip=args.frame_skip,
        )


if __name__ == "__main__":  # pragma: no cover
    main()
