"""PLY point-cloud io (numpy, no external deps).

Copy of ``street_crafter_tpu/utils/ply.py`` without its optional C++ fast
path: vertices with optional colors and a mask channel, binary
little-endian and ascii formats.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


class PointCloud(NamedTuple):
    points: np.ndarray            # [N, 3] float32
    colors: np.ndarray | None     # [N, 3] float32 in [0, 1]
    mask: np.ndarray | None       # [N] bool (the reference's per-point mask)


def read_ply(path: str | os.PathLike) -> PointCloud:
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"ply"):
            raise ValueError(f"not a PLY file: {path}")
        header_lines = []
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"truncated PLY header: {path}")
            line = raw.decode("ascii", "replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = None
        n_vertex = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported in vertex element")
                props.append((parts[2], _DTYPES[parts[1]]))

        names = [p[0] for p in props]
        if fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex)
            data = data.reshape(n_vertex, len(props))
            rec = {n: data[:, i] for i, (n, _) in enumerate(props)}
        else:
            endian = "<" if "little" in (fmt or "") else ">"
            dt = np.dtype([(n, endian + t) for n, t in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                count=n_vertex)
            rec = {n: raw[n] for n in names}

    pts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    colors = None
    if all(c in rec for c in ("red", "green", "blue")):
        cols = np.stack([rec["red"], rec["green"], rec["blue"]], -1)
        colors = (cols / 255.0 if cols.dtype != np.float32 or cols.max() > 1.0 + 1e-6
                  else cols).astype(np.float32)
    mask = None
    if "mask" in rec:
        mask = rec["mask"].astype(bool)
    return PointCloud(points=pts, colors=colors, mask=mask)


def write_ply(path: str | os.PathLike, points: np.ndarray,
              colors: np.ndarray | None = None,
              mask: np.ndarray | None = None) -> None:
    points = np.asarray(points, np.float32)
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if mask is not None:
        fields += [("mask", "u1")]
    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if colors is not None:
        rec["red"], rec["green"], rec["blue"] = (
            colors[:, 0], colors[:, 1], colors[:, 2])
    if mask is not None:
        rec["mask"] = np.asarray(mask).astype(np.uint8)

    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        type_names = {"<f4": "float", "u1": "uchar"}
        for name, t in fields:
            f.write(f"property {type_names[t]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def voxel_downsample(points: np.ndarray, colors: np.ndarray | None,
                     voxel_size: float) -> tuple[np.ndarray, np.ndarray | None]:
    """open3d voxel_down_sample analog: mean of points/colors per voxel."""
    keys = np.floor(points / voxel_size).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    m = counts.shape[0]
    out_pts = np.zeros((m, 3), np.float64)
    np.add.at(out_pts, inv, points)
    out_pts /= counts[:, None]
    out_cols = None
    if colors is not None:
        out_cols = np.zeros((m, 3), np.float64)
        np.add.at(out_cols, inv, colors)
        out_cols = (out_cols / counts[:, None]).astype(np.float32)
    return out_pts.astype(np.float32), out_cols


def remove_radius_outliers(points: np.ndarray, nb_points: int = 5,
                           radius: float = 0.5) -> np.ndarray:
    """open3d remove_radius_outlier analog: keep points with >= nb_points
    neighbors within radius (grid-hash neighborhood count). Returns a bool
    keep-mask."""
    cell = radius
    keys = np.floor(points / cell).astype(np.int64)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    key_to_idx = {tuple(k): i for i, k in enumerate(uniq)}
    counts = np.bincount(inv, minlength=len(uniq))
    keep = np.zeros(len(points), bool)
    # neighbor count over the 27-cell neighborhood is an upper bound for the
    # exact radius count and a lower bound when restricted to the own cell;
    # we use exact distances within the candidate cells.
    from collections import defaultdict
    cell_points = defaultdict(list)
    for i, k in enumerate(map(tuple, keys)):
        cell_points[k].append(i)
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
               for dz in (-1, 0, 1)]
    r2 = radius * radius
    for k, idxs in cell_points.items():
        cand = []
        for off in offsets:
            nk = (k[0] + off[0], k[1] + off[1], k[2] + off[2])
            cand.extend(cell_points.get(nk, ()))
        cand = np.asarray(cand)
        p = points[idxs]
        q = points[cand]
        d2 = ((p[:, None] - q[None]) ** 2).sum(-1)
        cnt = (d2 <= r2).sum(-1)  # includes self
        keep[np.asarray(idxs)] = cnt >= nb_points + 1
    return keep
