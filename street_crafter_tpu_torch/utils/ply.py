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
    """open3d voxel_down_sample analog: mean of points/colors per voxel,
    the voxels in lexicographic (x, y, z) order."""
    keys = np.floor(points / voxel_size).astype(np.int64)
    inv, counts = _voxel_ids(keys)
    m = counts.shape[0]

    def mean(x):        # float64 sums in the points' order, as np.add.at
        return np.stack([np.bincount(inv, weights=x[:, i], minlength=m)
                         for i in range(3)], 1) / counts[:, None]

    out_cols = None if colors is None else mean(colors).astype(np.float32)
    return mean(points).astype(np.float32), out_cols


def _voxel_ids(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``np.unique(keys, axis=0, return_inverse=True, return_counts=True)``
    without the unique rows: each [N, 3] int64 row packed into one int64
    that sorts as the row does (a 1-D sort, not a sort of records)."""
    if len(keys) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    packed, _ = _pack_cells(keys, margin=0)
    _, inv, counts = np.unique(packed, return_inverse=True,
                               return_counts=True)
    return inv.reshape(-1), counts


def _pack_cells(keys: np.ndarray, margin: int) -> tuple[np.ndarray, ...]:
    """Each [N, 3] int64 cell index as one int64 that sorts as the row
    does, with ``margin`` spare cells below and above each axis (so a
    neighbour's offset stays inside); returns (packed keys, the spans)."""
    lo = keys.min(0) - margin
    span = keys.max(0) - lo + 1 + margin
    if float(span[0]) * float(span[1]) * float(span[2]) >= 2.0 ** 62:
        raise ValueError(f"{span} cells overflow a 64-bit cell key")
    k = keys - lo
    return (k[:, 0] * span[1] + k[:, 1]) * span[2] + k[:, 2], span


_OUTLIER_BLOCK = 1 << 15      # points a vectorised pass
# the own cell first: in a dense cloud it holds most points' neighbours
_OFFSETS = sorted(((dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                   for dz in (-1, 0, 1)), key=lambda o: o != (0, 0, 0))


def remove_radius_outliers(points: np.ndarray, nb_points: int = 5,
                           radius: float = 0.5) -> np.ndarray:
    """open3d remove_radius_outlier analog: keep points with >= nb_points
    neighbors within radius. Returns a bool keep-mask.

    Cells of side ``radius`` hash the points; each point's candidates are
    the points of its own and the 26 neighbouring cells, and it counts
    those (itself included) whose squared distance ``((p - q) ** 2).sum()``
    in float32 is at most radius^2, stopping once it has ``nb_points + 1``
    (the mask is the same). The points are sorted by cell, so a
    neighbouring cell is one contiguous run, and the candidate pairs of a
    block of points are counted in one vectorised pass an offset."""
    n = len(points)
    keep = np.zeros(n, bool)
    if n == 0:
        return keep
    packed, span = _pack_cells(np.floor(points / radius).astype(np.int64),
                               margin=1)
    order = np.argsort(packed, kind="stable")
    packed, pts = packed[order], points[order]
    cells, first, size = np.unique(packed, return_index=True,
                                   return_counts=True)
    r2 = radius * radius
    need = nb_points + 1
    count = np.zeros(n, np.int64)
    for b0 in range(0, n, _OUTLIER_BLOCK):
        b1 = min(b0 + _OUTLIER_BLOCK, n)
        for dx, dy, dz in _OFFSETS:
            # a point that has its neighbours already is done
            open_ = b0 + np.flatnonzero(count[b0:b1] < need)
            if not len(open_):
                break
            want = packed[open_] + (dx * span[1] + dy) * span[2] + dz
            c = np.minimum(np.searchsorted(cells, want), len(cells) - 1)
            length = np.where(cells[c] == want, size[c], 0)
            total = int(length.sum())
            if not total:
                continue
            i = np.repeat(open_, length)
            run = np.cumsum(length) - length
            j = (np.arange(total) - np.repeat(run, length)
                 + np.repeat(first[c], length))
            d2 = ((pts[i] - pts[j]) ** 2).sum(-1)
            count[b0:b1] += np.bincount(i[d2 <= r2] - b0,
                                        minlength=b1 - b0)
    keep[order] = count >= nb_points + 1
    return keep
