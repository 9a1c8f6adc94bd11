"""Comparison and inspection images (port of
``street_crafter_tpu/visualizers/compare.py``; numpy, with OpenCV for lines
and text and matplotlib for colormaps, imported where used).

Multi-camera tiled layouts, projected 3D-box overlays, id -> colour
hashing, weighted-percentile depth colormaps and a labelled side-by-side
strip for comparing gt / 3DGS render / diffusion output. Layouts are
(row, col) tables per dataset; one compositor serves every dataset.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Sequence

import numpy as np

# dataset -> {cam_name: (row, col)} on an implicit grid; cameras absent from
# a frame leave their cell black and the canvas is cropped to filled cells.
# Side cameras that are shorter than the front camera are bottom-anchored
# (the Waymo side cameras crop the sky).
_LAYOUTS: dict[str, dict[str, tuple[int, int]]] = {
    "waymo": {
        "left_camera": (0, 0),
        "front_left_camera": (0, 1),
        "front_camera": (0, 2),
        "front_right_camera": (0, 3),
        "right_camera": (0, 4),
    },
    "pandaset": {
        "left_camera": (0, 0),
        "front_left_camera": (0, 1),
        "front_camera": (0, 2),
        "front_right_camera": (0, 3),
        "right_camera": (0, 4),
        "back_camera": (1, 2),
    },
    "nuscenes": {
        "CAM_FRONT_LEFT": (0, 0),
        "CAM_FRONT": (0, 1),
        "CAM_FRONT_RIGHT": (0, 2),
        "CAM_BACK_LEFT": (1, 0),
        "CAM_BACK": (1, 1),
        "CAM_BACK_RIGHT": (1, 2),
    },
    "nuplan": {
        "CAM_L0": (0, 0), "CAM_F0": (0, 1), "CAM_R0": (0, 2),
        "CAM_L1": (1, 0), "CAM_R1": (1, 2),
        "CAM_L2": (2, 0), "CAM_B0": (2, 1), "CAM_R2": (2, 2),
    },
    "kitti": {"CAM_LEFT": (0, 0), "CAM_RIGHT": (1, 0)},
    "argoverse": {
        "ring_front_left": (0, 0), "ring_front_center": (0, 1),
        "ring_front_right": (0, 2),
        "ring_side_left": (1, 0), "ring_side_right": (1, 2),
        "ring_rear_left": (2, 0), "ring_rear_right": (2, 2),
    },
}


def tile_cameras(imgs: Sequence[np.ndarray], cam_names: Sequence[str],
                 dataset: str = "waymo") -> np.ndarray:
    """Tile per-camera frames into one canvas."""
    layout = _LAYOUTS.get(dataset)
    if layout is None:
        raise ValueError(f"dataset {dataset!r} not supported "
                         f"(have {sorted(_LAYOUTS)})")
    # cell size from the largest provided image
    ch = max(i.shape[0] for i in imgs)
    cw = max(i.shape[1] for i in imgs)
    rows = 1 + max(r for r, _ in layout.values())
    cols = 1 + max(c for _, c in layout.values())
    canvas = np.zeros((rows * ch, cols * cw, imgs[0].shape[-1]), np.float32)
    filled = np.zeros((rows, cols), bool)
    for img, name in zip(imgs, cam_names):
        if name not in layout:
            continue
        r, c = layout[name]
        h, w = img.shape[:2]
        y0 = r * ch + (ch - h)          # bottom-anchor short side cams
        x0 = c * cw
        canvas[y0:y0 + h, x0:x0 + w] = img
        filled[r, c] = True
    rs = np.where(filled.any(1))[0]
    cs = np.where(filled.any(0))[0]
    return canvas[rs.min() * ch:(rs.max() + 1) * ch,
                  cs.min() * cw:(cs.max() + 1) * cw]


_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),      # one face
              (4, 5), (5, 6), (6, 7), (7, 4),      # opposite face
              (0, 4), (1, 5), (2, 6), (3, 7)]      # connectors


def draw_bbox3d(img: np.ndarray, corners2d: np.ndarray,
                colors=None, thickness: int = 2) -> np.ndarray:
    """Draw projected 3D boxes.

    corners2d: [num_boxes, 8, 2] pixel coordinates, faces ordered
    0-3 / 4-7 with vertical connectors i <-> i+4.
    colors: one (r,g,b) tuple, a list per box, or None (id-hash magenta).
    """
    import cv2

    canvas = np.ascontiguousarray(img.copy())
    corners2d = np.asarray(corners2d).astype(np.int32)
    for b in range(corners2d.shape[0]):
        if colors is None:
            c = (255, 0, 255)
        elif isinstance(colors, tuple):
            c = colors
        else:
            c = colors[b]
        pts = corners2d[b]
        for i, j in _BOX_EDGES:
            cv2.line(canvas, tuple(pts[i]), tuple(pts[j]), c, thickness)
    return canvas


def color_for_id(track_id: str) -> tuple[int, int, int]:
    """Stable id->color via SHA-256."""
    h = hashlib.sha256(str(track_id).encode()).hexdigest()
    return (int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16))


def weighted_percentile(x: np.ndarray, w: np.ndarray | None,
                        ps: Sequence[float]) -> np.ndarray:
    """Weighted percentiles of a flattened map."""
    x = np.asarray(x).reshape(-1)
    w = (np.ones_like(x) if w is None else np.asarray(w).reshape(-1))
    order = np.argsort(x)
    x, w = x[order], w[order]
    acc = np.cumsum(w)
    return np.interp(np.asarray(ps) * (acc[-1] / 100.0), acc, x)


def checker_matte(vis: np.ndarray, acc: np.ndarray, dark: float = 0.8,
                  light: float = 1.0, width: int = 8) -> np.ndarray:
    """Checkerboard under non-accumulated pixels."""
    bg = np.logical_xor(
        (np.arange(acc.shape[0]) % (2 * width) // width)[:, None],
        (np.arange(acc.shape[1]) % (2 * width) // width)[None, :])
    bg = np.where(bg, light, dark)
    return vis * acc[..., None] + (bg * (1 - acc))[..., None]


def visualize_depth(depth: np.ndarray, acc: np.ndarray | None = None,
                    lo: float | None = None, hi: float | None = None,
                    percentile: float = 99.0,
                    curve_fn: Callable = lambda x: -np.log(x + 1e-6),
                    colormap: str = "turbo") -> np.ndarray:
    """Depth -> rgb in [0,1]:
    -log curve, weighted-percentile bounds, matplotlib colormap."""
    if lo is None or hi is None:
        lo_a, hi_a = weighted_percentile(
            depth, acc, [50 - percentile / 2, 50 + percentile / 2])
        eps = np.finfo(np.float32).eps
        lo = lo if lo is not None else lo_a - eps
        hi = hi if hi is not None else hi_a + eps
    v, lo_c, hi_c = curve_fn(depth), curve_fn(lo), curve_fn(hi)
    v = np.nan_to_num(
        np.clip((v - min(lo_c, hi_c)) / abs(hi_c - lo_c), 0, 1))
    if acc is not None:
        v = v * acc
    from matplotlib import colormaps
    return np.asarray(colormaps[colormap](v))[..., :3].astype(np.float32)


def compare_strip(panels: dict[str, np.ndarray],
                  label_height: int = 14) -> np.ndarray:
    """Horizontal labelled strip for gt / render / diffusion comparison.
    panels: {label: [H,W,3] in [0,1]}."""
    import cv2

    cols = []
    H = max(p.shape[0] for p in panels.values())
    for label, img in panels.items():
        h, w = img.shape[:2]
        if h < H:
            img = np.concatenate(
                [img, np.zeros((H - h, w, img.shape[-1]), img.dtype)], 0)
        bar = np.zeros((label_height + 6, img.shape[1], 3), np.float32)
        canvas = np.ascontiguousarray((bar * 255).astype(np.uint8))
        cv2.putText(canvas, str(label), (4, label_height),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1)
        cols.append(np.concatenate([canvas.astype(np.float32) / 255.0,
                                    img.astype(np.float32)], 0))
    return np.concatenate(cols, 1)
