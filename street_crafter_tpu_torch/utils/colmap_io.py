"""COLMAP sparse-model io, binary and text (port of
``street_crafter_tpu/utils/colmap_io.py``; numpy only).

Reads points3D / images / cameras of a COLMAP model (the triangulated
background points that merge into the LiDAR init) and writes the fixed
known-pose text model the triangulation driver hands to COLMAP.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ..datasets.waymo import rotmat_to_quat_np


def _read(fid, fmt: str):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, fid.read(size))


def read_points3D_binary(path: str):
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N])."""
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty(n)
        for i in range(n):
            data = _read(f, "QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "Q")
            f.seek(8 * track_len, 1)  # skip track (image_id, point2D_idx)
    return xyz, rgb, err


def read_points3D_text(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            xyz.append([float(v) for v in vals[1:4]])
            rgb.append([int(v) for v in vals[4:7]])
            err.append(float(vals[7]))
    return (np.array(xyz).reshape(-1, 3), np.array(rgb, np.uint8).reshape(-1, 3),
            np.array(err))


def read_cameras_binary(path: str) -> dict:
    """camera_id -> dict(model_id, width, height, params)."""
    # params count per model id (COLMAP convention)
    n_params = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4,
                9: 5, 10: 12}
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "iiQQ")
            params = np.array(_read(f, "d" * n_params[model_id]))
            out[cam_id] = {"model_id": model_id, "width": w, "height": h,
                           "params": params}
    return out


def read_images_binary(path: str) -> dict:
    """image_id -> dict(qvec wxyz, tvec, camera_id, name)."""
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            (image_id,) = _read(f, "I")
            qvec = np.array(_read(f, "dddd"))
            tvec = np.array(_read(f, "ddd"))
            (camera_id,) = _read(f, "I")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "Q")
            f.seek(24 * n_pts, 1)  # skip 2D points (x, y, point3D_id)
            out[image_id] = {"qvec": qvec, "tvec": tvec,
                             "camera_id": camera_id,
                             "name": name.decode("utf-8")}
    return out


def rotmat_to_qvec(m: np.ndarray) -> np.ndarray:
    """COLMAP wxyz quaternion from a rotation matrix."""
    return rotmat_to_quat_np(m)


def write_text_model(model_dir: str,
                     cameras: dict,
                     images: dict,
                     points: tuple | None = None) -> None:
    """Write the fixed known-pose model (cameras.txt / images.txt /
    points3D.txt, empty unless ``points`` is given) for colmap
    point_triangulator.

    cameras: cam_id -> dict(model='SIMPLE_PINHOLE'|'PINHOLE', width, height,
    params list). images: image_id -> dict(name, camera_id, w2c [4,4]).
    points: (xyz [N, 3], rgb [N, 3] uint8, error [N]), written as points
    1..N with empty tracks.
    """
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cameras.txt"), "w") as f:
        for cam_id, c in sorted(cameras.items()):
            params = " ".join(str(float(p)) for p in c["params"])
            f.write(f"{cam_id} {c.get('model', 'SIMPLE_PINHOLE')} "
                    f"{c['width']} {c['height']} {params}\n")
    with open(os.path.join(model_dir, "images.txt"), "w") as f:
        for image_id, im in sorted(images.items()):
            w2c = np.asarray(im["w2c"])
            q = rotmat_to_qvec(w2c[:3, :3])
            t = w2c[:3, 3]
            vals = " ".join(str(float(v)) for v in (*q, *t))
            f.write(f"{image_id} {vals} {im['camera_id']} {im['name']}\n\n")
    with open(os.path.join(model_dir, "points3D.txt"), "w") as f:
        if points is not None:
            xyz, rgb, err = (np.asarray(a) for a in points)
            f.writelines(
                f"{i + 1} {x!r} {y!r} {z!r} {r} {g} {b} {e!r}\n"
                for i, ((x, y, z), (r, g, b), e) in enumerate(zip(
                    xyz.astype(np.float64).tolist(),
                    rgb.astype(np.uint8).tolist(),
                    err.astype(np.float64).tolist())))


def read_model_points(model_dir: str):
    """Load points3D from a triangulated model dir (bin preferred)."""
    b = os.path.join(model_dir, "points3D.bin")
    if os.path.exists(b):
        return read_points3D_binary(b)
    t = os.path.join(model_dir, "points3D.txt")
    if os.path.exists(t):
        return read_points3D_text(t)
    raise FileNotFoundError(f"no points3D model under {model_dir}")
