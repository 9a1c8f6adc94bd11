"""Known-pose COLMAP triangulation driver (port of
``street_crafter_tpu/data_processor/colmap_driver.py``).

Copies the train images and their inverted dynamic masks, runs colmap
feature_extractor, writes a fixed known-pose model (cameras / images text
from the scene calibration), exhaustive_matcher, point_triangulator (poses
and intrinsics frozen) and optionally rig_bundle_adjuster. The result,
``{model_path}/colmap/triangulated/sparse/model``, holds the points3D that
merge into the background LiDAR init (``initialize_ply(colmap_points=)``).

The ``colmap`` binary is host-side preprocessing: every call goes through
``runner`` (default: the binary, with a clear error when it is missing), so
the commands can be run elsewhere or checked without it. Masks are PNGs
written by ``utils/png``.
"""

from __future__ import annotations

import json
import os
import shutil
import sqlite3
import subprocess
from typing import Callable, Sequence

import numpy as np

from ..datasets.readers import CameraInfo
from ..utils.colmap_io import (read_model_points, rotmat_to_qvec,
                               write_text_model)
from ..utils.png import read_png, write_png


def _colmap(args: Sequence[str]) -> None:
    if shutil.which("colmap") is None:
        raise RuntimeError(
            "the 'colmap' binary is not installed; COLMAP triangulation is "
            "optional host-side preprocessing (cfg.data.use_colmap)")
    subprocess.run(["colmap", *args], check=True)


def _flat_name(cam: int, name: str) -> str:
    return f"cam_{cam}/{name}.png"


def run_colmap(cameras: list[CameraInfo], out_dir: str,
               use_rig_ba: bool = False,
               runner: Callable[[Sequence[str]], None] = _colmap) -> str:
    """Triangulate scene points from posed train images. Returns the
    triangulated model dir."""
    colmap_dir = os.path.abspath(out_dir)
    images_dir = os.path.join(colmap_dir, "images")
    masks_dir = os.path.join(colmap_dir, "mask")
    os.makedirs(images_dir, exist_ok=True)
    os.makedirs(masks_dir, exist_ok=True)

    cams_present = sorted({c.metadata["cam"] for c in cameras})
    for info in cameras:
        cam = info.metadata["cam"]
        rel = _flat_name(cam, info.image_name)
        dst = os.path.join(images_dir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if not os.path.exists(dst):
            shutil.copyfile(info.image_path, dst)
        # inverted dynamic mask: feature extraction ignores moving actors
        mask_dst = os.path.join(masks_dir, rel + ".png")
        os.makedirs(os.path.dirname(mask_dst), exist_ok=True)
        if not os.path.exists(mask_dst):
            dyn = info.guidance.get("obj_bound_path")
            if dyn and os.path.exists(dyn):
                m = read_png(dyn)
                if m.ndim == 3:
                    m = m[..., 0]
                write_png(mask_dst, (255 - m).astype(np.uint8))
            else:
                write_png(mask_dst, np.full((info.height, info.width), 255,
                                            np.uint8))

    db = os.path.join(colmap_dir, "database.db")
    runner(["feature_extractor",
            "--ImageReader.mask_path", masks_dir,
            "--ImageReader.camera_model", "SIMPLE_PINHOLE",
            "--ImageReader.single_camera_per_folder", "1",
            "--database_path", db,
            "--image_path", images_dir,
            "--SiftExtraction.use_gpu", "0"])

    # read image ids assigned by colmap; pin intrinsics + poses
    conn = sqlite3.connect(db)
    rows = conn.cursor().execute(
        "SELECT image_id, name, camera_id FROM images").fetchall()

    by_name = {_flat_name(c.metadata["cam"], c.image_name): c
               for c in cameras}
    cam_models: dict[int, dict] = {}
    images_model: dict[int, dict] = {}
    for image_id, name, camera_id in rows:
        info = by_name[name]
        K = np.asarray(info.K)
        cam_models[camera_id] = {
            "model": "SIMPLE_PINHOLE", "width": info.width,
            "height": info.height,
            "params": [K[0, 0], K[0, 2], K[1, 2]]}
        w2c = np.eye(4)
        w2c[:3, :3] = info.R.T
        w2c[:3, 3] = info.T
        images_model[image_id] = {"name": name, "camera_id": camera_id,
                                  "w2c": w2c}
        # pin the intrinsics in the database too
        params = np.array([K[0, 0], K[0, 2], K[1, 2]], np.float64)
        conn.execute("UPDATE cameras SET params = ? WHERE camera_id = ?",
                     (params.tobytes(), camera_id))
    conn.commit()
    conn.close()

    model_dir = os.path.join(colmap_dir, "created", "sparse", "model")
    write_text_model(model_dir, cam_models, images_model)

    runner(["exhaustive_matcher", "--database_path", db])

    tri_dir = os.path.join(colmap_dir, "triangulated", "sparse", "model")
    os.makedirs(tri_dir, exist_ok=True)
    runner(["point_triangulator",
            "--database_path", db,
            "--image_path", images_dir,
            "--input_path", model_dir,
            "--output_path", tri_dir,
            "--Mapper.ba_refine_focal_length", "0",
            "--Mapper.ba_refine_principal_point", "0",
            "--Mapper.max_extra_param", "0",
            "--clear_points", "0",
            "--Mapper.filter_max_reproj_error", "4",
            "--Mapper.tri_min_angle", "0.5",
            "--Mapper.tri_ignore_two_view_tracks", "1"])

    if use_rig_ba:
        rig_cfg = _rig_config(cameras, cams_present)
        rig_path = os.path.join(colmap_dir, "cam_rigid_config.json")
        with open(rig_path, "w") as f:
            json.dump([rig_cfg], f, indent=4)
        runner(["rig_bundle_adjuster",
                "--input_path", tri_dir, "--output_path", tri_dir,
                "--rig_config_path", rig_path,
                "--estimate_rig_relative_poses", "0",
                "--BundleAdjustment.refine_focal_length", "0",
                "--BundleAdjustment.refine_principal_point", "0"])
    return tri_dir


def _rig_config(cameras: list[CameraInfo], cams_present: list[int]) -> dict:
    """Camera-rig description from the per-camera extrinsics."""
    ext = {}
    for c in cameras:
        ext.setdefault(c.metadata["cam"], np.asarray(c.metadata["extrinsic"]))
    ref = cams_present[0]
    rig = {"ref_camera_id": ref, "cameras": []}
    for cam in cams_present:
        rel = np.linalg.inv(ext[cam]) @ ext[ref]
        q = rotmat_to_qvec(rel[:3, :3])
        rig["cameras"].append({
            "camera_id": cam,
            "image_prefix": f"cam_{cam}",
            "cam_from_rig_rotation": [float(v) for v in q],
            "cam_from_rig_translation": [float(v) for v in rel[:3, 3]],
        })
    return rig


def load_colmap_points(model_path: str):
    """(xyz, rgb in [0,1]) from a completed triangulation, or None."""
    tri_dir = os.path.join(model_path, "colmap", "triangulated", "sparse",
                           "model")
    try:
        xyz, rgb, _ = read_model_points(tri_dir)
    except FileNotFoundError:
        return None
    return xyz.astype(np.float32), (rgb.astype(np.float32) / 255.0)
