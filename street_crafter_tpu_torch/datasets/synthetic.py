"""Synthetic processed-Waymo scene generator.

The port's copy of ``tests/synthetic_scene.make_scene``: the same scene from
the same seed (images, ego_pose, intrinsics/extrinsics, track pickles,
timestamps, per-frame LiDAR plys, depth npz, sky/dynamic masks), with PNGs
written by the port's stdlib writer. Geometry is simple: an ego moving along
+x, one moving actor and one static sign.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from ..utils.ply import write_ply
from ..utils.png import write_png

NUM_CAMS = 5
IMG_W, IMG_H = 64, 48


def _write_png(path, arr):
    write_png(path, arr)


def make_scene(root: str, num_frames: int = 4, seed: int = 0,
               scene_name: str = "016",
               img_hw: tuple = (IMG_H, IMG_W),
               image_cameras: tuple | None = None) -> str:
    """Create a synthetic scene under root/scene_name; returns its path.
    ``img_hw`` scales the camera resolution (intrinsics follow).
    ``image_cameras`` limits the images, masks and LiDAR depth maps written
    to those cameras (default: all five)."""
    rng = np.random.default_rng(seed)
    IMG_H_, IMG_W_ = img_hw
    d = os.path.join(root, scene_name)
    os.makedirs(d, exist_ok=True)

    # calibration: cameras at small offsets, opencv convention (z forward)
    # cam->ego: forward = ego +x
    cam2ego_base = np.array([
        [0.0, 0.0, 1.0, 1.5],
        [-1.0, 0.0, 0.0, 0.0],
        [0.0, -1.0, 0.0, 2.0],
        [0.0, 0.0, 0.0, 1.0]])
    os.makedirs(os.path.join(d, "intrinsics"), exist_ok=True)
    os.makedirs(os.path.join(d, "extrinsics"), exist_ok=True)
    fx = fy = 40.0 * (IMG_W_ / IMG_W)
    cx, cy = IMG_W_ / 2, IMG_H_ / 2
    for c in range(NUM_CAMS):
        vals = np.zeros(9)
        vals[:4] = [fx, fy, cx, cy]
        np.savetxt(os.path.join(d, "intrinsics", f"{c}.txt"), vals)
        ext = cam2ego_base.copy()
        ext[1, 3] += 0.3 * c  # spread cameras laterally
        np.savetxt(os.path.join(d, "extrinsics", f"{c}.txt"), ext)

    # ego poses: straight line along +x, 2 m/frame
    os.makedirs(os.path.join(d, "ego_pose"), exist_ok=True)
    timestamps = {"FRAME": {}}
    for name in ("FRONT", "FRONT_LEFT", "FRONT_RIGHT", "SIDE_LEFT",
                 "SIDE_RIGHT"):
        timestamps[name] = {}
    for f in range(num_frames):
        pose = np.eye(4)
        pose[0, 3] = 2.0 * f
        np.savetxt(os.path.join(d, "ego_pose", f"{f:06d}.txt"), pose)
        timestamps["FRAME"][f"{f:06d}"] = 0.1 * f
        for c, name in enumerate(("FRONT", "FRONT_LEFT", "FRONT_RIGHT",
                                  "SIDE_LEFT", "SIDE_RIGHT")):
            cam_pose = pose.copy()
            cam_pose[0, 3] += 0.01 * c  # rolling-shutter-ish offset
            np.savetxt(os.path.join(d, "ego_pose", f"{f:06d}_{c}.txt"),
                       cam_pose)
            timestamps[name][f"{f:06d}"] = 0.1 * f + 0.005 * c
    with open(os.path.join(d, "timestamps.json"), "w") as fh:
        json.dump(timestamps, fh)

    # one moving actor (vehicle) crossing ahead, one stationary sign
    track_info, track_camera_visible, trajectory = {}, {}, {}
    moving_id, static_id = "actor_moving", "actor_static"

    def box(cx_, cy_, cz, heading, h, w, length, ts):
        return {"height": h, "width": w, "length": length,
                "center_x": cx_, "center_y": cy_, "center_z": cz,
                "heading": heading, "label": "vehicle", "speed": 1.0,
                "timestamp": ts}

    mov_frames, mov_boxes = [], []
    for f in range(num_frames):
        ts = 0.1 * f
        info = {}
        # moving actor: 10 m ahead of ego start, drifting +y (in vehicle
        # frame: ahead = +x of ego). ego is at x=2f so vehicle-frame x=10-2f.
        mb = box(10.0 - 2.0 * f, 0.5 * f, 1.0, 0.1 * f, 1.8, 2.0, 4.5, ts)
        info[moving_id] = {"lidar_box": mb, "camera_box": dict(mb)}
        sb = box(8.0 - 2.0 * f, -3.0, 1.0, 0.0, 1.0, 0.5, 0.5, ts)
        sb["label"] = "sign"
        info[static_id] = {"lidar_box": sb, "camera_box": dict(sb)}
        track_info[f"{f:06d}"] = info
        track_camera_visible[f"{f:06d}"] = {
            c: [moving_id, static_id] for c in range(NUM_CAMS)}
        mov_frames.append(f)
        mov_boxes.append(mb)

    def traj_entry(boxes, frames, label, stationary):
        poses_vehicle = []
        for b in boxes:
            p = np.eye(4, dtype=np.float32)
            c, s = np.cos(b["heading"]), np.sin(b["heading"])
            p[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            p[:3, 3] = [b["center_x"], b["center_y"], b["center_z"]]
            poses_vehicle.append(p)
        return {
            "label": label,
            "height": max(b["height"] for b in boxes),
            "width": max(b["width"] for b in boxes),
            "length": max(b["length"] for b in boxes),
            "poses_vehicle": np.stack(poses_vehicle),
            "timestamps": [b["timestamp"] for b in boxes],
            "frames": frames, "speeds": [1.0] * len(frames),
            "symmetric": label != "pedestrian",
            "deformable": label == "pedestrian",
            "stationary": stationary,
        }

    trajectory[moving_id] = traj_entry(mov_boxes, mov_frames, "vehicle",
                                       stationary=False)
    trajectory[static_id] = traj_entry(
        [track_info[f"{f:06d}"][static_id]["lidar_box"]
         for f in range(num_frames)],
        mov_frames, "sign", stationary=True)

    os.makedirs(os.path.join(d, "track"), exist_ok=True)
    for name, obj in (("track_info", track_info),
                      ("track_camera_visible", track_camera_visible),
                      ("trajectory", trajectory)):
        with open(os.path.join(d, "track", f"{name}.pkl"), "wb") as fh:
            pickle.dump(obj, fh)
    with open(os.path.join(d, "track", "track_ids.json"), "w") as fh:
        json.dump({moving_id: 0, static_id: 1}, fh)

    # images + masks + depth
    for f in range(num_frames):
        for c in (range(NUM_CAMS) if image_cameras is None
                  else image_cameras):
            img = rng.integers(0, 255, (IMG_H_, IMG_W_, 3), dtype=np.uint8)
            _write_png(os.path.join(d, "images", f"{f:06d}_{c}.png"), img)
            sky = np.zeros((IMG_H_, IMG_W_), np.uint8)
            sky[: IMG_H_ // 4] = 255
            _write_png(os.path.join(d, "sky_mask", f"{f:06d}_{c}.png"), sky)
            dyn = np.zeros((IMG_H_, IMG_W_), np.uint8)
            dyn[IMG_H_ // 2:, IMG_W_ // 3: 2 * IMG_W_ // 3] = 255
            _write_png(os.path.join(d, "dynamic_mask", f"{f:06d}_{c}.png"),
                       dyn)
            mask = np.zeros((IMG_H_, IMG_W_), bool)
            mask[IMG_H_ // 2:, :] = True
            value = rng.uniform(2.0, 50.0, mask.sum()).astype(np.float32)
            np.savez_compressed(
                _ensure(os.path.join(d, "lidar", "depth", f"{f:06d}_{c}.npz")),
                mask=mask, value=value)

    # LiDAR plys: background ground plane + walls (world frame),
    # actor points in canonical box frame
    for f in range(num_frames):
        gx = rng.uniform(-5 + 2 * f, 25 + 2 * f, 4000)
        gy = rng.uniform(-8, 8, 4000)
        ground = np.stack([gx, gy, np.zeros_like(gx)], -1)
        wall = np.stack([rng.uniform(-5 + 2 * f, 25 + 2 * f, 1000),
                         np.full(1000, 8.0), rng.uniform(0, 4, 1000)], -1)
        pts = np.concatenate([ground, wall]).astype(np.float32)
        cols = rng.uniform(0.2, 1.0, (len(pts), 3)).astype(np.float32)
        msk = np.ones(len(pts), bool)
        write_ply(os.path.join(d, "lidar", "background", f"{f:06d}.ply"),
                  pts, cols, msk)

        for tid, length, width, height in (
                (moving_id, 4.5, 2.0, 1.8), (static_id, 0.5, 0.5, 1.0)):
            apts = rng.uniform(-0.5, 0.5, (100, 3)).astype(np.float32)
            apts *= np.array([length, width, height], np.float32)
            acols = rng.uniform(0.2, 1.0, (100, 3)).astype(np.float32)
            write_ply(os.path.join(d, "lidar", "actor", tid,
                                   f"{f:06d}.ply"),
                      apts, acols, np.ones(100, bool))

    return d


def _ensure(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def trained_like_pool_arrays(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Gaussian pool with post-densification statistics, as numpy arrays in
    ``GaussianPool`` field order (the numpy builder of ``bench.py``'s
    ``build_trained_like_scene``, same draws from the same seed): street
    geometry (ground plane + facades + clutter) in an OpenCV camera frame
    looking down +z, heavy-tailed log-normal anisotropic scales, bimodal
    opacities, random rotations, SH degree 3."""
    rng = np.random.default_rng(seed)
    n_ground = n // 2
    n_wall = n // 3
    n_scatter = n - n_ground - n_wall
    ground = np.stack([rng.uniform(-40, 40, n_ground),
                       1.6 + rng.normal(0, 0.05, n_ground),
                       rng.uniform(2, 120, n_ground)], -1)
    walls = np.stack([rng.choice([-10.0, -7.0, 7.0, 10.0], n_wall)
                      + rng.normal(0, 0.3, n_wall),
                      rng.uniform(-8, 1.6, n_wall),
                      rng.uniform(2, 120, n_wall)], -1)
    scatter = np.stack([rng.uniform(-15, 15, n_scatter),
                        rng.uniform(-3, 1.6, n_scatter),
                        rng.uniform(2, 100, n_scatter)], -1)
    xyz = np.concatenate([ground, walls, scatter]).astype(np.float32)

    base = np.exp(rng.normal(np.log(0.04), 1.0, (n, 1))).astype(np.float32)
    base = np.clip(base, 0.005, 4.0)
    aniso = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    aniso[np.arange(n), rng.integers(0, 3, n)] *= 0.25
    scaling = np.log(base * aniso).astype(np.float32)

    hi = rng.normal(3.0, 1.0, n)
    lo = rng.normal(-2.0, 1.0, n)
    opacity = np.where(rng.random(n) < 0.7, hi, lo).astype(np.float32)[:, None]

    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)

    n_coef = (3 + 1) ** 2
    feat_dc = rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32)
    feat_rest = rng.normal(0, 0.05, (n, n_coef - 1, 3)).astype(np.float32)
    return {"xyz": xyz, "features_dc": feat_dc, "features_rest": feat_rest,
            "scaling": scaling, "rotation": quat, "opacity": opacity,
            "valid": np.ones(n, bool)}
