"""PandaSet processed-scene on-disk layout (loaders + constants); port of
``street_crafter_tpu/datasets/pandaset_layout.py``.

Analog of data_processor/pandaset_processor/pandaset_helpers.py: the
processed layout differs from Waymo — cameras store per-(frame, cam) c2w
matrices directly (no ego poses), tracks live in instances json files with
slerp-interpolated world poses, LiDAR dirs are named ``lidar_forward``.
``slerp_pose`` interpolates with the port's ``ops/quaternion.py`` in
float32 on the CPU, as the JAX package does with its own quaternion ops.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np

CAMERA_NAMES = ("front_camera", "front_left_camera", "front_right_camera",
                "left_camera", "right_camera", "back_camera")
CAM2NAME = {i: n for i, n in enumerate(CAMERA_NAMES)}
NUM_FRAMES = 80
NUM_CAMS = 6
IMAGE_HEIGHT, IMAGE_WIDTH = 1080, 1920

NONRIGID_CLASSES = ("Pedestrian", "Pedestrian with Object", "Bicycle",
                    "Animals - Other")
RIGID_CLASSES = (
    "Bus", "Car", "Emergency Vehicle", "Medium-sized Truck", "Motorcycle",
    "Motorized Scooter", "Other Vehicle - Construction Vehicle",
    "Other Vehicle - Pedicab", "Other Vehicle - Uncommon",
    "Personal Mobility Device", "Pickup Truck", "Semi-truck", "Train",
    "Tram / Subway")
DYNAMIC_CLASSES = NONRIGID_CLASSES + RIGID_CLASSES

LANE_SHIFT_SIGN: dict[str, int] = defaultdict(lambda: -1)
LANE_SHIFT_SIGN.update({"001": -1, "011": 1, "016": 1, "053": -1,
                        "158": -1})


def image_filename_to_frame(name: str) -> int:
    return int(name.split(".")[0][:3])


def image_filename_to_cam(name: str) -> int:
    return int(name.split(".")[0][-1])


def load_camera_info(datadir: str, num_frames: int | None = None,
                     num_cams: int | None = None):
    """(cam_poses [F, C, 4, 4] c2w, intrinsics [C][3,3])
    (pandaset_helpers.py:84-101). Dims auto-detected from the calibration
    files when not given (the reference hardcodes 80 frames / 6 cams)."""
    if num_cams is None:
        num_cams = len([f for f in os.listdir(
            os.path.join(datadir, "intrinsics")) if f.endswith(".txt")])
    if num_frames is None:
        frames = {image_filename_to_frame(f) for f in os.listdir(
            os.path.join(datadir, "extrinsics")) if f.endswith(".txt")}
        num_frames = max(frames) + 1
    intrinsics = []
    for i in range(num_cams):
        vals = np.loadtxt(os.path.join(datadir, "intrinsics", f"{i}.txt"))
        fx, fy, cx, cy = vals[0], vals[1], vals[2], vals[3]
        intrinsics.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]))
    poses = np.stack([
        np.stack([np.loadtxt(os.path.join(datadir, "extrinsics",
                                          f"{f:03d}_{c}.txt"))
                  for c in range(num_cams)])
        for f in range(num_frames)])
    return poses, intrinsics


def load_track(datadir: str):
    """(frame_instances, instances_info) json pair
    (pandaset_helpers.py:103-113)."""
    inst = os.path.join(datadir, "instances")
    with open(os.path.join(inst, "frame_instances.json")) as f:
        frame_instances = json.load(f)
    with open(os.path.join(inst, "instances_info.json")) as f:
        instances_info = json.load(f)
    return frame_instances, instances_info


def load_timestamps(datadir: str) -> dict:
    with open(os.path.join(datadir, "timestamps.json")) as f:
        return json.load(f)


def slerp_pose(pose_a: np.ndarray, pose_b: np.ndarray,
               alpha: float) -> np.ndarray:
    """Interpolate two [.,4] poses: slerp rotation + lerp translation, with
    the reference's convention pose = a*alpha + b*(1-alpha)
    (pandaset_helpers.py:116-125)."""
    import torch

    from ..ops import quaternion as Q
    from .waymo import rotmat_to_quat_np
    def quat(pose):
        return torch.as_tensor(rotmat_to_quat_np(pose[:3, :3]),
                               dtype=torch.float32)
    q = Q.slerp(quat(pose_b), quat(pose_a),
                torch.tensor(alpha, dtype=torch.float32))
    out = np.eye(4)
    out[:3, :3] = Q.to_matrix(q).numpy()
    out[:3, 3] = alpha * pose_a[:3, 3] + (1 - alpha) * pose_b[:3, 3]
    return out


def get_obj_info(frame_annotations: dict, box_timestamps,
                 timestamp: float) -> dict | None:
    """Timestamp-interpolated world pose + box size of one actor
    (pandaset_helpers.py:127-166). None when outside its lifetime."""
    idxs = frame_annotations["frame_idx"]
    poses = frame_annotations["obj_to_world"]
    sizes = frame_annotations["box_size"]
    ts = np.asarray(box_timestamps)[idxs]

    if ts[0] <= timestamp <= ts[-1]:
        if len(ts) > 1:
            order = np.argsort(np.abs(ts - timestamp))
            i1, i2 = order[0], order[1]
            p1 = np.eye(4)
            p1[:3, :4] = np.array(poses[i1], np.float64)[:3, :4]
            p2 = np.eye(4)
            p2[:3, :4] = np.array(poses[i2], np.float64)[:3, :4]
            alpha = (ts[i2] - timestamp) / (ts[i2] - ts[i1])
            pose = slerp_pose(p1, p2, alpha)
            box = (np.array(sizes[i1]) * alpha
                   + np.array(sizes[i2]) * (1 - alpha))
        else:
            pose = np.array(poses[0], np.float64)
            box = np.array(sizes[0], np.float64)
    elif ts[0] - 0.1 <= timestamp < ts[0]:
        pose, box = np.array(poses[0], np.float64), np.array(sizes[0])
    elif ts[-1] < timestamp <= ts[-1] + 0.1:
        pose, box = np.array(poses[-1], np.float64), np.array(sizes[-1])
    else:
        return None
    p4 = np.eye(4)
    p4[:3, :4] = np.asarray(pose)[:3, :4]
    return {"pose": p4, "box": np.asarray(box, np.float64)}


def get_lane_shift_direction(cam_poses: np.ndarray, cam: int,
                             frame: int) -> np.ndarray:
    """Right-orthogonal of the camera velocity
    (pandaset_helpers.py:169-177)."""
    poses = cam_poses[:, cam]
    vel = poses[1:, :3, 3] - poses[:-1, :3, 3]
    vel = np.concatenate([vel, vel[-1:]], axis=0)
    d = vel[frame] / np.linalg.norm(vel[frame])
    right = np.cross(d, np.array([0.0, 0.0, 1.0]))
    return right / np.linalg.norm(right)
