"""Waymo processed-scene on-disk layout (loaders + constants).

Copy of ``street_crafter_tpu/datasets/waymo_layout.py``.

The scene-directory contract produced by the offline processor
(data_processor/README.md:37-180): images/{frame:06d}_{cam}.png,
ego_pose/*.txt, extrinsics/{cam}.txt, intrinsics/{cam}.txt,
track/{track_info,track_camera_visible,trajectory}.pkl + track_ids.json,
timestamps.json, lidar/{background,actor,depth,color_render*}, dynamic_mask/,
sky_mask/. Loader behavior mirrors
data_processor/waymo_processor/waymo_helpers.py.
"""

from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict

import numpy as np

CAMERA_NAMES = ("FRONT", "FRONT_LEFT", "FRONT_RIGHT", "SIDE_LEFT", "SIDE_RIGHT")
CAMERA2LABEL = {n: i for i, n in enumerate(CAMERA_NAMES)}
LABEL2CAMERA = {i: n for i, n in enumerate(CAMERA_NAMES)}
IMAGE_HEIGHTS = (1280, 1280, 1280, 886, 886)
IMAGE_WIDTHS = (1920, 1920, 1920, 1920, 1920)
TRACK2LABEL = {"vehicle": 0, "pedestrian": 1, "cyclist": 2, "sign": 3, "misc": -1}

# per-scene lane-shift sign table (waymo_helpers.py:32-52)
LANE_SHIFT_SIGN: dict[str, int] = defaultdict(lambda: -1)
LANE_SHIFT_SIGN.update({
    "173": 1, "176": 1, "159": -1, "140": -1, "121": -1, "101": 1,
    "096": -1, "090": -1, "079": -1, "067": 1, "062": -1, "051": -1,
    "049": -1, "035": -1, "027": -1, "020": -1,
})


def image_filename_to_frame(name: str) -> int:
    return int(name.split(".")[0][:6])


def image_filename_to_cam(name: str) -> int:
    return int(name.split(".")[0][-1])


def load_camera_info(datadir: str):
    """intrinsics [5][3,3], extrinsics cam->ego [5][4,4], centered
    ego_frame_poses [F,4,4] and ego_cam_poses [5,F,4,4]
    (waymo_helpers.py:150-190)."""
    intrinsics, extrinsics = [], []
    for i in range(5):
        vals = np.loadtxt(os.path.join(datadir, "intrinsics", f"{i}.txt"))
        fx, fy, cx, cy = vals[0], vals[1], vals[2], vals[3]
        intrinsics.append(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]))
        extrinsics.append(np.loadtxt(os.path.join(datadir, "extrinsics", f"{i}.txt")))

    ego_dir = os.path.join(datadir, "ego_pose")
    ego_frame_poses = []
    ego_cam_poses = [[] for _ in range(5)]
    for name in sorted(os.listdir(ego_dir)):
        pose = np.loadtxt(os.path.join(ego_dir, name))
        if "_" not in name:
            ego_frame_poses.append(pose)
        else:
            ego_cam_poses[image_filename_to_cam(name)].append(pose)

    ego_frame_poses = np.array(ego_frame_poses)
    center = ego_frame_poses[:, :3, 3].mean(axis=0)
    ego_frame_poses[:, :3, 3] -= center
    ego_cam_poses = np.array([np.array(p) for p in ego_cam_poses])
    ego_cam_poses[:, :, :3, 3] -= center
    return intrinsics, extrinsics, ego_frame_poses, ego_cam_poses


def load_track(datadir: str):
    """(track_info, track_camera_visible, trajectory) pickles + ids json
    (waymo_helpers.py:78-104)."""
    track_dir = os.path.join(datadir, "track")
    with open(os.path.join(track_dir, "track_info.pkl"), "rb") as f:
        track_info = pickle.load(f)
    with open(os.path.join(track_dir, "track_camera_visible.pkl"), "rb") as f:
        track_camera_visible = pickle.load(f)
    with open(os.path.join(track_dir, "trajectory.pkl"), "rb") as f:
        trajectory = pickle.load(f)
    return track_info, track_camera_visible, trajectory


def load_track_ids(datadir: str) -> dict:
    with open(os.path.join(datadir, "track", "track_ids.json")) as f:
        return json.load(f)


def load_timestamps(datadir: str) -> dict:
    with open(os.path.join(datadir, "timestamps.json")) as f:
        return json.load(f)


def get_lane_shift_direction(ego_frame_poses: np.ndarray, frame: int) -> np.ndarray:
    """Unit lateral direction (perpendicular to ego motion, z=0)
    (waymo_helpers.py:272-282)."""
    if frame == 0:
        delta = ego_frame_poses[1][:3, 3] - ego_frame_poses[0][:3, 3]
    else:
        delta = ego_frame_poses[frame][:3, 3] - ego_frame_poses[frame - 1][:3, 3]
    d = delta[:2] / np.linalg.norm(delta[:2])
    return np.array([d[1], -d[0], 0.0])
