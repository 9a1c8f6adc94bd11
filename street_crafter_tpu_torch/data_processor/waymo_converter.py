"""Waymo tfrecord -> processed scene directory (port of
``street_crafter_tpu/data_processor/waymo_converter.py``; the reference's
waymo_converter.py + waymo_get_lidar_pcd.py).

Extracts images, ego / camera poses and timestamps, calibration, track
pickles, dynamic masks, and per-frame colorized LiDAR clouds (background /
actor split and sparse depth) into the on-disk layout that
``datasets/waymo_layout.py`` reads.

Needs the external ``waymo-open-dataset`` package and tensorflow, as the
reference does: ``_import_wod`` raises with the missing package's name, and
every stage takes ``tf``, ``dataset_pb2`` and ``frame_utils`` as arguments,
so the rest of the port works without them. The LiDAR stage's geometry is
``range_images.lidar_frame`` on ``device`` (float64; the sparse depth by
``scatter_reduce``); the other stages copy protobuf fields to files on the
host. PNGs are written by the port's ``utils/png.py``.

CLI: python -m street_crafter_tpu_torch.data_processor.waymo_converter \\
    --tfrecord SEQ.tfrecord --out SCENE_DIR [--stages images pose calib \\
    track dynamic lidar] [--device cuda]
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np
import torch

from ..datasets.waymo_layout import CAMERA_NAMES
from ..utils.ply import write_ply
from ..utils.png import write_png
from .range_images import LidarFrame, lidar_frame

OPENCV_FROM_CAMERA = np.array([  # [forward,left,up] -> [right,down,forward]
    [0.0, 0.0, 1.0, 0.0],
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0]])

ALL_STAGES = ("images", "pose", "calib", "track", "dynamic", "lidar")


def _import_wod():
    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2
        from waymo_open_dataset.utils import frame_utils
        return tf, dataset_pb2, frame_utils
    except ImportError as e:
        raise ImportError(
            "the offline Waymo converter needs the 'waymo-open-dataset' "
            "package (+tensorflow); install it on the preprocessing host. "
            f"missing: {e.name}") from e


def _frames(tf, dataset_pb2, tfrecord: str):
    for data in tf.data.TFRecordDataset(tfrecord, compression_type=""):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        yield frame


def convert(tfrecord: str, out_dir: str,
            stages: tuple[str, ...] = ALL_STAGES,
            skip_existing: bool = True,
            device: str | torch.device = "cuda") -> None:
    tf, dataset_pb2, frame_utils = _import_wod()
    os.makedirs(out_dir, exist_ok=True)

    if "images" in stages:
        _convert_images(tf, dataset_pb2, tfrecord, out_dir, skip_existing)
    if "pose" in stages:
        _convert_poses(tf, dataset_pb2, tfrecord, out_dir, skip_existing)
    if "calib" in stages:
        _convert_calibration(tf, dataset_pb2, tfrecord, out_dir,
                             skip_existing)
    if "track" in stages:
        _convert_tracks(tf, dataset_pb2, tfrecord, out_dir, skip_existing)
    if "dynamic" in stages:
        _convert_dynamic_masks(tf, dataset_pb2, tfrecord, out_dir)
    if "lidar" in stages:
        _convert_lidar(tf, dataset_pb2, frame_utils, tfrecord, out_dir,
                       device=device)


def _convert_images(tf, dataset_pb2, tfrecord, out_dir, skip) -> None:
    """images/{frame:06d}_{cam}.png (waymo_converter.py:100-160)."""
    img_dir = os.path.join(out_dir, "images")
    if skip and os.path.isdir(img_dir):
        return
    os.makedirs(img_dir, exist_ok=True)
    for fid, frame in enumerate(_frames(tf, dataset_pb2, tfrecord)):
        for image in frame.images:
            cam = image.name - 1
            write_png(os.path.join(img_dir, f"{fid:06d}_{cam}.png"),
                      np.asarray(tf.io.decode_jpeg(image.image).numpy(),
                                 np.uint8))


def _convert_poses(tf, dataset_pb2, tfrecord, out_dir, skip) -> None:
    """ego_pose/*.txt + timestamps.json (waymo_converter.py:60-96)."""
    pose_dir = os.path.join(out_dir, "ego_pose")
    if skip and os.path.isdir(pose_dir):
        return
    os.makedirs(pose_dir, exist_ok=True)
    timestamps: dict = {"FRAME": {}}
    for name in CAMERA_NAMES:
        timestamps[name] = {}
    for fid, frame in enumerate(_frames(tf, dataset_pb2, tfrecord)):
        pose = np.array(frame.pose.transform).reshape(4, 4)
        np.savetxt(os.path.join(pose_dir, f"{fid:06d}.txt"), pose)
        timestamps["FRAME"][f"{fid:06d}"] = frame.timestamp_micros / 1e6
        for image in frame.images:
            cam = image.name - 1
            cam_pose = np.array(image.pose.transform).reshape(4, 4)
            np.savetxt(os.path.join(pose_dir, f"{fid:06d}_{cam}.txt"),
                       cam_pose)
            timestamps[CAMERA_NAMES[cam]][f"{fid:06d}"] = \
                image.pose_timestamp
    with open(os.path.join(out_dir, "timestamps.json"), "w") as f:
        json.dump(timestamps, f, indent=1)


def _convert_calibration(tf, dataset_pb2, tfrecord, out_dir, skip) -> None:
    """intrinsics/{cam}.txt + extrinsics/{cam}.txt (opencv convention,
    waymo_helpers.py:196-214)."""
    intr_dir = os.path.join(out_dir, "intrinsics")
    extr_dir = os.path.join(out_dir, "extrinsics")
    if skip and os.path.isdir(intr_dir) and os.path.isdir(extr_dir):
        return
    os.makedirs(intr_dir, exist_ok=True)
    os.makedirs(extr_dir, exist_ok=True)
    frame = next(_frames(tf, dataset_pb2, tfrecord))
    for calib in frame.context.camera_calibrations:
        cam = calib.name - 1
        np.savetxt(os.path.join(intr_dir, f"{cam}.txt"),
                   np.array(calib.intrinsic))
        cam2vehicle = np.array(calib.extrinsic.transform).reshape(4, 4)
        np.savetxt(os.path.join(extr_dir, f"{cam}.txt"),
                   cam2vehicle @ OPENCV_FROM_CAMERA)


_LABEL_NAMES = {0: "misc", 1: "vehicle", 2: "pedestrian", 3: "sign",
                4: "cyclist"}


def _box_dict(box, label: str, speed: float, ts: float) -> dict:
    return {"height": box.height, "width": box.width, "length": box.length,
            "center_x": box.center_x, "center_y": box.center_y,
            "center_z": box.center_z, "heading": box.heading,
            "label": label, "speed": speed, "timestamp": ts}


def _convert_tracks(tf, dataset_pb2, tfrecord, out_dir, skip) -> None:
    """track/{track_info,track_camera_visible,trajectory}.pkl +
    track_ids.json (waymo_converter.py:200-365)."""
    track_dir = os.path.join(out_dir, "track")
    if skip and os.path.isdir(track_dir):
        return
    os.makedirs(track_dir, exist_ok=True)

    track_info, camera_visible, trajectory_raw = {}, {}, {}
    object_ids: dict[str, int] = {}
    ego_poses = []
    for fid, frame in enumerate(_frames(tf, dataset_pb2, tfrecord)):
        ts = frame.timestamp_micros / 1e6
        ego = np.array(frame.pose.transform).reshape(4, 4)
        ego_poses.append(ego)
        cur, vis = {}, {c: [] for c in range(5)}
        for label in frame.laser_labels:
            name = _LABEL_NAMES.get(label.type, "misc")
            speed = float(np.hypot(label.metadata.speed_x,
                                   label.metadata.speed_y))
            if label.id not in object_ids:
                object_ids[label.id] = len(object_ids)
            entry = {"lidar_box": _box_dict(label.box, name, speed, ts)}
            if label.camera_synced_box.ByteSize():
                entry["camera_box"] = _box_dict(label.camera_synced_box,
                                                name, speed, ts)
            else:
                entry["camera_box"] = None
            cur[label.id] = entry
            trajectory_raw.setdefault(label.id, {})[f"{fid:06d}"] = \
                entry["lidar_box"]
        for pcl in frame.projected_lidar_labels:
            cam = pcl.name - 1
            vis[cam] = [lab.id.replace(f"_{CAMERA_NAMES[cam]}", "")
                        for lab in pcl.labels]
        track_info[f"{fid:06d}"] = cur
        camera_visible[f"{fid:06d}"] = vis

    trajectory = {}
    for tid, boxes in trajectory_raw.items():
        boxes = dict(sorted(boxes.items()))
        frames = [int(k) for k in boxes]
        label = next(iter(boxes.values()))["label"]
        poses_vehicle, poses_world, dims = [], [], []
        for k, b in boxes.items():
            c, s = np.cos(b["heading"]), np.sin(b["heading"])
            pv = np.eye(4, dtype=np.float32)
            pv[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
            pv[:3, 3] = [b["center_x"], b["center_y"], b["center_z"]]
            poses_vehicle.append(pv)
            poses_world.append((ego_poses[int(k)] @ pv).astype(np.float32))
            dims.append([b["height"], b["width"], b["length"]])
        pos_world = np.stack(poses_world)[:, :3, 3]
        distance = np.linalg.norm(pos_world[0] - pos_world[-1])
        dynamic = bool(np.any(np.std(pos_world, axis=0) > 0.5)
                       or distance > 2)
        dim = np.max(np.array(dims), axis=0)
        trajectory[tid] = {
            "label": label,
            "height": float(dim[0]), "width": float(dim[1]),
            "length": float(dim[2]),
            "poses_vehicle": np.stack(poses_vehicle),
            "timestamps": [b["timestamp"] for b in boxes.values()],
            "frames": frames,
            "speeds": [b["speed"] for b in boxes.values()],
            "symmetric": label != "pedestrian",
            "deformable": label == "pedestrian",
            "stationary": not dynamic,
        }

    for name, obj in (("track_info", track_info),
                      ("track_camera_visible", camera_visible),
                      ("trajectory", trajectory)):
        with open(os.path.join(track_dir, f"{name}.pkl"), "wb") as f:
            pickle.dump(obj, f)
    with open(os.path.join(track_dir, "track_ids.json"), "w") as f:
        json.dump(object_ids, f)


def _convert_dynamic_masks(tf, dataset_pb2, tfrecord, out_dir) -> None:
    """dynamic_mask/{frame:06d}_{cam}.png: union of projected boxes of
    moving actors (waymo_converter.py:400-470)."""
    with open(os.path.join(out_dir, "track", "trajectory.pkl"), "rb") as f:
        trajectory = pickle.load(f)
    mask_dir = os.path.join(out_dir, "dynamic_mask")
    os.makedirs(mask_dir, exist_ok=True)
    for fid, frame in enumerate(_frames(tf, dataset_pb2, tfrecord)):
        sizes = {c.name - 1: (c.height, c.width)
                 for c in frame.context.camera_calibrations}
        masks = {cam: np.zeros(sizes[cam], bool) for cam in sizes}
        for pcl in frame.projected_lidar_labels:
            cam = pcl.name - 1
            for lab in pcl.labels:
                tid = lab.id.replace(f"_{CAMERA_NAMES[cam]}", "")
                if tid in trajectory and trajectory[tid]["stationary"]:
                    continue
                b = lab.box
                y0 = int(max(b.center_y - b.width / 2, 0))
                y1 = int(min(b.center_y + b.width / 2, sizes[cam][0]))
                x0 = int(max(b.center_x - b.length / 2, 0))
                x1 = int(min(b.center_x + b.length / 2, sizes[cam][1]))
                masks[cam][y0:y1, x0:x1] = True
        for cam, m in masks.items():
            write_png(os.path.join(mask_dir, f"{fid:06d}_{cam}.png"),
                      (m * 255).astype(np.uint8))


def frame_lidars(frame, range_images: dict) -> list:
    """(range image, inclinations, extrinsic) of each laser of a frame
    with a range image, in the calibrations' order (first return, range
    channel; uniform inclinations where the calibration lists none)."""
    lidars = []
    for calib in frame.context.laser_calibrations:
        if calib.name not in range_images:
            continue
        ri = range_images[calib.name][0]  # first return
        img = np.array(ri.data).reshape(ri.shape.dims)[..., 0]
        extrinsic = np.array(calib.extrinsic.transform).reshape(4, 4)
        if len(calib.beam_inclinations) == 0:
            incl = np.linspace(calib.beam_inclination_min,
                               calib.beam_inclination_max,
                               img.shape[0])[::-1]
        else:
            incl = np.array(calib.beam_inclinations)[::-1]
        lidars.append((img, incl.copy(), extrinsic))
    return lidars


def frame_cameras(tf, frame) -> tuple[dict, dict, dict]:
    """(decoded uint8 images, intrinsics [3, 3], opencv cam2vehicle) of a
    frame's cameras, FRONT first."""
    images, intr, c2v = {}, {}, {}
    for calib in sorted(frame.context.camera_calibrations,
                        key=lambda c: c.name):
        cam = calib.name - 1
        image = [im for im in frame.images if im.name == calib.name][0]
        images[cam] = np.asarray(tf.io.decode_jpeg(image.image).numpy(),
                                 np.uint8)
        k = np.array(calib.intrinsic)
        intr[cam] = np.array([[k[0], 0, k[2]], [0, k[1], k[3]], [0, 0, 1]])
        c2v[cam] = np.array(calib.extrinsic.transform).reshape(4, 4) \
            @ OPENCV_FROM_CAMERA
    return images, intr, c2v


def write_lidar_frame(out: LidarFrame, fid: int, out_dir: str) -> None:
    """lidar/background/{frame}.ply, lidar/actor/{tid}/{frame}.ply and
    lidar/depth/{frame}_{cam}.npz of one frame."""
    def host(parts):
        return [p.cpu().numpy() for p in parts]

    lidar = os.path.join(out_dir, "lidar")
    for tid, parts in out.actors.items():
        write_ply(os.path.join(lidar, "actor", tid, f"{fid:06d}.ply"),
                  *host(parts))
    write_ply(os.path.join(lidar, "background", f"{fid:06d}.ply"),
              *host(out.background))
    os.makedirs(os.path.join(lidar, "depth"), exist_ok=True)
    for cam, (mask, value) in out.depth.items():
        np.savez_compressed(
            os.path.join(lidar, "depth", f"{fid:06d}_{cam}.npz"),
            mask=mask.cpu().numpy(), value=value.cpu().numpy())


def _convert_lidar(tf, dataset_pb2, frame_utils, tfrecord, out_dir,
                   device: str | torch.device = "cuda") -> None:
    """lidar/background/{frame}.ply + lidar/actor/{tid}/{frame}.ply +
    lidar/depth/{frame}_{cam}.npz (waymo_get_lidar_pcd.py:139-360)."""
    with open(os.path.join(out_dir, "track", "track_info.pkl"), "rb") as f:
        track_info = pickle.load(f)
    for d in ("background", "actor", "depth"):
        os.makedirs(os.path.join(out_dir, "lidar", d), exist_ok=True)

    for fid, frame in enumerate(_frames(tf, dataset_pb2, tfrecord)):
        range_images = frame_utils.parse_range_image_and_camera_projection(
            frame)[0]
        images, intr, c2v = frame_cameras(tf, frame)
        boxes = {tid: entry["lidar_box"]
                 for tid, entry in track_info[f"{fid:06d}"].items()}
        out = lidar_frame(frame_lidars(frame, range_images), images, intr,
                          c2v, boxes, device=device)
        write_lidar_frame(out, fid, out_dir)


def main(argv: list[str] | None = None) -> None:
    import argparse
    p = argparse.ArgumentParser(description="waymo tfrecord converter")
    p.add_argument("--tfrecord", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--stages", nargs="+", default=list(ALL_STAGES),
                   choices=ALL_STAGES)
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    convert(args.tfrecord, args.out, tuple(args.stages),
            skip_existing=not args.force, device=args.device)


if __name__ == "__main__":
    main()
