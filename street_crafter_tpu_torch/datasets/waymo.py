"""Waymo processed-scene parser → SceneInfo.

Copy of ``street_crafter_tpu/datasets/waymo.py``.

Behavioral analog of street_gaussian/datasets/waymo_readers.py:17-192 +
street_gaussian/utils/waymo_utils.py:21-263 (dataparser outputs: calibration,
centered ego poses, per-camera timestamp-interpolated object tracklets) and
street_gaussian/utils/novel_view_utils.py:30-122 (lane-shift novel-view
cameras). Host-side numpy only; no global config — callers pass explicit
arguments (the entry layer maps the config tree onto them).
"""

from __future__ import annotations

import dataclasses
import os
from glob import glob

import numpy as np

from . import waymo_layout as layout
from .readers import CameraInfo, SceneInfo, get_nerfpp_norm, get_val_frames


def png_size(path: str) -> tuple[int, int]:
    """(width, height) from the PNG IHDR without decoding the image."""
    import struct
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"not a PNG: {path}")
    w, h = struct.unpack(">II", head[16:24])
    return int(w), int(h)


def rotz_quat(heading: np.ndarray) -> np.ndarray:
    """wxyz quaternion of a rotation about +z by `heading` (radians)."""
    heading = np.asarray(heading, np.float64)
    q = np.zeros(heading.shape + (4,))
    q[..., 0] = np.cos(heading / 2)
    q[..., 3] = np.sin(heading / 2)
    return q


def rotmat_to_quat_np(m: np.ndarray) -> np.ndarray:
    """Batched rotation matrix [.., 3, 3] → wxyz quaternion (numpy host path;
    same convention as ops.quaternion.from_matrix)."""
    m = np.asarray(m, np.float64)
    t = np.trace(m, axis1=-2, axis2=-1)
    q = np.empty(m.shape[:-2] + (4,))
    # four candidate solutions, pick by largest pivot for stability
    q0 = np.stack([
        1.0 + t,
        m[..., 2, 1] - m[..., 1, 2],
        m[..., 0, 2] - m[..., 2, 0],
        m[..., 1, 0] - m[..., 0, 1]], -1)
    q1 = np.stack([
        m[..., 2, 1] - m[..., 1, 2],
        1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
        m[..., 0, 1] + m[..., 1, 0],
        m[..., 0, 2] + m[..., 2, 0]], -1)
    q2 = np.stack([
        m[..., 0, 2] - m[..., 2, 0],
        m[..., 0, 1] + m[..., 1, 0],
        1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
        m[..., 1, 2] + m[..., 2, 1]], -1)
    q3 = np.stack([
        m[..., 1, 0] - m[..., 0, 1],
        m[..., 0, 2] + m[..., 2, 0],
        m[..., 1, 2] + m[..., 2, 1],
        1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)
    cands = np.stack([q0, q1, q2, q3], -2)        # [..., 4, 4]
    pivot = np.argmax(cands[..., (0, 1, 2, 3), (0, 1, 2, 3)], axis=-1)
    q = np.take_along_axis(cands, pivot[..., None, None].repeat(4, -1),
                           axis=-2)[..., 0, :]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@dataclasses.dataclass
class ObjectInfo:
    """Per-actor metadata (waymo_utils.py:69-85)."""
    id: int               # dense index into the tracklet tensor
    object_id: int        # stable id from track_ids.json
    track_id: str
    klass: str
    class_label: int
    height: float
    width: float
    length: float
    deformable: bool
    start_frame: int
    end_frame: int


def build_object_tracklets(datadir: str, selected_frames: tuple[int, int],
                           cameras: list[int], box_scale: float = 1.0):
    """Visible, non-stationary actors and their per-frame vehicle-space boxes.

    Returns (tracklets [F, A, 5] = (x, y, z, heading, valid), obj_info list),
    mirroring get_obj_pose_tracking (waymo_utils.py:47-104).
    """
    track_info, track_camera_visible, trajectory = layout.load_track(datadir)
    object_ids = layout.load_track_ids(datadir)
    start, end = selected_frames
    num_frames = end - start + 1

    visible: set[str] = set()
    for frame in range(start, end + 1):
        per_cam = track_camera_visible[f"{frame:06d}"]
        for cam in cameras:
            visible.update(per_cam[cam])
    track_ids = sorted(t for t in visible if not trajectory[t]["stationary"])

    obj_info = []
    for i, track_id in enumerate(track_ids):
        traj = trajectory[track_id]
        frames = traj["frames"]
        obj_info.append(ObjectInfo(
            id=i, object_id=object_ids[track_id], track_id=track_id,
            klass=traj["label"],
            class_label=layout.TRACK2LABEL.get(traj["label"], -1),
            height=traj["height"], width=traj["width"] * box_scale,
            length=traj["length"] * box_scale,
            deformable=traj["deformable"],
            start_frame=min(frames), end_frame=max(frames)))

    A = max(len(obj_info), 1)
    tracklets = -np.ones((num_frames, A, 5))
    for fi, frame in enumerate(range(start, end + 1)):
        info_frame = track_info[f"{frame:06d}"]
        for obj in obj_info:
            if not (obj.start_frame <= frame <= obj.end_frame):
                continue
            if obj.track_id not in info_frame:
                continue
            box = info_frame[obj.track_id]["lidar_box"]
            tracklets[fi, obj.id] = [box["center_x"], box["center_y"],
                                     box["center_z"], box["heading"], 1.0]
    return tracklets, obj_info


def build_camera_tracklets(tracklets: np.ndarray, obj_info: list[ObjectInfo],
                           ego_frame_poses: np.ndarray,
                           cams: list[int], frames: list[int],
                           frames_idx: list[int],
                           cams_timestamps: np.ndarray,
                           tracklet_timestamps: np.ndarray,
                           num_cams: int) -> np.ndarray:
    """[num_cams, F, A, 8] world-frame actor poses (x y z qw qx qy qz valid)
    per camera, interpolating (x, y, z, heading) between the two tracklet
    timestamps nearest to each camera's shutter time
    (waymo_utils.py:183-232)."""
    F = tracklets.shape[0]
    A = max(len(obj_info), 1)
    out = -np.ones((num_cams, F, A, 8))
    if not obj_info:
        return out

    valid_frames = {o.id: np.flatnonzero(tracklets[:, o.id, -1] == 1)
                    for o in obj_info}

    for cam, frame, fi, ts in zip(cams, frames, frames_idx, cams_timestamps):
        ego = ego_frame_poses[frame]
        for obj in obj_info:
            if not (obj.start_frame <= frame <= obj.end_frame):
                continue
            idx = valid_frames[obj.id]
            if idx.shape[0] == 0:
                continue
            if idx.shape[0] == 1:
                pose = tracklets[idx[0], obj.id, :4]
            else:
                order = np.argsort(np.abs(tracklet_timestamps[idx] - ts))
                i1, i2 = idx[order[0]], idx[order[1]]
                t1, t2 = tracklet_timestamps[i1], tracklet_timestamps[i2]
                alpha = (ts - t2) / (t1 - t2)
                pose = (alpha * tracklets[i1, obj.id, :4]
                        + (1 - alpha) * tracklets[i2, obj.id, :4])
            # object pose in world = ego_pose ∘ (Rz(heading), txyz)
            c, s = np.cos(pose[3]), np.sin(pose[3])
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            world_rot = ego[:3, :3] @ rot
            world_trans = ego[:3, :3] @ pose[:3] + ego[:3, 3]
            out[cam, fi, obj.id, :3] = world_trans
            out[cam, fi, obj.id, 3:7] = rotmat_to_quat_np(world_rot)
            out[cam, fi, obj.id, 7] = 1.0
    return out


def read_waymo_scene(datadir: str,
                     cameras: list[int] = (0, 1, 2),
                     selected_frames: tuple[int, int] | None = None,
                     split_test: int = -1,
                     split_train: int = -1,
                     box_scale: float = 1.0,
                     load_guidance: bool = True,
                     novel_view_shifts: list[float] = (2.0, 3.0),
                     train_actor_distance_thresh: float = 1.5,
                     extent: float | None = None,
                     use_novel_view_cameras: bool = True,
                     mode: str = "train") -> SceneInfo:
    """Parse a processed Waymo scene directory into SceneInfo
    (readWaymoInfo, waymo_readers.py:17-192)."""
    cameras = list(cameras)
    image_files = sorted(glob(os.path.join(datadir, "images", "*.png")))
    num_frames_all = len(image_files) // 5
    if selected_frames is None or selected_frames[0] < 0:
        selected_frames = (0, num_frames_all - 1)
    start, end = selected_frames
    num_frames = end - start + 1

    intrinsics, extrinsics, ego_frame_poses, ego_cam_poses = \
        layout.load_camera_info(datadir)
    timestamps = layout.load_timestamps(datadir)

    tracklet_timestamps = np.array(
        [timestamps[layout.LABEL2CAMERA[0]][f"{f:06d}"]
         for f in range(start, end + 1)], np.float64)

    frames, frames_idx, cams, files, cams_ts = [], [], [], [], []
    exts, ixts, poses = [], [], []
    for path in image_files:
        name = os.path.basename(path)
        frame = layout.image_filename_to_frame(name)
        cam = layout.image_filename_to_cam(name)
        if not (start <= frame <= end and cam in cameras):
            continue
        frames.append(frame)
        frames_idx.append(frame - start)
        cams.append(cam)
        files.append(path)
        exts.append(extrinsics[cam])
        ixts.append(intrinsics[cam])
        poses.append(ego_cam_poses[cam, frame])
        cams_ts.append(timestamps[layout.LABEL2CAMERA[cam]][f"{frame:06d}"])

    cams_ts = np.array(cams_ts, np.float64)
    ts_offset = min(cams_ts.min(), tracklet_timestamps.min())
    cams_ts -= ts_offset
    tracklet_timestamps -= ts_offset

    tracklets, obj_info = build_object_tracklets(
        datadir, (start, end), cameras, box_scale)
    camera_tracklets = build_camera_tracklets(
        tracklets, obj_info, ego_frame_poses, cams, frames, frames_idx,
        cams_ts, tracklet_timestamps, num_cams=5)

    train_frames, test_frames = get_val_frames(
        num_frames,
        test_every=split_test if split_test > 0 else None,
        train_every=split_train if split_train > 0 else None)

    guidance_dir = os.path.join(datadir, "lidar", "color_render")
    cam_infos = []
    for i in range(len(files)):
        c2w = poses[i] @ exts[i]
        w2c = np.linalg.inv(c2w)
        name = os.path.basename(files[i]).split(".")[0]
        width, height = png_size(files[i])
        metadata = {
            "frame": frames[i], "cam": cams[i], "frame_idx": frames_idx[i],
            "ego_pose": poses[i], "extrinsic": exts[i],
            "timestamp": float(cams_ts[i]),
            "is_val": frames_idx[i] in test_frames,
            "is_novel_view": False,
            "guidance_rgb_path": os.path.join(
                guidance_dir, f"{frames[i]:06d}_{cams[i]}.png"),
            "guidance_mask_path": os.path.join(
                guidance_dir, f"{frames[i]:06d}_{cams[i]}_mask.png"),
        }
        guidance = {}
        if load_guidance:
            dyn = os.path.join(datadir, "dynamic_mask", f"{name}.png")
            if os.path.exists(dyn):
                guidance["obj_bound_path"] = dyn
            if mode == "train":
                depth = os.path.join(datadir, "lidar", "depth", f"{name}.npz")
                if os.path.exists(depth):
                    guidance["lidar_depth_path"] = depth
                sky = os.path.join(datadir, "sky_mask", f"{name}.png")
                if os.path.exists(sky):
                    guidance["sky_mask_path"] = sky
        cam_infos.append(CameraInfo(
            uid=i, R=w2c[:3, :3].T, T=w2c[:3, 3],
            K=np.asarray(ixts[i], np.float64).copy(),
            width=width, height=height, image_path=files[i], image_name=name,
            metadata=metadata, guidance=guidance))

    train_cams = [c for c in cam_infos if not c.metadata["is_val"]]
    test_cams = [c for c in cam_infos if c.metadata["is_val"]]

    novel_cams = []
    if use_novel_view_cameras:
        novel_cams = waymo_novel_view_cameras(
            cam_infos, ego_frame_poses, obj_info, camera_tracklets,
            datadir=datadir, shifts=list(novel_view_shifts), mode=mode,
            train_actor_distance_thresh=train_actor_distance_thresh)

    norm = get_nerfpp_norm(novel_cams if mode == "novel_view" else train_cams)
    norm["radius"] = max(norm["radius"], 10.0)
    if extent:
        norm["radius"] = float(extent)

    metadata = {
        "camera_tracklets": camera_tracklets,
        "obj_meta": obj_info,
        "num_images": len(cam_infos),
        "num_cams": len(cameras),
        "num_frames": num_frames,
        "start_frame": start,
        "ego_frame_poses": ego_frame_poses,
        "camera_timestamps": {
            c: sorted(float(cams_ts[i]) for i in range(len(cams))
                      if cams[i] == c) for c in cameras},
        "tracklet_timestamps": tracklet_timestamps,
        "scene_center": norm["center"],
        "scene_radius": float(norm["radius"]),
        "datadir": datadir,
        "cameras": cameras,
    }
    return SceneInfo(train_cameras=train_cams, test_cameras=test_cams,
                     metadata=metadata, novel_view_cameras=novel_cams)


def waymo_novel_view_cameras(cam_infos: list[CameraInfo],
                             ego_frame_poses: np.ndarray,
                             obj_info: list[ObjectInfo],
                             camera_tracklets: np.ndarray,
                             datadir: str,
                             shifts: list[float],
                             mode: str = "train",
                             train_actor_distance_thresh: float = 1.5,
                             ) -> list[CameraInfo]:
    """Lane-shifted FRONT-camera trajectories (novel_view_utils.py:30-122).

    The ego pose is translated laterally (perpendicular to ego motion) by
    `shift * LANE_SHIFT_SIGN[scene]` meters; cameras passing within
    `train_actor_distance_thresh` of a tracked actor are flagged
    `skip_camera`.
    """
    scene_idx = os.path.basename(os.path.normpath(datadir))
    sign = layout.LANE_SHIFT_SIGN[scene_idx]
    if mode == "train":
        shifts = [s for s in shifts if s != 0]

    fronts = [c for c in cam_infos if c.metadata["cam"] == 0]
    out = []
    for shift in shifts:
        tag = f"_shift_{shift:.2f}" if shift != 0 else ""
        novel_dir = os.path.join(datadir, "lidar", f"color_render{tag}")
        for base in fronts:
            frame = base.metadata["frame"]
            frame_idx = base.metadata["frame_idx"]
            ego = np.asarray(base.metadata["ego_pose"]).copy()
            direction = layout.get_lane_shift_direction(ego_frame_poses, frame)
            ego[:3, 3] += direction * shift * sign

            c2w = ego @ base.metadata["extrinsic"]
            w2c = np.linalg.inv(c2w)
            metadata = dict(base.metadata)
            metadata.update({
                "is_novel_view": True,
                "novel_view_id": shift,
                "ego_pose": ego,
                "guidance_rgb_path": os.path.join(
                    novel_dir, f"{frame:06d}_0.png"),
                "guidance_mask_path": os.path.join(
                    novel_dir, f"{frame:06d}_0_mask.png"),
            })

            R, T = w2c[:3, :3].T, w2c[:3, 3]
            # skip cameras nearly coincident with an actor (":102-116")
            skip = False
            for obj in obj_info:
                tr = camera_tracklets[0, frame_idx, obj.id]
                if tr[-1] < 0:
                    continue
                depth = (R.T @ tr[:3] + T)[2]
                if abs(depth) < train_actor_distance_thresh:
                    skip = True
                break
            metadata["skip_camera"] = skip

            out.append(dataclasses.replace(
                base, R=R, T=T, metadata=metadata, guidance={},
                image_name=f"{base.image_name}{tag}"))
    return sorted(out, key=lambda c: c.uid)
