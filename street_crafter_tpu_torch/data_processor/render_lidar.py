"""Offline LiDAR condition rendering, lane shifts included (port of
``street_crafter_tpu/data_processor/render_lidar.py``; the reference's
waymo_render_lidar_pcd.py:164-304).

For every (camera, shift, frame): aggregate the coloured LiDAR cloud over
+-``delta_frames`` frames, pose the actors by the frame's box (the
camera-synced box at shift 0, to align with the training images; the LiDAR
box otherwise), shift the camera's ego pose sideways and splat the cloud
into the camera on ``device`` (``PointCloudProcessor._splat``: kernels A,
the pack and B on CUDA). Writes the rgb and mask PNGs to
``lidar/color_render[_shift_{s:.2f}]/`` and, when asked, a preview video
per (camera, shift), which needs imageio. ``render_many`` renders several
scenes, in turn or in spawned worker processes, one scene each at a time
(waymo_render_lidar_pcd.py:145-156).

CLI: python -m street_crafter_tpu_torch.data_processor.render_lidar \\
    --root DATA_ROOT --scenes 016 049 [--cams 0] [--shifts 0 2 3] \\
    [--device cuda] [--workers N] [--preview]
"""

from __future__ import annotations

import os
import types

import numpy as np

from ..datasets import waymo_layout as layout
from ..utils.png import write_png
from .pointcloud import WaymoPointCloudProcessor, box_pose


def render_scene_conditions(datadir: str, cams: list[int] = (0,),
                            shifts: list[float] = (0.0, 2.0, 3.0),
                            delta_frames: int = 10, scale: float = 0.01,
                            skip_existing: bool = True,
                            save_video_preview: bool = False,
                            device: str = "cuda") -> list[str]:
    """Render every condition image of one scene; returns the rgb PNG
    paths written."""
    proc = WaymoPointCloudProcessor(datadir, cameras=list(cams),
                                    delta_frames=delta_frames, device=device)
    num_frames = len(proc.ego_frame_poses)
    scene_idx = os.path.basename(os.path.normpath(datadir))
    sign = layout.LANE_SHIFT_SIGN[scene_idx]
    written = []
    for cam in cams:
        H, W = proc._image_size(cam)
        K = proc.intrinsics[cam]
        for shift in sorted({float(s) for s in shifts}):
            tag = "color_render" if shift == 0 else \
                f"color_render_shift_{shift:.2f}"
            save_dir = os.path.join(datadir, "lidar", tag)
            preview = []
            for frame in range(num_frames):
                rgb_path = os.path.join(save_dir, f"{frame:06d}_{cam}.png")
                mask_path = os.path.join(save_dir,
                                         f"{frame:06d}_{cam}_mask.png")
                if skip_existing and os.path.exists(rgb_path) \
                        and os.path.exists(mask_path):
                    continue
                start = max(0, frame - delta_frames)
                end = min(num_frames - 1, frame + delta_frames)
                track_info_frame = proc.track_info[f"{frame:06d}"]
                agg = proc.make_lidar_ply(start, end,
                                          list(track_info_frame.keys()))
                parts = [agg.pop("background")]
                ego_pose = proc.ego_cam_poses[cam, frame]
                for track_id, ply in agg.items():
                    boxes = track_info_frame[track_id]
                    box = (boxes.get("camera_box") or boxes["lidar_box"]) \
                        if shift == 0 else boxes["lidar_box"]
                    parts.append(proc.transform_lidar_ply(
                        ply, ego_pose @ box_pose(box)))
                ego_shift = ego_pose.copy()
                direction = layout.get_lane_shift_direction(
                    proc.ego_frame_poses, frame)
                ego_shift[:3, 3] += sign * direction * shift
                camera = types.SimpleNamespace(
                    c2w=ego_shift @ proc.extrinsics[cam], K=K, height=H,
                    width=W)
                rgb, acc = proc._splat(np.concatenate(parts), camera, scale,
                                       use_ndc_scale=True)
                rgb8 = (rgb * 255).astype(np.uint8)
                write_png(rgb_path, rgb8)
                write_png(mask_path, (acc * 255).astype(np.uint8))
                written.append(rgb_path)
                if save_video_preview:
                    preview.append(rgb8)
            if preview:
                from ..visualizers import save_video
                save_video(os.path.join(save_dir, f"render_rgb_{cam}.mp4"),
                           preview)
    return written


def render_many(root: str, scenes: list[str], num_workers: int = 1,
                **kw) -> list[str]:
    """``render_scene_conditions(root/scene, **kw)`` for every scene: in
    this process, or over ``num_workers`` spawned processes (each builds
    its own processor; on one card they share it). Returns the rgb PNG
    paths written, scene by scene."""
    dirs = [os.path.join(root, s) for s in scenes]
    if num_workers <= 1:
        written = []
        for d in dirs:
            print(f"rendering conditions: {d}")
            written += render_scene_conditions(d, **kw)
        return written
    import multiprocessing as mp
    with mp.get_context("spawn").Pool(num_workers) as pool:
        parts = pool.starmap(_render_one_kw, [(d, kw) for d in dirs])
    return [p for part in parts for p in part]


def _render_one_kw(datadir: str, kw: dict) -> list[str]:
    return render_scene_conditions(datadir, **kw)


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    p = argparse.ArgumentParser(description="offline LiDAR condition render")
    p.add_argument("--root", required=True)
    p.add_argument("--scenes", nargs="+", required=True)
    p.add_argument("--cams", nargs="+", type=int, default=[0])
    p.add_argument("--shifts", nargs="+", type=float,
                   default=[0.0, 2.0, 3.0])
    p.add_argument("--delta-frames", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--preview", action="store_true",
                   help="a preview video per camera and shift (imageio)")
    p.add_argument("--workers", type=int, default=1,
                   help="scenes rendered at once, one process each")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    return render_many(args.root, args.scenes, num_workers=args.workers,
                       cams=args.cams, shifts=args.shifts,
                       delta_frames=args.delta_frames,
                       skip_existing=not args.force,
                       save_video_preview=args.preview, device=args.device)


if __name__ == "__main__":
    main()
