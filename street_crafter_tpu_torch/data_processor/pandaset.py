"""PandaSet offline LiDAR condition rendering, lane shifts included (port of
``street_crafter_tpu/data_processor/pandaset.py``; the reference's
pandaset_render_lidar_pcd.py:30-240).

Aggregate per-frame world-frame background clouds and canonical actor
clouds over +-``delta_frames`` frames, pose the actors by their
timestamp-interpolated instance poses (in-box filter in the canonical
frame), shift the camera's c2w sideways and splat the cloud into the camera
on ``device`` (``PointCloudProcessor._splat``:
``ops.point_raster.render_pointcloud_gaussian``, kernels A, the pack and B
on CUDA). ``PandaSetScene`` moves the scene's clouds to the device once
and aggregates them there. Writes
``lidar_forward/color_render[_shift_{s:.2f}]/{frame:03d}_{cam}.png`` and
``_mask.png`` with the port's PNG writer and, when asked, a
preview video per (camera, shift), which needs imageio.

CLI: python -m street_crafter_tpu_torch.data_processor.pandaset \\
    --root DATA_ROOT --scenes 001 011 [--cams 0] [--shifts 0 2 3] \\
    [--device cuda] [--preview]
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import torch

from ..datasets import pandaset_layout as layout
from ..utils.ply import read_ply
from ..utils.png import write_png
from .range_images import points_in_box, transform_points


def read_lidar_ply(lidar_dir: str) -> dict:
    """Per-frame world-frame background + canonical actor clouds, [N, 6]
    xyz-rgb float32 (pandaset_render_lidar_pcd.py:32-71)."""
    out: dict = {"background": {}}
    bkgd_dir = os.path.join(lidar_dir, "background")
    for name in sorted(os.listdir(bkgd_dir)):
        if not name.endswith(".ply"):
            continue
        frame = layout.image_filename_to_frame(name)
        pc = read_ply(os.path.join(bkgd_dir, name))
        m = pc.mask if pc.mask is not None else np.ones(len(pc.points), bool)
        rgb = pc.colors[m] if pc.colors is not None else \
            np.full((int(m.sum()), 3), 0.5, np.float32)
        out["background"][frame] = np.concatenate([pc.points[m], rgb], -1)

    actor_dir = os.path.join(lidar_dir, "actor")
    if os.path.isdir(actor_dir):
        for tid in os.listdir(actor_dir):
            per = {}
            tdir = os.path.join(actor_dir, tid)
            for name in sorted(os.listdir(tdir)):
                if not name.endswith(".ply") or name == "full.ply":
                    continue
                frame = layout.image_filename_to_frame(name)
                pc = read_ply(os.path.join(tdir, name))
                m = pc.mask if pc.mask is not None else \
                    np.ones(len(pc.points), bool)
                if m.sum() == 0:
                    continue
                rgb = pc.colors[m] if pc.colors is not None else \
                    np.full((int(m.sum()), 3), 0.5, np.float32)
                per[frame] = np.concatenate([pc.points[m], rgb], -1)
            out[tid] = per
    return out


def _cat(parts: list):
    return torch.cat(parts) if isinstance(parts[0], torch.Tensor) \
        else np.concatenate(parts)


def make_lidar_ply(ply_dict: dict, start: int, end: int) -> dict:
    """The clouds of frames ``start`` to ``end`` (inclusive), concatenated
    per part (numpy arrays or tensors, as given)."""
    out = {}
    bkgd = [ply_dict["background"][f] for f in range(start, end + 1)
            if f in ply_dict["background"]]
    out["background"] = _cat(bkgd)
    for tid, per in ply_dict.items():
        if tid == "background":
            continue
        plys = [per[f] for f in range(start, end + 1) if f in per]
        if plys:
            out[tid] = _cat(plys)
    return out


def pose_actor_ply(ply, obj_info: dict,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """In-box filter (canonical frame) then transform to world
    (pandaset_render_lidar_pcd.py:107-124); [M, 6] float32 on
    ``device``."""
    p = ply if isinstance(ply, torch.Tensor) else torch.as_tensor(ply)
    p = p.to(device)
    pose = torch.as_tensor(np.asarray(obj_info["pose"], np.float64),
                           device=p.device)
    # box_size order is (length, width, height) in the canonical frame
    inside = points_in_box(p[:, :3], np.zeros(3), 0.0,
                           np.asarray(obj_info["box"]), device=p.device)
    p = p[inside]
    xyz = transform_points(p[:, :3].to(torch.float64), pose).to(torch.float32)
    return torch.cat([xyz, p[:, 3:].to(torch.float32)], -1)


class PandaSetScene:
    """One processed PandaSet scene's condition inputs: its cameras, actor
    tracks and timestamps on the host, its LiDAR clouds moved to
    ``device`` once (aggregated there)."""

    def __init__(self, datadir: str, device: str | torch.device = "cuda"):
        from ..datasets.waymo import png_size
        self.datadir = datadir
        self.device = torch.device(device)
        self.timestamps = layout.load_timestamps(datadir)
        self.cam_poses, self.intrinsics = layout.load_camera_info(datadir)
        _, self.instances_info = layout.load_track(datadir)
        self.lidar_dir = os.path.join(datadir, "lidar_forward")
        self.ply_dict = {
            part: {f: torch.as_tensor(a).to(self.device)
                   for f, a in per.items()}
            for part, per in read_lidar_ply(self.lidar_dir).items()}
        self.num_frames = self.cam_poses.shape[0]
        scene_idx = os.path.basename(os.path.normpath(datadir))
        self.sign = layout.LANE_SHIFT_SIGN[scene_idx]
        self.sizes = {}
        for cam in range(self.cam_poses.shape[1]):
            img0 = os.path.join(datadir, "images", f"{0:03d}_{cam}.png")
            self.sizes[cam] = (png_size(img0)[::-1] if os.path.exists(img0)
                               else (layout.IMAGE_HEIGHT, layout.IMAGE_WIDTH))

    def cloud(self, cam: int, frame: int,
              delta_frames: int = 10) -> torch.Tensor:
        """[N, 6] xyz-rgb of frames frame +- delta_frames: the background
        and each actor posed at the camera's timestamp."""
        start = max(0, frame - delta_frames)
        end = min(self.num_frames - 1, frame + delta_frames)
        agg = make_lidar_ply(self.ply_dict, start, end)
        parts = [agg.pop("background")]
        box_ts = self.timestamps[layout.CAM2NAME[0]]
        cam_ts = self.timestamps[layout.CAM2NAME[cam]]
        for tid, ply in agg.items():
            info = self.instances_info[str(tid)]["frame_annotations"]
            obj = layout.get_obj_info(info, box_ts, cam_ts[frame])
            if obj is not None:
                parts.append(pose_actor_ply(ply, obj, device=self.device))
        return torch.cat(parts)

    def camera(self, cam: int, frame: int, shift: float):
        """The camera of (cam, frame) moved ``shift`` m sideways (c2w, K,
        height, width)."""
        c2w = self.cam_poses[frame, cam].copy()
        direction = layout.get_lane_shift_direction(self.cam_poses, cam,
                                                    frame)
        c2w[:2, 3] += self.sign * shift * direction[:2]
        h, w = self.sizes[cam]
        return types.SimpleNamespace(c2w=c2w, K=self.intrinsics[cam],
                                     height=h, width=w)


def _splatter(device):
    """A ``PointCloudProcessor`` that only splats, on ``device``."""
    from .pointcloud import PointCloudProcessor
    splatter = PointCloudProcessor.__new__(PointCloudProcessor)
    splatter.device = torch.device(device)
    return splatter


def render_scene_conditions(datadir: str,
                            cams: list[int] = (0,),
                            shifts: list[float] = (0.0, 2.0, 3.0),
                            delta_frames: int = 10,
                            scale: float = 0.01,
                            skip_existing: bool = True,
                            save_video_preview: bool = False,
                            device: str | torch.device = "cuda",
                            frames: list[int] | None = None) -> list[str]:
    """Render the condition PNG pairs of one scene (``frames``: default
    every frame); returns the rgb PNG paths written."""
    scene = PandaSetScene(datadir, device)
    splatter = _splatter(scene.device)
    written = []
    for cam in cams:
        for shift in sorted(set(float(s) for s in shifts)):
            tag = "color_render" if shift == 0 else \
                f"color_render_shift_{shift:.2f}"
            save_dir = os.path.join(scene.lidar_dir, tag)
            os.makedirs(save_dir, exist_ok=True)
            preview = []
            for frame in (range(scene.num_frames) if frames is None
                          else frames):
                rgb_path = os.path.join(save_dir, f"{frame:03d}_{cam}.png")
                mask_path = os.path.join(save_dir,
                                         f"{frame:03d}_{cam}_mask.png")
                if skip_existing and os.path.exists(rgb_path) \
                        and os.path.exists(mask_path):
                    continue
                rgb, acc = splatter._splat(
                    scene.cloud(cam, frame, delta_frames),
                    scene.camera(cam, frame, shift), scale,
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


def prepare_meta(root_dir: str, scene_names: list[str],
                 save_name: str = "meta_info_train.json",
                 num_frames: int = 25, stride: int = 5,
                 cam: int = 0, shifts: list[float] | None = None) -> str:
    """pandaset_prepare_meta.py analog: 25-frame windows over
    lidar_forward/color_render*."""
    metas = []
    for scene in scene_names:
        scene_dir = os.path.join(root_dir, scene)
        image_dir = os.path.join(scene_dir, "images")
        total = len([f for f in os.listdir(image_dir)
                     if f.endswith(f"_{cam}.png")])
        render_dirs = ["color_render"]
        if shifts:
            render_dirs += [f"color_render_shift_{s:.2f}" for s in shifts]
        for rd in render_dirs:
            lidar_dir = os.path.join(scene_dir, "lidar_forward", rd)
            if not os.path.isdir(lidar_dir):
                continue
            for start in range(0, total, stride):
                end = start + num_frames
                if end >= total:
                    continue
                sample = {"frames": [], "guidances": [], "guidances_mask": []}
                ok = True
                for f in range(start, end):
                    img = os.path.join(image_dir, f"{f:03d}_{cam}.png")
                    gd = os.path.join(lidar_dir, f"{f:03d}_{cam}.png")
                    gm = os.path.join(lidar_dir, f"{f:03d}_{cam}_mask.png")
                    if not all(map(os.path.exists, (img, gd, gm))):
                        ok = False
                        break
                    sample["frames"].append(os.path.relpath(img, root_dir))
                    sample["guidances"].append(os.path.relpath(gd, root_dir))
                    sample["guidances_mask"].append(
                        os.path.relpath(gm, root_dir))
                if ok:
                    metas.append(sample)
    out = os.path.join(root_dir, save_name)
    with open(out, "w") as f:
        json.dump(metas, f, indent=1)
    return out


def main(argv: list[str] | None = None) -> list[str]:
    import argparse
    p = argparse.ArgumentParser(description="pandaset condition render")
    p.add_argument("--root", required=True)
    p.add_argument("--scenes", nargs="+", required=True)
    p.add_argument("--cams", nargs="+", type=int, default=[0])
    p.add_argument("--shifts", nargs="+", type=float, default=[0.0, 2.0, 3.0])
    p.add_argument("--delta-frames", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--preview", action="store_true",
                   help="a preview video per camera and shift (imageio)")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)
    written = []
    for scene in args.scenes:
        written += render_scene_conditions(
            os.path.join(args.root, scene), cams=args.cams,
            shifts=args.shifts, delta_frames=args.delta_frames,
            skip_existing=not args.force, save_video_preview=args.preview,
            device=args.device)
    return written


if __name__ == "__main__":
    main()
