"""Scene-init point clouds and the LiDAR condition renders (port of
``street_crafter_tpu/data_processor/pointcloud.py``).

Per-frame LiDAR clouds are loaded host-side (numpy), aggregated and written
as ``input_ply/points3D_{lidar,bkgd,obj_*,sky}.ply``. The condition render
of a camera aggregates the clouds of +-``delta_frames`` frames, poses the
actors by the frame's boxes and splats them on the processor's device
(``ops.point_raster``: kernels A, the pack and B on CUDA), then writes the
rgb and mask PNGs. Point counts are not padded.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..datasets import waymo_layout as layout
from ..datasets.waymo import ObjectInfo, png_size
from ..ops.point_raster import render_pointcloud_gaussian
from ..utils.ply import (read_ply, remove_radius_outliers, voxel_downsample,
                         write_ply)
from ..utils.png import PngWriter, read_png, write_png

FLIP_AXIS = 1


def project_visible_np(points: np.ndarray, K: np.ndarray, w2c: np.ndarray,
                       H: int, W: int) -> np.ndarray:
    """Visibility mask of world/vehicle points in a pinhole camera
    (graphics_utils.project_numpy analog)."""
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = K[0, 0] * cam[:, 0] / z + K[0, 2]
        v = K[1, 1] * cam[:, 1] / z + K[1, 2]
    return (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)


def box_pose(box: dict) -> np.ndarray:
    """[4, 4] pose of a LiDAR box: its heading about z, then its centre."""
    c, s = np.cos(box["heading"]), np.sin(box["heading"])
    pose = np.eye(4)
    pose[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    pose[:3, 3] = [box["center_x"], box["center_y"], box["center_z"]]
    return pose


def sphere_norm(points: np.ndarray) -> tuple[np.ndarray, float]:
    """Center + bounding radius (base_readers.get_Sphere_Norm analog)."""
    center = points.mean(axis=0)
    radius = float(np.linalg.norm(points - center, axis=-1).max() * 1.1)
    return center, radius


class PointCloudProcessor:
    """Base: aggregation, posing, scene-init ply writing, condition renders
    on ``device``."""

    def __init__(self, datadir: str, cameras=(0, 1, 2),
                 selected_frames: tuple[int, int] | None = None,
                 delta_frames: int = 10, device: str = "cuda"):
        self.datadir = datadir
        self.device = torch.device(device)
        self.cams = list(cameras)
        self.delta_frames = delta_frames
        (self.intrinsics, self.extrinsics, self.ego_frame_poses,
         self.ego_cam_poses) = layout.load_camera_info(datadir)
        self.track_info, self.track_camera_visible, self.trajectory = \
            layout.load_track(datadir)
        if selected_frames is None or selected_frames[0] < 0:
            n = len(self.ego_frame_poses)
            selected_frames = (0, n - 1)
        self.start_frame, self.end_frame = selected_frames
        self.sphere_center = np.zeros(3)
        self.sphere_radius = 1.0
        self.ply_dict = self.read_lidar_ply()

    # -- loading -------------------------------------------------------------
    def read_lidar_ply(self) -> dict:
        """Per-frame background clouds (vehicle→world) with per-camera
        visibility, and per-actor canonical-frame clouds with symmetry-flip
        densification for rigid actors (waymo_processor.py:41-116)."""
        out: dict = {"background": {}, "background_visible": {}}
        bkgd_dir = os.path.join(self.datadir, "lidar", "background")
        for name in sorted(os.listdir(bkgd_dir)):
            if not name.endswith(".ply") or name == "full.ply":
                continue
            frame = layout.image_filename_to_frame(name)
            if not (self.start_frame <= frame <= self.end_frame):
                continue
            pc = read_ply(os.path.join(bkgd_dir, name))
            m = pc.mask if pc.mask is not None else np.ones(len(pc.points), bool)
            xyz_vehicle = pc.points[m]
            rgb = pc.colors[m] if pc.colors is not None else \
                np.ones_like(xyz_vehicle) * 0.5
            ego = self.ego_frame_poses[frame]
            xyz_world = xyz_vehicle @ ego[:3, :3].T + ego[:3, 3]
            out["background"][frame] = np.concatenate([xyz_world, rgb], -1)

            visible = np.zeros(len(xyz_vehicle), bool)
            for cam in self.cams:
                w2c = np.linalg.inv(self.extrinsics[cam])
                H, W = self._image_size(cam)
                visible |= project_visible_np(
                    xyz_vehicle, self.intrinsics[cam], w2c, H, W)
            out["background_visible"][frame] = visible

        actor_dir = os.path.join(self.datadir, "lidar", "actor")
        if os.path.isdir(actor_dir):
            for track_id in os.listdir(actor_dir):
                per_frame = {}
                tdir = os.path.join(actor_dir, track_id)
                for name in sorted(os.listdir(tdir)):
                    if not name.endswith(".ply") or name == "full.ply":
                        continue
                    frame = layout.image_filename_to_frame(name)
                    pc = read_ply(os.path.join(tdir, name))
                    m = pc.mask if pc.mask is not None else \
                        np.ones(len(pc.points), bool)
                    if m.sum() == 0:
                        continue
                    xyz = pc.points[m]
                    rgb = pc.colors[m] if pc.colors is not None else \
                        np.ones_like(xyz) * 0.5
                    traj = self.trajectory.get(track_id) \
                        if self.trajectory else None
                    if traj is not None and not traj["deformable"]:
                        xyz, rgb = self._symmetry_flip(xyz, rgb)
                    per_frame[frame] = np.concatenate([xyz, rgb], -1)
                out[track_id] = per_frame
        return out

    @staticmethod
    def _symmetry_flip(xyz: np.ndarray, rgb: np.ndarray):
        """Mirror the denser side across the canonical symmetry axis
        (waymo_processor.py:97-110)."""
        pos = xyz[:, FLIP_AXIS] > 0
        part = pos if pos.sum() >= (~pos).sum() else ~pos
        xyz_flip = xyz[part].copy()
        xyz_flip[:, FLIP_AXIS] *= -1
        return (np.concatenate([xyz, xyz_flip]),
                np.concatenate([rgb, rgb[part]]))

    def _image_size(self, cam: int) -> tuple[int, int]:
        path = os.path.join(self.datadir, "images",
                            f"{self.start_frame:06d}_{cam}.png")
        if os.path.exists(path):
            w, h = png_size(path)
            return h, w
        return layout.IMAGE_HEIGHTS[cam], layout.IMAGE_WIDTHS[cam]

    def make_lidar_ply(self, start_frame: int, end_frame: int,
                       actor_ids: list[str]) -> dict:
        """Aggregate background + per-actor clouds over a frame window
        (base_processor.py:32-56)."""
        out = {}
        bkgd = [self.ply_dict["background"][f]
                for f in range(start_frame, end_frame + 1)
                if f in self.ply_dict["background"]]
        out["background"] = np.concatenate(bkgd)
        for actor_id in actor_ids:
            if actor_id not in self.ply_dict:
                continue
            plys = [self.ply_dict[actor_id][f]
                    for f in range(start_frame, end_frame + 1)
                    if f in self.ply_dict[actor_id]]
            if plys:
                out[actor_id] = np.concatenate(plys)
        return out

    @staticmethod
    def transform_lidar_ply(ply: np.ndarray, pose: np.ndarray) -> np.ndarray:
        xyz = ply[:, :3] @ pose[:3, :3].T + pose[:3, 3]
        return np.concatenate([xyz, ply[:, 3:]], -1)

    # -- scene init ------------------------------------------------------------
    def initialize_ply(self, model_dir: str, objects_info: list[ObjectInfo],
                       voxel_size: float = 0.1, outlier_points: int = 10,
                       outlier_radius: float = 0.5,
                       colmap_points: tuple[np.ndarray, np.ndarray] | None = None,
                       ) -> dict[str, str]:
        """Write input_ply/points3D_{lidar,bkgd,obj_*,sky}.ply
        (base_processor.py:65-131 + waymo_processor.py:126-176).
        Returns path dict."""
        out_dir = os.path.join(model_dir, "input_ply")
        os.makedirs(out_dir, exist_ok=True)
        paths: dict[str, str] = {}

        actor_ids = [o.track_id for o in objects_info]
        agg = self.make_lidar_ply(self.start_frame, self.end_frame, actor_ids)

        bkgd = agg.pop("background")
        visible = np.concatenate(
            [self.ply_dict["background_visible"][f]
             for f in range(self.start_frame, self.end_frame + 1)
             if f in self.ply_dict["background_visible"]])
        bkgd = bkgd[visible]
        xyz, rgb = voxel_downsample(bkgd[:, :3], bkgd[:, 3:6], voxel_size)
        keep = remove_radius_outliers(xyz, outlier_points, outlier_radius)
        xyz, rgb = xyz[keep], rgb[keep]
        paths["lidar"] = os.path.join(out_dir, "points3D_lidar.ply")
        write_ply(paths["lidar"], xyz, rgb)

        self.sphere_center, self.sphere_radius = sphere_norm(xyz)

        if colmap_points is not None:
            cxyz, crgb = colmap_points
            dist = np.linalg.norm(cxyz - self.sphere_center, axis=-1)
            m = dist < 2 * self.sphere_radius
            paths["colmap"] = os.path.join(out_dir, "points3D_colmap.ply")
            write_ply(paths["colmap"], cxyz, crgb)
            bkgd_xyz = np.concatenate([xyz, cxyz[m]])
            bkgd_rgb = np.concatenate([rgb, crgb[m]])
        else:
            bkgd_xyz, bkgd_rgb = xyz, rgb
        paths["bkgd"] = os.path.join(out_dir, "points3D_bkgd.ply")
        write_ply(paths["bkgd"], bkgd_xyz, bkgd_rgb)

        for obj in objects_info:
            if obj.track_id not in agg:
                continue
            ply = agg[obj.track_id]
            p = os.path.join(out_dir, f"points3D_obj_{obj.object_id:03d}.ply")
            write_ply(p, ply[:, :3], ply[:, 3:6])
            paths[f"obj_{obj.object_id:03d}"] = p

        sky_path = self._initialize_sky_ply(out_dir)
        if sky_path:
            paths["sky"] = sky_path
        return paths

    def _initialize_sky_ply(self, out_dir: str,
                            background_sphere_points: int = 50000,
                            distance_scale: float = 2.5) -> str | None:
        """Sample sky pixels, shoot rays onto an enlarged scene sphere
        (waymo_processor.py:126-176)."""
        sky_dir = os.path.join(self.datadir, "sky_mask")
        sky_path = os.path.join(out_dir, "points3D_sky.ply")
        if not os.path.isdir(sky_dir):
            return None
        if os.path.exists(sky_path):
            return sky_path
        n_imgs = len(self.cams) * (self.end_frame - self.start_frame + 1)
        num_samples = max(background_sphere_points // max(n_imgs, 1), 1)
        rng = np.random.default_rng(0)

        pts, cols = [], []
        for name in sorted(os.listdir(sky_dir)):
            if not name.endswith(".png"):
                continue
            frame = layout.image_filename_to_frame(name)
            cam = layout.image_filename_to_cam(name)
            if not (self.start_frame <= frame <= self.end_frame
                    and cam in self.cams):
                continue
            sky = read_png(os.path.join(sky_dir, name))
            if sky.ndim == 3:
                sky = sky[..., 0]
            flat = (sky > 0).reshape(-1)
            idx = np.flatnonzero(flat)
            if idx.size == 0:
                continue
            if idx.size > num_samples:
                idx = rng.choice(idx, num_samples, replace=False)

            img = read_png(os.path.join(self.datadir, "images", name)
                           ).astype(np.float32)[..., :3] / 255.0
            H, W = img.shape[:2]
            K = self.intrinsics[cam]
            c2w = self.ego_frame_poses[frame] @ self.extrinsics[cam]
            ys, xs = np.divmod(idx, W)
            dirs_cam = np.stack([
                (xs + 0.5 - K[0, 2]) / K[0, 0],
                (ys + 0.5 - K[1, 2]) / K[1, 1],
                np.ones_like(xs, np.float64)], -1)
            dirs = dirs_cam @ c2w[:3, :3].T
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            origin = c2w[:3, 3]
            # ray-sphere: |o + t d - c| = R, take the far root
            oc = origin - self.sphere_center
            radius = self.sphere_radius * distance_scale
            b = (dirs * oc).sum(-1)
            disc = b * b - ((oc * oc).sum() - radius * radius)
            t = -b + np.sqrt(np.maximum(disc, 0.0))
            pts.append(origin + t[:, None] * dirs)
            cols.append(img.reshape(-1, 3)[idx])

        if not pts:
            return None
        write_ply(sky_path, np.concatenate(pts), np.concatenate(cols))
        return sky_path

    # -- condition rendering ---------------------------------------------------
    def render_condition(self, camera, objects_info: list[ObjectInfo],
                         scale: float = 0.01, use_ndc_scale: bool = True,
                         force: bool = False,
                         png: PngWriter | None = None) -> None:
        """Render and save the LiDAR condition rgb and mask PNGs of one
        CameraInfo (waymo_processor.py:178-242), unless both exist and not
        ``force``; through ``png`` when given (its ``close`` waits for
        them)."""
        rgb_path = camera.metadata["guidance_rgb_path"]
        mask_path = camera.metadata["guidance_mask_path"]
        if (os.path.exists(rgb_path) and os.path.exists(mask_path)
                and not force):
            return
        rgb, acc = self._splat(self.condition_cloud(camera, objects_info),
                               camera, scale, use_ndc_scale)
        write = write_png if png is None else png.write
        write(rgb_path, (rgb * 255).astype(np.uint8))
        write(mask_path, (acc * 255).astype(np.uint8))

    def condition_cloud(self, camera, objects_info: list[ObjectInfo]
                        ) -> np.ndarray:
        """[N, 6] xyz-rgb world cloud of a camera's condition render: the
        background of +-``delta_frames`` frames and the actors of its frame
        posed by their LiDAR boxes."""
        frame = camera.metadata["frame"]
        start = max(self.start_frame, frame - self.delta_frames)
        end = min(self.end_frame, frame + self.delta_frames)
        actor_ids = [o.track_id for o in objects_info
                     if o.start_frame <= frame <= o.end_frame]
        agg = self.make_lidar_ply(start, end, actor_ids)
        parts = [agg.pop("background")]

        track_info_frame = self.track_info[f"{frame:06d}"]
        for actor_id, ply in agg.items():
            if actor_id not in track_info_frame:
                continue
            box = track_info_frame[actor_id]["lidar_box"]
            pose = np.asarray(camera.metadata["ego_pose"]) @ box_pose(box)
            parts.append(self.transform_lidar_ply(ply, pose))
        return np.concatenate(parts)

    def _splat(self, ply: np.ndarray, camera, scale: float,
               use_ndc_scale: bool) -> tuple[np.ndarray, np.ndarray]:
        """(rgb [H, W, 3], acc [H, W]) of an [N, 6] xyz-rgb cloud seen by
        ``camera`` (c2w, K, height, width), splatted as Gaussians
        (``ops.point_raster.render_pointcloud_gaussian``). The cloud may be
        a tensor (already on the device)."""
        def t(a):
            if isinstance(a, torch.Tensor):
                return a.to(self.device, torch.float32).contiguous()
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=self.device)

        out = render_pointcloud_gaussian(
            t(camera.c2w), t(camera.K), t(ply[:, :3]), t(ply[:, 3:6]),
            camera.height, camera.width, scale=scale,
            use_ndc_scale=use_ndc_scale)
        return out.rgb.cpu().numpy(), out.acc.cpu().numpy()

    def render_conditions(self, cameras, objects_info, **kw) -> None:
        """``render_condition`` of each camera; the PNGs are written on
        worker threads and are on disk when it returns."""
        with PngWriter() as png:
            for cam in cameras:
                self.render_condition(cam, objects_info, png=png, **kw)


class WaymoPointCloudProcessor(PointCloudProcessor):
    """Waymo layout specialization (waymo_processor.py:19-39)."""
