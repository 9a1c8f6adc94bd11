"""Host-side scene assembly: SceneInfo + input plys -> SceneParams/SceneMeta
(port of ``street_crafter_tpu/models/gs/build.py``).

Pools are built from the scene-init plys at ``optim.capacity_*``; actors are
stacked into one [A, cap_obj, ...] pool; tracklets become SceneMeta tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...config import Config
from ...datasets.cameras import Camera
from ...datasets.readers import CameraInfo, SceneInfo
from ...utils.ply import read_ply
from ...utils.png import read_png
from .color_mlp import init_color_mlp
from .params import GaussianPool, init_pool_from_points, stack_pools
from .scene import SceneMeta, SceneParams

def build_scene_meta(info: SceneInfo, fourier_scale: float = 1.0,
                     device: torch.device | str = "cpu") -> SceneMeta:
    """Tracklet tensors [C, F, A, ...] -> SceneMeta."""
    tr = np.asarray(info.metadata["camera_tracklets"])  # [C, F, A, 8]
    C, F, A, _ = tr.shape
    ts = np.zeros((C, F), np.float64)
    for cam, stamps in info.metadata["camera_timestamps"].items():
        ts[cam, : len(stamps)] = stamps
    ranges = np.zeros((A, 2), np.float32)
    bboxes = np.ones((A, 3), np.float32)
    for o in info.metadata["obj_meta"]:
        ranges[o.id] = (o.start_frame, o.end_frame)
        bboxes[o.id] = (o.length, o.width, o.height)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return SceneMeta(
        track_trans=t(tr[..., :3].astype(np.float32)),
        track_quats=t(tr[..., 3:7].astype(np.float32)),
        track_valid=t(tr[..., 7] > 0, torch.bool),
        timestamps=t(ts.astype(np.float32)),
        actor_frame_range=t(ranges), actor_bbox=t(bboxes),
        fourier_scale=float(fourier_scale))


def _grid_init_points(bbox: np.ndarray, points_dim: int = 20,
                      seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Random-colour regular grid filling the actor bbox (used when an actor
    has < 2000 LiDAR points)."""
    lin = np.linspace(-1.0, 1.0, points_dim)
    gx, gy, gz = np.meshgrid(lin, lin, lin)
    xyz = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1) * (bbox / 2.0)
    rgb = np.random.default_rng(seed).random(xyz.shape).astype(np.float32)
    return xyz.astype(np.float32), rgb


def build_actor_pools(info: SceneInfo, ply_paths: dict[str, str], cfg: Config,
                      device: torch.device | str = "cpu"
                      ) -> tuple[GaussianPool | None, np.ndarray | None]:
    """Stacked per-actor pool [A, cap_obj, ...] in canonical frames, plus a
    per-actor grid-initialization flag."""
    obj_meta = info.metadata["obj_meta"]
    if not obj_meta:
        return None, None
    cap = int(cfg.optim.capacity_obj)
    pools, random_init = [], []
    for obj in sorted(obj_meta, key=lambda o: o.id):
        key = f"obj_{obj.object_id:03d}"
        pts = rgb = None
        if key in ply_paths:
            pc = read_ply(ply_paths[key])
            if len(pc.points) >= 2000:
                pts, rgb = pc.points, pc.colors
        random_init.append(pts is None)
        if pts is None:
            bbox = np.array([obj.length, obj.width, obj.height], np.float32)
            pts, rgb = _grid_init_points(bbox, seed=obj.id)
        pools.append(init_pool_from_points(
            pts, rgb if rgb is not None else np.full_like(pts, 0.5),
            capacity=cap, sh_degree=cfg.model.gaussian.sh_degree,
            fourier_dim=cfg.model.gaussian.fourier_dim, device=device))
    return stack_pools(pools), np.asarray(random_init, bool)


def _pool_from_ply(path: str, capacity: int, sh_degree: int,
                   device) -> GaussianPool:
    pc = read_ply(path)
    colors = pc.colors if pc.colors is not None \
        else np.full_like(pc.points, 0.5)
    return init_pool_from_points(pc.points, colors, capacity=capacity,
                                 sh_degree=sh_degree, device=device)


def build_meta(info: SceneInfo, ply_paths: dict[str, str], cfg: Config,
               device: torch.device | str = "cpu") -> SceneMeta:
    """SceneMeta plus the LiDAR scene sphere of points3D_lidar.ply that the
    sky pool is pinned against."""
    meta = build_scene_meta(info, cfg.model.gaussian.fourier_scale, device)
    sphere_src = ply_paths.get("lidar") or ply_paths.get("bkgd")
    if sphere_src:
        from ...data_processor.pointcloud import sphere_norm
        center, radius = sphere_norm(read_ply(sphere_src).points)
        meta = dataclasses.replace(
            meta,
            sphere_center=torch.tensor(np.asarray(center, np.float32),
                                       device=device),
            sphere_radius=torch.tensor(float(radius), dtype=torch.float32,
                                       device=device))
    return meta


def build_scene_params(info: SceneInfo, ply_paths: dict[str, str],
                       cfg: Config, device: torch.device | str = "cpu"
                       ) -> tuple[SceneParams, SceneMeta]:
    """Assemble all trainable leaves of the scene."""
    sh_degree = cfg.model.gaussian.sh_degree
    meta = build_meta(info, ply_paths, cfg, device)

    bkgd = None
    if cfg.model.nsg.include_bkgd and "bkgd" in ply_paths:
        bkgd = _pool_from_ply(ply_paths["bkgd"],
                              int(cfg.optim.capacity_bkgd), sh_degree, device)

    actors = None
    if cfg.model.nsg.include_obj:
        actors, random_init = build_actor_pools(info, ply_paths, cfg, device)
        if random_init is not None:
            meta = dataclasses.replace(meta, actor_random_init=torch.tensor(
                random_init, device=device))

    sky = sky_cubemap = None
    if cfg.model.nsg.include_sky:
        if cfg.model.sky.use_cube_map:
            # the cubemap replaces the Gaussian sky pool
            r = int(cfg.model.sky.resolution)
            sky_cubemap = torch.full((6, r, r, 3), 0.5, device=device)
        elif "sky" in ply_paths:
            sky = _pool_from_ply(ply_paths["sky"],
                                 int(cfg.optim.capacity_sky), sh_degree,
                                 device)

    opt_trans = opt_theta = None
    if cfg.model.nsg.opt_track and actors is not None:
        C, F, A = meta.track_valid.shape
        opt_trans = torch.zeros((C, F, A, 3), device=device)
        opt_theta = torch.zeros((C, F, A, 1), device=device)

    color_corr = color_corr_sky = color_mlp = color_mlp_sky = None
    cc = cfg.model.color_correction
    if cfg.model.use_color_correction and cc.get("use_mlp", False):
        # seeds 0 and 1, as the JAX package's PRNGKey(0) and PRNGKey(1)
        color_mlp = init_color_mlp(torch.Generator().manual_seed(0), device)
        if cc.use_sky:
            color_mlp_sky = init_color_mlp(torch.Generator().manual_seed(1),
                                           device)
    elif cfg.model.use_color_correction:
        n = (info.metadata["num_images"] if cc.mode == "image"
             else info.metadata["num_cams"])
        eye = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1).to(device)
        color_corr = eye[None].repeat(n, 1, 1)
        if cc.use_sky:
            color_corr_sky = eye[None].repeat(n, 1, 1)

    pose_quat = pose_trans = None
    if cfg.model.use_pose_correction:
        n = info.metadata["num_images"]
        pose_quat = torch.tensor([[1.0, 0, 0, 0]], device=device).repeat(n, 1)
        pose_trans = torch.zeros((n, 3), device=device)

    params = SceneParams(
        bkgd=bkgd, actors=actors, sky=sky, opt_trans=opt_trans,
        opt_theta=opt_theta, sky_cubemap=sky_cubemap, color_corr=color_corr,
        color_corr_sky=color_corr_sky, pose_corr_quat=pose_quat,
        pose_corr_trans=pose_trans, color_mlp=color_mlp,
        color_mlp_sky=color_mlp_sky)
    return params, meta


def _mask(path: str) -> np.ndarray:
    img = read_png(path)
    if img.ndim == 3:
        img = img[..., 0]
    return (img > 0)[..., None]


def load_guidance_arrays(cam: CameraInfo) -> dict[str, np.ndarray]:
    """Guidance images referenced by the reader, as arrays."""
    out = {}
    g = cam.guidance
    if "obj_bound_path" in g:
        out["obj_bound"] = _mask(g["obj_bound_path"])
    if "sky_mask_path" in g:
        out["sky_mask"] = _mask(g["sky_mask_path"])
    if "lidar_depth_path" in g:
        z = np.load(g["lidar_depth_path"])
        mask = z["mask"].astype(bool)
        depth = np.zeros(mask.shape, np.float32)
        depth[mask] = z["value"].astype(np.float32)
        out["lidar_depth"] = depth[..., None]
    return out


def camera_batch(cam: CameraInfo, image_hw: tuple[int, int],
                 device: torch.device | str, load_image: bool = True,
                 load_guidance: bool = True) -> dict:
    """Per-camera batch: host indices, plus the gt image and the guidance
    arrays as tensors on ``device``, at ``image_hw``, the downscaled
    camera's size (the image bilinear with antialiasing, the guidance
    nearest)."""
    batch: dict = {
        "frame_idx": int(cam.metadata["frame_idx"]),
        "frame": float(cam.metadata["frame"]),
        "cam_id": int(cam.metadata["cam"]),
        "timestamp": float(cam.metadata.get("timestamp", 0.0)),
        "image_idx": int(cam.uid),
    }
    if load_image:
        img = torch.tensor(cam.load_image(), device=device)
        if tuple(img.shape[:2]) != tuple(image_hw):
            img = torch.nn.functional.interpolate(
                img.permute(2, 0, 1)[None], size=tuple(image_hw),
                mode="bilinear", antialias=True, align_corners=False
            )[0].permute(1, 2, 0).clamp(0.0, 1.0).contiguous()
        batch["gt_image"] = img
    if load_guidance:
        for k, v in load_guidance_arrays(cam).items():
            t = torch.tensor(v, device=device)
            if tuple(t.shape[:2]) != tuple(image_hw):
                # masks and the sparse LiDAR depth: nearest, so no value is
                # blended with its empty neighbours
                t = torch.nn.functional.interpolate(
                    t.permute(2, 0, 1)[None].to(torch.float32),
                    size=tuple(image_hw), mode="nearest")[0].permute(
                        1, 2, 0).to(t.dtype).contiguous()
            batch[k] = t
    return batch


def to_device_camera(cam: CameraInfo, downscale: float = 1.0,
                     device: torch.device | str = "cpu") -> Camera:
    """CameraInfo -> Camera on ``device`` (longer side capped at 1600 px)."""
    w2c = np.eye(4)
    w2c[:3, :3] = cam.R.T
    w2c[:3, 3] = cam.T
    c = Camera.from_extrinsic(
        w2c.astype(np.float32), cam.K, cam.width, cam.height, device=device,
        id=cam.uid, frame=cam.metadata.get("frame", -1),
        cam=cam.metadata.get("cam", 0),
        timestamp=float(cam.metadata.get("timestamp", 0.0)),
        image_name=cam.image_name)
    if downscale != 1.0:
        c = c.rescale(1.0 / downscale)
    return c


def auto_downscale(width: int, limit: int = 1600) -> float:
    """Downscale factor that caps the width at ``limit`` pixels."""
    return max(1.0, width / limit)
