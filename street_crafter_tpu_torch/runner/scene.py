"""Scene orchestrator: dataset + pools + processor wired together (port of
``street_crafter_tpu/runner/scene.py``).

Reads the processed scene dir, writes or reuses the input plys (with
``data.use_colmap``, the COLMAP triangulation's points join the
background's), builds the scene tensors on ``cfg.device`` and the camera
lists. With ``init_params=False`` only the scene meta is built; the render
runner takes the parameters, at their saved sizes, from a checkpoint.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np
import torch

from ..config import Config
from ..data_processor import get_pointcloud_processor
from ..data_processor.colmap_driver import load_colmap_points, run_colmap
from ..datasets.readers import CameraInfo, SceneInfo
from ..datasets.waymo import read_waymo_scene
from ..models.gs.build import (auto_downscale, build_meta,
                               build_scene_params, camera_batch,
                               to_device_camera)
from ..models.gs.scene import SceneMeta, SceneParams


class Scene:
    def __init__(self, cfg: Config, load_images: bool = True,
                 need_processor: bool = True, init_params: bool = True):
        self.cfg = cfg
        self.device = torch.device(cfg.get("device", "cuda"))
        self.model_path = cfg.model_path or os.path.join(
            cfg.workspace, "output", cfg.task, cfg.exp_name)
        os.makedirs(self.model_path, exist_ok=True)
        if cfg.data.type.lower() != "waymo":
            raise ValueError(f"unsupported dataset type {cfg.data.type!r}")

        shift = cfg.render.novel_view.shift
        selected = tuple(cfg.data.selected_frames)
        self.info: SceneInfo = read_waymo_scene(
            cfg.source_path,
            cameras=list(cfg.data.cameras),
            selected_frames=None if selected[0] < 0 else selected,
            split_test=cfg.data.split_test,
            split_train=cfg.data.split_train,
            box_scale=cfg.data.box_scale,
            novel_view_shifts=list(shift) if isinstance(shift, (list, tuple))
            else [shift],
            train_actor_distance_thresh=(
                cfg.render.novel_view.train_actor_distance_thresh),
            extent=cfg.data.get("extent") or None,
            mode=cfg.mode)

        self.processor = None
        if need_processor:
            start = self.info.metadata["start_frame"]
            self.processor = get_pointcloud_processor(
                cfg.data.type, cfg.source_path,
                cameras=list(cfg.data.cameras),
                selected_frames=(start,
                                 start + self.info.metadata["num_frames"] - 1),
                delta_frames=cfg.data.delta_frames, device=self.device)
            colmap_points = None
            if cfg.data.use_colmap:
                # an existing triangulation, else one made now (needs the
                # colmap binary; raises without it)
                colmap_points = load_colmap_points(self.model_path)
                if colmap_points is None:
                    run_colmap(self.info.train_cameras,
                               os.path.join(self.model_path, "colmap"))
                    colmap_points = load_colmap_points(self.model_path)
            ply_paths = self.processor.initialize_ply(
                self.model_path, self.info.metadata["obj_meta"],
                colmap_points=colmap_points)
        else:
            # render mode: reuse the input plys written at train time
            ply_paths = {
                os.path.basename(p)[len("points3D_"):-4]: p
                for p in glob(os.path.join(self.model_path, "input_ply",
                                           "points3D_*.ply"))}
        self.ply_paths = ply_paths

        self.params: SceneParams | None = None
        self.meta: SceneMeta
        if init_params:
            self.params, self.meta = build_scene_params(
                self.info, ply_paths, cfg, self.device)
        else:
            self.meta = build_meta(self.info, ply_paths, cfg, self.device)

        self.load_images = load_images
        self._batch_cache: dict[tuple, dict] = {}
        self.downscale = auto_downscale(max(
            (c.width for c in self.info.train_cameras), default=0))

        def cams(infos):
            return [to_device_camera(c, self.downscale, self.device)
                    for c in infos]

        self.train_cameras = cams(self.info.train_cameras)
        self.test_cameras = cams(self.info.test_cameras)
        self.novel_cameras = cams(self.info.novel_view_cameras)

    @property
    def extent(self) -> float:
        return float(self.info.metadata["scene_radius"])

    def batch_for(self, cam_info: CameraInfo) -> dict:
        """Per-camera batch, cached per camera identity and
        ``diffusion_version``. A train or test view's gt image is resized
        to the downscaled camera. A novel view has no image on disk: its gt
        is the diffusion sample (``_image``, at the diffusion resolution,
        which its device camera renders at: ``runner.diffusion.
        diffusion_camera``), once a sampling event has attached one; each
        event bumps ``diffusion_version``, so its batch is built anew."""
        is_novel = cam_info.metadata.get("is_novel_view", False)
        load_img = self.load_images and (not is_novel
                                         or cam_info._image is not None)
        key = (cam_info.uid, cam_info.image_name, load_img,
               cam_info.metadata.get("diffusion_version", 0))
        if key not in self._batch_cache:
            if is_novel and load_img:
                hw = tuple(np.shape(cam_info._image)[:2])
            else:
                scale = 1.0 / self.downscale
                hw = (int(round(cam_info.height * scale)),
                      int(round(cam_info.width * scale)))
            self._batch_cache[key] = camera_batch(
                cam_info, hw, self.device, load_image=load_img,
                load_guidance=not is_novel)
        return self._batch_cache[key]

    def render_conditions(self, cameras: list[CameraInfo] | None = None,
                          force: bool = False) -> None:
        """Write the LiDAR condition PNGs of ``cameras`` (default: train,
        test and novel) that do not exist yet, or all with ``force``."""
        if self.processor is None:
            raise RuntimeError("scene built without a pointcloud processor")
        cams = cameras if cameras is not None else (
            self.info.train_cameras + self.info.test_cameras
            + self.info.novel_view_cameras)
        self.processor.render_conditions(
            cams, self.info.metadata["obj_meta"],
            scale=self.cfg.render.scale,
            use_ndc_scale=bool(self.cfg.render.use_ndc_scale), force=force)


def create_scene(cfg: Config, **kw) -> Scene:
    return Scene(cfg, **kw)
