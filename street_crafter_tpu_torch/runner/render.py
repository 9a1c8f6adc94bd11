"""Render entry point (port of ``street_crafter_tpu/runner/render.py``).

Modes:
- ``trajectory``: all train+test cameras in id order; pngs per stream
  (rgb, acc, depth, gt, diff) and, with ``render.save_video``, videos;
- ``novel_view``: each lane-shift trajectory;
- ``diffusion``: the VDM over every lane-shift trajectory, SDS-initialised
  from the checkpoint's render at the smallest SDS scale; PNG frames under
  ``diffusion_{it}/`` and, with ``render.save_video``, a video per shift.
  With ``diffusion.shard_sample`` under torchrun each window samples
  frames-sharded over ``mesh.axes``: every rank builds the scene and renders
  the same (deterministic) SDS starts, rank 0 writes.
- ``virtual_warp``: per front train camera, the source image warped by
  depth into lane-shifted, yawed virtual views (``render_virtual_warp``).

CLI: python -m street_crafter_tpu_torch.runner.render --config scene.json \
    [mode=trajectory] [k=v ...]
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Config, default_config, load_config, merge_dotlist
from ..models.gs.renderer import render_scene
from ..models.gs.scene import SceneParams
from ..utils.checkpoint import load_checkpoint
from ..visualizers import Visualizer
from .scene import Scene, create_scene


def psnr(img: torch.Tensor, gt: torch.Tensor) -> float:
    mse = torch.mean((img - gt) ** 2)
    return float(-10.0 * torch.log10(torch.clamp(mse, min=1e-10)))


def make_eval_render(cfg: Config, meta, sh_degree: int):
    """Eval/trajectory render: interpolated actor poses, clamped rgb. Runs
    without autograd, so it takes kernel B's forward-only launch and keeps
    no training buffers alive, even for parameters that require grad."""
    @torch.no_grad()
    def eval_render(params: SceneParams, camera, batch: dict) -> dict:
        return render_scene(
            params, meta, camera,
            frame_idx=batch["frame_idx"], frame=batch["frame"],
            cam_id=batch["cam_id"], timestamp=batch.get("timestamp"),
            image_idx=batch.get("image_idx", 0),
            sh_degree=sh_degree, tile_size=int(cfg.render.tile_size),
            interpolate_pose=True, clamp=True,
            white_background=bool(cfg.data.white_background))
    return eval_render


def load_trained_state(cfg: Config, scene: Scene
                       ) -> tuple[SceneParams, int]:
    """The checkpoint's parameters; pools keep the saved sizes."""
    iteration = None if cfg.loaded_iter < 0 else int(cfg.loaded_iter)
    params, it = load_checkpoint(scene.model_path, iteration, scene.device)
    if params is None:
        raise FileNotFoundError(
            f"no checkpoint under {scene.model_path}/checkpoints")
    print(f"loaded checkpoint at iteration {it}")
    return params, it


def _render_cameras(cfg: Config, scene: Scene, params: SceneParams, infos,
                    cams, vis: Visualizer) -> dict:
    """Render each camera in id order; returns per-frame stats."""
    eval_render = make_eval_render(cfg, scene.meta,
                                   cfg.model.gaussian.sh_degree)
    frame_ms, n_pairs, psnrs = [], [], []
    for idx in np.argsort([i.uid for i in infos]):
        info, cam = infos[idx], cams[idx]
        batch = scene.batch_for(info)
        t0 = time.perf_counter()
        out = eval_render(params, cam, batch)
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        frame_ms.append(1e3 * (time.perf_counter() - t0))
        n_pairs.append(out["n_pairs"])
        if not bool(torch.isfinite(out["rgb"]).all()):
            raise FloatingPointError(f"non-finite render of {info.image_name}")
        gt = batch.get("gt_image")
        result = {k: out[k].cpu().numpy() for k in ("rgb", "acc", "depth")}
        vis.add_result(result, info.metadata["frame"], info.metadata["cam"],
                       gt=None if gt is None else gt.cpu().numpy())
        if gt is not None and info.metadata["is_val"]:
            psnrs.append(psnr(out["rgb"], gt))
    if psnrs:
        print(f"test psnr: {np.mean(psnrs):.3f}")
    return {"frame_ms": frame_ms, "n_pairs": n_pairs,
            "psnr": float(np.mean(psnrs)) if psnrs else None}


def _visualizer(cfg: Config, out_dir: str) -> Visualizer:
    return Visualizer(out_dir, fps=cfg.render.fps,
                      save_images=bool(cfg.render.save_image),
                      save_videos=bool(cfg.render.save_video))


def render_trajectory(cfg: Config) -> dict:
    """All train+test cameras in id order. Returns {"videos": stream ->
    path, "out_dir", "frame_ms", "n_pairs", "psnr"}."""
    scene = create_scene(cfg, need_processor=False, init_params=False)
    params, it = load_trained_state(cfg, scene)
    out_dir = os.path.join(scene.model_path, f"trajectory_{it}")
    vis = _visualizer(cfg, out_dir)
    stats = _render_cameras(cfg, scene, params,
                            scene.info.train_cameras + scene.info.test_cameras,
                            scene.train_cameras + scene.test_cameras, vis)
    return {"videos": vis.summarize(), "out_dir": out_dir, **stats}


def render_novel_view(cfg: Config) -> dict:
    """Per-shift lane-shift trajectories. Returns {"videos": "shift:stream"
    -> path, "out_dirs", "frame_ms", "n_pairs"}."""
    scene = create_scene(cfg, need_processor=False, init_params=False)
    params, it = load_trained_state(cfg, scene)
    res = {"videos": {}, "out_dirs": [], "frame_ms": [], "n_pairs": []}
    for shift in sorted({i.metadata["novel_view_id"]
                         for i in scene.info.novel_view_cameras}):
        out_dir = os.path.join(scene.model_path,
                               f"novel_view_{it}_shift_{shift:.2f}")
        vis = _visualizer(cfg, out_dir)
        pairs = [(i, c) for i, c in zip(scene.info.novel_view_cameras,
                                        scene.novel_cameras)
                 if i.metadata["novel_view_id"] == shift]
        stats = _render_cameras(cfg, scene, params, [p[0] for p in pairs],
                                [p[1] for p in pairs], vis)
        res["videos"].update({f"{shift}:{k}": v
                              for k, v in vis.summarize().items()})
        res["out_dirs"].append(out_dir)
        res["frame_ms"] += stats["frame_ms"]
        res["n_pairs"] += stats["n_pairs"]
    return res


def render_diffusion(cfg: Config) -> dict:
    """The conditioned VDM over the novel trajectories of a trained scene
    (the reference's render.py:78-107). Returns {"videos": "shift_S" ->
    path, "out_dir", "frames": the PNG paths (rank 0's)}."""
    from .diffusion import (DiffusionRunner, diffusion_camera,
                            sampling_mesh_from_cfg)
    from .vdm_sample import build_engine
    d = cfg.diffusion
    mesh = sampling_mesh_from_cfg(cfg)
    if mesh is None:
        scene = create_scene(cfg, init_params=False)
    else:
        # rank 0 first: it writes what the scene's build writes
        cfg = cfg.clone()
        cfg.device = str(mesh.device)
        scene = create_scene(cfg, init_params=False) if mesh.rank == 0 \
            else None
        mesh.barrier()
        scene = scene or create_scene(cfg, init_params=False)
    params, it = load_trained_state(cfg, scene)
    engine = build_engine(cfg, int(d.sample_frames), scene.device)
    out_dir = os.path.join(scene.model_path, f"diffusion_{it}")
    runner = DiffusionRunner(scene, engine, height=d.height, width=d.width,
                             window_size=d.window_size,
                             num_steps=d.num_steps, cfg_scale=d.cfg_scale,
                             save_dir=out_dir, mesh=mesh)
    eval_render = make_eval_render(cfg, scene.meta,
                                   cfg.model.gaussian.sh_degree)

    def render_fn(info):
        cam = diffusion_camera(info, d.height, d.width, scene.device)
        return eval_render(params, cam, scene.batch_for(info))

    runner.run(scene.info.novel_view_cameras, scene.info.train_cameras,
               render_fn=render_fn, scale=min(d.sds_scales))
    res = {"videos": {}, "out_dir": out_dir, "frames": []}
    if not runner.writes:
        return res
    res["frames"] = sorted(os.path.join(out_dir, f)
                           for f in os.listdir(out_dir))
    if cfg.render.get("save_video", False):
        from ..visualizers import save_video
        for shift in sorted({i.metadata["novel_view_id"]
                             for i in scene.info.novel_view_cameras}):
            frames = [c._image for c in sorted(
                (c for c in scene.info.novel_view_cameras
                 if c.metadata["novel_view_id"] == shift
                 and c._image is not None),
                key=lambda c: c.metadata["frame"])]
            if frames:
                res["videos"][f"shift_{shift:.2f}"] = save_video(
                    os.path.join(out_dir, f"diffusion_shift_{shift:.2f}.mp4"),
                    frames, fps=cfg.render.fps)
    return res


def render_virtual_warp(cfg: Config) -> dict:
    """Depth-reprojection warp guidance: for each front train camera in
    ``render.novel_view``'s frame range, render the source view, then for
    ``steps - 1`` fractions r in (0, 1] a virtual pose (lane shift
    ``shift * r``, yaw ``rotate * r``), render it and warp the source image
    into it with the rendered depths. Writes ``{i:04d}.png`` (the render;
    step 0 is the source image), ``{i:04d}_condition.png`` (the warp) and
    ``{i:04d}_mask.png`` under ``model_path/virtual_warp/{name}/
    {image_name}/``. The source image is the camera's gt at the render's
    size. Returns {"videos": {}, "out_dirs": image name -> dir, "view_ms":
    per source, the synchronised wall of its target renders and warp over
    the number of targets}."""
    from ..datasets import waymo_layout
    from ..datasets.cameras import Camera
    from ..ops.warp import process_depth, virtual_warp_images
    from ..utils.png import write_png

    scene = create_scene(cfg, need_processor=False, init_params=False)
    params, it = load_trained_state(cfg, scene)
    eval_render = make_eval_render(cfg, scene.meta,
                                   cfg.model.gaussian.sh_degree)
    dev = scene.device
    nv = cfg.render.novel_view
    steps = int(nv.steps)
    shift = nv.shift
    shift = float(shift[0] if isinstance(shift, (list, tuple)) else shift)
    yaw = float(nv.rotate)
    ego_frame_poses = scene.info.metadata["ego_frame_poses"]
    out_root = os.path.join(scene.model_path, "virtual_warp", str(nv.name))
    start, end = int(nv.start_frame), int(nv.end_frame)

    def u8(img: torch.Tensor) -> np.ndarray:
        return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)

    res = {"videos": {}, "out_dirs": {}, "view_ms": []}
    for info, cam in zip(scene.info.train_cameras, scene.train_cameras):
        if info.metadata["cam"] != 0:
            continue    # the front camera, as the lane-shift trajectories
        frame = info.metadata["frame"]
        if start >= 0 and frame < start or end >= 0 and frame > end:
            continue
        save_dir = os.path.join(out_root, info.image_name)
        batch = scene.batch_for(info)
        src_out = eval_render(params, cam, batch)
        src_rgb = batch["gt_image"]
        src_depth = process_depth(src_out["depth"], src_out["acc"])
        src = (src_rgb.cpu().numpy() * 255).astype(np.uint8)
        write_png(os.path.join(save_dir, "0000.png"), src)
        write_png(os.path.join(save_dir, "0000_condition.png"), src)
        write_png(os.path.join(save_dir, "0000_mask.png"),
                  np.full((cam.height, cam.width), 255, np.uint8))

        direction = waymo_layout.get_lane_shift_direction(ego_frame_poses,
                                                          frame)
        ext = np.asarray(info.metadata["extrinsic"])        # cam -> ego
        K = cam.K.cpu().numpy()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tar_rgbs, tar_depths, tar_c2ws = [], [], []
        for r in np.linspace(0.0, 1.0, steps)[1:]:
            ego = np.asarray(info.metadata["ego_pose"]).copy()
            ego[:3, 3] += direction * shift * r
            c, s = np.cos(yaw * r), np.sin(yaw * r)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)
            ego[:3, :3] = rot @ ego[:3, :3]
            tar_c2w = ego @ ext
            tar_cam = Camera.from_c2w(tar_c2w, K, cam.width, cam.height,
                                      device=dev)
            tar_out = eval_render(params, tar_cam, batch)
            tar_rgbs.append(tar_out["rgb"])
            tar_depths.append(process_depth(tar_out["depth"],
                                            tar_out["acc"]))
            tar_c2ws.append(tar_c2w)
        B = len(tar_c2ws)
        Ks = cam.K.expand(B, 3, 3)
        warp = virtual_warp_images(
            Ks, torch.tensor(np.stack(tar_c2ws), dtype=torch.float32,
                             device=dev),
            torch.stack(tar_depths), Ks,
            torch.tensor(np.asarray(info.c2w), dtype=torch.float32,
                         device=dev).expand(B, 4, 4),
            src_depth.expand(B, *src_depth.shape),
            src_rgb.expand(B, *src_rgb.shape))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res["view_ms"].append(1e3 * (time.perf_counter() - t0) / max(B, 1))
        for i in range(B):
            write_png(os.path.join(save_dir, f"{i + 1:04d}.png"),
                      u8(tar_rgbs[i]))
            write_png(os.path.join(save_dir, f"{i + 1:04d}_condition.png"),
                      u8(warp.rgb[i]))
            write_png(os.path.join(save_dir, f"{i + 1:04d}_mask.png"),
                      warp.mask[i].cpu().numpy().astype(np.uint8) * 255)
        res["out_dirs"][info.image_name] = save_dir
    print(f"virtual_warp at iteration {it}: {len(res['out_dirs'])} source "
          f"views, {max(steps - 1, 0)} targets each")
    return res


MODES = {"trajectory": render_trajectory, "novel_view": render_novel_view,
         "diffusion": render_diffusion, "virtual_warp": render_virtual_warp}


def main(argv: list[str] | None = None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="render a trained scene")
    p.add_argument("--config", required=True)
    p.add_argument("opts", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = default_config()
    cfg.merge(load_config(args.config))
    merge_dotlist(cfg, args.opts)
    mode = cfg.get("mode", "trajectory")
    if mode == "train":
        mode = "trajectory"
    if mode not in MODES:
        raise NotImplementedError(
            f"render mode {mode!r} is not a mode of the render entry point; "
            f"modes: {sorted(MODES)}")
    result = MODES[mode](cfg)
    for name, path in result["videos"].items():
        print(f"{name}: {path}")
    return result


if __name__ == "__main__":
    main()
