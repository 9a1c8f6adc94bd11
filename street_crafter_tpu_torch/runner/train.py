"""3DGS training entry point with the diffusion distillation (port of
``street_crafter_tpu/runner/train.py``).

Host loop: camera sampling (``random.Random(cfg.seed)``, the JAX trainer's
generator and sequence; novel views with ``train.novel_view_prob`` once a
sampling event has filled them), SH-degree warm-up, the densify /
opacity-reset schedule, the sampling events of ``diffusion.
sample_iterations`` (``make_diffusion_hook``: the VDM samples the
lane-shifted novel views, SDS-initialised from the current render, at an
SDS scale interpolated between ``sds_scales``' max and min; a resume just
after an event runs it again, since novel images are not checkpointed),
eval (PSNR and L1 on the test cameras), checkpoints with the whole train
state (``resume: true`` continues at ``it + 1``) and the 3DGS PLY export
(with a cubemap sky, its 512x1024 latlong PNG beside the PLY).
The LiDAR condition PNGs of the train and test cameras are written first
when the diffusion or the LiDAR depth loss needs them. Runs on
``cfg.device`` (``cuda`` unless the config says ``cpu``).

``train.batch_size`` B > 1 trains on B cameras a step (JAX's camera-DP
step): the first camera as above, B - 1 more drawn from the same pool with
the same resolution and supervision keys (``fill_camera_batch``). Under
torchrun (``WORLD_SIZE`` ranks, ``mesh.axes.data: -1`` meaning the world
size) the ranks draw the same cameras and each runs B / W of them (W the
mesh's ``data`` size; a ``frames`` axis replicates the cameras); the
gradients and densification statistics are all-reduced, and the replicated
state (pools, Adam moments, the densify generator) stays bit-equal on
every rank, which is checked after each densify. Rank 0 alone writes the
condition PNGs, checkpoints, PLYs, eval images and logs; a checkpoint is
the one-GPU format and resumes on any world size. Distillation
(``diffusion.use_diffusion``) runs on every rank of the mesh: the ranks at
data index 0 sample each event (rank 0 alone, or its frames group under
``diffusion.shard_sample`` with ``mesh.axes.frames`` > 1), every other
rank takes the windows from their broadcast, so every rank attaches
bit-equal novel images and the loop draws the same cameras on each
(``make_diffusion_hook``).

CLI: python -m street_crafter_tpu_torch.runner.train --config scene.json \
    [k=v ...]
    torchrun --nproc_per_node 2 -m street_crafter_tpu_torch.runner.train \
    --config scene.json train.batch_size=2 [diffusion.use_diffusion=true] \
    [diffusion.shard_sample=true mesh.axes.frames=F]
"""

from __future__ import annotations

import os
import random
import shutil
import time
from typing import Callable

import numpy as np
import torch

from ..config import Config, default_config, load_config, merge_dotlist, \
    save_config
from ..datasets.cameras import Camera
from ..datasets.readers import CameraInfo
from ..models.gs.params import GaussianPool
from ..parallel.mesh import Mesh, make_mesh
from ..training.gs_trainer import (GSTrainState, check_replicated,
                                   init_train_state, make_densify_step,
                                   make_train_step, reset_opacity_step,
                                   trainable_leaves)
from ..utils.checkpoint import load_train_checkpoint, save_checkpoint
from ..utils.metrics import MetricsLogger, ProfilerHook
from .diffusion import diffusion_camera
from .render import make_eval_render, psnr
from .scene import Scene, create_scene

# (trainer, iteration, sds_scale): attaches diffusion samples to the novel
# views (CameraInfo._image) and bumps their diffusion_version
DiffusionHook = Callable[["GSTrainer", int, float], None]


class GSTrainer:
    """The training loop's state and schedules."""

    # the data-parallel group (None: one process)
    mesh: Mesh | None = None

    def __init__(self, cfg: Config, scene: Scene,
                 lpips_fn: Callable | None = None, mesh: Mesh | None = None):
        self.cfg = cfg
        self.scene = scene
        self.lpips_fn = lpips_fn
        self.mesh = mesh
        self.state: GSTrainState = init_train_state(scene.params)
        self.start_iter = 1
        self._steps: dict[tuple, Callable] = {}
        self._eval_renders: dict[int, Callable] = {}
        self._densify = make_densify_step(cfg)
        self.max_sh = cfg.model.gaussian.sh_degree
        self.rng = random.Random(cfg.seed)
        # flip masks and split noise; the JAX trainer's jax.random key
        self.generator = torch.Generator(device=scene.device).manual_seed(
            int(cfg.seed))
        self._novel_cams: dict[tuple, Camera] = {}
        if cfg.resume:
            restored, it = load_train_checkpoint(scene.model_path,
                                                 device=scene.device)
            if restored is not None:
                self.state = restored
                self.start_iter = it + 1
                print(f"resumed from iteration {it}")

    def eval_render_fn(self, sh: int) -> Callable:
        if sh not in self._eval_renders:
            self._eval_renders[sh] = make_eval_render(self.cfg,
                                                      self.scene.meta, sh)
        return self._eval_renders[sh]

    def active_sh(self, iteration: int) -> int:
        """One more SH degree every 1000 iterations."""
        return min(iteration // 1000, self.max_sh)

    @property
    def batch_size(self) -> int:
        """Cameras a step (``train.batch_size``)."""
        return int(self.cfg.train.get("batch_size", 1))

    @property
    def is_main(self) -> bool:
        """Rank 0 (or no mesh): the rank that writes files and logs."""
        return self.mesh is None or self.mesh.rank == 0

    def step_fn(self, is_novel: bool, sh: int,
                with_obj_acc: bool = False) -> Callable:
        key = (is_novel, sh, with_obj_acc)
        if key not in self._steps:
            self._steps[key] = make_train_step(
                self.cfg, self.scene.meta, spatial_lr_scale=self.scene.extent,
                lpips_fn=self.lpips_fn, is_novel=is_novel,
                active_sh_degree=sh, with_obj_acc=with_obj_acc,
                generator=self.generator, batch_size=self.batch_size,
                mesh=self.mesh)
        return self._steps[key]

    def fill_camera_batch(self, cam_info: CameraInfo, is_novel: bool,
                          novel_pool: list) -> list[CameraInfo]:
        """``cam_info`` and B - 1 more cameras of its pool with its
        resolution and supervision keys, drawn from the trainer's seeded
        rng (duplicates allowed; ``cam_info`` itself when none matches)."""
        scene = self.scene
        pool = novel_pool if is_novel else scene.info.train_cameras
        keys = set(scene.batch_for(cam_info))
        compat = [c for c in pool
                  if (c.width, c.height) == (cam_info.width, cam_info.height)
                  and set(scene.batch_for(c)) == keys]
        infos = [cam_info]
        while len(infos) < self.batch_size:
            infos.append(self.rng.choice(compat) if compat else cam_info)
        return infos

    def pick_camera(self, novel_pool: list) -> tuple:
        """(cam_info, is_novel), with the novel-view probability."""
        infos = self.scene.info.train_cameras
        if novel_pool and self.rng.random() < self.cfg.train.novel_view_prob:
            return self.rng.choice(novel_pool), True
        return self.rng.choice(infos), False

    def densify(self) -> dict:
        """Densify and prune in place; with several ranks, then check that
        every rank's state is still the same."""
        scene = self.scene
        info = self._densify(self.state, self.generator, float(scene.extent),
                             scene.meta.actor_bbox,
                             scene.meta.actor_random_init,
                             scene.meta.sphere_center,
                             scene.meta.sphere_radius)
        check_replicated(self.state, self.mesh)
        return info

    def sds_schedule(self, iteration: int, sample_iters: list[int],
                     scales: list[float]) -> float | None:
        """The SDS scale of a sampling event at ``iteration``, or None when
        no event runs: linear from max(scales) at the first sample
        iteration to min(scales) at the last. An event also runs at the
        first iteration of a resume that lands just after one, with that
        event's scale."""
        restarting = (iteration == self.start_iter
                      and (iteration - 1) in sample_iters)
        if iteration not in sample_iters and not restarting:
            return None
        eff_it = iteration - int(restarting)
        lo, hi = min(sample_iters), max(sample_iters)
        smin, smax = min(scales), max(scales)
        return (smin - smax) * (eff_it - lo) / max(hi - lo, 1) + smax

    def novel_camera(self, info: CameraInfo) -> Camera:
        """The device camera of a novel view, at the diffusion resolution
        its supervision has."""
        key = (info.uid, info.image_name)
        if key not in self._novel_cams:
            d = self.cfg.diffusion
            self._novel_cams[key] = diffusion_camera(info, d.height, d.width,
                                                     self.scene.device)
        return self._novel_cams[key]

    def run(self, diffusion_hook: DiffusionHook | None = None,
            log_fn: Callable[[int, dict], None] | None = None
            ) -> GSTrainState:
        cfg = self.cfg
        scene = self.scene
        o = cfg.optim
        sample_iters = list(cfg.diffusion.sample_iterations) \
            if cfg.diffusion.use_diffusion else []
        scales = list(cfg.diffusion.sds_scales)
        novel_pool: list = []
        device_cams = {c.uid: cam for c, cam in
                       zip(scene.info.train_cameras, scene.train_cameras)}
        main = self.is_main
        metrics = (MetricsLogger(os.path.join(scene.model_path, "logs"))
                   if main else None)
        profiler = ProfilerHook(cfg.profiler if main else {},
                                scene.model_path)

        def camera_of(info, is_novel):
            return (self.novel_camera(info) if is_novel
                    else device_cams[info.uid])

        t0 = time.perf_counter()
        ema_loss = None
        for iteration in range(self.start_iter, cfg.train.iterations + 1):
            profiler.step(iteration)
            scale = self.sds_schedule(iteration, sample_iters, scales)
            if diffusion_hook is not None and scale is not None:
                diffusion_hook(self, iteration, scale)
                novel_pool = [
                    c for c in scene.info.novel_view_cameras
                    if not c.metadata.get("skip_camera", False)
                    and c._image is not None]
            cam_info, is_novel = self.pick_camera(novel_pool)
            batch = scene.batch_for(cam_info)
            if "gt_image" not in batch:
                continue
            if self.batch_size > 1:
                infos = self.fill_camera_batch(cam_info, is_novel,
                                               novel_pool)
                if self.mesh is not None:
                    infos = infos[self.mesh.local_slice(len(infos), "data")]
                camera = [camera_of(i, is_novel) for i in infos]
                batch = [scene.batch_for(i) for i in infos]
            else:
                camera = camera_of(cam_info, is_novel)
            sh = self.active_sh(iteration)
            # objects-only acc regulariser once densification has settled
            with_obj_acc = (
                not is_novel and o.lambda_reg > 0
                and iteration % cfg.train.reg_obj_acc_every != 0
                and iteration > o.densify_until_iter
                and "obj_bound" in scene.batch_for(cam_info))
            step = self.step_fn(is_novel, sh, with_obj_acc)
            _, scalars = step(self.state, camera, batch)

            if (o.densify_from_iter <= iteration <= o.densify_until_iter
                    and iteration % o.densification_interval == 0):
                self.densify()
            if (iteration % o.opacity_reset_interval == 0
                    and iteration <= o.densify_until_iter):
                reset_opacity_step(self.state)

            # scalars are read only at log points: a read waits for the card
            if main and (iteration % cfg.train.log_interval == 0
                         or iteration == cfg.train.iterations):
                vals = {k: float(v) for k, v in scalars.items()}
                if not np.isfinite(vals["loss"]):
                    raise FloatingPointError(
                        f"non-finite loss {vals['loss']} at iteration "
                        f"{iteration}")
                ema_loss = vals["loss"] if ema_loss is None else \
                    0.6 * ema_loss + 0.4 * vals["loss"]
                metrics.log_scalars(iteration, vals, prefix="train/")
                if log_fn is not None:
                    log_fn(iteration, vals)

            if not main:
                continue
            if iteration in cfg.train.test_iterations:
                report = self.evaluate(sh)
                print(f"[it {iteration}] eval " + " ".join(
                    f"{k}={v:.3f}" for k, v in report.items()))
                metrics.log_scalars(iteration, report, prefix="eval/")
                self._log_eval_image(metrics, iteration, sh)
                if log_fn is not None:
                    log_fn(iteration, report)

            if (iteration in cfg.train.checkpoint_iterations
                    or iteration == cfg.train.iterations):
                save_checkpoint(scene.model_path, iteration,
                                self.state.params, self.state)
            if iteration in cfg.train.get("save_iterations", []):
                self.export_ply(iteration)

            if iteration % 100 == 0:
                dt = time.perf_counter() - t0
                ema_s = "n/a" if ema_loss is None else f"{ema_loss:.4f}"
                print(f"[it {iteration}] ema_loss={ema_s} "
                      f"({100 / dt:.1f} it/s)", flush=True)
                t0 = time.perf_counter()
        profiler.close()
        if metrics is not None:
            metrics.close()
        return self.state

    def export_ply(self, iteration: int) -> str:
        """3DGS PLY of every pool under point_cloud/iteration_N/."""
        from ..utils.gs_ply import export_gaussians_ply
        params = self.state.params
        pools: dict[str, GaussianPool] = {}
        if params.bkgd is not None:
            pools["bkgd"] = params.bkgd
        if params.actors is not None:
            for i in range(params.actors.xyz.shape[0]):
                pools[f"obj_{i:03d}"] = GaussianPool(**{
                    k: getattr(params.actors, k)[i]
                    for k in GaussianPool.__dataclass_fields__})
        if params.sky is not None:
            pools["sky"] = params.sky
        path = os.path.join(self.scene.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        export_gaussians_ply(path, pools)
        if params.sky_cubemap is not None:
            # the cubemap sky's latlong view beside the PLY
            from ..ops.cubemap import latlong_from_cubemap
            from ..utils.png import write_png
            with torch.no_grad():
                ll = latlong_from_cubemap(params.sky_cubemap, 512, 1024)
            write_png(os.path.join(os.path.dirname(path), "sky_latlong.png"),
                      (np.clip(ll.cpu().numpy(), 0, 1) * 255).astype(
                          np.uint8))
        return path

    def _log_eval_image(self, metrics: MetricsLogger, iteration: int,
                        sh: int) -> None:
        """First test view's render beside its ground truth, as a PNG."""
        scene = self.scene
        if not scene.info.test_cameras:
            return
        info, cam = scene.info.test_cameras[0], scene.test_cameras[0]
        batch = scene.batch_for(info)
        img = self.eval_render_fn(sh)(self.state.params, cam, batch)["rgb"]
        if "gt_image" in batch:
            img = torch.cat([img, batch["gt_image"]], 1)
        metrics.log_image(iteration, "eval/render_vs_gt", img.cpu().numpy())

    def evaluate(self, sh: int | None = None, cameras: str = "test"
                 ) -> dict[str, float]:
        """PSNR and L1 over the test (or train) cameras, and the mean
        (tile, splat) pairs per render."""
        scene = self.scene
        sh = self.max_sh if sh is None else sh
        render = self.eval_render_fn(sh)
        infos = getattr(scene.info, f"{cameras}_cameras")
        cams = getattr(scene, f"{cameras}_cameras")
        psnrs, l1s, pairs = [], [], []
        for info, cam in zip(infos, cams):
            batch = scene.batch_for(info)
            if "gt_image" not in batch:
                continue
            out = render(self.state.params, cam, batch)
            psnrs.append(psnr(out["rgb"], batch["gt_image"]))
            l1s.append(float((out["rgb"] - batch["gt_image"]).abs().mean()))
            pairs.append(out["n_pairs"])
        if not psnrs:
            return {}
        return {"psnr": float(np.mean(psnrs)), "l1": float(np.mean(l1s)),
                "n_pairs": float(np.mean(pairs))}


def backup_code(model_path: str) -> None:
    """Snapshot of the port package into the run directory."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(model_path, "code_backup", os.path.basename(src))
    if not os.path.exists(dst):
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
            "__pycache__", "*.so", "*.pyc", "build"))


def make_lpips(cfg: Config, device) -> Callable | None:
    """The LPIPS term's function: converted weights, else the seeded
    stand-in under ``optim.lpips_fallback=random_features``; raises when
    the term is on and neither is allowed."""
    o = cfg.optim
    if not (o.lambda_lpips > 0 or o.lambda_novel_lpips > 0):
        return None
    from ..ops.lpips import load_lpips, random_feature_lpips
    fn = load_lpips(o.get("lpips_weights") or None, device)
    if fn is not None:
        return fn
    if o.get("lpips_fallback", "none") == "random_features":
        print("WARNING: no LPIPS weights; using the seeded random-feature "
              "stand-in (optim.lpips_fallback), NOT the reference objective")
        return random_feature_lpips(device=device)
    if o.get("allow_missing_lpips", False):
        print("WARNING: no LPIPS weights; lpips terms disabled "
              "(allow_missing_lpips=True)")
        return None
    raise RuntimeError(
        "lambda_lpips/lambda_novel_lpips > 0 but no LPIPS weights are "
        "available (optim.lpips_weights unset or missing). Convert weights "
        "with ops.lpips.convert_lpips_torch, set the lambdas to 0, set "
        "optim.lpips_fallback=random_features for a stand-in, or set "
        "optim.allow_missing_lpips=True to waive.")


def sampling_ranks(cfg: Config, mesh: Mesh | None) -> tuple[bool, bool]:
    """(this rank samples the events, the sample is frames-sharded): with a
    mesh, the ranks at data index 0 sample: rank 0 alone, or its frames
    group when ``diffusion.shard_sample`` is set and the mesh has a
    ``frames`` axis."""
    if mesh is None:
        return True, False
    shard = (bool(cfg.diffusion.get("shard_sample", False))
             and mesh.size("frames") > 1)
    samples = mesh.coord("data") == 0 and (shard
                                           or mesh.coord("frames") == 0)
    return samples, shard


def make_diffusion_hook(cfg: Config, mesh: Mesh | None = None
                        ) -> DiffusionHook:
    """The sampling event: the VDM engine of ``cfg.diffusion`` (built once;
    its weights rest on the host between events under
    ``diffusion.params_on_host``) and a ``DiffusionRunner`` over the novel
    trajectories, SDS-initialised from the current 3DGS render at the
    diffusion resolution. ``hook.param_store`` is the weights' store
    (None on a rank that does not sample).

    With the trainer's ``mesh`` (several ranks) every rank enters the
    hook at the same iterations. Only the ranks at data index 0 sample
    (``sampling_ranks``): they alone build the engine and its store and
    render the SDS start (from the replicated state, with no collective);
    every other rank holds no engine. Every collective inside an event is
    entered by exactly the ranks of its group, in the same order: the
    condition barrier (every rank, before the trajectory and before each
    window), the frames-sharded sample's exchanges (the sampling frames
    group, within each window), the window's broadcast (along ``data``
    when frames-sharded, else every rank). That is the whole design: a
    rank that skipped one would pair its next collective with another's."""
    from .diffusion import (DiffusionRunner, EngineParamStore,
                            resolve_params_on_host)
    from .vdm_sample import build_engine
    d = cfg.diffusion
    samples, shard = sampling_ranks(cfg, mesh)
    engine = store = None
    if samples:
        engine = build_engine(cfg, int(d.sample_frames))
        store = EngineParamStore(engine,
                                 resolve_params_on_host(d, engine.device))

    def hook(trainer: GSTrainer, iteration: int, scale: float) -> None:
        scene = trainer.scene
        render_fn = None
        if samples:
            eval_render = trainer.eval_render_fn(
                trainer.active_sh(iteration))

            def render_fn(info):
                return eval_render(trainer.state.params,
                                   trainer.novel_camera(info),
                                   scene.batch_for(info))

        try:
            runner = DiffusionRunner(
                scene, store.acquire() if samples else None,
                height=d.height, width=d.width,
                window_size=d.window_size, num_steps=d.num_steps,
                cfg_scale=d.cfg_scale,
                save_dir=os.path.join(scene.model_path, "diffusion")
                if d.save_diffusion_render else None, mesh=mesh,
                sample_frames=int(d.sample_frames), shard_frames=shard)
            runner.run(scene.info.novel_view_cameras,
                       scene.info.train_cameras, render_fn=render_fn,
                       scale=scale)
        finally:
            if samples:
                store.release()

    hook.param_store = store
    hook.samples = samples
    return hook


def create_replicated_scene(cfg: Config, mesh: Mesh) -> Scene:
    """The scene on every rank: rank 0 builds it (writing the input plys and
    the condition PNGs), then the other ranks build theirs from those
    files, and rank 0's parameters are broadcast."""
    if mesh.rank == 0:
        scene = create_scene(cfg)
        render_conditions(cfg, scene)
    mesh.barrier()
    if mesh.rank != 0:
        scene = create_scene(cfg, need_processor=False)
    params = scene.params
    mesh.broadcast_([t.data for t in trainable_leaves(params)]
                    + [p.valid for p in (params.bkgd, params.actors,
                                         params.sky) if p is not None])
    return scene


def render_conditions(cfg: Config, scene: Scene) -> None:
    """The condition PNGs of the train and test cameras, which the sampling
    events and the LiDAR depth loss read."""
    if cfg.diffusion.use_diffusion or cfg.optim.lambda_depth_lidar > 0:
        scene.render_conditions(scene.info.train_cameras
                                + scene.info.test_cameras)


def train(cfg: Config, diffusion_hook: DiffusionHook | None = None,
          lpips_fn: Callable | None = None) -> GSTrainer:
    mesh = make_mesh(cfg.mesh.axes, device=cfg.get("device", "cuda"))
    world = mesh.world_size
    if int(cfg.train.get("batch_size", 1)) % mesh.size("data"):
        raise ValueError(f"train.batch_size {cfg.train.batch_size} does not "
                         f"split over {mesh.size('data')} data ranks")
    if world > 1:
        scene = create_replicated_scene(cfg, mesh)
    else:
        scene = create_scene(cfg)
        render_conditions(cfg, scene)
    if mesh.rank == 0:
        backup_code(scene.model_path)
        save_config(cfg, os.path.join(scene.model_path, "config.json"))
    if diffusion_hook is None and cfg.diffusion.use_diffusion:
        diffusion_hook = make_diffusion_hook(cfg,
                                             mesh if world > 1 else None)
    if lpips_fn is None:
        lpips_fn = make_lpips(cfg, scene.device)
    trainer = GSTrainer(cfg, scene, lpips_fn=lpips_fn,
                        mesh=mesh if world > 1 else None)
    check_replicated(trainer.state, trainer.mesh)
    trainer.run(diffusion_hook=diffusion_hook)
    return trainer


def main(argv: list[str] | None = None) -> GSTrainer:
    import argparse
    p = argparse.ArgumentParser(description="3DGS distillation training")
    p.add_argument("--config", required=True)
    p.add_argument("opts", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = default_config()
    cfg.merge(load_config(args.config))
    merge_dotlist(cfg, args.opts)
    return train(cfg)


if __name__ == "__main__":
    main()
