#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (street_crafter_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one status line each; any failure raises (exit code != 0):
  1. card name and power limit; build every kernel source of
     street_crafter_tpu_torch/csrc with nvcc for sm_90a, in parallel;
  2. each kernel against its plain torch version on the card: 50k splats of
     a trained-like scene at 384x256, and a scene with splats wider than
     200 px. Kernel A's worklist must equal the plain one; kernel B must
     agree to atol 2e-4 on rgb and alpha;
  3. the main path: a synthetic 1920x1280 Waymo scene (4 frames, cameras
     0-2), scene init with the port's initialize_ply, the background pool
     replaced by a 600k-splat post-densification pool in front of camera 0,
     a port checkpoint, then runner.render.main(mode=trajectory): 12 renders
     at 1600x1067 that must be finite PNGs, through both kernels and never
     through the plain versions;
  4. both kernels against their plain versions at the headline frame's
     shapes, and their times (CUDA events);
  5. kernel C (the compositing backward) against the plain backward with
     seeded random cotangents on the inputs of phases 2 and 4: per field,
     to GRAD_RTOL of the field's largest gradient, of its norm and, in the
     median, of each splat's own gradient; its time, and the plain
     backward's at the headline frame;
  6. the training main path: runner.train.main on the synthetic scene from
     scene init, configs/waymo_val_base.yaml's GS settings, 300 iterations
     at 1600x1067 (densify at 100, 150 and 200, an opacity reset at 150,
     eval, checkpoint and PLY at 300), then 20 more resumed from that
     checkpoint, and runner.render.main(mode=trajectory) on it. The loss
     must stay finite, train-view PSNR must rise, densify must change the
     valid count, and every step must launch kernel C, never the plain
     backward;
  7. the train step at the shape users pay for: the 600k-splat pool in a
     2^20-slot background pool, actors and sky of phase 3, the full loss
     stack; median ms per step, peak memory, a per-stage split and the
     profiler's device-busy share.
  8. kernels D (attention forward), E (the temporal stage) and F (its
     attention) against their plain versions in bf16, first at small
     shapes with ragged edges, then at every shape of the sampling main
     path; the largest error within 2e-2 and the median within 2e-3 of the
     largest |reference|;
  9. the sampling main path: a synthetic 1920x1280 scene (26 frames,
     camera 0) with stand-in LiDAR condition renders and its meta_info,
     then runner.vdm_sample.main at full width (UNet 320 x (1, 2, 4, 4),
     VAE, ViT-H/14 CLIP; 25 frames at 576x1024, bf16, CFG 2.5) with seeded
     random weights whose zero-initialised output layers are perturbed,
     VDM_STEPS Euler steps: finite frames in [-1, 1], exactly 15 / 5 / 11
     launches of D / E / F per Euler step and none of the plain versions;
 10. times: one CFG UNet eval, wall per Euler step, the VAE encode, the
     chunked decode, CLIP, the profiler's device-busy share of one step,
     and per kernel at every main-path shape its CUDA-event time, bound,
     plain time and (kernel D) scaled_dot_product_attention's time;
 11. kernel D's training form (with lse) and the attention backward
     kernels G (dK, dV) and H (dQ) against their plain versions in bf16
     with seeded cotangents, at small ragged shapes, then at the three
     training shapes; phase 8's limits for each of o, lse, dq, dk, dv;
 12. the fine-tune main path: runner.vdm_train.main on phase 9's scene at
     full width (25 frames at 576x1024, batch 1, bf16 compute with f32
     masters, remat flash0, the recipe's frozen temporal layers), seeded
     random weights as phase 9, TRAIN_STEPS steps and a checkpoint, then
     one step resumed from it (its own checkpoint serialised into a byte
     count only, so that the script writes under ~35 GB to disk: one
     checkpoint is ~24 GB), then the EMA export loaded back through
     runner.vdm_sample's loader: finite losses, spatial weights moved,
     temporal weights bit-identical, the EMA apart from the weights, the
     step count + 1, the export equal to the EMA in bf16, and exactly
     25 / 15 / 15 launches of D-with-lse / G / H per step and none of D
     without lse, E, F or any plain version;
 13. times: the train step (median of synchronised steps after a warm-up)
     and its split into encode / forward / backward / optimizer + EMA, peak
     memory, the profiler's device-busy share of one step, and per kernel
     (D with lse, G, H) at each training shape its CUDA-event time, bound,
     plain time and one scaled_dot_product_attention forward (D) or
     backward (G + H together).
Kernel builds, launches and comparisons raise on failure; no phase catches
its own. TF32 is off for matmuls and cuDNN convolutions throughout.
The last three lines: the card's name and power limit, a JSON object of
per-kernel results, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

RGB_ALPHA_ATOL = 2e-4   # kernel B vs plain: f32, summed in another order
# kernel C vs the plain backward, per field, three ways: the largest error
# over the field's largest |gradient|, the error's norm over the field's
# norm, and the median over splats of each splat's own relative error (so
# small splats count as much as large ones). Kernel C rebuilds T by
# division where the plain version scans with cumprod, sums the suffix in
# another order, and adds per-splat sums with atomics in a run-dependent
# order: f32 rounding, observed below 1e-5 of each
GRAD_RTOL = 1e-4
N_SMALL, W_SMALL, H_SMALL = 50_000, 384, 256
N_HEAVY = 600_000
BKGD_CAPACITY = 2 ** 20     # phase 7: the 600k pool inside a fixed capacity
TRAIN_ITERS, RESUME_ITERS = 300, 20
SOURCE = "street_crafter_tpu_torch/csrc/gs_raster.cu"
REPLACES = {"tile_worklist": "street_crafter_tpu/ops/gs_raster_fused.py:86",
            "composite": "street_crafter_tpu/ops/gs_raster_fused.py:255",
            "composite_backward":
                "street_crafter_tpu/ops/gs_raster_train.py:60"}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One status line, after the seconds since the script started."""
    print(f"{time.perf_counter() - T_START:7.1f}s {msg}", flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device-clock ms per call (CUDA events around ``reps`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(G, args: dict, label: str, phase: int) -> dict:
    """Kernel A and B against their plain versions on the same inputs."""
    import torch
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    wl = G.tile_worklist(**geo)
    ref = G.tile_worklist_reference(**geo)
    for name in ("tile_ids", "gauss_ids", "ranges"):
        a, b = getattr(wl, name), getattr(ref, name)
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{label}: kernel A {name} differs from the "
                                 f"plain worklist")
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    col, alpha = G.composite(wl, **comp)
    col_ref, alpha_ref = G.composite_reference(wl, **comp)
    torch.cuda.synchronize()
    err_rgb = float((col[..., :3] - col_ref[..., :3]).abs().max())
    err_alpha = float((alpha - alpha_ref).abs().max())
    err_depth = float((col[..., 3] - col_ref[..., 3]).abs().max())
    max_depth = float(args["depths"][args["valid"]].max())
    log(f"[{phase}] {label}: {wl.n_pairs} pairs, worklist equal; "
        f"composite max err "
        f"rgb {err_rgb:.3g} alpha {err_alpha:.3g} (atol {RGB_ALPHA_ATOL}), "
        f"depth channel {err_depth:.3g} (max depth {max_depth:.1f})")
    if not (err_rgb <= RGB_ALPHA_ATOL and err_alpha <= RGB_ALPHA_ATOL):
        raise AssertionError(f"{label}: kernel B disagrees with the plain "
                             f"composite")
    return {"pairs": wl.n_pairs, "worklist_err": 0,
            "composite_err": max(err_rgb, err_alpha)}


def raster_args(flat, w2c, K, width: int, height: int) -> dict:
    """Keyword arguments of rasterize_pixels for a flat soup and camera."""
    from street_crafter_tpu_torch.models.gs.renderer import raster_inputs
    cam_center = -(w2c[:3, :3].T @ w2c[:3, 3])
    return raster_inputs(flat, w2c, K, cam_center, width, height)[1]


def wide_splat_args(device, n=20_000, width=W_SMALL, height=H_SMALL,
                    seed=1) -> dict:
    """Projected splats with 10% of radii in 200..300 px."""
    import torch
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(1.0, 8.0, n).astype(np.float32)
    wide = rng.random(n) < 0.1
    sigma[wide] = rng.uniform(67.0, 100.0, wide.sum())
    ca = 1.0 / sigma ** 2
    cc = 1.0 / (0.7 * sigma) ** 2
    cb = 0.3 * np.sqrt(ca * cc) * rng.uniform(-1, 1, n)
    depth = rng.uniform(1.0, 80.0, n).astype(np.float32)
    colors = np.concatenate([rng.random((n, 3)), depth[:, None]], 1)
    valid = rng.random(n) > 0.05

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(u=t(rng.uniform(-50, width + 50, n)),
                v=t(rng.uniform(-50, height + 50, n)), conic_a=t(ca),
                conic_b=t(cb), conic_c=t(cc), colors=t(colors),
                opacities=t(np.where(rng.random(n) < 0.5,
                                     rng.uniform(0.9, 1.0, n),
                                     rng.uniform(0.02, 0.3, n))),
                depths=t(depth), valid=t(valid, torch.bool),
                radii=t(np.ceil(3 * sigma) * valid), width=width,
                height=height)


def heavy_pool_in_camera(c2w: np.ndarray, device, n: int = N_HEAVY):
    """The post-densification pool (seed 0), moved rigidly from camera
    space into the world frame of a camera with pose ``c2w``."""
    import torch
    from street_crafter_tpu_torch.datasets.synthetic import (
        trained_like_pool_arrays)
    from street_crafter_tpu_torch.models.gs.params import GaussianPool
    from street_crafter_tpu_torch.ops import quaternion as Q
    arrays = {k: torch.tensor(v, device=device)
              for k, v in trained_like_pool_arrays(n, seed=0).items()}
    R = torch.tensor(c2w[:3, :3], dtype=torch.float32, device=device)
    t = torch.tensor(c2w[:3, 3], dtype=torch.float32, device=device)
    arrays["xyz"] = arrays["xyz"] @ R.T + t
    arrays["rotation"] = Q.multiply(Q.from_matrix(R)[None],
                                    arrays["rotation"])
    return GaussianPool(**arrays)


def build_main_path_scene(tmp: str, dev):
    """Synthetic 1920x1280 scene (4 frames, cameras 0-2) under ``tmp``, the
    port's scene init, the 600k pool as background and an iteration-0
    checkpoint. Returns (config, path of its JSON file)."""
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.utils.checkpoint import save_checkpoint
    t0 = time.perf_counter()
    cfg = default_config()
    cfg.source_path = make_scene(tmp, num_frames=4, img_hw=(1280, 1920))
    cfg.model_path = os.path.join(tmp, "model")
    cfg.device = "cuda"
    cfg.data.cameras = [0, 1, 2]
    cfg.optim.capacity_obj = 8192
    cfg.optim.capacity_sky = 65536
    cfg.render.save_video = False
    scene = create_scene(cfg)
    info0 = next(i for i in scene.info.train_cameras
                 if i.metadata["cam"] == 0 and i.metadata["frame"] == 0)
    params = dataclasses.replace(
        scene.params, bkgd=heavy_pool_in_camera(info0.c2w, dev))
    save_checkpoint(cfg.model_path, 0, params)
    cfg_path = os.path.join(tmp, "scene.json")
    save_config(cfg, cfg_path)
    log(f"[3] scene + checkpoint ready in {time.perf_counter() - t0:.1f} s: "
        f"{len(scene.info.train_cameras) + len(scene.info.test_cameras)} "
        f"cameras, bkgd {params.bkgd.capacity} splats, actors "
        f"{tuple(params.actors.xyz.shape[:2])}, sky "
        f"{params.sky.num_valid()} valid")
    return cfg, cfg_path


def headline_scene(cfg, dev):
    """(scene, checkpoint params, camera, batch) of the first trajectory
    frame, frame 0 of camera 0."""
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.utils.checkpoint import load_checkpoint
    scene = create_scene(cfg, need_processor=False, init_params=False)
    params, _ = load_checkpoint(cfg.model_path, 0, dev)
    infos = scene.info.train_cameras + scene.info.test_cameras
    i = min(range(len(infos)), key=lambda k: infos[k].uid)
    cam = (scene.train_cameras + scene.test_cameras)[i]
    return scene, params, cam, scene.batch_for(infos[i])


def headline_raster_args(cfg, dev):
    """rasterize_pixels arguments of the headline frame's foreground pass."""
    from street_crafter_tpu_torch.models.gs.scene import flatten_scene
    scene, params, cam, batch = headline_scene(cfg, dev)
    flat = flatten_scene(params, scene.meta, batch["cam_id"],
                         batch["frame_idx"], batch["frame"],
                         batch["timestamp"], include_sky=False,
                         interpolate=True)
    return (raster_args(flat, cam.w2c, cam.K, cam.width, cam.height), cam,
            flat.xyz.shape[0])


def split_args(args: dict) -> tuple[dict, dict]:
    """(worklist, compositing) keyword arguments of raster args."""
    return ({k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                  "width", "height")},
            {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                  "colors", "opacities", "width", "height")})


def compare_backward(G, args: dict, label: str, seed: int) -> dict:
    """Kernel C against the plain backward, after kernel B's training
    variant against the plain forward's T and last index."""
    import torch
    geo, comp = split_args(args)
    wl = G.tile_worklist(**geo)
    out, alpha, final_T, last = G.composite(wl, **comp, train=True)
    ref = G.composite_reference(wl, **comp, train=True)
    if not torch.equal(last, ref[3]):
        raise AssertionError(f"{label}: kernel B's last index differs")
    err_T = float((final_T - ref[2]).abs().max())
    if err_T > RGB_ALPHA_ATOL:
        raise AssertionError(f"{label}: kernel B's final T differs ({err_T})")
    rng = np.random.default_rng(seed)
    dev = out.device
    gcol = torch.tensor(rng.normal(size=out.shape), dtype=torch.float32,
                        device=dev)
    gal = torch.tensor(rng.normal(size=alpha.shape), dtype=torch.float32,
                       device=dev)
    state = dict(final_T=final_T, last=last, grad_colors=gcol,
                 grad_alpha=gal)
    got = G.composite_backward(wl, **comp, **state)
    want = G.composite_backward_reference(wl, **comp, grad_colors=gcol,
                                          grad_alpha=gal)
    torch.cuda.synchronize()
    fields = {"u": G.GRAD_U, "v": G.GRAD_V, "a": G.GRAD_A, "b": G.GRAD_B,
              "c": G.GRAD_C, "opacity": G.GRAD_OPACITY,
              "absgrad": G.GRAD_ABS, "colors": slice(G.GRAD_COLORS, None)}
    errs, worst_abs, worst_scale = {}, 0.0, 0.0
    for name, col in fields.items():
        errs[name] = grad_errors(got[:, col], want[:, col])
        if errs[name]["abs"] > worst_abs:
            worst_abs, worst_scale = errs[name]["abs"], errs[name]["max"]
    log(f"[5] {label}: {wl.n_pairs} pairs, T err {err_T:.3g}, last equal; "
        f"kernel C per field (error / field max, error norm / field norm, "
        f"median per-splat relative error; median |grad|): "
        + ", ".join(f"{k} {e['max_rel']:.2e} {e['norm_rel']:.2e} "
                    f"{e['median_rel']:.2e}; {e['median']:.3g}"
                    for k, e in errs.items())
        + f" (tolerance {GRAD_RTOL} on each); largest absolute error "
        f"{worst_abs:.3g} where the field's largest gradient is "
        f"{worst_scale:.3g}")
    if max(max(e["max_rel"], e["norm_rel"], e["median_rel"])
           for e in errs.values()) > GRAD_RTOL:
        raise AssertionError(f"{label}: kernel C disagrees with the plain "
                             f"backward")
    return {"wl": wl, "comp": comp, "state": state, "err": worst_abs,
            "prefix": int(last.sum()), "pixels": last.numel()}


def grad_errors(got, want) -> dict:
    """Errors of one gradient field: largest absolute error, that over the
    field's largest |gradient|, the error norm over the field's norm, and
    the median over nonzero entries of |got - want| / |want|; also the
    field's largest |gradient| and the median of its nonzero ones."""
    import torch
    diff = (got - want).abs().flatten()
    mag = want.abs().flatten()
    nz = mag > 0
    top, norm = float(mag.max()), float(torch.linalg.vector_norm(want))
    return {"abs": float(diff.max()), "max": top,
            "median": float(mag[nz].median()) if bool(nz.any()) else 0.0,
            "max_rel": float(diff.max()) / top if top > 0 else 0.0,
            "norm_rel": (float(torch.linalg.vector_norm(got - want)) / norm
                         if norm > 0 else 0.0),
            "median_rel": (float((diff[nz] / mag[nz]).median())
                           if bool(nz.any()) else 0.0)}


def contributing_pairs(G, wl, comp: dict) -> int:
    """(pixel, splat) pairs inside the image where the splat contributed
    (not skipped) before the pixel's stop: the pairs that do the full work
    of kernels B and C, recomputed as the plain versions do."""
    import torch
    height, width = comp["height"], comp["width"]
    n = torch.zeros((), dtype=torch.int64, device=comp["u"].device)
    for ts in G._tiles(wl, comp["u"], comp["v"], comp["conic_a"],
                       comp["conic_b"], comp["conic_c"], comp["opacities"],
                       width):
        hit = (ts.keep & (ts.alpha > 0)).reshape(-1, G.TILE, G.TILE)
        n += hit[:, :height - ts.rows.start, :width - ts.cols.start].sum()
    return int(n)


def bounds(n_splats: int, n_pairs: int, n_tiles: int, pixels: int,
           prefix: int, hits: int, C: int) -> dict:
    """Least time (ms) the card could take for each kernel's function at
    these shapes: bytes moved (each input read once, each output written
    once) over HBM3's rate, or float32 operations over the non-tensor-core
    peak, whichever is larger. ``prefix``: the (pixel, splat) pairs up to
    each pixel's last contributor, the least walk compositing needs; each
    costs the recompute of sigma and alpha. ``hits``: those of them where
    the splat contributed, the only ones that do the rest."""
    def bound(nbytes, flops):
        t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
        return ({"bound_ms": 1e3 * max(t_b, t_f),
                 "bound_by": "bytes" if t_b >= t_f else "operations"})
    splat_attrs = (6 + C) * 4 * n_splats        # u v a b c opacity colours
    lists = 4 * n_pairs + 8 * n_tiles           # gauss ids, tile ranges
    return {
        # u, v, radii, depths (f32) and valid (u8) in; tile and splat ids
        # per pair and the ranges out
        "tile_worklist": bound(17 * n_splats + 8 * n_pairs + 8 * n_tiles, 0),
        # per evaluated pair: dx, dy, sigma (11), exp, opacity, min, two
        # gates (~15); per hit also the weight, the T update (3) and a
        # multiply-add per channel
        "composite": bound(splat_attrs + lists + 4 * (C + 1) * pixels,
                           15 * prefix + hits * (3 + 2 * C)),
        # per evaluated pair the same recompute (15); per hit also T by
        # division, c.g_c (2C), dalpha (6), suffix (2), dcolour (C), the
        # eight geometric gradients and |.| (~22), and the warp sums (8 + C)
        "composite_backward": bound(
            splat_attrs + lists + 4 * (C + 3) * pixels
            + (8 + C) * 4 * n_splats, 15 * prefix + hits * (39 + 4 * C)),
    }


def train_config(cfg):
    """configs/waymo_val_base.yaml's GS settings (diffusion off, the
    seeded LPIPS stand-in), its schedule compressed into TRAIN_ITERS."""
    cfg.data.split_test = 2
    cfg.model.gaussian.sh_degree = 1
    cfg.model.gaussian.fourier_dim = 1
    cfg.model.gaussian.flip_prob = 0.2
    cfg.model.nsg.opt_track = True
    cfg.diffusion.use_diffusion = False
    o = cfg.optim
    o.densify_grad_threshold = 0.0006
    o.densify_grad_abs_bkgd = True
    o.densify_grad_abs_obj = True
    o.min_opacity = 0.005
    o.lambda_dssim = 0.2
    o.lambda_reg = 0.1
    o.lambda_sky = 0.05
    o.lambda_depth_lidar = 0.01
    o.lambda_lpips = 0.5
    o.lpips_fallback = "random_features"
    o.densify_from_iter = 100
    o.densification_interval = 50
    o.densify_until_iter = 200
    o.opacity_reset_interval = 150
    cfg.train.iterations = TRAIN_ITERS
    cfg.train.test_iterations = [TRAIN_ITERS]
    cfg.train.checkpoint_iterations = [TRAIN_ITERS]
    cfg.train.save_iterations = [TRAIN_ITERS]
    cfg.train.log_interval = 50
    return cfg


def n_valid(params) -> int:
    return sum(getattr(params, p).num_valid() for p in ("bkgd", "actors",
                                                        "sky")
               if getattr(params, p) is not None)


def train_main_path(G, source_path: str, tmp: str, gpu: str) -> dict:
    """Phase 6: runner.train.main from scene init, resume, render."""
    import torch
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.runner import render as R
    from street_crafter_tpu_torch.runner import train as T
    from street_crafter_tpu_torch.utils.png import read_png
    cfg = train_config(default_config())
    cfg.source_path = source_path
    cfg.model_path = os.path.join(tmp, "train_model")
    cfg.device = "cuda"
    cfg.data.cameras = [0, 1, 2]
    cfg.render.save_video = False
    cfg_path = os.path.join(tmp, "train.json")
    save_config(cfg, cfg_path)
    fresh = cfg.clone()
    fresh.resume = False
    t0 = time.perf_counter()
    init = T.GSTrainer(fresh, create_scene(fresh))
    before = init.evaluate(cameras="train")
    valid0 = n_valid(init.state.params)
    cam0 = init.scene.train_cameras[0]
    del init
    log(f"[6] scene init in {time.perf_counter() - t0:.1f} s: "
        f"{valid0} valid splats, train-view PSNR {before['psnr']:.3f} dB "
        f"before training ({cam0.width}x{cam0.height})")

    losses = []
    G.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = T.main(["--config", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(G.launches)
    after = trainer.evaluate(cameras="train")
    valid1 = n_valid(trainer.state.params)
    import json as _json
    with open(os.path.join(cfg.model_path, "logs", "metrics.jsonl")) as f:
        for line in f:
            rec = _json.loads(line)
            if "train/loss" in rec:
                losses.append(rec["train/loss"])
            if "eval/psnr" in rec:
                evals = rec
    log(f"[6] runner.train.main: {TRAIN_ITERS} iterations in {wall:.1f} s "
        f"({1e3 * wall / TRAIN_ITERS:.1f} ms/iteration incl. eval, "
        f"checkpoint and PLY); launches {counts}; card {gpu}")
    log(f"[6] loss every 50 iterations: "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; eval at {TRAIN_ITERS}: PSNR {evals['eval/psnr']:.3f} L1 "
        f"{evals['eval/l1']:.4f} ({evals['eval/n_pairs']:.0f} pairs/view); "
        f"train-view PSNR {before['psnr']:.3f} -> {after['psnr']:.3f} dB; "
        f"valid splats {valid0} -> {valid1}")
    if not (losses and all(np.isfinite(losses))):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not after["psnr"] > before["psnr"]:
        raise AssertionError("training did not raise the train-view PSNR")
    if valid1 == valid0:
        raise AssertionError("densify did not change the valid count")
    if counts.get("composite_backward", 0) < TRAIN_ITERS or \
            counts.get("composite_backward_reference", 0):
        raise AssertionError(f"training missed kernel C or ran the plain "
                             f"backward: {counts}")
    ply = os.path.join(cfg.model_path, "point_cloud",
                       f"iteration_{TRAIN_ITERS}", "point_cloud.ply")
    if not os.path.getsize(ply) > 0:
        raise AssertionError("no PLY export")
    del trainer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resumed = T.main(["--config", cfg_path,
                      f"train.iterations={TRAIN_ITERS + RESUME_ITERS}"])
    if (resumed.start_iter, resumed.state.step) != (
            TRAIN_ITERS + 1, TRAIN_ITERS + RESUME_ITERS):
        raise AssertionError("resume did not continue at the checkpoint")
    log(f"[6] resumed at {resumed.start_iter}, {RESUME_ITERS} iterations in "
        f"{time.perf_counter() - t0:.1f} s")
    del resumed
    torch.cuda.empty_cache()

    G.reset_launch_counts()
    result = R.main(["--config", cfg_path, "mode=trajectory",
                     "render.save_video=false"])
    render_counts = dict(G.launches)
    if set(render_counts) != {"tile_worklist", "composite"}:
        raise AssertionError(f"the render of the trained checkpoint ran a "
                             f"plain version or a backward: {render_counts}")
    rgb_dir = os.path.join(result["out_dir"], "rgb")
    pngs = sorted(os.listdir(rgb_dir))
    for name in pngs:
        img = read_png(os.path.join(rgb_dir, name))
        if img.shape != (1067, 1600, 3) or img.max() == 0:
            raise AssertionError(f"{name}: shape {img.shape}, max "
                                 f"{img.max()}")
    if len(pngs) != 12:
        raise AssertionError(f"expected 12 rgb PNGs, got {pngs}")
    log(f"[6] render of the trained checkpoint: {len(pngs)} PNGs, "
        f"ms/frame median {statistics.median(result['frame_ms']):.2f}, "
        f"test PSNR {result['psnr']:.3f}; launches {render_counts}")
    return counts


class StageTimer:
    """Wraps module functions so each call synchronises before and after
    and adds its wall time to a named stage (phase 7 only)."""

    def __init__(self):
        import torch
        self.sync = torch.cuda.synchronize
        self.ms: dict[str, float] = {}
        self._undo = []

    def wrap(self, module, attr: str, stage: str) -> None:
        fn = getattr(module, attr)

        def timed(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.sync()
            self.ms[stage] = self.ms.get(stage, 0.0) + \
                1e3 * (time.perf_counter() - t0)
            return out
        setattr(module, attr, timed)
        self._undo.append((module, attr, fn))

    def restore(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)


def step_time(G, cfg, dev, gpu: str) -> None:
    """Phase 7: the trainer's own train step on the 600k pool."""
    import torch
    from street_crafter_tpu_torch.models.gs import renderer as RN
    from street_crafter_tpu_torch.models.gs.params import GaussianPool
    from street_crafter_tpu_torch.ops.lpips import random_feature_lpips
    from street_crafter_tpu_torch.training import gs_trainer as GT
    scene, params, cam, batch = headline_scene(cfg, dev)
    pad = BKGD_CAPACITY - params.bkgd.capacity
    bkgd = GaussianPool(**{
        k: torch.cat([v, torch.zeros((pad,) + v.shape[1:], dtype=v.dtype,
                                     device=dev)])
        for k, v in dataclasses.asdict(params.bkgd).items()})
    C, F, A = scene.meta.track_valid.shape
    params = dataclasses.replace(
        params, bkgd=bkgd, opt_trans=torch.zeros((C, F, A, 3), device=dev),
        opt_theta=torch.zeros((C, F, A, 1), device=dev))
    tcfg = train_config(cfg.clone())
    state = GT.init_train_state(params)
    step = GT.make_train_step(
        tcfg, scene.meta, spatial_lr_scale=scene.extent,
        lpips_fn=random_feature_lpips(device=dev), active_sh_degree=1,
        with_obj_acc=True,
        generator=torch.Generator(device=dev).manual_seed(0))

    def one():
        step(state, cam, batch)
        torch.cuda.synchronize()

    for _ in range(5):
        one()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        one()
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    log(f"[7] train step, {N_HEAVY} splats in {BKGD_CAPACITY} bkgd slots + "
        f"actors {tuple(params.actors.xyz.shape[:2])} + sky "
        f"{params.sky.capacity}, {cam.width}x{cam.height}, full loss stack "
        f"(L1, D-SSIM, LPIPS stand-in, sky, obj-acc, LiDAR depth): median "
        f"{statistics.median(ms):.2f} ms (min {min(ms):.2f}, max "
        f"{max(ms):.2f}) over 20 steps; max_memory_allocated "
        f"{peak / 2 ** 30:.2f} GiB; TF32 off; card {gpu}")

    timer = StageTimer()
    timer.wrap(RN, "flatten_scene", "flatten")
    timer.wrap(RN, "raster_inputs", "projection+SH")
    timer.wrap(G, "tile_worklist", "kernel A")
    timer.wrap(G, "composite", "kernel B")
    timer.wrap(GT, "compute_train_loss", "loss (L1/SSIM/LPIPS/...)")
    timer.wrap(G, "composite_backward", "kernel C")
    timer.wrap(GT, "adam_update", "Adam")
    timer.wrap(GT, "accumulate_stats", "stats")
    n_split = 5
    total_ms = []
    try:
        for _ in range(n_split):
            t0 = time.perf_counter()
            one()
            total_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        timer.restore()
    split = {k: v / n_split for k, v in timer.ms.items()}
    whole = statistics.mean(total_ms)
    # what no forward, Adam or stats wrapper covers: autograd's backward
    # (kernel C within it), plus the hooks' small ops and zeroing the grads
    split["backward total (kernel C within it)"] = whole - sum(
        v for k, v in split.items() if k != "kernel C")
    log(f"[7] split, synchronised after each stage, mean of {n_split} "
        f"steps (ms; fg, sky and objects-only passes summed): "
        + "; ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; whole step with the syncs {whole:.2f}")

    busy, wall, n, top = busy_share(lambda: [one() for _ in range(3)])
    if not n:
        log("[7] torch.profiler recorded no device kernels: busy share not "
            "measured")
        return
    log(f"[7] torch.profiler over 3 steps: {n} device kernels, "
        f"{busy:.2f} ms busy of {wall:.2f} ms wall: device busy "
        f"{100 * busy / wall:.1f}%, idle "
        f"{100 - 100 * busy / wall:.1f}%; by kernel (ms, launches): "
        + "; ".join(f"{k[:48]} {v[0] / 1e3:.2f} x{v[1]}" for k, v in top))


# ---------------------------------------------------------------------------
# phases 8-10: the video diffusion sampler (kernels D, E and F)
# ---------------------------------------------------------------------------

VDM_SOURCES = {
    "flash_attention": "street_crafter_tpu_torch/csrc/flash_attention.cu",
    "temporal_block_fused": "street_crafter_tpu_torch/csrc/temporal_block.cu",
    "temporal_attention_fused":
        "street_crafter_tpu_torch/csrc/temporal_block.cu"}
VDM_REPLACES = {
    "flash_attention": "street_crafter_tpu/ops/flash_attention.py:29",
    "temporal_block_fused": "street_crafter_tpu/ops/temporal_block.py:72",
    "temporal_attention_fused": "street_crafter_tpu/ops/temporal_block.py:138"}
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
VDM_STEPS = 3                 # Euler steps of phase 9 (the work per step
                              # does not depend on the number of steps)
# kernels D, E and F against their plain versions, in bf16: the largest
# error over the largest |reference| and the median error over it. The
# kernels sum in another order, kernel D rounds its probabilities to bf16
# against a running max (the plain version against the final one), and
# both sides round the same bf16 intermediates, so an intermediate that
# rounds the other way moves an output by a bf16 ulp or two
BF16_MAX_REL, BF16_MED_REL = 2e-2, 2e-3
# main-path shapes of one CFG UNet eval (2 x 25 frames, latents 72 x 128):
# kernel D [B*T, S, heads, 64] at levels 0-2 (5 sites each); kernel E
# (B, T, S, C, heads) at level 0 (5 sites); kernel F at level 1, level 2 and
# the mid block (5 + 5 + 1 sites)
D_SHAPES = [(50, 9216, 5, 64), (50, 2304, 10, 64), (50, 576, 20, 64)]
E_SHAPES = [(2, 25, 9216, 320, 5)]
F_SHAPES = [(2, 25, 2304, 640, 10), (2, 25, 576, 1280, 20),
            (2, 25, 144, 1280, 20)]
PER_STEP = {"flash_attention": 15, "temporal_block_fused": 5,
            "temporal_attention_fused": 11}


def bf16_errors(got, want) -> dict:
    d = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    return {"abs": float(d.max()), "max_rel": float(d.max()) / top,
            "med_rel": float(d.median()) / top, "ref_max": top}


def check_errors(label: str, e: dict, phase: int) -> None:
    log(f"[{phase}] {label}: largest error {e['abs']:.4g} = "
        f"{e['max_rel']:.3e} of the largest |reference| {e['ref_max']:.4g}, "
        f"median error {e['med_rel']:.3e} of it (tolerances {BF16_MAX_REL} "
        f"and {BF16_MED_REL})")
    if e["max_rel"] > BF16_MAX_REL or e["med_rel"] > BF16_MED_REL:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version")


def attn_inputs(dev, b, s, h, d, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3)]


def plain_attention(FA, q, k, v):
    """Kernel D's plain version over [B, S, H, D] in chunks of batch*heads
    (the f32 scores of one (batch, head) at S = 9216 are 340 MB)."""
    import torch
    out = torch.empty_like(q)
    S = q.shape[1]
    hc = max(1, min(q.shape[2], (2 << 30) // (S * S * 4)))
    for b in range(q.shape[0]):
        for h0 in range(0, q.shape[2], hc):
            sl = (slice(b, b + 1), slice(None), slice(h0, h0 + hc))
            out[sl] = FA.flash_attention_reference(q[sl], k[sl], v[sl])
    return out


def stage_inputs(dev, B, T, S, C, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=g, device=dev) * sc).to(
            torch.bfloat16)
    inner = 4 * C
    w = dict(norm_in_s=1 + r(C, sc=.1), norm_in_b=r(C, sc=.1),
             ffin_w1=r(2 * inner, C, sc=C ** -.5), ffin_b1=r(2 * inner, sc=.1),
             ffin_w2=r(C, inner, sc=inner ** -.5), ffin_b2=r(C, sc=.1),
             norm1_s=1 + r(C, sc=.1), norm1_b=r(C, sc=.1),
             wqkv=r(3 * C, C, sc=C ** -.5), wout=r(C, C, sc=C ** -.5),
             bout=r(C, sc=.1), norm3_s=1 + r(C, sc=.1), norm3_b=r(C, sc=.1),
             ff_w1=r(2 * inner, C, sc=C ** -.5), ff_b1=r(2 * inner, sc=.1),
             ff_w2=r(C, inner, sc=inner ** -.5), ff_b2=r(C, sc=.1))
    return r(B * T, S, C), r(B * T, C, sc=.3), r(B, C, sc=.2), w


def e_args(TB, dev, B, T, S, C, heads, seed):
    h, emb, bias, w = stage_inputs(dev, B, T, S, C, seed)
    return ((h, emb, 0.3, bias, *[w[k] for k in TB._BLOCK_WEIGHTS]),
            dict(num_frames=T, heads=heads, dim_head=C // heads))


def f_args(TB, dev, B, T, S, C, heads, seed):
    h, _, bias, w = stage_inputs(dev, B, T, S, C, seed)
    return ((h, bias, *[w[k] for k in ("norm1_s", "norm1_b", "wqkv", "wout",
                                       "bout")]),
            dict(num_frames=T, heads=heads, dim_head=C // heads))


def compare_vdm_kernels() -> dict:
    """Phase 8: kernels D, E and F against their plain versions, first at
    small shapes with ragged edges, then at every main-path shape. Returns
    the largest absolute error per kernel over the main-path shapes."""
    import torch
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    dev = torch.device("cuda", 0)
    worst = {}
    small_d = [(2, 100, 75, 3, 64), (1, 100, 75, 2, 128),
               (1, 75, 100, 2, 128)]
    for i, (b, sq, skv, h, d) in enumerate(small_d):
        q, _, _ = attn_inputs(dev, b, sq, h, d, i)
        _, k, v = attn_inputs(dev, b, skv, h, d, i + 10)
        e = bf16_errors(FA.flash_attention(q, k, v),
                        FA.flash_attention_reference(q, k, v))
        check_errors(f"kernel D q {sq} x kv {skv}, {h} heads x {d}", e, 8)
    for i, (B, T, S, C, heads) in enumerate([(2, 25, 100, 64, 1),
                                             (1, 25, 75, 320, 5)]):
        args, kw = e_args(TB, dev, B, T, S, C, heads, i)
        e = bf16_errors(TB.temporal_block_fused(*args, **kw),
                        TB.temporal_block_fused_reference(*args, **kw))
        check_errors(f"kernel E {B}x{T} frames, S {S}, C {C}", e, 8)
    for i, (B, T, S, C, heads) in enumerate([(2, 25, 75, 640, 10),
                                             (2, 25, 75, 1280, 20)]):
        args, kw = f_args(TB, dev, B, T, S, C, heads, i)
        e = bf16_errors(TB.temporal_attention_fused(*args, **kw),
                        TB.temporal_attention_fused_reference(*args, **kw))
        check_errors(f"kernel F {B}x{T} frames, S {S}, C {C}", e, 8)
    for i, (b, s, h, d) in enumerate(D_SHAPES):
        q, k, v = attn_inputs(dev, b, s, h, d, 100 + i)
        e = bf16_errors(FA.flash_attention(q, k, v),
                        plain_attention(FA, q, k, v))
        check_errors(f"kernel D main path [{b}, {s}, {h}, {d}]", e, 8)
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0),
                                       e["abs"])
        del q, k, v
    for name, shapes, make, plain in (
            ("temporal_block_fused", E_SHAPES, e_args,
             TB.temporal_block_fused_reference),
            ("temporal_attention_fused", F_SHAPES, f_args,
             TB.temporal_attention_fused_reference)):
        for i, (B, T, S, C, heads) in enumerate(shapes):
            args, kw = make(TB, dev, B, T, S, C, heads, 200 + i)
            e = bf16_errors(getattr(TB, name)(*args, **kw),
                            plain(*args, **kw))
            check_errors(f"{name} main path [{B * T}, {S}, {C}]", e, 8)
            worst[name] = max(worst.get(name, 0.0), e["abs"])
            del args
    torch.cuda.empty_cache()
    return worst


def vdm_clip_root(tmp: str) -> str:
    """Phase 9's data: a synthetic scene at 1920x1280 (26 frames, camera
    0), stand-in LiDAR condition renders (the camera image at a seeded
    sparse mask, and the mask) and its meta_info_val.json."""
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    from street_crafter_tpu_torch.datasets.vdm_data import prepare_meta
    from street_crafter_tpu_torch.utils.png import read_png, write_png
    root = os.path.join(tmp, "vdm_data")
    scene = make_scene(root, num_frames=26, img_hw=(1280, 1920),
                       image_cameras=(0,))
    rng = np.random.default_rng(0)
    out = os.path.join(scene, "lidar", "color_render")
    for f in range(26):
        img = read_png(os.path.join(scene, "images", f"{f:06d}_0.png"))
        mask = rng.random(img.shape[:2]) < 0.05
        write_png(os.path.join(out, f"{f:06d}_0.png"),
                  (img[..., :3] * mask[..., None]).astype(np.uint8))
        write_png(os.path.join(out, f"{f:06d}_0_mask.png"),
                  (mask * 255).astype(np.uint8))
    prepare_meta(root, [os.path.basename(scene)], "meta_info_val.json")
    return root


def vdm_main_path(tmp: str, gpu: str) -> tuple[dict, str, float]:
    """Phase 9: runner.vdm_sample.main at full width, seeded random weights
    with the zero-initialised output layers perturbed, VDM_STEPS Euler
    steps. Returns (launch counts, config path, peak GiB)."""
    import torch
    from street_crafter_tpu_torch.models.vdm.engine import \
        VideoDiffusionEngine
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    from street_crafter_tpu_torch.utils.png import read_png
    t0 = time.perf_counter()
    root = vdm_clip_root(tmp)
    log(f"[9] data: 26 frames at 1920x1280 + condition renders + "
        f"meta_info_val.json in {time.perf_counter() - t0:.1f} s")
    cfg = {"device": "cuda", "model_path": os.path.join(tmp, "vdm_out"),
           "diffusion": {"tiny": False, "num_steps": VDM_STEPS,
                         "ckpt_path": "", "init_zero_layers_std": 1.0},
           "vdm_train": {"data_root": root, "height": 576, "width": 1024,
                         "num_frames": 25},
           "render": {"save_video": False}}
    cfg_path = os.path.join(tmp, "vdm.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    # the sample ends in a clamp to [-1, 1]: keep the latents and the
    # decoded frames before it, so that their check can fail
    seen = {}
    decode = VideoDiffusionEngine.decode_latents_chunked

    def decode_and_keep(self, z, chunk=8, overlap=3):
        out = decode(self, z, chunk=chunk, overlap=overlap)
        seen["latents"], seen["decoded"] = z.float(), out.float()
        return out

    FA.reset_launch_counts()
    TB.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    VideoDiffusionEngine.decode_latents_chunked = decode_and_keep
    t0 = time.perf_counter()
    try:
        res = VS.main(["--config", cfg_path])
        torch.cuda.synchronize()
    finally:
        VideoDiffusionEngine.decode_latents_chunked = decode
    wall = time.perf_counter() - t0
    counts = {**FA.launches, **TB.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frames = res["frames"]
    log(f"[9] runner.vdm_sample.main: 1 clip, 25 frames at 576x1024, "
        f"{VDM_STEPS} Euler steps, CFG 2.5, in {wall:.1f} s (sample "
        f"{res['sample_s'][0]:.1f} s incl. encode, CLIP, decode; engine "
        f"build and data loading outside it); launches {counts}; "
        f"max_memory_allocated {peak:.2f} GiB; card {gpu}")
    want = {k: v * VDM_STEPS for k, v in PER_STEP.items()}
    if counts != want:
        raise AssertionError(f"the main path's launches {counts} are not "
                             f"{PER_STEP} per Euler step x {VDM_STEPS}")
    if frames.shape != (25, 576, 1024, 3) or not np.isfinite(frames).all() \
            or np.abs(frames).max() > 1.0:
        raise AssertionError(f"samples: shape {frames.shape}, finite "
                             f"{np.isfinite(frames).all()}, max |x| "
                             f"{np.abs(frames).max()}")
    # before the clamp: finite latents and frames, neither constant nor
    # blown up (a saturated decode would be clamped almost everywhere)
    z, dec = seen["latents"], seen["decoded"]
    z_std, dec_std = float(z.std()), float(dec.std())
    clamped = float((dec.abs() > 1.0).float().mean())
    log(f"[9] before the clamp: latents {tuple(z.shape)} mean "
        f"{float(z.mean()):.4f} std {z_std:.4f}; decoded std {dec_std:.4f}, "
        f"max |x| {float(dec.abs().max()):.3f}, share clamped {clamped:.4f}")
    if z.shape[0] != 25 or z.numel() != 25 * 72 * 128 * 4 \
            or not bool(torch.isfinite(z).all()) \
            or not bool(torch.isfinite(dec).all()) \
            or not 1e-3 < z_std < 1e3 or not dec_std > 1e-3 \
            or not clamped < 0.9:
        raise AssertionError(
            f"before the clamp: latents {tuple(z.shape)} std {z_std} (want "
            f"finite, in (1e-3, 1e3)); decoded std {dec_std} (want finite, "
            f"> 1e-3), share clamped {clamped} (want < 0.9)")
    pngs = sorted(os.listdir(res["clips"][0]))
    img = read_png(os.path.join(res["clips"][0], pngs[-1]))
    if len(pngs) != 25 or img.shape != (3 * 576, 1024, 3):
        raise AssertionError(f"{len(pngs)} PNGs, last {img.shape}")
    log(f"[9] 25 PNGs {img.shape[1]}x{img.shape[0]} (gt | condition | "
        f"sample); sample mean {frames.mean():.4f} std {frames.std():.4f} "
        f"min {frames.min():.3f} max {frames.max():.3f}")
    return counts, cfg_path, peak


def sync_ms(fn, reps: int, warmup: int = 1) -> list[float]:
    """Host-clock ms of ``reps`` calls, each ending in a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def busy_share(fn) -> tuple[float, float, int, list]:
    """torch.profiler over one call: (busy ms, wall ms, kernels, top)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, -1.0
    for s0, s1 in spans:
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    by_name: dict[str, list] = {}
    for e in kern:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return busy / 1e3, wall, len(kern), top


def vdm_times(cfg_path: str, gpu: str) -> None:
    """Phase 10, end to end: one CFG UNet eval, wall per Euler step, the
    VAE encode of the guidance frames, the chunked decode, CLIP, and the
    device-busy share of one step."""
    import torch
    from street_crafter_tpu_torch.config import default_config, load_config
    from street_crafter_tpu_torch.models.vdm import diffusion as D
    from street_crafter_tpu_torch.models.vdm.samplers import euler_edm_sample
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    cfg = default_config()
    cfg.merge(load_config(cfg_path))
    eng = VS.build_engine(cfg, 25)
    dev = eng.device
    g = torch.Generator(device=dev).manual_seed(1)
    guide = torch.rand((25, 576, 1024, 3), generator=g, device=dev) * 2 - 1
    enc = sync_ms(lambda: eng.encode_images_chunked(guide, 8), 2)
    clip = sync_ms(lambda: eng.clip_embed(guide[:1]), 3)
    lat = eng.encode_images_chunked(guide, 8)
    cond, uc = eng.build_conditioning(guide[:1])
    cm = torch.zeros(25, device=dev)
    cm[0] = 1.0
    denoise = eng.make_cfg_denoise_fn(cond, uc, lat, cm)
    x = torch.randn((25, 72, 128, 4), generator=g, device=dev)
    sigma = torch.full((25,), 10.0, device=dev)
    unet = sync_ms(lambda: denoise(x, sigma), 3)
    sig2 = D.edm_sigmas(2, device=dev)          # 2 Euler steps
    step = [t / 2 for t in sync_ms(
        lambda: euler_edm_sample(denoise, x, sig2), 2)]
    dec = sync_ms(lambda: eng.decode_latents_chunked(lat, 8), 1)
    log(f"[10] CFG UNet eval (2 x 25 frames at 72x128, bf16): median "
        f"{statistics.median(unet):.1f} ms of {[round(t, 1) for t in unet]}"
        f"; wall per Euler step {statistics.median(step):.1f} ms; VAE encode"
        f" of 25 guidance frames (chunks of 8) {statistics.median(enc):.1f}"
        f" ms; chunked decode of 25 frames (8, overlap 3) {dec[0]:.1f} ms; "
        f"CLIP {statistics.median(clip):.1f} ms; card {gpu}")
    busy, wall, n, top = busy_share(
        lambda: euler_edm_sample(denoise, x, D.edm_sigmas(1, device=dev)))
    if n:
        log(f"[10] torch.profiler over one Euler step: {n} device kernels, "
            f"{busy:.1f} ms busy of {wall:.1f} ms wall: device busy "
            f"{100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%"
            f"; by kernel (ms, launches): "
            + "; ".join(f"{k[:56]} {v[0] / 1e3:.2f} x{v[1]}"
                        for k, v in top))
    else:
        log("[10] torch.profiler recorded no device kernels: busy share not "
            "measured")
    del eng, denoise, cond, uc, lat, guide
    torch.cuda.empty_cache()


def vdm_bound(nbytes: float, flops: float) -> dict:
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def vdm_kernel_times(gpu: str) -> dict:
    """Phase 10, per kernel at every main-path shape: CUDA-event ms, the
    plain version's ms, the bound and, for kernel D, one call of
    torch.nn.functional.scaled_dot_product_attention on the same inputs
    (timed only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    dev = torch.device("cuda", 0)
    rows = {"flash_attention": [], "temporal_block_fused": [],
            "temporal_attention_fused": []}
    for i, (b, s, h, d) in enumerate(D_SHAPES):
        q, k, v = attn_inputs(dev, b, s, h, d, 300 + i)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rows["flash_attention"].append({
            "shape": [b, s, h, d],
            "ms": cuda_ms(lambda: FA.flash_attention(q, k, v), 5),
            "plain_ms": cuda_ms(lambda: plain_attention(FA, q, k, v), 1,
                              warmup=0),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), 5),
            **vdm_bound(2 * 4 * b * s * h * d, 4 * s * s * d * b * h)})
        del q, k, v, qt, kt, vt
    for name, shapes, make, plain, full in (
            ("temporal_block_fused", E_SHAPES, e_args,
             TB.temporal_block_fused_reference, True),
            ("temporal_attention_fused", F_SHAPES, f_args,
             TB.temporal_attention_fused_reference, False)):
        for i, (B, T, S, C, heads) in enumerate(shapes):
            args, kw = make(TB, dev, B, T, S, C, heads, 400 + i)
            cost = TB.stage_cost(B, T, S, C, full)
            rows[name].append({
                "shape": [B * T, S, C],
                "ms": cuda_ms(lambda: getattr(TB, name)(*args, **kw), 5),
                "plain_ms": cuda_ms(lambda: plain(*args, **kw), 1, warmup=0),
                "library_ms": None,
                **vdm_bound(cost["bytes"], cost["flops"])})
            del args
    for name, rs in rows.items():
        for r in rs:
            log(f"[10] {name} {r['shape']}: kernel {r['ms']:.3f} ms, bound "
                f"{r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.1f} ms"
                + (f", scaled_dot_product_attention {r['library_ms']:.3f} ms"
                   if r["library_ms"] is not None else "")
                + f"; {gpu}")
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phases 11-13: the video diffusion fine-tune (kernel D with lse, G and H)
# ---------------------------------------------------------------------------

BWD_REPLACES = {
    "flash_attention_bwd_dkv": "street_crafter_tpu/ops/flash_attention.py:195",
    "flash_attention_bwd_dq": "street_crafter_tpu/ops/flash_attention.py:246"}
# the training shapes [B*T, S, heads, 64] at levels 0-2 (25 frames, no CFG
# doubling; 5 sites each)
TRAIN_SHAPES = [(25, 9216, 5, 64), (25, 2304, 10, 64), (25, 576, 20, 64)]
# per train step under flash0: 15 forwards with lse + the 10 of levels 1-2
# recomputed, and one G and one H per site
TRAIN_PER_STEP = {"flash_attention_lse": 25, "flash_attention_bwd_dkv": 15,
                  "flash_attention_bwd_dq": 15}
TRAIN_STEPS = 3            # phase 12's first run; then 1 resumed step


def train_attn_case(dev, b, sq, skv, h, d, seed):
    """q, k, v and a seeded cotangent do, bf16."""
    import torch
    q, _, _ = attn_inputs(dev, b, sq, h, d, seed)
    _, k, v = attn_inputs(dev, b, skv, h, d, seed + 1)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    do = torch.randn((b, sq, h, d), generator=g, device=dev).to(
        torch.bfloat16)
    return q, k, v, do


def train_kernels_vs_plain(FA, q, k, v, do, label: str) -> dict:
    """Kernel D with lse, G and H against their plain versions on the same
    inputs (the plain lse and delta feed both backwards). Returns the
    largest absolute error per kernel."""
    import torch
    o, lse = FA._flash_cuda(q, k, v, with_lse=True)
    o_ref, lse_ref = FA.flash_attention_lse_reference(q, k, v)
    delta = FA.attention_delta(o_ref, do)
    dk, dv = FA._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta)
    dq = FA._flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta)
    dk_ref, dv_ref = FA.flash_attention_bwd_dkv_reference(q, k, v, do,
                                                          lse_ref, delta)
    dq_ref = FA.flash_attention_bwd_dq_reference(q, k, v, do, lse_ref,
                                                 delta)
    torch.cuda.synchronize()
    worst = {}
    for kernel, name, got, want in (
            ("flash_attention", "o", o, o_ref),
            ("flash_attention", "lse", lse, lse_ref),
            ("flash_attention_bwd_dkv", "dk", dk, dk_ref),
            ("flash_attention_bwd_dkv", "dv", dv, dv_ref),
            ("flash_attention_bwd_dq", "dq", dq, dq_ref)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label} {name}: not finite")
        e = bf16_errors(got, want)
        check_errors(f"{label} {name}", e, 11)
        worst[kernel] = max(worst.get(kernel, 0.0), e["abs"])
    return worst


def compare_train_kernels() -> dict:
    """Phase 11: D with lse, G and H at small ragged shapes, then at the
    training shapes. Returns the largest absolute error per kernel over the
    training shapes."""
    import torch
    from street_crafter_tpu_torch.ops import flash_attention as FA
    dev = torch.device("cuda", 0)
    for i, (b, sq, skv, h, d) in enumerate([(2, 100, 75, 3, 64),
                                            (1, 75, 100, 2, 128),
                                            (1, 300, 257, 2, 64)]):
        train_kernels_vs_plain(FA, *train_attn_case(dev, b, sq, skv, h, d,
                                                    500 + 10 * i),
                               f"q {sq} x kv {skv}, {h} heads x {d}")
    worst: dict = {}
    for i, (b, s, h, d) in enumerate(TRAIN_SHAPES):
        e = train_kernels_vs_plain(
            FA, *train_attn_case(dev, b, s, s, h, d, 600 + 10 * i),
            f"training shape [{b}, {s}, {h}, {d}]")
        for kname, err in e.items():
            worst[kname] = max(worst.get(kname, 0.0), err)
        torch.cuda.empty_cache()
    return worst


def vdm_train_config(tmp: str, root: str, steps: int) -> str:
    cfg = {"device": "cuda", "model_path": os.path.join(tmp, "vdm_train"),
           "diffusion": {"tiny": False, "ckpt_path": "",
                         "init_zero_layers_std": 1.0,
                         "remat_policy": "flash0"},
           "vdm_train": {"data_root": root, "height": 576, "width": 1024,
                         "num_frames": 25, "batch_size": 1,
                         "samples_per_epoch": steps, "epochs": 1,
                         "ckpt_every": 1000, "log_every": 1,
                         "log_images_every": 0, "num_workers": 2,
                         "slow_temporal_layers": True,
                         "slow_temporal_layers_scale": 0.0}}
    path = os.path.join(tmp, "vdm_train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


class ByteCount:
    """A write-only stream that counts what ``torch.save`` writes to it."""

    def __init__(self):
        self.n = 0

    def write(self, b) -> int:
        self.n += len(b)
        return len(b)

    def flush(self) -> None:
        pass


def vdm_train_main_path(tmp: str, gpu: str) -> tuple[dict, dict]:
    """Phase 12: runner.vdm_train.main at full width, TRAIN_STEPS steps with
    a checkpoint, one step resumed from it, the EMA export loaded back.
    Returns (the launch counts of both runs, {"trainer": the resumed
    trainer, "config": its config path, "peak_gib", "step_s"})."""
    import gc

    import torch
    from street_crafter_tpu_torch.datasets.vdm_data import prepare_meta
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    from street_crafter_tpu_torch.runner import vdm_train as VT
    from street_crafter_tpu_torch.training import vdm_trainer as TR
    from street_crafter_tpu_torch.utils import checkpoint as CK
    root = os.path.join(tmp, "vdm_data")
    scenes = [d for d in os.listdir(root)
              if os.path.isdir(os.path.join(root, d))]
    prepare_meta(root, scenes, "meta_info_train.json")
    path = vdm_train_config(tmp, root, TRAIN_STEPS)

    # per-step launch counts, and the masters the first run starts from
    per_step, start = [], {}
    step_fn, init_fn = TR.VDMTrainer.train_step, TR.VDMTrainer.__init__

    def counted_step(self, *a, **kw):
        before = {**FA.launches, **TB.launches}
        out = step_fn(self, *a, **kw)
        after = {**FA.launches, **TB.launches}
        per_step.append({k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)})
        return out

    def keeping_init(self, engine, masters=None, *a, **kw):
        if masters is not None and not start:
            start.update({k: m.to("cpu", copy=True)
                          for k, m in masters.items()})
        init_fn(self, engine, masters, *a, **kw)

    # the checkpoints: the first run's is written to disk (and timed); the
    # resumed run's is serialised into a byte count only, so that the whole
    # script writes under ~35 GB to disk: one checkpoint of the full-width
    # state (f32 masters, two moments, EMA) is ~24 GB
    saves = []
    save_fn = VT.save_vdm_checkpoint

    def timed_save(model_path, step, state):
        t = time.perf_counter()
        out = save_fn(model_path, step, state)
        size = os.path.getsize(os.path.join(out, CK.VDM_TRAIN_STATE_FILE))
        saves.append((time.perf_counter() - t, size))
        return out

    def counted_save(model_path, step, state):
        sink = ByteCount()
        t = time.perf_counter()
        torch.save(state.to_dict(), sink)
        saves.append((time.perf_counter() - t, sink.n))
        return CK.checkpoint_dir(model_path, step)

    FA.reset_launch_counts()
    TB.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    TR.VDMTrainer.train_step = counted_step
    TR.VDMTrainer.__init__ = keeping_init
    VT.save_vdm_checkpoint = timed_save
    t0 = time.perf_counter()
    try:
        res = VT.main(["--config", path])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tr = res["trainer"]
        with open(os.path.join(res["model_path"], "logs",
                               "metrics.jsonl")) as f:
            losses = [json.loads(line)["train/loss"] for line in f]
        log(f"[12] runner.vdm_train.main: {res['steps']} steps at full width "
            f"(25 frames at 576x1024, bf16 compute, f32 masters, flash0) in "
            f"{first_s:.1f} s incl. engine build, data, checkpoint and EMA "
            f"export; step s {[round(t, 2) for t in res['step_s']]}; losses "
            f"{[round(x, 4) for x in losses]}; max_memory_allocated "
            f"{peak:.2f} GiB; card {gpu}")
        if res["steps"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"steps {res['steps']}, losses {losses}")
        kept = 0
        base = [n for n, g in tr.labels.items() if g == "base"]
        slow = [n for n, g in tr.labels.items() if g == "slow"]
        still = []
        for name in base:
            if torch.equal(tr.state.masters[name].cpu(), start[name]):
                still.append(name)
        moved = len(base) - len(still)
        if still:
            log(f"[12] spatial leaves that did not move: {still[:12]}")
        for name in slow:
            m = tr.state.masters[name].cpu()
            p = tr.params[name].detach().cpu()
            kept += int(torch.equal(m, start[name])
                        and torch.equal(p, start[name].to(p.dtype)))
        # a length-1 context makes the cross-attention's softmax 1: its
        # query and key projections and the norm in front of them get no
        # gradient, in the JAX package too
        unused = {n for n in base if re.search(
            r"transformer_blocks\.\d+\.(attn2\.to_[qk]|norm2)\.", n)}
        ema_apart = sum(int(not torch.equal(tr.state.ema[n],
                                            tr.state.masters[n]))
                        for n in base if n not in unused)
        log(f"[12] spatial leaves moved {moved} of {len(base)} (unused by "
            f"the length-1 cross-attention: {len(unused)}); temporal "
            f"leaves bit-identical to their start {kept} of {len(slow)} "
            f"(masters and bf16 weights); EMA apart from the masters in "
            f"{ema_apart} of {len(base) - len(unused)} moved leaves")
        if set(still) != unused or kept != len(slow) or not slow \
                or ema_apart != len(base) - len(unused):
            raise AssertionError("the fine-tune's parameter groups did not "
                                 "train as the recipe says")
        del res, tr
        gc.collect()
        torch.cuda.empty_cache()

        VT.save_vdm_checkpoint = counted_save
        t0 = time.perf_counter()
        res = VT.main(["--config", path, "vdm_train.samples_per_epoch=1"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        TR.VDMTrainer.train_step = step_fn
        TR.VDMTrainer.__init__ = init_fn
        VT.save_vdm_checkpoint = save_fn
    counts = {**FA.launches, **TB.launches}
    tr = res["trainer"]
    log(f"[12] resumed: {res['steps']} step to step {tr.state.step} in "
        f"{resume_s:.1f} s incl. engine build, checkpoint load and EMA "
        f"export; checkpoints (s, bytes): written {saves[0][0]:.1f} s, "
        f"{saves[0][1]}; serialised only {saves[-1][0]:.1f} s, "
        f"{saves[-1][1]}; launches per step {per_step}")
    if res["steps"] != 1 or tr.state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"resume: {res['steps']} steps to "
                             f"{tr.state.step}")
    if len(saves) != 2 or abs(saves[1][1] - saves[0][1]) > 1e-3 * saves[0][1]:
        raise AssertionError(f"checkpoints {saves}: want one per run, of "
                             f"one size")
    for i, c in enumerate(per_step):
        if c != TRAIN_PER_STEP:
            raise AssertionError(f"step {i}: launches {c}, want exactly "
                                 f"{TRAIN_PER_STEP}")
    if len(per_step) != TRAIN_STEPS + 1:
        raise AssertionError(f"{len(per_step)} steps counted")

    from street_crafter_tpu_torch.config import default_config, load_config
    scfg = default_config()
    scfg.merge(load_config(path))
    scfg.diffusion.ckpt_path = res["ema_path"]
    eng = VS.build_engine(scfg, 25)
    bad = [n for n, p in eng.unet.named_parameters()
           if not torch.equal(p, tr.state.ema[n].to(p.dtype))]
    log(f"[12] EMA export {os.path.basename(res['ema_path'])} loaded by "
        f"runner.vdm_sample: {len(bad)} of "
        f"{len(list(eng.unet.parameters()))} UNet weights differ from the "
        f"trainer's EMA in bf16")
    if bad:
        raise AssertionError(f"EMA export differs: {bad[:5]}")
    del eng
    torch.cuda.empty_cache()
    return counts, {"trainer": tr, "config": path, "peak_gib": peak}


def vdm_train_times(train: dict, gpu: str) -> None:
    """Phase 13, end to end: the train step (encode included) and its split,
    peak memory and the device-busy share of one step."""
    import torch
    from street_crafter_tpu_torch.config import default_config, load_config
    from street_crafter_tpu_torch.runner import vdm_train as VT
    tr = train["trainer"]
    cfg = default_config()
    cfg.merge(load_config(train["config"]))
    clip = VT.build_sampler(cfg).datasets[0][0]
    batch_np = {k: clip[k][None] for k in ("img_seq", "guide_seq")}
    encode = VT.make_encode_fn(tr.engine)
    g = torch.Generator(device=tr.engine.device).manual_seed(5)

    def step():
        tr.train_step(encode(batch_np["img_seq"], batch_np["guide_seq"]),
                      generator=g)

    torch.cuda.reset_peak_memory_stats()
    steps = sync_ms(step, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    enc = sync_ms(lambda: encode(batch_np["img_seq"], batch_np["guide_seq"]),
                  2)
    # the split: synchronise around the loss (forward) and the optimizer
    split = {"forward": [], "optimizer + EMA": []}
    loss_fn, apply_fn = tr._loss, tr._apply

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    batch = encode(batch_np["img_seq"], batch_np["guide_seq"])
    tr._loss, tr._apply = timed("forward", loss_fn), timed(
        "optimizer + EMA", apply_fn)
    try:
        total = sync_ms(lambda: tr.train_step(batch, generator=g), 3,
                        warmup=0)
    finally:
        del tr._loss, tr._apply
    fwd = statistics.median(split["forward"])
    opt = statistics.median(split["optimizer + EMA"])
    tot = statistics.median(total)
    log(f"[13] train step (1 clip of 25 frames at 576x1024, encode "
        f"included): median {statistics.median(steps):.1f} ms of "
        f"{[round(t, 1) for t in steps]}; split: encode "
        f"{statistics.median(enc):.1f} ms, forward {fwd:.1f} ms, backward "
        f"(and the f32 gradient copies) {tot - fwd - opt:.1f} ms, optimizer "
        f"+ EMA {opt:.1f} ms (step without encode {tot:.1f} ms); peak "
        f"max_memory_allocated {peak:.2f} GiB (phase 12 {train['peak_gib']:.2f}"
        f" GiB); card {gpu}")
    busy, wall, n, top = busy_share(step)
    if n:
        log(f"[13] torch.profiler over one train step: {n} device kernels, "
            f"{busy:.1f} ms busy of {wall:.1f} ms wall: device busy "
            f"{100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%"
            f"; by kernel (ms, launches): "
            + "; ".join(f"{k[:56]} {v[0] / 1e3:.2f} x{v[1]}"
                        for k, v in top))
    else:
        log("[13] torch.profiler recorded no device kernels: busy share not "
            "measured")


def vdm_train_kernel_times(gpu: str) -> dict:
    """Phase 13, per kernel at each training shape: CUDA-event ms of D with
    lse, G and H, their plain versions' ms, their bounds, and one
    scaled_dot_product_attention forward (with grad, beside D) or backward
    (dq, dk, dv in one call, beside G + H) on the same inputs (timed only;
    the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from street_crafter_tpu_torch.ops import flash_attention as FA
    dev = torch.device("cuda", 0)
    rows = {"flash_attention": [], "flash_attention_bwd_dkv": [],
            "flash_attention_bwd_dq": []}
    for i, (b, s, h, d) in enumerate(TRAIN_SHAPES):
        q, k, v, do = train_attn_case(dev, b, s, s, h, d, 700 + 10 * i)
        o, lse = FA._flash_cuda(q, k, v, with_lse=True)
        delta = FA.attention_delta(o, do)
        x = b * s * h * d * 2            # bytes of one [B, S, H, D] bf16
        r = b * h * s * 4                # bytes of one [B, H, S] f32
        ops = s * s * d * b * h
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 3)
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt,
                                                                   vt), 3)
        del out
        for name, kern, plain, nbytes, flops, lib in (
                ("flash_attention",
                 lambda: FA._flash_cuda(q, k, v, with_lse=True),
                 lambda: FA.flash_attention_lse_reference(q, k, v),
                 4 * x + r, 4 * ops, sdpa_fwd),
                ("flash_attention_bwd_dkv",
                 lambda: FA._flash_bwd_dkv_cuda(q, k, v, do, lse, delta),
                 lambda: FA.flash_attention_bwd_dkv_reference(
                     q, k, v, do, lse, delta),
                 6 * x + 2 * r, 8 * ops, sdpa_bwd),
                ("flash_attention_bwd_dq",
                 lambda: FA._flash_bwd_dq_cuda(q, k, v, do, lse, delta),
                 lambda: FA.flash_attention_bwd_dq_reference(
                     q, k, v, do, lse, delta),
                 5 * x + 2 * r, 6 * ops, sdpa_bwd)):
            rows[name].append({
                "shape": [b, s, h, d], "ms": cuda_ms(kern, 5),
                "plain_ms": cuda_ms(plain, 1, warmup=0),
                "library_ms": lib, **vdm_bound(nbytes, flops)})
        del q, k, v, do, o, lse, delta, qt, kt, vt
        torch.cuda.empty_cache()
    for name, rs in rows.items():
        what = ("scaled_dot_product_attention forward with grad"
                if name == "flash_attention" else
                "scaled_dot_product_attention backward (dq, dk, dv: G + H)")
        for r in rs:
            log(f"[13] {name} (training) {r['shape']}: kernel "
                f"{r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                f"({r['bound_by']}), plain {r['plain_ms']:.1f} ms, {what} "
                f"{r['library_ms']:.3f} ms; {gpu}")
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from street_crafter_tpu_torch.models.gs.scene import FlatGaussians
    from street_crafter_tpu_torch.ops import cuda_build
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.runner import render as R
    from street_crafter_tpu_torch.utils.png import read_png

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    log(f"[1] card: {gpu}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    builds = cuda_build.build()          # one nvcc per source, in parallel
    G._library()
    log(f"[1] built " + ", ".join(os.path.relpath(lib, here)
                                  for lib, _ in builds.values())
        + f" in {time.perf_counter() - t0:.1f} s")
    for _, ptxas in builds.values():
        for line in ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log("    ptxas " + line.strip())

    # ---- phase 2: kernels vs plain versions --------------------------------
    small = heavy_pool_in_camera(np.eye(4), dev, N_SMALL)
    flat = FlatGaussians(small.xyz, small.get_rotation(),
                         small.get_scaling(), small.get_opacity()[:, 0],
                         small.get_features(), small.valid)
    K_small = torch.tensor([[1.1 * W_SMALL, 0, W_SMALL / 2],
                            [0, 1.1 * W_SMALL, H_SMALL / 2], [0, 0, 1]],
                           device=dev)
    small_args = raster_args(flat, torch.eye(4, device=dev), K_small,
                             W_SMALL, H_SMALL)
    small_label = f"trained-like {N_SMALL} splats {W_SMALL}x{H_SMALL}"
    compare(G, small_args, small_label, 2)
    wide = wide_splat_args(dev)
    n_wide = int(((wide["radii"] > 200) & wide["valid"]).sum())
    wide_label = (f"wide splats ({n_wide} with radius > 200 px) "
                  f"{W_SMALL}x{H_SMALL}")
    compare(G, wide, wide_label, 2)

    # ---- phase 3: the main path --------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg, cfg_path = build_main_path_scene(tmp, dev)
        torch.cuda.reset_peak_memory_stats()
        G.reset_launch_counts()
        t0 = time.perf_counter()
        result = R.main(["--config", cfg_path, "mode=trajectory",
                         "render.save_video=false"])
        wall = time.perf_counter() - t0
        render_counts = dict(G.launches)
        peak = torch.cuda.max_memory_allocated()
        log(f"[3] runner.render.main: {len(result['frame_ms'])} frames in "
            f"{wall:.1f} s; launches {render_counts}")
        if render_counts.get("tile_worklist", 0) < 1 or \
                render_counts.get("composite", 0) < 1:
            raise AssertionError(f"main path missed a kernel: "
                                 f"{render_counts}")
        if render_counts.get("tile_worklist_reference", 0) or \
                render_counts.get("composite_reference", 0):
            raise AssertionError(f"main path ran a plain version: "
                                 f"{render_counts}")
        rgb_dir = os.path.join(result["out_dir"], "rgb")
        pngs = sorted(os.listdir(rgb_dir))
        if len(pngs) != 12:
            raise AssertionError(f"expected 12 rgb PNGs, got {pngs}")
        for name in pngs:
            img = read_png(os.path.join(rgb_dir, name))
            if img.shape != (1067, 1600, 3) or img.max() == 0:
                raise AssertionError(f"{name}: shape {img.shape}, max "
                                     f"{img.max()}")
        ms = result["frame_ms"]
        log(f"[3] {len(pngs)} PNGs {img.shape[1]}x{img.shape[0]}; ms/frame "
            f"median {statistics.median(ms):.2f} (first {ms[0]:.2f}, min "
            f"{min(ms):.2f}); headline frame pairs {result['n_pairs'][0]}; "
            f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; card {gpu}")

        # ---- phase 4: kernels vs plain at the headline frame -------------
        args, cam0, n_splats = headline_raster_args(cfg, dev)
        stats = compare(G, args, f"headline frame {cam0.width}x"
                        f"{cam0.height}, {n_splats} splats", 4)
        geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                    "width", "height")}
        comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b",
                                     "conic_c", "colors", "opacities",
                                     "width", "height")}
        wl = G.tile_worklist(**geo)
        times = {
            "tile_worklist": (cuda_ms(lambda: G.tile_worklist(**geo), 10),
                              cuda_ms(lambda: G.tile_worklist_reference(
                                  **geo), 3)),
            "composite": (cuda_ms(lambda: G.composite(wl, **comp), 20),
                          cuda_ms(lambda: G.composite_reference(wl, **comp),
                                  1, warmup=0)),
        }
        for name, (k_ms, p_ms) in times.items():
            log(f"[4] {name}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms "
                f"({cam0.width}x{cam0.height}, {stats['pairs']} pairs; "
                f"{gpu})")

        # ---- phase 5: kernel C vs the plain backward ---------------------
        compare_backward(G, small_args, small_label, 5)
        compare_backward(G, wide, wide_label, 6)
        head = compare_backward(G, args, f"headline frame {cam0.width}x"
                                f"{cam0.height}", 7)
        bwd = dict(head["comp"], **head["state"])
        times["composite_backward"] = (
            cuda_ms(lambda: G.composite_backward(head["wl"], **bwd), 20),
            cuda_ms(lambda: G.composite_backward_reference(
                head["wl"], **head["comp"],
                grad_colors=bwd["grad_colors"],
                grad_alpha=bwd["grad_alpha"]), 1, warmup=0))
        hits = contributing_pairs(G, head["wl"], head["comp"])
        log(f"[5] composite_backward: kernel C "
            f"{times['composite_backward'][0]:.3f} ms, plain "
            f"{times['composite_backward'][1]:.3f} ms ({cam0.width}x"
            f"{cam0.height}, {head['wl'].n_pairs} pairs, "
            f"{head['prefix']} pixel-splat pairs in the pixels' prefixes, "
            f"{hits} of them contributing; {gpu})")
        bound = bounds(n_splats, head["wl"].n_pairs,
                       head["wl"].ranges.shape[0], head["pixels"],
                       head["prefix"], hits, args["colors"].shape[1])
        errs = {"tile_worklist": stats["worklist_err"],
                "composite": stats["composite_err"],
                "composite_backward": head["err"]}
        del head, bwd
        torch.cuda.empty_cache()

        # ---- phase 6: the training main path ------------------------------
        train_counts = train_main_path(G, cfg.source_path, tmp, gpu)

        # ---- phase 7: the train step at the 600k shape --------------------
        step_time(G, cfg, dev, gpu)

    # ---- phase 8: kernels D, E, F vs plain versions -----------------------
    vdm_errs = compare_vdm_kernels()

    # ---- phase 9: the sampling main path -----------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vdm_") as tmp:
        vdm_counts, vdm_cfg, vdm_peak = vdm_main_path(tmp, gpu)

        # ---- phase 10: times -----------------------------------------------
        vdm_times(vdm_cfg, gpu)
        vdm_rows = vdm_kernel_times(gpu)

        # ---- phase 11: kernels D with lse, G, H vs plain versions ----------
        train_errs = compare_train_kernels()

        # ---- phase 12: the fine-tune main path -----------------------------
        ft_counts, ft = vdm_train_main_path(tmp, gpu)

        # ---- phase 13: times -----------------------------------------------
        vdm_train_times(ft, gpu)
        del ft
        torch.cuda.empty_cache()
    ft_rows = vdm_train_kernel_times(gpu)

    # each main path's counts, read right after its own reset; "launches"
    # is their sum
    by_path = {name: {"render": render_counts.get(name, 0),
                      "train": train_counts.get(name, 0), "vdm_sample": 0,
                      "vdm_train": 0}
               for name in REPLACES}
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name],
         "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": errs[name], "ms": round(times[name][0], 4),
         "plain_ms": round(times[name][1], 4),
         "bound_ms": round(bound[name]["bound_ms"], 6),
         "bound_by": bound[name]["bound_by"],
         # no single PyTorch call computes these functions
         "library_ms": None}
        for name in ("tile_worklist", "composite", "composite_backward")]
    for k in kernels:
        log(f"[7] {k['name']}: {k['ms']:.3f} ms against a bound of "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
            f"{k['plain_ms']:.3f} ms, launches {k['launches_by_path']}")
    # kernels D, E, F: the numbers at the first (largest) sampling shape;
    # "shapes" has every sampling shape and, for kernel D, every training
    # shape (its form with lse); kernel D's vdm_train launches are its lse
    # form's
    def rounded(rows):
        return [{k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in r.items()} for r in rows]

    for name in ("flash_attention", "temporal_block_fused",
                 "temporal_attention_fused"):
        head = vdm_rows[name][0]
        paths = {"render": 0, "train": 0,
                 "vdm_sample": vdm_counts.get(name, 0),
                 "vdm_train": ft_counts.get(
                     "flash_attention_lse" if name == "flash_attention"
                     else name, 0)}
        shapes = rounded(vdm_rows[name])
        if name == "flash_attention":
            shapes += [dict(r, path="vdm_train")
                       for r in rounded(ft_rows[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": VDM_SOURCES[name],
            "replaces": VDM_REPLACES[name],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(vdm_errs[name], train_errs.get(name, 0.0)),
            "ms": round(head["ms"], 4),
            "plain_ms": round(head["plain_ms"], 4),
            "bound_ms": round(head["bound_ms"], 6),
            "bound_by": head["bound_by"],
            "library_ms": (None if head["library_ms"] is None
                           else round(head["library_ms"], 4)),
            "shapes": shapes})
    # kernels G and H: the numbers at the first (largest) training shape;
    # library_ms is one scaled_dot_product_attention backward, which
    # computes dq, dk and dv together (G + H)
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        head = ft_rows[name][0]
        paths = {"render": 0, "train": 0, "vdm_sample": 0,
                 "vdm_train": ft_counts.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": VDM_SOURCES["flash_attention"],
            "replaces": BWD_REPLACES[name],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": train_errs[name], "ms": round(head["ms"], 4),
            "plain_ms": round(head["plain_ms"], 4),
            "bound_ms": round(head["bound_ms"], 6),
            "bound_by": head["bound_by"],
            "library_ms": round(head["library_ms"], 4),
            "library_covers": "dq, dk and dv (G + H)",
            "shapes": rounded(ft_rows[name])})
    log(f"[10] sampling peak max_memory_allocated {vdm_peak:.2f} GiB")
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
