#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (street_crafter_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one status line each; any failure raises (exit code != 0):
  1. card name and power limit; build the raster kernels from
     street_crafter_tpu_torch/csrc with nvcc for sm_90a;
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
     shapes, and their times (CUDA events).
The last three lines: the card's name and power limit, a JSON object of
per-kernel results, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

RGB_ALPHA_ATOL = 2e-4   # kernel B vs plain: f32, summed in another order
N_SMALL, W_SMALL, H_SMALL = 50_000, 384, 256
N_HEAVY = 600_000
SOURCE = "street_crafter_tpu_torch/csrc/gs_raster.cu"
REPLACES = {"tile_worklist": "street_crafter_tpu/ops/gs_raster_fused.py:86",
            "composite": "street_crafter_tpu/ops/gs_raster_fused.py:255"}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from street_crafter_tpu_torch.models.gs.scene import FlatGaussians
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
    lib, ptxas = G.build_kernels()
    G._library()
    log(f"[1] built {os.path.relpath(lib, here)} in "
        f"{time.perf_counter() - t0:.1f} s")
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
    compare(G, raster_args(flat, torch.eye(4, device=dev), K_small, W_SMALL,
                           H_SMALL),
            f"trained-like {N_SMALL} splats {W_SMALL}x{H_SMALL}", 2)
    wide = wide_splat_args(dev)
    n_wide = int(((wide["radii"] > 200) & wide["valid"]).sum())
    compare(G, wide, f"wide splats ({n_wide} with radius > 200 px) "
            f"{W_SMALL}x{H_SMALL}", 2)

    # ---- phase 3: the main path --------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg, cfg_path = build_main_path_scene(tmp, dev)
        torch.cuda.reset_peak_memory_stats()
        G.reset_launch_counts()
        t0 = time.perf_counter()
        result = R.main(["--config", cfg_path, "mode=trajectory",
                         "render.save_video=false"])
        wall = time.perf_counter() - t0
        counts = dict(G.launches)
        peak = torch.cuda.max_memory_allocated()
        log(f"[3] runner.render.main: {len(result['frame_ms'])} frames in "
            f"{wall:.1f} s; launches {counts}")
        if counts.get("tile_worklist", 0) < 1 or counts.get("composite", 0) < 1:
            raise AssertionError(f"main path missed a kernel: {counts}")
        if counts.get("tile_worklist_reference", 0) or \
                counts.get("composite_reference", 0):
            raise AssertionError(f"main path ran a plain version: {counts}")
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

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": counts[name],
         "max_abs_err": stats["worklist_err" if name == "tile_worklist"
                              else "composite_err"],
         "ms": round(times[name][0], 4), "plain_ms": round(times[name][1], 4)}
        for name in ("tile_worklist", "composite")]
    log(gpu)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
