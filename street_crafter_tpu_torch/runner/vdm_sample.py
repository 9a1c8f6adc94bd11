"""Conditioned video sampling over meta_info clips (port of
``street_crafter_tpu/runner/vdm_sample.py``; the sample_condition.py CLI,
:487-563).

For each val clip: LiDAR-conditioned sampling of one window with frame 0
as the conditioning frame, then per frame a PNG of ground truth, condition
and sample stacked top to bottom (a video as well when
``render.save_video`` is set; that needs imageio).

With ``diffusion.shard_sample`` under torchrun every rank reads the clips
and samples its frames of each window (``parallel/sample.py``, over
``mesh.axes``); rank 0 alone writes the PNGs and videos.

CLI: python -m street_crafter_tpu_torch.runner.vdm_sample --config cfg.json
    [--num-clips N] [key=value ...]
    torchrun --nproc-per-node 5 -m street_crafter_tpu_torch.runner.vdm_sample
    --config cfg.json mesh.axes.frames=5 diffusion.shard_sample=true
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Config, default_config, load_config, merge_dotlist
from ..datasets.vdm_data import ClipDataset
from ..models.vdm.engine import VideoDiffusionEngine
from ..models.vdm.weights import engine_from_config, load_vdm_params
from ..parallel.sample import sample_on_mesh
from ..utils.png import PngWriter
from ..visualizers.visualizer import save_video, to_uint8
from .diffusion import sampling_mesh_from_cfg

SEED = 23   # the reference seeds every sampling call with 23


def build_engine(cfg: Config, num_frames: int, device=None
                 ) -> VideoDiffusionEngine:
    """The engine of ``cfg.diffusion`` on ``device`` (default
    ``cfg.device``), weights loaded."""
    dcfg = cfg.diffusion.clone()
    dcfg.sample_frames = num_frames
    ecfg = engine_from_config(dcfg)
    device = device if device is not None else cfg.get("device", "cuda")
    if torch.device(device).type == "cuda" and ecfg.unet.dtype != "bfloat16":
        raise ValueError(
            f"UNet compute dtype {ecfg.unet.dtype or 'float32'} on {device}: "
            f"kernel D (csrc/flash_attention.cu), the spatial attention's "
            f"kernel, takes bfloat16 only; set diffusion.compute_dtype="
            f"bfloat16 and tiny=false, or device=cpu")
    engine = VideoDiffusionEngine(ecfg, device)
    load_vdm_params(engine, dcfg)
    return engine


def sample_clips(cfg: Config, num_clips: int | None = None) -> dict:
    """Sample the val clips of ``cfg.vdm_train.data_root``. Returns
    {"out_dir", "clips": per-clip PNG directories, "videos", "sample_s":
    wall seconds per clip, "frames": the last clip's samples [T, H, W, 3]
    in [-1, 1]}; frames-sharded, on every rank, with the PNGs (and
    "clips", "videos") of rank 0."""
    v = cfg.vdm_train
    out_dir = cfg.model_path or os.path.join(cfg.workspace, "output",
                                             "vdm_samples", cfg.exp_name)
    mesh = sampling_mesh_from_cfg(cfg)
    writes = mesh is None or mesh.rank == 0
    if writes:
        os.makedirs(out_dir, exist_ok=True)
    engine = build_engine(cfg, v.num_frames,
                          mesh.device if mesh is not None else None)
    dev = engine.device
    ds = ClipDataset(v.data_root, split="val", target_height=v.height,
                     target_width=v.width, num_frames=v.num_frames,
                     postfix=v.get("postfix") or None)
    n = min(num_clips or len(ds), len(ds))
    res = {"out_dir": out_dir, "clips": [], "videos": [], "sample_s": []}
    for i in range(n):
        item = ds[i]
        t0 = time.perf_counter()
        guide = torch.from_numpy(item["guide_seq"]).to(dev)
        cond = torch.from_numpy(item["img_seq"][:1]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        if mesh is not None:
            out = sample_on_mesh(engine, guide, cond, mesh, generator=gen)
        else:
            out = engine.sample(guide_images=guide, cond_image=cond,
                                generator=gen)
        sample = out.cpu().numpy()
        res["sample_s"].append(time.perf_counter() - t0)
        res["frames"] = sample
        if not writes:
            continue
        frames = [np.concatenate([to_uint8((g + 1.0) / 2.0),
                                  to_uint8((c + 1.0) / 2.0),
                                  to_uint8((s + 1.0) / 2.0)], 0)
                  for g, c, s in zip(item["img_seq"], item["guide_seq"],
                                     sample)]
        clip_dir = os.path.join(out_dir, f"clip_{i:04d}")
        with PngWriter() as png:
            for t, frame in enumerate(frames):
                png.write(os.path.join(clip_dir, f"{t:03d}.png"), frame)
        res["clips"].append(clip_dir)
        if cfg.render.get("save_video", False):
            res["videos"].append(save_video(
                os.path.join(out_dir, f"clip_{i:04d}.mp4"), frames,
                fps=cfg.render.fps))
        print(f"clip {i}: {clip_dir} ({res['sample_s'][-1]:.1f} s)")
    return res


def sample_rollout(engine: VideoDiffusionEngine, generator: torch.Generator,
                   guide_images: np.ndarray, cond_image: np.ndarray,
                   overlap: int = 3, cfg_scale: float | None = None,
                   num_steps: int | None = None) -> np.ndarray:
    """Multi-round long-video rollout with frame overlap (Vista do_sample,
    sample_utils.py:286-376): round 1 conditions on the given frame, each
    later round on the last ``overlap`` frames of the round before.
    guide_images: [F, H, W, 3] in [-1, 1]; returns [F, H, W, 3]."""
    T = engine.cfg.num_frames
    F = guide_images.shape[0]
    out = np.zeros_like(guide_images)
    pos = 0
    cond_imgs = np.asarray(cond_image)[None] if cond_image.ndim == 3 \
        else np.asarray(cond_image)
    cond_indices: tuple[int, ...] = (0,)
    dev = engine.device
    while pos < F:
        end = min(pos + T, F)
        start = end - T
        # overlap frames must sit at the window head; shift back if clipped
        if start < pos - overlap:
            start = max(pos - overlap, 0)
            end = start + T
        frames = engine.sample(
            guide_images=torch.from_numpy(guide_images[start:end]).to(dev),
            cond_image=torch.from_numpy(cond_imgs).to(dev),
            generator=generator, cfg_scale=cfg_scale, num_steps=num_steps,
            cond_indices=cond_indices).cpu().numpy()
        out[start:end] = frames
        pos = end
        cond_imgs = frames[-overlap:]
        cond_indices = tuple(range(overlap))
    return out


def main(argv: list[str] | None = None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="conditioned video sampling")
    p.add_argument("--config", required=True)
    p.add_argument("--num-clips", type=int, default=None)
    p.add_argument("opts", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = default_config()
    cfg.merge(load_config(args.config))
    merge_dotlist(cfg, args.opts)
    return sample_clips(cfg, args.num_clips)


if __name__ == "__main__":
    main()
