"""Video-diffusion fine-tune driver (port of ``street_crafter_tpu/runner/
vdm_train.py``; the video_diffusion/train.py loop), on one device or over
data-parallel ranks.

Clips come from meta_info windows (``datasets.vdm_data``); the frozen VAE
encodes frames and guidance and the frozen CLIP and VAE build the
conditioning (``make_encode_fn``), both without gradients; the trainer
(``training.vdm_trainer``) takes one step per batch. Checkpoints go to
``model_path/checkpoints/iteration_{step}/`` (every ``ckpt_every`` steps
and at the end) and a run resumes from the newest one when ``resume`` is
set; at the end the EMA weights are exported with ``save_vdm_params`` to
``model_path/ema_params.pt``, which ``runner.vdm_sample`` loads as its
``diffusion.ckpt_path``. The image log writes PNGs of the first clip's
inputs, VAE targets and a sample with the current weights. The compute
dtype (``diffusion.compute_dtype``) is bfloat16 or float32 (null): the
f32 step runs the attention kernels' f32 forms and, on the card, its
convolutions with TF32 off (``VideoDiffusionEngine.numerics``).

Under torchrun (``mesh.axes.data``: -1, the world size, or the world size
itself) the ranks train data-parallel with ZeRO-2 (Adam moments sharded),
or FSDP with ``vdm_train.fsdp: true`` (masters and EMA sharded too; the
module's bf16 compute copy stays whole on each rank): every rank runs the
same seeded ``MultiSourceSampler`` and decodes and encodes only its own
clips of the global batch of ``vdm_train.batch_size`` clips, and takes its
slice of the global batch's random draws, so a run does not depend on the
world size. Rank 0 alone logs and writes checkpoints (gathered: the one-GPU
format, which resumes on any world size) and the EMA export. With
``mesh.axes.frames`` f > 1 (sequence parallelism, the JAX step on a
``{data, frames}`` mesh) the clips split over ``data`` and each clip's
frames over ``frames``: a frames rank encodes only its T/f frames (the
conditioning, from frame 0, on every rank) and the UNet exchanges what
crosses frames.

CLI: python -m street_crafter_tpu_torch.runner.vdm_train --config cfg.json
    [key=value ...]
    torchrun --nproc_per_node 2 -m street_crafter_tpu_torch.runner.vdm_train
    --config cfg.json vdm_train.batch_size=2 [vdm_train.fsdp=true]
    torchrun --nproc_per_node 4 -m street_crafter_tpu_torch.runner.vdm_train
    --config cfg.json mesh.axes.data=2 mesh.axes.frames=2
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import Config, default_config, load_config, merge_dotlist
from ..datasets.vdm_data import ClipDataset, MultiSourceSampler
from ..models.vdm.conditioner import Conditioning
from ..models.vdm.engine import VideoDiffusionEngine
from ..models.vdm.lr_schedule import schedule_from_config
from ..models.vdm.weights import (check_compute_dtype, engine_from_config,
                                  load_vdm_params, save_vdm_params)
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.sequence import FramesShard
from ..parallel.sharding import ShardingRules
from ..training.vdm_trainer import VDMTrainer, groups_from_config
from ..utils.checkpoint import load_vdm_checkpoint, save_vdm_checkpoint
from ..utils.metrics import MetricsLogger, ProfilerHook
from ..utils.png import write_png
from ..visualizers.visualizer import to_uint8

SUBSET_CLASSES = {"waymo": ClipDataset, "pandaset": ClipDataset}
EMA_FILE = "ema_params.pt"


def build_sampler(cfg: Config, mesh: Mesh | None = None
                  ) -> MultiSourceSampler:
    """The clip sampler; with a mesh, each batch holds the clips of this
    rank's ``data`` index of the global batch (whole clips: a frames rank
    takes its frames when it encodes)."""
    v = cfg.vdm_train
    datasets = []
    for name in v.subsets:
        root = os.path.join(v.data_root, name) if len(v.subsets) > 1 \
            else v.data_root
        datasets.append(SUBSET_CLASSES[name.lower()](
            root, split="train", target_height=v.height,
            target_width=v.width, num_frames=v.num_frames,
            postfix=v.get("postfix") or None))
    return MultiSourceSampler(
        datasets, probs=list(v.probs) if v.probs else None,
        batch_size=v.batch_size, samples_per_epoch=v.samples_per_epoch,
        seed=cfg.seed, num_workers=int(v.get("num_workers", 0) or 0),
        rank=mesh.coord("data") if mesh is not None else 0,
        world_size=mesh.size("data") if mesh is not None else 1)


def make_encode_fn(engine: VideoDiffusionEngine,
                   frames: FramesShard | None = None):
    """Image batch -> latent training batch (shared_step,
    diffusion_condition.py:237-247): img_seq and guide_seq [B, T, H, W, 3]
    in [-1, 1] -> {"latents", "guidance_latents": [B, T, h, w, 4], "cond":
    Conditioning of [B, T, ...] leaves} on the engine's device, from the
    frozen VAE (frames, in chunks of the engine's encode / decode chunk)
    and CLIP (frame 0 of each clip). With ``frames`` only this rank's
    frames are encoded and kept (T of the result is T/f)."""
    chunk = engine.cfg.encode_chunk or engine.cfg.decode_chunk

    @torch.no_grad()
    def encode(img_seq, guide_seq) -> dict:
        dev = engine.device
        img = torch.as_tensor(np.asarray(img_seq)).to(dev)
        guide = torch.as_tensor(np.asarray(guide_seq)).to(dev)
        B, T = img.shape[:2]
        mine = slice(0, T) if frames is None else frames.frames

        def latents(x):
            x = x[:, mine]
            n = x.shape[1]
            x = x.reshape(B * n, *x.shape[2:])
            z = engine.encode_images_chunked(x, chunk) if chunk \
                else engine.encode_images(x)
            return z.reshape(B, n, *z.shape[1:])

        cond, _ = engine.build_conditioning(img[:, 0])
        cond = Conditioning(*(x.reshape(B, T, *x.shape[1:])[:, mine]
                              for x in cond))
        return {"latents": latents(img), "cond": cond,
                "guidance_latents": latents(guide)}

    return encode


def build_trainer(cfg: Config, mesh: Mesh | None = None
                  ) -> tuple[VDMTrainer, str]:
    """The engine (weights from ``diffusion.ckpt_path`` or the seeded
    random init), and its trainer from the newest checkpoint under the
    model path when ``resume`` is set, sharded over ``mesh`` (ZeRO-2, or
    FSDP under ``vdm_train.fsdp``). Returns (trainer, model path)."""
    v = cfg.vdm_train
    model_path = cfg.model_path or os.path.join(
        cfg.workspace, "output", "vdm", cfg.exp_name)
    os.makedirs(model_path, exist_ok=True)
    dcfg = cfg.diffusion.clone()
    dcfg.sample_frames = v.num_frames
    ecfg = engine_from_config(dcfg, training=True)
    device = mesh.device if mesh is not None else cfg.get("device", "cuda")
    check_compute_dtype(ecfg)
    engine = VideoDiffusionEngine(ecfg, device, training=True)
    state, it = (load_vdm_checkpoint(model_path, device=engine.device)
                 if cfg.resume else (None, None))
    masters = {} if state is None else None
    load_vdm_params(engine, dcfg, masters=masters)
    flags, scale = groups_from_config(v)
    trainer = VDMTrainer(
        engine, masters, lr=v.lr, grad_clip=v.grad_clip,
        ema_decay=v.ema_decay, guidance_dropout=v.guidance_dropout,
        accumulate=int(v.get("accumulate", 1)), group_flags=flags,
        slow_scale=scale, schedule=schedule_from_config(v.get("scheduler")),
        state=state, rules=(None if mesh is None or mesh.world_size == 1
                            else ShardingRules(mesh, fsdp_params=bool(
                                v.get("fsdp", False)))))
    if state is not None:
        print(f"resumed from step {it}")
    return trainer, model_path


def log_image_samples(trainer: VDMTrainer, metrics: MetricsLogger,
                      np_batch: dict, step: int, out_dir: str,
                      num_steps: int | None) -> None:
    """ImageLogger analog (video_diffusion/train.py:318-475): the first
    clip's inputs, VAE round trip and a sample with the current weights,
    PNG per frame under ``out_dir/step_{step}/{name}/`` and frame 0 of each
    through the metrics logger."""
    eng = trainer.engine
    dev = eng.device
    img = torch.as_tensor(np_batch["img_seq"][0]).to(dev)
    guide = torch.as_tensor(np_batch["guide_seq"][0]).to(dev)
    chunk = eng.cfg.decode_chunk or 8
    targets = eng.decode_latents_chunked(
        eng.encode_images_chunked(img, chunk), chunk)
    samples = eng.sample(guide, img[:1],
                         generator=torch.Generator(device=dev).manual_seed(
                             step), num_steps=num_steps)
    for name, seq in (("inputs", img), ("targets", targets),
                      ("samples", samples)):
        frames = ((seq.float().cpu().numpy() + 1.0) / 2.0).clip(0, 1)
        d = os.path.join(out_dir, f"step_{step:08d}", name)
        for t, frame in enumerate(frames):
            write_png(os.path.join(d, f"{t:03d}.png"), to_uint8(frame))
        metrics.log_image(step, f"image_log/{name}", frames[0])


def finetune(cfg: Config) -> dict:
    """Train for ``vdm_train.epochs`` x ``samples_per_epoch`` steps.
    Returns {"trainer", "model_path", "steps": steps taken in this run,
    "step_s": host seconds of each, "scalars": the last step's, "ema_path",
    "checkpoint"}."""
    v = cfg.vdm_train
    mesh = make_mesh(cfg.mesh.axes, device=cfg.get("device", "cuda"))
    main = mesh.rank == 0
    trainer, model_path = build_trainer(cfg, mesh)
    encode = make_encode_fn(trainer.engine, trainer.frames)
    metrics = (MetricsLogger(os.path.join(model_path, "logs")) if main
               else None)
    profiler = ProfilerHook(cfg.profiler if main else {}, model_path)
    gen = torch.Generator(device=trainer.engine.device).manual_seed(cfg.seed)
    step = trainer.state.step
    saved, saved_step = None, None
    step_s, scalars = [], {}
    sampler = build_sampler(cfg, mesh)
    t_log = time.perf_counter()

    def checkpoint(step: int) -> str:
        whole = trainer.whole_state()           # every rank gathers
        return (save_vdm_checkpoint(model_path, step, whole) if main
                else "")

    for epoch in range(v.epochs):
        for np_batch in sampler:
            profiler.step(step)
            t0 = time.perf_counter()
            batch = encode(np_batch["img_seq"], np_batch["guide_seq"])
            scalars = trainer.train_step(batch, generator=gen)
            step += 1
            step_s.append(time.perf_counter() - t0)
            if main and step % v.log_every == 0:
                dt = time.perf_counter() - t_log
                metrics.log_scalars(step, scalars, prefix="train/")
                print(f"[epoch {epoch} step {step}] loss="
                      f"{scalars['loss']:.4f} ({v.log_every / dt:.2f} it/s)",
                      flush=True)
                t_log = time.perf_counter()
            if (main and v.log_images_every
                    and step % v.log_images_every == 0):
                log_image_samples(trainer, metrics, np_batch, step,
                                  os.path.join(model_path, "image_log"),
                                  int(v.get("log_images_steps", 0)) or None)
            if step % v.ckpt_every == 0:
                saved, saved_step = checkpoint(step), step
    profiler.close()
    if metrics is not None:
        metrics.close()
    if saved_step != step:
        saved = checkpoint(step)
    ema_path = os.path.join(model_path, EMA_FILE)
    ema = trainer.whole_state().ema
    if main:
        save_vdm_params(ema_path, trainer.engine, unet=ema)
        print(f"done: {step} steps; checkpoint {saved}; ema params "
              f"{ema_path}")
    mesh.barrier()
    return {"trainer": trainer, "model_path": model_path,
            "steps": len(step_s), "step_s": step_s, "scalars": scalars,
            "ema_path": ema_path, "checkpoint": saved}


def main(argv: list[str] | None = None) -> dict:
    import argparse
    p = argparse.ArgumentParser(description="video diffusion fine-tune")
    p.add_argument("--config", required=True)
    p.add_argument("opts", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = default_config()
    cfg.merge(load_config(args.config))
    merge_dotlist(cfg, args.opts)
    return finetune(cfg)


if __name__ == "__main__":
    main()
