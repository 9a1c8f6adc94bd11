"""Ensemble reward estimation (port of ``street_crafter_tpu/runner/
reward.py``; the Vista-legacy reward entry, video_diffusion/reward.py:1-266
and reward_utils.py:285-341).

Sample an ensemble of videos from one conditioning with different noise,
take the per-latent variance across the ensemble, and map it to a scalar
confidence ``reward = exp(-mean(variance))``: low disagreement means the
model is confident about the scene's dynamics. The members run one after
the other (the JAX package's ``lax.map``); each CFG evaluation goes through
the engine's UNet and so through kernels D, E and F on the card.

Vista's action conditioning rides adapter modules that the StreetCrafter
UNet does not have; the nuScenes loader returns the action dict, and
sampling is the unconditional-action mode.

CLI: python -m street_crafter_tpu_torch.runner.reward --dataset IMG \\
    --data_root DIR [--ens_size 5] [--n_steps 10] ... [key=value ...]
(``key=value`` options go to the port's config, e.g. ``device=cpu``,
``diffusion.tiny=true``, ``diffusion.ckpt_path=...``.)
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..datasets.vdm_data import resize_lanczos_uint8
from ..models.vdm import diffusion as D
from ..models.vdm.samplers import euler_edm_sample
from ..utils.png import read_png


def reward_from_samples(samples: torch.Tensor) -> torch.Tensor:
    """[E, ...] ensemble -> exp(-mean unbiased variance)
    (reward_utils.py:332-338)."""
    E = samples.shape[0]
    u = samples.mean(0)
    var = ((samples - u) ** 2).sum(0) / (E - 1)
    return torch.exp(-var.mean())


@torch.no_grad()
def ensemble_reward(engine, images: torch.Tensor,
                    generator: torch.Generator | None = None,
                    ensemble_size: int = 5, num_steps: int = 10,
                    cfg_scale: float = 2.5,
                    cond_indices: tuple[int, ...] = (0,),
                    noises: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(reward scalar, [E, T, h, w, 4] latent ensemble) of ``images``
    [T, H, W, 3] in [-1, 1] (do_sample, reward_utils.py:285-341). The real
    video's latents are the cond-frame source, and frame 0 of every sample
    is pinned to the real latent before the variance (:330). Each member's
    standard-normal noise is drawn from ``generator``, or is
    ``noises[e]``."""
    cfgc = engine.cfg
    dev = engine.device
    T = cfgc.num_frames
    images = images.to(dev)
    z = engine.encode_images_chunked(images).float()
    cond, uc = engine.build_conditioning(images[:1])
    cond_mask = torch.zeros((T,), device=dev)
    cond_mask[list(cond_indices)] = 1.0
    denoise_fn = engine.make_cfg_denoise_fn(cond, uc, None, cond_mask,
                                            cfg_scale)
    sigmas = D.edm_sigmas(num_steps, cfgc.sigma_min, cfgc.sigma_max,
                          cfgc.rho, device=dev)
    samples = []
    for e in range(ensemble_size):
        noise = (torch.randn(tuple(z.shape), generator=generator, device=dev)
                 if noises is None else noises[e].to(dev, torch.float32))
        s = euler_edm_sample(denoise_fn, noise, sigmas, cond_frame=z,
                             cond_mask=cond_mask)
        s[0] = z[0]
        samples.append(s)
    samples = torch.stack(samples)
    return reward_from_samples(samples), samples


def load_reward_image(path: str, th: int, tw: int) -> np.ndarray:
    """Center aspect crop on both axes, then Lanczos resize to [-1, 1]
    (reward.py:174-205 ``load_img``; unlike the training data's
    bottom-biased crop). Reads PNG; the resize is Pillow's LANCZOS."""
    img = read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    img = img[..., :3] if img.shape[-1] >= 3 else \
        np.repeat(img[..., :1], 3, -1)      # drop alpha; gray -> RGB
    h, w = img.shape[:2]
    if w / h > tw / th:
        cw = int(tw / th * h)
        img = img[:, (w - cw) // 2:(w + cw) // 2]
    elif w / h < tw / th:
        ch = int(th / tw * w)
        img = img[(h - ch) // 2:(h + ch) // 2]
    img = resize_lanczos_uint8(np.ascontiguousarray(img), th, tw)
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0


def get_sample(index: int, dataset: str, data_root: str,
               anno_file: str | None = None, num_frames: int = 25,
               action_mode: str = "traj"
               ) -> tuple[list[str], int, int, dict[str, Any] | None]:
    """(frame paths, wrapped index, dataset length, action dict)
    (reward.py:122-172). IMG mode repeats a single image; NUSCENES reads
    the annotation json's frame and action lists."""
    if dataset == "IMG":
        files = sorted(os.listdir(data_root))
        index %= len(files)
        return ([os.path.join(data_root, files[index])] * num_frames,
                index, len(files), None)
    if dataset != "NUSCENES":
        raise ValueError(f"invalid dataset {dataset}")
    with open(anno_file) as f:
        annos = json.load(f)
    index %= len(annos)
    s = annos[index]
    paths = [os.path.join(data_root, s["frames"][i])
             for i in range(num_frames)]
    action: dict[str, Any] = {}
    if action_mode in ("traj", "trajectory"):
        action["trajectory"] = np.asarray(s["traj"][2:])
    elif action_mode in ("cmd", "command"):
        action["command"] = np.asarray(s["cmd"])
    elif action_mode == "steer":
        if s.get("speed"):
            action["speed"] = np.asarray(s["speed"][1:])
        if s.get("angle"):
            action["angle"] = np.asarray(s["angle"][1:]) / 780
    elif action_mode == "goal":
        if (s["z"] > 0 and 0 < s["goal"][0] < 1600
                and 0 < s["goal"][1] < 900):
            action["goal"] = np.asarray(
                [s["goal"][0] / 1600, s["goal"][1] / 900])
    else:
        raise ValueError(f"unsupported action mode {action_mode}")
    return paths, index, len(annos), action


def main(argv: list[str] | None = None) -> list[dict]:
    """The CLI; returns the records it appended to ``rewards.jsonl``."""
    import argparse

    from ..config import default_config, merge_dotlist
    from .vdm_sample import build_engine

    p = argparse.ArgumentParser(description="ensemble reward estimation")
    p.add_argument("--dataset", default="IMG", choices=["IMG", "NUSCENES"])
    p.add_argument("--data_root", required=True)
    p.add_argument("--anno_file", default=None)
    p.add_argument("--save", default="outputs/reward")
    p.add_argument("--action", default="traj")
    p.add_argument("--n_frames", type=int, default=25)
    p.add_argument("--n_conds", type=int, default=1)
    p.add_argument("--ens_size", type=int, default=5)
    p.add_argument("--seed", type=int, default=23)
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--cfg_scale", type=float, default=2.5)
    p.add_argument("--n_steps", type=int, default=10)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--count", type=int, default=1)
    p.add_argument("opts", nargs="*", default=[])
    args = p.parse_args(argv)

    cfg = default_config()
    merge_dotlist(cfg, args.opts)
    engine = build_engine(cfg, args.n_frames)

    os.makedirs(args.save, exist_ok=True)
    records = []
    index = args.index
    for _ in range(args.count):
        paths, index, _, action = get_sample(
            index, args.dataset, args.data_root, args.anno_file,
            args.n_frames, args.action)
        images = torch.from_numpy(np.stack(
            [load_reward_image(pth, args.height, args.width)
             for pth in paths]))
        reward, _ = ensemble_reward(
            engine, images,
            torch.Generator(device=engine.device).manual_seed(args.seed),
            ensemble_size=args.ens_size, num_steps=args.n_steps,
            cfg_scale=args.cfg_scale,
            cond_indices=tuple(range(args.n_conds)))
        rec = {"index": index, "reward": float(reward),
               "frames": paths[:1],
               "action_keys": sorted(action) if action else []}
        print(json.dumps(rec))
        with open(os.path.join(args.save, "rewards.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")
        records.append(rec)
        index += 1
    return records


if __name__ == "__main__":
    main()
