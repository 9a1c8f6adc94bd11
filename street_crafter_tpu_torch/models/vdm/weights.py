"""Engine construction from config and its weights (port of
``street_crafter_tpu/models/vdm/weights.py``).

``load_vdm_params`` fills an engine's modules from ``diffusion.ckpt_path``:
  * the port's own checkpoint (``save_vdm_params``: ``torch.save`` of the
    three state dicts), or a torch-side vwm checkpoint (``.safetensors``,
    ``.ckpt``, ``.bin``, ``.pt``), read through ``convert`` with LoRA/EMA
    merged and ``time_embed`` duplicated when needed; unknown keys are
    reported, missing ones raise;
  * seeded random weights when the path is empty (the bring-up path: no
    released weights are on disk), drawn on the engine's device from a
    ``torch.Generator``. The JAX package's orbax directories are not read:
    carry JAX parameters across with ``convert.engine_params_from_jax``.
"""

from __future__ import annotations

import os

import torch

from .clip import CLIPVisualConfig
from .engine import EngineConfig, VideoDiffusionEngine
from .unet import UNetConfig
from .vae import VAEConfig

FORMAT = "street_crafter_tpu_torch.vdm/1"
# weights the JAX package initialises to zero (flax kernel_init zeros), by
# part and the end of their state-dict name
_ZERO_INIT = {"unet": ("out_layers.3.weight", "proj_out.weight",
                       "out.2.weight", "condition_input_blocks.1.0.weight",
                       "_adapter_up.weight"),
              "vae": ("time_stack.out_layers.3.weight",),
              "clip": ()}


def engine_from_config(dcfg, training: bool = False) -> EngineConfig:
    """The diffusion config node -> EngineConfig. Sampling takes the fused
    temporal kernels by default; ``training=True`` turns them off."""
    if dcfg.get("tiny", False):
        return EngineConfig.tiny(num_frames=dcfg.sample_frames,
                                 num_steps=dcfg.num_steps)
    dt = dcfg.get("compute_dtype", "bfloat16") or None
    return EngineConfig(
        unet=UNetConfig(dtype=dt, add_lora=bool(dcfg.get("add_lora", False)),
                        lora_rank=int(dcfg.get("lora_rank", 16)),
                        remat_policy=str(dcfg.get("remat_policy", "flash0")),
                        fused_temporal=bool(
                            dcfg.get("fused_temporal", not training))),
        vae=VAEConfig(dtype=dt),
        clip=CLIPVisualConfig(dtype=dt),
        num_frames=dcfg.sample_frames,
        num_steps=dcfg.num_steps,
        cfg_scale=dcfg.cfg_scale,
        fps_id=dcfg.fps_id,
        motion_bucket_id=dcfg.motion_bucket_id,
        cond_aug=dcfg.cond_aug,
        decode_chunk=int(dcfg.get("decode_chunk", 8)))


def load_state_dicts(engine: VideoDiffusionEngine, sds: dict,
                     strict: bool = True,
                     masters: dict | None = None) -> dict[str, list[str]]:
    """Copy {"unet", "vae", "clip"} state dicts into the engine (cast to
    each parameter's dtype). Raises on missing keys; returns the unknown
    ones (an error too when ``strict``). ``masters``, when given, receives
    the UNet's values in f32 on the engine's device before the cast (the
    fine-tune's master weights)."""
    unknown = {}
    for part, module in engine.modules().items():
        sd = sds[part]
        params = module.state_dict()
        missing = sorted(set(params) - set(sd))
        if missing:
            raise KeyError(f"{part}: checkpoint lacks {len(missing)} "
                           f"parameters, e.g. {missing[:5]}")
        unknown[part] = sorted(set(sd) - set(params))
        if strict and unknown[part]:
            raise KeyError(f"{part}: unknown keys {unknown[part][:5]}")
        with torch.no_grad():
            for k, p in params.items():
                v = torch.as_tensor(sd[k])
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"{part}.{k}: shape {tuple(v.shape)}, "
                                     f"expected {tuple(p.shape)}")
                if masters is not None and part == "unet":
                    masters[k] = v.to(p.device, torch.float32).clone()
                p.copy_(v.to(p.device, p.dtype))
    return unknown


@torch.no_grad()
def init_random_(engine: VideoDiffusionEngine, seed: int = 0,
                 zero_init_std: float = 0.0,
                 masters: dict | None = None) -> None:
    """Seeded random weights drawn on the engine's device, with the JAX
    package's initialisers: weights N(0, 1/fan_in) (lecun normal, not
    truncated), biases 0, norm scales 1, AlphaBlender mix factors at their
    init, CLIP embeddings N(0, 0.02^2), LoRA down N(0, 1/r^2); the
    zero-initialised output layers are 0, or N(0, zero_init_std^2 /
    fan_in) when ``zero_init_std`` > 0 (so that every layer reaches the
    output of a randomly initialised model). ``masters``, when given,
    receives every UNet value as drawn, in f32, before it is cast to the
    parameter's dtype."""
    dev = engine.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for part, module in engine.modules().items():
        norms = {n for n, m in module.named_modules()
                 if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))}
        for name, p in module.named_parameters():
            value = _draw(part, name, p, norms, gen,
                          engine.cfg.unet.merge_factor, zero_init_std)
            p.copy_(value)
            if masters is not None and part == "unet":
                masters[name] = value


def _draw(part: str, name: str, p: torch.Tensor, norms: set,
          gen: torch.Generator, merge_factor: float,
          zero_init_std: float) -> torch.Tensor:
    """The initial value of one parameter, f32, on its device."""
    mod, _, leaf = name.rpartition(".")
    f32 = dict(dtype=torch.float32, device=p.device)
    if leaf == "mix_factor":
        # UNet AlphaBlenders start at merge_factor 0.5, the VAE's video
        # blocks at 0
        return torch.full(p.shape, merge_factor if part == "unet" else 0.0,
                          **f32)
    if mod in norms:
        return torch.full(p.shape, 1.0 if leaf == "weight" else 0.0, **f32)
    if leaf in ("bias", "in_proj_bias"):
        return torch.zeros(p.shape, **f32)
    if part == "clip" and leaf in ("class_embedding", "positional_embedding",
                                   "proj"):
        std = 0.02
    elif name.endswith("_adapter_down.weight"):
        std = 1.0 / p.shape[0]                # 1 / rank
    else:
        std = p[0].numel() ** -0.5            # 1 / sqrt(fan_in)
        if _ZERO_INIT[part] and name.endswith(_ZERO_INIT[part]):
            std *= zero_init_std
    if std == 0.0:
        return torch.zeros(p.shape, **f32)
    return torch.randn(p.shape, generator=gen, **f32) * std


def save_vdm_params(path: str, engine: VideoDiffusionEngine,
                    unet: dict | None = None) -> None:
    """The port's checkpoint: the three state dicts in one torch.save.
    ``unet``, when given, stands in for the UNet's own parameters (e.g. the
    fine-tune's EMA), cast to each parameter's dtype."""
    sds = {part: m.state_dict() for part, m in engine.modules().items()}
    if unet is not None:
        sds["unet"] = {k: unet[k].to(v.dtype) if k in unet else v
                       for k, v in sds["unet"].items()}
    save_vdm_state_dicts(path, sds)


def save_vdm_state_dicts(path: str, sds: dict) -> None:
    """The port's checkpoint from {"unet", "vae", "clip"} state dicts
    (``load_vdm_params`` casts each value to its parameter's dtype)."""
    torch.save({"format": FORMAT, **sds}, path)


def load_vdm_params(engine: VideoDiffusionEngine, dcfg,
                    masters: dict | None = None) -> str:
    """Fill the engine from ``dcfg.ckpt_path``; seeded random weights (seed
    0, as the JAX package's ``PRNGKey(0)``) when it is empty. Returns what
    was loaded. ``masters``, when given, receives the UNet's values in f32
    (see ``load_state_dicts``)."""
    ckpt = dcfg.get("ckpt_path", "") or ""
    if not ckpt:
        print("WARNING: no diffusion ckpt_path set; using seeded random "
              "weights")
        init_random_(engine, 0,
                     float(dcfg.get("init_zero_layers_std", 0.0)), masters)
        return "random"
    if os.path.isdir(ckpt):
        raise NotImplementedError(
            f"{ckpt} is a directory (the JAX package's orbax format); the "
            f"port reads torch checkpoints: convert it with python -m "
            f"street_crafter_tpu_torch.scripts.convert_jax_checkpoint vdm "
            f"{ckpt} OUT.pt --config CFG (needs tensorstore)")
    if not os.path.isfile(ckpt):
        raise FileNotFoundError(f"vdm checkpoint not found: {ckpt}")
    if not ckpt.endswith(".safetensors"):
        obj = torch.load(ckpt, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and obj.get("format") == FORMAT:
            load_state_dicts(engine, obj, masters=masters)
            return ckpt
        del obj
    from .convert import (duplicate_time_embed, merge_lora_ema,
                          read_checkpoint, split_engine_state_dict)
    sd = duplicate_time_embed(merge_lora_ema(read_checkpoint(ckpt)))
    unknown = load_state_dicts(engine, split_engine_state_dict(sd),
                               strict=False, masters=masters)
    for part, keys in unknown.items():
        if keys:
            print(f"{part}: {len(keys)} unknown keys (e.g. {keys[:3]})")
    return ckpt
