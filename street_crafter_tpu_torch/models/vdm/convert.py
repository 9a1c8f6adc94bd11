"""Weights across: torch-side checkpoints and the JAX engine's parameters
(port of ``street_crafter_tpu/models/vdm/convert.py`` and the name maps of
``weights.py``).

- ``read_checkpoint``: ``.safetensors`` / ``.ckpt`` (Lightning
  ``state_dict``) / ``.bin`` (DeepSpeed ``_forward_module.``) / ``.pt``
  into {name: f32 ndarray} (sample_condition.py:80-106);
- ``merge_lora_ema``: LoRA adapters folded into their projections and EMA
  weights substituted (bin_to_st.py:10-47);
- ``duplicate_time_embed``: ``time_embed`` copied to
  ``cond_time_stack_embed`` for a vanilla SVD/Vista checkpoint
  (video_diffusion/train.py:652-655);
- ``split_engine_state_dict``: a full vwm state dict into the port's
  {"unet", "vae", "clip"} state dicts (the port keeps the reference's
  names, so this only strips prefixes);
- ``engine_params_from_jax``: the JAX engine's parameter tree (nested dicts
  of arrays) into the same three state dicts, through the port's own copy
  of the JAX package's name maps, inverted: Dense [in, out] -> Linear
  [out, in], Conv HWIO / DHWIO -> OIHW / OIDHW, norm scale -> weight, the
  CLIP q/k/v DenseGenerals packed into ``in_proj``. Raises on any leaf left
  over or any port parameter missing.
"""

from __future__ import annotations

import os
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

UNET_PREFIX = "model.diffusion_model."
VAE_PREFIX = "first_stage_model."
CLIP_VISUAL_PREFIX = "conditioner.embedders.0.open_clip.model.visual."

# ------------------------------------------------------------------ readers


def read_checkpoint(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """A torch-side checkpoint as {name: float32 ndarray}."""
    path = str(path)
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        sd = dict(load_file(path))
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict) and "state_dict" in obj:
            obj = obj["state_dict"]
        if isinstance(obj, dict) and "module" in obj and all(
                not torch.is_tensor(v) for v in list(obj.values())[:1]):
            obj = obj.get("module", obj)
        sd = {k: v.detach().to(torch.float32).cpu().numpy()
              for k, v in obj.items() if torch.is_tensor(v)}
    return {k.replace("_forward_module.", ""): np.asarray(v, np.float32)
            for k, v in sd.items()}


def merge_lora_ema(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Fold LoRA adapters into their base projections (W += up @ down),
    then substitute EMA weights (``model_ema.<name without dots>``)."""
    sd = dict(sd)
    for k in list(sd.keys()):
        if "adapter_down" not in k:
            continue
        for tag, base in (("q_adapter_down", "to_q"),
                          ("k_adapter_down", "to_k"),
                          ("v_adapter_down", "to_v"),
                          ("out_adapter_down", None)):
            if tag not in k:
                continue
            up_k = k.replace(tag, tag.replace("down", "up"))
            if base is None:      # EMA keys have their dots stripped
                base_k = k.replace("out_adapter_down", "to_out0"
                                   if "model_ema" in k else "to_out.0")
            else:
                base_k = k.replace(tag, base)
            sd[base_k] = sd[base_k] + sd[up_k] @ sd[k]
            del sd[k], sd[up_k]
            break
    ema = {k: v for k, v in sd.items()
           if k.startswith("model_ema.")
           and not k.endswith(("decay", "num_updates"))}
    if ema:
        originals = {k.replace(".", ""): k for k in sd
                     if not k.startswith("model_ema.")}
        for k, v in ema.items():
            orig = originals.get("model" + k[len("model_ema."):])
            if orig is not None:
                sd[orig] = v
        for k in list(sd.keys()):
            if k.startswith("model_ema."):
                del sd[k]
    return sd


def duplicate_time_embed(sd: dict[str, np.ndarray]
                         ) -> dict[str, np.ndarray]:
    """Copy every ``time_embed`` weight to ``cond_time_stack_embed``; a
    no-op when the checkpoint already has the conditioned embed."""
    if any("cond_time_stack_embed" in k for k in sd):
        return sd
    sd = dict(sd)
    for k in list(sd.keys()):
        if "time_embed" in k:
            sd[k.replace("time_embed", "cond_time_stack_embed")] = sd[k]
    return sd


def split_engine_state_dict(sd: dict[str, Any]) -> dict[str, dict]:
    """A full vwm checkpoint's names -> the port's three state dicts
    (other keys, e.g. the conditioner's other embedders, are dropped)."""
    out: dict[str, dict] = {"unet": {}, "vae": {}, "clip": {}}
    for k, v in sd.items():
        for part, prefix in (("unet", UNET_PREFIX), ("vae", VAE_PREFIX),
                             ("clip", CLIP_VISUAL_PREFIX)):
            if k.startswith(prefix):
                name = k[len(prefix):]
                if part == "vae":
                    name = name.replace(".conv_shortcut.", ".nin_shortcut.")
                out[part][name] = v
    return out


# ---------------------------------------------- name maps (torch -> flax)

def _mlp_map(tp: str, fp: str) -> dict[str, str]:
    return {f"{tp}.0": f"{fp}/fc1", f"{tp}.2": f"{fp}/fc2"}


def _resblock_map(tp: str, fp: str) -> dict[str, str]:
    def one(t, f):
        return {f"{t}.in_layers.0": f"{f}/in_norm",
                f"{t}.in_layers.2": f"{f}/in_conv",
                f"{t}.emb_layers.1": f"{f}/emb_proj",
                f"{t}.out_layers.0": f"{f}/out_norm",
                f"{t}.out_layers.3": f"{f}/out_conv",
                f"{t}.skip_connection": f"{f}/skip_conv"}
    out = one(tp, f"{fp}/spatial")
    out.update(one(f"{tp}.time_stack", f"{fp}/time_stack"))
    out[f"{tp}.time_mixer"] = f"{fp}/time_mixer"
    return out


def _transformer_map(tp: str, fp: str, depth: int,
                     lora: bool) -> dict[str, str]:
    def block(t, f, with_ff_in):
        m = {}
        for a in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                m[f"{t}.{a}.{proj}"] = f"{f}/{a}/{proj}"
            m[f"{t}.{a}.to_out.0"] = f"{f}/{a}/to_out"
            if lora:
                for x in ("q", "k", "v", "out"):
                    for d in ("down", "up"):
                        m[f"{t}.{a}.{x}_adapter_{d}"] = \
                            f"{f}/{a}/{x}_adapter_{d}"
        for i in (1, 2, 3):
            m[f"{t}.norm{i}"] = f"{f}/norm{i}"
        m[f"{t}.ff.net.0.proj"] = f"{f}/ff/proj_in"
        m[f"{t}.ff.net.2"] = f"{f}/ff/proj_out"
        if with_ff_in:
            m[f"{t}.norm_in"] = f"{f}/norm_in"
            m[f"{t}.ff_in.net.0.proj"] = f"{f}/ff_in/proj_in"
            m[f"{t}.ff_in.net.2"] = f"{f}/ff_in/proj_out"
        return m

    out = {f"{tp}.norm": f"{fp}/norm", f"{tp}.proj_in": f"{fp}/proj_in",
           f"{tp}.proj_out": f"{fp}/proj_out",
           f"{tp}.time_mixer": f"{fp}/time_mixer"}
    out.update(_mlp_map(f"{tp}.time_pos_embed", f"{fp}/time_pos_embed"))
    for d in range(depth):
        out.update(block(f"{tp}.transformer_blocks.{d}", f"{fp}/block_{d}",
                         False))
        out.update(block(f"{tp}.time_stack.{d}", f"{fp}/time_block_{d}",
                         True))
    return out


def unet_name_map(cfg) -> dict[str, str]:
    """torch module path -> flax module path of the VideoUNet (the JAX
    package's ``weights.py:150-199``)."""
    m: dict[str, str] = {}
    m.update(_mlp_map("time_embed", "time_embed"))
    m.update(_mlp_map("cond_time_stack_embed", "cond_time_stack_embed"))
    m.update(_mlp_map("label_emb.0", "label_emb"))
    m["input_blocks.0.0"] = "input_conv"
    m["condition_input_blocks.0.0"] = "condition_conv_0"
    m["condition_input_blocks.1.0"] = "condition_conv_1"
    depth, lora = cfg.transformer_depth, cfg.add_lora
    n, ds = 1, 1
    for level in range(len(cfg.channel_mult)):
        for i in range(cfg.num_res_blocks):
            m.update(_resblock_map(f"input_blocks.{n}.0",
                                   f"in_{level}_{i}_res"))
            if ds in cfg.attention_resolutions:
                m.update(_transformer_map(f"input_blocks.{n}.1",
                                          f"in_{level}_{i}_attn", depth,
                                          lora))
            n += 1
        if level != len(cfg.channel_mult) - 1:
            m[f"input_blocks.{n}.0.op"] = f"down_{level}/conv"
            n += 1
            ds *= 2
    m.update(_resblock_map("middle_block.0", "mid_res_0"))
    m.update(_transformer_map("middle_block.1", "mid_attn", depth, lora))
    m.update(_resblock_map("middle_block.2", "mid_res_1"))
    n = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            m.update(_resblock_map(f"output_blocks.{n}.0",
                                   f"out_{level}_{i}_res"))
            j = 1
            if ds in cfg.attention_resolutions:
                m.update(_transformer_map(f"output_blocks.{n}.1",
                                          f"out_{level}_{i}_attn", depth,
                                          lora))
                j = 2
            if level and i == cfg.num_res_blocks:
                m[f"output_blocks.{n}.{j}.conv"] = f"up_{level}/conv"
                ds //= 2
            n += 1
    m["out.0"] = "out_norm"
    m["out.2"] = "out_conv"
    return m


def _resnet_map(tp: str, fp: str) -> dict[str, str]:
    return {f"{tp}.norm1": f"{fp}/norm1", f"{tp}.conv1": f"{fp}/conv1",
            f"{tp}.norm2": f"{fp}/norm2", f"{tp}.conv2": f"{fp}/conv2",
            f"{tp}.nin_shortcut": f"{fp}/nin_shortcut"}


def _video_resnet_map(tp: str, fp: str) -> dict[str, str]:
    m = _resnet_map(tp, f"{fp}/spatial")
    m.update({f"{tp}.time_stack.in_layers.0": f"{fp}/time_stack/in_norm",
              f"{tp}.time_stack.in_layers.2": f"{fp}/time_stack/in_conv",
              f"{tp}.time_stack.out_layers.0": f"{fp}/time_stack/out_norm",
              f"{tp}.time_stack.out_layers.3": f"{fp}/time_stack/out_conv",
              tp: fp})                       # <tp>.mix_factor
    return m


def _attn_map(tp: str, fp: str) -> dict[str, str]:
    return {f"{tp}.{x}": f"{fp}/{x}" for x in ("norm", "q", "k", "v",
                                               "proj_out")}


def vae_name_map(cfg) -> dict[str, str]:
    """torch module path -> flax module path of the VAE with the video
    decoder (the JAX package's ``convert.py:237-272``)."""
    m: dict[str, str] = {"encoder.conv_in": "encoder/conv_in"}
    L = len(cfg.ch_mult)
    for lv in range(L):
        for i in range(cfg.num_res_blocks):
            m.update(_resnet_map(f"encoder.down.{lv}.block.{i}",
                                 f"encoder/down_{lv}_block_{i}"))
        if lv != L - 1:
            m[f"encoder.down.{lv}.downsample.conv"] = \
                f"encoder/down_{lv}_downsample"
    m.update(_resnet_map("encoder.mid.block_1", "encoder/mid_block_1"))
    m.update(_attn_map("encoder.mid.attn_1", "encoder/mid_attn_1"))
    m.update(_resnet_map("encoder.mid.block_2", "encoder/mid_block_2"))
    m["encoder.norm_out"] = "encoder/norm_out"
    m["encoder.conv_out"] = "encoder/conv_out"
    m["decoder.conv_in"] = "decoder/conv_in"
    m.update(_video_resnet_map("decoder.mid.block_1", "decoder/mid_block_1"))
    m.update(_attn_map("decoder.mid.attn_1", "decoder/mid_attn_1"))
    m.update(_video_resnet_map("decoder.mid.block_2", "decoder/mid_block_2"))
    for lv in range(L):
        for i in range(cfg.num_res_blocks + 1):
            m.update(_video_resnet_map(f"decoder.up.{lv}.block.{i}",
                                       f"decoder/up_{lv}_block_{i}"))
        if lv != 0:
            m[f"decoder.up.{lv}.upsample.conv"] = f"decoder/up_{lv}_upsample"
    m["decoder.norm_out"] = "decoder/norm_out"
    m["decoder.conv_out"] = "decoder/conv_out"
    m["decoder.conv_out.time_mix_conv"] = "decoder/conv_out_time_mix"
    return m


def clip_name_map(cfg) -> dict[str, str]:
    """torch module path -> flax module path of the CLIP tower; the
    attention's q/k/v map to the packed ``attn.in_proj`` separately."""
    m = {"conv1": "patch_embed", "ln_pre": "ln_pre", "ln_post": "ln_post"}
    for i in range(cfg.layers):
        t, f = f"transformer.resblocks.{i}", f"resblock_{i}"
        m.update({f"{t}.ln_1": f"{f}/ln_1", f"{t}.ln_2": f"{f}/ln_2",
                  f"{t}.attn.out_proj": f"{f}/attn/out",
                  f"{t}.mlp.c_fc": f"{f}/mlp_fc",
                  f"{t}.mlp.c_proj": f"{f}/mlp_proj"})
    return m


# ------------------------------------------------------- JAX -> port


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def _torch_layout(leaf: str, a: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        if a.ndim == 2:
            a = a.T                              # [in, out] -> [out, in]
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)          # HWIO -> OIHW
        elif a.ndim == 5:
            a = a.transpose(4, 3, 0, 1, 2)       # DHWIO -> OIDHW
        return "weight", a
    if leaf == "scale":
        return "weight", a
    return leaf, a                               # bias, mix_factor


def _convert(flat: dict[str, np.ndarray], module_map: dict[str, str],
             what: str) -> dict[str, np.ndarray]:
    inverse: dict[str, str] = {}
    for tmod, fmod in module_map.items():
        inverse.setdefault(fmod, tmod)
    out = {}
    left = []
    for path, a in flat.items():
        fmod, _, leaf = path.rpartition("/")
        tmod = inverse.get(fmod)
        if tmod is None:
            left.append(path)
            continue
        name, a = _torch_layout(leaf, a)
        out[f"{tmod}.{name}"] = a
    if left:
        raise ValueError(f"{what}: {len(left)} JAX parameters have no port "
                         f"name, e.g. {left[:5]}")
    return out


def _clip_from_jax(flat: dict[str, np.ndarray], cfg) -> dict[str, np.ndarray]:
    flat = dict(flat)
    out = {}
    W = cfg.width
    for leaf in ("class_embedding", "positional_embedding", "proj"):
        out[leaf] = flat.pop(leaf)
    for i in range(cfg.layers):
        f, t = f"resblock_{i}/attn", f"transformer.resblocks.{i}.attn"
        ws = [flat.pop(f"{f}/{x}/kernel").reshape(W, W).T
              for x in ("query", "key", "value")]
        bs = [flat.pop(f"{f}/{x}/bias").reshape(W)
              for x in ("query", "key", "value")]
        out[f"{t}.in_proj_weight"] = np.concatenate(ws, 0)
        out[f"{t}.in_proj_bias"] = np.concatenate(bs, 0)
        out[f"{t}.out_proj.weight"] = flat.pop(f"{f}/out/kernel").reshape(
            W, W).T
        out[f"{t}.out_proj.bias"] = flat.pop(f"{f}/out/bias")
    out.update(_convert(flat, clip_name_map(cfg), "clip"))
    return out


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def engine_params_from_jax(tree: Mapping, cfg
                           ) -> dict[str, dict[str, torch.Tensor]]:
    """The JAX engine's {"unet", "vae", "clip"} parameters (each optionally
    under "params"; nested dicts of arrays) -> the port's state dicts
    (f32 torch tensors) for an ``EngineConfig`` ``cfg``. Checks every name
    against the port's modules and raises on any mismatch."""
    from .clip import CLIPVisual
    from .unet import VideoUNet
    from .vae import VAE
    sds = {
        "unet": state_dict_from_jax(tree["unet"], unet_name_map(cfg.unet),
                                    "unet"),
        "vae": state_dict_from_jax(tree["vae"], vae_name_map(cfg.vae), "vae"),
        "clip": _tensors(_clip_from_jax(_flatten(_params(tree["clip"])),
                                        cfg.clip)),
    }
    with torch.device("meta"):
        modules = {"unet": VideoUNet(cfg.unet), "vae": VAE(cfg.vae),
                   "clip": CLIPVisual(cfg.clip)}
    out = {}
    for part, sd in sds.items():
        want = modules[part].state_dict()
        missing = sorted(set(want) - set(sd))
        extra = sorted(set(sd) - set(want))
        if missing or extra:
            raise ValueError(f"{part}: port parameters missing {missing[:5]} "
                             f"({len(missing)}), unknown {extra[:5]} "
                             f"({len(extra)})")
        out[part] = {k: a.reshape(want[k].shape) for k, a in sd.items()}
    return out


def _tensors(sd: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(a))
            for k, a in sd.items()}


def state_dict_from_jax(params: Mapping, module_map: dict[str, str],
                        what: str = "module") -> dict[str, torch.Tensor]:
    """One flax module's parameters (optionally under "params") -> a torch
    state dict, through a torch -> flax module-path map such as
    ``unet_name_map``; raises on a leaf the map does not name."""
    return _tensors(_convert(_flatten(_params(params)), module_map, what))
