"""Conditioning of the LiDAR-conditioned video model (port of
``street_crafter_tpu/models/vdm/conditioner.py``).

- ``crossattn``: the CLIP image embedding of the conditioning frame,
  [B*T, 1, 1024];
- ``vector``: sinusoidal 256-d embeddings of (fps_id, motion_bucket_id,
  cond_aug), concatenated -> [B*T, 768];
- ``concat``: the VAE-encoded (mode) conditioning frame repeated over the
  clip, [B*T, h, w, 4].
The unconditional branch zeroes crossattn and concat and keeps vector.
``apply_ucg_dropout`` drops crossattn and concat per clip (the
conditioner's ``ucg_rate``); neither the trainer nor the runners call it,
as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .layers import timestep_embedding


class Conditioning(NamedTuple):
    crossattn: torch.Tensor  # [B*T, 1, 1024]
    vector: torch.Tensor     # [B*T, 768]
    concat: torch.Tensor     # [B*T, h, w, 4]


def concat_timestep_embed(values: torch.Tensor,
                          outdim: int = 256) -> torch.Tensor:
    """ConcatTimestepEmbedderND (modules.py:407-430): [B, D] -> [B, D*out]."""
    if values.dim() == 1:
        values = values[:, None]
    b, d = values.shape
    return timestep_embedding(values.reshape(-1), outdim).reshape(b, d * outdim)


def make_vector_conditioning(fps_id: torch.Tensor,
                             motion_bucket_id: torch.Tensor,
                             cond_aug: torch.Tensor,
                             outdim: int = 256) -> torch.Tensor:
    return torch.cat([concat_timestep_embed(v, outdim)
                      for v in (fps_id, motion_bucket_id, cond_aug)], dim=-1)


def get_conditioning(
    clip_embed_fn: Callable[[torch.Tensor], torch.Tensor],
    vae_encode_fn: Callable[[torch.Tensor], torch.Tensor],
    cond_frame_without_noise: torch.Tensor,   # [B, H, W, 3] in [-1, 1]
    cond_frame: torch.Tensor,                 # [B, H, W, 3]
    num_frames: int,
    fps_id: float = 10.0,
    motion_bucket_id: float = 127.0,
    cond_aug: float = 0.0,
    vector_outdim: int = 256,
) -> tuple[Conditioning, Conditioning]:
    """(cond, uncond): VanillaCFG's prepared pair (guiders.py:28-41)."""
    b = cond_frame.shape[0]
    crossattn = clip_embed_fn(cond_frame_without_noise)[:, None, :]
    crossattn = crossattn.repeat_interleave(num_frames, dim=0)
    ones = torch.ones((b,), dtype=torch.float32, device=cond_frame.device)
    vector = make_vector_conditioning(ones * fps_id, ones * motion_bucket_id,
                                      ones * cond_aug, vector_outdim)
    vector = vector.repeat_interleave(num_frames, dim=0)
    concat = vae_encode_fn(cond_frame).repeat_interleave(num_frames, dim=0)
    cond = Conditioning(crossattn=crossattn, vector=vector, concat=concat)
    uc = Conditioning(crossattn=torch.zeros_like(crossattn), vector=vector,
                      concat=torch.zeros_like(concat))
    return cond, uc


UCG_KEYS = ("crossattn", "concat")


def ucg_keep_masks(rates: dict[str, float], batch: int,
                   generator: torch.Generator | None = None,
                   device=None) -> dict[str, torch.Tensor]:
    """Per-clip keep masks of ``apply_ucg_dropout``: for each of crossattn
    and concat whose rate is above 0, [batch] bools, True with probability
    1 - rate, drawn from ``generator``."""
    masks = {}
    for key in UCG_KEYS:
        rate = rates.get(key, 0)
        if rate > 0:
            u = torch.rand((batch,), generator=generator, device=device)
            masks[key] = u < 1.0 - rate
    return masks


def apply_ucg_dropout(cond: Conditioning, rates: dict[str, float],
                      batch: int, generator: torch.Generator | None = None,
                      masks: dict[str, torch.Tensor] | None = None
                      ) -> Conditioning:
    """Unconditional-guidance dropout of fine-tuning (GeneralConditioner
    ``ucg_rate``; the JAX package's ``conditioner.py:84-101``): each clip's
    crossattn and concat rows (T frames each, clip-major) are zeroed when
    its keep mask is False. ``masks`` as ``ucg_keep_masks`` gives them
    (drawn from ``generator`` when not given); a key whose rate is 0 is
    left as it is."""
    if masks is None:
        masks = ucg_keep_masks(rates, batch, generator,
                               cond.crossattn.device)
    out = cond
    for key in UCG_KEYS:
        if rates.get(key, 0) > 0:
            x = getattr(out, key)
            keep = masks[key].to(device=x.device).repeat_interleave(
                x.shape[0] // batch)
            keep = keep.reshape((-1,) + (1,) * (x.dim() - 1))
            out = out._replace(**{key: x * keep.to(x.dtype)})
    return out
