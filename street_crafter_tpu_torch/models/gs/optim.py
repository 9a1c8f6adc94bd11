"""Per-group Adam for Gaussian pools (port of
``street_crafter_tpu/models/gs/optim.py``) and the learning-rate tables of
the train step (``street_crafter_tpu/training/gs_trainer.py`` ``pool_lrs``
and ``misc_lrs``).

Pools have a fixed capacity, so the moments are fixed-shape tensors too and
the reference's optimizer-state surgery on densify/prune reduces to zeroing
moment rows at slots that were (re)allocated. eps is the 3DGS family's
1e-15. Unlike the JAX package, which returns new arrays, ``adam_update``
updates parameters and moments IN PLACE under ``torch.no_grad()``: a pool
of 2^20 slots would otherwise hold a second copy of every parameter and
moment for the length of the update.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import torch

from ...config import Config
from ...ops.maths import expon_lr

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15


@dataclasses.dataclass
class GaussianAdamState:
    m: dict[str, torch.Tensor]
    v: dict[str, torch.Tensor]
    count: torch.Tensor  # int32, shape of the batch dims ([] or [A])


def init_adam(params: Mapping[str, torch.Tensor],
              batch_shape: tuple = ()) -> GaussianAdamState:
    any_p = next(iter(params.values()))
    return GaussianAdamState(
        m={k: torch.zeros_like(p) for k, p in params.items()},
        v={k: torch.zeros_like(p) for k, p in params.items()},
        count=torch.zeros(batch_shape, dtype=torch.int32,
                          device=any_p.device))


def _gate(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


@torch.no_grad()
def adam_update(params: Mapping[str, torch.Tensor],
                grads: Mapping[str, torch.Tensor | None],
                state: GaussianAdamState, lrs: Mapping[str, float],
                update_mask: torch.Tensor | None = None) -> None:
    """One Adam step, in place. ``update_mask`` [*batch, cap]: rows outside
    it take no gradient and no step. A missing gradient counts as zero."""
    state.count += 1
    c = state.count.to(torch.float32)
    bc1 = 1.0 - torch.tensor(ADAM_B1, dtype=torch.float32) ** c
    bc2 = 1.0 - torch.tensor(ADAM_B2, dtype=torch.float32) ** c
    for k, p in params.items():
        g = grads.get(k)
        if g is None:
            g = torch.zeros_like(p)
        gate = None
        if update_mask is not None:
            gate = _gate(update_mask, g)
            g = torch.where(gate, g, 0.0)
        m, v = state.m[k], state.v[k]
        m.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
        v.mul_(ADAM_B2).add_((1 - ADAM_B2) * g * g)
        b1, b2 = _gate(bc1, p), _gate(bc2, p)
        step = lrs[k] * (m / b1) / (torch.sqrt(v / b2) + ADAM_EPS)
        if gate is not None:
            step = torch.where(gate, step, 0.0)
        p.sub_(step)


@torch.no_grad()
def zero_moments_at(state: GaussianAdamState, slot_mask: torch.Tensor,
                    keys: Iterable[str] | None = None) -> None:
    """Zero first and second moments at the slots of ``slot_mask``, in
    place (the reference's optimizer surgery)."""
    for k in (state.m if keys is None else keys):
        for d in (state.m, state.v):
            d[k].masked_fill_(_gate(slot_mask, d[k]), 0.0)


def pool_lrs(cfg: Config, step: int, spatial_lr_scale: float
             ) -> dict[str, float]:
    """Per-group learning rates of a Gaussian pool."""
    o = cfg.optim
    return {
        "xyz": expon_lr(step, o.position_lr_init * spatial_lr_scale,
                        o.position_lr_final * spatial_lr_scale,
                        lr_delay_mult=o.position_lr_delay_mult,
                        max_steps=o.position_lr_max_steps),
        "f_dc": float(o.feature_lr),
        "f_rest": float(o.feature_lr / 20.0),
        "opacity": float(o.opacity_lr),
        "scaling": float(o.scaling_lr),
        "rotation": float(o.rotation_lr),
    }


def misc_lrs(cfg: Config, step: int, keys: Iterable[str]
             ) -> dict[str, float]:
    """Learning rates of the scene-level leaves (track residuals,
    corrections), by leaf name; ``name.sub`` keys take ``name``'s rate."""
    o = cfg.optim
    table = {
        "opt_trans": expon_lr(step, o.track_position_lr_init,
                              o.track_position_lr_final,
                              max_steps=o.position_lr_max_steps),
        "opt_theta": expon_lr(step, o.track_rotation_lr_init,
                              o.track_rotation_lr_final,
                              max_steps=o.position_lr_max_steps),
        "sky_cubemap": float(o.sky_cube_map_lr),
        "color_corr": float(o.color_correction_lr),
        "color_corr_sky": float(o.color_correction_lr),
        "pose_corr_quat": float(o.pose_correction_lr),
        "pose_corr_trans": float(o.pose_correction_lr),
        "color_mlp": float(o.color_correction_lr),
        "color_mlp_sky": float(o.color_correction_lr),
    }
    return {k: table[k.split(".", 1)[0]] for k in keys}
