"""Adaptive density control on fixed-capacity pools (port of
``street_crafter_tpu/models/gs/densify.py``).

The 3DGS clone/split/prune cycle, with the JAX package's slot semantics so
that both assign the same slots: children go into free (invalid) slots in
ascending index order, allocated by a prefix sum over the parents; a
parent whose children do not fit is not densified; prune clears the
validity mask; Adam moments at (re)written slots are zeroed. Pools keep
their capacity (no compaction, see ROADMAP).

Everything runs in place under ``torch.no_grad()``. A pool may carry batch
dimensions ([A, cap, ...] for the stacked actors): the JAX package's vmap
over actors is the leading dimension here, with per-actor thresholds,
column choice and boxes. The split noise is an argument ([*batch, 2, cap,
3] standard normals) so that a caller can hand in any generator's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ...ops import quaternion as Q
from .optim import GaussianAdamState, zero_moments_at
from .params import GaussianPool

POOL_ARRAYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
               "opacity")


@dataclasses.dataclass
class DensifyState:
    # two accumulator columns, as the reference's xyz_gradient_accum[:, 0:2]:
    # the absgrad norm (gsplat absgrad channel) and the signed-grad norm
    grad_accum: torch.Tensor      # [*, cap] signed-gradient norms
    grad_abs_accum: torch.Tensor  # [*, cap] absgrad norms
    denom: torch.Tensor           # [*, cap] number of accumulations
    max_radii2d: torch.Tensor     # [*, cap] running max screen radius


def init_densify_state(shape: tuple, device=None) -> DensifyState:
    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return DensifyState(z(), z(), z(), z())


@torch.no_grad()
def accumulate_stats(state: DensifyState, contrib: torch.Tensor,
                     contrib_abs: torch.Tensor, visf: torch.Tensor,
                     radii: torch.Tensor) -> None:
    """add_densification_stats, in place: per-Gaussian screen-gradient
    norms (already times visibility and 0.5 [W, H]) and the screen radius
    (0 where not visible)."""
    state.grad_accum.add_(contrib)
    state.grad_abs_accum.add_(contrib_abs)
    state.denom.add_(visf)
    state.max_radii2d.copy_(torch.maximum(state.max_radii2d, radii))


def sky_extent(pool: GaussianPool, sphere_radius: torch.Tensor,
               percent_dense: float = 0.01) -> torch.Tensor:
    """The sky pool's own densification extent: the sphere radius clamped
    between the 10%-smallest and 10%-largest max-scales over
    percent_dense, over valid slots only."""
    scale_max = torch.minimum(pool.get_scaling(), sphere_radius).amax(-1)
    n_valid = int(pool.valid.sum())
    k = max(int(n_valid / 10), 1)
    asc = torch.sort(torch.where(pool.valid, scale_max, torch.inf)).values
    low = asc[max(k - 1, 0)] / percent_dense
    up = asc[max(n_valid - k, 0)] / percent_dense
    return torch.clamp(sphere_radius, low, up)


class DensifyInfo(NamedTuple):
    n_cloned: torch.Tensor   # [*batch]
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_valid: torch.Tensor


def _per_batch(x, batch: int, device, dtype) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device).expand(batch)


@torch.no_grad()
def densify_and_prune(
    pool: GaussianPool,
    adam: GaussianAdamState,
    state: DensifyState,
    noise: torch.Tensor,                 # [*batch, 2, cap, 3] N(0, 1)
    grad_threshold,                      # float or [*batch]
    percent_dense: float,
    extent: float,
    min_opacity: float = 0.005,
    prune_big_points: bool = False,
    percent_big_ws: float = 0.1,
    max_screen_size: float = 0.0,
    bbox: torch.Tensor | None = None,    # [*batch, 3] (l, w, h): prune
    # Gaussians outside the canonical-frame box (actors)
    pin_sphere: tuple[torch.Tensor, torch.Tensor] | None = None,  # (centre
    # [3], radius): the sky pool; split children sample around the pinned
    # positions and scales are clamped at the radius for the tests
    use_abs=True,                        # bool or [*batch]: densify on the
    # absgrad column (the reference's densify_grad_abs_* flag is its
    # negation)
) -> DensifyInfo:
    """Clone, split and prune ``pool`` in place; zero the Adam moments of
    rewritten slots and reset ``state``."""
    batched = pool.xyz.dim() == 3
    one = (lambda t: t) if batched else (lambda t: t[None])
    arrays = {k: one(getattr(pool, k)) for k in POOL_ARRAYS}
    valid = one(pool.valid)
    B, cap = valid.shape
    dev = valid.device
    thresh = _per_batch(grad_threshold, B, dev, torch.float32)[:, None]
    use_abs = _per_batch(use_abs, B, dev, torch.bool)[:, None]
    noise = one(noise)

    accum = torch.where(use_abs, one(state.grad_abs_accum),
                        one(state.grad_accum))
    grads = accum / torch.clamp(one(state.denom), min=1.0)
    grads = torch.where(torch.isnan(grads), 0.0, grads)

    scales_act = torch.exp(arrays["scaling"])
    base_xyz = arrays["xyz"]
    if pin_sphere is not None:
        center, radius = pin_sphere
        rel = base_xyz - center
        ratio = torch.linalg.norm(rel, dim=-1, keepdim=True) / (2.0 * radius)
        base_xyz = torch.where(
            ratio < 1.0, center + rel / torch.clamp(ratio, min=1e-12),
            base_xyz)
        scales_act = torch.minimum(scales_act, radius)
    scale_max = scales_act.amax(-1)
    hot = valid & (grads >= thresh)
    clone_mask = hot & (scale_max <= percent_dense * extent)
    split_mask = hot & (scale_max > percent_dense * extent)

    # -- allocate children into free slots ---------------------------------
    child_count = clone_mask.to(torch.int64) + 2 * split_mask.to(torch.int64)
    offsets = torch.cumsum(child_count, -1) - child_count       # exclusive
    n_free = cap - valid.sum(-1, keepdim=True)
    fits = (offsets + child_count) <= n_free
    child_count = torch.where(fits, child_count, 0)
    # free slots in ascending index order (invalid first, stable)
    free_list = torch.argsort(valid.to(torch.int32), dim=-1, stable=True)

    rotmats = Q.to_matrix(arrays["rotation"])                  # [B, cap, 3, 3]
    scaled = noise * scales_act[:, None]                       # [B, 2, cap, 3]
    split_xyz = base_xyz[:, None] + torch.einsum("bnij,bsnj->bsni", rotmats,
                                                 scaled)
    split_scaling = torch.log(torch.clamp(scales_act / 1.6, min=1e-12))

    new_valid = valid & ~(split_mask & fits)    # split parents removed
    slot_reset = torch.zeros_like(valid)
    for j in range(2):
        bi, pi = torch.nonzero(child_count > j, as_tuple=True)
        di = free_list[bi, torch.clamp(offsets[bi, pi] + j, max=cap - 1)]
        is_split = split_mask[bi, pi][:, None]
        for name, arr in arrays.items():
            val = arr[bi, pi]
            if name == "xyz":
                val = torch.where(is_split, split_xyz[bi, j, pi], val)
            elif name == "scaling":
                val = torch.where(is_split, split_scaling[bi, pi], val)
            arr[bi, di] = val
        new_valid[bi, di] = True
        slot_reset[bi, di] = True

    # -- prune ---------------------------------------------------------------
    opa = torch.sigmoid(arrays["opacity"])[..., 0]
    prune = new_valid & (opa < min_opacity)
    if prune_big_points:
        scale_new = torch.exp(arrays["scaling"])
        if pin_sphere is not None:
            scale_new = torch.minimum(scale_new, pin_sphere[1])
        prune |= new_valid & (scale_new.amax(-1) > extent * percent_big_ws)
        if max_screen_size > 0:
            prune |= (new_valid & (one(state.max_radii2d) > max_screen_size)
                      & ~slot_reset)
    if bbox is not None:
        box = one(bbox)[:, None, :] / 2.0
        prune |= new_valid & (arrays["xyz"].abs() > box).any(-1)
    new_valid &= ~prune
    valid.copy_(new_valid)

    zero_moments_at(adam, slot_reset if batched else slot_reset[0])
    for t in (state.grad_accum, state.grad_abs_accum, state.denom,
              state.max_radii2d):
        t.zero_()
    info = DensifyInfo(n_cloned=(clone_mask & fits).sum(-1),
                       n_split=(split_mask & fits).sum(-1),
                       n_pruned=prune.sum(-1), n_valid=new_valid.sum(-1))
    return info if batched else DensifyInfo(*(x[0] for x in info))


@torch.no_grad()
def reset_opacity(pool: GaussianPool, adam: GaussianAdamState,
                  value: float = 0.01) -> None:
    """Opacity clamp-down, in place, and a moment reset of the opacity
    group."""
    logit = torch.log(torch.tensor(value / (1.0 - value)))   # in float32
    pool.opacity.clamp_(max=float(logit))
    zero_moments_at(adam, torch.ones(pool.valid.shape, dtype=torch.bool,
                                     device=pool.device), keys=("opacity",))
