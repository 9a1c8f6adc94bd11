"""3DGS trainer: the train step, densify step and opacity reset (port of
``street_crafter_tpu/training/gs_trainer.py``).

A train step renders (foreground with posed actors, then the Gaussian sky
or the cubemap lookup),
computes the loss stack, runs autograd (kernel C for the compositing
backward on the card), applies per-group masked Adam in place and
accumulates the densification statistics. Screen-space gradients for
densification come from the renderer's explicit hooks: the gradient of
``viewspace_zero`` (dL/d(u, v)) and of ``absgrad_sink`` (per-pixel
|dL/d(u, v)| sums), scaled by 0.5 [W, H] so that the reference's
densify_grad_threshold values carry over. The JAX package's vmap over
actors is the stacked pool's leading dimension here. Pools keep their
fixed capacity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from ..config import Config
from ..models.gs.densify import (DensifyState, accumulate_stats,
                                 densify_and_prune, init_densify_state,
                                 reset_opacity, sky_extent)
from ..models.gs.losses import LossWeights, compute_train_loss
from ..models.gs.optim import (GaussianAdamState, adam_update, init_adam,
                               misc_lrs, pool_lrs)
from ..models.gs.params import GaussianPool
from ..models.gs.renderer import render_scene
from ..models.gs.scene import SceneMeta, SceneParams
from ..parallel.mesh import Mesh

POOLS = ("bkgd", "actors", "sky")
# scene-level leaves optimised by one Adam group each (``adam_misc``); the
# colour MLPs' weights are leaves ``color_mlp.w0``, ``color_mlp.b0``, ...
MISC = ("opt_trans", "opt_theta", "sky_cubemap", "color_corr",
        "color_corr_sky", "pose_corr_quat", "pose_corr_trans", "color_mlp",
        "color_mlp_sky")


@dataclasses.dataclass
class GSTrainState:
    params: SceneParams
    adam_bkgd: GaussianAdamState | None
    adam_actors: GaussianAdamState | None   # batch dim: the actor axis
    adam_sky: GaussianAdamState | None
    adam_misc: GaussianAdamState | None
    dstate_bkgd: DensifyState | None
    dstate_actors: DensifyState | None      # [A, cap]
    dstate_sky: DensifyState | None
    step: int


def misc_params(params: SceneParams) -> dict[str, torch.Tensor]:
    out = {}
    for k in MISC:
        x = getattr(params, k)
        if isinstance(x, dict):
            out.update({f"{k}.{sub}": v for sub, v in x.items()})
        elif x is not None:
            out[k] = x
    return out


def trainable_leaves(params: SceneParams) -> list[torch.Tensor]:
    out = list(misc_params(params).values())
    for name in POOLS:
        pool = getattr(params, name)
        if pool is not None:
            out += list(pool.trainable_dict().values())
    return out


def set_trainable(params: SceneParams) -> None:
    """Make every optimised tensor an autograd leaf (after a load)."""
    for t in trainable_leaves(params):
        if not t.requires_grad:
            t.requires_grad_(True)


def init_train_state(params: SceneParams) -> GSTrainState:
    set_trainable(params)

    def pool_state(pool: GaussianPool | None):
        if pool is None:
            return None, None
        batch = tuple(pool.valid.shape[:-1])
        return (init_adam(pool.trainable_dict(), batch),
                init_densify_state(tuple(pool.valid.shape), pool.device))

    adam_b, ds_b = pool_state(params.bkgd)
    adam_a, ds_a = pool_state(params.actors)
    adam_s, ds_s = pool_state(params.sky)
    misc = misc_params(params)
    return GSTrainState(
        params=params, adam_bkgd=adam_b, adam_actors=adam_a, adam_sky=adam_s,
        adam_misc=init_adam(misc) if misc else None,
        dstate_bkgd=ds_b, dstate_actors=ds_a, dstate_sky=ds_s, step=0)


class StepOutput(NamedTuple):
    state: GSTrainState
    scalars: dict[str, torch.Tensor]


def _sizes(params: SceneParams) -> tuple[int, int, int]:
    nb = params.bkgd.capacity if params.bkgd is not None else 0
    A, cap = (tuple(params.actors.xyz.shape[:2]) if params.actors is not None
              else (0, 0))
    return nb, A, cap


def _grads(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: t.grad for k, t in tensors.items()}


def loss_weights(cfg: Config) -> LossWeights:
    o = cfg.optim
    return LossWeights(**{f: float(o[f]) for f in LossWeights._fields})


def make_train_step(cfg: Config, meta: SceneMeta | None,
                    spatial_lr_scale: float, lpips_fn: Callable | None = None,
                    is_novel: bool = False,
                    active_sh_degree: int | None = None,
                    with_obj_acc: bool = False,
                    generator: torch.Generator | None = None,
                    batch_size: int = 1, mesh: Mesh | None = None
                    ) -> Callable:
    """The train step of one camera: ``step(state, camera, batch) ->
    StepOutput``, updating ``state`` in place. ``generator`` draws the
    actor flip mask (``model.gaussian.flip_prob``).

    ``batch_size`` B > 1 gives the camera-batched step (JAX's
    ``train_step_dp``): ``step(state, cameras, batches)`` with this rank's
    B / W cameras of uniform resolution (W = the mesh's data size, 1
    without a mesh). Each camera's loss is differentiated into ``.grad``
    (the flip masks of all B cameras are drawn from ``generator`` on every
    rank, in camera order, so a camera's mask does not depend on W); the
    gradient sums, the densification-stat sums (``contrib``,
    ``contrib_abs``, ``visf``) and the radius maxima (``rad``) are
    all-reduced over the ranks; the gradients and the scalars are divided
    by B (JAX's means); then one Adam update runs on every rank, on equal
    inputs, so the replicated pools stay bit-equal. A mesh with a
    ``frames`` axis F > 1 (JAX's ``make_train_step`` on ``{data,
    frames}``) replicates the cameras over it: the sums over every rank
    hold F copies of each camera's and are divided by F too (the reduction
    runs over every rank, so all of them get the same bits even where a
    kernel's atomics make the copies differ)."""
    weights = loss_weights(cfg)
    tile_size = int(cfg.render.tile_size)
    sh_degree = (active_sh_degree if active_sh_degree is not None
                 else cfg.model.gaussian.sh_degree)
    flip_prob = float(cfg.model.gaussian.flip_prob)

    def draw_flip(params: SceneParams, dev) -> torch.Tensor | None:
        _, A, cap_o = _sizes(params)
        if flip_prob > 0 and A > 0:
            return torch.rand((A, cap_o), generator=generator,
                              device=dev) < flip_prob
        return None

    def compute_grads(params: SceneParams, camera, batch: dict[str, Any],
                      flip_mask: torch.Tensor | None):
        """Loss and gradients (added to the leaves' .grad) of one camera,
        plus the densification-stat contributions."""
        nb, A, cap_o = _sizes(params)
        n_flat = nb + A * cap_o     # the sky pass has its own hooks
        dev = camera.device
        n_sky = params.sky.capacity if params.sky is not None else 0
        hooks = [torch.zeros((n, 2), dtype=torch.float32, device=dev,
                             requires_grad=True)
                 for n in (n_flat, n_flat, n_sky, n_sky)]
        kw = dict(frame_idx=batch["frame_idx"], frame=batch["frame"],
                  cam_id=batch["cam_id"], timestamp=batch.get("timestamp"),
                  sh_degree=sh_degree, tile_size=tile_size,
                  flip_mask=flip_mask)
        out = render_scene(
            params, meta, camera, image_idx=batch.get("image_idx", 0),
            viewspace_zero=hooks[0], absgrad_sink=hooks[1],
            viewspace_zero_sky=hooks[2], absgrad_sink_sky=hooks[3],
            white_background=bool(cfg.data.white_background), **kw)
        acc_obj = None
        if with_obj_acc and params.actors is not None:
            # objects-only pass for the acc-entropy regulariser; its alpha
            # does not depend on colour correction, so none is evaluated
            plain = dataclasses.replace(params, color_corr=None,
                                        color_mlp=None, color_mlp_sky=None)
            acc_obj = render_scene(plain, meta, camera, include_bkgd=False,
                                   include_sky=False, **kw)["acc"]
        cc_reg, cc_reg_sky = params.color_corr, params.color_corr_sky
        if cc_reg is None and "cc_mat" in out:
            # MLP mode: the regulariser holds the evaluated affine
            cc_reg = out["cc_mat"][None]
            cc_reg_sky = (out["cc_mat_sky"][None] if "cc_mat_sky" in out
                          else None)
        loss, scalars = compute_train_loss(
            out, batch, weights, is_novel=is_novel, lpips_fn=lpips_fn,
            scene_scaling=(params.bkgd.get_scaling()
                           if params.bkgd is not None else None),
            scene_valid=params.bkgd.valid if params.bkgd is not None else None,
            color_corr=cc_reg, color_corr_sky=cc_reg_sky, acc_obj=acc_obj)
        loss.backward()

        # gsplat's pixel-unit screen gradients -> the reference's
        # NDC-comparable scale
        scale = 0.5 * torch.tensor([camera.width, camera.height],
                                   dtype=torch.float32, device=dev)

        def hook_grad(t):
            return (t.grad if t.grad is not None
                    else torch.zeros_like(t)) * scale

        def contributions(vz, sink, vis, radii):
            visf = vis.to(torch.float32)
            return {"contrib": torch.linalg.norm(hook_grad(vz), dim=-1) * visf,
                    "contrib_abs": torch.linalg.norm(hook_grad(sink), dim=-1)
                    * visf,
                    "visf": visf,
                    "rad": torch.where(vis, radii.detach(), 0.0)}

        stats = {"fg": contributions(hooks[0], hooks[1],
                                     out["visibility"][:n_flat],
                                     out["radii"][:n_flat])}
        if params.sky is not None and "visibility_sky" in out:
            stats["sky"] = contributions(hooks[2], hooks[3],
                                         out["visibility_sky"],
                                         out["radii_sky"])
        return {k: v.detach() for k, v in scalars.items()}, stats

    @torch.no_grad()
    def apply_update(state: GSTrainState, stats) -> None:
        params = state.params
        nb, A, cap_o = _sizes(params)
        lrs = pool_lrs(cfg, state.step, spatial_lr_scale)
        fg = stats["fg"]
        if params.bkgd is not None:
            p = params.bkgd.trainable_dict()
            adam_update(p, _grads(p), state.adam_bkgd, lrs,
                        update_mask=params.bkgd.valid)
            accumulate_stats(state.dstate_bkgd,
                             *(fg[k][:nb] for k in
                               ("contrib", "contrib_abs", "visf", "rad")))
        if params.actors is not None:
            p = params.actors.trainable_dict()
            adam_update(p, _grads(p), state.adam_actors, lrs,
                        update_mask=params.actors.valid)
            accumulate_stats(state.dstate_actors,
                             *(fg[k][nb:].reshape(A, cap_o) for k in
                               ("contrib", "contrib_abs", "visf", "rad")))
        if params.sky is not None:
            p = params.sky.trainable_dict()
            adam_update(p, _grads(p), state.adam_sky, lrs,
                        update_mask=params.sky.valid)
            if "sky" in stats:
                accumulate_stats(state.dstate_sky,
                                 *(stats["sky"][k] for k in
                                   ("contrib", "contrib_abs", "visf", "rad")))
        misc = misc_params(params)
        if misc:
            adam_update(misc, _grads(misc), state.adam_misc,
                        misc_lrs(cfg, state.step, misc))
        state.step += 1

    def train_step(state: GSTrainState, camera, batch: dict[str, Any]
                   ) -> StepOutput:
        set_trainable(state.params)
        scalars, stats = compute_grads(
            state.params, camera, batch,
            draw_flip(state.params, camera.device))
        apply_update(state, stats)
        for t in trainable_leaves(state.params):
            t.grad = None
        return StepOutput(state, scalars)

    if batch_size <= 1:
        return train_step
    data = mesh.size("data") if mesh is not None else 1
    copies = mesh.size("frames") if mesh is not None else 1
    if batch_size % data:
        raise ValueError(f"train.batch_size {batch_size} does not split over "
                         f"{data} data ranks")
    mine = (mesh.local_slice(batch_size, "data") if mesh is not None
            else slice(0, batch_size))

    def train_step_dp(state: GSTrainState, cameras: list,
                      batches: list[dict[str, Any]]) -> StepOutput:
        if len(cameras) != len(batches) or \
                len(cameras) != batch_size // data:
            raise ValueError(f"{len(cameras)} cameras and {len(batches)} "
                             f"batches on this rank, expected "
                             f"{batch_size // data} each")
        if len({(c.width, c.height) for c in cameras}) > 1:
            raise ValueError("camera-batched training needs a uniform-"
                             "resolution batch")
        params = state.params
        set_trainable(params)
        masks = [draw_flip(params, cameras[0].device)
                 for _ in range(batch_size)][mine]
        sums: dict[str, torch.Tensor] = {}
        stats: dict[str, dict[str, torch.Tensor]] = {}
        for cam, batch, mask in zip(cameras, batches, masks):
            scalars, st = compute_grads(params, cam, batch, mask)
            for k, v in scalars.items():
                sums[k] = sums[k] + v if k in sums else v.clone()
            for part, contrib in st.items():
                acc = stats.setdefault(part, {})
                for k, v in contrib.items():
                    if k not in acc:
                        acc[k] = v.clone()
                    elif k.startswith("rad"):
                        acc[k] = torch.maximum(acc[k], v)
                    else:
                        acc[k] = acc[k] + v
        leaves = trainable_leaves(params)
        for t in leaves:
            if t.grad is None:      # a missing gradient counts as zero
                t.grad = torch.zeros_like(t)
        names = sorted(sums)
        flat_sums = [sums[k] for k in names]
        if mesh is not None:
            mesh.all_reduce_([t.grad for t in leaves] + flat_sums + [
                v for part in sorted(stats) for k, v in stats[part].items()
                if not k.startswith("rad")])
            mesh.all_reduce_([v for part in sorted(stats)
                              for k, v in stats[part].items()
                              if k.startswith("rad")], op="max")
            if copies > 1:
                for part in stats.values():
                    for k, v in part.items():
                        if not k.startswith("rad"):
                            v.div_(copies)
        for t in leaves:
            t.grad.div_(batch_size * copies)
        apply_update(state, stats)
        for t in leaves:
            t.grad = None
        return StepOutput(state, {k: v / (batch_size * copies)
                                  for k, v in zip(names, flat_sums)})

    return train_step_dp


def make_densify_step(cfg: Config) -> Callable:
    """``densify(state, generator, extent, actor_bbox, actor_random_init,
    sphere_center, sphere_radius) -> {pool: DensifyInfo}``, in place."""
    o = cfg.optim
    # the reference's densify_grad_abs_* = True selects the SIGNED column
    use_abs_bkgd = not bool(o.get("densify_grad_abs_bkgd", False))
    use_abs_obj = not bool(o.get("densify_grad_abs_obj", False))
    thresh_bkgd = float(o.get("densify_grad_threshold_bkgd")
                        or o.densify_grad_threshold)
    thresh_obj = float(o.get("densify_grad_threshold_obj")
                       or o.densify_grad_threshold)

    def noise(pool: GaussianPool, generator):
        shape = tuple(pool.valid.shape[:-1]) + (2, pool.capacity, 3)
        return torch.randn(shape, generator=generator, device=pool.device)

    def densify_step(state: GSTrainState, generator: torch.Generator,
                     extent: float, actor_bbox=None, actor_random_init=None,
                     sphere_center=None, sphere_radius=None) -> dict:
        params = state.params
        info = {}
        if params.bkgd is not None:
            info["bkgd"] = densify_and_prune(
                params.bkgd, state.adam_bkgd, state.dstate_bkgd,
                noise(params.bkgd, generator), grad_threshold=thresh_bkgd,
                percent_dense=o.percent_dense, extent=extent,
                min_opacity=o.min_opacity,
                prune_big_points=bool(o.prune_big_points),
                percent_big_ws=o.percent_big_ws,
                max_screen_size=o.max_screen_size, use_abs=use_abs_bkgd)
        if params.actors is not None:
            A = params.actors.xyz.shape[0]
            dev = params.actors.device
            rand_init = (actor_random_init if actor_random_init is not None
                         else torch.zeros(A, dtype=torch.bool, device=dev))
            bbox = (actor_bbox if actor_bbox is not None
                    else torch.full((A, 3), torch.inf, device=dev))
            # grid-initialised actors densify on absgrad and the base
            # threshold
            info["actors"] = densify_and_prune(
                params.actors, state.adam_actors, state.dstate_actors,
                noise(params.actors, generator),
                grad_threshold=torch.where(
                    rand_init, float(o.densify_grad_threshold), thresh_obj),
                percent_dense=o.percent_dense, extent=extent,
                min_opacity=o.min_opacity, bbox=bbox,
                use_abs=rand_init | use_abs_obj)
        if params.sky is not None and sphere_radius is not None:
            # own extent, pinned split origins, clamped scales, absgrad
            ext_sky = sky_extent(params.sky, sphere_radius, o.percent_dense)
            info["sky"] = densify_and_prune(
                params.sky, state.adam_sky, state.dstate_sky,
                noise(params.sky, generator),
                grad_threshold=o.densify_grad_threshold,
                percent_dense=o.percent_dense, extent=ext_sky,
                min_opacity=o.min_opacity,
                prune_big_points=bool(o.prune_big_points),
                percent_big_ws=o.percent_big_ws,
                max_screen_size=o.max_screen_size,
                pin_sphere=(sphere_center, sphere_radius), use_abs=True)
        return info

    return densify_step


def state_checksum(state: GSTrainState) -> torch.Tensor:
    """[n] int64: per pool and scene leaf, the sum of its words' int32
    views times their positions (mod 2^64): any bit that differs between
    two states changes it (but for collisions)."""
    leaves = list(misc_params(state.params).values())
    for name in POOLS:
        pool = getattr(state.params, name)
        if pool is not None:
            leaves += [getattr(pool, f) for f in
                       sorted(pool.__dataclass_fields__)]
    out = []
    for t in leaves:
        words = t.detach().contiguous().reshape(-1)
        if words.element_size() == 4:
            words = words.view(torch.int32)
        words = words.to(torch.int64)
        pos = torch.arange(1, words.numel() + 1, device=words.device)
        out.append((words * pos).sum())
    return torch.stack(out)


def check_replicated(state: GSTrainState, mesh: Mesh | None) -> None:
    """Raise when the replicated train state differs between the ranks
    (compares ``state_checksum`` of every rank)."""
    if mesh is None or mesh.world_size == 1:
        return
    sums = mesh.all_gather(state_checksum(state)[None], 0)
    bad = (sums != sums[:1]).any(1).nonzero().flatten().tolist()
    if bad:
        raise RuntimeError(f"the replicated GS state of rank(s) {bad} differs "
                           f"from rank 0's (step {state.step})")


def reset_opacity_step(state: GSTrainState) -> None:
    """Opacity reset of every pool, the sky included, in place."""
    for name in POOLS:
        pool = getattr(state.params, name)
        if pool is not None:
            reset_opacity(pool, getattr(state, f"adam_{name}"))
