"""Scene renderer: projection + SH + rasterization + sky/colour composition
(port of ``street_crafter_tpu/models/gs/renderer.py``).

- the foreground pass renders background + actors; a Gaussian sky is
  rendered in its own pass and blended behind: rgb += sky * (1 - acc);
  a cubemap sky is looked up along each pixel's ray and blended behind
  with acc detached, so the sky does not pull the foreground's alpha;
- depth rides as a fourth colour channel and is normalized by alpha;
- one raster path (``ops.gs_raster``): exact, never drops a splat; the
  hand-written CUDA kernels for CUDA tensors, plain torch for CPU tensors;
- colour correction: a per-image (or per-camera) [3, 4] affine, or the
  pose-conditioned MLP's affine of the camera (``cc_mat``, and
  ``cc_mat_sky`` of the sky's MLP, returned for the regulariser);
- differentiable end to end. The densification hooks are explicit inputs,
  as in the JAX package: ``viewspace_zero`` [N, 2] zeros added to the
  screen positions (u + viewspace_zero[:, 0]), whose gradient is
  dL/d(u, v), and ``absgrad_sink`` [N, 2] zeros, whose gradient is the
  per-splat sum of |dL/du|, |dL/dv| over pixels; ``*_sky`` for the sky pass.
"""

from __future__ import annotations

from typing import Any

import torch

from ...ops import quaternion as Q
from ...ops import sh as SH
from ...ops.cubemap import sample_cubemap
from ...ops.gs_projection import Projection, project_gaussians
from ...ops.gs_raster import rasterize_pixels
from ...ops.maths import get_rays, world_to_view
from .color_mlp import apply_color_mlp
from .scene import FlatGaussians, SceneMeta, SceneParams, flatten_scene


def raster_inputs(flat: FlatGaussians, w2c: torch.Tensor, K: torch.Tensor,
                  cam_center: torch.Tensor, width: int, height: int,
                  sh_degree: int = 3, antialiasing: bool = True,
                  scaling_modifier: float = 1.0, near_plane: float = 0.01,
                  far_plane: float = 1e8) -> tuple[Projection, dict]:
    """Projection plus the keyword arguments of ``rasterize_pixels``:
    SH colours max(c + 0.5, 0) with depth as a fourth channel, opacities
    times the antialiasing compensation."""
    proj = project_gaussians(
        flat.xyz, flat.rotation, flat.scaling * scaling_modifier, w2c, K,
        width, height, near_plane=near_plane, far_plane=far_plane,
        antialiasing=antialiasing, mask=flat.valid)
    # SH colours in world frame, directions from the camera centre
    dirs = flat.xyz - cam_center
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-12)
    colors = SH.eval_sh(sh_degree, flat.shs.transpose(-1, -2), dirs)
    colors = torch.clamp(colors + 0.5, min=0.0)
    return proj, dict(
        u=proj.u, v=proj.v, conic_a=proj.conic_a, conic_b=proj.conic_b,
        conic_c=proj.conic_c,
        colors=torch.cat([colors, proj.depths[:, None]], -1).contiguous(),
        opacities=(flat.opacity * proj.compensations).contiguous(),
        depths=proj.depths, valid=proj.valid, radii=proj.radii,
        width=width, height=height)


def render_flat(flat: FlatGaussians, w2c: torch.Tensor, K: torch.Tensor,
                cam_center: torch.Tensor, width: int, height: int,
                sh_degree: int = 3, tile_size: int = 16,
                antialiasing: bool = True, scaling_modifier: float = 1.0,
                near_plane: float = 0.01, far_plane: float = 1e8,
                viewspace_zero: torch.Tensor | None = None,
                absgrad_sink: torch.Tensor | None = None,
                extra_channels: torch.Tensor | None = None
                ) -> dict[str, Any]:
    """Render a flat gaussian soup. Returns rgb [H,W,3], acc, depth, radii,
    visibility and n_pairs (the (tile, splat) pairs composited).
    ``extra_channels`` [N, K] (e.g. semantic logits,
    street_gaussian_renderer.py:195-200) are composited after rgb and depth
    in the same pass and returned under "semantic", un-normalised (the
    depth's convention before its division by alpha); 4 + K is at most
    ``ops.gs_raster.MAX_CHANNELS``."""
    proj, args = raster_inputs(flat, w2c, K, cam_center, width, height,
                               sh_degree, antialiasing, scaling_modifier,
                               near_plane, far_plane)
    if extra_channels is not None:
        args["colors"] = torch.cat(
            [args["colors"], extra_channels.to(args["colors"].dtype)],
            -1).contiguous()
    if viewspace_zero is not None:
        # densification hook: d loss / d viewspace_zero = d loss / d (u, v)
        args["u"] = args["u"] + viewspace_zero[:, 0]
        args["v"] = args["v"] + viewspace_zero[:, 1]
    out = rasterize_pixels(**args, tile_size=tile_size,
                           absgrad_sink=absgrad_sink)
    result = {
        "rgb": out.colors[..., :3],
        "acc": out.alpha,
        "depth": out.colors[..., 3] / torch.clamp(out.alpha, min=1e-10),
        "radii": proj.radii / float(max(height, width)),
        "visibility": proj.valid & (proj.radii > 0),
        "n_pairs": out.n_pairs,
    }
    if extra_channels is not None:
        result["semantic"] = out.colors[..., 4:]
    return result


def render_scene(
    params: SceneParams,
    meta: SceneMeta | None,
    camera: Any,                 # datasets.cameras.Camera
    frame_idx: int = 0,
    frame: float = 0.0,
    cam_id: int = 0,
    timestamp=None,
    image_idx: int = 0,          # colour/pose-correction table index
    include_bkgd: bool = True,
    include_obj: bool = True,
    include_sky: bool = True,
    sh_degree: int = 3,
    tile_size: int = 16,
    antialiasing: bool = True,
    interpolate_pose: bool = False,
    use_track_residual: bool = True,
    flip_mask: torch.Tensor | None = None,
    viewspace_zero: torch.Tensor | None = None,
    absgrad_sink: torch.Tensor | None = None,
    viewspace_zero_sky: torch.Tensor | None = None,
    absgrad_sink_sky: torch.Tensor | None = None,
    clamp: bool = False,
    white_background: bool = False,
) -> dict[str, Any]:
    """Full composition: foreground -> sky blend -> colour correction."""
    w2c = camera.w2c
    K = camera.K
    if params.pose_corr_quat is not None:
        dq = Q.normalize(params.pose_corr_quat[image_idx])
        corr = world_to_view(Q.to_matrix(dq), params.pose_corr_trans[image_idx])
        w2c = corr @ w2c
    cam_center = -(w2c[:3, :3].T @ w2c[:3, 3])

    # the foreground pass excludes the sky, which is blended behind it
    flat = flatten_scene(
        params, meta, cam_id, frame_idx, frame, timestamp,
        include_bkgd=include_bkgd, include_obj=include_obj, include_sky=False,
        interpolate=interpolate_pose, use_residual=use_track_residual,
        flip_mask=flip_mask)
    result = render_flat(flat, w2c, K, cam_center, camera.width,
                         camera.height, sh_degree=sh_degree,
                         tile_size=tile_size, antialiasing=antialiasing,
                         viewspace_zero=viewspace_zero,
                         absgrad_sink=absgrad_sink)

    if include_sky and params.sky is not None:
        sky_flat = flatten_scene(params, meta, cam_id, frame_idx, frame,
                                 timestamp, include_bkgd=False,
                                 include_obj=False, include_sky=True)
        sky = render_flat(sky_flat, w2c, K, cam_center, camera.width,
                          camera.height, sh_degree=sh_degree,
                          tile_size=tile_size, antialiasing=antialiasing,
                          viewspace_zero=viewspace_zero_sky,
                          absgrad_sink=absgrad_sink_sky)
        result["rgb"] = result["rgb"] + sky["rgb"] * (1.0 - result["acc"][..., None])
        result["acc_sky"] = sky["acc"]
        result["radii_sky"] = sky["radii"]
        result["visibility_sky"] = sky["visibility"]
        result["n_pairs"] += sky["n_pairs"]
    elif include_sky and params.sky_cubemap is not None:
        c2w = torch.eye(4, device=w2c.device)
        c2w[:3, :3] = w2c[:3, :3].T
        c2w[:3, 3] = cam_center
        _, dirs = get_rays(K, c2w, camera.height, camera.width)
        sky_rgb = sample_cubemap(params.sky_cubemap, dirs)
        acc = result["acc"].detach()[..., None]
        result["rgb"] = result["rgb"] + sky_rgb * (1.0 - acc)
        result["sky_rgb"] = sky_rgb
    elif white_background:
        result["rgb"] = result["rgb"] + (1.0 - result["acc"][..., None])

    if params.color_corr is not None:
        cc = params.color_corr[image_idx]  # [3, 4]
        result["rgb"] = (torch.einsum("hwc,dc->hwd", result["rgb"], cc[:, :3])
                         + cc[:, 3])
    elif params.color_mlp is not None:
        cc = apply_color_mlp(params.color_mlp, w2c)
        result["rgb"] = (torch.einsum("hwc,dc->hwd", result["rgb"], cc[:, :3])
                         + cc[:, 3])
        result["cc_mat"] = cc
        if params.color_mlp_sky is not None:
            result["cc_mat_sky"] = apply_color_mlp(params.color_mlp_sky, w2c)
    if clamp:
        result["rgb"] = torch.clamp(result["rgb"], 0.0, 1.0)
    return result
