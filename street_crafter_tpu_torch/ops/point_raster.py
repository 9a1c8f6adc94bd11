"""Point-cloud -> image splatting: the LiDAR condition renders (port of
``street_crafter_tpu/ops/point_raster.py``).

Two renders of a coloured point cloud, both in pixels:

- ``render_pointcloud_gaussian``, the condition render: every point is an
  isotropic 2D Gaussian (alpha = occ exp(-0.5 d^2 / sigma^2), the 0.999
  clamp, the 1/255 cutoff) composited front to back in depth order, the
  reference's ``diff_point_rasterization`` semantics. It goes through
  ``ops.gs_raster.rasterize_pixels`` with the channels (rgb, z), so on
  CUDA tensors it launches kernels A, the pack and B, on CPU tensors their
  plain versions. That raster is exact: no per-tile capacity, no
  approximate selection (the JAX package's XLA raster keeps at most 512
  splats a 16-px tile and 4,096 a coarse tile here);
- ``render_pointcloud`` / ``splat_points``, the nearest-hit z-buffer of
  hard disks: points sorted by (centre pixel, depth), each pixel keeping
  its ``layers`` nearest centres, then every pixel takes the nearest of the
  candidates of its (2R+1)^2 window whose disk covers it. The ``layers``
  cap is kept: a point ranked past it at its centre pixel is dropped, also
  where it would win a neighbouring pixel, as in the JAX package. No
  condition render calls it.

With ``use_ndc_scale`` the pixel radius (z-buffer) or sigma (Gaussian) is
the constant ``scale * 0.5 * min(H, W)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import maths
from .gs_raster import rasterize_pixels

_INF = 1e10


class PointRenderOutput(NamedTuple):
    rgb: torch.Tensor    # [H, W, 3]
    acc: torch.Tensor    # [H, W] coverage (z-buffer: 1 where hit)
    depth: torch.Tensor  # [H, W] camera-space depth, 0 where empty


def _project(points_cam: torch.Tensor, K: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(u, v, z) of camera-space points, z clamped to 1e-6 below for the
    division only."""
    x, y, z = (points_cam[:, i].contiguous() for i in range(3))
    zs = torch.clamp(z, min=1e-6)
    return K[0, 0] * x / zs + K[0, 2], K[1, 1] * y / zs + K[1, 2], z


@torch.no_grad()
def splat_points(points_cam: torch.Tensor, colors: torch.Tensor,
                 radii_px: torch.Tensor, K: torch.Tensor, H: int, W: int,
                 mask: torch.Tensor | None = None, znear: float = 0.2,
                 max_radius_px: int = 8, layers: int = 4
                 ) -> PointRenderOutput:
    """Nearest-hit splatting of [N, 3] camera-space points with [N, 3]
    colours and [N] pixel radii."""
    dev = points_cam.device
    f32 = torch.float32
    u, v, z = _project(points_cam.to(f32), K.to(f32))
    valid = z > znear
    if mask is not None:
        valid = valid & mask
    iu = torch.floor(torch.clamp(u, 0, W - 1)).to(torch.int64)
    iv = torch.floor(torch.clamp(v, 0, H - 1)).to(torch.int64)
    R = int(max_radius_px)
    valid = valid & (u >= -R) & (u < W + R) & (v >= -R) & (v < H + R)
    depth = torch.where(valid, z, torch.full_like(z, _INF))
    pix = torch.where(valid, iv * W + iu, torch.full_like(iv, H * W))

    # scatter: sort by (pixel, depth), stable; rank = hit order per pixel
    by_depth = torch.argsort(depth, stable=True)
    order = by_depth[torch.argsort(pix[by_depth], stable=True)]
    pix_s = pix[order]
    n = pix_s.shape[0]
    idx = torch.arange(n, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = pix_s[1:] != pix_s[:-1]
    seg_first = torch.cummax(torch.where(is_start, idx, -1), 0).values
    rank = idx - seg_first
    keep = (rank < layers) & (pix_s < H * W)
    layer = torch.where(keep, rank, layers)   # dropped hits: overflow layer
    attrs = torch.cat([
        depth[order, None], radii_px.to(f32)[order, None],
        (u - (iu.to(f32) + 0.5))[order, None],
        (v - (iv.to(f32) + 0.5))[order, None], colors.to(f32)[order]], -1)
    buf = torch.zeros((layers + 1, H * W + 1, 7), dtype=f32, device=dev)
    buf[..., 0] = _INF
    buf[layer, pix_s] = attrs
    # (depth, radius, du, dv, rgb) per layer and pixel, padded by R
    padded = torch.zeros((layers, H + 2 * R, W + 2 * R, 7), dtype=f32,
                         device=dev)
    padded[..., 0] = _INF
    padded[:, R:R + H, R:R + W] = buf[:layers, :H * W].reshape(layers, H, W,
                                                               7)

    # gather: the nearest covering candidate of each pixel's window, the
    # offsets in row-major order, a later offset winning only if nearer
    best_depth = torch.full((H, W), _INF, dtype=f32, device=dev)
    best_rgb = torch.zeros((H, W, 3), dtype=f32, device=dev)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            # the candidate stored at q covers p = q + (dy, dx)
            cand = padded[:, R - dy:R - dy + H, R - dx:R - dx + W]
            dist2 = (dx - cand[..., 2]) ** 2 + (dy - cand[..., 3]) ** 2
            covers = (dist2 <= cand[..., 1] ** 2) & (cand[..., 0] < _INF)
            depth_m = torch.where(covers, cand[..., 0],
                                  torch.full_like(dist2, _INF))
            d_best, l_best = torch.min(depth_m, 0)
            closer = d_best < best_depth
            best_depth = torch.where(closer, d_best, best_depth)
            rgb = torch.gather(cand[..., 4:], 0, l_best[None, ..., None]
                               .expand(1, H, W, 3))[0]
            best_rgb = torch.where(closer[..., None], rgb, best_rgb)

    hit = best_depth < _INF
    return PointRenderOutput(
        rgb=torch.where(hit[..., None], best_rgb, 0.0),
        acc=hit.to(f32), depth=torch.where(hit, best_depth, 0.0))


def ndc_radius_px(scale: float, H: int, W: int) -> float:
    """The constant pixel radius of the reference's use_ndc_scale mode:
    scale * 0.5 * min(H, W)."""
    return scale * 0.5 * min(H, W)


def _to_camera(c2w: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    return maths.transform_points(maths.affine_inverse(c2w.float()),
                                  points.float())


@torch.no_grad()
def render_pointcloud(c2w: torch.Tensor, K: torch.Tensor,
                      points: torch.Tensor, colors: torch.Tensor, H: int,
                      W: int, scale: float = 0.01,
                      use_ndc_scale: bool = True,
                      point_radii: torch.Tensor | None = None,
                      mask: torch.Tensor | None = None, znear: float = 0.2
                      ) -> PointRenderOutput:
    """The z-buffer render of [N, 3] world points with a [4, 4] c2w: disks
    of the ndc radius, or of world radius ``point_radii`` (``scale`` when
    None) projected and capped at 12 px."""
    pts_cam = _to_camera(c2w, points)
    z = torch.clamp(pts_cam[:, 2], min=1e-6)
    if use_ndc_scale:
        r_px = ndc_radius_px(scale, H, W)
        radii = torch.full_like(z, r_px)
        max_r = max(1, int(math.ceil(r_px)))
    else:
        world_r = point_radii if point_radii is not None else \
            torch.full_like(z, scale)
        max_r = 12
        radii = torch.clamp(K[0, 0] * world_r / z, max=max_r)
    return splat_points(pts_cam, colors, radii, K, H, W, mask=mask,
                        znear=znear, max_radius_px=max_r)


def gaussian_splats(c2w: torch.Tensor, K: torch.Tensor,
                    points: torch.Tensor, colors: torch.Tensor, H: int,
                    W: int, scale: float = 0.01, use_ndc_scale: bool = True,
                    occ: float = 1.0, mask: torch.Tensor | None = None,
                    znear: float = 0.2) -> dict:
    """The ``rasterize_pixels`` arguments of the condition render of [N, 3]
    world points: isotropic splats of pixel sigma ``scale * 0.5 * min(H,
    W)`` (``use_ndc_scale``, the reference's setting) or ``fx * scale /
    z``, radius 3 sigma, opacity ``occ``, channels (rgb, z), valid in front
    of ``znear`` (and ``mask``)."""
    f32 = torch.float32
    K = K.to(f32)
    u, v, z = _project(_to_camera(c2w, points), K)
    valid = z > znear
    if mask is not None:
        valid = valid & mask
    if use_ndc_scale:
        sigma = torch.full_like(z, ndc_radius_px(scale, H, W))
    else:
        sigma = K[0, 0] * scale / torch.clamp(z, min=1e-6)
    inv_s2 = 1.0 / torch.clamp(sigma * sigma, min=1e-12)
    return dict(u=u, v=v, conic_a=inv_s2, conic_b=torch.zeros_like(z),
                conic_c=inv_s2, colors=torch.cat([colors.to(f32), z[:, None]],
                                                 -1),
                opacities=torch.full_like(z, occ), depths=z, valid=valid,
                radii=3.0 * sigma, width=W, height=H)


@torch.no_grad()
def render_pointcloud_gaussian(c2w: torch.Tensor, K: torch.Tensor,
                               points: torch.Tensor, colors: torch.Tensor,
                               H: int, W: int, scale: float = 0.01,
                               use_ndc_scale: bool = True, occ: float = 1.0,
                               mask: torch.Tensor | None = None,
                               znear: float = 0.2) -> PointRenderOutput:
    """The condition render (``gaussian_splats`` composited): acc is the
    composited alpha (the condition mask), depth the alpha-weighted z over
    acc."""
    out = rasterize_pixels(**gaussian_splats(
        c2w, K, points, colors, H, W, scale, use_ndc_scale, occ, mask,
        znear))
    acc = out.alpha
    depth = out.colors[..., 3] / torch.clamp(acc, min=1e-10)
    return PointRenderOutput(rgb=out.colors[..., :3], acc=acc,
                             depth=torch.where(acc > 0, depth, 0.0))
