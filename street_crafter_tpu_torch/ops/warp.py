"""Depth-reprojection warp of a source view into target views (port of
``street_crafter_tpu/ops/warp.py``; the ``virtual_warp`` guidance).

Pixels of a target view are back-projected with the target depth, moved
into the source camera and projected; the source image is sampled
bilinearly there. A pixel is kept only when it projects inside the source
frustum and passes the relative depth test |sampled source depth -
reprojected depth| < 0.1 * reprojected depth.

Conventions, as in the reference's warp: ``c2w`` matrices are
camera->world; the source is sampled at ``u * (W - 1) / W`` (its grid
normalisation ``u / W * 2 - 1`` under ``align_corners=True``), with the
border clamped. Per-pixel quantities are flat [H * W] columns; the four
bilinear taps are flat gathers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .maths import affine_inverse


class WarpResult(NamedTuple):
    rgb: torch.Tensor    # [B, H, W, 3] warped source rgb, 0 where invalid
    mask: torch.Tensor   # [B, H, W] bool: in the frustum and unoccluded
    depth: torch.Tensor  # [B, H, W] reprojected depth in the source camera


def _bilinear_border(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                     ) -> torch.Tensor:
    """img [H, W, C] at flat [P] pixel coordinates (integers hit pixel
    centres), the border clamped."""
    H, W = img.shape[:2]
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.clamp(x0i + 1, max=W - 1)
    y1i = torch.clamp(y0i + 1, max=H - 1)
    flat = img.reshape(H * W, -1)
    g00 = flat[y0i * W + x0i]
    g01 = flat[y0i * W + x1i]
    g10 = flat[y1i * W + x0i]
    g11 = flat[y1i * W + x1i]
    top = g00 * (1.0 - fx) + g01 * fx
    bot = g10 * (1.0 - fx) + g11 * fx
    return top * (1.0 - fy) + bot * fy


def virtual_warp_single(tar_K: torch.Tensor, tar_c2w: torch.Tensor,
                        tar_depth: torch.Tensor, src_K: torch.Tensor,
                        src_c2w: torch.Tensor, src_depth: torch.Tensor,
                        src_rgb: torch.Tensor, depth_thresh: float = 0.1
                        ) -> WarpResult:
    """Warp one source view into one target view: K [3, 3], c2w [4, 4],
    depth [H, W], rgb [H, W, 3]. The result has no batch dimension."""
    H, W = tar_depth.shape
    f32 = torch.float32
    dev = tar_depth.device
    v, u = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                          torch.arange(W, dtype=f32, device=dev),
                          indexing="ij")
    d = tar_depth.reshape(-1).to(f32)
    u = u.reshape(-1) * d
    v = v.reshape(-1) * d

    # target camera -> source camera
    rel = affine_inverse(src_c2w.to(f32)) @ tar_c2w.to(f32)
    Kinv = torch.linalg.inv(tar_K.to(f32))
    xc = Kinv[0, 0] * u + Kinv[0, 1] * v + Kinv[0, 2] * d
    yc = Kinv[1, 0] * u + Kinv[1, 1] * v + Kinv[1, 2] * d
    zc = Kinv[2, 0] * u + Kinv[2, 1] * v + Kinv[2, 2] * d
    R, t = rel[:3, :3], rel[:3, 3]
    xs = R[0, 0] * xc + R[0, 1] * yc + R[0, 2] * zc + t[0]
    ys = R[1, 0] * xc + R[1, 1] * yc + R[1, 2] * zc + t[1]
    zs = R[2, 0] * xc + R[2, 1] * yc + R[2, 2] * zc + t[2]

    Ks = src_K.to(f32)
    up = Ks[0, 0] * xs + Ks[0, 1] * ys + Ks[0, 2] * zs
    vp = Ks[1, 0] * xs + Ks[1, 1] * ys + Ks[1, 2] * zs
    wp = Ks[2, 0] * xs + Ks[2, 1] * ys + Ks[2, 2] * zs
    safe = torch.where(wp.abs() > 1e-12, wp, torch.full_like(wp, 1e-12))
    up = up / safe
    vp = vp / safe
    in_frustum = (zs > 0) & (up >= 0) & (up < W) & (vp >= 0) & (vp < H)

    # the reference's sampling position: u * (W - 1) / W
    sx = up * ((W - 1.0) / W)
    sy = vp * ((H - 1.0) / H)
    info = torch.cat([src_rgb.to(f32), src_depth[..., None].to(f32)], -1)
    sampled = _bilinear_border(info, sx, sy)
    unoccluded = (sampled[:, 3] - zs).abs() < depth_thresh * zs
    mask = in_frustum & unoccluded
    rgb = torch.where(mask[:, None], sampled[:, :3], 0.0)
    return WarpResult(rgb=rgb.reshape(H, W, 3), mask=mask.reshape(H, W),
                      depth=zs.reshape(H, W))


def virtual_warp_images(tar_K: torch.Tensor, tar_c2w: torch.Tensor,
                        tar_depth: torch.Tensor, src_K: torch.Tensor,
                        src_c2w: torch.Tensor, src_depth: torch.Tensor,
                        src_rgb: torch.Tensor, depth_thresh: float = 0.1
                        ) -> WarpResult:
    """The warp over a batch: every argument leads with [B]."""
    outs = [virtual_warp_single(*args, depth_thresh=depth_thresh)
            for args in zip(tar_K, tar_c2w, tar_depth, src_K, src_c2w,
                            src_depth, src_rgb)]
    return WarpResult(*(torch.stack(x) for x in zip(*outs)))


def process_depth(depth: torch.Tensor, acc: torch.Tensor,
                  sky_depth: float = 900.0) -> torch.Tensor:
    """Fill the pixels nothing covers (the sky) with a far plane."""
    return torch.clamp(depth, 0.0, sky_depth) + sky_depth * (1.0 - acc)
