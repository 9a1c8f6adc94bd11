"""Differentiable cubemap texture lookup (port of
``street_crafter_tpu/ops/cubemap.py``).

The optimisable sky's bilinear cube-mode lookup and the cubemap -> latlong
export. Faces follow the GL cube map: 0:+x 1:-x 2:+y 3:-y 4:+z 5:-z. The
face choice breaks ties as the JAX package does (x wins ties with y and z,
y wins ties with z), and each face clamps its own edge texels: nothing is
filtered across faces.

The four taps are one gather of the flat ``[6 * R * R, C]`` view at
``(face * R + iy) * R + ix``; its backward is torch's accumulating scatter
(``index_add_``) into the texture.
"""

from __future__ import annotations

import math

import torch


def _face_uv(dirs: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., 3] directions (need not be unit) -> (face, u, v), u, v in
    [0, 1]."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)       # the rest is z major

    def pick(on_x, on_y, on_z):
        return torch.where(is_x, on_x, torch.where(is_y, on_y, on_z))

    face = pick(torch.where(x > 0, 0, 1), torch.where(y > 0, 2, 3),
                torch.where(z > 0, 4, 5))
    ma = torch.clamp(pick(ax, ay, az), min=1e-12)
    # GL cube map face (s, t) conventions
    sc = pick(torch.where(x > 0, -z, z), x, torch.where(z > 0, x, -x))
    tc = pick(-y, torch.where(y > 0, z, -z), -y)
    u = 0.5 * (sc / ma + 1.0)
    v = 0.5 * (tc / ma + 1.0)
    return face, u, v


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear cubemap lookup: cubemap [6, R, R, C], dirs [..., 3] ->
    [..., C]."""
    face, u, v = _face_uv(dirs)
    R, C = cubemap.shape[1], cubemap.shape[-1]
    fu = u * R - 0.5
    fv = v * R - 0.5
    x0 = torch.floor(fu)
    y0 = torch.floor(fv)
    wx = (fu - x0)[..., None]
    wy = (fv - y0)[..., None]
    base = face.to(torch.int64) * R

    def index(ix, iy):
        ix = torch.clamp(ix.to(torch.int64), 0, R - 1)
        iy = torch.clamp(iy.to(torch.int64), 0, R - 1)
        return ((base + iy) * R + ix).reshape(-1)

    idx = torch.stack([index(x0, y0), index(x0 + 1, y0),
                       index(x0, y0 + 1), index(x0 + 1, y0 + 1)])
    taps = torch.index_select(cubemap.reshape(-1, C), 0, idx.reshape(-1))
    c00, c10, c01, c11 = taps.reshape((4,) + u.shape + (C,)).unbind(0)
    return ((1 - wx) * (1 - wy) * c00 + wx * (1 - wy) * c10
            + (1 - wx) * wy * c01 + wx * wy * c11)


def latlong_from_cubemap(cubemap: torch.Tensor, H: int, W: int
                         ) -> torch.Tensor:
    """Equirectangular [H, W, C] export of the cubemap."""
    dev = cubemap.device
    gy, gx = torch.meshgrid(
        (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H,
        (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W,
        indexing="ij")
    theta = (gy - 0.5) * math.pi          # [-pi/2, pi/2]
    phi = (gx - 0.5) * 2 * math.pi        # [-pi, pi]
    dirs = torch.stack([torch.cos(theta) * torch.sin(phi), torch.sin(theta),
                        torch.cos(theta) * torch.cos(phi)], -1)
    return sample_cubemap(cubemap, dirs)
