"""Transform / camera math helpers (port of ``street_crafter_tpu/ops/maths.py``).

World-view and OpenGL-style projection matrices built from intrinsics K, rays,
sphere intersection. Column-vector convention: x_cam = R @ x_world + T.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def world_to_view(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """4x4 world->camera from the w2c rotation R and translation T."""
    m = torch.eye(4, dtype=torch.float32, device=R.device)
    m[:3, :3] = R
    m[:3, 3] = T
    return m


def projection_from_K(K: torch.Tensor, H: int, W: int,
                      znear: float = 0.01, zfar: float = 100.0) -> torch.Tensor:
    """OpenGL-style (z in [0,1]) projection from pixel intrinsics
    (getProjectionMatrixK)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    s = K[0, 1]
    P = torch.zeros((4, 4), dtype=torch.float32, device=K.device)
    P[0, 0] = 2 * fx / W
    P[0, 1] = 2 * s / W
    P[0, 2] = -1 + 2 * (cx / W)
    P[1, 1] = 2 * fy / H
    P[1, 2] = -1 + 2 * (cy / H)
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -2 * zfar * znear / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov_from_K(K: np.ndarray, H: int, W: int) -> tuple[float, float]:
    """(FoVx, FoVy) from pixel intrinsics."""
    K = np.asarray(K)
    return (float(2 * np.arctan(W / (2 * K[0, 0]))),
            float(2 * np.arctan(H / (2 * K[1, 1]))))


def affine_inverse(m: torch.Tensor) -> torch.Tensor:
    """Invert a [...,4,4] rigid transform with orthonormal rotation."""
    R = m[..., :3, :3]
    t = m[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ t], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype,
                          device=m.device).expand(m.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a [4,4] (or batched) transform to [..., 3] points."""
    return pts @ m[..., :3, :3].transpose(-1, -2) + m[..., :3, 3]


def project_points(K: torch.Tensor, w2c: torch.Tensor, pts: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """World points -> (pixel uv [...,2], camera-space depth [...])."""
    cam = transform_points(w2c, pts)
    depth = cam[..., 2]
    uv = (cam[..., :2] / torch.clamp(depth[..., None].abs(), min=1e-8)
          * torch.sign(depth[..., None]))
    u = K[0, 0] * uv[..., 0] + K[0, 1] * uv[..., 1] + K[0, 2]
    v = K[1, 1] * uv[..., 1] + K[1, 2]
    return torch.stack([u, v], -1), depth


def get_rays(K: torch.Tensor, c2w: torch.Tensor, H: int, W: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world-space rays: (origins [H,W,3], dirs [H,W,3])."""
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=K.device),
        torch.arange(W, dtype=torch.float32, device=K.device), indexing="ij")
    x = (i + 0.5 - K[0, 2]) / K[0, 0]
    y = (j + 0.5 - K[1, 2]) / K[1, 1]
    dirs_cam = torch.stack([x, y, torch.ones_like(x)], -1)
    dirs = dirs_cam @ c2w[:3, :3].T
    origins = c2w[:3, 3].expand(dirs.shape)
    return origins, dirs


def ray_sphere_intersection(origins: torch.Tensor, dirs: torch.Tensor,
                            center: torch.Tensor, radius: float) -> torch.Tensor:
    """Far intersection distance t of rays with a sphere (origins inside)."""
    d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    oc = origins - center
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius ** 2
    disc = torch.clamp(b * b - c, min=0.0)
    return -b + torch.sqrt(disc)


def expon_lr(step: int, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1000000) -> float:
    """Log-linear LR interpolation with optional delayed warmup (the 3DGS
    position LR schedule)."""
    step = float(step)
    if lr_init <= 0.0 and lr_final <= 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    log_lerp = math.exp(math.log(max(lr_init, 1e-12)) * (1 - t)
                        + math.log(max(lr_final, 1e-12)) * t)
    return delay_rate * log_lerp
