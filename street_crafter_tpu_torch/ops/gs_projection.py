"""3D Gaussian -> 2D screen-space projection (EWA splatting), plain torch.

Port of ``street_crafter_tpu/ops/gs_projection.py::project_gaussians``:
quaternion+scale -> camera covariance, perspective Jacobian with the
1.3x tan-FoV clamp, 2D covariance with the 0.3-pixel low-pass (EPS2D),
antialiasing compensation sqrt(det_orig / det_blurred), conic,
radius = ceil(3 sqrt(lambda_max)) and the validity culls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import quaternion as Q

EPS2D = 0.3  # screen-space low-pass filter (same constant as INRIA/gsplat)


class Projection(NamedTuple):
    """Column layout: every field is [N]."""
    u: torch.Tensor
    v: torch.Tensor
    depths: torch.Tensor
    conic_a: torch.Tensor
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    radii: torch.Tensor          # 0 = culled
    compensations: torch.Tensor
    valid: torch.Tensor          # bool


def _covar_cam(quats: torch.Tensor, scales: torch.Tensor, Rcw: torch.Tensor):
    """Camera-frame covariance Rcw R S S^T R^T Rcw^T as six [N] columns."""
    q = Q.normalize(quats)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = [
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ]
    s2 = [scales[:, 0] ** 2, scales[:, 1] ** 2, scales[:, 2] ** 2]

    def world(i, k):   # world covariance entry, sum_j R[i,j] R[k,j] s_j^2
        return (r[3 * i] * r[3 * k] * s2[0]
                + r[3 * i + 1] * r[3 * k + 1] * s2[1]
                + r[3 * i + 2] * r[3 * k + 2] * s2[2])

    Sw = {(i, k): world(i, k) for i in range(3) for k in range(i, 3)}

    def cam(a, b):
        acc = 0.0
        for i in range(3):
            for j in range(3):
                acc = acc + Rcw[a, i] * Rcw[b, j] * Sw[min(i, j), max(i, j)]
        return acc

    return cam(0, 0), cam(0, 1), cam(0, 2), cam(1, 1), cam(1, 2), cam(2, 2)


def project_gaussians(
    means: torch.Tensor,       # [N, 3] world
    quats: torch.Tensor,       # [N, 4] wxyz
    scales: torch.Tensor,      # [N, 3] activated
    w2c: torch.Tensor,         # [4, 4]
    K: torch.Tensor,           # [3, 3]
    width: int,
    height: int,
    near_plane: float = 0.01,
    far_plane: float = 1e10,
    antialiasing: bool = True,
    mask: torch.Tensor | None = None,
    radius_clip: float = 0.0,
) -> Projection:
    f32 = torch.float32
    means = means.to(f32)
    Rcw = w2c[:3, :3].to(f32)
    tcw = w2c[:3, 3].to(f32)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    # camera-space means, in the reference's operation order so that
    # radius = ceil(...) lands on the same integer
    mx, my, mz = means[:, 0], means[:, 1], means[:, 2]
    x = Rcw[0, 0] * mx + Rcw[0, 1] * my + Rcw[0, 2] * mz + tcw[0]
    y = Rcw[1, 0] * mx + Rcw[1, 1] * my + Rcw[1, 2] * mz + tcw[1]
    z = Rcw[2, 0] * mx + Rcw[2, 1] * my + Rcw[2, 2] * mz + tcw[2]
    zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)

    c00, c01, c02, c11, c12, c22 = _covar_cam(quats.to(f32),
                                              scales.to(f32), Rcw)

    # frustum-clamped perspective Jacobian (INRIA: clamp x/z to 1.3 tan_fov)
    lim_x = 1.3 * (0.5 * width / fx)
    lim_y = 1.3 * (0.5 * height / fy)
    tx = torch.maximum(torch.minimum(x / zs, lim_x), -lim_x) * zs
    ty = torch.maximum(torch.minimum(y / zs, lim_y), -lim_y) * zs
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    # cov2d = J Sigma_c J^T (2x2 symmetric)
    sxx = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22)
    sxy = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    syy = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22)

    det_orig = sxx * syy - sxy * sxy
    bxx = sxx + EPS2D
    byy = syy + EPS2D
    det = bxx * byy - sxy * sxy
    det_safe = torch.where(det == 0.0, torch.full_like(det, 1e-10), det)
    if antialiasing:
        compensations = torch.sqrt(torch.clamp(det_orig / det_safe, min=0.0))
    else:
        compensations = torch.ones_like(det)
    inv_det = 1.0 / det_safe

    # screen extent: 3 sigma of the larger eigenvalue
    b = 0.5 * (bxx + byy)
    v1 = b + torch.sqrt(torch.clamp(b * b - det, min=0.01))
    radius = torch.ceil(3.0 * torch.sqrt(v1))

    u = fx * x * inv_z + cx
    v = fy * y * inv_z + cy

    valid = (z > near_plane) & (z < far_plane) & (det > 0.0)
    valid &= radius > radius_clip
    valid &= (u + radius > 0) & (u - radius < width)
    valid &= (v + radius > 0) & (v - radius < height)
    if mask is not None:
        valid &= mask

    zero = torch.zeros_like(radius)
    return Projection(
        u=u, v=v, depths=z,
        conic_a=byy * inv_det, conic_b=-sxy * inv_det, conic_c=bxx * inv_det,
        radii=torch.where(valid, radius, zero),
        compensations=torch.where(valid, compensations, zero),
        valid=valid,
    )
