"""Quaternion algebra, wxyz convention (port of
``street_crafter_tpu/ops/quaternion.py``). Batched over leading dims."""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] wxyz -> [..., 3, 3] rotation matrix (normalizes first)."""
    q = normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] wxyz, branch-free Shepperd method."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    def _sqrtp(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    q_abs = torch.stack([
        _sqrtp(1.0 + m00 + m11 + m22),
        _sqrtp(1.0 + m00 - m11 - m22),
        _sqrtp(1.0 - m00 + m11 - m22),
        _sqrtp(1.0 - m00 - m11 + m22),
    ], -1)
    quat_by_w = torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20,
                             m10 - m01], -1)
    quat_by_x = torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01,
                             m02 + m20], -1)
    quat_by_y = torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2,
                             m12 + m21], -1)
    quat_by_z = torch.stack([m10 - m01, m20 + m02, m21 + m12,
                             q_abs[..., 3] ** 2], -1)
    cands = torch.stack([quat_by_w, quat_by_x, quat_by_y, quat_by_z], -2)
    denom = 2.0 * torch.clamp(q_abs, min=0.1 * torch.finfo(m.dtype).eps)
    cands = cands / denom[..., None]
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return normalize(torch.gather(cands, -2, idx)[..., 0, :])


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both [..., 4] wxyz."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def invert(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (conjugate)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation; lerp where the angle is ~0."""
    q0 = normalize(q0)
    q1 = normalize(q1)
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0.0, -q1, q1)
    dot = torch.clamp(dot.abs(), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    use_lerp = sin_theta < 1e-6
    safe = torch.clamp(sin_theta, min=1e-12)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(use_lerp, t, torch.sin(t * theta) / safe)
    return normalize(w0 * q0 + w1 * q1)


def from_axis_angle(axis_angle: torch.Tensor) -> torch.Tensor:
    """SO(3) exp map: [..., 3] rotation vector -> [..., 4] wxyz."""
    angle = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-6
    factor = torch.where(small, 0.5 + angle ** 2 / 48.0,
                         torch.sin(half) / torch.clamp(angle, min=1e-12))
    return torch.cat([torch.cos(half), axis_angle * factor], dim=-1)


def to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """SO(3) log map: [..., 4] wxyz -> [..., 3] rotation vector."""
    q = normalize(q)
    norms = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    angle = 2.0 * half
    small = angle.abs() < 1e-6
    factor = torch.where(small, 2.0 + angle ** 2 / 12.0,
                         angle / torch.clamp(norms, min=1e-12))
    return q[..., 1:] * factor
