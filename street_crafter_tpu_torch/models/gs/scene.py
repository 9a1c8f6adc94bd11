"""Dynamic street scene graph (port of ``street_crafter_tpu/models/gs/scene.py``).

- ``bkgd``: one Gaussian pool in world frame;
- ``actors``: a stacked pool [A, cap_obj, ...] in per-object canonical
  frames, posed by a tracklet table [cams, frames, A] (quaternion + trans,
  with optional learnable residuals);
- ``sky``: a Gaussian pool, or ``sky_cubemap``, an optimisable cubemap
  texture in its place;
- colour corrections (per-image affines or the pose-conditioned MLP) and
  pose corrections.

``flatten_scene`` produces one flat Gaussian soup for the rasterizer; actor
visibility per camera and frame is a validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ...ops import quaternion as Q
from ...ops.sh import idft_basis
from .params import GaussianPool

# flip across canonical y-axis: diag(-1, 1, -1)
FLIP_AXIS = 1
FLIP_QUAT = (0.0, 0.0, 1.0, 0.0)  # wxyz of diag(-1, 1, -1)


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """Trainable leaves of the scene."""
    bkgd: GaussianPool | None
    actors: GaussianPool | None          # stacked [A, cap_obj, ...]
    sky: GaussianPool | None
    opt_trans: torch.Tensor | None       # [C, F, A, 3] tracklet residual
    opt_theta: torch.Tensor | None       # [C, F, A, 1] yaw residual
    sky_cubemap: torch.Tensor | None     # [6, R, R, 3] texture
    color_corr: torch.Tensor | None      # [M, 3, 4] affine per image/sensor
    color_corr_sky: torch.Tensor | None  # [M, 3, 4]
    pose_corr_quat: torch.Tensor | None  # [M, 4]
    pose_corr_trans: torch.Tensor | None  # [M, 3]
    color_mlp: dict | None = None        # pose-conditioned MLP {w0, b0, ..}
    color_mlp_sky: dict | None = None


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Non-trainable scene arrays (tracklets, timing, actor info)."""
    track_trans: torch.Tensor     # [C, F, A, 3]
    track_quats: torch.Tensor     # [C, F, A, 4] wxyz
    track_valid: torch.Tensor     # [C, F, A] bool
    timestamps: torch.Tensor      # [C, F]
    actor_frame_range: torch.Tensor  # [A, 2] (start, end) frame
    actor_bbox: torch.Tensor | None = None        # [A, 3]
    actor_random_init: torch.Tensor | None = None  # [A] bool
    sphere_center: torch.Tensor | None = None     # [3] LiDAR scene sphere
    sphere_radius: torch.Tensor | None = None     # scalar
    fourier_scale: float = 1.0

    @property
    def num_frames(self) -> int:
        return self.track_trans.shape[1]


class FlatGaussians(NamedTuple):
    """One soup of world-space gaussians ready for projection."""
    xyz: torch.Tensor       # [N, 3]
    rotation: torch.Tensor  # [N, 4] normalized wxyz
    scaling: torch.Tensor   # [N, 3] activated
    opacity: torch.Tensor   # [N]
    shs: torch.Tensor       # [N, K, 3]
    valid: torch.Tensor     # [N] bool


def actor_pose(params: SceneParams, meta: SceneMeta, cam: int, frame_idx: int,
               timestamp=None, interpolate: bool = False,
               use_residual: bool = True
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tracked pose of every actor at (cam, frame): ([A,4], [A,3], [A]
    valid), with the optional residuals and the timestamp slerp between
    neighbour frames."""
    def pose_at(f):
        trans = meta.track_trans[cam, f]
        quats = meta.track_quats[cam, f]
        if use_residual and params.opt_trans is not None:
            trans = trans + params.opt_trans[cam, f]
            theta = params.opt_theta[cam, f, :, 0]   # yaw about object z
            zero = torch.zeros_like(theta)
            dq = torch.stack([torch.cos(theta / 2), zero, zero,
                              torch.sin(theta / 2)], -1)
            quats = Q.multiply(quats, dq)
        return quats, trans

    quats, trans = pose_at(frame_idx)
    valid = meta.track_valid[cam, frame_idx]

    if interpolate and timestamp is not None:
        F = meta.num_frames
        f0 = min(max(frame_idx - 1, 0), F - 1)
        f1 = min(max(frame_idx + 1, 0), F - 1)
        q0, t0 = pose_at(f0)
        q1, t1 = pose_at(f1)
        ts0 = meta.timestamps[cam, f0]
        ts1 = meta.timestamps[cam, f1]
        ts = torch.as_tensor(timestamp, dtype=torch.float32,
                             device=ts0.device)
        span = torch.where(ts1 == ts0, torch.ones_like(ts0), ts1 - ts0)
        alpha = (ts - ts0) / span
        can = (meta.track_valid[cam, f0] & meta.track_valid[cam, f1]
               & (0 < frame_idx < F - 1))
        trans_i = alpha * t1 + (1 - alpha) * t0
        quats_i = Q.slerp(q0, q1, alpha.expand(q0.shape[:-1]))
        trans = torch.where(can[:, None], trans_i, trans)
        quats = torch.where(can[:, None], quats_i, quats)
    return quats, trans, valid


def actor_time(meta: SceneMeta, frame) -> torch.Tensor:
    """Per-actor normalized Fourier time."""
    start = meta.actor_frame_range[:, 0]
    end = meta.actor_frame_range[:, 1]
    span = torch.clamp(end - start, min=1.0)
    return meta.fourier_scale * (frame - start) / span


def sky_pin(xyz: torch.Tensor, scaling: torch.Tensor, meta: SceneMeta | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sky-pool specialization: positions closer to the LiDAR sphere centre
    than 2x its radius are pushed out onto the 2r sphere; scales are clamped
    at the sphere radius. No-op without a sphere."""
    if meta is None or meta.sphere_center is None:
        return xyz, scaling
    rel = xyz - meta.sphere_center
    dist = torch.linalg.norm(rel, dim=-1, keepdim=True)
    ratio = dist / (2.0 * meta.sphere_radius)
    pinned = meta.sphere_center + rel / torch.clamp(ratio, min=1e-12)
    xyz = torch.where(ratio < 1.0, pinned, xyz)
    return xyz, torch.minimum(scaling, meta.sphere_radius)


def flatten_scene(params: SceneParams, meta: SceneMeta | None, cam: int,
                  frame_idx: int, frame: float, timestamp=None,
                  include_bkgd: bool = True, include_obj: bool = True,
                  include_sky: bool = True, interpolate: bool = False,
                  use_residual: bool = True,
                  flip_mask: torch.Tensor | None = None) -> FlatGaussians:
    parts: list[tuple] = []

    if include_bkgd and params.bkgd is not None:
        p = params.bkgd
        parts.append((p.xyz, p.get_rotation(), p.get_scaling(),
                      p.get_opacity()[:, 0], p.get_features(), p.valid))

    if include_obj and params.actors is not None and meta is not None:
        a = params.actors  # stacked [A, cap, ...]
        A, cap = a.xyz.shape[0], a.xyz.shape[1]
        quats_w, trans_w, pose_valid = actor_pose(
            params, meta, cam, frame_idx, timestamp, interpolate,
            use_residual)
        times = actor_time(meta, torch.as_tensor(
            frame, dtype=torch.float32, device=a.device))      # [A]

        xyz_local = a.xyz
        rot_local = a.get_rotation()
        if flip_mask is not None:
            flipped_xyz = xyz_local.clone()
            flipped_xyz[..., FLIP_AXIS] *= -1.0
            xyz_local = torch.where(flip_mask[..., None], flipped_xyz,
                                    xyz_local)
            flip_q = torch.tensor(FLIP_QUAT, dtype=torch.float32,
                                  device=a.device)
            rot_local = torch.where(flip_mask[..., None],
                                    Q.multiply(flip_q, rot_local), rot_local)

        xyz_w = Q.rotate(quats_w[:, None, :], xyz_local) + trans_w[:, None, :]
        rot_w = Q.normalize(Q.multiply(quats_w[:, None, :], rot_local))

        F = a.features_dc.shape[2]
        if F == 1:
            dc = a.features_dc
        else:   # Fourier time-varying DC per actor
            basis = idft_basis(times, F)                         # [A, F]
            dc = torch.einsum("anfc,af->anc", a.features_dc, basis)[:, :, None]
        shs = torch.cat([dc, a.features_rest], dim=2)

        valid = a.valid & pose_valid[:, None]
        parts.append((xyz_w.reshape(A * cap, 3), rot_w.reshape(A * cap, 4),
                      a.get_scaling().reshape(A * cap, 3),
                      a.get_opacity().reshape(A * cap),
                      shs.reshape(A * cap, -1, 3), valid.reshape(A * cap)))

    if include_sky and params.sky is not None:
        p = params.sky
        xyz, scaling = sky_pin(p.xyz, p.get_scaling(), meta)
        parts.append((xyz, p.get_rotation(), scaling, p.get_opacity()[:, 0],
                      p.get_features(), p.valid))

    if not parts:
        raise ValueError("flatten_scene: nothing to render")

    # pad SH K to the max across parts
    kmax = max(part[4].shape[1] for part in parts)
    parts = [part[:4] + (torch.nn.functional.pad(
        part[4], (0, 0, 0, kmax - part[4].shape[1])),) + part[5:]
        for part in parts]
    return FlatGaussians(*(torch.cat([part[i] for part in parts])
                           for i in range(6)))
