"""Waymo range-image math on a torch device (port of
``street_crafter_tpu/data_processor/range_images.py``; the reference's
waymo_get_lidar_pcd.py:44-360).

Polar range images -> cartesian vehicle-frame points, per-camera
colorization (the first camera that covers a point wins, FRONT first), the
scatter-min sparse depth map and the in-box actor test, plus
``lidar_frame``: the whole per-frame LiDAR step of the Waymo converter
(``waymo_converter._convert_lidar``) on plain arrays.

Everything runs in float64 on ``device`` (the angles too), as the JAX
package's numpy does. Inputs may be numpy arrays or tensors; outputs are
tensors on ``device``. The sparse depth map is a ``scatter_reduce`` with
``amin`` (the JAX package's ``np.minimum.at``): a min does not depend on
the order of the writes, so the map is the same on every device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DUMMY_DISTANCE_VALUE = 2e3  # marker for missing returns (reference :41)

F64 = torch.float64


def _t(x, device) -> torch.Tensor:
    """A numpy array or tensor as float64 on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F64)
    return torch.as_tensor(np.asarray(x), dtype=F64, device=device)


def _np64(x) -> np.ndarray:
    """A small host-side matrix (numpy or tensor) as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def transform_points(points: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``points @ m[:3, :3].T + m[:3, 3]``, written out per coordinate
    (the same roundings on every device)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack([m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]
                        for i in range(3)], -1)


def range_image_to_cartesian(range_image, inclinations, extrinsic,
                             pixel_pose=None, frame_pose_inv=None,
                             device: str | torch.device = "cuda"
                             ) -> torch.Tensor:
    """Polar -> cartesian (WOD convention).

    range_image: [H, W] ranges; inclinations: [H] beam angles (top row
    first); extrinsic: [4, 4] sensor->vehicle. pixel_pose: optional
    [H, W, 4, 4] world_from_vehicle per pixel (top LiDAR rolling shutter);
    frame_pose_inv: [4, 4] vehicle_from_world of the frame. Returns
    [H, W, 3] vehicle-frame points.
    """
    r = _t(range_image, device)
    incl = _t(inclinations, device)
    ext = _t(extrinsic, device)
    H, W = r.shape
    # azimuth spans [pi, -pi) across columns, corrected by the sensor yaw
    az_correction = torch.atan2(ext[1, 0], ext[0, 0])
    ratios = (torch.arange(W, dtype=F64, device=r.device) + 0.5) / W
    azimuth = (1.0 - 2.0 * ratios) * torch.pi - az_correction
    cos_az, sin_az = torch.cos(azimuth)[None, :], torch.sin(azimuth)[None, :]
    cos_incl = torch.cos(incl)[:, None]
    sin_incl = torch.sin(incl)[:, None]
    pts_sensor = torch.stack([cos_az * cos_incl * r, sin_az * cos_incl * r,
                              sin_incl * r], -1)
    pts = transform_points(pts_sensor, ext)
    if pixel_pose is not None:
        assert frame_pose_inv is not None
        # to world via the per-pixel pose, back to the frame's vehicle frame
        pp = _t(pixel_pose, device)
        pw = torch.einsum("hwij,hwj->hwi", pp[..., :3, :3], pts) \
            + pp[..., :3, 3]
        pts = transform_points(pw, _t(frame_pose_inv, device))
    return pts


def cartesian_to_range_image(points_sensor, inclinations, width: int,
                             extrinsic=None,
                             device: str | torch.device = "cuda"
                             ) -> torch.Tensor:
    """Inverse mapping (test utility): sensor/vehicle points -> [H, W]
    range image (nearest cell; the last point of a cell wins, as numpy's
    fancy assignment)."""
    p = _t(points_sensor, device)
    incl = _t(inclinations, device)
    if extrinsic is not None:
        e = _np64(extrinsic)
        p = transform_points(p, _t(np.linalg.inv(e), device))
        az_correction = float(np.arctan2(e[1, 0], e[0, 0]))
    else:
        az_correction = 0.0
    r = torch.sqrt((p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]) + p[:, 2] * p[:, 2])
    azimuth = torch.atan2(p[:, 1], p[:, 0])
    el = torch.asin(p[:, 2] / torch.clamp(r, min=1e-9))
    cols = torch.round((1.0 - (azimuth + az_correction) / torch.pi)
                       * width / 2.0 - 0.5).long() % width
    rows = torch.argmin(torch.abs(el[:, None] - incl[None]), dim=1)
    H = incl.shape[0]
    cell = rows * width + cols
    last = torch.full((H * width,), -1, dtype=torch.long, device=p.device)
    last.scatter_reduce_(0, cell, torch.arange(len(cell), device=p.device),
                         "amax")
    img = torch.full((H * width,), -1.0, dtype=F64, device=p.device)
    hit = last >= 0
    img[hit] = r[last[hit]]
    return img.reshape(H, width)


def project_points_to_camera(points_vehicle, K, cam2vehicle, H: int, W: int,
                             device: str | torch.device = "cuda"):
    """(uv [N, 2], depth [N], valid [N]) of vehicle-frame points in a
    camera (colorization / depth, reference :230-300). The camera's inverse
    is taken on the host in float64, as the JAX package does."""
    p = _t(points_vehicle, device)
    cam = transform_points(p, _t(np.linalg.inv(_np64(cam2vehicle)), device))
    k = _np64(K)
    z = cam[:, 2]
    u = float(k[0, 0]) * cam[:, 0] / z + float(k[0, 2])
    v = float(k[1, 1]) * cam[:, 1] / z + float(k[1, 2])
    valid = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return torch.stack([u, v], -1), z, valid


def colorize_points(points_vehicle, images: dict, intrinsics: dict,
                    cam2vehicles: dict,
                    device: str | torch.device = "cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-point rgb from the first camera covering it (cameras tried in
    dict order, i.e. FRONT first like the reference). ``images``: [H, W, 3+]
    float in [0, 1], or uint8 (read as value / 255 in float64). Returns
    (rgb [N, 3] float32 in [0, 1], mask [N] colorized)."""
    p = _t(points_vehicle, device)
    n = p.shape[0]
    rgb = torch.zeros((n, 3), dtype=torch.float32, device=p.device)
    done = torch.zeros(n, dtype=torch.bool, device=p.device)
    for cam, img in images.items():
        img = img if isinstance(img, torch.Tensor) else torch.as_tensor(img)
        img = img.to(p.device)
        H, W = img.shape[:2]
        uv, _, valid = project_points_to_camera(
            p, intrinsics[cam], cam2vehicles[cam], H, W, device=p.device)
        take = valid & ~done
        ui = torch.clamp(uv[take, 0].long(), 0, W - 1)
        vi = torch.clamp(uv[take, 1].long(), 0, H - 1)
        px = img[vi, ui][..., :3]
        px = px.to(F64) / 255.0 if px.dtype == torch.uint8 else px
        rgb[take] = px.to(torch.float32)
        done |= take
    return rgb, done


def scatter_min_depth(points_vehicle, K, cam2vehicle, H: int, W: int,
                      device: str | torch.device = "cuda"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse z-buffer depth map: (value [M] float32, mask [H, W]) in the
    compressed npz layout the readers consume (lidar/depth/*.npz,
    waymo_readers.py:127-134). The smallest depth of a pixel wins:
    ``scatter_reduce(..., "amin")``, independent of the order of writes."""
    uv, z, valid = project_points_to_camera(points_vehicle, K, cam2vehicle,
                                            H, W, device=device)
    depth = torch.full((H * W,), torch.inf, dtype=torch.float32,
                       device=z.device)
    ui = uv[valid, 0].long()
    vi = uv[valid, 1].long()
    depth.scatter_reduce_(0, vi * W + ui, z[valid].to(torch.float32),
                          "amin")
    depth = depth.reshape(H, W)
    mask = torch.isfinite(depth)
    return depth[mask], mask


def points_in_box(points, center, heading: float, lwh, scale: float = 1.0,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """In-box mask in the vehicle frame (box_utils analog): the box is
    centred at ``center``, yawed by ``heading``, dims (length, width,
    height)."""
    p = _t(points, device)
    ctr = np.asarray(center, np.float64)
    c, s = np.cos(-heading), np.sin(-heading)
    dx, dy, dz = p[:, 0] - ctr[0], p[:, 1] - ctr[1], p[:, 2] - ctr[2]
    local = torch.stack([c * dx - s * dy, s * dx + c * dy, dz], -1)
    half = torch.as_tensor(np.asarray(lwh, np.float64) * scale / 2.0,
                           device=p.device)
    return (torch.abs(local) <= half).all(dim=-1)


# -- the per-frame LiDAR step of the Waymo converter --------------------------

class LidarFrame(NamedTuple):
    """One frame's LiDAR products (tensors on the device).

    background: (points [N, 3] float32, rgb [N, 3], colorized [N]);
    actors: track id -> (canonical points [M, 3] float32, rgb, colorized),
    in the order of the frame's boxes; depth: camera -> (mask [H, W],
    value [K] float32), the lidar/depth npz pair."""
    background: tuple
    actors: dict
    depth: dict


def lidar_frame(lidars: list, images: dict, intrinsics: dict,
                cam2vehicles: dict, boxes: dict,
                device: str | torch.device = "cuda") -> LidarFrame:
    """The body of the JAX package's ``waymo_converter._convert_lidar`` on
    plain arrays: ``lidars`` is a list of (range image [H, W] (first return,
    range channel), inclinations [H] (top row first), extrinsic [4, 4]);
    ``images`` camera -> decoded uint8 image [H, W, 3] in the order cameras
    are tried for colour (FRONT first); ``intrinsics`` camera -> [3, 3];
    ``cam2vehicles`` camera -> [4, 4] (opencv); ``boxes`` track id -> LiDAR
    box dict (``center_{x,y,z}``, ``heading``, ``length``, ``width``,
    ``height``). A point goes to the first box that holds it."""
    pts_all = []
    for img, incl, extrinsic in lidars:
        r = _t(img, device)
        pts = range_image_to_cartesian(torch.clamp(r, min=0.0), incl,
                                       extrinsic, device=device)
        pts_all.append(pts[r > 0])
    pts = torch.cat(pts_all)
    rgb, colorized = colorize_points(pts, images, intrinsics, cam2vehicles,
                                     device=device)

    assigned = torch.zeros(len(pts), dtype=torch.bool, device=pts.device)
    actors = {}
    for tid, box in boxes.items():
        ctr = np.array([box["center_x"], box["center_y"], box["center_z"]])
        inside = points_in_box(pts, ctr, box["heading"],
                               np.array([box["length"], box["width"],
                                         box["height"]]), device=device)
        inside &= ~assigned
        if not bool(inside.any()):
            continue
        assigned |= inside
        # the canonical actor frame: (p - centre) @ R(heading)
        c, s = np.cos(box["heading"]), np.sin(box["heading"])
        q = pts[inside]
        dx, dy, dz = q[:, 0] - ctr[0], q[:, 1] - ctr[1], q[:, 2] - ctr[2]
        local = torch.stack([dx * c + dy * s, dx * -s + dy * c, dz], -1)
        actors[tid] = (local.to(torch.float32), rgb[inside],
                       colorized[inside])
    keep = ~assigned
    background = (pts[keep].to(torch.float32), rgb[keep], colorized[keep])

    depth = {}
    for cam, img in images.items():
        H, W = img.shape[:2]
        value, mask = scatter_min_depth(pts, intrinsics[cam],
                                        cam2vehicles[cam], H, W,
                                        device=device)
        depth[cam] = (mask, value)
    return LidarFrame(background, actors, depth)
