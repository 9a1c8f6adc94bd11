"""Predicted point clouds from a monocular geometry model (port of
``street_crafter_tpu/data_processor/moge_pcd.py``; the reference's
waymo_get_moge_pcd.py:19-204).

Run a MoGe-style monocular geometry predictor on the front camera's images,
align the predicted affine-invariant depth to the sparse LiDAR depth with a
weighted linear fit, move the aligned points to the vehicle frame, split
the points inside actor boxes into per-actor canonical plys, and write the
rest as per-frame ``moge/background/{frame:06d}.ply``.

The predictor is injected: any callable ``predict(image_f32[H, W, 3],
fov_x_deg) -> {"points": [h, w, 3] camera frame, "depth": [h, w], "mask":
[h, w] bool}``. The real MoGe backend (``moge_predictor()``) is behind an
import gate: the ``moge`` package and its weights do not ship with the port.
The fit, the frame changes and the box tests run in torch on ``device``;
the two resizes are Pillow's, written out in numpy
(``datasets/vdm_data.py``: bicubic on the uint8 image, bilinear on the
float32 depth), equal to the JAX package's PIL calls.

CLI: python -m street_crafter_tpu_torch.data_processor.moge_pcd \\
    --data_dir DIR [--skip_existing] [--device cuda]
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ..datasets import waymo_layout
from ..datasets.vdm_data import resize_float32, resize_uint8
from ..utils.ply import write_ply
from ..utils.png import read_png
from .range_images import transform_points

Predictor = Callable[[np.ndarray, float], dict]

F64 = torch.float64


def recover_metric_depth(pred, gt, valid,
                         device: str | torch.device = "cuda"
                         ) -> tuple[torch.Tensor, float, float]:
    """Affine-align predicted depth to sparse metric gt: the weighted (1/gt)
    linear fit gt ~ a * pred + b of ``np.polyfit(pred, gt, 1, w=1/gt)``
    (waymo_get_moge_pcd.py:19-41) on ``device``: numpy's column-scaled
    weighted system, solved by least squares, all in float64 (numpy builds
    the system of float32 inputs in float32 and rounds the coefficients to
    float32). Falls back to mean-ratio scaling when the fitted slope is not
    positive. Returns (aligned float64, a, b)."""
    pred = torch.as_tensor(pred).to(device=device, dtype=F64)
    gt = torch.as_tensor(gt).to(device=device, dtype=F64)
    mask = gt > 1e-8
    if valid is not None:
        v = torch.as_tensor(valid).to(pred.device)
        if bool((v > 0).any()):
            mask = mask & (v > 0)
    gt_m, pred_m = gt[mask], pred[mask]
    if gt_m.numel() < 2:
        return pred, 1.0, 0.0
    w = 1.0 / gt_m
    lhs = torch.stack([pred_m, torch.ones_like(pred_m)], -1) * w[:, None]
    scale = torch.sqrt((lhs * lhs).sum(0))
    try:
        sol = torch.linalg.lstsq(lhs / scale, (gt_m * w)[:, None]).solution
        a, b = (sol[:, 0] / scale).tolist()
    except RuntimeError:
        a, b = 1.0, 0.0
    if a > 0:
        return a * pred + b, float(a), float(b)
    s = float(gt_m.mean() / torch.clamp(pred_m.mean(), min=1e-12))
    return pred * s, s, 0.0


def _area_resize(img: np.ndarray,
                 expected_area: int = 700 * 700) -> np.ndarray:
    """Resize so h * w ~ expected_area, keeping the aspect: Pillow's
    bicubic resize of the image quantised to uint8 (:89-94)."""
    h, w = img.shape[:2]
    s = (expected_area / (h * w)) ** 0.5
    nh, nw = int(h * s), int(w * s)
    q = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    out = resize_uint8(q, nh, nw, "bicubic").astype(np.float32) / 255.0
    return np.clip(out, 0.0, 1.0)


def _bilinear_resize_depth(depth: np.ndarray,
                           shape: tuple[int, int]) -> np.ndarray:
    """Bilinear depth upsample back to the original resolution (:100-101),
    Pillow's mode "F" resize."""
    return resize_float32(np.asarray(depth, np.float32), shape[0], shape[1],
                          "bilinear")


def _in_canonical_bbox(pts, length: float, width: float,
                       height: float) -> torch.Tensor:
    """Axis-aligned box test in the actor canonical frame (box_utils
    bbox_to_corner3d + inbbox_points reduce to this for axis-aligned
    boxes)."""
    half = torch.as_tensor(np.array([length, width, height]) * 0.5,
                           device=pts.device)
    return (torch.abs(pts) <= half).all(dim=-1)


def moge_predictor(device: str = "cuda") -> Predictor:
    """The real MoGe backend, behind an import gate (reference
    :15-16,97-98)."""
    try:
        from moge.model import MoGeModel
    except ImportError as e:
        raise ImportError(
            "the MoGe backend needs the `moge` package + weights "
            "(Ruicheng/moge-vitl); install it on the preprocessing host or "
            f"inject a predictor callable. missing: {e.name}") from e
    model = MoGeModel.from_pretrained("Ruicheng/moge-vitl").to(device)

    def predict(image: np.ndarray, fov_x: float) -> dict:
        t = torch.tensor(image).float().to(device).permute(2, 0, 1)[None]
        out = model.infer(t, fov_x=fov_x)
        return {"points": out["points"][0].cpu().numpy(),
                "depth": out["depth"][0].cpu().numpy(),
                "mask": out["mask"][0].cpu().numpy().astype(bool)}

    return predict


def save_moge_pcd(scene_dir: str, predictor: Predictor,
                  expected_area: int = 700 * 700,
                  device: str | torch.device = "cuda") -> None:
    """Process one scene directory (waymo_get_moge_pcd.py:43-177)."""
    track_info, _, trajectory = waymo_layout.load_track(scene_dir)
    intrinsics, extrinsics, _, _ = waymo_layout.load_camera_info(scene_dir)
    image_dir = os.path.join(scene_dir, "images")
    depth_dir = os.path.join(scene_dir, "lidar", "depth")
    lidar_actor_dir = os.path.join(scene_dir, "lidar", "actor")
    num_frames = len([x for x in os.listdir(image_dir)
                      if x.endswith(".png")]) // 5

    moge_dir = os.path.join(scene_dir, "moge")
    bkgd_dir = os.path.join(moge_dir, "background")
    actor_dir = os.path.join(moge_dir, "actor")
    os.makedirs(bkgd_dir, exist_ok=True)

    # dynamic non-sign actors only (:66-73)
    acc: dict[str, dict[str, list]] = {}
    for tid, traj in trajectory.items():
        if not traj["stationary"] and traj["label"] != "sign":
            os.makedirs(os.path.join(actor_dir, tid), exist_ok=True)
            acc[tid] = {"xyz": [], "rgb": []}

    K = np.asarray(intrinsics[0])
    cam2ego = torch.as_tensor(np.asarray(extrinsics[0], np.float64),
                              device=device)
    for frame in range(num_frames):
        img = read_png(os.path.join(image_dir, f"{frame:06d}_0.png"))
        img = img[..., :3].astype(np.float32) / 255.0
        orig_h, orig_w = img.shape[:2]
        ld = np.load(os.path.join(depth_dir, f"{frame:06d}_0.npz"))
        gt_depth = np.zeros((orig_h, orig_w), np.float32)
        gt_depth[ld["mask"].astype(bool)] = ld["value"].astype(np.float32)

        small = _area_resize(img, expected_area)
        fov_x = float(2 * np.arctan(0.5 * orig_w / K[0, 0]) / np.pi * 180)
        out = predictor(small, fov_x)

        pred_depth = _bilinear_resize_depth(np.asarray(out["depth"]),
                                            (orig_h, orig_w))
        valid = ~(np.isnan(pred_depth) | np.isinf(pred_depth))
        _, a, b = recover_metric_depth(pred_depth, gt_depth, valid,
                                       device=device)

        pts = torch.as_tensor(np.asarray(out["points"], np.float32),
                              device=device).reshape(-1, 3) * a + b
        rgbs = torch.as_tensor(small, device=device).reshape(-1, 3)
        keep = torch.as_tensor(np.asarray(out["mask"]).reshape(-1),
                               device=device)
        # camera -> vehicle frame (:113)
        pts = transform_points(pts[keep].to(F64), cam2ego)
        rgbs = rgbs[keep]

        actor_mask = torch.zeros(len(pts), dtype=torch.bool, device=device)
        for tid, info in track_info[f"{frame:06d}"].items():
            if tid not in acc or not os.path.exists(
                    os.path.join(lidar_actor_dir, tid, f"{frame:06d}.ply")):
                continue
            box = info["lidar_box"]
            pose_idx = trajectory[tid]["frames"].index(frame)
            inv = np.linalg.inv(trajectory[tid]["poses_vehicle"][pose_idx])
            canon = transform_points(pts, torch.as_tensor(
                inv.astype(np.float64), device=device))
            inb = _in_canonical_bbox(canon, box["length"], box["width"],
                                     box["height"])
            actor_mask |= inb
            if int(inb.sum()) > 10:
                xyz_c = canon[inb].cpu().numpy()
                rgb_c = rgbs[inb].cpu().numpy()
                acc[tid]["xyz"].append(xyz_c)
                acc[tid]["rgb"].append(rgb_c)
                write_ply(os.path.join(actor_dir, tid, f"{frame:06d}.ply"),
                          xyz_c, rgb_c, np.ones(len(xyz_c), bool))

        rest = ~actor_mask
        write_ply(os.path.join(bkgd_dir, f"{frame:06d}.ply"),
                  pts[rest].cpu().numpy(), rgbs[rest].cpu().numpy(),
                  np.ones(int(rest.sum()), bool))

    for tid, pc in acc.items():
        if pc["xyz"]:
            xyz = np.concatenate(pc["xyz"])
            write_ply(os.path.join(actor_dir, tid, "full.ply"), xyz,
                      np.concatenate(pc["rgb"]), np.ones(len(xyz), bool))


def check_existing(scene_dir: str) -> bool:
    """Skip scenes whose moge/background is complete (:181-189)."""
    image_dir = os.path.join(scene_dir, "images")
    bkgd = os.path.join(scene_dir, "moge", "background")
    if not os.path.isdir(bkgd):
        return False
    return len(os.listdir(image_dir)) // 5 == len(os.listdir(bkgd))


def main(argv: list[str] | None = None) -> None:
    import argparse
    p = argparse.ArgumentParser(description="MoGe predicted pcd extraction")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    predictor = moge_predictor(args.device)
    for sid in sorted(os.listdir(args.data_dir)):
        scene = os.path.join(args.data_dir, sid)
        if args.skip_existing and check_existing(scene):
            print(f"moge pcd exists for {sid}, skipping")
            continue
        print(f"processing {sid}")
        save_moge_pcd(scene, predictor, device=args.device)


if __name__ == "__main__":
    main()
