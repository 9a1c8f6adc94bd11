#!/usr/bin/env python3
"""Scene init's KNN on the card, at chip_smoke.py's phase 16 point cloud.

    python3 street_crafter_tpu_torch/scripts/knn_time.py [--rows N]

Rebuilds phase 16's background LiDAR (26 frames of
``chip_smoke.LIDAR_POINTS`` ground and wall returns, the same seed), voxel-
downsamples it at 0.1 m as ``initialize_ply`` does, then times
``ops.knn.knn_dist2`` on all of it (three synchronised calls after a warm-
up) beside the former form, ``torch.cdist(compute_mode=
"donot_use_mm_for_euclid_dist") ** 2`` and a top-3, on the first ``--rows``
queries (its time for all of them is extrapolated), and the largest
relative difference between the two on those rows. Prints one JSON object,
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=16 * 1024)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", ".."))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("knn_time: needs a CUDA device")
    import chip_smoke as CS
    from street_crafter_tpu_torch.data_processor.pointcloud import \
        voxel_downsample
    from street_crafter_tpu_torch.ops.knn import knn_dist2
    rng = np.random.default_rng(16)
    n_g = CS.LIDAR_POINTS * 4 // 5
    n_w = CS.LIDAR_POINTS - n_g
    frames = []
    for f in range(26):
        ground = np.stack([rng.uniform(-5 + 2 * f, 25 + 2 * f, n_g),
                           rng.uniform(-8, 8, n_g), np.zeros(n_g)], -1)
        wall = np.stack([rng.uniform(-5 + 2 * f, 25 + 2 * f, n_w),
                         np.full(n_w, 8.0), rng.uniform(0, 4, n_w)], -1)
        frames.append(np.concatenate([ground, wall]))
    xyz = np.concatenate(frames).astype(np.float32)
    xyz, _ = voxel_downsample(xyz, np.ones_like(xyz), 0.1)
    dev = torch.device("cuda", 0)
    pts = torch.tensor(xyz, device=dev)
    n = len(pts)
    knn_dist2(pts[:4096])
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        new = knn_dist2(pts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    rows = min(args.rows, n) // 1024 * 1024
    old = torch.empty(rows, 3, device=dev)
    t = time.perf_counter()
    for s in range(0, rows, 1024):
        d2 = torch.cdist(pts[s:s + 1024], pts,
                         compute_mode="donot_use_mm_for_euclid_dist") ** 2
        r = torch.arange(1024, device=dev)
        d2[r, r + s] = float("inf")
        old[s:s + 1024] = torch.topk(d2, 3, dim=1, largest=False).values
    torch.cuda.synchronize()
    t_old = time.perf_counter() - t
    rel = ((new[:rows] - old).abs() / old.clamp_min(1e-12)).max().item()
    print(json.dumps({
        "points": n, "knn_dist2_s": times, "cdist_rows": rows,
        "cdist_s": t_old, "cdist_s_all_rows": t_old * n / rows,
        "max_rel_diff": rel, "finite": bool(torch.isfinite(new).all())}),
        flush=True)
    print(CS.card(), flush=True)


if __name__ == "__main__":
    main()
