"""K-nearest-neighbour distances (port of ``street_crafter_tpu/ops/knn.py``).

The simple-knn ``distCUDA2`` analog used once at pool initialization: mean
squared distance to the 3 nearest neighbours. Exact brute force, chunked
over queries so memory stays at O(chunk * N). The squared distances are
summed per coordinate by elementwise ops: ``torch.cdist`` without its
matmul form took ~31 s on an H100 for the ~158k points of a 26-frame
scene, these ops ~0.9 s.
"""

from __future__ import annotations

import torch

_BIG = 1e12


def knn_dist2(points: torch.Tensor, k: int = 3,
              chunk: int = 1024) -> torch.Tensor:
    """[N, k] squared distances to the k nearest neighbours (self excluded),
    ascending; _BIG where fewer than k neighbours exist."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    out = torch.full((n, k), _BIG, dtype=torch.float32, device=pts.device)
    kk = min(k, n - 1)
    if kk <= 0:
        return out
    for s in range(0, n, chunk):
        q = pts[s:s + chunk]
        d2 = torch.square(q[:, None, 0] - pts[None, :, 0])
        for c in (1, 2):
            d2 += torch.square(q[:, None, c] - pts[None, :, c])
        rows = torch.arange(q.shape[0], device=pts.device)
        d2[rows, rows + s] = float("inf")
        out[s:s + chunk, :kk] = torch.topk(d2, kk, dim=1,
                                           largest=False).values
    return out


def mean_dist2_knn3(points: torch.Tensor,
                    clamp_min: float = 1e-7) -> torch.Tensor:
    """distCUDA2 analog: [N] mean squared distance to the 3 nearest
    neighbours, clamped below."""
    return torch.clamp(knn_dist2(points, k=3).mean(-1), min=clamp_min)
