"""Gaussian parameter pools (port of ``street_crafter_tpu/models/gs/params.py``).

A pool is a structure of arrays with a ``valid`` mask, in the reference's raw
(pre-activation) parameterization: scaling = log(sigma), opacity =
logit(alpha), rotation = unnormalized wxyz, features split into DC
([cap, F, 3], Fourier-time-varying when F > 1) and rest ([cap, K-1, 3]).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ops import sh as SH
from ...ops.knn import mean_dist2_knn3

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "valid")


@dataclasses.dataclass(frozen=True)
class GaussianPool:
    xyz: torch.Tensor            # [cap, 3]
    features_dc: torch.Tensor    # [cap, F, 3]
    features_rest: torch.Tensor  # [cap, K-1, 3]
    scaling: torch.Tensor        # [cap, 3] log-scale
    rotation: torch.Tensor       # [cap, 4] unnormalized wxyz
    opacity: torch.Tensor        # [cap, 1] logit
    valid: torch.Tensor          # [cap] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def fourier_dim(self) -> int:
        return self.features_dc.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def num_valid(self) -> int:
        """Valid slots, summed over every slot of a stacked pool too."""
        return int(self.valid.sum())

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.clamp(
            torch.linalg.norm(self.rotation, dim=-1, keepdim=True), min=1e-12)

    def get_features_dc(self, time=0.0) -> torch.Tensor:
        """[cap, 1, 3]; Fourier IDFT combination when F > 1."""
        F = self.fourier_dim
        if F == 1:
            return self.features_dc
        basis = SH.idft_basis(torch.as_tensor(time, dtype=torch.float32,
                                              device=self.device), F)
        return torch.einsum("nfc,f->nc", self.features_dc,
                            basis.reshape(-1))[:, None, :]

    def get_features(self, time=0.0) -> torch.Tensor:
        """[cap, K, 3] full SH coefficient stack."""
        return torch.cat([self.get_features_dc(time), self.features_rest], 1)

    def trainable_dict(self) -> dict[str, torch.Tensor]:
        """The optimised leaves under the Adam group names."""
        return {
            "xyz": self.xyz, "f_dc": self.features_dc,
            "f_rest": self.features_rest, "scaling": self.scaling,
            "rotation": self.rotation, "opacity": self.opacity,
        }

    def replace(self, **kw) -> "GaussianPool":
        return dataclasses.replace(self, **kw)


def stack_pools(pools: list[GaussianPool]) -> GaussianPool:
    """[A, cap, ...] pool from A pools of equal capacity."""
    return GaussianPool(**{f: torch.stack([getattr(p, f) for p in pools])
                           for f in FIELDS})


def empty_pool(capacity: int, sh_degree: int = 3, fourier_dim: int = 1,
               device: torch.device | str = "cpu") -> GaussianPool:
    k = (sh_degree + 1) ** 2
    rotation = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    rotation[:, 0] = 1.0
    return GaussianPool(
        xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        features_dc=torch.zeros((capacity, fourier_dim, 3),
                                dtype=torch.float32, device=device),
        features_rest=torch.zeros((capacity, k - 1, 3), dtype=torch.float32,
                                  device=device),
        scaling=torch.full((capacity, 3), -10.0, dtype=torch.float32,
                           device=device),
        rotation=rotation,
        opacity=torch.full((capacity, 1), -10.0, dtype=torch.float32,
                           device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def init_pool_from_points(
    points: np.ndarray,            # [N, 3]
    colors: np.ndarray,            # [N, 3] in [0, 1]
    capacity: int,
    sh_degree: int = 3,
    fourier_dim: int = 1,
    init_opacity: float = 0.1,
    fixed_scale: float | None = None,
    device: torch.device | str = "cpu",
) -> GaussianPool:
    """create_from_pcd analog: KNN scales (log sqrt mean dist^2 to 3 NN),
    identity rotations, ``init_opacity``, DC features from RGB2SH. Points
    beyond ``capacity`` are subsampled with numpy's default_rng(0)."""
    n = min(len(points), capacity)
    if len(points) > capacity:
        sel = np.random.default_rng(0).choice(len(points), capacity,
                                              replace=False)
        points = points[sel]
        colors = colors[sel]
    pool = empty_pool(capacity, sh_degree, fourier_dim, device)

    pts = torch.tensor(np.asarray(points[:n], np.float32), device=device)
    if fixed_scale is not None:
        scales = torch.full((n, 3), float(np.log(fixed_scale)),
                            dtype=torch.float32, device=device)
    else:
        d2 = mean_dist2_knn3(pts)
        scales = torch.log(torch.sqrt(d2))[:, None].expand(n, 3)
    dc = SH.rgb_to_sh(torch.tensor(np.asarray(colors[:n, :3], np.float32),
                                   device=device))

    pool.xyz[:n] = pts
    pool.features_dc[:n, 0, :] = dc      # higher Fourier terms start at zero
    pool.scaling[:n] = scales
    pool.opacity[:n] = float(np.log(init_opacity / (1 - init_opacity)))
    pool.valid[:n] = True
    return pool
