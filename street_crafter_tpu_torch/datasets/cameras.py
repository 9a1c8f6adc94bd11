"""Camera model (port of ``street_crafter_tpu/datasets/cameras.py``).

A plain dataclass holding float32 tensors on an explicit device:
- ``R``: camera-to-world rotation as stored by the readers (w2c = [R^T | T]);
- ``T``: world-to-camera translation;
- ``K``: 3x3 pixel intrinsics.
Derived transforms use the column-vector convention.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..ops import maths


@dataclasses.dataclass(frozen=True)
class Camera:
    R: torch.Tensor          # [3,3] cam->world rotation
    T: torch.Tensor          # [3]   w2c translation
    K: torch.Tensor          # [3,3] intrinsics
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 1000.0
    id: int = -1
    frame: int = -1
    cam: int = 0
    timestamp: float = 0.0
    image_name: str = ""

    @property
    def device(self) -> torch.device:
        return self.K.device

    @property
    def w2c(self) -> torch.Tensor:
        return maths.world_to_view(self.R.T, self.T)

    @property
    def c2w(self) -> torch.Tensor:
        return maths.affine_inverse(self.w2c)

    @property
    def camera_center(self) -> torch.Tensor:
        return self.c2w[:3, 3]

    @property
    def projection_matrix(self) -> torch.Tensor:
        return maths.projection_from_K(self.K, self.height, self.width,
                                       self.znear, self.zfar)

    @property
    def full_proj_transform(self) -> torch.Tensor:
        return self.projection_matrix @ self.w2c

    @property
    def fov(self) -> tuple[float, float]:
        return maths.fov_from_K(self.K.cpu().numpy(), self.height, self.width)

    @classmethod
    def from_extrinsic(cls, ext_w2c: np.ndarray, K: np.ndarray, width: int,
                       height: int, device: torch.device | str = "cpu",
                       **kw: Any) -> "Camera":
        """Build from a 4x4 world->camera matrix."""
        ext_w2c = np.asarray(ext_w2c, np.float32)

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return cls(R=t(ext_w2c[:3, :3].T), T=t(ext_w2c[:3, 3]), K=t(K),
                   width=int(width), height=int(height), **kw)

    @classmethod
    def from_c2w(cls, c2w: np.ndarray, K: np.ndarray, width: int, height: int,
                 device: torch.device | str = "cpu", **kw: Any) -> "Camera":
        w2c = np.linalg.inv(np.asarray(c2w, np.float64))
        return cls.from_extrinsic(w2c.astype(np.float32), K, width, height,
                                  device=device, **kw)

    def get_extrinsic(self) -> np.ndarray:
        return self.w2c.cpu().numpy()

    def rescale(self, scale: float) -> "Camera":
        """Resolution change: scales K and the image size (rounded)."""
        K = self.K.clone()
        K[:2] *= scale
        return dataclasses.replace(
            self, K=K, width=int(round(self.width * scale)),
            height=int(round(self.height * scale)))
