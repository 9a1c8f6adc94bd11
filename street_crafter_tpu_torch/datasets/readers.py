"""Scene reading structures shared across dataset parsers.

Copy of ``street_crafter_tpu/datasets/readers.py`` (CameraInfo/SceneInfo,
nerf++ norm, train/test frame split); images load lazily through the port's
PNG reader. Host-side numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..utils.png import read_png


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray          # [3,3] cam->world rotation (3DGS convention)
    T: np.ndarray          # [3] w2c translation
    K: np.ndarray          # [3,3]
    width: int
    height: int
    image_path: str = ""
    image_name: str = ""
    metadata: dict = dataclasses.field(default_factory=dict)
    guidance: dict = dataclasses.field(default_factory=dict)
    _image: Any = None

    @property
    def fov(self) -> tuple[float, float]:
        return (2 * np.arctan(self.width / (2 * self.K[0, 0])),
                2 * np.arctan(self.height / (2 * self.K[1, 1])))

    def load_image(self) -> np.ndarray:
        """[H, W, 3] float32 in [0, 1]."""
        if self._image is None:
            img = read_png(self.image_path)
            self._image = np.asarray(img, np.float32)[..., :3] / 255.0
        return self._image

    @property
    def c2w(self) -> np.ndarray:
        w2c = np.eye(4, dtype=np.float64)
        w2c[:3, :3] = self.R.T
        w2c[:3, 3] = self.T
        return np.linalg.inv(w2c)


@dataclasses.dataclass
class SceneInfo:
    train_cameras: list
    test_cameras: list
    metadata: dict = dataclasses.field(default_factory=dict)
    novel_view_cameras: list = dataclasses.field(default_factory=list)


def get_val_frames(num_frames: int, test_every: int | None,
                   train_every: int | None) -> tuple[list[int], list[int]]:
    """Train/test frame split (data_utils.py:30-40). Unlike the reference,
    (None, None) is accepted and means "all frames train"."""
    everything = set(range(num_frames))
    if train_every is None or train_every < 0:
        if test_every is None:
            return sorted(everything), []
        val = set(np.arange(test_every, num_frames, test_every))
        train = (everything - val) if test_every > 1 else set()
    else:
        train = set(np.arange(0, num_frames, train_every))
        val = (everything - train) if train_every > 1 else set()
    return sorted(int(f) for f in train), sorted(int(f) for f in val)


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Scene center/radius from camera centers (base_readers.py:37-60)."""
    centers = np.stack([c.c2w[:3, 3] for c in cam_infos])
    center = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - center, axis=-1).max() * 1.1)
    return {"center": center, "radius": radius}
