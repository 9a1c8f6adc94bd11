"""Render-output visualization: per-frame pngs + optional videos per stream
(port of ``street_crafter_tpu/visualizers/visualizer.py``).

PNGs go through the port's stdlib writer. Videos are written only when
asked for, and need ``imageio``; asking without it raises.
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np

from ..utils.png import write_png


def to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def depth_colormap(depth: np.ndarray, near: float | None = None,
                   far: float | None = None) -> np.ndarray:
    """Normalized depth -> 3-channel blue-green-red ramp (0 stays black)."""
    d = np.asarray(depth, np.float32)
    valid = d > 0
    if near is None:
        near = float(d[valid].min()) if valid.any() else 0.0
    if far is None:
        far = float(np.percentile(d[valid], 99.0)) if valid.any() else 1.0
    x = np.clip((d - near) / max(far - near, 1e-6), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    img = np.stack([r, g, b], -1)
    img[~valid] = 0.0
    return to_uint8(img)


def save_image(path: str, img: np.ndarray) -> None:
    write_png(path, to_uint8(img))


def save_video(path: str, frames: list[np.ndarray], fps: int = 10) -> str:
    """Write an mp4 when imageio-ffmpeg is available, else a GIF beside it.
    Raises ImportError when imageio is not installed."""
    try:
        import imageio.v2 as imageio
    except ImportError as exc:
        raise ImportError("render.save_video needs imageio; install it or "
                          "set render.save_video=false") from exc
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames8 = [to_uint8(f) for f in frames]
    try:
        import imageio_ffmpeg  # noqa: F401
        imageio.mimsave(path, frames8, fps=fps)
        return path
    except ImportError:
        gif = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(gif, frames8, duration=1.0 / fps)
        return gif


class Visualizer:
    """Collects named streams (rgb, acc, depth, gt, diff) per (frame, cam),
    writes one png each and, with ``save_videos``, one video per stream
    with the cameras of a frame side by side."""

    def __init__(self, out_dir: str, fps: int = 10, save_images: bool = True,
                 save_videos: bool = True):
        self.out_dir = out_dir
        self.fps = fps
        self.save_images = save_images
        self.save_videos = save_videos
        self._streams: dict[str, dict[int, dict[int, np.ndarray]]] = \
            defaultdict(lambda: defaultdict(dict))
        os.makedirs(out_dir, exist_ok=True)

    def add(self, name: str, frame: int, cam: int, img: np.ndarray) -> None:
        img = np.asarray(img)
        if img.ndim == 2:
            if name == "depth":
                img = depth_colormap(img)
            else:
                img = np.repeat(to_uint8(img)[..., None], 3, -1)
        if self.save_videos:
            self._streams[name][frame][cam] = to_uint8(img)
        if self.save_images:
            save_image(os.path.join(self.out_dir, name,
                                    f"{frame:06d}_{cam}.png"), img)

    def add_result(self, result: dict, frame: int, cam: int,
                   gt: np.ndarray | None = None) -> None:
        rgb = np.asarray(result["rgb"])
        self.add("rgb", frame, cam, rgb)
        if "acc" in result:
            self.add("acc", frame, cam, np.asarray(result["acc"]))
        if "depth" in result:
            self.add("depth", frame, cam, np.asarray(result["depth"]))
        if gt is not None:
            self.add("gt", frame, cam, gt)
            diff = np.abs(rgb - gt).mean(-1)
            self.add("diff", frame, cam,
                     np.repeat(to_uint8(diff)[..., None], 3, -1))

    def summarize(self) -> dict[str, str]:
        """Write one video per stream when videos are on; returns stream ->
        video path."""
        out = {}
        for name, frames in self._streams.items():
            video_frames = []
            for frame in sorted(frames):
                cams = frames[frame]
                tiles = [cams[c] for c in sorted(cams)]
                h = min(t.shape[0] for t in tiles)
                video_frames.append(np.concatenate([t[:h] for t in tiles], 1))
            if video_frames:
                out[name] = save_video(
                    os.path.join(self.out_dir, f"{name}.mp4"), video_frames,
                    fps=self.fps)
        return out
