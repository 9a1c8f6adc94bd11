"""Clip data of the video diffusion model (port of
``street_crafter_tpu/datasets/vdm_data.py``): ``prepare_meta``,
``ClipDataset`` (and its ``WaymoClipDataset`` / ``PandasetClipDataset``
aliases), the fine-tune's ``MultiSourceSampler``, and Vista's anno-file
datasets without LiDAR guidance: ``YouTubeClipDataset`` and
``NuScenesClipDataset`` (one action conditioning a draw, in turn), with
``balance_with_actions`` and ``resample_complete_samples``.

Images are read with the port's own PNG reader (``utils/png.py``) and
resized by ``aspect_crop_resize``, the port's copy of
``runner/diffusion.py::aspect_crop_resize``: an aspect crop (bottom-biased
by default), then a per-channel Lanczos-3 resize of the image quantised to
uint8, written out here in numpy with Pillow's fixed-point arithmetic
(``Resample.c``: 22-bit integer coefficients, a horizontal then a vertical
pass, each rounded and clipped to uint8), so it needs no PIL.
"""

from __future__ import annotations

import json
import math
import os
import queue
import threading

import numpy as np

from ..utils.png import read_png, thread_map

_PRECISION_BITS = 32 - 8 - 2


def _lanczos3(x: np.ndarray) -> np.ndarray:
    def sinc(v):
        with np.errstate(invalid="ignore", divide="ignore"):
            out = np.sin(np.pi * v) / (np.pi * v)
        return np.where(v == 0.0, 1.0, out)
    return np.where((x >= -3.0) & (x < 3.0), sinc(x) * sinc(x / 3.0), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic_filter (a = -0.5)."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    """Pillow's bilinear_filter."""
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


# Pillow's resampling filters and their supports
FILTERS = {"lanczos": (_lanczos3, 3.0), "bicubic": (_bicubic, 2.0),
           "bilinear": (_bilinear, 1.0)}


def _weights(in_size: int, out_size: int, resample: str = "lanczos"):
    """Pillow's precompute_coeffs for the box [0, in_size): per output
    pixel its first input pixel and float64 weights [out_size, ksize]
    (zeros past each window), each row normalised by its sum taken in
    Pillow's order."""
    kernel, radius = FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = radius * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    centers = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((centers + support + 0.5).astype(np.int64), in_size)
    x = np.arange(ksize)[None, :]
    taps = (xmax - xmin)[:, None]
    w = kernel((x + xmin[:, None] - centers[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where(x < taps, w, 0.0)
    total = np.zeros((out_size, 1))
    for j in range(ksize):
        total[:, 0] += w[:, j]
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    return xmin, w


def _coefficients(in_size: int, out_size: int, resample: str = "lanczos"):
    """``_weights`` + Pillow's normalize_coeffs_8bpc: integer weights with
    ``_PRECISION_BITS`` fraction bits."""
    xmin, w = _weights(in_size, out_size, resample)
    scaled = w * (1 << _PRECISION_BITS)
    kk = np.where(scaled < 0, np.trunc(-0.5 + scaled),
                  np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   resample: str = "lanczos") -> np.ndarray:
    """One Pillow pass along ``axis`` (0 rows, 1 columns) of a uint8
    [H, W, C] image."""
    in_size = img.shape[axis]
    xmin, kk = _coefficients(in_size, out_size, resample)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :],
                     in_size - 1)
    # [in, other, C]; int32 as in Pillow: |sum| < 255 * 1.3 * 2^22 < 2^31
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0), dtype=np.int32)
    kk = kk.astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int32)
    for j in range(kk.shape[1]):
        acc += src[idx[:, j]] * kk[:, j][:, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_uint8(img: np.ndarray, th: int, tw: int,
                 resample: str = "lanczos") -> np.ndarray:
    """uint8 [H, W, C] -> [th, tw, C] as Pillow's ``resize((tw, th),
    resample)`` of the image ("lanczos", "bicubic" or "bilinear"; each
    channel is resampled alone, so mode "L" and "RGB" agree)."""
    h, w = img.shape[:2]
    if w != tw:
        img = _resample_axis(img, tw, 1, resample)
    if h != th:
        img = _resample_axis(img, th, 0, resample)
    return img


def resize_lanczos_uint8(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """uint8 [H, W, C] -> [th, tw, C] as Pillow's ``resize((tw, th),
    LANCZOS)`` of each channel in mode "L"."""
    return resize_uint8(img, th, tw, "lanczos")


def resize_float32(img: np.ndarray, th: int, tw: int,
                   resample: str = "bilinear") -> np.ndarray:
    """float32 [H, W] -> [th, tw] as Pillow's ``resize`` in mode "F"
    (ImagingResample*_32bpc): float64 sums of float64 weights, each pass
    stored as float32, the horizontal pass first."""
    out = np.asarray(img, np.float32)
    for axis, size in ((1, tw), (0, th)):
        if out.shape[axis] == size:
            continue
        xmin, w = _weights(out.shape[axis], size, resample)
        src = np.moveaxis(out, axis, 0).astype(np.float64)
        idx = np.minimum(xmin[:, None] + np.arange(w.shape[1])[None, :],
                         src.shape[0] - 1)
        acc = np.zeros((size,) + src.shape[1:])
        for j in range(w.shape[1]):
            acc += src[idx[:, j]] * w[:, j][:, None]
        out = np.moveaxis(acc.astype(np.float32), 0, axis)
    return out


def aspect_crop_resize(img: np.ndarray, th: int, tw: int,
                       crop: str = "bottom") -> np.ndarray:
    """Center-width aspect crop, then a Lanczos resize of the image
    quantised to uint8 (preprocess_image, diffusion_utils.py:78-97).
    img: [H, W, C] or [H, W] float in [0, 1]; returns float in [0, 1]. The
    height crop keeps the bottom (road) part unless ``crop="center"``."""
    h, w = img.shape[:2]
    if w / h > tw / th:
        cw = int(tw / th * h)
        left = (w - cw) // 2
        img = img[:, left:left + cw]
    elif w / h < tw / th:
        ch = int(th / tw * w)
        img = img[(h - ch) // 2:(h - ch) // 2 + ch] if crop == "center" \
            else img[h - ch:]
    arr = np.asarray(img)
    flat = arr.ndim == 2
    if flat:
        arr = arr[..., None]
    q = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    out = resize_lanczos_uint8(q, th, tw).astype(np.float32) / 255.0
    return out[..., 0] if flat else out


def prepare_meta(root_dir: str, scene_names: list[str],
                 save_name: str = "meta_info_train.json",
                 num_frames: int = 25, stride: int = 5,
                 postfix: str | None = None, cam: int = 0,
                 shifts: list[float] | None = None) -> str:
    """Write a meta_info json: windows of ``num_frames`` frames of camera
    ``cam`` with their LiDAR condition paths (waymo_prepare_meta.py:54-76);
    ``shifts`` adds windows over lane-shifted condition renders."""
    metas = []
    for scene in scene_names:
        scene_dir = os.path.join(root_dir, scene)
        image_dir = os.path.join(scene_dir, "images")
        total = len([f for f in os.listdir(image_dir)
                     if f.endswith(f"_{cam}.png")])
        render_dirs = [f"color_render_{postfix}" if postfix
                       else "color_render"]
        if shifts:
            render_dirs += [f"color_render_shift_{s:.2f}" for s in shifts]
        for render_dir in render_dirs:
            lidar_dir = os.path.join(scene_dir, "lidar", render_dir)
            if not os.path.isdir(lidar_dir):
                continue
            for start in range(0, total, stride):
                end = start + num_frames
                if end >= total:
                    continue
                sample = {"frames": [], "guidances": [], "guidances_mask": []}
                for f in range(start, end):
                    img = os.path.join(image_dir, f"{f:06d}_{cam}.png")
                    gd = os.path.join(lidar_dir, f"{f:06d}_{cam}.png")
                    gm = os.path.join(lidar_dir, f"{f:06d}_{cam}_mask.png")
                    if not all(os.path.exists(p) for p in (img, gd, gm)):
                        break
                    sample["frames"].append(os.path.relpath(img, root_dir))
                    sample["guidances"].append(os.path.relpath(gd, root_dir))
                    sample["guidances_mask"].append(
                        os.path.relpath(gm, root_dir))
                else:
                    metas.append(sample)
    out = os.path.join(root_dir, save_name)
    with open(out, "w") as f:
        json.dump(metas, f, indent=1)
    return out


def load_rgb(path: str) -> np.ndarray:
    """A PNG as float RGB [H, W, 3] in [0, 1]."""
    img = read_png(path).astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    elif img.shape[-1] == 2:                 # gray + alpha
        img = np.repeat(img[..., :1], 3, -1)
    return img[..., :3]


class ClipDataset:
    """meta_info-backed clips (subsets/common.py + waymo.py:58-117): numpy
    dicts in [-1, 1]."""

    def __init__(self, data_root: str, split: str = "train",
                 target_height: int = 320, target_width: int = 576,
                 num_frames: int = 25, postfix: str | None = None,
                 anno_file: str | None = None):
        if anno_file is None:
            anno_file = os.path.join(data_root, f"meta_info_{split}.json")
            if postfix:
                anno_file = anno_file.replace(".json", f"_{postfix}.json")
        if not os.path.exists(anno_file):
            raise FileNotFoundError(anno_file)
        with open(anno_file) as f:
            self.samples = json.load(f)
        self.data_root = data_root
        self.th, self.tw = target_height, target_width
        self.num_frames = num_frames

    def __len__(self) -> int:
        return len(self.samples)

    def _prep(self, relpath: str) -> np.ndarray:
        img = load_rgb(os.path.join(self.data_root, relpath))
        return aspect_crop_resize(img, self.th, self.tw) * 2.0 - 1.0

    def __getitem__(self, index: int) -> dict:
        s = self.samples[index]
        T = self.num_frames
        imgs = np.stack(thread_map(self._prep, s["frames"][:T]))
        guides = np.stack(thread_map(self._prep, s["guidances"][:T]))
        return {
            "img_seq": imgs.astype(np.float32),        # [T, H, W, 3]
            "guide_seq": guides.astype(np.float32),    # [T, H, W, 3]
            "cond_frames_without_noise": imgs[0],
            "fps_id": np.float32(9.0),
            "motion_bucket_id": np.float32(127.0),
            "cond_aug": np.float32(0.0),
        }


class WaymoClipDataset(ClipDataset):
    pass


class PandasetClipDataset(ClipDataset):
    pass


def balance_with_actions(samples: list, increase_factor: int = 5,
                         exceptions: list | None = None) -> list:
    """Vista's command re-balancing: each sample whose command is not in
    ``exceptions`` is repeated ``increase_factor`` times in all
    (subsets/nuscenes.py:8-17)."""
    if exceptions is None:
        exceptions = [2, 3]
    extra = []
    if increase_factor > 1:
        for s in samples:
            if s["cmd"] not in exceptions:
                extra.extend([s] * (increase_factor - 1))
    return samples + extra


def resample_complete_samples(samples: list, increase_factor: int = 5
                              ) -> list:
    """Samples with complete action annotations (speed, angle and a goal
    inside the 1600x900 image in front of the camera) repeated
    ``increase_factor`` times in all (subsets/nuscenes.py:20-28)."""
    extra = []
    if increase_factor > 1:
        for s in samples:
            if (s["speed"] and s["angle"] and s["z"] > 0
                    and 0 < s["goal"][0] < 1600 and 0 < s["goal"][1] < 900):
                extra.extend([s] * (increase_factor - 1))
    return samples + extra


class _VistaAnnoDataset:
    """Vista's anno-file clips (vwm/data/subsets/common.py): a json list of
    sample dicts; frames center-cropped to the target's aspect and
    Lanczos-resized, in [-1, 1]; Vista's conditioning values, no LiDAR
    guidance."""

    def __init__(self, data_root: str, anno_file: str,
                 target_height: int = 320, target_width: int = 576,
                 num_frames: int = 25):
        if not os.path.isdir(data_root):
            raise FileNotFoundError(data_root)
        if not os.path.exists(anno_file):
            raise FileNotFoundError(anno_file)
        with open(anno_file) as f:
            self.samples = json.load(f)
        self.data_root = data_root
        self.th, self.tw = target_height, target_width
        self.num_frames = num_frames

    def __len__(self) -> int:
        return len(self.samples)

    def _image_path(self, sample: dict, i: int) -> str:
        raise NotImplementedError

    def _prep(self, path: str) -> np.ndarray:
        return aspect_crop_resize(load_rgb(path), self.th, self.tw,
                                  crop="center") * 2.0 - 1.0

    def __getitem__(self, index: int) -> dict:
        s = self.samples[index]
        imgs = np.stack(thread_map(
            self._prep, [self._image_path(s, i)
                         for i in range(self.num_frames)]))
        return {
            "img_seq": imgs.astype(np.float32),        # [T, H, W, 3]
            "cond_frames_without_noise": imgs[0],
            "fps_id": np.float32(9.0),
            "motion_bucket_id": np.float32(127.0),
            "cond_aug": np.float32(0.0),
        }


class YouTubeClipDataset(_VistaAnnoDataset):
    """Driving-video clips indexed by (folder_name, first_frame): frame i
    is the first frame's number plus i, zero-padded alike
    (subsets/youtube.py:6-22)."""

    def _image_path(self, sample: dict, i: int) -> str:
        idx_str, ext = sample["first_frame"].split(".")
        name = str(int(idx_str) + i).zfill(len(idx_str)) + "." + ext
        return os.path.join(self.data_root, sample["folder_name"], name)


class NuScenesClipDataset(_VistaAnnoDataset):
    """nuScenes clips with one action conditioning a draw
    (subsets/nuscenes.py:31-95): the samples re-balanced by command and
    resampled by completeness, then each draw advances ``action_mod`` by
    its index (mod 4) and attaches the trajectory (0), the command (1),
    speed and steering angle (2) or the goal point (3)."""

    def __init__(self, *args, balance_factor: int = 5,
                 resample_factor: int = 2, **kw):
        super().__init__(*args, **kw)
        self.samples = balance_with_actions(
            self.samples, increase_factor=balance_factor)
        self.samples = resample_complete_samples(
            self.samples, increase_factor=resample_factor)
        self.action_mod = 0

    def _image_path(self, sample: dict, i: int) -> str:
        return os.path.join(self.data_root, sample["frames"][i])

    def __getitem__(self, index: int) -> dict:
        out = super().__getitem__(index)
        s = self.samples[index]
        self.action_mod = (self.action_mod + index) % 4
        if self.action_mod == 0:
            out["trajectory"] = np.asarray(s["traj"][2:], np.float32)
        elif self.action_mod == 1:
            out["command"] = np.float32(s["cmd"])
        elif self.action_mod == 2:
            if s["speed"]:
                out["speed"] = np.asarray(s["speed"][1:], np.float32)
            if s["angle"]:
                out["angle"] = np.asarray(s["angle"][1:], np.float32) / 780.0
        elif s["z"] > 0 and 0 < s["goal"][0] < 1600 \
                and 0 < s["goal"][1] < 900:
            out["goal"] = np.asarray(
                [s["goal"][0] / 1600.0, s["goal"][1] / 900.0], np.float32)
        return out


class MultiSourceSampler:
    """Probability-weighted batches across subsets with prefetch
    (MultiSourceSamplerDataset, dataset.py:108-141; 0.9 / 0.1 Waymo /
    PandaSet in the reference config).

    Which clips a batch holds is chosen in the parent from ``seed``
    (deterministic); ``num_workers > 0`` decodes batches in a process pool
    (the reference's DataLoader workers: a 25-frame 576x1024 clip is ~50
    PNG decodes), 0 in one producer thread. The worker count does not
    change the sample sequence. Data-parallel rank ``rank`` of
    ``world_size`` draws every global batch of ``batch_size`` clips, as
    the others do, and decodes only its ``batch_size / world_size``."""

    def __init__(self, datasets: list[ClipDataset],
                 probs: list[float] | None = None,
                 batch_size: int = 1, samples_per_epoch: int = 1000,
                 seed: int = 0, prefetch: int = 2, num_workers: int = 0,
                 rank: int = 0, world_size: int = 1):
        if batch_size % world_size:
            raise ValueError(f"a batch of {batch_size} clips does not split "
                             f"over {world_size} ranks")
        if not datasets:
            raise ValueError("no datasets")
        self.datasets = datasets
        if probs is None:
            probs = [len(d) for d in datasets]
        total = float(sum(probs))
        self.probs = [p / total for p in probs]
        self.batch_size = batch_size
        self.samples_per_epoch = samples_per_epoch
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.num_workers = num_workers
        m = batch_size // world_size
        self.mine = slice(rank * m, (rank + 1) * m)

    def _indices(self) -> list[tuple[int, int]]:
        out = []
        for _ in range(self.batch_size):
            di = int(self.rng.choice(len(self.datasets), p=self.probs))
            out.append((di, int(self.rng.integers(len(self.datasets[di])))))
        return out[self.mine]

    def _fetch(self, idx: list[tuple[int, int]]) -> dict:
        items = [self.datasets[di][si] for di, si in idx]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self):
        n = self.samples_per_epoch
        if self.num_workers > 0:
            import multiprocessing as mp
            # fork: the workers share the loaded meta_info lists; they only
            # decode PNGs (no torch, no device)
            with mp.get_context("fork").Pool(self.num_workers) as pool:
                draws = [self._indices() for _ in range(n)]
                depth = max(self.prefetch, self.num_workers)
                pending = [pool.apply_async(self._fetch, (idx,))
                           for idx in draws[:depth]]
                for i in range(n):
                    batch = pending.pop(0).get()
                    if i + depth < n:
                        pending.append(pool.apply_async(
                            self._fetch, (draws[i + depth],)))
                    yield batch
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def producer():
            try:
                for _ in range(n):
                    q.put(self._fetch(self._indices()))
            except Exception as e:      # re-raised in the consumer
                q.put(e)
                return
            q.put(None)

        threading.Thread(target=producer, daemon=True).start()
        while (item := q.get()) is not None:
            if isinstance(item, Exception):
                raise item
            yield item
