"""Diffusion distillation runner: sliding-window conditioned sampling (port
of ``street_crafter_tpu/runner/diffusion.py``).

For each lane-shift trajectory: slide windows of ``sample_frames - 1``
novel frames (step ``sample_frames - 1 - window_size``), prepend the
nearest train camera as the conditioning frame 0, sample the
LiDAR-conditioned VDM (SDS-initialised from the current 3DGS render when a
``render_fn`` is given) and attach the frames to the novel cameras as their
supervision (``CameraInfo._image``, ``metadata["diffusion_version"]``
bumped). Every window draws its noise from a ``torch.Generator`` seeded
with ``seed`` afresh, as the reference seeds every call with 23.

Novel views render directly at the diffusion resolution: the aspect crop
and resize of the sample are folded into the camera's intrinsics
(``diffusion_camera``), so no resampling op runs in the training loop.

With a mesh, the ranks of the mesh run the event together. The ranks that
hold an engine sample: with ``shard_frames`` (``diffusion.shard_sample``
with a ``frames`` axis, as ``sampling_mesh_from_cfg`` gives
``runner.render`` and ``runner.train``'s hook gives the frames group of
data index 0) each window with its frames split over the ``frames`` axis
(``parallel/sample.py``), every sampling rank getting the whole window;
else rank 0 alone. After each window its frames go from data index 0 to
every rank (a broadcast along ``data``, or over every rank when rank 0
sampled alone), so that every rank attaches bit-equal images: ranks that
each sampled would train on different supervision (two valid bf16
evaluations of the network differ by up to ~0.1). Every rank joins the
condition barrier, with or without a processor; rank 0 alone writes
files.

``EngineParamStore`` keeps the engine's weights in (pinned) host memory
between sampling events and moves them to the card for one event, so that
GS training has the card's memory to itself between events (the
reference's ``--low_vram`` offload).

The reference's masked guidance is not a parameter here: its consumption is
commented out in the reference's sampler, and the JAX runner accepts the
flag and drops it, so ``diffusion.{masked_guidance_iter,
acc_masked_guidance, cond_masked_guidance}`` have no effect.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..datasets.cameras import Camera
from ..datasets.readers import CameraInfo
from ..datasets.vdm_data import aspect_crop_resize
from ..parallel.mesh import make_mesh
from ..parallel.sample import sample_on_mesh
from ..utils.png import read_png
from ..visualizers.visualizer import save_image

SEED = 23   # the reference seeds every sampling call with 23


def crop_resize_K(K: np.ndarray, h: int, w: int, th: int, tw: int
                  ) -> np.ndarray:
    """The intrinsics of ``aspect_crop_resize`` (bottom crop) from an
    h x w image to th x tw."""
    K = np.asarray(K, np.float64).copy()
    left, top = 0.0, 0.0
    ch, cw = h, w
    if w / h > tw / th:
        cw = int(tw / th * h)
        left = (w - cw) // 2
    elif w / h < tw / th:
        ch = int(th / tw * w)
        top = h - ch
    K[0, 2] -= left
    K[1, 2] -= top
    K[0] *= tw / cw
    K[1] *= th / ch
    return K


def diffusion_camera(info: CameraInfo, th: int, tw: int,
                     device: torch.device | str = "cpu") -> Camera:
    """Device camera of ``info`` rendering at the diffusion resolution."""
    w2c = np.eye(4)
    w2c[:3, :3] = info.R.T
    w2c[:3, 3] = info.T
    K = crop_resize_K(info.K, info.height, info.width, th, tw)
    return Camera.from_extrinsic(
        w2c.astype(np.float32), K.astype(np.float32), tw, th, device=device,
        id=info.uid, frame=info.metadata.get("frame", -1),
        cam=info.metadata.get("cam", 0),
        timestamp=float(info.metadata.get("timestamp", 0.0)),
        image_name=info.image_name)


def _load_rgb(path: str) -> np.ndarray:
    img = np.asarray(read_png(path), np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return img[..., :3]


def resolve_params_on_host(dcfg, device: torch.device | str) -> bool:
    """``diffusion.params_on_host``: true / false, or "auto": on when the
    engine runs on ``cuda`` (on the CPU the weights are host memory
    already)."""
    v = dcfg.get("params_on_host", "auto")
    if isinstance(v, str):
        if v.lower() == "auto":
            return torch.device(device).type == "cuda"
        return v.lower() in ("1", "true", "yes", "on")
    return bool(v)


class EngineParamStore:
    """Where the engine's (frozen) weights live between sampling events.
    With ``on_host`` the only copy rests in host memory (pinned when the
    engine is on ``cuda``, so that the copies run at the link's rate);
    ``acquire()`` copies it to the engine's device for one event and
    ``release()`` drops the device copy. The weights are never written, so
    nothing is copied back. ``move_s`` holds the last acquire's and
    release's wall seconds; ``nbytes`` the weights' size."""

    def __init__(self, engine, on_host: bool):
        self.engine = engine
        self.on_host = bool(on_host)
        self.on_device = True
        self.nbytes = sum(t.numel() * t.element_size()
                          for m in engine.modules().values()
                          for t in list(m.parameters()) + list(m.buffers()))
        self.move_s = {"acquire": 0.0, "release": 0.0}
        self._host: dict[str, list[torch.Tensor]] = {}
        if self.on_host:
            pin = engine.device.type == "cuda"
            for name, module in engine.modules().items():
                kept = self._host[name] = []

                def to_host(t, kept=kept):
                    h = t.detach().to("cpu")
                    h = h.pin_memory() if pin else h.clone()
                    kept.append(h)
                    return h
                module._apply(to_host)
            self.on_device = False
            self._sync()

    def _sync(self) -> None:
        if self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def acquire(self):
        """The engine with its weights on its device, for one event."""
        if self.on_host and not self.on_device:
            t0 = time.perf_counter()
            dev = self.engine.device
            for module in self.engine.modules().values():
                module._apply(lambda t: t.to(dev, non_blocking=True))
            self._sync()
            self.on_device = True
            self.move_s["acquire"] = time.perf_counter() - t0
        return self.engine

    def release(self) -> None:
        """Point the modules back at the host copy; the device copy is
        freed (no-op when the weights stay on the device)."""
        if self.on_host and self.on_device:
            t0 = time.perf_counter()
            self._sync()
            for name, module in self.engine.modules().items():
                it = iter(self._host[name])
                module._apply(lambda t: next(it))
            self.on_device = False
            self.move_s["release"] = time.perf_counter() - t0

    @property
    def host_resident(self) -> bool:
        """True iff the weights rest on the host and no device copy is
        staged."""
        return self.on_host and not self.on_device and all(
            t.device.type == "cpu" for m in self.engine.modules().values()
            for t in list(m.parameters()) + list(m.buffers()))


def sampling_mesh_from_cfg(cfg):
    """The mesh of frames-sharded sampling when ``diffusion.shard_sample``
    is set and the process group has more than one rank (torchrun's
    ``WORLD_SIZE``), over ``cfg.mesh.axes``; None otherwise (as JAX's
    returns None on one device)."""
    if not cfg.diffusion.get("shard_sample", False):
        return None
    joined = dist.is_available() and dist.is_initialized()
    world = (dist.get_world_size() if joined
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world <= 1:
        return None
    return make_mesh(dict(cfg.mesh.axes), device=cfg.get("device", "cuda"))


class DiffusionRunner:
    """Bridges the VDM engine to the GS scene. ``render_fn(camera_info) ->
    {"rgb": [H, W, 3] tensor in [0, 1], ...}`` renders the current 3DGS
    at the diffusion resolution (the SDS init). ``scene`` (None in unit
    use) gives the processor that writes missing condition PNGs. With a
    ``mesh``: ``engine`` None on a rank that does not sample (it takes
    each window from the broadcast; ``sample_frames`` then gives the
    window), ``shard_frames`` (default: the mesh has a ``frames`` axis)
    samples each window frames-sharded over that axis
    (``parallel.sample.sample_on_mesh``), and rank 0 alone writes."""

    def __init__(self, scene, engine, height: int = 576, width: int = 1024,
                 window_size: int = 4, num_steps: int | None = None,
                 cfg_scale: float | None = None,
                 save_dir: str | None = None, seed: int = SEED,
                 mesh=None, sample_frames: int | None = None,
                 shard_frames: bool | None = None):
        if engine is None and mesh is None:
            raise ValueError("a rank without an engine takes its windows "
                             "from a mesh")
        self.scene = scene
        self.engine = engine
        self.th, self.tw = height, width
        self.window_size = window_size
        self.sample_frames = (engine.cfg.num_frames if engine is not None
                              else int(sample_frames))
        self.num_steps = num_steps
        self.cfg_scale = cfg_scale
        self.save_dir = save_dir
        self.seed = seed
        self.mesh = mesh
        if shard_frames is None:
            shard_frames = mesh is not None and mesh.size("frames") > 1
        self.shard_frames = bool(shard_frames)

    @property
    def writes(self) -> bool:
        """This rank writes files (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def samples(self) -> bool:
        """This rank samples the windows (it holds the engine)."""
        return self.engine is not None

    def _share(self, out: np.ndarray | None) -> np.ndarray:
        """The window's frames from data index 0 on every rank of the
        mesh: a broadcast along ``data`` (each frames index's data-0 rank
        holds the whole window) when sampling frames-sharded, else over
        every rank from rank 0. ``out``: this rank's sample, None on a
        rank that did not sample."""
        if self.mesh is None:
            return out
        shape = (self.sample_frames, self.th, self.tw, 3)
        t = (torch.empty(shape, dtype=torch.float32) if out is None
             else torch.from_numpy(np.ascontiguousarray(out, np.float32)))
        if tuple(t.shape) != shape:
            raise ValueError(f"a window of {tuple(t.shape)}, expected "
                             f"{shape}")
        if self.mesh.backend == "nccl":
            t = t.to(self.mesh.device)
        self.mesh.broadcast_([t], src=0,
                             axis="data" if self.shard_frames else None)
        return t.cpu().numpy()

    def _sample(self, guide_images: np.ndarray, cond_images: np.ndarray,
                render_images: torch.Tensor | None, sds_scale: float | None,
                cond_indices: tuple[int, ...] = (0,)) -> np.ndarray:
        """One window: [T, th, tw, 3] in [-1, 1]."""
        dev = self.engine.device
        kw = dict(generator=torch.Generator(device=dev).manual_seed(
                      self.seed),
                  render_images=render_images, sds_scale=sds_scale,
                  cfg_scale=self.cfg_scale, num_steps=self.num_steps,
                  cond_indices=cond_indices)
        guide = torch.from_numpy(guide_images).to(dev)
        cond = torch.from_numpy(cond_images).to(dev)
        if self.shard_frames:
            out = sample_on_mesh(self.engine, guide, cond, self.mesh, **kw)
        else:
            out = self.engine.sample(guide_images=guide, cond_image=cond,
                                     **kw)
        return out.float().cpu().numpy()

    def _render_conditions(self, cameras: list[CameraInfo]) -> None:
        """Write the missing condition PNGs (rank 0, where it has the
        scene's processor); every rank of the mesh then meets in a barrier,
        whether or not it has a processor, so that no rank reads a PNG
        before it is written and the collectives after it pair up."""
        processor = None if self.scene is None else self.scene.processor
        if self.writes and processor is not None:
            processor.render_conditions(
                cameras, self.scene.info.metadata["obj_meta"])
        if self.mesh is not None:
            self.mesh.barrier()

    # -- data assembly ---------------------------------------------------
    def load_guidance(self, cam: CameraInfo) -> np.ndarray:
        """The LiDAR condition image at the diffusion size, in [-1, 1]."""
        rgb = _load_rgb(cam.metadata["guidance_rgb_path"])
        return aspect_crop_resize(rgb, self.th, self.tw) * 2.0 - 1.0

    def load_cond_image(self, cam: CameraInfo) -> np.ndarray:
        img = aspect_crop_resize(cam.load_image(), self.th, self.tw)
        return img * 2.0 - 1.0

    def _attach(self, cameras: list[CameraInfo], frames: np.ndarray,
                name: Callable[[CameraInfo], str]) -> None:
        for cam, img in zip(cameras, frames):
            cam._image = img
            # a new version: Scene.batch_for builds the batch anew
            cam.metadata["diffusion_version"] = \
                cam.metadata.get("diffusion_version", 0) + 1
            if self.save_dir and self.writes:
                save_image(os.path.join(self.save_dir, name(cam)), img)

    # -- entry points ------------------------------------------------------
    def run(self, novel_cameras: list[CameraInfo],
            train_cameras: list[CameraInfo],
            render_fn: Callable | None = None, scale: float = 0.3) -> None:
        """``run_sequence`` over each lane-shift trajectory of the front
        camera."""
        cams = [c for c in novel_cameras if c.metadata["cam"] == 0]
        for novel_id in sorted({c.metadata["novel_view_id"] for c in cams}):
            seq = sorted((c for c in cams
                          if c.metadata["novel_view_id"] == novel_id),
                         key=lambda c: c.metadata["frame"])
            self.run_sequence(seq, train_cameras, render_fn, scale)

    def run_sequence(self, cameras: list[CameraInfo],
                     train_cameras: list[CameraInfo],
                     render_fn: Callable | None = None,
                     scale: float = 0.3) -> np.ndarray:
        """Sliding windows over one trajectory; returns its frames [n, th,
        tw, 3] in [0, 1]."""
        self._render_conditions(cameras)
        frames = [c.metadata["frame"] for c in cameras]
        train_frames = np.array([c.metadata["frame"] for c in train_cameras])
        n = len(frames)
        win = self.sample_frames - 1
        if n < win:
            raise ValueError(f"not enough frames for sampling: {n} < {win}")
        step = win - self.window_size

        guides = ([self.load_guidance(c) for c in cameras] if self.samples
                  else None)
        renders = None
        if render_fn is not None and self.samples:
            renders = [render_fn(c)["rgb"].float() * 2.0 - 1.0
                       for c in cameras]

        filled = np.zeros(n, bool)
        result = np.zeros((n, self.th, self.tw, 3), np.float32)
        for start in range(0, n, step):
            end = min(start + win, n)
            start = end - win
            cond_cam = train_cameras[
                int(np.abs(train_frames - frames[start]).argmin())]
            self._render_conditions([cond_cam])
            out = None
            if self.samples:
                guide_seq = np.stack([self.load_guidance(cond_cam)]
                                     + guides[start:end]).astype(np.float32)
                cond_image = self.load_cond_image(cond_cam)[None].astype(
                    np.float32)
                render_seq = None
                if renders is not None:
                    dev = renders[0].device
                    render_seq = torch.cat([
                        torch.from_numpy(cond_image).to(dev),
                        torch.stack(renders[start:end])])
                out = self._sample(guide_seq, cond_image, render_seq,
                                   scale if render_seq is not None else None)
            out = self._share(out)
            result[start:end] = (out[1:] + 1.0) / 2.0
            filled[start:end] = True
        assert filled.all(), "not all frames were sampled"
        self._attach(cameras, result,
                     lambda c: f"{c.image_name}_scale{scale}.png")
        return result

    def run_interleaved(self, test_cameras: list[CameraInfo],
                        train_cameras: list[CameraInfo]) -> np.ndarray:
        """Condition on every train frame inside each window and fill the
        test frames between them. Returns the test frames [len(test), th,
        tw, 3] in [0, 1]."""
        cameras = sorted(test_cameras + train_cameras,
                         key=lambda c: c.metadata["frame"])
        train_frames = {c.metadata["frame"] for c in train_cameras}
        self._render_conditions(cameras)
        n = len(cameras)
        T = self.sample_frames
        if n < T:
            raise ValueError(f"not enough frames: {n} < {T}")
        step = T - self.window_size

        guides = ([self.load_guidance(c) for c in cameras] if self.samples
                  else None)
        filled = np.zeros(n, bool)
        result = np.zeros((n, self.th, self.tw, 3), np.float32)
        for start in range(0, n, step):
            end = min(start + T, n)
            start = end - T
            window = cameras[start:end]
            cond_indices = tuple(
                i for i, c in enumerate(window)
                if c.metadata["frame"] in train_frames)
            out = None
            if self.samples:
                cond_images = np.stack(
                    [self.load_cond_image(window[i]) for i in cond_indices])
                out = self._sample(
                    np.stack(guides[start:end]).astype(np.float32),
                    cond_images.astype(np.float32), None, None,
                    cond_indices=cond_indices)
            out = self._share(out)
            result[start:end] = (out + 1.0) / 2.0
            filled[start:end] = True
        assert filled.all(), "not all frames were sampled"
        self._attach(cameras, result, lambda c: f"{c.image_name}.png")
        test_set = {id(c) for c in test_cameras}
        return np.stack([result[i] for i, c in enumerate(cameras)
                         if id(c) in test_set])
