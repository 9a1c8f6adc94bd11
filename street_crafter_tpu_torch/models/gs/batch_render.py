"""Camera-parallel scene rendering over the data-parallel ranks (port of
``street_crafter_tpu/models/gs/batch_render.py``).

Scene parameters are replicated; the B cameras of a batch split over the
ranks (B / W each, in order), every rank renders its cameras through
kernels A, the pack and B, and ``all_gather`` returns ``rgb``, ``depth``
and ``acc`` as [B, H, W, .] on every rank. Without a mesh one process
renders all B.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...datasets.cameras import Camera
from ...parallel.mesh import Mesh
from .renderer import render_scene
from .scene import SceneMeta, SceneParams


def stack_cameras(cameras: list[Camera], frame_idx: list[int] | None = None
                  ) -> tuple[dict[str, torch.Tensor], tuple[int, int]]:
    """[B] camera batch tensors (w2c, K, frame_idx, frame, cam_id,
    timestamp) of same-size cameras, and (H, W). ``frame_idx`` (frame -
    start_frame, for the tracklet lookup) defaults to the raw frame
    number (right when the selected frames start at 0)."""
    if not cameras:
        raise ValueError("empty camera batch")
    w, h = cameras[0].width, cameras[0].height
    if any(c.width != w or c.height != h for c in cameras):
        raise ValueError("sharded rendering needs a uniform-resolution "
                         "batch")
    if frame_idx is None:
        frame_idx = [c.frame for c in cameras]
    dev = cameras[0].device
    return {
        "w2c": torch.stack([c.w2c for c in cameras]),
        "K": torch.stack([c.K for c in cameras]),
        "frame_idx": torch.tensor(frame_idx, dtype=torch.int32, device=dev),
        "frame": torch.tensor([c.frame for c in cameras],
                              dtype=torch.float32, device=dev),
        "cam_id": torch.tensor([c.cam for c in cameras], dtype=torch.int32,
                               device=dev),
        "timestamp": torch.tensor([c.timestamp for c in cameras],
                                  dtype=torch.float32, device=dev),
    }, (h, w)


def make_sharded_renderer(mesh: Mesh | None, width: int, height: int,
                          sh_degree: int = 3, tile_size: int = 16,
                          **render_kw) -> Callable:
    """(params, meta, camera batch of ``stack_cameras``) -> {"rgb" [B, H, W,
    3], "depth" [B, H, W, 1], "acc" [B, H, W]}: this rank renders its B / W
    cameras (clamped rgb, interpolated tracklet poses), the ranks gather."""

    @torch.no_grad()
    def render_batch(params: SceneParams, meta: SceneMeta | None,
                     batch: dict[str, torch.Tensor]) -> dict:
        n = batch["w2c"].shape[0]
        mine = (mesh.local_slice(n) if mesh is not None
                else slice(0, n))
        outs = {"rgb": [], "depth": [], "acc": []}
        for i in range(n)[mine]:
            w2c = batch["w2c"][i]
            cam = Camera(R=w2c[:3, :3].T, T=w2c[:3, 3], K=batch["K"][i],
                         width=width, height=height)
            out = render_scene(
                params, meta, cam, frame_idx=int(batch["frame_idx"][i]),
                frame=float(batch["frame"][i]),
                cam_id=int(batch["cam_id"][i]),
                timestamp=batch["timestamp"][i], sh_degree=sh_degree,
                tile_size=tile_size, interpolate_pose=True, clamp=True,
                **render_kw)
            for k in outs:
                outs[k].append(out[k])
        local = {k: torch.stack(v) for k, v in outs.items()}
        if mesh is None:
            return local
        return {k: mesh.all_gather(v, 0, axis="data")
                for k, v in local.items()}

    return render_batch
