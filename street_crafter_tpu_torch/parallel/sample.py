"""Frames-sharded conditioned sampling (port of ``street_crafter_tpu/
parallel/sample.py``).

The distillation phase's wall-clock is dominated by 25-frame CFG windows.
The fine-tune's sequence parallelism (``parallel/sequence.py``: spatial
UNet work on each rank's frames, the temporal stages across the
``frames`` group) applies unchanged at inference: each of the f ranks of
a frames group runs the whole ``engine.sample`` on its T/f frames of the
window, encoding only its frames of the guide and render images, and the
UNet exchanges what crosses frames. The kernels (D in the spatial
attention, E and F in the fused temporal stages) run on each rank's shard
as they run on one GPU; the JAX package's kernel_shard bridge is not
involved, the frames are already split.

Unlike JAX's, which returns the sample sharded over frames, the port
gathers: every rank returns the whole [T, H, W, 3] window. Ranks along
``data`` compute the same window, as JAX's replication over ``data``
does.
"""

from __future__ import annotations

from typing import Any

import torch

from .mesh import Mesh
from .sequence import AXIS, frames_shard
from .sharding import map_leaves


def shard_window_inputs(mesh: Mesh, num_frames: int, tree: Any,
                        frames_axis: str = AXIS) -> Any:
    """This rank's part of every tensor leaf: a leading dim of
    ``num_frames`` is sliced to the rank's frames along ``frames_axis``;
    other leaves stay whole (replicated)."""
    mine = mesh.local_slice(num_frames, frames_axis)

    def cut(x):
        if x.ndim >= 1 and x.shape[0] == num_frames:
            return x[mine]
        return x
    return map_leaves(cut, tree)


@torch.no_grad()
def sample_on_mesh(engine, guide_images: torch.Tensor,
                   cond_image: torch.Tensor, mesh: Mesh,
                   render_images: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   **sample_kw) -> torch.Tensor:
    """``engine.sample`` with the window's frames split over ``mesh``'s
    frames axis: guide_images (and render_images) [T, H, W, 3] and
    cond_image whole on every rank, the generator seeded alike on every
    rank (the noise is drawn over the whole window, then sliced). Returns
    the whole [T, H, W, 3] on every rank. A frames size that does not
    divide T raises."""
    fs = frames_shard(mesh, engine.cfg.num_frames)
    return engine.sample(guide_images, cond_image, generator=generator,
                         render_images=render_images, frames=fs,
                         **sample_kw)
