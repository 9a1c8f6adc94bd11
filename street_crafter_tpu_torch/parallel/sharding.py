"""Sharding rules of the port's parallel fine-tune (port of
``street_crafter_tpu/parallel/sharding.py``).

The JAX package annotates arrays with PartitionSpecs and lets XLA place
them; the port's layouts are explicit: a sharded leaf lives on each rank as
its ``1 / data`` chunk (the chunk of the rank's ``data`` index) along one
dim, chosen by the same rule as JAX's
``ShardingRules._largest_divisible`` (the largest dim that divides by the
data size, falling back through smaller dims, else replicated), and is
replicated over ``frames``, whose ranks hold parts of one clip's loss. So
``with_sharding_constraint`` has no counterpart here.

- ``param_spec``: the f32 masters' and the EMA's dim under FSDP
  (``fsdp_params``), else None (replicated, DDP and ZeRO-2);
- ``opt_state_spec``: the Adam moments' dim (ZeRO-2 and FSDP), None when
  ``zero`` is off (plain DDP: every rank holds every moment; the JAX
  package always shards its moments).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Mesh
    data_axis: str = "data"
    frames_axis: str = "frames"
    fsdp_params: bool = False
    zero: bool = True

    def __post_init__(self):
        if self.fsdp_params and not self.zero:
            raise ValueError("fsdp_params shards the moments too: zero must "
                             "be on")

    @property
    def data(self) -> int:
        return self.mesh.shape.get(self.data_axis, 1)

    def _largest_divisible(self, shape) -> int | None:
        """The largest dim divisible by the data size (ties: the first),
        falling back through smaller dims; None: replicated (a leaf whose
        largest dim is odd, e.g. CLIP's pos-emb [257, 1280], still shards
        on its second dim)."""
        data = self.data
        dims = list(shape)
        if data <= 1 or not dims:
            return None
        for best in sorted(range(len(dims)), key=lambda i: -dims[i]):
            if dims[best] % data == 0:
                return best
        return None

    def param_spec(self, shape) -> int | None:
        """The dim of a master / EMA leaf of ``shape`` sharded over data, or
        None (replicated)."""
        return self._largest_divisible(shape) if self.fsdp_params else None

    def opt_state_spec(self, shape) -> int | None:
        """The dim of an Adam moment of ``shape`` sharded over data, or
        None (replicated)."""
        return self._largest_divisible(shape) if self.zero else None

    def shard(self, x: torch.Tensor, dim: int | None) -> torch.Tensor:
        """This rank's chunk of ``x`` along ``dim`` (a view; ``x`` itself
        when ``dim`` is None): the chunk of its ``data`` index."""
        if dim is None:
            return x
        return x.chunk(self.data, dim)[self.mesh.coord(self.data_axis)]

    def unshard(self, x: torch.Tensor, dim: int | None) -> torch.Tensor:
        """The whole leaf from the ``data`` ranks' chunks (a collective:
        every rank calls it)."""
        if dim is None:
            return x
        return self.mesh.all_gather(x, dim, axis=self.data_axis)


def shard_batch(x: Any, mesh: Mesh) -> Any:
    """This rank's slice of the leading dim of a tensor or array (the
    clips of its ``data`` index)."""
    return x[mesh.local_slice(x.shape[0])]


def shard_batch_for_mesh(tree: Any, mesh: Mesh, num_frames: int) -> Any:
    """This rank's part of a batch (``shard_batch_for_mesh`` of the JAX
    package): leaves of [B, num_frames, ...] split over ``data`` on the
    clips and over ``frames`` on the frames; other leaves over ``data`` on
    their leading dim."""
    frames = mesh.local_slice(num_frames, "frames")

    def cut(x):
        x = shard_batch(x, mesh)
        if x.ndim >= 2 and x.shape[1] == num_frames:
            x = x[:, frames]
        return x
    return map_leaves(cut, tree)


def shard_pytree_batch(tree: Any, mesh: Mesh) -> Any:
    """``shard_batch`` on every tensor / array leaf of nested dicts, lists
    and tuples (NamedTuples keep their type)."""
    return map_leaves(lambda x: shard_batch(x, mesh), tree)


def map_leaves(fn, tree: Any) -> Any:
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return tree
