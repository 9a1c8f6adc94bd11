"""Sequence parallelism over the ``frames`` mesh axis: the exchanges that
XLA inserts for the JAX package (``parallel/mesh.py``'s docstring, SURVEY
section 2.3), written out.

A clip of T frames is split over the f ranks of a ``frames`` group: rank
i holds frames [i T/f, (i + 1) T/f), so activations are [B * T/f, ...].
The spatial UNet work stays on each rank's frames; the three places that
cross frames exchange:

- the temporal transformer stage runs on all T frames of a run of the
  tokens: ``frames_to_tokens`` turns [B * T/f, S, C] into [B * T, S_r, C]
  (an all-to-all), ``tokens_to_frames`` turns it back. The token axis S
  splits into runs of whole 16-token tiles (``token_runs``), so the fused
  temporal kernels E and F, which take S % 16 == 0, stay on the path at
  every level;
- the temporal (3, 1, 1) convolution reads one frame of each neighbour
  (``frames_halo``; zeros at the clip's ends, as the convolution's
  padding);
- the temporal GroupNorm's statistics sum over the group (``frames_sum``).

Each exchange is a ``torch.autograd.Function`` whose backward is its
transpose, so a training step's gradients cross the same ranks back.
Every rank of a group runs the same program in the same order, also when
a checkpointed block is recomputed in the backward, so the collectives
pair up.
"""

from __future__ import annotations

import dataclasses

import torch

from .mesh import Mesh

AXIS = "frames"
TILE = 16      # the token tile of kernels E and F


@dataclasses.dataclass(frozen=True)
class FramesShard:
    """This rank's part of a clip of ``num_frames`` frames split over the
    mesh's ``frames`` axis."""

    mesh: Mesh
    num_frames: int

    @property
    def size(self) -> int:
        return self.mesh.size(AXIS)

    @property
    def index(self) -> int:
        return self.mesh.coord(AXIS)

    @property
    def local(self) -> int:
        """Frames a rank holds."""
        return self.num_frames // self.size

    @property
    def start(self) -> int:
        """The clip index of this rank's first frame."""
        return self.index * self.local

    @property
    def frames(self) -> slice:
        return slice(self.start, self.start + self.local)


def frames_shard(mesh: Mesh | None, num_frames: int) -> FramesShard | None:
    """The shard of a ``num_frames`` clip over ``mesh``'s frames axis, or
    None when the axis is 1 (or there is no mesh). A size that does not
    divide the clip raises."""
    f = mesh.size(AXIS) if mesh is not None else 1
    if num_frames % f:
        raise ValueError(f"num_frames {num_frames} not divisible by mesh "
                         f"axis '{AXIS}'={f}")
    return FramesShard(mesh, num_frames) if f > 1 else None


def token_runs(S: int, f: int) -> list[int]:
    """The token counts of the f ranks' runs of a token axis of S: whole
    16-token tiles when S is a multiple of 16 with a tile for every rank
    (9216 = 576 tiles at f = 5: 116, 115, 115, 115, 115 tiles; 144 = 9
    tiles: 2, 2, 2, 2, 1), else tokens, the first S % f runs one longer."""
    unit = TILE if S % TILE == 0 and S // TILE >= f else 1
    base, extra = divmod(S // unit, f)
    return [(base + (i < extra)) * unit for i in range(f)]


# -- the exchanges ----------------------------------------------------------

def _to_tokens(x: torch.Tensor, fs: FramesShard, runs: list[int]
               ) -> torch.Tensor:
    """[B * T/f, S, C] -> [B * T, S_r, C]."""
    L, f = fs.local, fs.size
    B = x.shape[0] // L
    S, C = x.shape[1], x.shape[2]
    parts = x.reshape(B, L, S, C).split(runs, dim=2)
    me = runs[fs.index]
    got = fs.mesh.all_to_all(parts, [(B, L, me, C)] * f, AXIS)
    return torch.cat(got, dim=1).reshape(B * fs.num_frames, me, C)


def _to_frames(y: torch.Tensor, fs: FramesShard, runs: list[int]
               ) -> torch.Tensor:
    """[B * T, S_r, C] -> [B * T/f, S, C]."""
    L, f = fs.local, fs.size
    B = y.shape[0] // fs.num_frames
    me, C = y.shape[1], y.shape[2]
    parts = y.reshape(B, f, L, me, C).unbind(1)
    got = fs.mesh.all_to_all(parts, [(B, L, r, C) for r in runs], AXIS)
    return torch.cat(got, dim=2).reshape(B * L, sum(runs), C)


class _FramesToTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fs, runs):
        ctx.fs, ctx.runs = fs, runs
        return _to_tokens(x, fs, runs)

    @staticmethod
    def backward(ctx, g):
        return _to_frames(g.contiguous(), ctx.fs, ctx.runs), None, None


class _TokensToFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, fs, runs):
        ctx.fs, ctx.runs = fs, runs
        return _to_frames(y, fs, runs)

    @staticmethod
    def backward(ctx, g):
        return _to_tokens(g.contiguous(), ctx.fs, ctx.runs), None, None


def frames_to_tokens(x: torch.Tensor, fs: FramesShard,
                     runs: list[int]) -> torch.Tensor:
    """This rank's frames of every token, [B * T/f, S, C], to every frame
    of this rank's run of tokens, [B * T, runs[index], C]: an all-to-all
    over the frames group (its backward: the inverse all-to-all)."""
    return _FramesToTokens.apply(x, fs, runs)


def tokens_to_frames(y: torch.Tensor, fs: FramesShard,
                     runs: list[int]) -> torch.Tensor:
    """The inverse of ``frames_to_tokens``."""
    return _TokensToFrames.apply(y, fs, runs)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, dim, mesh):
        ctx.k, ctx.dim, ctx.mesh, ctx.L = k, dim, mesh, x.shape[dim]
        return mesh.halo(x, k, dim, AXIS)

    @staticmethod
    def backward(ctx, g):
        # the halos' gradients go back to their owners and add there
        k, dim, mesh, L = ctx.k, ctx.dim, ctx.mesh, ctx.L
        n, i = mesh.size(AXIS), mesh.coord(AXIS)
        g = g.contiguous()
        grad = g.narrow(dim, k, L).clone()
        edge = list(g.shape)
        edge[dim] = k
        empty = [0] * len(edge)
        sends = [g.new_zeros(empty) for _ in range(n)]
        shapes = [empty] * n
        if i > 0:
            sends[i - 1] = g.narrow(dim, 0, k)
            shapes[i - 1] = edge
        if i < n - 1:
            sends[i + 1] = g.narrow(dim, k + L, k)
            shapes[i + 1] = edge
        got = mesh.all_to_all(sends, shapes, AXIS)
        if i > 0:          # the previous rank's after-halo: my first k
            grad.narrow(dim, 0, k).add_(got[i - 1])
        if i < n - 1:      # the next rank's before-halo: my last k
            grad.narrow(dim, L - k, k).add_(got[i + 1])
        return grad, None, None, None


def frames_halo(x: torch.Tensor, k: int, dim: int, fs: FramesShard
                ) -> torch.Tensor:
    """``x`` with ``k`` frames (along ``dim``) of each neighbour on either
    side, zeros at the clip's ends (``Mesh.halo``); differentiable."""
    return _Halo.apply(x, k, dim, fs.mesh)


class _FramesSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone()
        mesh.all_reduce_([out], axis=AXIS)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        ctx.mesh.all_reduce_([out], axis=AXIS)
        return out, None


def frames_sum(x: torch.Tensor, fs: FramesShard) -> torch.Tensor:
    """The sum of ``x`` over the frames group, on every rank of it; its
    backward is the same sum of the gradients."""
    return _FramesSum.apply(x, fs.mesh)


class _ClipFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone()
        mesh.broadcast_([out], src=0, axis=AXIS)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone()
        ctx.mesh.all_reduce_([out], axis=AXIS)
        if ctx.mesh.coord(AXIS) != 0:
            out.zero_()
        return out, None


def clip_first_frame(x: torch.Tensor, fs: FramesShard) -> torch.Tensor:
    """Per clip, the value of the clip's frame 0: ``x`` is [B * T/f, ...]
    of this rank's frames; frames rank 0 holds frame 0 and broadcasts its
    [B, ...] (the backward sums the gradients back to it)."""
    first = x.reshape(-1, fs.local, *x.shape[1:])[:, 0].contiguous()
    return _ClipFirst.apply(first, fs.mesh)
