"""Tile-binned Gaussian rasterization: worklist, compositing and its backward.

Port of the TPU raster (``street_crafter_tpu/ops/gs_raster_fused.py``: K1
``_compact_kernel`` and K2 ``_composite_kernel``;
``street_crafter_tpu/ops/gs_raster_train.py``: K3 ``_composite_bwd_kernel``)
in gsplat's form rather than the TPU's: an exact (tile, depth)-sorted
worklist over every 16x16 tile a splat's 3-sigma box overlaps, then
front-to-back compositing per pixel, and its exact adjoint. No capacity, so
no splat is ever dropped.

Rules kept from the reference raster (``ops/gs_raster.py``):
  sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, skipped when sigma < 0;
  alpha = min(0.999, opacity exp(-sigma)), skipped when alpha < 1/255;
  a pixel stops before the splat that would bring T to <= 1e-4 (gsplat's
  rule, the train kernel's ``stop_lt``); alpha out = 1 - T.

Each step has two implementations in this module:
  * ``tile_worklist_reference`` / ``composite_reference`` /
    ``composite_backward_reference``: plain torch, used for CPU tensors (the
    tests) and as the oracle on the card;
  * the CUDA kernels of ``csrc/gs_raster.cu`` (A, B and C), used for CUDA
    tensors. They are compiled with nvcc on first use; a failed build or
    launch raises.
Kernel A also gives the order in which B and C take the tiles (longest
list first). Kernels B and C read the lists as pair records
(``pair_records``: one 16-byte aligned record per (tile, splat) pair,
packed by a kernel once per rasterization and shared by B and C) and skip,
per warp of 16x2 pixels, the pairs that no pixel of the warp can take
(``warp_cull_reference`` is the cull's plain version). ``launches`` counts
the calls of each implementation.
``rasterize_pixels`` is differentiable (``torch.autograd.Function``) when
an input needs a gradient; its ``absgrad_sink`` input receives the
per-splat sums of |dL/du| and |dL/dv| over pixels as its gradient (gsplat
``absgrad=True``, the JAX ``_abs_sink_hook``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import torch

from ..parallel.kernel_shard import assert_no_context_axes
from . import cuda_build

TILE = 16
ALPHA_CLAMP = 0.999
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4
MAX_CHANNELS = 7
WARPS = TILE * TILE // 32   # warps of a tile in kernels B and C, 16x2 px each
# pair record fields (floats), then the channels, zero-padded to 16 bytes
REC_U, REC_V, REC_A, REC_B, REC_C, REC_OPACITY, REC_THRESHOLD = range(7)
REC_COLORS = 7
# the cull's margins in sigma (derived beside kCullAbs / kCullRel in
# csrc/gs_raster.cu): absolute, and relative to the rectangle's largest
# |a| dx^2 + |c| dy^2 + 2 |b| dx dy
CULL_ABS = 1e-5
CULL_REL = 2.0 ** -20


# calls per implementation: "tile_worklist", "pair_records", "composite"
# and "composite_backward" (CUDA kernels A, the pack, B and C),
# "tile_worklist_reference", "composite_reference" and
# "composite_backward_reference" (plain)
launches: collections.Counter = collections.Counter()
# columns of the [N, 8 + C] gradient rows of the compositing backward
GRAD_U, GRAD_V, GRAD_A, GRAD_B, GRAD_C, GRAD_OPACITY = range(6)
GRAD_ABS = slice(6, 8)      # sum over pixels of |dL/du|, |dL/dv|
GRAD_COLORS = 8             # then the C colour channels


def reset_launch_counts() -> None:
    launches.clear()


class TileWorklist(NamedTuple):
    tile_ids: torch.Tensor   # [P] int32, ascending
    gauss_ids: torch.Tensor  # [P] int32, depth order within a tile
    ranges: torch.Tensor     # [tiles_y * tiles_x, 2] int32 [start, end)
    n_pairs: int
    # [tiles_y * tiles_x] int64: the tiles by list length descending, tile
    # index ascending on ties (the order kernels B and C take them in)
    order: torch.Tensor


class RasterOutput(NamedTuple):
    colors: torch.Tensor     # [H, W, C]
    alpha: torch.Tensor      # [H, W]
    n_pairs: int             # (tile, splat) pairs composited


def tile_grid(width: int, height: int) -> tuple[int, int]:
    return -(-width // TILE), -(-height // TILE)


def record_floats(channels: int) -> int:
    """Floats per pair record: 7 + C, rounded up to a multiple of 4."""
    return (REC_COLORS + channels + 3) // 4 * 4


def _uses_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"gs_raster supports cpu and cuda tensors, not {dev}")


def _depth_bits(depths: torch.Tensor) -> torch.Tensor:
    return depths.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def tile_worklist_reference(u, v, radii, depths, valid, width: int,
                            height: int) -> TileWorklist:
    """Vectorised bbox-overlap test (per axis) + stable (tile, depth) sort;
    the tile order is a stable descending sort of the list lengths."""
    launches["tile_worklist_reference"] += 1
    tw, th = tile_grid(width, height)
    dev = u.device
    n = u.shape[0]
    active = valid & (radii > 0)
    ox = torch.arange(tw, dtype=torch.float32, device=dev) * TILE
    oy = torch.arange(th, dtype=torch.float32, device=dev) * TILE
    col = (((u - radii)[:, None] < ox + TILE) & ((u + radii)[:, None] > ox)
           & active[:, None])                                   # [N, tw]
    row = ((v - radii)[:, None] < oy + TILE) & ((v + radii)[:, None] > oy)
    nx = col.sum(1)
    ny = row.sum(1)
    tx0 = col.to(torch.uint8).argmax(1)    # first overlapping column
    ty0 = row.to(torch.uint8).argmax(1)
    counts = nx * ny
    gid = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    starts = torch.cumsum(counts, 0) - counts
    k = torch.arange(gid.shape[0], device=dev) - starts[gid]
    nxg = nx[gid]
    tile = (ty0[gid] + k // nxg) * tw + tx0[gid] + k % nxg
    key = (tile.to(torch.int64) << 32) | _depth_bits(depths)[gid]
    key, order = torch.sort(key, stable=True)
    tile_ids = (key >> 32).to(torch.int32)
    per_tile = torch.bincount(tile_ids.to(torch.int64), minlength=tw * th)
    end = torch.cumsum(per_tile, 0)
    ranges = torch.stack([end - per_tile, end], 1) * (per_tile > 0)[:, None]
    ranges = ranges.to(torch.int32)     # empty tiles: [0, 0)
    by_length = torch.sort(per_tile, descending=True, stable=True)[1]
    return TileWorklist(tile_ids, gid[order].to(torch.int32), ranges,
                        int(key.shape[0]), by_length)


class _TileSplats(NamedTuple):
    """One tile's list, recomputed as kernels B and C see it: [K, 256]
    per (splat, pixel) of the tile, pixels row-major."""
    g: torch.Tensor          # [K] splat ids
    dx: torch.Tensor
    dy: torch.Tensor
    sigma: torch.Tensor
    raw: torch.Tensor        # opacity exp(-sigma), before the clamp
    alpha: torch.Tensor      # 0 where skipped
    keep: torch.Tensor       # inside the pixel's prefix (before the stop)
    t_before: torch.Tensor   # T in front of the splat
    t_final: torch.Tensor    # [256] T after the prefix
    rows: slice
    cols: slice


def _tiles(wl: TileWorklist, u, v, conic_a, conic_b, conic_c, opacities,
           width: int, cull: torch.Tensor | None = None):
    """Yield the non-empty tiles of ``wl`` with their [K, 256] alpha and
    the stop rule's transmittance scan. ``cull`` ([P, 8] bool, from
    ``warp_cull_reference``) sets alpha to 0 for every pixel of a warp
    that culled the pair, as kernels B and C skip it."""
    tw, _ = tile_grid(width, 1)
    dev = u.device
    ly, lx = torch.meshgrid(
        torch.arange(TILE, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(TILE, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    lx, ly = lx.reshape(-1), ly.reshape(-1)
    for t, (s, e) in enumerate(wl.ranges.tolist()):
        if s == e:
            continue
        g = wl.gauss_ids[s:e].to(torch.int64)
        ty, tx = divmod(t, tw)
        dx = (tx * TILE + lx)[None, :] - u[g][:, None]          # [K, 256]
        dy = (ty * TILE + ly)[None, :] - v[g][:, None]
        sigma = (0.5 * (conic_a[g][:, None] * dx * dx
                        + conic_c[g][:, None] * dy * dy)
                 + conic_b[g][:, None] * dx * dy)
        raw = opacities[g][:, None] * torch.exp(-sigma)
        alpha = torch.clamp(raw, max=ALPHA_CLAMP)
        alpha = torch.where((sigma >= 0) & (alpha >= ALPHA_MIN), alpha, 0.0)
        if cull is not None:
            alpha = torch.where(cull[s:e].repeat_interleave(32, 1), 0.0,
                                alpha)
        # T after each splat: a scan along dim 0 multiplies sequentially
        # per pixel, rounding exactly like the kernel's T *= 1 - alpha, so
        # both stop at the same splat
        t_after = torch.cumprod(1.0 - alpha, 0)
        keep = t_after > T_STOP                      # a prefix per pixel
        t_before = torch.cat([torch.ones_like(t_after[:1]), t_after[:-1]])
        t_final = torch.where(keep, t_after, 1.0).amin(0)
        yield _TileSplats(g, dx, dy, sigma, raw, alpha, keep, t_before,
                          t_final, slice(ty * TILE, (ty + 1) * TILE),
                          slice(tx * TILE, (tx + 1) * TILE))


def composite_reference(wl: TileWorklist, u, v, conic_a, conic_b, conic_c,
                        colors, opacities, width: int, height: int,
                        train: bool = False, *,
                        cull: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, ...]:
    """Python loop over tiles; per tile a vectorised [K, 256] alpha and an
    inclusive transmittance scan for the stop rule. Returns (colours [H, W,
    C], alpha [H, W]) and, with ``train``, also the final T [H, W] and the
    index one past the last contributing splat in the tile's list (int32
    [H, W], 0 where none). ``cull``: see ``_tiles`` (the tests' check that
    the cull changes nothing)."""
    launches["composite_reference"] += 1
    tw, th = tile_grid(width, height)
    dev = u.device
    C = colors.shape[1]
    out = torch.zeros((th * TILE, tw * TILE, C), dtype=torch.float32,
                      device=dev)
    trans = torch.ones((th * TILE, tw * TILE), dtype=torch.float32, device=dev)
    last = torch.zeros((th * TILE, tw * TILE), dtype=torch.int32, device=dev)
    for ts in _tiles(wl, u, v, conic_a, conic_b, conic_c, opacities, width,
                     cull):
        w = torch.where(ts.keep, ts.alpha * ts.t_before, 0.0)
        out[ts.rows, ts.cols] = (w.T @ colors[ts.g]).reshape(TILE, TILE, C)
        trans[ts.rows, ts.cols] = ts.t_final.reshape(TILE, TILE)
        if train:
            pos = torch.arange(1, ts.g.shape[0] + 1, dtype=torch.int32,
                               device=dev)[:, None]
            hit = ts.keep & (ts.alpha > 0)
            last[ts.rows, ts.cols] = torch.where(hit, pos, 0).amax(0).reshape(
                TILE, TILE)
    res = (out[:height, :width], 1.0 - trans[:height, :width])
    if train:
        res += (trans[:height, :width].contiguous(),
                last[:height, :width].contiguous())
    return res


def composite_backward_reference(wl: TileWorklist, u, v, conic_a, conic_b,
                                 conic_c, colors, opacities, width: int,
                                 height: int, grad_colors: torch.Tensor,
                                 grad_alpha: torch.Tensor, *,
                                 cull: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Gradients of sum(grad_colors * colours) + sum(grad_alpha * alpha)
    w.r.t. each splat: [N, 8 + C] rows (u, v, conic a, b, c, opacity,
    sum |dL/du|, sum |dL/dv|, colours). Recomputes each tile as
    ``composite_reference`` does, then per pair the adjoint of the forward:
    dalpha_j = T_j (c_j.g_c) - (S_j - g_a T_N) / (1 - alpha_j) with S_j the
    suffix sum of w c.g_c behind splat j; zero where a splat was skipped,
    stopped or its alpha clamped at 0.999. ``cull``: see ``_tiles``."""
    launches["composite_backward_reference"] += 1
    tw, th = tile_grid(width, height)
    dev = u.device
    n, C = colors.shape
    gc = torch.zeros((th * TILE, tw * TILE, C), dtype=torch.float32,
                     device=dev)
    ga = torch.zeros((th * TILE, tw * TILE), dtype=torch.float32, device=dev)
    gc[:height, :width] = grad_colors
    ga[:height, :width] = grad_alpha
    grads = torch.zeros((n, GRAD_COLORS + C), dtype=torch.float32, device=dev)
    for ts in _tiles(wl, u, v, conic_a, conic_b, conic_c, opacities, width,
                     cull):
        g = ts.g
        gcp = gc[ts.rows, ts.cols].reshape(-1, C)               # [256, C]
        gap = ga[ts.rows, ts.cols].reshape(-1)                  # [256]
        hit = ts.keep & (ts.alpha > 0)
        w = torch.where(hit, ts.alpha * ts.t_before, 0.0)       # [K, 256]
        cg = colors[g] @ gcp.T                                  # c_j . g_c
        wc = w * cg
        suffix = torch.flip(torch.cumsum(torch.flip(wc, (0,)), 0), (0,)) - wc
        dalpha = (ts.t_before * cg
                  - (suffix - gap * ts.t_final) / (1.0 - ts.alpha))
        # gate before any product: the clamp and the skips pass no gradient
        active = hit & (ts.raw < ALPHA_CLAMP)
        dsig = torch.where(active, -ts.alpha * dalpha, 0.0)
        dx = torch.where(active, ts.dx, 0.0)
        dy = torch.where(active, ts.dy, 0.0)
        a, b, c = (x[g][:, None] for x in (conic_a, conic_b, conic_c))
        du = torch.where(active, -dsig * (a * dx + b * dy), 0.0)
        dv = torch.where(active, -dsig * (c * dy + b * dx), 0.0)
        dopa = torch.where(active, dalpha * torch.exp(-ts.sigma), 0.0)
        rows = torch.stack([
            du.sum(1), dv.sum(1), (0.5 * dx * dx * dsig).sum(1),
            (dx * dy * dsig).sum(1), (0.5 * dy * dy * dsig).sum(1),
            dopa.sum(1), du.abs().sum(1), dv.abs().sum(1)], 1)
        grads.index_add_(0, g, torch.cat([rows, w @ gcp], 1))
    return grads


def cull_threshold_reference(conic_a, conic_b, conic_c, opacities
                             ) -> torch.Tensor:
    """The cull threshold t of each splat, as kernel B's records hold it:
    ln(255 opacity) + CULL_ABS, -inf (always culled) for an opacity below
    1/255, +inf (never culled) for a conic that is not positive definite."""
    pd = (conic_a > 0) & (conic_a * conic_c - conic_b * conic_b > 0)
    t = torch.where(pd, torch.log(255 * opacities) + CULL_ABS, float("inf"))
    return torch.where(opacities < ALPHA_MIN, float("-inf"), t)


def pair_records_reference(wl: TileWorklist, u, v, conic_a, conic_b,
                           conic_c, colors, opacities) -> torch.Tensor:
    """[P, record_floats(C)] f32: per (tile, splat) pair in list order its
    splat's u, v, a, b, c, opacity, cull threshold and C channels, then
    zeros (the kernels' pack)."""
    g = wl.gauss_ids.to(torch.int64)
    C = colors.shape[1]
    cols = [x[g][:, None] for x in (u, v, conic_a, conic_b, conic_c,
                                    opacities)]
    cols.append(cull_threshold_reference(conic_a, conic_b, conic_c,
                                         opacities)[g][:, None])
    rec = torch.cat(cols + [colors[g]], 1)
    return torch.nn.functional.pad(rec, (0, record_floats(C) - rec.shape[1]))


def warp_cull_reference(wl: TileWorklist, u, v, conic_a, conic_b, conic_c,
                        opacities, width: int) -> torch.Tensor:
    """[P, 8] bool, the cull of kernels B and C: True where warp w of the
    pair's tile (pixel rows 2w and 2w + 1, 16 columns) skips the pair
    because no pixel centre of its rectangle can reach alpha >= 1/255. Per
    row at dy the least sigma over the columns is at the vertex -b dy / a
    clamped to [dx_lo, dx_hi]; the pair is culled iff it exceeds the
    threshold plus CULL_REL times the rectangle's largest |a| dx^2 + |c| dy^2
    + 2 |b| dx dy on both rows. Operation for operation the kernels' f32
    test, so it counts what they skip. Not on any main path."""
    tw, _ = tile_grid(width, 1)
    dev = u.device
    tile = wl.tile_ids.to(torch.int64)
    g = wl.gauss_ids.to(torch.int64)
    fx0 = ((tile % tw) * TILE).to(torch.float32) + 0.5          # [P]
    rows = 2 * torch.arange(WARPS, device=dev)
    fy0 = ((tile // tw)[:, None] * TILE + rows).to(torch.float32) + 0.5
    uu, vv = u[g][:, None], v[g][:, None]
    a, b, c = (x[g][:, None] for x in (conic_a, conic_b, conic_c))
    t = cull_threshold_reference(conic_a, conic_b, conic_c,
                                 opacities)[g][:, None]
    lo = (fx0[:, None] - uu)
    hi = ((fx0[:, None] + (TILE - 1)) - uu)
    dy0 = fy0 - vv
    dy1 = (fy0 + 1.0) - vv
    X = torch.maximum(lo.abs(), hi.abs())
    Y = torch.maximum(dy0.abs(), dy1.abs())
    m = (a.abs() * X * X + c.abs() * Y * Y) + 2.0 * b.abs() * X * Y
    thr = t + CULL_REL * m

    def row_min(dy):
        x = torch.clamp(-(b * dy) / a, lo, hi)
        return 0.5 * (a * x * x + c * dy * dy) + b * x * dy

    return (row_min(dy0) > thr) & (row_min(dy1) > thr)


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("gs_raster")
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "sc_worklist_count": [P, P, P, P, I, I, I, P, P, P, P, P],
        "sc_tile_order": [P, I, P, P, P],
        "sc_worklist_emit": [P, P, P, P, P, I, I, I, P, P, P, P, P, P, P],
        "sc_pair_records": [P, P, P, P, P, P, P, P, I, ctypes.c_longlong, I,
                            P, P, P],
        "sc_composite": [P, P, P, P, I, I, I, I, I, P, P, P, P, P],
        "sc_composite_backward": [P, P, P, P, P, I, I, I, I, I, P, P, P, P,
                                  P, P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    lib.sc_error_string.argtypes = [I]
    lib.sc_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.sc_error_string(err).decode()} ({err})")


# the raster kernels read their arrays element by element: no alignment
_require = functools.partial(cuda_build.require, align=1)


class _Bins(NamedTuple):
    """Kernel A up to its host synchronisation (``_worklist_bins``), and
    what the rest needs, taken before the synchronisation so that the host
    does little between it and the emit's launch."""
    scratch: torch.Tensor    # [tiles + 1] int32: bucket counters, tile counter
    ranges: torch.Tensor
    order: torch.Tensor
    n_pairs: int
    # the emit's first arguments: the pointers of u, v, radii, valid and
    # depths (their caller keeps them until the emit is launched), n, tw, th
    emit_args: tuple


def _geometry(u, v, radii, depths, valid) -> list[int]:
    n = u.shape[0]
    f32 = torch.float32
    return [_require(u, "u", f32, (n,)), _require(v, "v", f32, (n,)),
            _require(radii, "radii", f32, (n,)),
            _require(valid, "valid", torch.bool, (n,)),
            _require(depths, "depths", f32, (n,))]


def _worklist_bins(u, v, radii, depths, valid, width, height) -> _Bins:
    """Count and scan (every tile's range and the pair total), then the
    tile order, launched after the copy of the total to the host so that
    it runs while the host waits: the one synchronisation of kernel A."""
    lib = _library()
    tw, th = tile_grid(width, height)
    n = u.shape[0]
    geometry = _geometry(u, v, radii, depths, valid)
    dev = u.device
    scratch = torch.empty(tw * th + 1, dtype=torch.int32, device=dev)
    ranges = torch.empty((tw * th, 2), dtype=torch.int32, device=dev)
    order_keys = torch.empty(tw * th, dtype=torch.int64, device=dev)
    order = torch.empty(tw * th, dtype=torch.int64, device=dev)
    info = torch.empty(2, dtype=torch.int64, device=dev)
    host = torch.empty(2, dtype=torch.int64, pin_memory=True)
    stream = torch.cuda.current_stream(dev)
    _check(lib, lib.sc_worklist_count(
        *geometry[:4], n, tw, th, scratch.data_ptr(), ranges.data_ptr(),
        order_keys.data_ptr(), info.data_ptr(), stream.cuda_stream),
        "worklist_count")
    launches["tile_worklist"] += 1
    host.copy_(info, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(stream)
    _check(lib, lib.sc_tile_order(order_keys.data_ptr(), tw * th,
                                  info.data_ptr(), order.data_ptr(),
                                  stream.cuda_stream), "tile_order")
    copied.synchronize()             # the host sync: the total sizes lists
    n_pairs = host.tolist()[0]
    if n_pairs >= 2 ** 31:
        raise RuntimeError(f"{n_pairs} (tile, splat) pairs exceed int32 ids")
    return _Bins(scratch, ranges, order, n_pairs, (*geometry, n, tw, th))


def _worklist_lists(bins: _Bins) -> TileWorklist:
    """The emit into per-tile buckets and the per-tile sort: no host
    synchronisation, and replayable (a CUDA graph) on the same ``bins``
    while the inputs it was counted from live."""
    dev = bins.ranges.device
    tile_ids = torch.empty(bins.n_pairs, dtype=torch.int32, device=dev)
    gauss_ids = torch.empty(bins.n_pairs, dtype=torch.int32, device=dev)
    if bins.n_pairs:
        keys = torch.empty(bins.n_pairs, dtype=torch.int64, device=dev)
        lib = _library()
        _check(lib, lib.sc_worklist_emit(
            *bins.emit_args, bins.scratch.data_ptr(), bins.ranges.data_ptr(),
            bins.order.data_ptr(), keys.data_ptr(), tile_ids.data_ptr(),
            gauss_ids.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "worklist_emit")
    return TileWorklist(tile_ids, gauss_ids, bins.ranges, bins.n_pairs,
                        bins.order)


def _tile_worklist_cuda(u, v, radii, depths, valid, width, height
                        ) -> TileWorklist:
    return _worklist_lists(_worklist_bins(u, v, radii, depths, valid, width,
                                          height))


def _pair_records_cuda(wl: TileWorklist, u, v, conic_a, conic_b, conic_c,
                       colors, opacities) -> torch.Tensor:
    lib = _library()
    n, C = colors.shape
    f32 = torch.float32
    ptrs = [_require(wl.gauss_ids, "gauss_ids", torch.int32, (wl.n_pairs,)),
            _require(u, "u", f32, (n,)), _require(v, "v", f32, (n,)),
            _require(conic_a, "conic_a", f32, (n,)),
            _require(conic_b, "conic_b", f32, (n,)),
            _require(conic_c, "conic_c", f32, (n,)),
            _require(colors, "colors", f32, (n, C)),
            _require(opacities, "opacities", f32, (n,))]
    # torch's allocations are 256-byte aligned: what the bulk copies need
    rec = torch.empty((wl.n_pairs, record_floats(C)), dtype=f32,
                      device=u.device)
    table = torch.empty((n, record_floats(C)), dtype=f32, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    _check(lib, lib.sc_pair_records(*ptrs, n, wl.n_pairs, C,
                                    table.data_ptr(), rec.data_ptr(),
                                    stream), "pair_records")
    if wl.n_pairs:                   # no pairs: nothing was launched
        launches["pair_records"] += 1
    return rec


def _records(rec, wl: TileWorklist, u, v, conic_a, conic_b, conic_c, colors,
             opacities) -> torch.Tensor:
    """The pair records B and C read: ``rec`` checked (16-byte aligned, for
    the bulk copies), or a new pack when the caller has none. The caller
    keeps the tensor until its kernel is launched."""
    if rec is None:
        return _pair_records_cuda(wl, u, v, conic_a, conic_b, conic_c,
                                  colors, opacities)
    _require(rec, "records", torch.float32,
             (wl.n_pairs, record_floats(colors.shape[1])), align=16)
    return rec


def _composite_cuda(wl: TileWorklist, u, v, conic_a, conic_b, conic_c,
                    colors, opacities, width, height, train, records):
    lib = _library()
    tw, th = tile_grid(width, height)
    C = colors.shape[1]
    ranges = _require(wl.ranges, "ranges", torch.int32, (tw * th, 2))
    order = _require(wl.order, "order", torch.int64, (tw * th,))
    rec = _records(records, wl, u, v, conic_a, conic_b, conic_c, colors,
                   opacities)
    dev = u.device
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((height, width, C), dtype=torch.float32, device=dev)
    alpha = torch.empty((height, width), dtype=torch.float32, device=dev)
    res = (out, alpha)
    state = [None, None]
    if train:
        res += (torch.empty((height, width), dtype=torch.float32, device=dev),
                torch.empty((height, width), dtype=torch.int32, device=dev))
        state = [res[2].data_ptr(), res[3].data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check(lib, lib.sc_composite(ranges, rec.data_ptr(), order,
                                 counter.data_ptr(), C, width, height, tw, th,
                                 out.data_ptr(), alpha.data_ptr(), *state,
                                 stream), "composite")
    launches["composite"] += 1
    return res


def _composite_backward_cuda(wl: TileWorklist, u, v, conic_a, conic_b,
                             conic_c, colors, opacities, width, height,
                             final_T, last, grad_colors, grad_alpha, records):
    lib = _library()
    tw, th = tile_grid(width, height)
    n, C = colors.shape
    ranges = _require(wl.ranges, "ranges", torch.int32, (tw * th, 2))
    state = [_require(final_T, "final_T", torch.float32, (height, width)),
             _require(last, "last", torch.int32, (height, width)),
             _require(grad_colors, "grad_colors", torch.float32,
                      (height, width, C)),
             _require(grad_alpha, "grad_alpha", torch.float32,
                      (height, width))]
    order = _require(wl.order, "order", torch.int64, (tw * th,))
    rec = _records(records, wl, u, v, conic_a, conic_b, conic_c, colors,
                   opacities)
    counter = torch.zeros(1, dtype=torch.int32, device=u.device)
    grads = torch.zeros((n, GRAD_COLORS + C), dtype=torch.float32,
                        device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    _check(lib, lib.sc_composite_backward(
        ranges, wl.gauss_ids.data_ptr(), rec.data_ptr(), order,
        counter.data_ptr(), C, width, height, tw, th, *state,
        grads.data_ptr(), stream), "composite_backward")
    launches["composite_backward"] += 1
    return grads


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------

def tile_worklist(u, v, radii, depths, valid, width: int, height: int
                  ) -> TileWorklist:
    """Exact per-16x16-tile splat lists, depth-sorted, and the tile order
    (kernel A on CUDA: one host synchronisation, to size the lists)."""
    if _uses_kernel(u, v, radii, depths, valid):
        with torch.cuda.device(u.device):
            return _tile_worklist_cuda(u, v, radii, depths, valid, width,
                                       height)
    return tile_worklist_reference(u, v, radii, depths, valid, width, height)


def pair_records(wl: TileWorklist, u, v, conic_a, conic_b, conic_c, colors,
                 opacities) -> torch.Tensor:
    """The pair records kernels B and C read (see
    ``pair_records_reference``): packed by a kernel on CUDA. A
    rasterization packs once and hands the records to B and C; B and C
    pack themselves when called without them."""
    if _uses_kernel(u, v, conic_a, conic_b, conic_c, colors, opacities,
                    wl.gauss_ids):
        with torch.cuda.device(u.device):
            return _pair_records_cuda(wl, u, v, conic_a, conic_b, conic_c,
                                      colors, opacities)
    return pair_records_reference(wl, u, v, conic_a, conic_b, conic_c,
                                  colors, opacities)


def composite(wl: TileWorklist, u, v, conic_a, conic_b, conic_c, colors,
              opacities, width: int, height: int, train: bool = False, *,
              records: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, ...]:
    """Front-to-back compositing of each tile's list (kernel B on CUDA).
    With ``train`` also the final T and the last-contributor index (see
    ``composite_reference``), the backward's starting point. ``records``:
    ``pair_records`` of these inputs (packed here when not given; the plain
    version reads none)."""
    if _uses_kernel(u, v, conic_a, conic_b, conic_c, colors, opacities,
                    wl.ranges):
        with torch.cuda.device(u.device):
            return _composite_cuda(wl, u, v, conic_a, conic_b, conic_c,
                                   colors, opacities, width, height, train,
                                   records)
    return composite_reference(wl, u, v, conic_a, conic_b, conic_c, colors,
                               opacities, width, height, train)


def composite_backward(wl: TileWorklist, u, v, conic_a, conic_b, conic_c,
                       colors, opacities, width: int, height: int, final_T,
                       last, grad_colors, grad_alpha, *,
                       records: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 8 + C] gradient rows of compositing (kernel C on CUDA; the plain
    version recomputes T and the stop from scratch and ignores ``final_T``,
    ``last`` and ``records``). ``records``: those kernel B read in the
    forward (packed here when not given)."""
    if _uses_kernel(u, v, conic_a, conic_b, conic_c, colors, opacities,
                    wl.ranges, grad_colors, grad_alpha):
        with torch.cuda.device(u.device):
            return _composite_backward_cuda(
                wl, u, v, conic_a, conic_b, conic_c, colors, opacities,
                width, height, final_T, last, grad_colors, grad_alpha,
                records)
    return composite_backward_reference(wl, u, v, conic_a, conic_b, conic_c,
                                        colors, opacities, width, height,
                                        grad_colors, grad_alpha)


class _Composite(torch.autograd.Function):
    """Compositing with kernel C (or its plain version) as its backward.
    The worklist is computed outside, without gradient. ``sink`` [N, 2] is
    not read; its gradient is the absgrad columns. On CUDA the forward
    packs the pair records once; B reads them, and the backward's C reads
    the same records and the worklist's tile order."""

    @staticmethod
    def forward(ctx, wl, width, height, u, v, conic_a, conic_b, conic_c,
                colors, opacities, sink):
        del sink
        rec = (pair_records(wl, u, v, conic_a, conic_b, conic_c, colors,
                            opacities) if u.is_cuda else None)
        out, alpha, final_T, last = composite(
            wl, u, v, conic_a, conic_b, conic_c, colors, opacities, width,
            height, train=True, records=rec)
        ctx.save_for_backward(u, v, conic_a, conic_b, conic_c, colors,
                              opacities, final_T, last)
        ctx.wl, ctx.size, ctx.records = wl, (width, height), rec
        return out, alpha

    @staticmethod
    def backward(ctx, grad_out, grad_alpha):
        u, v, ca, cb, cc, colors, opa, final_T, last = ctx.saved_tensors
        width, height = ctx.size
        if grad_out is None:
            grad_out = torch.zeros((height, width, colors.shape[1]),
                                   dtype=torch.float32, device=u.device)
        if grad_alpha is None:
            grad_alpha = torch.zeros((height, width), dtype=torch.float32,
                                     device=u.device)
        g = composite_backward(ctx.wl, u, v, ca, cb, cc, colors, opa, width,
                               height, final_T, last,
                               grad_out.contiguous(), grad_alpha.contiguous(),
                               records=ctx.records)
        return (None, None, None, g[:, GRAD_U], g[:, GRAD_V], g[:, GRAD_A],
                g[:, GRAD_B], g[:, GRAD_C], g[:, GRAD_COLORS:],
                g[:, GRAD_OPACITY], g[:, GRAD_ABS])


def rasterize_pixels(u, v, conic_a, conic_b, conic_c, colors, opacities,
                     depths, valid, radii, width: int, height: int,
                     tile_size: int = TILE,
                     absgrad_sink: torch.Tensor | None = None
                     ) -> RasterOutput:
    """Composite [N] projected splats with [N, C] channels (C <= 7) into
    (colors [H, W, C], alpha [H, W]). CPU tensors take the plain versions,
    CUDA tensors the kernels. Differentiable in u, v, the conic, colours,
    opacities and ``absgrad_sink`` ([N, 2] zeros, whose gradient is the
    per-splat sum over pixels of |dL/du| and |dL/dv|) when one of them
    requires a gradient; then the forward also keeps the backward's state
    and the backward runs kernel C. Depths, valid and radii only bin."""
    if tile_size != TILE:
        raise ValueError(f"tile_size must be {TILE}, got {tile_size}")
    # the kernels' leading dim is the splat / tile axis, never a batch axis
    assert_no_context_axes("rasterize_pixels")
    if not 1 <= colors.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"1..{MAX_CHANNELS} channels, got {colors.shape}")
    diff = (u, v, conic_a, conic_b, conic_c, colors, opacities)
    if absgrad_sink is not None:
        diff += (absgrad_sink,)
    with torch.no_grad():
        wl = tile_worklist(u, v, radii, depths, valid, width, height)
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
        if absgrad_sink is None:
            absgrad_sink = torch.zeros((u.shape[0], 2), dtype=torch.float32,
                                       device=u.device)
        out, alpha = _Composite.apply(wl, width, height, u, v, conic_a,
                                      conic_b, conic_c, colors, opacities,
                                      absgrad_sink)
    else:
        out, alpha = composite(wl, u, v, conic_a, conic_b, conic_c, colors,
                               opacities, width, height)
    return RasterOutput(out, alpha, wl.n_pairs)
