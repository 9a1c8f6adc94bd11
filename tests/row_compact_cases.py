"""Candidate sets at the edges of the row-compaction kernel's chunks
(``street_crafter_tpu_torch/ops/row_compact.py``), shared by the CPU tests
and the ``cuda`` ones. numpy only: no JAX, no torch.

A set is [T, kc, 11] float32: values from a normal draw, depth (column 8)
sorted in [1, 100), the y span [y0, y1) in columns 9 and 10 chosen so that a
candidate meets a chosen run of the 8 16-px rows of its 128-px coarse tile
(coarse tile t starts at y = t // 13 * 128), or none of them.
"""

import numpy as np

A, DEPTH, Y0, Y1 = 11, 8, 9, 10
TILES_X, COARSE, ROW, ROWS, KF = 13, 128, 16, 8, 1024
# the sets named by ``chunk_case``; "kc640" has 640 candidates a tile for
# blocks of 128 and 768 for blocks of 256
CASES = ("kf_at_edges", "kf_mid_chunk", "dead_edges", "rowbatch_one_open",
         "kc640", "one_tile")


def base(T: int, kc: int, seed: int) -> np.ndarray:
    """Candidates that meet no row, depth-sorted and alive."""
    rng = np.random.default_rng(seed)
    cand = rng.normal(size=(T, kc, A)).astype(np.float32)
    cand[..., DEPTH] = np.sort(rng.uniform(1, 100, (T, kc)), 1)
    ty0 = (np.arange(T) // TILES_X * COARSE).astype(np.float32)[:, None]
    cand[..., Y0] = ty0 - 50.0
    cand[..., Y1] = ty0 - 50.0
    return cand


def meet(cand: np.ndarray, t: int, j, lo, hi) -> None:
    """Candidates ``j`` of tile ``t`` meet rows ``lo`` .. ``hi`` (inclusive)
    and no other."""
    ty0 = np.float32(t // TILES_X * COARSE)
    cand[t, j, Y0] = ty0 + np.asarray(lo, np.float32) * ROW + 0.5
    cand[t, j, Y1] = ty0 + np.asarray(hi, np.float32) * ROW + 15.5


def spans(T: int, kc: int, seed: int) -> np.ndarray:
    """make_cand's draws at another size: heavy-tailed y spans inside the
    coarse tile, so that ~12% of a tile's candidates meet a given row."""
    rng = np.random.default_rng(seed)
    cand = base(T, kc, seed + 1)
    cy = rng.uniform(0, COARSE, (T, kc)).astype(np.float32)
    half = np.minimum(rng.lognormal(1.5, 1.0, (T, kc)), 64).astype(np.float32)
    ty0 = (np.arange(T) // TILES_X * COARSE).astype(np.float32)[:, None]
    cand[..., Y0] = ty0 + cy - half
    cand[..., Y1] = ty0 + cy + half
    return cand


def chunk_case(name: str, kb: int = 128) -> np.ndarray:
    """The named set:

    - "kf_at_edges" (2 tiles of 4096): tile 0's first block of 128 meets no
      row and the next 8 meet every row, so every row reaches kf = 1024
      exactly after the first 1152 candidates, a block edge inside the
      kernel's chunk of 512; every candidate of tile 1 meets every row, so
      the rows reach kf exactly at a chunk edge (after 1024);
    - "kf_mid_chunk" (2 tiles of 4096): in every block of 128 the candidate
      at position i meets rows 0 .. (99 - i) // 7, so row r keeps 100 - 7 r
      a block and crosses kf in the middle of a block and of a chunk;
    - "dead_edges" (3 tiles of 4096, make_cand-like spans): a dead
      candidate (depth 2e10) in tile 0's first block, in tile 1's block 4
      (the first block of the second chunk of 512) and in tile 2's block 7
      (the last of the first chunk);
    - "rowbatch_one_open" (2 tiles of 4096): every candidate meets rows
      0-6, every tenth also row 7: seven rows are full while row 7 stays
      open to the end of the tile;
    - "kc640" (2 tiles of 640, or 768 for ``kb`` 256; make_cand-like): a
      tile that is not a whole number of chunks;
    - "one_tile" (1 tile of 4096, make_cand-like).
    """
    if name == "kf_at_edges":
        cand = base(2, 4096, 11)
        meet(cand, 0, slice(128, 1152), 0, ROWS - 1)
        meet(cand, 1, slice(None), 0, ROWS - 1)
    elif name == "kf_mid_chunk":
        cand = base(2, 4096, 12)
        i = np.arange(4096) % 128
        hit = i < 100
        for t in range(2):
            meet(cand, t, hit, 0, np.minimum((99 - i[hit]) // 7, ROWS - 1))
    elif name == "dead_edges":
        cand = spans(3, 4096, 13)
        cand[0, 70, DEPTH] = 2e10
        cand[1, 4 * 128 + 3, DEPTH] = 2e10
        cand[2, 7 * 128 + 100, DEPTH] = 2e10
    elif name == "rowbatch_one_open":
        cand = base(2, 4096, 14)
        for t in range(2):
            meet(cand, t, slice(None), 0, ROWS - 2)
            meet(cand, t, slice(None, None, 10), 0, ROWS - 1)
    elif name == "kc640":
        cand = spans(2, 640 if kb == 128 else 768, 15)
    elif name == "one_tile":
        cand = spans(1, 4096, 16)
    else:
        raise ValueError(f"no case {name}")
    return cand
