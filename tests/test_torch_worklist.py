"""Kernel A's plain versions against brute force and the JAX package.

  * the plain worklist's tile order (``TileWorklist.order``, the order in
    which kernels B and C take the tiles) against a brute-force ordering of
    the list lengths: length descending, tile index ascending on ties;
  * the port of K1's row-compaction variants (``ops/row_compact.py``,
    kernel A's variant bench) against the TPU bench's own kernels,
    ``scripts/bench_phase1_variants.py``'s ``kernel`` (variants base and
    bf16) and ``rowbatch_kernel`` (blocks of 128 and 256 candidates), run
    under ``pl.pallas_call(..., interpret=True)`` on the first 2 coarse
    tiles of its ``make_cand(seed)`` and on a 2-tile chunk-edge set of
    ``row_compact_cases.py``: the counts exactly, the checksums to 1e-6
    relative (the 11-value sum is reduced in another order), and the
    compacted lists exactly. The script is loaded by path; its candidates
    and the port's ``make_cand`` are the same numpy draws.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from street_crafter_tpu_torch.ops import gs_raster as G
from street_crafter_tpu_torch.ops import row_compact as RC
from street_crafter_tpu_torch.scripts import bench_phase1_variants as PV
from row_compact_cases import chunk_case  # tests/row_compact_cases.py

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TILES = 2          # coarse tiles run through the interpreter


@functools.lru_cache(maxsize=None)
def tpu_bench():
    spec = importlib.util.spec_from_file_location(
        "tpu_bench_phase1_variants", ROOT / "scripts" /
        "bench_phase1_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_worklist_order_is_brute_force_order(seed):
    rng = np.random.default_rng(seed)
    n, W, H = 600, 150, 97
    sigma = rng.uniform(1.0, 25.0, n)
    t = lambda a, d=torch.float32: torch.tensor(a, dtype=d)  # noqa: E731
    wl = G.tile_worklist_reference(
        t(rng.uniform(-30, W + 30, n)), t(rng.uniform(-30, H + 30, n)),
        t(np.ceil(3 * sigma)), t(rng.uniform(1, 50, n)),
        t(rng.random(n) > 0.1, torch.bool), W, H)
    lengths = (wl.ranges[:, 1] - wl.ranges[:, 0]).tolist()
    want = sorted(range(len(lengths)), key=lambda k: (-lengths[k], k))
    assert wl.order.dtype == torch.int64
    assert wl.order.tolist() == want
    # ties exist (many empty and equal-length tiles), so the tie rule is
    # what is checked
    assert len(set(lengths)) < len(lengths)


def tpu_checksums(variant, cand, kb):
    """The TPU bench's per-program checksums on ``cand`` [TILES, kc, 11],
    in interpret mode: [TILES, 8] for ``kernel``, [TILES] for
    ``rowbatch_kernel``."""
    S = tpu_bench()
    x = jnp.asarray(cand)
    if variant == "rowbatch":
        f = pl.pallas_call(
            functools.partial(S.rowbatch_kernel, KB=kb), grid=(TILES,),
            in_specs=[pl.BlockSpec((1, S.kc, S.A), lambda c: (c, 0, 0)),
                      pl.BlockSpec((1, 4, S.kc), lambda c: (c, 0, 0))],
            out_specs=pl.BlockSpec((1, 8, 128), lambda c: (c, 0, 0)),
            out_shape=jax.ShapeDtypeStruct((TILES, 8, 128), jnp.float32),
            scratch_shapes=[pltpu.VMEM((S.CF, S.kf, S.A), jnp.float32)],
            interpret=True)
        yb = jnp.stack([x[..., S.DEPTH + 1], x[..., S.DEPTH + 2],
                        x[..., S.DEPTH], jnp.zeros_like(x[..., 0])], axis=1)
        return np.asarray(f(x, yb))[:, 0, 0]
    f = pl.pallas_call(
        functools.partial(S.kernel, variant=variant), grid=(TILES, S.CF),
        in_specs=[pl.BlockSpec((1, S.kc, S.A), lambda c, r: (c, 0, 0))],
        out_specs=pl.BlockSpec((1, 1, 8, 128), lambda c, r: (c, r, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((TILES, S.CF, 8, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((S.kf, S.A), jnp.float32)],
        interpret=True)
    return np.asarray(f(x))[:, :, 0, 0]


def candidates(data: str) -> np.ndarray:
    """``make_cand(0)``'s first coarse tiles; "capped": 40% of them span
    the whole coarse tile, so that every row of tile 0 outgrows kf, and
    tile 1 has a dead candidate in its second block of 128, which ends its
    walks there; "kf_at_edges": the chunk-edge set of
    ``row_compact_cases.py`` (every row reaches kf exactly at a block edge
    inside a chunk of the CUDA kernel in tile 0, at a chunk edge in tile
    1)."""
    if data == "kf_at_edges":
        cand = chunk_case(data)
        assert cand.shape == (TILES, tpu_bench().kc, RC.A)
        return cand
    cand = PV.make_cand(0, TILES)
    np.testing.assert_array_equal(
        cand, np.asarray(tpu_bench().make_cand(0))[:TILES])
    if data == "capped":
        wide = np.random.default_rng(1).random(cand.shape[:2]) < 0.4
        cand[..., RC.Y0] = np.where(wide, -1.0, cand[..., RC.Y0])
        cand[..., RC.Y1] = np.where(wide, 1000.0, cand[..., RC.Y1])
        cand[1, 200, RC.DEPTH] = 2e10
    return cand


@pytest.mark.parametrize("data", ["make_cand", "capped", "kf_at_edges"])
@pytest.mark.parametrize("variant,kb", [("base", 128), ("bf16", 128),
                                        ("rowbatch", 128),
                                        ("rowbatch", 256)])
def test_row_compaction_matches_tpu_bench(variant, kb, data):
    cand = candidates(data)
    comp, counts = RC.compact_rows(torch.tensor(cand), variant, kb)
    got = RC.checksums(comp, counts, variant).numpy()
    want = tpu_checksums(variant, cand, kb)
    # the counts exactly: a TPU checksum less the port's sum of the first
    # candidate's values (under 11 * 6 in magnitude) rounds to its count
    port_counts = (counts.sum(1) if variant == "rowbatch" else counts).numpy()
    first = got - port_counts
    np.testing.assert_array_equal(np.round(want - first), port_counts)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if data == "kf_at_edges":
        # every walk stops exactly at kf, before the next block
        assert counts.tolist() == [[RC.KF] * RC.ROWS] * TILES
        kept = torch.tensor(cand[0, 128:1152])
        if variant == "bf16":
            kept = kept.to(torch.bfloat16).float()
        assert torch.equal(comp[0, 3], kept)
        return
    if data == "capped":
        # tile 0's walks stop once the count passed kf: within a block of
        # it, slots capped; tile 1's after the block with the dead one
        assert RC.KF < int(counts[0].min()) and int(counts[0].max()) \
            < RC.KF + (RC.ROWS * kb if variant == "rowbatch" else kb)
        assert int(counts[1].max()) < 2 * kb
        return
    # the lists: row r of tile t holds, in depth order, the candidates whose
    # span meets the row (values rounded to bf16 for bf16), then zeros
    exact = torch.tensor(cand)
    values = exact.to(torch.bfloat16).float() if variant == "bf16" else exact
    for t in range(TILES):
        for r in (0, 5):
            ry0 = t // RC.TILES_X * RC.COARSE + r * RC.ROW
            meets = ((exact[t, :, RC.Y0] < ry0 + RC.ROW)
                     & (exact[t, :, RC.Y1] > ry0))
            n = min(int(counts[t, r]), RC.KF)
            assert int(counts[t, r]) == int(meets.sum()) > 0
            assert torch.equal(comp[t, r, :n], values[t][meets][:n])
            assert float(comp[t, r, n:].abs().max()) == 0.0


def test_row_compaction_caps_slots_not_counts():
    """Rows of more than kf candidates: the count runs on inside the last
    block walked while the slots stop at kf (as the TPU kernel does), and
    the walk stops after a block with a dead candidate."""
    rng = np.random.default_rng(3)
    T, kc = 2, 2048
    cand = rng.normal(size=(T, kc, RC.A)).astype(np.float32)
    cand[..., RC.DEPTH] = np.sort(rng.uniform(1, 100, (T, kc)), 1)
    cand[..., RC.Y0] = -1.0                 # every candidate meets every row
    cand[..., RC.Y1] = 1000.0
    cand[1, 300, RC.DEPTH] = 2e10           # a dead one in tile 1's block 2
    comp, counts = RC.compact_rows_reference(torch.tensor(cand), "base", 128)
    # tile 0: blocks of 128 until the count reaches 1024: exactly 8 blocks
    assert counts[0].tolist() == [1024] * RC.ROWS
    # tile 1: blocks 0-2 (the third holds the dead one; it is not kept)
    assert counts[1].tolist() == [383] * RC.ROWS
    assert torch.equal(comp[0, 3], torch.tensor(cand[0, :1024]))
    want = np.concatenate([cand[1, :300], cand[1, 301:384]])
    assert torch.equal(comp[1, 5, :383], torch.tensor(want))
    assert float(comp[1, 5, 383:].abs().max()) == 0.0
    rows, rcounts = RC.compact_rows_reference(torch.tensor(cand), "rowbatch",
                                              256)
    assert rcounts[0].tolist() == [1024] * RC.ROWS
    assert torch.equal(rows[0], comp[0])
    # counts run past kf inside the last block: 11 blocks of 100 kept
    cand[0, :, RC.Y1] = np.where(np.arange(kc) % 128 < 100, 1000.0, -5.0)
    _, counts = RC.compact_rows_reference(torch.tensor(cand), "base", 128)
    assert counts[0].tolist() == [1100] * RC.ROWS
    _, only = RC.compact_rows_reference(torch.tensor(cand), "count_only", 128)
    assert torch.equal(only, counts)
