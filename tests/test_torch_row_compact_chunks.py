"""The row-compaction kernel's chunked resolution (``csrc/row_compact.cu``),
modelled in plain torch and held against the plain version
(``ops/row_compact.py``: ``compact_rows_reference`` and ``_walk``).

The kernel splits a coarse tile's candidates into chunks of ``RC.CHUNK``
(512), a CTA each. A chunk publishes, per row, its kept count and whether
all its candidates are alive, sums its predecessors' words back to the
nearest inclusive prefix (decoupled look-back), and from the exact count
before each of its blocks of kb applies the walk's stop rule. The model
takes those per-(tile, chunk, row, block) counts and alive flags, resolves
each chunk's look-back under several orders of publication, and gives the
walked blocks, the slot before each block, each row's count (written by the
chunk that holds the row's last walked block, exactly one) and the slots a
chunk writes; from them and the kernel's ranking it rebuilds the lists, and
splits each chunk's run of slots into the kernel's 16-byte-aligned write
units. Everything is compared exactly, for every variant and both kb, on
the sets of ``row_compact_cases.py``.
"""

import numpy as np
import pytest
import torch

from street_crafter_tpu_torch.ops import row_compact as RC
from row_compact_cases import CASES, chunk_case  # tests/row_compact_cases.py

torch.set_num_threads(1)

RUNS = (("base", 128), ("bf16", 128), ("count_only", 128), ("rowbatch", 128),
        ("rowbatch", 256))
AGG, INCL = 1, 2


def look_back(words: list, c: int) -> tuple[int, bool]:
    """Chunk ``c``'s exclusive prefix (count, all alive before it) from the
    published words of its predecessors: (state, count, alive), state 0 not
    yet (the kernel spins), AGG the chunk's own, INCL through the chunk."""
    count, alive = 0, True
    for p in range(c - 1, -1, -1):
        state, n, a = words[p]
        assert state != 0, "a predecessor has published nothing"
        count, alive = count + n, alive and a
        if state == INCL:
            break
    return count, alive


def resolve(block_counts, block_alive, n_blocks, variant, kf, order):
    """The kernel's resolution of one tile. ``block_counts`` [nc, 8, bpc]
    int, ``block_alive`` [nc, bpc] bool, ``n_blocks`` [nc] valid blocks a
    chunk; ``order``: the chunks' publication order (each chunk publishes
    its aggregate, then resolves and publishes its inclusive prefix, when
    its turn comes; a chunk's predecessors have published their aggregates
    by then, as the tickets guarantee). Returns per chunk (E [8], P [8,
    bpc + 1], walk [8] bitmasks, nout [8]), and the count writes
    [(chunk, row, count)]."""
    nc, _, bpc = block_counts.shape
    agg = block_counts.sum(-1)                                   # [nc, 8]
    chunk_alive = [bool(block_alive[c, :n_blocks[c]].all()) for c in range(nc)]
    # words[c][r]; a look-back that finds no word yet spins until the
    # aggregate, which a chunk publishes without waiting: as if every
    # aggregate came first
    words = [[(AGG, int(agg[c, r]), chunk_alive[c]) for r in range(8)]
             for c in range(nc)]
    out, writes = {}, []
    for c in order:
        E = np.zeros(8, np.int64)
        tail = True
        for r in range(8):
            E[r], tail = look_back([w[r] for w in words], c)
        for r in range(8):
            words[c][r] = (INCL, int(E[r] + agg[c, r]),
                           tail and chunk_alive[c])
        nbl = n_blocks[c]
        P = np.zeros((8, bpc + 1), np.int64)
        P[:, 0] = E
        P[:, 1:] = E[:, None] + np.cumsum(block_counts[c], -1)
        tmask = [tail]
        for b in range(bpc):
            tmask.append(tmask[-1] and bool(block_alive[c, b]))
        walk = np.zeros(8, np.int64)
        nout = np.zeros(8, np.int64)
        for r in range(8):
            bits, nxt = 0, False
            for b in range(nbl + 1):
                open_ = (P[:, b] < kf).any() if variant == "rowbatch" \
                    else P[r, b] < kf
                walked = bool(open_) and tmask[b]
                if b < nbl:
                    bits |= int(walked) << b
                else:
                    nxt = walked and c + 1 < nc
            k = bin(bits).count("1")
            assert bits == (1 << k) - 1, "walked blocks are not a prefix"
            if k > 0 and not (k == nbl and nxt):
                writes.append((c, r, int(P[r, k])))
            walk[r] = bits
            nout[r] = max(0, min(P[r, k] - E[r], kf - E[r]))
        out[c] = (E, P, walk, nout)
    return out, writes


def write_units(row_base: int, E: int, nout: int) -> list:
    """The kernel's write of a run of ``nout`` slots at slot ``E`` of a row
    whose first float is float ``row_base`` of the output: h head floats up
    to a 16-byte boundary, float4s, then the tail floats. Returns, unit by
    unit, the run's float offsets."""
    nf = nout * RC.A
    dst = row_base + E * RC.A
    h = min(nf, (4 - dst % 4) % 4)
    nv = (nf - h) // 4
    units = []
    for u in range(nf - 3 * nv):
        if u < h or u >= h + nv:
            units.append([u if u < h else u + 3 * nv])
        else:
            f = h + 4 * (u - h)
            assert (dst + f) % 4 == 0, "a float4 store off 16 bytes"
            units.append([f, f + 1, f + 2, f + 3])
    return units


def kernel_model(cand: torch.Tensor, variant: str, kb: int,
                 order_seed: int):
    """(lists [T, 8, kf, 11] f32, zeros where the kernel writes nothing, or
    None for count_only; counts [T, 8]; walked [T, 8, nb] bool) as the
    kernel computes them."""
    T, kc, _ = cand.shape
    chunk = RC.CHUNK
    mask, _, _ = RC._walk(cand, variant, kb)                     # [T, 8, kc]
    alive = cand[..., RC.DEPTH] < RC.DEAD                        # [T, kc]
    nc, bpc = -(-kc // chunk), chunk // kb
    pad = nc * chunk - kc
    m = torch.nn.functional.pad(mask, (0, pad)).view(T, 8, nc, bpc, kb)
    al = torch.nn.functional.pad(alive, (0, pad), value=True)
    al = al.view(T, nc, bpc, kb).all(-1).numpy()
    block_counts = m.sum(-1).permute(0, 2, 1, 3).numpy()  # [T, nc, 8, bpc]
    n_blocks = [min(chunk, kc - c * chunk) // kb for c in range(nc)]
    rng = np.random.default_rng(order_seed)
    values = cand.to(torch.bfloat16).float() if variant == "bf16" else cand
    values, mask = values.numpy(), mask.numpy()
    comp = np.zeros((T, 8, RC.KF * RC.A), np.float32)
    counts = torch.full((T, 8), -1, dtype=torch.int32)
    walked = torch.zeros((T, 8, kc // kb), dtype=torch.bool)
    for t in range(T):
        order = list(range(nc))
        if order_seed:
            rng.shuffle(order)
        res, writes = resolve(block_counts[t], al[t], n_blocks, variant,
                              RC.KF, order)
        assert sorted(r for _, r, _ in writes) == list(range(8)), \
            "each row's count is written by exactly one chunk"
        for _, r, n in writes:
            counts[t, r] = n
        for c, (E, P, walk, nout) in res.items():
            lo = c * chunk
            blocks = np.arange(n_blocks[c] * kb) // kb
            for r in range(8):
                walked[t, r, c * bpc:c * bpc + n_blocks[c]] = torch.tensor(
                    [bool(walk[r] >> b & 1) for b in range(n_blocks[c])])
                if variant == "count_only" or nout[r] == 0:
                    continue
                # the kernel's rank: kept before the candidate in the chunk
                in_walk = (walk[r] >> blocks) & 1 == 1
                kept = lo + np.nonzero(
                    mask[t, r, lo:lo + len(blocks)] & in_walk)[0]
                run = values[t, kept[:int(nout[r])]].reshape(-1)
                row_base = ((t * 8 + r) * RC.KF) * RC.A
                f = np.concatenate(write_units(row_base, int(E[r]),
                                               int(nout[r])))
                comp[t, r, int(E[r]) * RC.A + f] = run[f]
    comp = torch.from_numpy(comp.reshape(T, 8, RC.KF, RC.A))
    return (None if variant == "count_only" else comp), counts, walked


def case_tensor(name: str, kb: int) -> torch.Tensor:
    return torch.tensor(chunk_case(name, kb))


@pytest.mark.parametrize("variant,kb", RUNS)
@pytest.mark.parametrize("name", CASES)
def test_chunked_resolution_matches_plain(name, variant, kb):
    cand = case_tensor(name, kb)
    comp, counts, walked = kernel_model(cand, variant, kb, 0)
    want_comp, want_counts = RC.compact_rows_reference(cand, variant, kb)
    assert torch.equal(counts, want_counts)
    assert torch.equal(walked, RC._walk(cand, variant, kb)[2])
    if comp is None:
        assert want_comp is None
    else:
        assert torch.equal(comp, want_comp)


@pytest.mark.parametrize("order_seed", [1, 2, 3])
def test_look_back_any_publication_order(order_seed):
    """The chunks' inclusive prefixes published in shuffled orders give
    what the in-order resolution gives (the look-back stops at whichever
    inclusive word it meets first)."""
    cand = case_tensor("dead_edges", 128)
    for variant, kb in (("base", 128), ("rowbatch", 128)):
        want = kernel_model(cand, variant, kb, 0)
        got = kernel_model(cand, variant, kb, order_seed)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_chunk_cases_reach_their_edges():
    """The sets are what their names say (plain version, kb 128)."""
    _, counts = RC.compact_rows_reference(case_tensor("kf_at_edges", 128))
    assert counts.tolist() == [[RC.KF] * 8] * 2
    blocks = RC.walked_blocks(case_tensor("kf_at_edges", 128))
    assert blocks.tolist() == [[9] * 8, [8] * 8]
    _, counts = RC.compact_rows_reference(case_tensor("kf_mid_chunk", 128))
    per_block = np.array([100 - 7 * r for r in range(8)])
    want = (-(-RC.KF // per_block)) * per_block
    assert counts.tolist() == [want.tolist()] * 2
    assert (want % 128 != 0).all() and (want > RC.KF).all()
    blocks = RC.walked_blocks(case_tensor("dead_edges", 128))
    assert blocks.tolist() == [[1] * 8, [5] * 8, [8] * 8]
    cand = case_tensor("rowbatch_one_open", 128)
    _, counts = RC.compact_rows_reference(cand, "rowbatch", 128)
    assert counts.tolist() == [[4096] * 7 + [410]] * 2
    assert RC.walked_blocks(cand, "base")[0].tolist() == [8] * 7 + [32]
    assert case_tensor("kc640", 128).shape == (2, 640, RC.A)
    assert case_tensor("kc640", 256).shape == (2, 768, RC.A)
    assert case_tensor("one_tile", 128).shape == (1, 4096, RC.A)


@pytest.mark.parametrize("E", [0, 1, 2, 3, 5, 1000, 1023])
def test_write_units_cover_the_run_once(E):
    """The kernel's head / float4 / tail split of a run of slots covers
    each float once, every float4 16-byte aligned, at every alignment of
    the run's first slot."""
    for nout in (1, 2, 3, 7, 24, min(RC.KF - E, 500)):
        for row_base in (0, RC.KF * RC.A, 3 * RC.KF * RC.A):
            units = write_units(row_base, E, nout)
            flat = sorted(f for u in units for f in u)
            assert flat == list(range(nout * RC.A))
