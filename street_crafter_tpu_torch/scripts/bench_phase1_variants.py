#!/usr/bin/env python3
"""K1's row-compaction variants on the card: kernel A's variant bench.

    python3 -m street_crafter_tpu_torch.scripts.bench_phase1_variants

Port of ``scripts/bench_phase1_variants.py`` (the TPU bench of the
compaction inside K1): synthetic candidates shaped like the headline
scene's coarse tiles ([117, 4096, 11] f32, depth-sorted, heavy-tailed y
spans; ``make_cand``, the same numpy draws for the same seed) compacted
into 8 per-16-px-row lists [117, 8, 1024, 11] with counts, by the kernels
of ``ops/row_compact.py`` (``csrc/row_compact.cu``):

  * ``base``: one block per (coarse tile, row), the TPU's ``kernel``;
  * ``rowbatch``: one block per coarse tile for its 8 rows, the TPU's
    ``rowbatch_kernel``, with blocks of 128 and of 256 candidates;
  * ``bf16``: ``base`` with the values rounded to bf16, the TPU's bf16
    one-hot products;
  * ``count_only``: the mask and the counts without the scatter, the
    TPU's no-upd / no-ind ablations.

The TPU's ``win8`` variant only moved the slot window's alignment and
computes what ``base`` computes: no kernel here. Each kernel is held
against the plain torch version on the same candidates (counts, the kept
slots and the TPU bench's checksums exactly equal) and timed beside it:
as called (``ms``: CUDA events around 20 calls back to back, the host's
work per call included where it is the longer) and on the device alone
(``device_ms``: 20 calls captured in one CUDA graph, replayed between
events; the workspace's memset included). Both calls find the candidates
in L2 where the last call left them (warm). Prints one JSON object per
variant and seed, then the card's name and power limit. A kernel that
disagrees exits non-zero.

    python3 -m street_crafter_tpu_torch.scripts.bench_phase1_variants
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

# the TPU bench's shapes
TC, KC, A = 117, 4096, 11
TWC, CTS = 13, 128
DEPTH = 10 - 2          # depth column (A - 3)
# (name, variant, candidates per walked block)
RUNS = (("base", "base", 128), ("rowbatch", "rowbatch", 128),
        ("rowbatch_kb256", "rowbatch", 256), ("bf16", "bf16", 128),
        ("count_only", "count_only", 128))


def make_cand(seed: int, tiles: int = TC) -> np.ndarray:
    """[tiles, 4096, 11] f32 depth-sorted alive candidates with
    heavy-tailed y spans inside their coarse tile: the TPU bench's draws
    (its ``make_cand``) for the first ``tiles`` coarse tiles."""
    rng = np.random.default_rng(seed)
    depth = np.sort(rng.uniform(1, 100, (TC, KC)).astype(np.float32), axis=1)
    cy = rng.uniform(0, CTS, (TC, KC)).astype(np.float32)
    half = np.minimum(rng.lognormal(1.5, 1.0, (TC, KC)), 64).astype(
        np.float32)
    cand = rng.normal(size=(TC, KC, A)).astype(np.float32)
    ty0 = (np.arange(TC) // TWC * CTS).astype(np.float32)[:, None]
    cand[..., DEPTH] = depth
    cand[..., DEPTH + 1] = ty0 + cy - half
    cand[..., DEPTH + 2] = ty0 + cy + half
    return cand[:tiles]


def kept_equal(got, want, counts) -> bool:
    """The kernel's lists equal the plain ones in every written slot (the
    first min(count, kf) of each row)."""
    import torch
    from street_crafter_tpu_torch.ops import row_compact as RC
    n = counts.clamp(max=RC.KF).long()
    live = torch.arange(RC.KF, device=counts.device) < n[..., None]
    return bool(torch.equal(got[live], want[live]))


def bound_ms(cand, counts, variant: str, kb: int,
             peak_bytes_s: float) -> float:
    """Least time for the bytes a variant must move: each coarse tile's
    candidates up to where its longest walk stopped, read once; each kept
    candidate written once (not for count_only); the counts."""
    from street_crafter_tpu_torch.ops import row_compact as RC
    blocks = RC.walked_blocks(cand, variant, kb).max(1).values
    read = float(blocks.sum()) * kb * RC.A * 4
    written = (0.0 if variant == "count_only" else
               float(counts.clamp(max=RC.KF).sum()) * RC.A * 4)
    return 1e3 * (read + written + counts.numel() * 4) / peak_bytes_s


def events_ms(fn, n: int) -> float:
    """Mean ms per call of ``n`` calls back to back (CUDA events), after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Mean device ms per call: ``calls`` calls captured in one CUDA graph
    (after a warm-up call off the capturing stream), replayed ``replays``
    times between CUDA events. ``fn`` must not synchronise."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    ms = events_ms(graph.replay, replays) / calls
    del graph
    torch.cuda.empty_cache()
    return ms


def run_variants(dev, cand, peak_bytes_s: float, reps: int = 20) -> list:
    """Each variant's kernel against its plain version on ``cand`` (a CUDA
    tensor), and both timed: the kernel as called (``ms``: CUDA events
    around ``reps`` calls) and on the device alone (``device_ms``: a CUDA
    graph of ``reps`` calls), the plain version once."""
    import torch
    from street_crafter_tpu_torch.ops import row_compact as RC

    rows = []
    for name, variant, kb in RUNS:
        def call(variant=variant, kb=kb):
            return RC.compact_rows(cand, variant, kb)
        comp, counts = call()
        ref_comp, ref_counts = RC.compact_rows_reference(cand, variant, kb)
        ok = bool(torch.equal(counts, ref_counts))
        if comp is not None:
            ok = ok and kept_equal(comp, ref_comp, ref_counts)
        sums = RC.checksums(comp, counts, variant)
        ref_sums = RC.checksums(ref_comp, ref_counts, variant)
        ok = ok and bool(torch.equal(sums, ref_sums))
        del comp, counts
        bound = bound_ms(cand, ref_counts, variant, kb, peak_bytes_s)
        device = graph_ms(call, reps)
        rows.append({
            "name": name, "variant": variant, "kb": kb,
            "shape": list(cand.shape), "equal": ok,
            "max_abs_err": float((sums - ref_sums).abs().max()),
            "kept": int(ref_counts.clamp(max=RC.KF).sum()),
            "counts_max": int(ref_counts.max()),
            "ms": events_ms(call, reps), "device_ms": device,
            "plain_ms": events_ms(lambda: RC.compact_rows_reference(
                cand, variant, kb), 1),
            "bound_ms": bound, "bound_by": "bytes",
            "share_of_bound": bound / device})
    return rows


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_phase1_variants: needs a CUDA device")
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    bad = []
    for seed in range(3):
        cand = torch.tensor(make_cand(seed), device=dev)
        for row in run_variants(dev, cand, 3.35e12):
            row.update(seed=seed, card=gpu)
            print(json.dumps(row), flush=True)
            if not row["equal"]:
                bad.append((seed, row["name"]))
    print(gpu, flush=True)
    if bad:
        sys.exit(f"kernels disagree with their plain versions: {bad}")


if __name__ == "__main__":
    main()
