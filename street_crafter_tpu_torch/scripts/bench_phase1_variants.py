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
slots and the TPU bench's checksums exactly equal) and timed with CUDA
events beside it. Prints one JSON object per variant, then the card's
name and power limit. A kernel that disagrees exits non-zero.
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


def run_variants(dev, cand, peak_bytes_s: float, reps: int = 20) -> list:
    """Each variant's kernel against its plain version on ``cand`` (a CUDA
    tensor), and both timed (CUDA events; the plain version once)."""
    import torch
    from street_crafter_tpu_torch.ops import row_compact as RC

    def ms(fn, n):
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

    rows = []
    for name, variant, kb in RUNS:
        comp, counts = RC.compact_rows(cand, variant, kb)
        ref_comp, ref_counts = RC.compact_rows_reference(cand, variant, kb)
        ok = bool(torch.equal(counts, ref_counts))
        if comp is not None:
            ok = ok and kept_equal(comp, ref_comp, ref_counts)
        sums = RC.checksums(comp, counts, variant)
        ref_sums = RC.checksums(ref_comp, ref_counts, variant)
        ok = ok and bool(torch.equal(sums, ref_sums))
        rows.append({
            "name": name, "variant": variant, "kb": kb,
            "shape": list(cand.shape), "equal": ok,
            "max_abs_err": float((sums - ref_sums).abs().max()),
            "kept": int(ref_counts.clamp(max=RC.KF).sum()),
            "counts_max": int(ref_counts.max()),
            "ms": ms(lambda: RC.compact_rows(cand, variant, kb), reps),
            "plain_ms": ms(lambda: RC.compact_rows_reference(cand, variant,
                                                             kb), 1),
            "bound_ms": bound_ms(cand, ref_counts, variant, kb,
                                 peak_bytes_s),
            "bound_by": "bytes"})
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
