#!/usr/bin/env python3
"""How often a torch.profiler profile misses kernels of one fused call.

    python3 street_crafter_tpu_torch/scripts/profile_window.py [--trials N]

Builds kernels E and F, then profiles one fused call at every shape of
chip_smoke.py's phase 10 split (kernel E's, then F's three) ``--trials``
times with ``chip_smoke.kernel_ms``, alternating between no pause at the
profiler's window edges and ``chip_smoke.PROFILE_GAP_S``. Each profile
records ``chip_smoke.PROFILE_CALLS`` calls between marker kernels; the
script counts the bounded calls that hold fewer kernels than the call
launches, the profiles with no whole call and the markers lost. Prints one
JSON object per (shape, pause), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", ".."))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_window: needs a CUDA device")
    import chip_smoke as CS
    from street_crafter_tpu_torch.ops import temporal_block as TB
    dev = torch.device("cuda", 0)
    gpu = CS.card()
    shapes = ([(s, True) for s in CS.E_SHAPES]
              + [(s, False) for s in CS.F_SHAPES])
    for i, ((B, T, S, C, heads), full) in enumerate(shapes):
        h, emb, bias, w = CS.stage_inputs(dev, B, T, S, C, 400 + i)
        call, want = CS.fused_stage_call(TB, h, emb, bias, w, T, heads,
                                         full)
        call()
        torch.cuda.synchronize()
        seen = {0.0: [], CS.PROFILE_GAP_S: []}
        for t in range(args.trials):
            for gap in (seen if t % 2 else reversed(list(seen))):
                got = CS.kernel_ms(call, gap)
                seen[gap].append((
                    [sum(n for _, _, n in c) for c in got["calls"]],
                    got["markers"]))
        for gap, profiles in seen.items():
            calls = [n for c, _ in profiles for n in c]
            print(json.dumps({
                "stage": "E" if full else "F", "shape": [B * T, S, C],
                "gap_s": gap, "kernels": want, "profiles": len(profiles),
                "bounded_calls": len(calls),
                "incomplete_calls": sum(n != want for n in calls),
                "profiles_without_whole_call": sum(
                    want not in c for c, _ in profiles),
                "markers_lost": sum(CS.PROFILE_CALLS + 1 - m
                                    for _, m in profiles),
                "fewest_seen": min(calls, default=0), "card": gpu}),
                flush=True)
        del h, emb, bias, w
        torch.cuda.empty_cache()
    print(gpu, flush=True)


if __name__ == "__main__":
    main()
