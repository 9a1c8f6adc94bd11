"""Where ``chip_smoke.py``'s host time goes: its main process under cProfile.

Runs ``chip_smoke.main()`` (so it needs the card, as the script does),
writes the profile to ``--out`` and prints the functions with the most
time of their own and the port's functions with the most time under
them. Spawned processes (the ranks of phases 18, 23 and 24, the data
builders) are not profiled. The profiler slows Python-heavy code, so the
script's own times in its log run long.

  python3 -m street_crafter_tpu_torch.scripts.profile_smoke --out smoke.prof
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True, help="the profile's file")
    p.add_argument("--top", type=int, default=40)
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    prof = cProfile.Profile()
    prof.enable()
    try:
        chip_smoke.main()
    finally:
        prof.disable()
        prof.dump_stats(args.out)
        stats = pstats.Stats(args.out, stream=sys.stderr)
        stats.sort_stats("tottime").print_stats(args.top)
        stats.sort_stats("cumulative").print_stats(
            "(street_crafter_tpu_torch|chip_smoke)", args.top)


if __name__ == "__main__":
    main()
