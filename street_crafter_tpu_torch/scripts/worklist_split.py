#!/usr/bin/env python3
"""Kernel A's split at the headline frame, under torch.profiler.

    python3 street_crafter_tpu_torch/scripts/worklist_split.py [--tree DIR]

Builds chip_smoke.py's main-path scene (a synthetic 1920x1280 scene, the
600k-splat pool in front of camera 0) from the checkout at ``--tree``
(default: this script's checkout), then for both passes of the headline
frame (1600x1067: the foreground and the sky) times one
``tile_worklist`` call of that checkout's ``ops.gs_raster`` three ways:
CUDA events over back-to-back calls, the host clock of synchronised
calls, and torch.profiler: each device activity's time per call (kernels,
memsets, copies), the device's busy time, the call's span on the device
clock and the idle gaps in it (the largest is the host's gap at the
worklist's synchronisation). Beside it, one ``torch.sort(keys,
stable=True)`` of the same pairs' 64-bit (tile << 32 | depth bits) keys in
the order the splats emit them: the library sort the worklist's first
port called (``library_ms``, timed only). Run it on two checkouts in one
call to compare them on one card. Prints one JSON object per pass, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

LABEL = "tile_worklist call"


def emission_keys(u, v, radii, depths, valid, width: int, height: int):
    """[P] int64 (tile << 32 | depth bits) of every (tile, splat) pair in
    emission order (splat by splat, each splat's tiles row-major): the keys
    as the first kernel A handed them to torch.sort. Plain torch."""
    import torch
    tile = 16
    tw, th = -(-width // tile), -(-height // tile)
    s = 1.0 / tile
    active = valid & (radii > 0)
    tx0 = torch.clamp(torch.floor((u - radii) * s), 0, tw).long()
    tx1 = torch.clamp(torch.ceil((u + radii) * s), 0, tw).long()
    ty0 = torch.clamp(torch.floor((v - radii) * s), 0, th).long()
    ty1 = torch.clamp(torch.ceil((v + radii) * s), 0, th).long()
    nx = torch.where(active, tx1 - tx0, 0).clamp(min=0)
    ny = torch.where(active, ty1 - ty0, 0).clamp(min=0)
    counts = nx * ny
    gid = torch.repeat_interleave(torch.arange(u.shape[0], device=u.device),
                                  counts)
    k = torch.arange(gid.shape[0], device=u.device) - (
        torch.cumsum(counts, 0) - counts)[gid]
    t = (ty0[gid] + k // nx[gid]) * tw + tx0[gid] + k % nx[gid]
    bits = depths.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return (t << 32) | bits[gid]


def device_split(fn, reps: int = 5) -> dict:
    """torch.profiler over ``reps`` synchronised calls of ``fn`` after a
    warm-up. Per call (means): each device activity's ms and count, the
    busy ms (union of the activities), the span from the first start to
    the last end, and the idle gaps in the span, largest first, each with
    the activities it lies between."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            with torch.profiler.record_function(LABEL):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    calls = sorted(e.time_range.start for e in events
                   if e.name == LABEL
                   and e.device_type == torch.autograd.DeviceType.CPU)
    # the annotation has a device-side range of its own: not an activity
    dev = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != LABEL),
                 key=lambda e: e.time_range.start)
    per_call = [[] for _ in calls]
    for e in dev:
        i = max((k for k, c in enumerate(calls) if c <= e.time_range.start),
                default=None)
        if i is not None:
            per_call[i].append(e)
    by_name: dict[str, list] = {}
    busy, span, gaps = [], [], []
    for evs in per_call:
        if not evs:
            continue
        b, end = 0.0, None
        call_gaps = []
        prev = None
        for e in evs:
            s0, s1 = e.time_range.start, e.time_range.end
            if end is not None and s0 > end:
                call_gaps.append((s0 - end, prev.name[:60], e.name[:60]))
            b += s1 - (s0 if end is None else max(s0, end))
            if end is None or s1 > end:
                end, prev = s1, e
            rec = by_name.setdefault(e.name[:80], [0.0, 0])
            rec[0] += e.time_range.elapsed_us()
            rec[1] += 1
        busy.append(b)
        span.append(end - evs[0].time_range.start)
        gaps.append(sorted(call_gaps, reverse=True))
    n = max(len(busy), 1)
    return {
        "activities": [{"name": k, "ms": v[0] / 1e3 / n, "per_call": v[1] / n}
                       for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1][0])],
        "busy_ms": statistics.mean(busy) / 1e3 if busy else None,
        "span_ms": statistics.mean(span) / 1e3 if span else None,
        "gaps": [{"ms": g / 1e3, "after": a, "before": b}
                 for g, a, b in (gaps[-1][:4] if gaps else [])],
        "calls_traced": len(busy)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."),
        help="root of the checkout whose kernel A is measured")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("worklist_split: needs a CUDA device")
    import chip_smoke as CS
    from street_crafter_tpu_torch.ops import gs_raster as G
    dev = torch.device("cuda", 0)
    gpu = CS.card()
    t0 = time.perf_counter()
    G._library()
    print(f"{tree}: gs_raster built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="worklist_split_") as tmp:
        cfg, _ = CS.build_main_path_scene(tmp, dev)
        fg, _, _ = CS.headline_raster_args(cfg, dev)
        sky, _ = CS.headline_sky_args(cfg, dev)
    for label, ra in (("foreground", fg), ("sky", sky)):
        geo = CS.split_args(ra)[0]
        wl = G.tile_worklist(**geo)
        keys = emission_keys(**geo)
        if keys.shape[0] != wl.n_pairs:
            raise AssertionError(f"{label}: {keys.shape[0]} keys, "
                                 f"{wl.n_pairs} pairs")
        call = lambda: G.tile_worklist(**geo)   # noqa: E731
        row = {
            "tree": tree, "pass": label, "splats": int(geo["u"].shape[0]),
            "pairs": wl.n_pairs, "tiles": int(wl.ranges.shape[0]),
            "max_list": int((wl.ranges[:, 1] - wl.ranges[:, 0]).max()),
            "event_ms": CS.cuda_ms(call, 20),
            "host_ms_median": statistics.median(CS.sync_ms(call, 20)),
            "split": device_split(call),
            "torch_sort_ms": CS.cuda_ms(
                lambda: torch.sort(keys, stable=True), 20),
            "card": gpu}
        print(json.dumps(row), flush=True)
    print(gpu, flush=True)


if __name__ == "__main__":
    main()
