#!/usr/bin/env python3
"""Kernel D's f32 forms (``csrc/flash_attention_f32.cu``) beside other
builds of the same entries, timed in turns on one card.

    python3 street_crafter_tpu_torch/scripts/f32_forward_turns.py \\
        [--source LABEL=PATH ...] [--ablation LABEL=PATH ...] [--reps N]

Each PATH is a CUDA source with the f32 library's C interface
(``sc_flash_forward_f32``, ``sc_flash_forward_lse_f32``): an earlier
version of the file or a variant of it. Every source is compiled with nvcc
(``ops.cuda_build``'s flags; its own directory first on the include path,
then ``csrc/``) beside this tree's source, labelled "this", all builds at
once. Each build is first held against the plain version at small ragged
lengths (head dims 64 and 128), then at each of the main path's shapes
(sampling [50, 9216 / 2304 / 576, 5 / 10 / 20, 64] without lse, training
[25, ...] with lse): the largest error against atol 2e-5 + rtol 1e-4 of
the largest |reference| (TF32 off for the plain version); a build past it
is reported and not timed. Then each is timed by CUDA events (the mean of
REPS calls after one warm-up) in turns: the builds in order, then in the
reverse order. An ablation (``--ablation``: a variant with a part of the
kernel taken out, such as the softmax or the split passes, to see what
that part costs) computes something else, so it is timed whatever its
error. Prints one JSON object per shape and form (ms of each turn, their
mean, the 3xTF32 bound and its share), then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SAMPLING = [(50, 9216, 5, 64), (50, 2304, 10, 64), (50, 576, 20, 64)]
TRAINING = [(25, 9216, 5, 64), (25, 2304, 10, 64), (25, 576, 20, 64)]
RAGGED = [(2, sq, skv, 3, d) for d in (64, 128)
          for sq, skv in ((1, 1), (33, 1), (1000, 1), (127, 129),
                          (129, 31), (300, 1000), (65, 257))]
ATOL, RTOL = 2e-5, 1e-4
PEAK_3XTF32_FLOPS = 495e12 / 3   # TF32's dense peak over three products
PEAK_BYTES_S = 3.35e12


def build_all(sources: dict[str, Path]) -> dict[str, Path]:
    """{label: shared library}, one nvcc process per source not built yet,
    all started together."""
    from street_crafter_tpu_torch.ops import cuda_build as CB
    out, procs = {}, {}
    for label, src in sources.items():
        text = src.read_bytes() + b"".join(
            p.read_bytes() for d in (src.parent, CB.CSRC_DIR)
            for p in sorted(d.glob("*.cuh")))
        digest = hashlib.sha256(
            text + " ".join(CB.NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = CB.BUILD_DIR / f"turns_{digest}.so"
        out[label] = lib
        if lib.exists():
            continue
        CB.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs[label] = subprocess.Popen(
            [CB.nvcc(), *CB.NVCC_FLAGS, "-I", str(src.parent), "-I",
             str(CB.CSRC_DIR), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for label, proc in procs.items():
        so, se = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[label]}:\n{so}\n{se}")
        print(f"[build] {label}: " + " | ".join(ptxas_report(so + se)),
              flush=True)
    return out


def ptxas_report(text: str) -> list[str]:
    """ptxas's registers and spills of kernel D's entries, and any
    warning (a wgmma serialisation among them)."""
    keep, entry = [], ""
    for line in text.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            entry = line
        elif "flash_fwd" in entry and ("Used" in line or "spill" in line):
            keep.append(line.split(":", 1)[-1].strip())
        if "warning" in line.lower():
            keep.append(line.strip())
    return keep


def entries(lib: Path):
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd, lse = so.sc_flash_forward_f32, so.sc_flash_forward_lse_f32
    fwd.argtypes, fwd.restype = [P, P, P, P, I, I, I, I, I, F, P], I
    lse.argtypes, lse.restype = [P, P, P, P, P, I, I, I, I, I, F, P], I
    return fwd, lse


def run(fns, with_lse: bool, q, k, v, o, lse) -> None:
    import torch
    B, Sq, H, D = q.shape
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
    if with_lse:
        ptrs.append(lse.data_ptr())
    err = fns[1 if with_lse else 0](
        *ptrs, B, H, Sq, k.shape[1], D, 1.0 / D ** 0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed ({err})")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def inputs(b, sq, skv, h, d, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((b, n, h, d), generator=g, device="cuda")
                 for n in (sq, skv, skv))


def errors(libs, q, k, v, with_lse: bool) -> dict:
    """{label: (largest error over o and lse, its limit)}."""
    import torch
    from street_crafter_tpu_torch.ops import flash_attention as FA
    o_ref, lse_ref = FA.flash_attention_lse_reference(q, k, v)
    out = {}
    for label, fns in libs.items():
        o = torch.empty_like(q)
        lse = torch.empty(lse_ref.shape, device="cuda")
        run(fns, with_lse, q, k, v, o, lse)
        torch.cuda.synchronize()
        worst = None
        for got, want in ((o, o_ref), (lse, lse_ref))[:2 if with_lse else 1]:
            err = float((got - want).abs().max()) if bool(
                torch.isfinite(got).all()) else float("inf")
            lim = ATOL + RTOL * float(want.abs().max())
            if worst is None or err / lim > worst[0] / worst[1]:
                worst = (err, lim)
        out[label] = worst
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of another source (repeatable)")
    ap.add_argument("--ablation", action="append", default=[],
                    help="LABEL=PATH of a variant timed whatever its error")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("f32_forward_turns.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = {}
    for spec in args.source + args.ablation:
        label, _, path = spec.partition("=")
        sources[label] = Path(path).resolve()
    ablations = {spec.partition("=")[0] for spec in args.ablation}
    sources["this"] = (ROOT / "street_crafter_tpu_torch" / "csrc"
                       / "flash_attention_f32.cu")
    libs = {label: entries(lib) for label, lib in build_all(sources).items()}
    labels = list(libs)

    bad: set = set()
    for i, (b, sq, skv, h, d) in enumerate(RAGGED):
        q, k, v = inputs(b, sq, skv, h, d, 500 + i)
        for with_lse in (False, True):
            for label, (err, lim) in errors(libs, q, k, v, with_lse).items():
                if err > lim and label not in ablations:
                    bad.add(label)
                    print(json.dumps({"ragged": [b, sq, skv, h, d],
                                      "lse": with_lse, "label": label,
                                      "err": err, "limit": lim}), flush=True)
    print(json.dumps({"ragged_cases": len(RAGGED), "past_the_limit":
                      sorted(bad)}), flush=True)

    for with_lse, shapes in ((False, SAMPLING), (True, TRAINING)):
        for i, (b, s, h, d) in enumerate(shapes):
            q, k, v = inputs(b, s, s, h, d, 700 + i)
            errs = errors(libs, q, k, v, with_lse)
            flops = 4.0 * b * h * s * s * d
            nbytes = 4.0 * (4 * b * s * h * d + (b * h * s if with_lse else 0))
            bound = 1e3 * max(flops / PEAK_3XTF32_FLOPS, nbytes / PEAK_BYTES_S)
            o = torch.empty_like(q)
            lse = torch.empty((b, h, s), device="cuda")
            ok = [lb for lb in labels if lb in ablations or (
                lb not in bad and errs[lb][0] <= errs[lb][1])]
            ms: dict = {lb: [] for lb in ok}
            for lb in ok + ok[::-1]:
                ms[lb].append(cuda_ms(
                    lambda: run(libs[lb], with_lse, q, k, v, o, lse),
                    args.reps))
            row = {"shape": [b, s, h, d], "lse": with_lse,
                   "bound_ms": bound, "builds": {}}
            for lb in labels:
                err, lim = errs[lb]
                entry = {"err": err, "limit": lim,
                         "ablation": lb in ablations}
                if lb in ms:
                    mean = sum(ms[lb]) / len(ms[lb])
                    entry.update(ms=ms[lb], mean_ms=mean,
                                 bound_share=bound / mean)
                row["builds"][lb] = entry
            print(json.dumps(row), flush=True)
            del q, k, v, o, lse
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
