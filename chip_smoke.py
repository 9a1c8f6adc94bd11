#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (street_crafter_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one status line each; any failure raises (exit code != 0):
  1. card name and power limit; build every kernel source of
     street_crafter_tpu_torch/csrc with nvcc for sm_90a, in parallel, and
     print each kernel's registers and spill bytes from ptxas's report,
     with any wgmma serialisation it notes; then start phases 3's, 9's,
     16's and 17's data (images, LiDAR and condition PNGs: host work
     only) in spawned processes of their own (prefetch_data), so that the
     phases before each run on the card meanwhile;
  2. each kernel against its plain torch version on the card: 50k splats of
     a trained-like scene at 384x256, and a scene with splats wider than
     200 px. Kernel A's worklist (its tile order included) must equal the
     plain one; kernel B must agree to atol 2e-4 on rgb and alpha, and the
     pack of pair records that B and C read must equal its plain version.
     Then, at 384x256, kernels A, B (both forms) and C (phase 5's limits)
     at 1, 3, 4 and 7 channels (records of 32, 48 and 64 bytes; past 7:
     phase 21) and on a
     tile list of more than 8,000 pairs that no pixel stops in (the rings
     wrap many times), and kernel A on 40,000 splats over one tile (a list
     longer than a sort block holds, sorted in passes over device memory);
  3. the main path: a synthetic 1920x1280 Waymo scene (4 frames, cameras
     0-2), scene init with the port's initialize_ply, the background pool
     replaced by a 600k-splat post-densification pool in front of camera 0,
     a port checkpoint, then runner.render.main(mode=trajectory): 12 renders
     at 1600x1067 that must be finite PNGs, through both kernels and never
     through the plain versions;
  4. kernels A and B against their plain versions at the headline frame's
     shapes, for both of its passes: the foreground and the sky; kernel A
     exactly, its tile order included;
  5. kernel C (the compositing backward) against the plain backward with
     seeded random cotangents on the inputs of phases 2 and 4: per field,
     to GRAD_RTOL of the field's largest gradient, of its norm and, in the
     median, of each splat's own gradient (kernel B's training form first:
     last exactly, T to 2e-4); at the headline frame's passes B and C read
     pair records packed once, as the main path hands them: B's outputs
     must equal those of B packing its own, bit for bit. For both passes
     of the headline frame: the times of A, the pack, B (eval and training
     forms) and C (CUDA events over back-to-back calls; the pack, B and C
     also replayed as a CUDA graph, and A's part after its host
     synchronisation), their plain versions' (one call: for B and C the
     call that phases 4 and 5 compare, timed), one
     torch.sort(stable=True) of A's pairs' 64-bit keys (A's yardstick,
     timed only), the tile-list lengths (median, p99, max) and the
     pixel-splat pairs in the lists, left by the per-warp cull, in the
     pixels' prefixes and contributing;
  6. the training main path: runner.train.main on the synthetic scene from
     scene init, configs/waymo_val_base.yaml's GS settings, TRAIN_ITERS
     (60) iterations at 1600x1067 (densify at 20, 30 and 40, an opacity
     reset at 30, eval, checkpoint and PLY at 60), then 10 more resumed
     from that checkpoint, and runner.render.main(mode=trajectory) on it;
     the LiDAR condition PNGs of the train and test cameras are rendered
     (kernels A, the pack and B, 4 channels) before the training run. The
     loss must stay finite, train-view PSNR must rise, densify must change
     the valid count, every step must launch kernel C, never the plain
     backward, and kernel C must read the records its forward packed (no
     more packs than kernel B calls);
  7. the train step at the shape users pay for: the 600k-splat pool in a
     2^20-slot background pool, actors and sky of phase 3, the full loss
     stack; median ms per step, peak memory, a per-stage split and the
     profiler's device-busy share.
  8. kernels D (attention forward), E (the temporal stage) and F (its
     attention) against their plain versions in bf16, first at small
     shapes with ragged edges (for D: q x kv of 127 x 129, 129 x 1 and
     300 x 257 at head dims 64 and 128, across its 128-row and 128-key
     tiles), then at every shape of the sampling main path; the largest
     error within 2e-2 and the median within 2e-3 of the largest
     |reference| (that scale floored at 2^-8, see BF16_FLOOR);
  9. the sampling main path: a synthetic 1920x1280 scene (26 frames,
     camera 0) with stand-in LiDAR condition renders and its meta_info,
     then runner.vdm_sample.main at full width (UNet 320 x (1, 2, 4, 4),
     VAE, ViT-H/14 CLIP; 25 frames at 576x1024, bf16, CFG 2.5) with seeded
     random weights whose zero-initialised output layers are perturbed,
     VDM_STEPS Euler steps: finite frames in [-1, 1], exactly 15 / 5 / 11
     launches of D / E / F per Euler step and none of the plain versions;
 10. times: one CFG UNet eval, wall per Euler step, the VAE encode, the
     chunked decode, CLIP, the profiler's device-busy share of one step,
     and per kernel at every main-path shape its CUDA-event time, bound,
     plain time and (kernel D) scaled_dot_product_attention's time, with
     D's TF/s, share of its bound and ratio to that call; then kernels E
     and F split: the profiler's time of each kernel in one fused call
     (the LayerNorms, the GEMMs by epilogue, the attention over T), and
     each GEMM launched alone by epilogue and [M, N, K] on the operands
     the stage gives it, held against its plain version (phase 8's
     limits) and timed beside one F.linear call on the same operands;
 11. kernel D's training form (with lse) and the attention backward
     kernels G (dK, dV) and H (dQ) against their plain versions in bf16
     with seeded cotangents, at small ragged shapes (127 x 129 and 129 x 1
     at head dims 64 and 128 among them: G's 128-key blocks and q tiles),
     then at the three training shapes; phase 8's limits for each of o,
     lse, dq, dk, dv;
 12. the fine-tune main path: runner.vdm_train.main on phase 9's scene at
     full width (25 frames at 576x1024, batch 1, bf16 compute with f32
     masters, remat flash0, the recipe's frozen temporal layers), seeded
     random weights as phase 9, TRAIN_STEPS steps and a checkpoint, then
     one step resumed from it (its own checkpoint counted by its tensors'
     bytes only, so that the script writes under ~35 GB to disk: one
     checkpoint is ~24 GB), then the EMA export loaded back through
     runner.vdm_sample's loader: finite losses, spatial weights moved,
     temporal weights bit-identical, the EMA apart from the weights, the
     step count + 1, the export equal to the EMA in bf16, and exactly
     25 / 15 / 15 launches of D-with-lse / G / H per step and none of D
     without lse, E, F or any plain version;
 13. times: the train step (median of synchronised steps after a warm-up)
     and its split into encode / forward / backward / optimizer + EMA, peak
     memory, the profiler's device-busy share of one step, and per kernel
     (D with lse, G, H) at each training shape its CUDA-event time, bound,
     plain time and one scaled_dot_product_attention forward (D) or
     backward (G + H together), with TF/s, share of bound and ratio to
     that call;
 14. kernel A's variant bench (street_crafter_tpu_torch/scripts/
     bench_phase1_variants.py): K1's row compaction of [117, 4096, 11]
     candidates into 8 per-row lists by the kernel template of
     csrc/row_compact.cu (base, rowbatch with blocks of 128 and 256, bf16,
     count_only), each once with the launch counts set to 0 before and
     read after, then each against its plain version (counts, kept slots
     and checksums exactly equal) and timed beside it, as called (20
     calls) and on the device alone (a CUDA graph of 20 calls);
 15. kernel A's split at both headline passes (phase 4's inputs, kept):
     each kernel's device time and the device's idle gaps in one call,
     from torch.profiler (here and not in phase 5: a profiler session
     before phase 10 once left phase 10's scheduled profile empty);
 16. distillation: phase 9's synthetic 1920x1280 scene (26 frames, camera
     0, one 2 m lane-shift trajectory of 26 novel cameras) with its
     background LiDAR rewritten at LIDAR_POINTS a frame (a condition render
     aggregates up to 21 frames, ~2.1 M points), configs/
     waymo_val_base.yaml's GS and diffusion settings and the engine at
     full width with phase 9's seeded random weights (DISTILL_STEPS Euler
     steps); runner.train.main to DISTILL_ITERS with events at
     DISTILL_EVENTS, the rest resumed from the checkpoint at the last
     event (which runs it again), runner.render.main(mode=diffusion) on
     the checkpoint. Each event: every novel frame filled, finite,
     576x1024, its PNG written and its batch rebuilt; 15 / 5 / 11 launches
     of D / E / F per Euler step the SDS schedule runs, over both windows,
     and no plain version; the weights off the card after it
     (memory_allocated falls by their bytes). Every condition render: one
     launch each of A, the pack and B with 4 channels. GS steps: novel
     views after the first event, kernel C in every step on its forward's
     records. Then one novel camera's condition render through the
     kernels against their plain versions (the worklist exactly, rgb and
     acc to RGB_ALPHA_ATOL, z to RGB_ALPHA_ATOL of the largest z, the PNGs
     within 1), its list lengths and the pairs past 512 a tile, the
     kernels' times and bounds, the first event's wall split, GS ms a step
     before and after it and the peak memory.
 17. the rest of the 3DGS features: phase 3's synthetic scene with a
     COLMAP text model of its background LiDAR points (jittered, written
     by the port's write_text_model where data.use_colmap reads it), phase
     6's GS settings with the cubemap sky (6x1024x1024) in place of the
     Gaussian sky pool, the pose-conditioned colour MLP and its sky MLP;
     runner.train.main for SKY_ITERS iterations from scene init, a resume
     of SKY_RESUME, then runner.render.main(mode=virtual_warp) on the
     checkpoint (front camera, WARP_STEPS steps, WARP_SHIFT m). The loss
     finite; the cubemap and every leaf of the colour MLP moved (the sky's
     MLP, read only by the regulariser at its minimum, stays at its init);
     the 512x1024 latlong PNG beside the PLY; the COLMAP points in the
     init PLY; every GS step one pass (two where the objects-only
     regulariser runs its own), each launching A, the pack, B and C once
     and no plain version; the warps' PNGs at the render's size with masks
     neither empty nor full, through A, the pack and B once a view. Then
     phase 7's train step with the cubemap and the MLPs in place of the
     sky pool: median, peak memory and the split beside phase 7's, and the
     cubemap lookup and the MLPs alone (forward, backward) by CUDA events.
 18. data-parallel training (street_crafter_tpu_torch/parallel/). (a),
     right after phase 7: phase 7's step at train.batch_size 2 (the
     headline camera and a second train camera), on one rank: the median
     of DP_STEPS synchronised steps after a warm-up and the peak beside
     phase 7's, and every kernel of one camera's step launched twice a
     step, no plain version. (b): runner.train.main at train.batch_size 2
     on phase 6's scene data from scene init, DP_MAIN_ITERS iterations
     across densifies: finite losses, the pools changed, kernel C in
     every step on its forward's records. (c), after phase 17: two ranks
     spawned with a file:// rendezvous share the card through gloo (NCCL
     refuses two ranks on one device): the bridge's x2 kernel (X1) on each
     rank's shard of [2, 8, 128], gathered: 2 x, and the kernel equal to
     its plain version (with a probe of gloo's reduce_scatter on CUDA
     tensors); DP_GS_ORDER's batch-2 GS steps on phase 2's 50k splats at
     384x256 with a densify: the ranks' states bit-equal, and within
     DP_GS_TOL of each leaf's largest |value| of a one-rank run; the
     fine-tune at full width (phase 12's engine and recipe, clips of
     DP_VDM frames) under vdm_train.fsdp with one clip a rank: one step,
     its time, the
     gradient all-reduce's and the master gathers' times, each rank's
     peak, then the ranks' masters against one rank's step over both
     clips with accumulate 2 from the same weights and draws (within
     VDM_UPDATE_RTOL of each leaf's update, still leaves bit-equal), and
     D-with-lse / G / H launched 25 / 15 / 15 times a rank. The kernels
     line's launches_by_path gains "data_parallel" ((a) + (b) + (c)'s
     ranks), and a "kernel_shard" row for x2.
 19. the fine-tune's options at full width, after phase 13: (a) phase 12's
     trainer on phase 13's clip under each remat policy (flash0, nothing,
     flash01, flash, flashx, dots; dots at DOTS_FRAMES frames, the longest
     clip whose step fits the card, with flash0 at that length beside it):
     first every policy's loss and gradient norm with the update skipped,
     from the same weights and draws, within POLICY_NORM_RTOL of flash0's;
     then per policy a timed step, the peak, and exactly
     POLICY_D_PER_STEP / 15 / 15 launches of D-with-lse / G / H a step.
     (b) runner.vdm_train's build_trainer with diffusion.add_lora and
     vdm_train.train_peft_adapters at 1 x 25 x 576x1024: LORA_STEPS steps,
     their times and the peak, 25 / 15 / 15 launches a step, every
     adapter and cond_time_stack_embed leaf moved (but the cross-
     attention's q and k adapters, which a length-1 context leaves without
     gradient), every frozen leaf bit-identical;
 20. the sampling options at full width: (a) phase 9's seeded weights
     carried by models/vdm/convert.py into a UNet with
     merge_strategy="fixed" (the JAX layout and back, less the mixers),
     fused temporal: one CFG eval with exactly 15 / 5 / 11 launches of D /
     E / F and a finite output, then kernel E at the fixed alpha and
     kernel F against their plain versions at phase 8's main-path shapes
     (phase 8's limits); (b) runner.reward.main --dataset IMG on phase 9's
     frames at 576x1024, REWARD_ENS members of REWARD_STEPS Euler steps:
     one record in (0, 1] in rewards.jsonl, every member's frame 0 the real
     latent, 15 / 5 / 11 launches per CFG eval; the wall, the encode and
     each member's time;
 21. the semantic channel (kernels B, C and the pack past 7 channels): (a)
     right after phase 2, at each of WIDE_CASES channels on phase 2's 50k
     splats at 384x256 (rgb + depth and seeded logits): the pack equal,
     B (both forms) and C within phase 2's and phase 5's limits; (b) after
     phase 5, the headline frame's foreground with a SemanticField of 19
     classes: render_flat(extra_channels=) forward and backward through
     semantic_loss against a seeded label map (one launch each of A, the
     pack, B and C, a finite gradient), B and C against their plain
     versions at 23 channels (C also on the logits' columns alone), the
     times of A, the pack, B and C at 23 and at 32 channels beside phase
     5's 4-channel times, with their bounds, and the peak; (c) densify
     carrying the field (on the card and on the host: the same) and the
     PLY round trip of its semantic_i. The kernels line's launches_by_path
     gains "remat_policies", "lora", "fixed_blender", "reward" and
     "semantic", and the raster rows "wide": their times at 23 and 32
     channels.
 22. host-side data processing, after phase 18 (c): (a) the LiDAR frame
     core (data_processor/range_images.py::lidar_frame) on a Waymo Open
     Dataset frame at its sizes (TOP 64x2650 and four 200x600 range
     images, three cameras at 1920x1280 and two at 1920x886, four boxes)
     on the card and on the host: points within LIDAR_POINT_ATOL, colours,
     the actor split and the sparse depth maps equal; (b) the heuristic sky
     mask of three 1920x1280 street images on the card and on the host,
     bit-equal; (c) data_processor/pandaset.py::render_scene_conditions on
     a synthetic PandaSet scene at 1920x1080 (100k points a sweep, +-10
     sweeps aggregated, ~2.1 M points a render), camera 0, 3 frames x
     shifts 0 and 2 m: one launch each of A, the pack and B a render and
     none of their plain versions, the PNGs checked, then one render
     against the plain versions (phase 16's checks) with the kernels'
     times and bounds; (d) save_moge_pcd with a seeded stand-in predictor
     on the card and on the host: the same PLYs. Each part's seconds. The
     kernels line's raster rows gain "pandaset" launches and a
     "pandaset_render" row.
 23. frames-axis sequence parallelism, after phase 22, ranks spawned with a
     file:// rendezvous sharing the card through gloo, each part first on
     one rank in this process (kept on the host, freed before the spawn):
     (a) parallel/sample.py::sample_on_mesh on {frames: SP_FRAMES} with
     phase 9's seeded weights, 25 frames at 576x1024, CFG, fused temporal,
     SP_STEPS Euler steps and the chunked decode: rank 0's window against
     one rank's engine.sample (same weights and generator) within
     noise_limits of the control's (one rank with the plain temporal
     stages: bf16 evaluations of the whole network differ by more than
     one kernel's limits), every rank holding the same whole window,
     exactly 15 / 5 / 11 launches of D / E / F a CFG eval a rank, and E
     and F against
     their plain versions at rank 0's token-shard shapes (phase 8's
     limits); (b) phase 19 (b)'s LoRA recipe on {data: 1, frames: f}, one
     step from the same weights and draws as one rank's: the loss within
     SP_LOSS_RTOL, the adapters' gradients within noise_limits of the
     control's (one rank's step on two copies of the clip), the updates'
     agreement reported, frozen leaves bit-equal, 25 / 15 / 15 launches of
     D-with-lse / G / H a rank. f is SP_FRAMES unless SP_FRAMES times the
     memory a one-rank trainer holds before its step passes the card's,
     then SP_FT_FALLBACK (2 ranks of 12 frames). Each part's wall, the
     all-to-all and all-reduce seconds and each rank's peak. The kernels
     line's launches_by_path gains "frames_sp".
 24. distillation on several ranks, right after phase 16 in its scene
     directory (its condition PNGs on disk but the first novel view's):
     runner.train.main on {data: 2} at train.batch_size
     2 with the diffusion hook, two ranks spawned sharing the card through
     gloo, the engine at full width with phase 9's seeded weights on rank
     0 alone, one event at DPD_EVENT of 2 Euler steps (2 windows), then
     GS iterations with novel views: the 26 novel frames filled and
     finite at 576x1024 and bit-equal on both ranks (sha256), rank 1 with
     no engine, no file written and no D / E / F launch, rank 0 with 15 /
     5 / 11 a step and no plain version, rank 0's one condition render
     (while rank 1 waits in the barrier) one A, one pack, one B, kernel C
     in every GS step on each
     rank, check_replicated at the end; the event's wall and split, the
     broadcasts' time, each rank's peak. The frames-sharded event is held
     by the CPU tests only (five sampler ranks fill the card before any GS
     state); phase 23 holds frames-sharded sampling on the card. The
     kernels line's launches_by_path gains "dp_distill".
 25. the W8A8 eval UNet: UNetConfig(quant_convs=True) at full width with
     phase 9's seeded weights, one CFG eval (2 x 25 frames at 72x128)
     against the bf16 eval of the same weights: exactly 50 launches of
     kernel Q (csrc/int8_conv.cu: absmax, quantize, weight quantization,
     the int8 wgmma implicit GEMM fed by TMA) and 15 / 5 / 11 of D / E /
     F, no
     plain version, the per-frame PSNR (min, median, above Q_PSNR_FLOOR)
     and each eval's median of 3; then Q at each distinct shape that eval
     gave it against its plain version (int32 products and scales exactly
     equal, bf16 outputs within 1 ulp), timed beside its bound (int8
     operations at 1,979 TOPS or bytes), the plain version, F.conv2d in
     bf16 and torch._int_mm on the int8 im2col (its products checked
     equal too), and split by launch (q_split: CUDA events around each of
     the four launches, the call enqueued behind a spin kernel; the
     wrapper's host time). The kernels line gains Q with its shapes and
     the eval's sums.
Kernel builds, launches and comparisons raise on failure; no phase catches
its own. TF32 is off for matmuls and cuDNN convolutions throughout.
The last three lines: the card's name and power limit, a JSON object of
per-kernel results, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

RGB_ALPHA_ATOL = 2e-4   # kernel B vs plain: f32, summed in another order
# kernel C vs the plain backward, per field, three ways: the largest error
# over the field's largest |gradient|, the error's norm over the field's
# norm, and the median over splats of each splat's own relative error (so
# small splats count as much as large ones). Kernel C rebuilds T by
# division where the plain version scans with cumprod, sums the suffix in
# another order, and adds per-splat sums with atomics in a run-dependent
# order: f32 rounding, observed below 1e-5 of each
GRAD_RTOL = 1e-4
N_SMALL, W_SMALL, H_SMALL = 50_000, 384, 256
N_HEAVY = 600_000
BKGD_CAPACITY = 2 ** 20     # phase 7: the 600k pool inside a fixed capacity
# phase 6's depth (300 until phase 16 came, 150 until phase 18 came: cut to
# keep the script inside its time limit)
TRAIN_ITERS, RESUME_ITERS = 60, 10
SOURCE = "street_crafter_tpu_torch/csrc/gs_raster.cu"
REPLACES = {"tile_worklist": "street_crafter_tpu/ops/gs_raster_fused.py:86",
            # the pack of pair records B and C read: the first part of
            # compositing on this card
            "pair_records": "street_crafter_tpu/ops/gs_raster_fused.py:255",
            "composite": "street_crafter_tpu/ops/gs_raster_fused.py:255",
            "composite_backward":
                "street_crafter_tpu/ops/gs_raster_train.py:60"}
# kernel A's own kernels, as torch.profiler names them (phase 15)
A_KERNELS = ("worklist_count_kernel", "tile_scan_kernel", "tile_order_kernel",
             "worklist_emit_kernel", "tile_sort_kernel")
VARIANT_SOURCE = "street_crafter_tpu_torch/csrc/row_compact.cu"
VARIANT_REPLACES = {"base": "scripts/bench_phase1_variants.py:45",
                    "rowbatch": "scripts/bench_phase1_variants.py:115",
                    "bf16": "scripts/bench_phase1_variants.py:45",
                    "count_only": "scripts/bench_phase1_variants.py:45"}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


T_START = time.perf_counter()


def log(msg: str) -> None:
    """One status line, after the seconds since the script started."""
    print(f"{time.perf_counter() - T_START:7.1f}s {msg}", flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device-clock ms per call (CUDA events around ``reps`` calls)."""
    import torch
    for _ in range(warmup):
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


def once_ms(fn) -> tuple:
    """``fn``'s result and the device-clock ms of that one call
    (``cuda_ms(fn, 1, warmup=0)``): a plain version that takes seconds is
    compared and timed in the same call."""
    out = []
    ms = cuda_ms(lambda: out.append(fn()), 1, warmup=0)
    return out[0], ms


def check_worklist(wl, ref, label: str) -> None:
    """Kernel A's worklist bit-equal to the plain one, tile order included."""
    import torch
    if wl.n_pairs != ref.n_pairs:
        raise AssertionError(f"{label}: kernel A has {wl.n_pairs} pairs, the "
                             f"plain worklist {ref.n_pairs}")
    for name in ("tile_ids", "gauss_ids", "ranges", "order"):
        a, b = getattr(wl, name), getattr(ref, name)
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"{label}: kernel A {name} differs from the "
                                 f"plain worklist")


def compare(G, args: dict, label: str, phase: int) -> dict:
    """Kernel A and B against their plain versions on the same inputs."""
    import torch
    geo = {k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                "width", "height")}
    wl = G.tile_worklist(**geo)
    ref = G.tile_worklist_reference(**geo)
    check_worklist(wl, ref, label)
    comp = {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                 "colors", "opacities", "width", "height")}
    col, alpha = G.composite(wl, **comp)
    (col_ref, alpha_ref), plain_ms = once_ms(
        lambda: G.composite_reference(wl, **comp))
    C = args["colors"].shape[1]
    n = 3 if C == 4 else C       # C = 4 is rgb + depth, the main path's
    err_rgb = float((col[..., :n] - col_ref[..., :n]).abs().max())
    err_alpha = float((alpha - alpha_ref).abs().max())
    depth = ""
    if C == 4:
        err_depth = float((col[..., 3] - col_ref[..., 3]).abs().max())
        max_depth = float(args["depths"][args["valid"]].max())
        depth = (f", depth channel {err_depth:.3g} (max depth "
                 f"{max_depth:.1f})")
    # the pack kernel inside kernels B and C against its plain version
    rec_args = [comp[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                  "colors", "opacities")]
    if not torch.equal(G.pair_records(wl, *rec_args),
                       G.pair_records_reference(wl, *rec_args)):
        raise AssertionError(f"{label}: the pair records differ from the "
                             f"plain pack")
    log(f"[{phase}] {label}: {wl.n_pairs} pairs, worklist and tile order "
        f"equal, pair "
        f"records equal; composite max err "
        f"{'rgb' if C == 4 else f'{C} channel(s)'} {err_rgb:.3g} alpha "
        f"{err_alpha:.3g} (atol {RGB_ALPHA_ATOL}){depth}")
    if not (err_rgb <= RGB_ALPHA_ATOL and err_alpha <= RGB_ALPHA_ATOL):
        raise AssertionError(f"{label}: kernel B disagrees with the plain "
                             f"composite")
    return {"pairs": wl.n_pairs, "worklist_err": 0,
            "composite_err": max(err_rgb, err_alpha),
            "plain_ms": plain_ms}


def raster_args(flat, w2c, K, width: int, height: int) -> dict:
    """Keyword arguments of rasterize_pixels for a flat soup and camera."""
    from street_crafter_tpu_torch.models.gs.renderer import raster_inputs
    cam_center = -(w2c[:3, :3].T @ w2c[:3, 3])
    return raster_inputs(flat, w2c, K, cam_center, width, height)[1]


def wide_splat_args(device, n=20_000, width=W_SMALL, height=H_SMALL,
                    seed=1) -> dict:
    """Projected splats with 10% of radii in 200..300 px."""
    import torch
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(1.0, 8.0, n).astype(np.float32)
    wide = rng.random(n) < 0.1
    sigma[wide] = rng.uniform(67.0, 100.0, wide.sum())
    ca = 1.0 / sigma ** 2
    cc = 1.0 / (0.7 * sigma) ** 2
    cb = 0.3 * np.sqrt(ca * cc) * rng.uniform(-1, 1, n)
    depth = rng.uniform(1.0, 80.0, n).astype(np.float32)
    colors = np.concatenate([rng.random((n, 3)), depth[:, None]], 1)
    valid = rng.random(n) > 0.05

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(u=t(rng.uniform(-50, width + 50, n)),
                v=t(rng.uniform(-50, height + 50, n)), conic_a=t(ca),
                conic_b=t(cb), conic_c=t(cc), colors=t(colors),
                opacities=t(np.where(rng.random(n) < 0.5,
                                     rng.uniform(0.9, 1.0, n),
                                     rng.uniform(0.02, 0.3, n))),
                depths=t(depth), valid=t(valid, torch.bool),
                radii=t(np.ceil(3 * sigma) * valid), width=width,
                height=height)


def heavy_pool_in_camera(c2w: np.ndarray, device, n: int = N_HEAVY):
    """The post-densification pool (seed 0), moved rigidly from camera
    space into the world frame of a camera with pose ``c2w``."""
    import torch
    from street_crafter_tpu_torch.datasets.synthetic import (
        trained_like_pool_arrays)
    from street_crafter_tpu_torch.models.gs.params import GaussianPool
    from street_crafter_tpu_torch.ops import quaternion as Q
    arrays = {k: torch.tensor(v, device=device)
              for k, v in trained_like_pool_arrays(n, seed=0).items()}
    R = torch.tensor(c2w[:3, :3], dtype=torch.float32, device=device)
    t = torch.tensor(c2w[:3, 3], dtype=torch.float32, device=device)
    arrays["xyz"] = arrays["xyz"] @ R.T + t
    arrays["rotation"] = Q.multiply(Q.from_matrix(R)[None],
                                    arrays["rotation"])
    return GaussianPool(**arrays)


def gs_scene(tmp: str) -> str:
    """Phases 3's and 17's data: the synthetic 1920x1280 scene (4 frames,
    cameras 0-2). Returns its path."""
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    return make_scene(tmp, num_frames=4, img_hw=(1280, 1920))


def prefetch_data(tmp: str) -> dict:
    """Phases 3's, 9's, 16's and 17's data (host work only: images, LiDAR
    and condition PNGs), each made under ``tmp`` in two spawned processes,
    in the order the phases need it, while the phases before it run on the
    card (four at once made phase 3 wait for its data: they share the
    host's cores with the kernels' build). Returns {phase: future of the
    data's path}; the processes and ``tmp`` are removed at exit."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    makers = {3: gs_scene, 9: vdm_clip_root, 16: distill_scene,
              17: gs_scene}
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing
                               .get_context("spawn"))
    atexit.register(shutil.rmtree, tmp, True)
    atexit.register(pool.shutdown, True, cancel_futures=True)
    return {phase: pool.submit(make, os.path.join(tmp, str(phase)))
            for phase, make in makers.items()}


def prefetched(future, phase: int) -> str:
    """The path of a phase's data from ``prefetch_data``, and how long the
    phase waited for it."""
    t0 = time.perf_counter()
    path = future.result()
    log(f"[{phase}] data made in a spawned process beside the earlier "
        f"phases; waited {time.perf_counter() - t0:.1f} s for it")
    return path


def build_main_path_scene(tmp: str, dev, source):
    """Phase 3's scene (``gs_scene``, from ``prefetch_data``), the port's
    scene init, the 600k pool as background and an iteration-0
    checkpoint under ``tmp``. Returns (config, path of its JSON file)."""
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.utils.checkpoint import save_checkpoint
    t0 = time.perf_counter()
    cfg = default_config()
    cfg.source_path = prefetched(source, 3)
    cfg.model_path = os.path.join(tmp, "model")
    cfg.device = "cuda"
    cfg.data.cameras = [0, 1, 2]
    cfg.optim.capacity_obj = 8192
    cfg.optim.capacity_sky = 65536
    cfg.render.save_video = False
    scene = create_scene(cfg)
    info0 = next(i for i in scene.info.train_cameras
                 if i.metadata["cam"] == 0 and i.metadata["frame"] == 0)
    params = dataclasses.replace(
        scene.params, bkgd=heavy_pool_in_camera(info0.c2w, dev))
    save_checkpoint(cfg.model_path, 0, params)
    cfg_path = os.path.join(tmp, "scene.json")
    save_config(cfg, cfg_path)
    log(f"[3] scene + checkpoint ready in {time.perf_counter() - t0:.1f} s: "
        f"{len(scene.info.train_cameras) + len(scene.info.test_cameras)} "
        f"cameras, bkgd {params.bkgd.capacity} splats, actors "
        f"{tuple(params.actors.xyz.shape[:2])}, sky "
        f"{params.sky.num_valid()} valid")
    return cfg, cfg_path


def headline_scene(cfg, dev):
    """(scene, checkpoint params, camera, batch) of the first trajectory
    frame, frame 0 of camera 0."""
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.utils.checkpoint import load_checkpoint
    scene = create_scene(cfg, need_processor=False, init_params=False)
    params, _ = load_checkpoint(cfg.model_path, 0, dev)
    infos = scene.info.train_cameras + scene.info.test_cameras
    i = min(range(len(infos)), key=lambda k: infos[k].uid)
    cam = (scene.train_cameras + scene.test_cameras)[i]
    return scene, params, cam, scene.batch_for(infos[i])


def headline_raster_args(cfg, dev):
    """rasterize_pixels arguments of the headline frame's foreground pass."""
    from street_crafter_tpu_torch.models.gs.scene import flatten_scene
    scene, params, cam, batch = headline_scene(cfg, dev)
    flat = flatten_scene(params, scene.meta, batch["cam_id"],
                         batch["frame_idx"], batch["frame"],
                         batch["timestamp"], include_sky=False,
                         interpolate=True)
    return (raster_args(flat, cam.w2c, cam.K, cam.width, cam.height), cam,
            flat.xyz.shape[0])


def split_args(args: dict) -> tuple[dict, dict]:
    """(worklist, compositing) keyword arguments of raster args."""
    return ({k: args[k] for k in ("u", "v", "radii", "depths", "valid",
                                  "width", "height")},
            {k: args[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                                  "colors", "opacities", "width", "height")})


def compare_backward(G, args: dict, label: str, seed: int,
                     phase: int = 5, shared: bool = False) -> dict:
    """Kernel C against the plain backward, after kernel B's training
    variant against the plain forward's T and last index. ``shared``: B
    and C read records packed once, as the main path hands them, and B's
    outputs must equal those of B packing its own, bit for bit."""
    import torch
    geo, comp = split_args(args)
    wl = G.tile_worklist(**geo)
    rec = None
    if shared:
        rec = G.pair_records(wl, *(comp[k] for k in (
            "u", "v", "conic_a", "conic_b", "conic_c", "colors",
            "opacities")))
    out, alpha, final_T, last = G.composite(wl, **comp, train=True,
                                            records=rec)
    if shared:
        own = G.composite(wl, **comp, train=True)
        if not all(torch.equal(a, b) for a, b in
                   zip((out, alpha, final_T, last), own)):
            raise AssertionError(f"{label}: kernel B on shared records "
                                 f"differs from kernel B packing its own")
        del own
    ref, plain_fwd_ms = once_ms(
        lambda: G.composite_reference(wl, **comp, train=True))
    if not torch.equal(last, ref[3]):
        raise AssertionError(f"{label}: kernel B's last index differs")
    err_T = float((final_T - ref[2]).abs().max())
    if err_T > RGB_ALPHA_ATOL:
        raise AssertionError(f"{label}: kernel B's final T differs ({err_T})")
    rng = np.random.default_rng(seed)
    dev = out.device
    gcol = torch.tensor(rng.normal(size=out.shape), dtype=torch.float32,
                        device=dev)
    gal = torch.tensor(rng.normal(size=alpha.shape), dtype=torch.float32,
                       device=dev)
    state = dict(final_T=final_T, last=last, grad_colors=gcol,
                 grad_alpha=gal)
    got = G.composite_backward(wl, **comp, **state, records=rec)
    want, plain_bwd_ms = once_ms(lambda: G.composite_backward_reference(
        wl, **comp, grad_colors=gcol, grad_alpha=gal))
    fields = {"u": G.GRAD_U, "v": G.GRAD_V, "a": G.GRAD_A, "b": G.GRAD_B,
              "c": G.GRAD_C, "opacity": G.GRAD_OPACITY,
              "absgrad": G.GRAD_ABS, "colors": slice(G.GRAD_COLORS, None)}
    errs, worst_abs, worst_scale = {}, 0.0, 0.0
    for name, col in fields.items():
        errs[name] = grad_errors(got[:, col], want[:, col])
        if errs[name]["abs"] > worst_abs:
            worst_abs, worst_scale = errs[name]["abs"], errs[name]["max"]
    log(f"[{phase}] {label}: {wl.n_pairs} pairs, T err {err_T:.3g}, last "
        f"equal; "
        + ("records packed once: kernel B equal to B packing its own; "
           if shared else "")
        + f"kernel C per field (error / field max, error norm / field norm, "
        f"median per-splat relative error; median |grad|): "
        + ", ".join(f"{k} {e['max_rel']:.2e} {e['norm_rel']:.2e} "
                    f"{e['median_rel']:.2e}; {e['median']:.3g}"
                    for k, e in errs.items())
        + f" (tolerance {GRAD_RTOL} on each); largest absolute error "
        f"{worst_abs:.3g} where the field's largest gradient is "
        f"{worst_scale:.3g}")
    if max(max(e["max_rel"], e["norm_rel"], e["median_rel"])
           for e in errs.values()) > GRAD_RTOL:
        raise AssertionError(f"{label}: kernel C disagrees with the plain "
                             f"backward")
    return {"wl": wl, "comp": comp, "state": state, "err": worst_abs,
            "records": rec, "prefix": int(last.sum()),
            "pixels": last.numel(), "grads": (got, want),
            "plain_ms": {"composite (train)": plain_fwd_ms,
                         "composite_backward": plain_bwd_ms}}


def grad_errors(got, want) -> dict:
    """Errors of one gradient field: largest absolute error, that over the
    field's largest |gradient|, the error norm over the field's norm, and
    the median over nonzero entries of |got - want| / |want|; also the
    field's largest |gradient| and the median of its nonzero ones."""
    import torch
    diff = (got - want).abs().flatten()
    mag = want.abs().flatten()
    nz = mag > 0
    top, norm = float(mag.max()), float(torch.linalg.vector_norm(want))
    return {"abs": float(diff.max()), "max": top,
            "median": float(mag[nz].median()) if bool(nz.any()) else 0.0,
            "max_rel": float(diff.max()) / top if top > 0 else 0.0,
            "norm_rel": (float(torch.linalg.vector_norm(got - want)) / norm
                         if norm > 0 else 0.0),
            "median_rel": (float((diff[nz] / mag[nz]).median())
                           if bool(nz.any()) else 0.0)}


def contributing_pairs(G, wl, comp: dict) -> int:
    """(pixel, splat) pairs inside the image where the splat contributed
    (not skipped) before the pixel's stop: the pairs that do the full work
    of kernels B and C, recomputed as the plain versions do."""
    import torch
    height, width = comp["height"], comp["width"]
    dev = comp["u"].device
    tw, th = G.tile_grid(width, height)
    inside = torch.zeros((th * G.TILE, tw * G.TILE), dtype=torch.bool,
                         device=dev)
    inside[:height, :width] = True
    inside = G._to_tiles(inside, th, tw)               # [tiles, 256]
    n = torch.zeros((), dtype=torch.int64, device=dev)
    for b in G._tile_batches(wl, comp["u"], comp["v"], comp["conic_a"],
                             comp["conic_b"], comp["conic_c"],
                             comp["opacities"], width):
        n += (b.keep & (b.alpha > 0) & inside[b.tiles][:, None, :]).sum()
    return int(n)


# channel counts of phase 2's extra cases: record sizes of 32, 48 and 64
# bytes at the edges of kernels B's and C's templates (4: rgb + depth, the
# main path's)
CHANNEL_CASES = (1, 3, 4, 7)


def channel_case_args(device, C: int) -> dict:
    """wide_splat_args with C channels: rgb + depth for C = 4, else C
    channels in [0, 1]."""
    import torch
    args = wide_splat_args(device, seed=10 + C)
    if C != 4:
        rng = np.random.default_rng(C)
        args["colors"] = torch.tensor(rng.random((args["u"].shape[0], C)),
                                      dtype=torch.float32, device=device)
    return args


def long_list_args(device, n_long: int = 8000, seed: int = 3) -> dict:
    """wide_splat_args (2,000 splats) plus n_long small faint splats in
    front of them inside one 16x16 tile: a list of more than 8,000 pairs
    that no pixel stops in, so the rings of kernels B and C wrap many
    times."""
    import torch
    base = wide_splat_args(device, n=2000, seed=seed)
    rng = np.random.default_rng(seed)
    sigma = rng.uniform(0.5, 2.0, n_long)
    ca = 1.0 / sigma ** 2
    depth = rng.uniform(0.5, 1.0, n_long)    # in front of the base splats
    extra = dict(
        u=160 + rng.uniform(0, 16, n_long), v=96 + rng.uniform(0, 16, n_long),
        conic_a=ca, conic_b=np.zeros(n_long), conic_c=ca,
        colors=np.concatenate([rng.random((n_long, 3)), depth[:, None]], 1),
        opacities=rng.uniform(0.004, 0.02, n_long), depths=depth,
        valid=np.ones(n_long, bool), radii=np.ceil(3 * sigma))
    out = dict(width=base["width"], height=base["height"])
    for k, x in extra.items():
        out[k] = torch.cat([base[k], torch.tensor(x, dtype=base[k].dtype,
                                                  device=device)])
    return out


def forced_list_args(device, n: int = 40_000, seed: int = 5) -> dict:
    """Kernel A's geometry: n small splats inside tile (1, 1) of a 48x48
    image, each also spilling into its neighbours: a list of n pairs,
    longer than a sort block holds."""
    import torch
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return dict(u=t(rng.uniform(16, 32, n)), v=t(rng.uniform(16, 32, n)),
                radii=t(rng.uniform(0.5, 2.0, n)),
                depths=t(rng.uniform(1.0, 80.0, n)),
                valid=t(np.ones(n, bool), torch.bool), width=48, height=48)


def list_lengths(wl) -> dict:
    """Median, 99th percentile and largest tile-list length, in pairs."""
    n = (wl.ranges[:, 1] - wl.ranges[:, 0]).float()
    return {"median": float(n.median()), "p99": float(n.quantile(0.99)),
            "max": float(n.max())}


def pair_counts(G, wl, comp: dict) -> dict:
    """Pixel-splat pairs of one pass, pixels inside the image only: in the
    tile lists (each list's length times its tile's pixels), left by the
    per-warp cull of kernels B and C (warp_cull_reference: per pair, the
    pixels of the warps that keep it)."""
    import torch
    W, H = comp["width"], comp["height"]
    tw, th = G.tile_grid(W, H)
    dev = comp["u"].device
    t = torch.arange(tw * th, device=dev)
    cols = (W - (t % tw) * G.TILE).clamp(max=G.TILE)
    rows = H - (t // tw) * G.TILE                # rows of the tile inside
    r0 = 2 * torch.arange(G.WARPS, device=dev)[None, :]
    warp_px = ((r0 < rows[:, None]).long() + (r0 + 1 < rows[:, None]).long()
               ) * cols[:, None]                 # [tiles, 8]
    lengths = (wl.ranges[:, 1] - wl.ranges[:, 0]).long()
    cull = G.warp_cull_reference(wl, comp["u"], comp["v"], comp["conic_a"],
                                 comp["conic_b"], comp["conic_c"],
                                 comp["opacities"], W)
    kept = (~cull).long() * warp_px[wl.tile_ids.long()]
    return {"lists": int((lengths * warp_px.sum(1)).sum()),
            "after_cull": int(kept.sum())}


def graph_ms(fn, reps: int = 20) -> float:
    """Mean ms per call of ``fn`` captured once as a CUDA graph and
    replayed (CUDA events): the device's time for the call's launches
    without the host's time between them, which back-to-back calls of a
    short pass cannot hide. ``fn`` must not synchronise with the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                      # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(graph.replay, reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def headline_pass(G, args: dict, label: str, gpu: str) -> dict:
    """One pass of the headline frame: kernels A, B (eval and training
    forms) and C against their plain versions, each once, B and C on
    records packed once (phase 4's and 5's limits); each kernel's time
    (CUDA events, mean of back-to-back calls; the pack, B and C also
    replayed as a CUDA graph, and A's part after its host synchronisation)
    and its plain version's (one call: for B and C the comparison's own);
    torch.sort of A's keys; the tile-list lengths and the pixel-splat pair
    counts."""
    import torch
    from street_crafter_tpu_torch.scripts.worklist_split import emission_keys
    stats = compare(G, args, label, 4)
    head = compare_backward(G, args, label, 7, shared=True)
    geo, comp = split_args(args)
    wl, rec = head["wl"], head["records"]
    bwd = dict(head["comp"], **head["state"])
    pack = [comp[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                              "colors", "opacities")]
    # kernel, plain version (or the comparison's one timed call of it),
    # kernel calls, plain calls
    plain_ms = dict(head["plain_ms"], composite=stats["plain_ms"])
    runs = {
        "tile_worklist": (lambda: G.tile_worklist(**geo),
                          lambda: G.tile_worklist_reference(**geo), 10, 3),
        "pair_records": (lambda: G.pair_records(wl, *pack),
                         lambda: G.pair_records_reference(wl, *pack), 20, 1),
        "composite": (lambda: G.composite(wl, **comp, records=rec), None,
                      20, 1),
        "composite (train)": (
            lambda: G.composite(wl, **comp, train=True, records=rec), None,
            20, 1),
        "composite_backward": (
            lambda: G.composite_backward(wl, **bwd, records=rec), None, 20,
            1)}
    times, graphs = {}, {}
    for name, (kern, plain, reps, plain_reps) in runs.items():
        times[name] = (cuda_ms(kern, reps),
                       plain_ms[name] if plain is None else
                       cuda_ms(plain, plain_reps,
                               warmup=1 if plain_reps > 1 else 0))
        if name == "tile_worklist":
            # the part after the host synchronisation: emit and sort
            bins = G._worklist_bins(**geo)
            graphs[name] = graph_ms(lambda: G._worklist_lists(bins),
                                    reps)
            graph = (f" (its part after the host synchronisation as a CUDA "
                     f"graph {graphs[name]:.3f} ms)")
            del bins
        else:
            graphs[name] = graph_ms(kern, reps)
            graph = f" (as a CUDA graph {graphs[name]:.3f} ms)"
        log(f"[5] {label}: {name}: kernel {times[name][0]:.3f} ms{graph}, "
            f"plain {times[name][1]:.3f} ms ({wl.n_pairs} pairs; {gpu})")
    keys = emission_keys(**geo)
    sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), 10)
    log(f"[5] {label}: torch.sort(stable=True) of the {keys.shape[0]} "
        f"64-bit (tile << 32 | depth bits) keys alone, kernel A's "
        f"yardstick (the port never calls it): {sort_ms:.3f} ms; {gpu}")
    del keys
    hits = contributing_pairs(G, wl, comp)
    counts = pair_counts(G, wl, comp)
    n = list_lengths(wl)
    log(f"[5] {label}: tile lists (pairs) median {n['median']:.0f}, p99 "
        f"{n['p99']:.0f}, max {n['max']:.0f} over {wl.ranges.shape[0]} "
        f"tiles; pixel-splat pairs: {counts['lists']} in the lists, "
        f"{counts['after_cull']} left by the per-warp cull "
        f"({100 * counts['after_cull'] / max(counts['lists'], 1):.1f}%), "
        f"{head['prefix']} in the pixels' prefixes, {hits} contributing")
    return {"wl": wl, "times": times, "graphs": graphs, "sort_ms": sort_ms,
            "hits": hits, "prefix": head["prefix"],
            "pixels": head["pixels"], "geo": geo, "errs": {
                "tile_worklist": stats["worklist_err"],
                "pair_records": 0.0,
                "composite": stats["composite_err"],
                "composite_backward": head["err"]}}


def headline_sky_args(cfg, dev):
    """rasterize_pixels arguments of the headline frame's sky pass (the
    renderer's second pass, blended behind the foreground), and its
    splat count."""
    from street_crafter_tpu_torch.models.gs.scene import flatten_scene
    scene, params, cam, batch = headline_scene(cfg, dev)
    flat = flatten_scene(params, scene.meta, batch["cam_id"],
                         batch["frame_idx"], batch["frame"],
                         batch["timestamp"], include_bkgd=False,
                         include_obj=False, include_sky=True)
    return (raster_args(flat, cam.w2c, cam.K, cam.width, cam.height),
            flat.xyz.shape[0])


def bounds(n_splats: int, n_pairs: int, n_tiles: int, pixels: int,
           prefix: int, hits: int, C: int) -> dict:
    """Least time (ms) the card could take for each kernel's function at
    these shapes: bytes moved (each input read once, each output written
    once) over HBM3's rate, or float32 operations over the non-tensor-core
    peak, whichever is larger. ``prefix``: the (pixel, splat) pairs up to
    each pixel's last contributor, the least walk compositing needs; each
    costs the recompute of sigma and alpha. ``hits``: those of them where
    the splat contributed, the only ones that do the rest."""
    def bound(nbytes, flops):
        t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
        return ({"bound_ms": 1e3 * max(t_b, t_f),
                 "bound_by": "bytes" if t_b >= t_f else "operations"})
    splat_attrs = (6 + C) * 4 * n_splats        # u v a b c opacity colours
    lists = 4 * n_pairs + 8 * n_tiles           # gauss ids, tile ranges
    return {
        # u, v, radii, depths (f32) and valid (u8) in; tile and splat ids
        # per pair, the ranges and the tile order out
        "tile_worklist": bound(17 * n_splats + 8 * n_pairs + 16 * n_tiles,
                               0),
        # splat ids per pair and each splat's attributes in, a record of
        # record_floats(C) floats per pair out
        "pair_records": bound(4 * n_pairs + splat_attrs
                              + 4 * n_pairs * ((7 + C + 3) // 4 * 4), 0),
        # per evaluated pair: dx, dy, sigma (11), exp, opacity, min, two
        # gates (~15); per hit also the weight, the T update (3) and a
        # multiply-add per channel
        "composite": bound(splat_attrs + lists + 4 * (C + 1) * pixels,
                           15 * prefix + hits * (3 + 2 * C)),
        # per evaluated pair the same recompute (15); per hit also T by
        # division, c.g_c (2C), dalpha (6), suffix (2), dcolour (C), the
        # eight geometric gradients and |.| (~22), and the warp sums (8 + C)
        "composite_backward": bound(
            splat_attrs + lists + 4 * (C + 3) * pixels
            + (8 + C) * 4 * n_splats, 15 * prefix + hits * (39 + 4 * C)),
    }


def train_config(cfg, iters: int = TRAIN_ITERS):
    """configs/waymo_val_base.yaml's GS settings (diffusion off, the
    seeded LPIPS stand-in), its schedule compressed into ``iters``."""
    cfg.data.split_test = 2
    cfg.model.gaussian.sh_degree = 1
    cfg.model.gaussian.fourier_dim = 1
    cfg.model.gaussian.flip_prob = 0.2
    cfg.model.nsg.opt_track = True
    cfg.diffusion.use_diffusion = False
    o = cfg.optim
    o.densify_grad_threshold = 0.0006
    o.densify_grad_abs_bkgd = True
    o.densify_grad_abs_obj = True
    o.min_opacity = 0.005
    o.lambda_dssim = 0.2
    o.lambda_reg = 0.1
    o.lambda_sky = 0.05
    o.lambda_depth_lidar = 0.01
    o.lambda_lpips = 0.5
    o.lpips_fallback = "random_features"
    o.densify_from_iter = iters // 3
    o.densification_interval = iters // 6
    o.densify_until_iter = 2 * iters // 3
    o.opacity_reset_interval = iters // 2
    cfg.train.iterations = iters
    cfg.train.test_iterations = [iters]
    cfg.train.checkpoint_iterations = [iters]
    cfg.train.save_iterations = [iters]
    cfg.train.log_interval = iters // 6
    return cfg


def n_valid(params) -> int:
    return sum(getattr(params, p).num_valid() for p in ("bkgd", "actors",
                                                        "sky")
               if getattr(params, p) is not None)


def train_main_path(G, source_path: str, tmp: str, gpu: str) -> dict:
    """Phase 6: runner.train.main from scene init, resume, render."""
    import torch
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.runner import create_scene
    from street_crafter_tpu_torch.runner import render as R
    from street_crafter_tpu_torch.runner import train as T
    from street_crafter_tpu_torch.utils.png import read_png
    cfg = train_config(default_config())
    cfg.source_path = source_path
    cfg.model_path = os.path.join(tmp, "train_model")
    cfg.device = "cuda"
    cfg.data.cameras = [0, 1, 2]
    cfg.render.save_video = False
    cfg_path = os.path.join(tmp, "train.json")
    save_config(cfg, cfg_path)
    fresh = cfg.clone()
    fresh.resume = False
    t0 = time.perf_counter()
    init = T.GSTrainer(fresh, create_scene(fresh))
    before = init.evaluate(cameras="train")
    valid0 = n_valid(init.state.params)
    cam0 = init.scene.train_cameras[0]
    log(f"[6] scene init in {time.perf_counter() - t0:.1f} s: "
        f"{valid0} valid splats, train-view PSNR {before['psnr']:.3f} dB "
        f"before training ({cam0.width}x{cam0.height})")
    # the condition PNGs runner.train writes first when lambda_depth_lidar
    # > 0, rendered here so that the training run's time and launches are
    # those of GS training alone
    cams = init.scene.info.train_cameras + init.scene.info.test_cameras
    todo = sum(not all(os.path.exists(c.metadata[f"guidance_{k}_path"])
                       for k in ("rgb", "mask")) for c in cams)
    G.reset_launch_counts()
    t0 = time.perf_counter()
    init.scene.render_conditions(cams)
    torch.cuda.synchronize()
    cond = dict(G.launches)
    log(f"[6] condition renders of {todo} of the {len(cams)} train and "
        f"test cameras in {time.perf_counter() - t0:.1f} s; launches "
        f"{cond}; card {gpu}")
    if cond != {k: todo for k in ("tile_worklist", "pair_records",
                                  "composite") if todo}:
        raise AssertionError(f"a condition render missed a kernel or ran a "
                             f"plain version: {cond}")
    del init

    losses = []
    G.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = T.main(["--config", cfg_path])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(G.launches)
    after = trainer.evaluate(cameras="train")
    valid1 = n_valid(trainer.state.params)
    import json as _json
    with open(os.path.join(cfg.model_path, "logs", "metrics.jsonl")) as f:
        for line in f:
            rec = _json.loads(line)
            if "train/loss" in rec:
                losses.append(rec["train/loss"])
            if "eval/psnr" in rec:
                evals = rec
    log(f"[6] runner.train.main: {TRAIN_ITERS} iterations in {wall:.1f} s "
        f"({1e3 * wall / TRAIN_ITERS:.1f} ms/iteration incl. eval, "
        f"checkpoint and PLY); launches {counts}; card {gpu}")
    log(f"[6] loss every {TRAIN_ITERS // 6} iterations: "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; eval at {TRAIN_ITERS}: PSNR {evals['eval/psnr']:.3f} L1 "
        f"{evals['eval/l1']:.4f} ({evals['eval/n_pairs']:.0f} pairs/view); "
        f"train-view PSNR {before['psnr']:.3f} -> {after['psnr']:.3f} dB; "
        f"valid splats {valid0} -> {valid1}")
    if not (losses and all(np.isfinite(losses))):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not after["psnr"] > before["psnr"]:
        raise AssertionError("training did not raise the train-view PSNR")
    if valid1 == valid0:
        raise AssertionError("densify did not change the valid count")
    if counts.get("composite_backward", 0) < TRAIN_ITERS or \
            counts.get("composite_backward_reference", 0):
        raise AssertionError(f"training missed kernel C or ran the plain "
                             f"backward: {counts}")
    # one pack per kernel B call at most: kernel C reads the records its
    # forward packed and packs none of its own
    if not 0 < counts.get("pair_records", 0) <= counts.get("composite", 0):
        raise AssertionError(f"kernel C packed its own records: {counts}")
    ply = os.path.join(cfg.model_path, "point_cloud",
                       f"iteration_{TRAIN_ITERS}", "point_cloud.ply")
    if not os.path.getsize(ply) > 0:
        raise AssertionError("no PLY export")
    del trainer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    resumed = T.main(["--config", cfg_path,
                      f"train.iterations={TRAIN_ITERS + RESUME_ITERS}"])
    if (resumed.start_iter, resumed.state.step) != (
            TRAIN_ITERS + 1, TRAIN_ITERS + RESUME_ITERS):
        raise AssertionError("resume did not continue at the checkpoint")
    log(f"[6] resumed at {resumed.start_iter}, {RESUME_ITERS} iterations in "
        f"{time.perf_counter() - t0:.1f} s")
    del resumed
    torch.cuda.empty_cache()

    G.reset_launch_counts()
    result = R.main(["--config", cfg_path, "mode=trajectory",
                     "render.save_video=false"])
    render_counts = dict(G.launches)
    if set(render_counts) != {"tile_worklist", "pair_records", "composite"}:
        raise AssertionError(f"the render of the trained checkpoint ran a "
                             f"plain version or a backward: {render_counts}")
    rgb_dir = os.path.join(result["out_dir"], "rgb")
    pngs = sorted(os.listdir(rgb_dir))
    for name in pngs:
        img = read_png(os.path.join(rgb_dir, name))
        if img.shape != (1067, 1600, 3) or img.max() == 0:
            raise AssertionError(f"{name}: shape {img.shape}, max "
                                 f"{img.max()}")
    if len(pngs) != 12:
        raise AssertionError(f"expected 12 rgb PNGs, got {pngs}")
    log(f"[6] render of the trained checkpoint: {len(pngs)} PNGs, "
        f"ms/frame median {statistics.median(result['frame_ms']):.2f}, "
        f"test PSNR {result['psnr']:.3f}; launches {render_counts}")
    return counts


class StageTimer:
    """Wraps module functions so each call synchronises before and after
    and adds its wall time to a named stage (phase 7 only)."""

    def __init__(self):
        import torch
        self.sync = torch.cuda.synchronize
        self.ms: dict[str, float] = {}
        self._undo = []

    def wrap(self, module, attr: str, stage: str) -> None:
        fn = getattr(module, attr)

        def timed(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.sync()
            self.ms[stage] = self.ms.get(stage, 0.0) + \
                1e3 * (time.perf_counter() - t0)
            return out
        setattr(module, attr, timed)
        self._undo.append((module, attr, fn))

    def restore(self) -> None:
        for module, attr, fn in reversed(self._undo):
            setattr(module, attr, fn)


def timed_train_step(G, tcfg, scene, params, cam, batch, dev) -> dict:
    """The trainer's own train step (the objects-only regulariser on, the
    LPIPS stand-in) on ``params``: 5 warm-up steps, the median of 20
    synchronised ones, the peak memory, then a split over 5 more steps with
    every stage synchronised before and after (the cubemap lookup and the
    colour MLPs' forwards among them, where the scene has them). Returns
    the numbers and ``one``, a synchronised step."""
    import torch
    from street_crafter_tpu_torch.models.gs import renderer as RN
    from street_crafter_tpu_torch.ops.lpips import random_feature_lpips
    from street_crafter_tpu_torch.training import gs_trainer as GT
    state = GT.init_train_state(params)
    step = GT.make_train_step(
        tcfg, scene.meta, spatial_lr_scale=scene.extent,
        lpips_fn=random_feature_lpips(device=dev), active_sh_degree=1,
        with_obj_acc=True,
        generator=torch.Generator(device=dev).manual_seed(0))

    def one():
        step(state, cam, batch)
        torch.cuda.synchronize()

    for _ in range(5):
        one()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        one()
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()

    timer = StageTimer()
    timer.wrap(RN, "flatten_scene", "flatten")
    timer.wrap(RN, "raster_inputs", "projection+SH")
    timer.wrap(G, "tile_worklist", "kernel A")
    timer.wrap(G, "pair_records", "pack (shared by B and C)")
    timer.wrap(G, "composite", "kernel B")
    if params.sky_cubemap is not None:
        timer.wrap(RN, "sample_cubemap", "cubemap lookup forward")
    if params.color_mlp is not None:
        timer.wrap(RN, "apply_color_mlp", "colour MLPs forward")
    timer.wrap(GT, "compute_train_loss", "loss (L1/SSIM/LPIPS/...)")
    timer.wrap(G, "composite_backward", "kernel C")
    timer.wrap(GT, "adam_update", "Adam")
    timer.wrap(GT, "accumulate_stats", "stats")
    n_split = 5
    total_ms = []
    try:
        for _ in range(n_split):
            t0 = time.perf_counter()
            one()
            total_ms.append(1e3 * (time.perf_counter() - t0))
    finally:
        timer.restore()
    split = {k: v / n_split for k, v in timer.ms.items()}
    whole = statistics.mean(total_ms)
    # what no forward, Adam or stats wrapper covers: autograd's backward
    # (kernel C within it), plus the hooks' small ops and zeroing the grads
    split["backward total (kernel C within it)"] = whole - sum(
        v for k, v in split.items() if k != "kernel C")
    return {"ms": ms, "median": statistics.median(ms),
            "peak_gib": peak / 2 ** 30, "split": split, "whole": whole,
            "n_split": n_split, "one": one}


def padded_pool(pool, capacity: int, dev):
    """``pool`` in ``capacity`` slots, the new ones zero (invalid)."""
    import torch
    from street_crafter_tpu_torch.models.gs.params import GaussianPool
    pad = capacity - pool.capacity
    return GaussianPool(**{
        k: torch.cat([v, torch.zeros((pad,) + v.shape[1:], dtype=v.dtype,
                                     device=dev)])
        for k, v in dataclasses.asdict(pool).items()})


def phase7_inputs(cfg, dev) -> tuple:
    """(scene, params, camera, batch, train config) of phase 7's step: the
    headline frame, the 600k pool in BKGD_CAPACITY slots, track
    residuals."""
    import torch
    scene, params, cam, batch = headline_scene(cfg, dev)
    C, F, A = scene.meta.track_valid.shape
    params = dataclasses.replace(
        params, bkgd=padded_pool(params.bkgd, BKGD_CAPACITY, dev),
        opt_trans=torch.zeros((C, F, A, 3), device=dev),
        opt_theta=torch.zeros((C, F, A, 1), device=dev))
    return scene, params, cam, batch, train_config(cfg.clone())


# GS train steps under torch.profiler for the device-busy share (phases 7
# and 17): its trace of ~12,000 kernels a step takes seconds to read
BUSY_STEPS = 1


def step_time(G, cfg, dev, gpu: str) -> dict:
    """Phase 7: the trainer's own train step on the 600k pool. Returns
    the step's numbers (phase 17 prints its split beside them)."""
    scene, params, cam, batch, tcfg = phase7_inputs(cfg, dev)
    res = timed_train_step(G, tcfg, scene, params, cam, batch, dev)
    log(f"[7] train step, {N_HEAVY} splats in {BKGD_CAPACITY} bkgd slots + "
        f"actors {tuple(params.actors.xyz.shape[:2])} + sky "
        f"{params.sky.capacity}, {cam.width}x{cam.height}, full loss stack "
        f"(L1, D-SSIM, LPIPS stand-in, sky, obj-acc, LiDAR depth): median "
        f"{res['median']:.2f} ms (min {min(res['ms']):.2f}, max "
        f"{max(res['ms']):.2f}) over 20 steps; max_memory_allocated "
        f"{res['peak_gib']:.2f} GiB; TF32 off; card {gpu}")
    log(f"[7] split, synchronised after each stage, mean of "
        f"{res['n_split']} steps (ms; fg, sky and objects-only passes "
        f"summed): " + "; ".join(f"{k} {v:.3f}"
                                 for k, v in res["split"].items())
        + f"; whole step with the syncs {res['whole']:.2f}")
    one = res.pop("one")

    busy, wall, n, top = busy_share(
        lambda: [one() for _ in range(BUSY_STEPS)])
    if not n:
        log("[7] torch.profiler recorded no device kernels: busy share not "
            "measured")
        return res
    res["busy_share"] = busy / wall
    log(f"[7] torch.profiler over {BUSY_STEPS} step(s): {n} device kernels, "
        f"{busy:.2f} ms busy of {wall:.2f} ms wall: device busy "
        f"{100 * busy / wall:.1f}%, idle "
        f"{100 - 100 * busy / wall:.1f}%; by kernel (ms, launches): "
        + "; ".join(f"{k[:48]} {v[0] / 1e3:.2f} x{v[1]}" for k, v in top))
    return res


# ---------------------------------------------------------------------------
# phases 8-10: the video diffusion sampler (kernels D, E and F)
# ---------------------------------------------------------------------------

VDM_SOURCES = {
    "flash_attention": "street_crafter_tpu_torch/csrc/flash_attention.cu",
    "temporal_block_fused": "street_crafter_tpu_torch/csrc/temporal_block.cu",
    "temporal_attention_fused":
        "street_crafter_tpu_torch/csrc/temporal_block.cu"}
VDM_REPLACES = {
    "flash_attention": "street_crafter_tpu/ops/flash_attention.py:29",
    "temporal_block_fused": "street_crafter_tpu/ops/temporal_block.py:72",
    "temporal_attention_fused": "street_crafter_tpu/ops/temporal_block.py:138"}
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
VDM_STEPS = 3                 # Euler steps of phase 9 (the work per step
                              # does not depend on the number of steps)
# kernels D, E and F against their plain versions, in bf16: the largest
# error over the largest |reference| and the median error over it. The
# kernels sum in another order, kernel D rounds its probabilities to bf16
# against a running max (the plain version against the final one), and
# both sides round the same bf16 intermediates, so an intermediate that
# rounds the other way moves an output by a bf16 ulp or two
BF16_MAX_REL, BF16_MED_REL = 2e-2, 2e-3
# the floor of that scale: with one key (Skv = 1) the reference dk and dq
# vanish (a softmax over one key has no gradient with respect to its
# score), and both sides hold only rounding noise, ~1e-6
BF16_FLOOR = 2.0 ** -8
# main-path shapes of one CFG UNet eval (2 x 25 frames, latents 72 x 128):
# kernel D [B*T, S, heads, 64] at levels 0-2 (5 sites each); kernel E
# (B, T, S, C, heads) at level 0 (5 sites); kernel F at level 1, level 2 and
# the mid block (5 + 5 + 1 sites)
D_SHAPES = [(50, 9216, 5, 64), (50, 2304, 10, 64), (50, 576, 20, 64)]
E_SHAPES = [(2, 25, 9216, 320, 5)]
F_SHAPES = [(2, 25, 2304, 640, 10), (2, 25, 576, 1280, 20),
            (2, 25, 144, 1280, 20)]
PER_STEP = {"flash_attention": 15, "temporal_block_fused": 5,
            "temporal_attention_fused": 11}
VDM_KERNELS = tuple(PER_STEP)       # kernels D, E and F


def bf16_errors(got, want) -> dict:
    d = (got.float() - want.float()).abs()
    top = float(want.float().abs().max())
    scale = max(top, BF16_FLOOR)
    return {"abs": float(d.max()), "max_rel": float(d.max()) / scale,
            "med_rel": float(d.median()) / scale, "ref_max": top}


def check_errors(label: str, e: dict, phase: int) -> None:
    log(f"[{phase}] {label}: largest error {e['abs']:.4g} = "
        f"{e['max_rel']:.3e} of the largest |reference| {e['ref_max']:.4g}, "
        f"median error {e['med_rel']:.3e} of it (tolerances {BF16_MAX_REL} "
        f"and {BF16_MED_REL})")
    if e["max_rel"] > BF16_MAX_REL or e["med_rel"] > BF16_MED_REL:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version")


def attn_inputs(dev, b, s, h, d, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3)]


def plain_attention(FA, q, k, v):
    """Kernel D's plain version over [B, S, H, D] in chunks of batch*heads
    (the f32 scores of one (batch, head) at S = 9216 are 340 MB)."""
    import torch
    out = torch.empty_like(q)
    S = q.shape[1]
    hc = max(1, min(q.shape[2], (2 << 30) // (S * S * 4)))
    for b in range(q.shape[0]):
        for h0 in range(0, q.shape[2], hc):
            sl = (slice(b, b + 1), slice(None), slice(h0, h0 + hc))
            out[sl] = FA.flash_attention_reference(q[sl], k[sl], v[sl])
    return out


def stage_inputs(dev, B, T, S, C, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=g, device=dev) * sc).to(
            torch.bfloat16)
    inner = 4 * C
    w = dict(norm_in_s=1 + r(C, sc=.1), norm_in_b=r(C, sc=.1),
             ffin_w1=r(2 * inner, C, sc=C ** -.5), ffin_b1=r(2 * inner, sc=.1),
             ffin_w2=r(C, inner, sc=inner ** -.5), ffin_b2=r(C, sc=.1),
             norm1_s=1 + r(C, sc=.1), norm1_b=r(C, sc=.1),
             wqkv=r(3 * C, C, sc=C ** -.5), wout=r(C, C, sc=C ** -.5),
             bout=r(C, sc=.1), norm3_s=1 + r(C, sc=.1), norm3_b=r(C, sc=.1),
             ff_w1=r(2 * inner, C, sc=C ** -.5), ff_b1=r(2 * inner, sc=.1),
             ff_w2=r(C, inner, sc=inner ** -.5), ff_b2=r(C, sc=.1))
    return r(B * T, S, C), r(B * T, C, sc=.3), r(B, C, sc=.2), w


def e_args(TB, dev, B, T, S, C, heads, seed):
    h, emb, bias, w = stage_inputs(dev, B, T, S, C, seed)
    return ((h, emb, 0.3, bias, *[w[k] for k in TB._BLOCK_WEIGHTS]),
            dict(num_frames=T, heads=heads, dim_head=C // heads))


def f_args(TB, dev, B, T, S, C, heads, seed):
    h, _, bias, w = stage_inputs(dev, B, T, S, C, seed)
    return ((h, bias, *[w[k] for k in ("norm1_s", "norm1_b", "wqkv", "wout",
                                       "bout")]),
            dict(num_frames=T, heads=heads, dim_head=C // heads))


def compare_vdm_kernels() -> dict:
    """Phase 8: kernels D, E and F against their plain versions, first at
    small shapes with ragged edges, then at every main-path shape. Returns
    the largest absolute error per kernel over the main-path shapes."""
    import torch
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    dev = torch.device("cuda", 0)
    worst = {}
    small_d = [(2, 100, 75, 3, 64), (1, 100, 75, 2, 128),
               (1, 75, 100, 2, 128)] + [
        (1, sq, skv, 2, d) for d in (64, 128)
        for sq, skv in ((127, 129), (129, 1), (300, 257))]
    for i, (b, sq, skv, h, d) in enumerate(small_d):
        q, _, _ = attn_inputs(dev, b, sq, h, d, i)
        _, k, v = attn_inputs(dev, b, skv, h, d, i + 10)
        e = bf16_errors(FA.flash_attention(q, k, v),
                        FA.flash_attention_reference(q, k, v))
        check_errors(f"kernel D q {sq} x kv {skv}, {h} heads x {d}", e, 8)
    for i, (B, T, S, C, heads) in enumerate([(2, 25, 100, 64, 1),
                                             (1, 25, 75, 320, 5)]):
        args, kw = e_args(TB, dev, B, T, S, C, heads, i)
        e = bf16_errors(TB.temporal_block_fused(*args, **kw),
                        TB.temporal_block_fused_reference(*args, **kw))
        check_errors(f"kernel E {B}x{T} frames, S {S}, C {C}", e, 8)
    for i, (B, T, S, C, heads) in enumerate([(2, 25, 75, 640, 10),
                                             (2, 25, 75, 1280, 20)]):
        args, kw = f_args(TB, dev, B, T, S, C, heads, i)
        e = bf16_errors(TB.temporal_attention_fused(*args, **kw),
                        TB.temporal_attention_fused_reference(*args, **kw))
        check_errors(f"kernel F {B}x{T} frames, S {S}, C {C}", e, 8)
    for i, (b, s, h, d) in enumerate(D_SHAPES):
        q, k, v = attn_inputs(dev, b, s, h, d, 100 + i)
        e = bf16_errors(FA.flash_attention(q, k, v),
                        plain_attention(FA, q, k, v))
        check_errors(f"kernel D main path [{b}, {s}, {h}, {d}]", e, 8)
        worst["flash_attention"] = max(worst.get("flash_attention", 0.0),
                                       e["abs"])
        del q, k, v
    for name, shapes, make, plain in (
            ("temporal_block_fused", E_SHAPES, e_args,
             TB.temporal_block_fused_reference),
            ("temporal_attention_fused", F_SHAPES, f_args,
             TB.temporal_attention_fused_reference)):
        for i, (B, T, S, C, heads) in enumerate(shapes):
            args, kw = make(TB, dev, B, T, S, C, heads, 200 + i)
            e = bf16_errors(getattr(TB, name)(*args, **kw),
                            plain(*args, **kw))
            check_errors(f"{name} main path [{B * T}, {S}, {C}]", e, 8)
            worst[name] = max(worst.get(name, 0.0), e["abs"])
            del args
    torch.cuda.empty_cache()
    return worst


def vdm_clip_root(tmp: str) -> str:
    """Phase 9's data: a synthetic scene at 1920x1280 (26 frames, camera
    0), stand-in LiDAR condition renders (the camera image at a seeded
    sparse mask, and the mask) and its meta_info_val.json."""
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    from street_crafter_tpu_torch.datasets.vdm_data import prepare_meta
    from street_crafter_tpu_torch.utils.png import read_png, write_png
    root = os.path.join(tmp, "vdm_data")
    scene = make_scene(root, num_frames=26, img_hw=(1280, 1920),
                       image_cameras=(0,))
    rng = np.random.default_rng(0)
    out = os.path.join(scene, "lidar", "color_render")
    for f in range(26):
        img = read_png(os.path.join(scene, "images", f"{f:06d}_0.png"))
        mask = rng.random(img.shape[:2]) < 0.05
        write_png(os.path.join(out, f"{f:06d}_0.png"),
                  (img[..., :3] * mask[..., None]).astype(np.uint8))
        write_png(os.path.join(out, f"{f:06d}_0_mask.png"),
                  (mask * 255).astype(np.uint8))
    prepare_meta(root, [os.path.basename(scene)], "meta_info_val.json")
    return root


def vdm_main_path(tmp: str, gpu: str, data) -> tuple[dict, str, float]:
    """Phase 9: runner.vdm_sample.main at full width on ``vdm_clip_root``'s
    data (``data``: its future from ``prefetch_data``), seeded random
    weights with the zero-initialised output layers perturbed, VDM_STEPS
    Euler steps. Returns (launch counts, config path, peak GiB)."""
    import torch
    from street_crafter_tpu_torch.models.vdm.engine import \
        VideoDiffusionEngine
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    from street_crafter_tpu_torch.utils.png import read_png
    root = prefetched(data, 9)
    log("[9] data: 26 frames at 1920x1280 + condition renders + "
        "meta_info_val.json")
    cfg = {"device": "cuda", "model_path": os.path.join(tmp, "vdm_out"),
           "diffusion": {"tiny": False, "num_steps": VDM_STEPS,
                         "ckpt_path": "", "init_zero_layers_std": 1.0},
           "vdm_train": {"data_root": root, "height": 576, "width": 1024,
                         "num_frames": 25},
           "render": {"save_video": False}}
    cfg_path = os.path.join(tmp, "vdm.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    # the sample ends in a clamp to [-1, 1]: keep the latents and the
    # decoded frames before it, so that their check can fail
    seen = {}
    decode = VideoDiffusionEngine.decode_latents_chunked

    def decode_and_keep(self, z, chunk=8, overlap=3, frames=None):
        out = decode(self, z, chunk=chunk, overlap=overlap, frames=frames)
        seen["latents"], seen["decoded"] = z.float(), out.float()
        return out

    FA.reset_launch_counts()
    TB.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    VideoDiffusionEngine.decode_latents_chunked = decode_and_keep
    t0 = time.perf_counter()
    try:
        res = VS.main(["--config", cfg_path])
        torch.cuda.synchronize()
    finally:
        VideoDiffusionEngine.decode_latents_chunked = decode
    wall = time.perf_counter() - t0
    counts = {**FA.launches, **TB.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frames = res["frames"]
    log(f"[9] runner.vdm_sample.main: 1 clip, 25 frames at 576x1024, "
        f"{VDM_STEPS} Euler steps, CFG 2.5, in {wall:.1f} s (sample "
        f"{res['sample_s'][0]:.1f} s incl. encode, CLIP, decode; engine "
        f"build and data loading outside it); launches {counts}; "
        f"max_memory_allocated {peak:.2f} GiB; card {gpu}")
    want = {k: v * VDM_STEPS for k, v in PER_STEP.items()}
    if counts != want:
        raise AssertionError(f"the main path's launches {counts} are not "
                             f"{PER_STEP} per Euler step x {VDM_STEPS}")
    if frames.shape != (25, 576, 1024, 3) or not np.isfinite(frames).all() \
            or np.abs(frames).max() > 1.0:
        raise AssertionError(f"samples: shape {frames.shape}, finite "
                             f"{np.isfinite(frames).all()}, max |x| "
                             f"{np.abs(frames).max()}")
    # before the clamp: finite latents and frames, neither constant nor
    # blown up (a saturated decode would be clamped almost everywhere)
    z, dec = seen["latents"], seen["decoded"]
    z_std, dec_std = float(z.std()), float(dec.std())
    clamped = float((dec.abs() > 1.0).float().mean())
    log(f"[9] before the clamp: latents {tuple(z.shape)} mean "
        f"{float(z.mean()):.4f} std {z_std:.4f}; decoded std {dec_std:.4f}, "
        f"max |x| {float(dec.abs().max()):.3f}, share clamped {clamped:.4f}")
    if z.shape[0] != 25 or z.numel() != 25 * 72 * 128 * 4 \
            or not bool(torch.isfinite(z).all()) \
            or not bool(torch.isfinite(dec).all()) \
            or not 1e-3 < z_std < 1e3 or not dec_std > 1e-3 \
            or not clamped < 0.9:
        raise AssertionError(
            f"before the clamp: latents {tuple(z.shape)} std {z_std} (want "
            f"finite, in (1e-3, 1e3)); decoded std {dec_std} (want finite, "
            f"> 1e-3), share clamped {clamped} (want < 0.9)")
    pngs = sorted(os.listdir(res["clips"][0]))
    img = read_png(os.path.join(res["clips"][0], pngs[-1]))
    if len(pngs) != 25 or img.shape != (3 * 576, 1024, 3):
        raise AssertionError(f"{len(pngs)} PNGs, last {img.shape}")
    log(f"[9] 25 PNGs {img.shape[1]}x{img.shape[0]} (gt | condition | "
        f"sample); sample mean {frames.mean():.4f} std {frames.std():.4f} "
        f"min {frames.min():.3f} max {frames.max():.3f}")
    return counts, cfg_path, peak


def sync_ms(fn, reps: int, warmup: int = 1) -> list[float]:
    """Host-clock ms of ``reps`` calls, each ending in a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


# the port's own CUDA kernels (D, G, H; E's and F's pieces) in a profiler
# trace
PORT_KERNEL = re.compile(
    r"\(anonymous namespace\)::(flash_|gemm_kernel|tattn_kernel|ln_kernel)")


def busy_share(fn) -> tuple[float, float, int, list]:
    """torch.profiler over one call: (busy ms, wall ms, kernels, top): top
    is the 8 kernels with the most device time, then every kernel of the
    port's own (PORT_KERNEL) below them."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, end = 0.0, -1.0
    for s0, s1 in spans:
        if s1 > end:
            busy += s1 - max(s0, end)
            end = s1
    by_name: dict[str, list] = {}
    for e in kern:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us()
        rec[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    top = ranked[:8] + [kv for kv in ranked[8:] if PORT_KERNEL.search(kv[0])]
    return busy / 1e3, wall, len(kern), top


def vdm_times(cfg_path: str, gpu: str) -> None:
    """Phase 10, end to end: one CFG UNet eval, wall per Euler step, the
    VAE encode of the guidance frames, the chunked decode, CLIP, and the
    device-busy share of one step."""
    import torch
    from street_crafter_tpu_torch.config import default_config, load_config
    from street_crafter_tpu_torch.models.vdm import diffusion as D
    from street_crafter_tpu_torch.models.vdm.samplers import euler_edm_sample
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    cfg = default_config()
    cfg.merge(load_config(cfg_path))
    eng = VS.build_engine(cfg, 25)
    dev = eng.device
    g = torch.Generator(device=dev).manual_seed(1)
    guide = torch.rand((25, 576, 1024, 3), generator=g, device=dev) * 2 - 1
    enc = sync_ms(lambda: eng.encode_images_chunked(guide, 8), 2)
    clip = sync_ms(lambda: eng.clip_embed(guide[:1]), 3)
    lat = eng.encode_images_chunked(guide, 8)
    cond, uc = eng.build_conditioning(guide[:1])
    cm = torch.zeros(25, device=dev)
    cm[0] = 1.0
    denoise = eng.make_cfg_denoise_fn(cond, uc, lat, cm)
    x = torch.randn((25, 72, 128, 4), generator=g, device=dev)
    sigma = torch.full((25,), 10.0, device=dev)
    unet = sync_ms(lambda: denoise(x, sigma), 3)
    sig2 = D.edm_sigmas(2, device=dev)          # 2 Euler steps
    step = [t / 2 for t in sync_ms(
        lambda: euler_edm_sample(denoise, x, sig2), 2)]
    dec = sync_ms(lambda: eng.decode_latents_chunked(lat, 8), 1)
    log(f"[10] CFG UNet eval (2 x 25 frames at 72x128, bf16): median "
        f"{statistics.median(unet):.1f} ms of {[round(t, 1) for t in unet]}"
        f"; wall per Euler step {statistics.median(step):.1f} ms; VAE encode"
        f" of 25 guidance frames (chunks of 8) {statistics.median(enc):.1f}"
        f" ms; chunked decode of 25 frames (8, overlap 3) {dec[0]:.1f} ms; "
        f"CLIP {statistics.median(clip):.1f} ms; card {gpu}")
    busy, wall, n, top = busy_share(
        lambda: euler_edm_sample(denoise, x, D.edm_sigmas(1, device=dev)))
    if n:
        log(f"[10] torch.profiler over one Euler step: {n} device kernels, "
            f"{busy:.1f} ms busy of {wall:.1f} ms wall: device busy "
            f"{100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%"
            f"; by kernel (ms, launches): "
            + "; ".join(f"{k[:56]} {v[0] / 1e3:.2f} x{v[1]}"
                        for k, v in top))
    else:
        log("[10] torch.profiler recorded no device kernels: busy share not "
            "measured")
    del eng, denoise, cond, uc, lat, guide
    torch.cuda.empty_cache()


def vdm_bound(nbytes: float, flops: float) -> dict:
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS
    return {"bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations"}


def with_rates(row: dict, flops: float) -> dict:
    """A kernel row with its TF/s, its share of the bound (bound_ms / ms)
    and its time over the library call's (None without one)."""
    lib = row["library_ms"]
    return dict(row, tflops=flops / row["ms"] / 1e9,
                bound_share=row["bound_ms"] / row["ms"],
                library_ratio=None if lib is None else row["ms"] / lib)


def rates_text(r: dict, lib_name: str) -> str:
    return (f"; {r['tflops']:.1f} TF/s, {100 * r['bound_share']:.1f}% of "
            f"the bound" + ("" if r["library_ratio"] is None else
                            f", {r['library_ratio']:.3f}x {lib_name}"))


def vdm_kernel_times(gpu: str) -> dict:
    """Phase 10, per kernel at every main-path shape: CUDA-event ms, the
    plain version's ms, the bound and, for kernel D, one call of
    torch.nn.functional.scaled_dot_product_attention on the same inputs
    (timed only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    dev = torch.device("cuda", 0)
    rows = {"flash_attention": [], "temporal_block_fused": [],
            "temporal_attention_fused": []}
    for i, (b, s, h, d) in enumerate(D_SHAPES):
        q, k, v = attn_inputs(dev, b, s, h, d, 300 + i)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = 4 * s * s * d * b * h
        rows["flash_attention"].append(with_rates({
            "shape": [b, s, h, d],
            "ms": cuda_ms(lambda: FA.flash_attention(q, k, v), 5),
            "plain_ms": cuda_ms(lambda: plain_attention(FA, q, k, v), 1,
                              warmup=0),
            "library_ms": cuda_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), 5),
            **vdm_bound(2 * 4 * b * s * h * d, flops)}, flops))
        del q, k, v, qt, kt, vt
    for name, shapes, make, plain, full in (
            ("temporal_block_fused", E_SHAPES, e_args,
             TB.temporal_block_fused_reference, True),
            ("temporal_attention_fused", F_SHAPES, f_args,
             TB.temporal_attention_fused_reference, False)):
        for i, (B, T, S, C, heads) in enumerate(shapes):
            args, kw = make(TB, dev, B, T, S, C, heads, 400 + i)
            cost = TB.stage_cost(B, T, S, C, full)
            rows[name].append(with_rates({
                "shape": [B * T, S, C],
                "ms": cuda_ms(lambda: getattr(TB, name)(*args, **kw), 5),
                "plain_ms": cuda_ms(lambda: plain(*args, **kw), 1, warmup=0),
                "library_ms": None,
                **vdm_bound(cost["bytes"], cost["flops"])}, cost["flops"]))
            del args
    for name, shapes, full in (("temporal_block_fused", E_SHAPES, True),
                               ("temporal_attention_fused", F_SHAPES, False)):
        for i, (B, T, S, C, heads) in enumerate(shapes):
            r = rows[name][i]
            r["split"] = stage_split(TB, dev, B, T, S, C, heads, 400 + i,
                                     full)
            log(f"[10] {name} {r['shape']} split: "
                + split_text(r["split"], r["ms"]) + f"; {gpu}")
            torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            log(f"[10] {name} {r['shape']}: kernel {r['ms']:.3f} ms, bound "
                f"{r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.1f} ms"
                + (f", scaled_dot_product_attention {r['library_ms']:.3f} ms"
                   if r["library_ms"] is not None else "")
                + rates_text(r, "scaled_dot_product_attention") + f"; {gpu}")
    torch.cuda.empty_cache()
    return rows


# a kernel's name in a profiler listing without its arguments
KERNEL_NAME = re.compile(r"\w+_kernel<[^>]*>")


# host seconds between the profiler's window edges and the profiled calls.
# With none, profiles of one fused call of kernel E or F on the H100 miss
# some of its kernels now and then (10 of 520, some with none at all);
# with 10 ms, none of 520 did (street_crafter_tpu_torch/scripts/
# profile_window.py counts them). Whole runs of this script still lost F's
# first kernel at [50, 2304, 640] from every profile of some runs, so the
# calls kept are those that marker kernels bound on both sides.
PROFILE_GAP_S = 0.01
PROFILE_CALLS = 4          # calls of fn in the recorded step
PROFILE_TRIES = 3
MARKER = "spin_kernel"     # torch.cuda._sleep's kernel


def kernel_ms(fn, gap_s: float = PROFILE_GAP_S,
              calls: int = PROFILE_CALLS) -> dict:
    """The port's kernels in each of ``calls`` calls of fn, from
    torch.profiler. fn runs in two warm-up steps of the profiler's schedule
    (on the H100 a profile of a single call once recorded 2 of kernel E's
    10 launches and none of F's 4, a call after two warm-up steps every
    launch), then ``calls`` times in the one recorded step, each call after
    a marker kernel (``torch.cuda._sleep``) and one more marker after the
    last. A call counts only where markers bound it on both sides, so
    kernels the profiler loses at its window's edges cannot shorten a kept
    call. The host waits ``gap_s`` after the window opens and before it
    closes. Returns {"calls": [[(kernel, device ms, launches)], largest
    first, for each bounded call], "markers": markers seen, "outside": the
    port's kernels seen outside bounded calls}."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    events = []
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=2, active=1),
            on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
        time.sleep(gap_s)
        for _ in range(calls):
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(gap_s)
        prof.step()
    seq = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        m = KERNEL_NAME.search(e.name)
        if m or MARKER in e.name:
            seq.append((e.time_range.start, m.group(0) if m else None,
                        e.time_range.elapsed_us() / 1e3))
    seq.sort(key=lambda r: r[0])
    marks = [i for i, r in enumerate(seq) if r[1] is None]
    bounded = []
    for a, b in zip(marks, marks[1:]):
        by_name: dict[str, list] = {}
        for _, name, ms in seq[a + 1:b]:
            rec = by_name.setdefault(name, [0.0, 0])
            rec[0] += ms
            rec[1] += 1
        bounded.append(sorted(((k, v[0], v[1]) for k, v in by_name.items()),
                              key=lambda r: -r[1]))
    inside = sum(n for c in bounded for _, _, n in c)
    return {"calls": bounded, "markers": len(marks),
            "outside": len(seq) - len(marks) - inside}


def fused_stage_call(TB, h, emb, bias, w, T: int, heads: int, full: bool):
    """One call of kernel E's (``full``) or F's fused stage on
    stage_inputs' tensors, and the number of kernels it launches."""
    C = h.shape[-1]
    kw = dict(num_frames=T, heads=heads, dim_head=C // heads)
    if full:
        return (lambda: TB.temporal_block_fused(
            h, emb, 0.3, bias, *[w[k] for k in TB._BLOCK_WEIGHTS], **kw)), 10
    return (lambda: TB.temporal_attention_fused(
        h, bias, *[w[k] for k in ("norm1_s", "norm1_b", "wqkv", "wout",
                                  "bout")], **kw)), 4


def stage_split(TB, dev, B, T, S, C, heads, seed, full: bool) -> list:
    """Phase 10: kernel E's (``full``) or F's split at one shape. First the
    device time of each kernel in one fused call, from torch.profiler, the
    mean over the profiled calls that kernel_ms keeps whole (the
    LayerNorms and the attention over T are timed only so). Then each GEMM
    launched alone through ``temporal_gemm`` on the operands the stage
    gives it (the chain of kernels E and F, with the plain LayerNorm and
    attention between the GEMMs), held against its plain version on the
    same operands, its CUDA-event ms beside one
    torch.nn.functional.linear call (timed only; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    h, emb, bias, w = stage_inputs(dev, B, T, S, C, seed)
    BT, M = B * T, B * T * S
    call, want = fused_stage_call(TB, h, emb, bias, w, T, heads, full)
    # the split is the mean over the bounded calls that hold every kernel
    # of the call; a profile with an incomplete call is logged, one with no
    # whole call taken anew, at most PROFILE_TRIES times
    for attempt in range(PROFILE_TRIES):
        got = kernel_ms(call)
        whole = [c for c in got["calls"] if sum(n for _, _, n in c) == want]
        if len(whole) < PROFILE_CALLS:
            log(f"[10] profile {attempt + 1}: {len(whole)} of "
                f"{len(got['calls'])} bounded calls held all {want} "
                f"kernels; {got['markers']} of {PROFILE_CALLS + 1} markers, "
                f"{got['outside']} kernels outside them; {got['calls']}")
        if whole:
            break
    if not whole:
        raise AssertionError(f"no call in {PROFILE_TRIES} profiles held all "
                             f"{want} kernels of one fused call: {got}")
    counts = [{k: n for k, _, n in c} for c in whole]
    if any(c != counts[0] for c in counts):
        raise AssertionError(f"the whole calls' launches differ: {counts}")
    times = [{k: t for k, t, _ in c} for c in whole]
    prof = sorted(((k, statistics.mean(t[k] for t in times), n)
                   for k, n in counts[0].items()), key=lambda r: -r[1])
    rows = [{"piece": f"{name} in the fused call", "ms": ms, "launches": n}
            for name, ms, n in prof]

    def gemm(epi, a, wname, bname, **ekw):
        wt = w[wname]
        b = None if bname is None else w[bname]
        N = wt.shape[0] // 2 if epi == "geglu" else wt.shape[0]
        out = TB.temporal_gemm(epi, a, wt, b, **ekw)
        e = bf16_errors(out, TB.temporal_gemm_reference(epi, a, wt, b,
                                                        **ekw))
        shape = [M, N, a.shape[1]]
        check_errors(f"GEMM {epi} {shape} alone", e, 10)
        ms = cuda_ms(lambda: TB.temporal_gemm(epi, a, wt, b, **ekw), 5)
        lin = cuda_ms(lambda: F.linear(a, wt, b), 5)
        rows.append({"piece": f"GEMM {epi}", "shape": shape, "ms": ms,
                     "linear_ms": lin,
                     "tflops": 2 * M * wt.shape[0] * a.shape[1] / ms / 1e9,
                     "linear_ratio": ms / lin, "max_rel": e["max_rel"],
                     "med_rel": e["med_rel"]})
        torch.cuda.empty_cache()
        return out

    def ln(x, sname, bname):
        return TB._ln(x.reshape(BT, S, C), w[sname], w[bname])

    def attn(y):
        qkv = gemm("store", y.reshape(M, C), "wqkv", None)
        return TB._attn_T(qkv.reshape(BT, S, 3 * C), B, T, S,
                          heads).reshape(M, C)

    if not full:
        att = attn(ln(h, "norm1_s", "norm1_b"))
        gemm("add_f32", att, "wout", "bout", resid=h.reshape(M, C),
             rowbias=bias, rows_per_batch=T * S)
        return rows
    x = (h.float() + emb.float()[:, None]).to(torch.bfloat16).reshape(M, C)
    g = gemm("geglu", ln(x, "norm_in_s", "norm_in_b").reshape(M, C),
             "ffin_w1", "ffin_b1")
    x = gemm("resid", g, "ffin_w2", "ffin_b2", resid=x)
    att = attn(ln(x, "norm1_s", "norm1_b"))
    x = gemm("resid_bias", att, "wout", "bout", resid=x, rowbias=bias,
             rows_per_batch=T * S)
    g = gemm("geglu", ln(x, "norm3_s", "norm3_b").reshape(M, C), "ff_w1",
             "ff_b1")
    gemm("resid_blend", g, "ff_w2", "ff_b2", resid=x,
         blend_h=h.reshape(M, C), alpha=0.3)
    return rows


def split_text(rows: list, total_ms: float) -> str:
    parts = []
    for r in rows:
        t = f"{r['piece']} {r['ms']:.3f} ms"
        if "launches" in r:
            t += f" x{r['launches']}"
        if "shape" in r:
            t += (f" alone {r['shape']} ({r['tflops']:.1f} TF/s; F.linear "
                  f"{r['linear_ms']:.3f} ms, {r['linear_ratio']:.2f}x; "
                  f"error {r['max_rel']:.2e} / {r['med_rel']:.2e})")
        parts.append(t)
    prof = sum(r["ms"] for r in rows if "launches" in r)
    alone = sum(r["ms"] for r in rows if "shape" in r)
    return (", ".join(parts) + f"; the fused call's kernels {prof:.3f} ms "
            f"under the profiler, its GEMMs alone {alone:.3f} ms, the fused "
            f"call {total_ms:.3f} ms by CUDA events")


# ---------------------------------------------------------------------------
# phases 11-13: the video diffusion fine-tune (kernel D with lse, G and H)
# ---------------------------------------------------------------------------

BWD_REPLACES = {
    "flash_attention_bwd_dkv": "street_crafter_tpu/ops/flash_attention.py:195",
    "flash_attention_bwd_dq": "street_crafter_tpu/ops/flash_attention.py:246"}
# the training shapes [B*T, S, heads, 64] at levels 0-2 (25 frames, no CFG
# doubling; 5 sites each)
TRAIN_SHAPES = [(25, 9216, 5, 64), (25, 2304, 10, 64), (25, 576, 20, 64)]
# per train step under flash0: 15 forwards with lse + the 10 of levels 1-2
# recomputed, and one G and one H per site
TRAIN_PER_STEP = {"flash_attention_lse": 25, "flash_attention_bwd_dkv": 15,
                  "flash_attention_bwd_dq": 15}
TRAIN_STEPS = 3            # phase 12's first run; then 1 resumed step


def train_attn_case(dev, b, sq, skv, h, d, seed):
    """q, k, v and a seeded cotangent do, bf16."""
    import torch
    q, _, _ = attn_inputs(dev, b, sq, h, d, seed)
    _, k, v = attn_inputs(dev, b, skv, h, d, seed + 1)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    do = torch.randn((b, sq, h, d), generator=g, device=dev).to(
        torch.bfloat16)
    return q, k, v, do


def train_kernels_vs_plain(FA, q, k, v, do, label: str) -> dict:
    """Kernel D with lse, G and H against their plain versions on the same
    inputs (the plain lse and delta feed both backwards). Returns the
    largest absolute error per kernel."""
    import torch
    o, lse = FA._flash_cuda(q, k, v, with_lse=True)
    o_ref, lse_ref = FA.flash_attention_lse_reference(q, k, v)
    delta = FA.attention_delta(o_ref, do)
    dk, dv = FA._flash_bwd_dkv_cuda(q, k, v, do, lse_ref, delta)
    dq = FA._flash_bwd_dq_cuda(q, k, v, do, lse_ref, delta)
    dk_ref, dv_ref = FA.flash_attention_bwd_dkv_reference(q, k, v, do,
                                                          lse_ref, delta)
    dq_ref = FA.flash_attention_bwd_dq_reference(q, k, v, do, lse_ref,
                                                 delta)
    torch.cuda.synchronize()
    worst = {}
    for kernel, name, got, want in (
            ("flash_attention", "o", o, o_ref),
            ("flash_attention", "lse", lse, lse_ref),
            ("flash_attention_bwd_dkv", "dk", dk, dk_ref),
            ("flash_attention_bwd_dkv", "dv", dv, dv_ref),
            ("flash_attention_bwd_dq", "dq", dq, dq_ref)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label} {name}: not finite")
        e = bf16_errors(got, want)
        check_errors(f"{label} {name}", e, 11)
        worst[kernel] = max(worst.get(kernel, 0.0), e["abs"])
    return worst


def compare_train_kernels() -> dict:
    """Phase 11: D with lse, G and H at small ragged shapes, then at the
    training shapes. Returns the largest absolute error per kernel over the
    training shapes."""
    import torch
    from street_crafter_tpu_torch.ops import flash_attention as FA
    dev = torch.device("cuda", 0)
    for i, (b, sq, skv, h, d) in enumerate([(2, 100, 75, 3, 64),
                                            (1, 75, 100, 2, 128),
                                            (1, 300, 257, 2, 64),
                                            (1, 127, 129, 2, 64),
                                            (1, 127, 129, 2, 128),
                                            (1, 129, 1, 2, 64),
                                            (1, 129, 1, 2, 128)]):
        train_kernels_vs_plain(FA, *train_attn_case(dev, b, sq, skv, h, d,
                                                    500 + 10 * i),
                               f"q {sq} x kv {skv}, {h} heads x {d}")
    worst: dict = {}
    for i, (b, s, h, d) in enumerate(TRAIN_SHAPES):
        e = train_kernels_vs_plain(
            FA, *train_attn_case(dev, b, s, s, h, d, 600 + 10 * i),
            f"training shape [{b}, {s}, {h}, {d}]")
        for kname, err in e.items():
            worst[kname] = max(worst.get(kname, 0.0), err)
        torch.cuda.empty_cache()
    return worst


def vdm_train_config(tmp: str, root: str, steps: int) -> str:
    cfg = {"device": "cuda", "model_path": os.path.join(tmp, "vdm_train"),
           "diffusion": {"tiny": False, "ckpt_path": "",
                         "init_zero_layers_std": 1.0,
                         "remat_policy": "flash0"},
           "vdm_train": {"data_root": root, "height": 576, "width": 1024,
                         "num_frames": 25, "batch_size": 1,
                         "samples_per_epoch": steps, "epochs": 1,
                         "ckpt_every": 1000, "log_every": 1,
                         "log_images_every": 0, "num_workers": 2,
                         "slow_temporal_layers": True,
                         "slow_temporal_layers_scale": 0.0}}
    path = os.path.join(tmp, "vdm_train.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def vdm_train_main_path(tmp: str, root: str, gpu: str
                        ) -> tuple[dict, dict]:
    """Phase 12: runner.vdm_train.main at full width on phase 9's data
    (``root``), TRAIN_STEPS steps with a checkpoint, one step resumed from
    it, the EMA export loaded back.
    Returns (the launch counts of both runs, {"trainer": the resumed
    trainer, "config": its config path, "peak_gib", "step_s"})."""
    import gc

    import torch
    from street_crafter_tpu_torch.datasets.vdm_data import prepare_meta
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    from street_crafter_tpu_torch.runner import vdm_train as VT
    from street_crafter_tpu_torch.training import vdm_trainer as TR
    from street_crafter_tpu_torch.utils import checkpoint as CK
    scenes = [d for d in os.listdir(root)
              if os.path.isdir(os.path.join(root, d))]
    prepare_meta(root, scenes, "meta_info_train.json")
    path = vdm_train_config(tmp, root, TRAIN_STEPS)

    # per-step launch counts, and the masters the first run starts from
    per_step, start = [], {}
    step_fn, init_fn = TR.VDMTrainer.train_step, TR.VDMTrainer.__init__

    def counted_step(self, *a, **kw):
        before = {**FA.launches, **TB.launches}
        out = step_fn(self, *a, **kw)
        after = {**FA.launches, **TB.launches}
        per_step.append({k: after[k] - before.get(k, 0) for k in after
                         if after[k] != before.get(k, 0)})
        return out

    def keeping_init(self, engine, masters=None, *a, **kw):
        if masters is not None and not start:
            start.update({k: m.to("cpu", copy=True)
                          for k, m in masters.items()})
        init_fn(self, engine, masters, *a, **kw)

    # the checkpoints: the first run's is written to disk (and timed); the
    # resumed run's is counted by its tensors' bytes only, so that the
    # whole script writes under ~35 GB to disk: one checkpoint of the
    # full-width state (f32 masters, two moments, EMA) is ~24 GB
    saves = []
    save_fn = VT.save_vdm_checkpoint

    def timed_save(model_path, step, state):
        t = time.perf_counter()
        out = save_fn(model_path, step, state)
        size = os.path.getsize(os.path.join(out, CK.VDM_TRAIN_STATE_FILE))
        saves.append((time.perf_counter() - t, size))
        return out

    def counted_save(model_path, step, state):
        # the bytes of the state's tensors (serialising them into a byte
        # count took 16-18 s: cut to pay for phases 24-25)
        t = time.perf_counter()
        n = sum(v.numel() * v.element_size()
                for part in state.to_dict().values() if isinstance(part, dict)
                for v in part.values() if isinstance(v, torch.Tensor))
        saves.append((time.perf_counter() - t, n))
        return CK.checkpoint_dir(model_path, step)

    FA.reset_launch_counts()
    TB.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    TR.VDMTrainer.train_step = counted_step
    TR.VDMTrainer.__init__ = keeping_init
    VT.save_vdm_checkpoint = timed_save
    t0 = time.perf_counter()
    try:
        res = VT.main(["--config", path])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tr = res["trainer"]
        with open(os.path.join(res["model_path"], "logs",
                               "metrics.jsonl")) as f:
            losses = [json.loads(line)["train/loss"] for line in f]
        log(f"[12] runner.vdm_train.main: {res['steps']} steps at full width "
            f"(25 frames at 576x1024, bf16 compute, f32 masters, flash0) in "
            f"{first_s:.1f} s incl. engine build, data, checkpoint and EMA "
            f"export; step s {[round(t, 2) for t in res['step_s']]}; losses "
            f"{[round(x, 4) for x in losses]}; max_memory_allocated "
            f"{peak:.2f} GiB; card {gpu}")
        if res["steps"] != TRAIN_STEPS or len(losses) != TRAIN_STEPS \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"steps {res['steps']}, losses {losses}")
        kept = 0
        base = [n for n, g in tr.labels.items() if g == "base"]
        slow = [n for n, g in tr.labels.items() if g == "slow"]
        still = []
        for name in base:
            if torch.equal(tr.state.masters[name].cpu(), start[name]):
                still.append(name)
        moved = len(base) - len(still)
        if still:
            log(f"[12] spatial leaves that did not move: {still[:12]}")
        for name in slow:
            m = tr.state.masters[name].cpu()
            p = tr.params[name].detach().cpu()
            kept += int(torch.equal(m, start[name])
                        and torch.equal(p, start[name].to(p.dtype)))
        # a length-1 context makes the cross-attention's softmax 1: its
        # query and key projections and the norm in front of them get no
        # gradient, in the JAX package too
        unused = {n for n in base if re.search(
            r"transformer_blocks\.\d+\.(attn2\.to_[qk]|norm2)\.", n)}
        ema_apart = sum(int(not torch.equal(tr.state.ema[n],
                                            tr.state.masters[n]))
                        for n in base if n not in unused)
        log(f"[12] spatial leaves moved {moved} of {len(base)} (unused by "
            f"the length-1 cross-attention: {len(unused)}); temporal "
            f"leaves bit-identical to their start {kept} of {len(slow)} "
            f"(masters and bf16 weights); EMA apart from the masters in "
            f"{ema_apart} of {len(base) - len(unused)} moved leaves")
        if set(still) != unused or kept != len(slow) or not slow \
                or ema_apart != len(base) - len(unused):
            raise AssertionError("the fine-tune's parameter groups did not "
                                 "train as the recipe says")
        del res, tr
        gc.collect()
        torch.cuda.empty_cache()

        VT.save_vdm_checkpoint = counted_save
        t0 = time.perf_counter()
        res = VT.main(["--config", path, "vdm_train.samples_per_epoch=1"])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        TR.VDMTrainer.train_step = step_fn
        TR.VDMTrainer.__init__ = init_fn
        VT.save_vdm_checkpoint = save_fn
    counts = {**FA.launches, **TB.launches}
    tr = res["trainer"]
    log(f"[12] resumed: {res['steps']} step to step {tr.state.step} in "
        f"{resume_s:.1f} s incl. engine build, checkpoint load and EMA "
        f"export; checkpoints (s, bytes): written {saves[0][0]:.1f} s, "
        f"{saves[0][1]}; the resumed state's tensors {saves[-1][0]:.1f} s, "
        f"{saves[-1][1]}; launches per step {per_step}")
    if res["steps"] != 1 or tr.state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"resume: {res['steps']} steps to "
                             f"{tr.state.step}")
    if len(saves) != 2 or abs(saves[1][1] - saves[0][1]) > 1e-3 * saves[0][1]:
        raise AssertionError(f"checkpoints {saves}: want one per run, of "
                             f"one size")
    for i, c in enumerate(per_step):
        if c != TRAIN_PER_STEP:
            raise AssertionError(f"step {i}: launches {c}, want exactly "
                                 f"{TRAIN_PER_STEP}")
    if len(per_step) != TRAIN_STEPS + 1:
        raise AssertionError(f"{len(per_step)} steps counted")

    from street_crafter_tpu_torch.config import default_config, load_config
    scfg = default_config()
    scfg.merge(load_config(path))
    scfg.diffusion.ckpt_path = res["ema_path"]
    eng = VS.build_engine(scfg, 25)
    bad = [n for n, p in eng.unet.named_parameters()
           if not torch.equal(p, tr.state.ema[n].to(p.dtype))]
    log(f"[12] EMA export {os.path.basename(res['ema_path'])} loaded by "
        f"runner.vdm_sample: {len(bad)} of "
        f"{len(list(eng.unet.parameters()))} UNet weights differ from the "
        f"trainer's EMA in bf16")
    if bad:
        raise AssertionError(f"EMA export differs: {bad[:5]}")
    del eng
    torch.cuda.empty_cache()
    return counts, {"trainer": tr, "config": path, "peak_gib": peak}


def vdm_train_times(train: dict, gpu: str) -> dict:
    """Phase 13, end to end: the train step (encode included) and its split,
    peak memory and the device-busy share of one step. Returns the encoded
    batch (phase 19 steps on it)."""
    import torch
    from street_crafter_tpu_torch.config import default_config, load_config
    from street_crafter_tpu_torch.runner import vdm_train as VT
    tr = train["trainer"]
    cfg = default_config()
    cfg.merge(load_config(train["config"]))
    clip = VT.build_sampler(cfg).datasets[0][0]
    batch_np = {k: clip[k][None] for k in ("img_seq", "guide_seq")}
    encode = VT.make_encode_fn(tr.engine)
    g = torch.Generator(device=tr.engine.device).manual_seed(5)

    def step():
        tr.train_step(encode(batch_np["img_seq"], batch_np["guide_seq"]),
                      generator=g)

    torch.cuda.reset_peak_memory_stats()
    steps = sync_ms(step, 3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    enc = sync_ms(lambda: encode(batch_np["img_seq"], batch_np["guide_seq"]),
                  2)
    # the split: synchronise around the loss (forward) and the optimizer
    split = {"forward": [], "optimizer + EMA": []}
    loss_fn, apply_fn = tr._loss, tr._apply

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    batch = encode(batch_np["img_seq"], batch_np["guide_seq"])
    tr._loss, tr._apply = timed("forward", loss_fn), timed(
        "optimizer + EMA", apply_fn)
    try:
        total = sync_ms(lambda: tr.train_step(batch, generator=g), 3,
                        warmup=0)
    finally:
        del tr._loss, tr._apply
    fwd = statistics.median(split["forward"])
    opt = statistics.median(split["optimizer + EMA"])
    tot = statistics.median(total)
    log(f"[13] train step (1 clip of 25 frames at 576x1024, encode "
        f"included): median {statistics.median(steps):.1f} ms of "
        f"{[round(t, 1) for t in steps]}; split: encode "
        f"{statistics.median(enc):.1f} ms, forward {fwd:.1f} ms, backward "
        f"(and the f32 gradient copies) {tot - fwd - opt:.1f} ms, optimizer "
        f"+ EMA {opt:.1f} ms (step without encode {tot:.1f} ms); peak "
        f"max_memory_allocated {peak:.2f} GiB (phase 12 {train['peak_gib']:.2f}"
        f" GiB); card {gpu}")
    busy, wall, n, top = busy_share(step)
    if n:
        log(f"[13] torch.profiler over one train step: {n} device kernels, "
            f"{busy:.1f} ms busy of {wall:.1f} ms wall: device busy "
            f"{100 * busy / wall:.1f}%, idle {100 - 100 * busy / wall:.1f}%"
            f"; by kernel (ms, launches): "
            + "; ".join(f"{k[:56]} {v[0] / 1e3:.2f} x{v[1]}"
                        for k, v in top))
    else:
        log("[13] torch.profiler recorded no device kernels: busy share not "
            "measured")
    return batch


def vdm_train_kernel_times(gpu: str) -> dict:
    """Phase 13, per kernel at each training shape: CUDA-event ms of D with
    lse, G and H, their plain versions' ms, their bounds, and one
    scaled_dot_product_attention forward (with grad, beside D) or backward
    (dq, dk, dv in one call, beside G + H) on the same inputs (timed only;
    the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from street_crafter_tpu_torch.ops import flash_attention as FA
    dev = torch.device("cuda", 0)
    rows = {"flash_attention": [], "flash_attention_bwd_dkv": [],
            "flash_attention_bwd_dq": []}
    for i, (b, s, h, d) in enumerate(TRAIN_SHAPES):
        q, k, v, do = train_attn_case(dev, b, s, s, h, d, 700 + 10 * i)
        o, lse = FA._flash_cuda(q, k, v, with_lse=True)
        delta = FA.attention_delta(o, do)
        x = b * s * h * d * 2            # bytes of one [B, S, H, D] bf16
        r = b * h * s * 4                # bytes of one [B, H, S] f32
        ops = s * s * d * b * h
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt)
        dot = do.transpose(1, 2)
        sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 3)
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt,
                                                                   vt), 3)
        del out
        for name, kern, plain, nbytes, flops, lib in (
                ("flash_attention",
                 lambda: FA._flash_cuda(q, k, v, with_lse=True),
                 lambda: FA.flash_attention_lse_reference(q, k, v),
                 4 * x + r, 4 * ops, sdpa_fwd),
                ("flash_attention_bwd_dkv",
                 lambda: FA._flash_bwd_dkv_cuda(q, k, v, do, lse, delta),
                 lambda: FA.flash_attention_bwd_dkv_reference(
                     q, k, v, do, lse, delta),
                 6 * x + 2 * r, 8 * ops, sdpa_bwd),
                ("flash_attention_bwd_dq",
                 lambda: FA._flash_bwd_dq_cuda(q, k, v, do, lse, delta),
                 lambda: FA.flash_attention_bwd_dq_reference(
                     q, k, v, do, lse, delta),
                 5 * x + 2 * r, 6 * ops, sdpa_bwd)):
            rows[name].append(with_rates({
                "shape": [b, s, h, d], "ms": cuda_ms(kern, 5),
                "plain_ms": cuda_ms(plain, 1, warmup=0),
                "library_ms": lib, **vdm_bound(nbytes, flops)}, flops))
        del q, k, v, do, o, lse, delta, qt, kt, vt
        torch.cuda.empty_cache()
    for name, rs in rows.items():
        what = ("scaled_dot_product_attention forward with grad"
                if name == "flash_attention" else
                "scaled_dot_product_attention backward (dq, dk, dv: G + H)")
        for r in rs:
            log(f"[13] {name} (training) {r['shape']}: kernel "
                f"{r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
                f"({r['bound_by']}), plain {r['plain_ms']:.1f} ms, {what} "
                f"{r['library_ms']:.3f} ms" + rates_text(r, "that call")
                + f"; {gpu}")
    return rows


def ptxas_entries(report: str) -> list[dict]:
    """Per kernel of one `ptxas -v` report: its name with its template
    arguments (flash_fwd_kernel<64, 3, 1>), registers, spill bytes and the
    performance notes ptxas gave it (wgmma serialisation, C75xx)."""
    out, notes = [], []
    for line in report.splitlines():
        m = re.search(r"\((C75\d\d)\) ([^']*)'?(\w*)'?", line)
        if m:
            text = m.group(2).replace("Potential Performance Loss: ", "")
            text = re.sub(r" (for|in) the function\s*$", "", text.strip())
            notes.append((m.group(3), f"{m.group(1)} {text}"))
            continue
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            k = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?",
                          entry)
            kernel = entry if k is None else k.group(1) + (
                "<" + ", ".join(re.findall(r"L[ib](\d+)E", k.group(2)))
                + ">" if k.group(2) else "")
            out.append({"entry": entry, "kernel": kernel, "registers": None,
                        "spill_stores": 0, "spill_loads": 0, "notes": []})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1]["spill_stores"] = int(m.group(1))
            out[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    for fn, note in notes:
        for e in out:
            if fn and e["entry"] in fn:
                e["notes"].append(note)
    return out


def variant_bench(dev, gpu: str) -> tuple[list, dict]:
    """Phase 14: K1's row-compaction variants (kernel A's variant bench) at
    [117, 4096, 11]: each kernel once with the counts set to 0 just before
    and read just after, then each against its plain version and timed
    beside it, as called and on the device alone (street_crafter_tpu_torch/
    scripts/bench_phase1_variants.py)."""
    import torch
    from street_crafter_tpu_torch.ops import row_compact as RC
    from street_crafter_tpu_torch.scripts import bench_phase1_variants as PV
    cand = torch.tensor(PV.make_cand(0), device=dev)
    RC.reset_launch_counts()
    for _, variant, kb in PV.RUNS:
        RC.compact_rows(cand, variant, kb)
    torch.cuda.synchronize()
    counts = dict(RC.launches)
    if counts != {name: 1 for name, _, _ in PV.RUNS}:
        raise AssertionError(f"the variant bench's launches: {counts}")
    rows = PV.run_variants(dev, cand, PEAK_BYTES_S)
    for r in rows:
        log(f"[14] {r['name']} (kb {r['kb']}) on {r['shape']}: "
            f"{'equal' if r['equal'] else 'DIFFERS'} (counts, kept slots, "
            f"checksums; largest checksum error {r['max_abs_err']}); "
            f"{r['kept']} kept, longest count {r['counts_max']}; kernel "
            f"{r['device_ms']:.4f} ms on the device (a CUDA graph of 20 "
            f"calls), {r['ms']:.4f} ms as called (20 calls), bound "
            f"{r['bound_ms']:.4f} ms (bytes, {r['share_of_bound']:.1%} of "
            f"it), plain {r['plain_ms']:.3f} ms; "
            f"launches {counts}; {gpu}")
    bad = [r["name"] for r in rows if not r["equal"]]
    if bad:
        raise AssertionError(f"variant kernels differ from their plain "
                             f"versions: {bad}")
    return rows, counts


def worklist_split(G, inputs: dict, gpu: str) -> dict:
    """Phase 15: kernel A's device split at the headline passes, from
    torch.profiler (scripts/worklist_split.py's device_split)."""
    from street_crafter_tpu_torch.scripts.worklist_split import device_split
    out = {}
    for label, geo in inputs.items():
        # torch.profiler's device trace comes back empty now and then: try
        # again, and leave the split unmeasured if it stays empty
        for _ in range(PROFILE_TRIES):
            sp = device_split(lambda: G.tile_worklist(**geo))
            if sp["calls_traced"]:
                break
        if not sp["calls_traced"]:
            log(f"[15] kernel A, headline {label} pass: torch.profiler "
                f"recorded no device activity in {PROFILE_TRIES} tries")
            out[label] = {"kernels_ms": {}, "busy_ms": None,
                          "span_ms": None, "gaps": []}
            continue
        acts = {}
        for a in sp["activities"]:
            k = next((k for k in A_KERNELS if k in a["name"]), a["name"])
            acts[k] = round(a["ms"], 4)
        out[label] = {"kernels_ms": acts, "busy_ms": sp["busy_ms"],
                      "span_ms": sp["span_ms"], "gaps": sp["gaps"]}
        log(f"[15] kernel A, headline {label} pass, device ms per call "
            f"(torch.profiler, mean of {sp['calls_traced']} calls): "
            + ", ".join(f"{k} {v:.4f}" for k, v in acts.items())
            + f"; busy {sp['busy_ms']:.4f} of a {sp['span_ms']:.4f} ms span; "
            f"largest idle gaps "
            + ", ".join(f"{g['ms']:.4f} ms before {g['before'][:40]}"
                        for g in sp["gaps"][:2]) + f"; {gpu}")
    missing = [k for k in A_KERNELS
               if k not in out.get("foreground", {}).get("kernels_ms", {})]
    if missing:
        log(f"[15] torch.profiler recorded none of {missing}: the split is "
            f"not measured")
    return out


# ---------------------------------------------------------------------------
# phase 16: distillation (the diffusion hook in GS training)
# ---------------------------------------------------------------------------

LIDAR_POINTS = 100_000     # background returns a frame (a Waymo top-LiDAR
# sweep holds ~64 x 2,650 = ~170k before processing)
DISTILL_ITERS = 8
# the sampling events, the checkpoint at the last (cut from [3, 6] to pay
# for phases 24 and 25: one event fewer, ~21-25 s)
DISTILL_EVENTS = [3]
DISTILL_STEPS = 5          # Euler steps (cut from 50): SDS scales 0.7 and
# 0.3 run int(5 x scale) = 3 and 1 of them
DISTILL_WINDOWS = 2        # 26 novel frames in windows of 24, step 20
JAX_TILE_CAP = 512         # JAX's condition raster keeps 512 splats a tile
# one condition render's launches: one A, one pack, one B
ONE_RENDER = {"tile_worklist": 1, "pair_records": 1, "composite": 1}


def distill_scene(tmp: str) -> str:
    """Phase 16's data: phase 9's synthetic 1920x1280 scene (26 frames,
    camera 0) with its background LiDAR rewritten at LIDAR_POINTS a frame,
    ground and walls placed as datasets/synthetic.py places them."""
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    from street_crafter_tpu_torch.utils.ply import write_ply
    scene = make_scene(os.path.join(tmp, "distill_data"), num_frames=26,
                       img_hw=(1280, 1920), image_cameras=(0,))
    rng = np.random.default_rng(16)
    n_g = LIDAR_POINTS * 4 // 5
    n_w = LIDAR_POINTS - n_g
    for f in range(26):
        ground = np.stack([rng.uniform(-5 + 2 * f, 25 + 2 * f, n_g),
                           rng.uniform(-8, 8, n_g), np.zeros(n_g)], -1)
        wall = np.stack([rng.uniform(-5 + 2 * f, 25 + 2 * f, n_w),
                         np.full(n_w, 8.0), rng.uniform(0, 4, n_w)], -1)
        pts = np.concatenate([ground, wall]).astype(np.float32)
        write_ply(os.path.join(scene, "lidar", "background", f"{f:06d}.ply"),
                  pts, rng.uniform(0.2, 1.0, (len(pts), 3)).astype(
                      np.float32), np.ones(len(pts), bool))
    return scene


def distill_config(tmp: str, source: str):
    """configs/waymo_val_base.yaml's GS and diffusion settings (phase 6's
    GS settings; lambda_depth_lidar 0.01, novel_view_prob 0.4, sds_scales
    [0.7, 0.3], window_size 4, params_on_host auto), the engine at full
    width with phase 9's seeded random weights, DISTILL_ITERS iterations
    with events at DISTILL_EVENTS, densify off."""
    from street_crafter_tpu_torch.config import default_config
    cfg = train_config(default_config())
    cfg.source_path = source
    cfg.model_path = os.path.join(tmp, "distill_model")
    cfg.device = "cuda"
    cfg.data.cameras = [0]
    # the reader counts frames by five cameras' images; camera 0's only
    cfg.data.selected_frames = [0, 25]
    cfg.render.novel_view.shift = [2.0]
    cfg.render.save_video = False
    t = cfg.train
    t.iterations = DISTILL_ITERS
    t.test_iterations = []
    t.checkpoint_iterations = [DISTILL_EVENTS[-1]]
    t.save_iterations = []
    t.log_interval = 1
    t.novel_view_prob = 0.4
    cfg.optim.densify_from_iter = 10 ** 6
    cfg.optim.opacity_reset_interval = 10 ** 6
    d = cfg.diffusion
    d.use_diffusion = True
    d.tiny = False
    d.ckpt_path = ""
    d.init_zero_layers_std = 1.0
    d.num_steps = DISTILL_STEPS
    d.sample_iterations = list(DISTILL_EVENTS)
    d.sds_scales = [0.7, 0.3]
    d.window_size = 4
    d.params_on_host = "auto"
    d.height, d.width, d.sample_frames, d.cfg_scale = 576, 1024, 25, 2.5
    return cfg


def counts_now() -> dict:
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.ops import temporal_block as TB
    return {**G.launches, **FA.launches, **TB.launches}


def counts_since(before: dict) -> dict:
    now = counts_now()
    return {k: now.get(k, 0) - before.get(k, 0) for k in now
            if now.get(k, 0) != before.get(k, 0)}


class DistillProbe:
    """Phase 16's instruments around the port's own functions: a stage
    timer (synchronised), the sampling events (launches, frames, PNGs,
    the weights' moves and the card's memory at release), each condition
    render's launches and channel count, the GS steps' kind, time and
    kernel C launches."""

    def __init__(self, gpu: str):
        import torch
        from street_crafter_tpu_torch.data_processor import pointcloud as PC
        from street_crafter_tpu_torch.models.gs import params as PM
        from street_crafter_tpu_torch.models.vdm import engine as EN
        from street_crafter_tpu_torch.ops import gs_raster as G
        from street_crafter_tpu_torch.runner import diffusion as DR
        from street_crafter_tpu_torch.runner import render as R
        from street_crafter_tpu_torch.runner import scene as SC
        from street_crafter_tpu_torch.runner import train as T
        from street_crafter_tpu_torch.runner import vdm_sample as VS
        self.torch, self.G, self.T, self.gpu = torch, G, T, gpu
        self.timer = StageTimer()
        tm = self.timer
        tm.wrap(PC.PointCloudProcessor, "render_conditions", "condition")
        tm.wrap(PC.PointCloudProcessor, "_splat", "condition splat")
        tm.wrap(DR.DiffusionRunner, "load_guidance", "guide PNG load")
        tm.wrap(DR.DiffusionRunner, "load_guidances", "guide PNG load")
        tm.wrap(DR.DiffusionRunner, "load_cond_image", "cond image load")
        tm.wrap(EN.VideoDiffusionEngine, "encode_images", "encode")
        tm.wrap(EN.VideoDiffusionEngine, "clip_embed", "CLIP")
        tm.wrap(EN.VideoDiffusionEngine, "decode_latents_chunked", "decode")
        tm.wrap(EN, "euler_edm_sample_sds", "Euler steps")
        tm.wrap(EN, "euler_edm_sample", "Euler steps")
        # the runs' set-up
        tm.wrap(T, "create_scene", "scene build")
        tm.wrap(PC.PointCloudProcessor, "initialize_ply", "initialize_ply")
        tm.wrap(PM, "mean_dist2_knn3", "scene init KNN")
        tm.wrap(SC.Scene, "render_conditions", "train/test conditions")
        tm.wrap(VS, "build_engine", "engine build")
        tm.wrap(VS, "load_vdm_params", "engine weights init")
        tm.wrap(DR.EngineParamStore, "__init__", "pinned host copy")
        tm.wrap(T.GSTrainer, "__init__", "trainer init")
        self._patch(T, "make_eval_render", self._eval_render)
        self.events, self.renders, self.steps, self.picks = [], [], [], []
        self.stores = []
        self._patch(PC.PointCloudProcessor, "_splat", self._splat)
        self._patch(G, "composite", self._composite)
        self._patch(T, "make_diffusion_hook", self._make_hook)
        self._patch(T.GSTrainer, "pick_camera", self._pick)
        self._patch(T.GSTrainer, "step_fn", self._step_fn)
        self._channels = None
        self._freed = 0

    def _patch(self, owner, attr, make):
        orig = getattr(owner, attr)
        self.timer._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def restore(self) -> None:
        self.timer.restore()

    # -- condition renders: launches and channels
    def _splat(self, orig):
        def splat(proc, *a, **kw):
            before = counts_now()
            self._channels = []
            out = orig(proc, *a, **kw)
            self.renders.append((counts_since(before), self._channels))
            self._channels = None
            return out
        return splat

    def _composite(self, orig):
        def composite(wl, u, v, a, b, c, colors, *rest, **kw):
            if self._channels is not None:
                self._channels.append(int(colors.shape[1]))
            return orig(wl, u, v, a, b, c, colors, *rest, **kw)
        return composite

    # -- the SDS renders (the trainer's eval renders: only the hook's)
    def _eval_render(self, orig):
        torch, tm = self.torch, self.timer

        def make(*a, **kw):
            fn = orig(*a, **kw)

            def render(*ra, **rkw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*ra, **rkw)
                torch.cuda.synchronize()
                tm.ms["SDS render"] = tm.ms.get("SDS render", 0.0) + \
                    1e3 * (time.perf_counter() - t0)
                return out
            return render
        return make

    # -- GS steps
    def _pick(self, orig):
        def pick(trainer, pool):
            info, is_novel = orig(trainer, pool)
            self.picks.append((is_novel, counts_now().get(
                "composite_backward", 0)))
            return info, is_novel
        return pick

    def _step_fn(self, orig):
        torch = self.torch

        def step_fn(trainer, is_novel, *a, **kw):
            step = orig(trainer, is_novel, *a, **kw)

            def timed(*sa, **skw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*sa, **skw)
                torch.cuda.synchronize()
                self.steps.append((is_novel, 1e3 * (time.perf_counter()
                                                    - t0)))
                return out
            return timed
        return step_fn

    # -- sampling events
    def _make_hook(self, orig):
        torch = self.torch

        def make(cfg, *mesh):
            hook = orig(cfg, *mesh)
            store = hook.param_store
            release = store.release

            def checked_release():
                torch.cuda.synchronize()
                m0 = torch.cuda.memory_allocated()
                release()
                torch.cuda.synchronize()
                self._freed = m0 - torch.cuda.memory_allocated()
            store.release = checked_release
            self.stores.append({"nbytes": store.nbytes,
                                "on_host": store.on_host})

            def event(trainer, iteration, scale):
                before, ms0 = counts_now(), dict(self.timer.ms)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hook(trainer, iteration, scale)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                self.events.append(self._check_event(
                    trainer, cfg, iteration, scale, wall,
                    counts_since(before),
                    {k: v - ms0.get(k, 0.0) for k, v in self.timer.ms.items()
                     if v != ms0.get(k, 0.0)}, store))
            return event
        return make

    def _check_event(self, trainer, cfg, iteration, scale, wall, counts,
                     stages, store) -> dict:
        torch = self.torch
        steps = int(DISTILL_STEPS * scale)
        want = {k: v * steps * DISTILL_WINDOWS for k, v in PER_STEP.items()}
        got = {k: counts.get(k, 0) for k in PER_STEP}
        plain = {k: v for k, v in counts.items() if k.endswith("_reference")}
        if got != want or plain:
            raise AssertionError(
                f"event at {iteration}: launches {counts}, want {want} "
                f"({steps} Euler steps x {DISTILL_WINDOWS} windows) and no "
                f"plain version")
        novel = trainer.scene.info.novel_view_cameras
        version = {c.metadata.get("diffusion_version", 0) for c in novel}
        out_dir = os.path.join(trainer.scene.model_path, "diffusion")
        hw = (cfg.diffusion.height, cfg.diffusion.width, 3)
        for c in novel:
            img = c._image
            if img is None or img.shape != hw or \
                    not np.isfinite(img).all():
                raise AssertionError(f"event at {iteration}: novel frame "
                                     f"{c.image_name} not filled")
            png = os.path.join(out_dir, f"{c.image_name}_scale{scale}.png")
            if not os.path.getsize(png) > 0:
                raise AssertionError(f"no diffusion PNG {png}")
            gt = trainer.scene.batch_for(c)["gt_image"]
            if not torch.equal(gt.cpu(), torch.from_numpy(img)):
                raise AssertionError(f"event at {iteration}: the batch of "
                                     f"{c.image_name} was not rebuilt")
        if len(version) != 1:
            raise AssertionError(f"diffusion_version differs: {version}")
        if store.on_host and not (store.host_resident
                                  and self._freed >= store.nbytes):
            raise AssertionError(
                f"event at {iteration}: the engine's weights stayed on the "
                f"card (freed {self._freed} of {store.nbytes} bytes)")
        ev = {"iteration": iteration, "scale": scale, "steps": steps,
              "wall_s": wall, "launches": counts, "stages_ms": stages,
              "moves_s": dict(store.move_s), "freed": self._freed,
              "nbytes": store.nbytes, "version": version.pop(),
              "novel": len(novel)}
        log(f"[16] event at iteration {iteration}: SDS scale {scale:.3f}, "
            f"{steps} Euler steps x {DISTILL_WINDOWS} windows, {len(novel)} "
            f"novel frames {hw[1]}x{hw[0]} filled and finite, PNGs written, "
            f"diffusion_version {ev['version']}, batches rebuilt; wall "
            f"{wall:.2f} s; D / E / F launches {got['flash_attention']} / "
            f"{got['temporal_block_fused']} / "
            f"{got['temporal_attention_fused']}; weights "
            f"{store.nbytes / 2 ** 30:.2f} GiB moved to the card in "
            f"{store.move_s['acquire']:.2f} s and dropped in "
            f"{store.move_s['release']:.3f} s (memory_allocated fell "
            f"{self._freed / 2 ** 30:.2f} GiB); {self.gpu}")
        return ev


def event_split(ev: dict) -> str:
    """The wall split of one sampling event, from the stage timer."""
    st = ev["stages_ms"]
    cond = st.get("condition", 0.0)
    splat = st.get("condition splat", 0.0)
    parts = [("condition renders on the card", splat),
             ("host LiDAR aggregation + condition PNG writes", cond - splat),
             ("guide / cond PNG reads + crop-resize",
              st.get("guide PNG load", 0.0) + st.get("cond image load", 0.0)),
             ("SDS renders", st.get("SDS render", 0.0)),
             ("engine host->card move", 1e3 * ev["moves_s"]["acquire"]),
             ("engine card release", 1e3 * ev["moves_s"]["release"]),
             ("VAE encode", st.get("encode", 0.0)),
             ("CLIP", st.get("CLIP", 0.0)),
             ("Euler steps", st.get("Euler steps", 0.0)),
             ("decode", st.get("decode", 0.0))]
    rest = 1e3 * ev["wall_s"] - sum(v for _, v in parts)
    return ", ".join(f"{k} {v:.1f}" for k, v in parts) + \
        f", rest {rest:.1f} (ms, of {1e3 * ev['wall_s']:.1f})"


def condition_render_vs_plain(G, scene, gpu: str) -> dict:
    """One novel camera's condition render (phase 16)."""
    proc = scene.processor
    novel = scene.info.novel_view_cameras
    cam = novel[len(novel) // 2]
    t0 = time.perf_counter()
    ply = proc.condition_cloud(cam, scene.info.metadata["obj_meta"])
    host_ms = 1e3 * (time.perf_counter() - t0)
    return condition_vs_plain(G, ply, cam, cam.image_name, host_ms, 16, gpu,
                              proc.device)


def condition_vs_plain(G, ply, cam, name: str, host_ms: float, phase: int,
                       gpu: str, device) -> dict:
    """One condition render of an [N, 6] cloud through kernels A, the pack
    and B against their plain versions on the same CUDA tensors, its PNGs,
    its statistics and the kernels' times and bounds."""
    import torch
    from street_crafter_tpu_torch.ops.point_raster import gaussian_splats

    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device, torch.float32).contiguous()
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    args = gaussian_splats(t(cam.c2w), t(cam.K), t(ply[:, :3]),
                           t(ply[:, 3:6]), cam.height, cam.width)
    geo, comp = split_args(args)
    wl = G.tile_worklist(**geo)
    check_worklist(wl, G.tile_worklist_reference(**geo),
                   "condition render")
    pack = [comp[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                              "colors", "opacities")]
    rec = G.pair_records(wl, *pack)
    if not torch.equal(rec, G.pair_records_reference(wl, *pack)):
        raise AssertionError("condition render: the pair records differ "
                             "from the plain pack")
    col, alpha = G.composite(wl, **comp, records=rec)
    (col_ref, alpha_ref), plain_composite_ms = once_ms(
        lambda: G.composite_reference(wl, **comp))
    zmax = float(args["depths"][args["valid"]].max())
    err = {"rgb": float((col[..., :3] - col_ref[..., :3]).abs().max()),
           "acc": float((alpha - alpha_ref).abs().max()),
           "z": float((col[..., 3] - col_ref[..., 3]).abs().max())}
    png = {}
    for key, a, b in (("rgb", col[..., :3], col_ref[..., :3]),
                      ("mask", alpha, alpha_ref)):
        a8 = (a.cpu().numpy() * 255).astype(np.uint8).astype(int)
        b8 = (b.cpu().numpy() * 255).astype(np.uint8).astype(int)
        png[key] = int(np.abs(a8 - b8).max())
    lengths = (wl.ranges[:, 1] - wl.ranges[:, 0]).long()
    n = list_lengths(wl)
    beyond = int((lengths - JAX_TILE_CAP).clamp(min=0).sum())
    counts = pair_counts(G, wl, comp)
    hits = contributing_pairs(G, wl, comp)
    _, _, _, last = G.composite(wl, **comp, train=True, records=rec)
    prefix = int(last.sum())
    log(f"[{phase}] condition render of {name} "
        f"({cam.width}x{cam.height}): {len(ply)} points "
        f"({int(args['valid'].sum())} in front of the camera), "
        f"{wl.n_pairs} (tile, point) pairs over {wl.ranges.shape[0]} tiles; "
        f"lists median {n['median']:.0f}, p99 {n['p99']:.0f}, max "
        f"{n['max']:.0f}; {int((lengths > 8192).sum())} lists past 8,192 "
        f"(sorted in passes over device memory); {beyond} pairs beyond 512 "
        f"in a tile (what JAX's capped condition raster drops); pixel-splat "
        f"pairs {counts['lists']} in the lists, {counts['after_cull']} left "
        f"by the per-warp cull, {prefix} in the pixels' prefixes, {hits} "
        f"contributing; host aggregation {host_ms:.1f} ms; {gpu}")
    log(f"[{phase}] kernels vs plain at the condition render: worklist "
        f"and tile order equal, pair records equal; rgb {err['rgb']:.3g}, acc "
        f"{err['acc']:.3g} (atol {RGB_ALPHA_ATOL}), z {err['z']:.3g} (atol "
        f"{RGB_ALPHA_ATOL} x max z {zmax:.1f}); PNGs within "
        f"{max(png.values())} in uint8")
    if not (err["rgb"] <= RGB_ALPHA_ATOL and err["acc"] <= RGB_ALPHA_ATOL
            and err["z"] <= RGB_ALPHA_ATOL * zmax and max(png.values()) <= 1):
        raise AssertionError(f"condition render: kernels disagree with the "
                             f"plain versions: {err}, PNGs {png}")
    runs = {"tile_worklist": (lambda: G.tile_worklist(**geo),
                              lambda: G.tile_worklist_reference(**geo), 10),
            "pair_records": (lambda: G.pair_records(wl, *pack),
                             lambda: G.pair_records_reference(wl, *pack),
                             20),
            "composite": (lambda: G.composite(wl, **comp, records=rec),
                          None, 20)}
    bound = bounds(len(ply), wl.n_pairs, wl.ranges.shape[0],
                   cam.width * cam.height, prefix, hits, 4)
    rows = {}
    for kname, (kern, plain, reps) in runs.items():
        ms = cuda_ms(kern, reps)
        plain_ms = (plain_composite_ms if plain is None
                    else cuda_ms(plain, 1, warmup=0))
        rows[kname] = {"ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                       "bound_ms": round(bound[kname]["bound_ms"], 6),
                       "bound_by": bound[kname]["bound_by"],
                       "shape": f"{len(ply)} points, {wl.n_pairs} pairs, "
                                f"{cam.width}x{cam.height}, 4 channels"}
        log(f"[{phase}] condition render, {kname}: kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound[kname]['bound_ms']:.4f} ms "
            f"({bound[kname]['bound_by']}); {gpu}")
    rows["_errs"] = max(err["rgb"], err["acc"])
    return rows


def distill_main_path(G, tmp: str, gpu: str, data
                      ) -> tuple[dict, dict, str]:
    """Phase 16: runner.train.main with the diffusion hook at full width,
    a resume from the checkpoint at the last event that runs it again, and
    runner.render.main(mode=diffusion) on the checkpoint, on
    ``distill_scene``'s data (``data``: its future from ``prefetch_data``).
    Returns (the path's launch counts, the condition render's kernel rows,
    the scene directory)."""
    import torch
    from street_crafter_tpu_torch.config import save_config
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.runner import render as R
    from street_crafter_tpu_torch.runner import train as T
    from street_crafter_tpu_torch.utils.checkpoint import checkpoint_dir
    from street_crafter_tpu_torch.utils.png import read_png
    source = prefetched(data, 16)
    cfg = distill_config(tmp, source)
    path = os.path.join(tmp, "distill.json")
    save_config(cfg, path)
    log(f"[16] data: 26 frames at 1920x1280, {LIDAR_POINTS} LiDAR points a "
        f"frame")
    probe = DistillProbe(gpu)
    G.reset_launch_counts()
    FA.reset_launch_counts()
    TB.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        trainer = T.main(["--config", path])
        torch.cuda.synchronize()
        wall_train = time.perf_counter() - t0
        picks, steps = list(probe.picks), list(probe.steps)
        c_total = counts_now().get("composite_backward", 0)
        shutil.rmtree(checkpoint_dir(cfg.model_path, DISTILL_ITERS))
        probe.picks.clear()
        t0 = time.perf_counter()
        resumed = T.main(["--config", path, "resume=true"])
        torch.cuda.synchronize()
        wall_resume = time.perf_counter() - t0
        t0 = time.perf_counter()
        rendered = R.main(["--config", path, "mode=diffusion",
                           "render.save_video=false"])
        torch.cuda.synchronize()
        wall_render = time.perf_counter() - t0
        counts = counts_now()
    finally:
        probe.restore()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = probe.events
    log(f"[16] runner.train.main: {DISTILL_ITERS} iterations with events "
        f"at {DISTILL_EVENTS} in {wall_train:.1f} s; resumed at "
        f"{resumed.start_iter} ({DISTILL_ITERS - resumed.start_iter + 1} "
        f"iterations) in {wall_resume:.1f} s; runner.render.main("
        f"mode=diffusion) in {wall_render:.1f} s; launches {counts}; "
        f"max_memory_allocated {peak:.2f} GiB; {gpu}")
    # the events, then the last one again on the resume, the iteration
    # after it (the render mode's sample is not a hook's)
    its = [e["iteration"] for e in events]
    if its != DISTILL_EVENTS + [DISTILL_EVENTS[-1] + 1]:
        raise AssertionError(f"sampling events at {its}")
    if [e["version"] for e in events] != list(
            range(1, len(DISTILL_EVENTS) + 1)) + [1]:
        raise AssertionError("diffusion_version did not rise per event")
    if (resumed.start_iter, resumed.state.step) != (
            DISTILL_EVENTS[-1] + 1, DISTILL_ITERS):
        raise AssertionError(f"the resume did not continue at "
                             f"{DISTILL_EVENTS[-1] + 1}")
    # the GS steps: novel views after the first event, kernel C in every
    # step, reading its forward's records
    novel_after = sum(n for n, _ in picks[DISTILL_EVENTS[0] - 1:])
    c_per_step = [b - a for (_, a), (_, b) in
                  zip(picks, picks[1:] + [(None, c_total)])]
    if not novel_after or min(c_per_step) < 1 or \
            counts.get("composite_backward_reference", 0) or \
            not 0 < counts.get("pair_records", 0) <= counts.get(
                "composite", 0):
        raise AssertionError(
            f"GS steps: {novel_after} novel after the first event, kernel C "
            f"launches per step {c_per_step}, counts {counts}")
    # every condition render: one A, one pack, one B with 4 channels
    bad = [r for r in probe.renders if r[0] != ONE_RENDER or r[1] != [4]]
    if bad or not probe.renders:
        raise AssertionError(f"condition renders: {len(probe.renders)}, "
                             f"off the kernels or not 4 channels: {bad[:3]}")
    frames = rendered["frames"]
    img = read_png(frames[0])
    if len(frames) != 26 or img.shape != (cfg.diffusion.height,
                                          cfg.diffusion.width, 3):
        raise AssertionError(f"render mode diffusion: {len(frames)} frames, "
                             f"{img.shape}")
    before = [ms for (_, ms) in steps[:DISTILL_EVENTS[0] - 1]]
    after = [ms for (_, ms) in steps[DISTILL_EVENTS[0] - 1:]]
    cam = resumed.scene.train_cameras[0]
    log(f"[16] GS steps at {cam.width}x{cam.height} ({len(steps)} in the "
        f"first run): "
        f"median {statistics.median(before):.1f} ms before the first event, "
        f"{statistics.median(after):.1f} ms after it ({novel_after} novel-"
        f"view steps after it); kernel C launches per step {c_per_step}; "
        f"{len(probe.renders)} condition renders, each one A, one pack and "
        f"one B with 4 channels; render mode: {len(frames)} PNGs "
        f"{img.shape[1]}x{img.shape[0]}; {gpu}")
    log(f"[16] the first event's wall split: {event_split(events[0])}")
    st = probe.timer.ms
    log(f"[16] the phase's set-up, summed over its three runs (ms): "
        + ", ".join(f"{k} {st.get(k, 0.0):.1f}" for k in (
            "scene build", "initialize_ply", "scene init KNN",
            "trainer init", "train/test conditions", "engine build",
            "engine weights init", "pinned host copy"))
        + f"; events {sum(1e3 * e['wall_s'] for e in events):.1f}")
    del trainer
    torch.cuda.empty_cache()
    rows = condition_render_vs_plain(G, resumed.scene, gpu)
    del resumed
    torch.cuda.empty_cache()
    return counts, rows, source


# ---------------------------------------------------------------------------
# phase 17: the cubemap sky, the colour MLPs, COLMAP points, virtual_warp
# ---------------------------------------------------------------------------

# cut from 30 and 10 to pay for phases 19-21, from 18 and 6 for 24-25
SKY_ITERS, SKY_RESUME = 12, 4
COLMAP_POINTS = 50_000     # at most; the scene's LiDAR holds 20,000
WARP_STEPS, WARP_SHIFT = 5, 2.0
# one pass a step: the cubemap replaces the Gaussian sky's pass
ONE_PASS = {"tile_worklist": 1, "pair_records": 1, "composite": 1,
            "composite_backward": 1}


def sky_color_config(tmp: str, source: str):
    """Phase 6's GS settings (configs/waymo_val_base.yaml's) at SKY_ITERS,
    with the cubemap sky at model.sky.resolution (1024), the colour MLP and
    its sky MLP, COLMAP points, diffusion off; lambda_color_correction 0.1,
    since only the regulariser reads the sky's MLP."""
    from street_crafter_tpu_torch.config import default_config
    cfg = train_config(default_config(), SKY_ITERS)
    cfg.source_path = source
    cfg.model_path = os.path.join(tmp, "sky_model")
    cfg.device = "cuda"
    cfg.data.cameras = [0, 1, 2]
    cfg.data.use_colmap = True
    cfg.optim.capacity_obj = 8192       # phase 3's, so phase 7 compares
    cfg.model.sky.use_cube_map = True
    cfg.model.use_color_correction = True
    cfg.model.color_correction.use_mlp = True
    cfg.model.color_correction.use_sky = True
    cfg.optim.lambda_color_correction = 0.1
    cfg.render.save_video = False
    nv = cfg.render.novel_view
    nv.steps, nv.shift = WARP_STEPS, [WARP_SHIFT]
    return cfg


def write_colmap_model(cfg) -> np.ndarray:
    """A triangulated COLMAP text model under the scene's model path, as
    the known-pose driver leaves it: the train cameras' poses, and up to
    COLMAP_POINTS of the scene's background LiDAR points jittered by 5 cm
    (triangulation noise) as its points. Returns their xyz (float32)."""
    from street_crafter_tpu_torch.datasets.waymo import read_waymo_scene
    from street_crafter_tpu_torch.utils.colmap_io import write_text_model
    from street_crafter_tpu_torch.utils.ply import read_ply
    lidar = os.path.join(cfg.source_path, "lidar", "background")
    clouds = [read_ply(os.path.join(lidar, f))
              for f in sorted(os.listdir(lidar))]
    xyz = np.concatenate([c.points for c in clouds])
    rgb = np.concatenate([c.colors for c in clouds])
    rng = np.random.default_rng(17)
    keep = rng.permutation(len(xyz))[:COLMAP_POINTS]
    xyz = (xyz[keep] + rng.normal(0, 0.05, (len(keep), 3))).astype(
        np.float32)
    rgb = np.round(rgb[keep] * 255).astype(np.uint8)
    info = read_waymo_scene(cfg.source_path, cameras=list(cfg.data.cameras),
                            split_test=cfg.data.split_test)
    cameras, images = {}, {}
    for i, c in enumerate(info.train_cameras):
        cam = c.metadata["cam"]
        cameras[cam] = {"model": "SIMPLE_PINHOLE", "width": c.width,
                        "height": c.height,
                        "params": [c.K[0, 0], c.K[0, 2], c.K[1, 2]]}
        w2c = np.eye(4)
        w2c[:3, :3] = c.R.T
        w2c[:3, 3] = c.T
        images[i + 1] = {"name": f"cam_{cam}/{c.image_name}.png",
                         "camera_id": cam, "w2c": w2c}
    write_text_model(os.path.join(cfg.model_path, "colmap", "triangulated",
                                  "sparse", "model"), cameras, images,
                     points=(xyz, rgb, np.full(len(xyz), 0.5)))
    return xyz


class SkyProbe:
    """Phase 17's instruments around the port's own functions: each GS
    step's launches, time and passes (one, or two where the objects-only
    regulariser runs its own), the launches of the train and test views'
    condition renders, and the set-up's stages (synchronised)."""

    def __init__(self):
        import torch
        from street_crafter_tpu_torch.data_processor import pointcloud as PC
        from street_crafter_tpu_torch.models.gs import params as PM
        from street_crafter_tpu_torch.runner import scene as SC
        from street_crafter_tpu_torch.runner import train as T
        self.torch = torch
        self.timer = StageTimer()
        tm = self.timer
        tm.wrap(T, "create_scene", "scene build")
        tm.wrap(PC.PointCloudProcessor, "initialize_ply", "initialize_ply")
        tm.wrap(PM, "mean_dist2_knn3", "scene init KNN")
        tm.wrap(T.GSTrainer, "__init__", "trainer init")
        self.steps, self.conditions = [], []
        self._patch(T.GSTrainer, "step_fn", self._step_fn)
        self._patch(SC.Scene, "render_conditions", self._conditions)

    def _patch(self, owner, attr, make):
        orig = getattr(owner, attr)
        self.timer._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def restore(self) -> None:
        self.timer.restore()

    def _conditions(self, orig):
        def render_conditions(scene, *a, **kw):
            before = counts_now()
            out = orig(scene, *a, **kw)
            self.conditions.append(counts_since(before))
            return out
        return render_conditions

    def _step_fn(self, orig):
        torch = self.torch

        def step_fn(trainer, is_novel, sh, with_obj_acc=False):
            step = orig(trainer, is_novel, sh, with_obj_acc)

            def probed(*sa, **skw):
                before = counts_now()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*sa, **skw)
                torch.cuda.synchronize()
                self.steps.append({
                    "ms": 1e3 * (time.perf_counter() - t0),
                    "passes": 1 + int(with_obj_acc),
                    "launches": counts_since(before)})
                return out
            return probed
        return step_fn


def cubemap_lookup_ms(params, cam, gpu: str) -> None:
    """The cubemap lookup and the colour MLPs alone at the step's shapes
    (every pixel's ray into the trained texture), 10 calls under
    torch.profiler: device-busy and wall ms a call of the forward, of the
    forward + backward into the texture (index_add_ of 4 taps a pixel),
    and of both MLPs' forward + backward into their weights."""
    import torch
    from street_crafter_tpu_torch.models.gs.color_mlp import apply_color_mlp
    from street_crafter_tpu_torch.ops.cubemap import sample_cubemap
    from street_crafter_tpu_torch.ops.maths import get_rays
    w2c = cam.w2c
    _, dirs = get_rays(cam.K, torch.linalg.inv(w2c), cam.height, cam.width)
    tex = params.sky_cubemap.detach().clone().requires_grad_(True)
    g = torch.rand((cam.height, cam.width, 3), device=tex.device)
    mlps = [{k: v.detach().clone().requires_grad_(True) for k, v in
             m.items()} for m in (params.color_mlp, params.color_mlp_sky)]

    def lookup_fwd():
        with torch.no_grad():
            sample_cubemap(tex, dirs)

    def lookup_fwd_bwd():
        sample_cubemap(tex, dirs).backward(g)

    def mlps_fwd_bwd():
        sum(apply_color_mlp(m, w2c).sum() for m in mlps).backward()

    out = {}
    for name, fn in (("lookup forward", lookup_fwd),
                     ("lookup forward + backward", lookup_fwd_bwd),
                     ("MLPs forward + backward", mlps_fwd_bwd)):
        fn()
        busy, wall, n, _ = busy_share(lambda fn=fn: [fn() for _ in
                                                     range(10)])
        out[name] = {"device_ms": busy / 10, "wall_ms": wall / 10,
                     "kernels": n // 10}
    log(f"[17] alone, 10 calls under torch.profiler, device-busy / wall ms "
        f"a call (kernels a call): "
        + "; ".join(f"{k} {v['device_ms']:.3f} / {v['wall_ms']:.3f} "
                    f"({v['kernels']})" for k, v in out.items())
        + f"; the lookup: {cam.width}x{cam.height} rays into 6x"
        f"{tex.shape[1]}x{tex.shape[2]}x3; {gpu}")


def sky_color_main_path(G, tmp: str, gpu: str, phase7: dict, data) -> dict:
    """Phase 17: runner.train.main from scene init with the cubemap sky,
    the colour MLPs and COLMAP points, a resume, runner.render.main(
    mode=virtual_warp) on the checkpoint, then the train step at phase 7's
    shape with the cubemap and the MLPs, on ``gs_scene``'s data (``data``:
    its future from ``prefetch_data``). Returns the path's launches."""
    import torch
    from street_crafter_tpu_torch.config import save_config
    from street_crafter_tpu_torch.models.gs.color_mlp import init_color_mlp
    from street_crafter_tpu_torch.runner import render as R
    from street_crafter_tpu_torch.runner import train as T
    from street_crafter_tpu_torch.utils.ply import read_ply
    from street_crafter_tpu_torch.utils.png import read_png
    source = prefetched(data, 17)
    t0 = time.perf_counter()
    cfg = sky_color_config(tmp, source)
    colmap_xyz = write_colmap_model(cfg)
    path = os.path.join(tmp, "sky.json")
    save_config(cfg, path)
    log(f"[17] data: phase 3's synthetic scene (4 frames, cameras 0-2, "
        f"1920x1280) and a COLMAP text model of {len(colmap_xyz)} points "
        f"(written in {time.perf_counter() - t0:.1f} s)")
    probe = SkyProbe()
    G.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        trainer = T.main(["--config", path])
        torch.cuda.synchronize()
        wall_train = time.perf_counter() - t0
        train_steps, setup = list(probe.steps), dict(probe.timer.ms)
        peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
        probe.steps.clear()
        t0 = time.perf_counter()
        resumed = T.main(["--config", path,
                          f"train.iterations={SKY_ITERS + SKY_RESUME}"])
        torch.cuda.synchronize()
        wall_resume = time.perf_counter() - t0
        resume_steps = list(probe.steps)
        train_counts = dict(G.launches)
        G.reset_launch_counts()
        t0 = time.perf_counter()
        warp = R.main(["--config", path, "mode=virtual_warp"])
        torch.cuda.synchronize()
        wall_warp = time.perf_counter() - t0
        warp_counts = dict(G.launches)
    finally:
        probe.restore()
    steps = train_steps + resume_steps
    conditions = probe.conditions
    cam = resumed.scene.train_cameras[0]
    # every step: one pass (two with the objects-only regulariser), each
    # launching A, the pack, B and C once; no plain version, and C on its
    # forward's records (one pack a pass)
    bad = [(i, s) for i, s in enumerate(steps)
           if s["launches"] != {k: s["passes"] for k in ONE_PASS}]
    if bad or len(steps) != SKY_ITERS + SKY_RESUME:
        raise AssertionError(f"{len(steps)} GS steps; off one pass's "
                             f"launches: {bad[:3]}")
    plain = {k: v for k, v in train_counts.items()
             if k.endswith("_reference")}
    if plain:
        raise AssertionError(f"the training path ran a plain version: "
                             f"{plain}")
    with open(os.path.join(cfg.model_path, "logs", "metrics.jsonl")) as f:
        losses = [json.loads(x)["train/loss"] for x in f if "train/loss" in x]
    if not (losses and np.isfinite(losses).all()):
        raise AssertionError(f"non-finite training loss: {losses}")
    # the cubemap and every MLP leaf moved from their init
    p = resumed.state.params
    r = int(cfg.model.sky.resolution)
    if p.sky is not None or p.sky_cubemap is None or \
            tuple(p.sky_cubemap.shape) != (6, r, r, 3):
        raise AssertionError("no cubemap sky, or a Gaussian sky pool")
    moved = {"sky_cubemap": float((p.sky_cubemap.detach() - 0.5).abs().max())}
    for name, seed in (("color_mlp", 0), ("color_mlp_sky", 1)):
        init = init_color_mlp(torch.Generator().manual_seed(seed),
                              p.sky_cubemap.device)
        for k, v in getattr(p, name).items():
            moved[f"{name}.{k}"] = float((v.detach() - init[k]).abs().max())
    # the sky's MLP feeds only the colour regulariser |A - I|, which its
    # zero output layer holds at its minimum, where torch's |x| passes no
    # gradient (JAX's passes 1): it stays at its init, as in the reference
    sky_mlp = {k: v for k, v in moved.items()
               if k.startswith("color_mlp_sky.")}
    still = [k for k, v in moved.items() if not v > 0 and k not in sky_mlp]
    if still or any(sky_mlp.values()):
        raise AssertionError(f"leaves that did not move: {still}; the sky "
                             f"MLP's change {sky_mlp}")
    ply_dir = os.path.join(cfg.model_path, "point_cloud",
                           f"iteration_{SKY_ITERS}")
    ll = read_png(os.path.join(ply_dir, "sky_latlong.png"))
    if ll.shape != (512, 1024, 3) or not os.path.getsize(
            os.path.join(ply_dir, "point_cloud.ply")) > 0:
        raise AssertionError(f"latlong {ll.shape}, or no PLY")
    inp = os.path.join(cfg.model_path, "input_ply")
    col = read_ply(os.path.join(inp, "points3D_colmap.ply")).points
    lidar = read_ply(os.path.join(inp, "points3D_lidar.ply")).points
    bkgd = read_ply(os.path.join(inp, "points3D_bkgd.ply")).points
    if not (np.array_equal(col, colmap_xyz)
            and len(lidar) < len(bkgd) <= len(lidar) + len(col)):
        raise AssertionError(f"the init PLY lacks the COLMAP points: lidar "
                             f"{len(lidar)}, colmap {len(col)}, bkgd "
                             f"{len(bkgd)}")
    one_pass = sum(s["passes"] == 1 for s in steps)
    ms1 = [s["ms"] for s in steps if s["passes"] == 1]
    ms2 = [s["ms"] for s in steps if s["passes"] == 2]
    log(f"[17] runner.train.main: {SKY_ITERS} iterations from scene init "
        f"in {wall_train:.1f} s ({1e3 * wall_train / SKY_ITERS:.1f} "
        f"ms/iteration incl. scene init, condition renders, eval, "
        f"checkpoint, PLY and latlong), resumed at {resumed.start_iter} for "
        f"{SKY_RESUME} in {wall_resume:.1f} s; GS steps at {cam.width}x"
        f"{cam.height}: {one_pass} with one pass, median "
        f"{statistics.median(ms1):.1f} ms, {len(ms2)} with the objects-only "
        f"regulariser's second pass"
        + (f", median {statistics.median(ms2):.1f} ms" if ms2 else "")
        + f"; each pass one A, one pack, one B and one C, no plain "
        f"version; max_memory_allocated {peak_train:.2f} GiB; {gpu}")
    log(f"[17] loss every {cfg.train.log_interval} iterations: "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; cubemap |change| max {moved['sky_cubemap']:.4g}, every leaf "
        f"of the colour MLP moved (least "
        f"{min(v for k, v in moved.items() if k not in sky_mlp):.3g}), the "
        f"sky's MLP at its init (no gradient); sky_latlong.png "
        f"{ll.shape[1]}x{ll.shape[0]}; init PLY: {len(lidar)} LiDAR + "
        f"{len(bkgd) - len(lidar)} of {len(col)} COLMAP points in the "
        f"background; condition renders {conditions}")
    log(f"[17] set-up of the two training runs (ms, synchronised): "
        + ", ".join(f"{k} {v:.1f}" for k, v in setup.items())
        + f" (first run only); train wall {1e3 * wall_train:.1f}")

    # virtual_warp: one source view and WARP_STEPS - 1 targets a front
    # train camera, each rendered once (A, the pack and B), no backward
    n_src = len(warp["out_dirs"])
    n_views = n_src * WARP_STEPS
    if not n_src or warp_counts != {"tile_worklist": n_views,
                                    "pair_records": n_views,
                                    "composite": n_views}:
        raise AssertionError(f"virtual_warp: {n_src} sources, launches "
                             f"{warp_counts}")
    shares = []
    for d in warp["out_dirs"].values():
        for i in range(1, WARP_STEPS):
            rgb = read_png(os.path.join(d, f"{i:04d}.png"))
            cond = read_png(os.path.join(d, f"{i:04d}_condition.png"))
            mask = read_png(os.path.join(d, f"{i:04d}_mask.png"))
            if rgb.shape != (cam.height, cam.width, 3) or \
                    cond.shape != rgb.shape or \
                    mask.shape[:2] != rgb.shape[:2]:
                raise AssertionError(f"virtual_warp PNG shapes {rgb.shape}, "
                                     f"{cond.shape}, {mask.shape}")
            share = float((mask > 0).mean())
            if not 0.0 < share < 1.0:
                raise AssertionError(f"virtual_warp mask {d} {i}: {share}")
            shares.append(share)
    log(f"[17] runner.render.main(mode=virtual_warp): {n_src} front source "
        f"views x {WARP_STEPS - 1} targets (shift {WARP_SHIFT} m) at "
        f"{cam.width}x{cam.height} in {wall_warp:.1f} s; ms per target view "
        f"(its render and "
        f"the warp, synchronised) "
        + ", ".join(f"{x:.2f}" for x in warp["view_ms"])
        + f"; valid-mask share {min(shares):.3f}-{max(shares):.3f}; "
        f"launches {warp_counts}; {gpu}")
    del trainer

    # the train step at phase 7's shape, the cubemap and the colour MLPs in
    # place of the Gaussian sky
    sky_step_time(G, cfg, resumed, gpu, phase7)
    cubemap_lookup_ms(p, cam, gpu)
    del resumed
    torch.cuda.empty_cache()
    counts = {k: train_counts.get(k, 0) + warp_counts.get(k, 0)
              for k in set(train_counts) | set(warp_counts)}
    return counts


def sky_step_time(G, cfg, trainer, gpu: str, phase7: dict) -> None:
    """Phase 7's train step (the 600k pool in 2^20 background slots, the
    actors, frame 0 of camera 0, the full loss stack) with the trained
    cubemap and colour MLPs in place of the Gaussian sky pool; its split
    beside phase 7's."""
    import torch
    from street_crafter_tpu_torch.models.gs.params import GaussianPool
    scene = trainer.scene
    dev = scene.device
    infos = scene.info.train_cameras
    i = min(range(len(infos)), key=lambda k: infos[k].uid)
    cam, batch = scene.train_cameras[i], scene.batch_for(infos[i])
    heavy = heavy_pool_in_camera(infos[i].c2w, dev, N_HEAVY)
    pad = BKGD_CAPACITY - heavy.capacity
    bkgd = GaussianPool(**{
        k: torch.cat([v, torch.zeros((pad,) + v.shape[1:], dtype=v.dtype,
                                     device=dev)])
        for k, v in dataclasses.asdict(heavy).items()})
    p = trainer.state.params

    def leaf(x):
        return ({k: v.detach().clone() for k, v in x.items()}
                if isinstance(x, dict) else x.detach().clone())

    C, F, A = scene.meta.track_valid.shape
    params = dataclasses.replace(
        p, bkgd=bkgd, actors=GaussianPool(**{
            k: v.detach().clone()
            for k, v in dataclasses.asdict(p.actors).items()}),
        opt_trans=torch.zeros((C, F, A, 3), device=dev),
        opt_theta=torch.zeros((C, F, A, 1), device=dev),
        sky_cubemap=leaf(p.sky_cubemap), color_mlp=leaf(p.color_mlp),
        color_mlp_sky=leaf(p.color_mlp_sky))
    res = timed_train_step(G, cfg.clone(), scene, params, cam, batch, dev)
    one = res.pop("one")
    busy, wall, n, _ = busy_share(
        lambda: [one() for _ in range(BUSY_STEPS)])
    res["busy_share"] = busy / wall if n else None
    log(f"[17] train step at phase 7's shape ({N_HEAVY} splats in "
        f"{BKGD_CAPACITY} bkgd slots + actors "
        f"{tuple(params.actors.xyz.shape[:2])}, {cam.width}x{cam.height}, "
        f"the full loss stack with the colour regulariser) with the "
        f"cubemap sky 6x{cfg.model.sky.resolution}x"
        f"{cfg.model.sky.resolution} and the colour MLPs: median "
        f"{res['median']:.2f} ms (min {min(res['ms']):.2f}, max "
        f"{max(res['ms']):.2f}) over 20 steps, phase 7 "
        f"{phase7['median']:.2f}; max_memory_allocated "
        f"{res['peak_gib']:.2f} GiB (phase 7 {phase7['peak_gib']:.2f}); "
        + (f"device busy {100 * res['busy_share']:.1f}% over {BUSY_STEPS} "
           f"step(s) "
           f"(torch.profiler; phase 7 {100 * phase7['busy_share']:.1f}%)"
           if res["busy_share"] and phase7.get("busy_share")
           else "busy share not measured")
        + f"; {gpu}")
    keys = list(dict.fromkeys(list(res["split"]) + list(phase7["split"])))
    log(f"[17] split beside phase 7's (ms a step, mean of {res['n_split']}, "
        f"synchronised after each stage; phase 17: foreground and "
        f"objects-only passes, phase 7: foreground, sky and objects-only): "
        + "; ".join(f"{k} {res['split'].get(k, 0.0):.3f} | "
                    f"{phase7['split'].get(k, 0.0):.3f}" for k in keys)
        + f"; whole step with the syncs {res['whole']:.2f} | "
        f"{phase7['whole']:.2f}; {gpu}")


# ---------------------------------------------------------------------------
# phase 18: data-parallel training: camera-batched GS steps on one card, then
# two gloo ranks sharing it (the bridge's x2, GS, the fine-tune under FSDP)

DP_B = 2                  # cameras a GS step, clips a fine-tune step
DP_STEPS = 5              # (a): timed steps at batch_size 2, after a warm-up
DP_MAIN_ITERS = 12        # (b): runner.train.main at batch_size 2
# (c)'s GS run: phase 2's 50k splats in 65,536 slots at 384x256, four
# cameras, DP_GS_ORDER's pairs, a densify after the third step
DP_GS = {"n": N_SMALL, "capacity": 65536, "width": W_SMALL,
         "height": H_SMALL}
DP_GS_ORDER = [[0, 1], [2, 3], [1, 2], [3, 0], [0, 2]]
DP_GS_DENSIFY_AFTER = 2
# two ranks against one: kernel C adds per-splat gradients with atomics in a
# run-dependent order, and Adam turns a near-zero gradient's sign into a
# full step: each leaf within 2e-3 of its largest |value| (the one-step
# tolerance against JAX of tests/test_torch_train.py)
DP_GS_TOL = 2e-3
# (c)'s fine-tune: phase 12's engine and recipe, one clip a rank
# (cut from 25 frames to pay for phases 24-25: the 6.11 GB gradient
# all-reduce, not the clip, is most of the step)
DP_VDM = {"frames": 9, "height": 576, "width": 1024}
# of each leaf's update (the fine-tune's tolerance in
# tests/test_torch_vdm_train.py)
VDM_UPDATE_RTOL = 1e-3
X1_SHAPE = (DP_B, 8, 128)
X1_SOURCE = "street_crafter_tpu_torch/csrc/kernel_shard.cu"
X1_REPLACES = "__graft_entry__.py:301"
DP_TIMEOUT_S = 900.0


def launches_now() -> dict:
    from street_crafter_tpu_torch.parallel import kernel_shard as KS
    return {**counts_now(), **KS.launches}


def reset_launches() -> None:
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.parallel import kernel_shard as KS
    for m in (G, FA, TB, KS):
        m.reset_launch_counts()


def device_sync(dev):
    import torch
    return torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)


def check_kernels_only(counts: dict, dev, what: str) -> None:
    if dev.type == "cuda" and any(k.endswith("_reference") for k in counts):
        raise AssertionError(f"{what} ran a plain version: {counts}")


def dp_step_time(G, cfg, dev, gpu: str, phase7: dict) -> dict:
    """Phase 18 (a): phase 7's step at batch_size 2 (the headline camera
    and a second train camera of its size), on one rank: one warm-up, then
    DP_STEPS synchronised steps (median, peak memory) beside phase 7's;
    every kernel of one camera's step launched twice a step. Returns the
    launch counts of the timed steps."""
    import torch
    from street_crafter_tpu_torch.ops.lpips import random_feature_lpips
    from street_crafter_tpu_torch.training import gs_trainer as GT
    scene, params, cam, batch, tcfg = phase7_inputs(cfg, dev)
    infos = scene.info.train_cameras
    cams = dict(zip((i.uid for i in infos), scene.train_cameras))
    other = next(i for i in infos
                 if cams[i.uid].width == cam.width
                 and cams[i.uid].height == cam.height
                 and not torch.equal(cams[i.uid].w2c, cam.w2c))
    cameras = [cam, cams[other.uid]]
    batches = [batch, scene.batch_for(other)]
    state = GT.init_train_state(params)
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(spatial_lr_scale=scene.extent,
              lpips_fn=random_feature_lpips(device=dev), active_sh_degree=1,
              with_obj_acc=True, generator=gen)
    single = GT.make_train_step(tcfg, scene.meta, **kw)
    step = GT.make_train_step(tcfg, scene.meta, batch_size=DP_B, **kw)
    G.reset_launch_counts()
    single(state, cam, batch)
    torch.cuda.synchronize()
    per_camera = dict(G.launches)
    step(state, cameras, batches)           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    G.reset_launch_counts()
    ms = []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        step(state, cameras, batches)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = dict(G.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: DP_STEPS * DP_B * v for k, v in per_camera.items()}
    check_kernels_only(counts, dev, "the batch step")
    if counts != want or not want.get("composite_backward"):
        raise AssertionError(f"the batch step's launches {counts}, expected "
                             f"{DP_B} cameras' worth of one camera's "
                             f"{per_camera} a step")
    log(f"[18] (a) train step at batch_size {DP_B} (phase 7's shape: "
        f"{N_HEAVY} splats in {BKGD_CAPACITY} slots, {cam.width}x"
        f"{cam.height}, full loss stack, one rank): median "
        f"{statistics.median(ms):.2f} ms (min {min(ms):.2f}, max "
        f"{max(ms):.2f}) over {DP_STEPS} steps after a warm-up, "
        f"{statistics.median(ms) / DP_B:.2f} ms a camera; phase 7's one "
        f"camera {phase7['median']:.2f} ms; max_memory_allocated "
        f"{peak:.2f} GiB (phase 7 {phase7['peak_gib']:.2f}); launches a "
        f"step {({k: v // DP_STEPS for k, v in counts.items()})}; {gpu}")
    return counts


def dp_train_main(G, source_path: str, tmp: str, gpu: str) -> dict:
    """Phase 18 (b): runner.train.main at train.batch_size 2 on phase 6's
    scene data from scene init, DP_MAIN_ITERS iterations (phase 6's
    schedule compressed: densify at 4, 6 and 8, an opacity reset at 6).
    Returns its launch counts."""
    import torch
    from street_crafter_tpu_torch.config import default_config, save_config
    from street_crafter_tpu_torch.runner import train as T
    cfg = train_config(default_config(), DP_MAIN_ITERS)
    cfg.source_path = source_path
    cfg.model_path = os.path.join(tmp, "dp_train_model")
    cfg.device = "cuda"
    cfg.data.cameras = [0, 1, 2]
    cfg.render.save_video = False
    cfg.train.batch_size = DP_B
    path = os.path.join(tmp, "dp_train.json")
    save_config(cfg, path)
    valid = []
    densify = T.GSTrainer.densify

    def probe(self):
        before = n_valid(self.state.params)
        out = densify(self)
        valid.append((before, n_valid(self.state.params)))
        return out
    T.GSTrainer.densify = probe
    G.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer = T.main(["--config", path])
        torch.cuda.synchronize()
    finally:
        T.GSTrainer.densify = densify
    wall = time.perf_counter() - t0
    counts = dict(G.launches)
    losses = []
    with open(os.path.join(cfg.model_path, "logs", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "train/loss" in rec:
                losses.append(rec["train/loss"])
    log(f"[18] (b) runner.train.main at train.batch_size {DP_B}: "
        f"{DP_MAIN_ITERS} iterations in {wall:.1f} s from scene init "
        f"(condition renders, eval, checkpoint and PLY inside); losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; valid splats around each densify {valid}; launches {counts}; "
        f"{gpu}")
    if trainer.state.step != DP_MAIN_ITERS or not losses or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"step {trainer.state.step}, losses {losses}")
    if not valid or all(a == b for a, b in valid):
        raise AssertionError(f"densify did not change the pools: {valid}")
    check_kernels_only(counts, torch.device("cuda"), "runner.train.main")
    if counts.get("composite_backward", 0) < DP_B * DP_MAIN_ITERS or \
            not 0 < counts.get("pair_records", 0) <= counts["composite"]:
        raise AssertionError(f"the batch steps missed kernel C or C packed "
                             f"its own records: {counts}")
    return counts


def x1_on_shard(mesh) -> dict:
    """Phase 18 (c), each rank: x2 (X1) on this rank's shard of a
    X1_SHAPE tensor through the bridge, then all_gather: 2 x. Then the
    kernel against its plain version on the shard, and whether gloo takes
    CUDA tensors in reduce_scatter (a probe: nothing depends on it)."""
    import torch
    import torch.distributed as dist
    from street_crafter_tpu_torch.parallel import kernel_shard as KS
    dev = mesh.device
    x = torch.arange(int(np.prod(X1_SHAPE)), dtype=torch.float32,
                     device=dev).reshape(X1_SHAPE)
    KS.reset_launch_counts()
    with KS.kernel_sharding(mesh, ("data",)):
        y = KS.wrap_kernel(KS.x2, (3,), 3)(x)
    device_sync(dev)()
    counts = dict(KS.launches)
    shard = x[mesh.local_slice(X1_SHAPE[0])]
    err = float((KS.x2(shard) - KS.x2_reference(shard)).abs().max())
    try:
        out = torch.empty((1,), device=dev)
        dist.reduce_scatter_tensor(out, torch.ones((mesh.world_size,),
                                                   device=dev))
        rs = f"taken (result {float(out[0])}, {mesh.world_size} expected)"
    except (RuntimeError, ValueError, NotImplementedError) as e:
        rs = f"refused: {type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return {"counts": counts, "equal": bool(torch.equal(y, 2 * x)),
            "err": err, "reduce_scatter": rs}


def dp_gs_steps(mesh, dev) -> dict:
    """Phase 18 (c)'s GS run (also on one rank: ``mesh`` None): phase 2's
    50k splats (seed 0) in DP_GS's slots, four cameras 384x256 a few cm
    apart with seeded targets, L1 + D-SSIM; steps at batch_size 2 on
    DP_GS_ORDER's pairs (this rank's share), a densify (threshold 1e-7)
    after step DP_GS_DENSIFY_AFTER with the replication check. Returns the
    state (numpy), the launch counts of the steps and the valid counts."""
    import torch
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.datasets.cameras import Camera
    from street_crafter_tpu_torch.models.gs.convert import \
        train_state_to_numpy
    from street_crafter_tpu_torch.models.gs.scene import SceneParams
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.training import gs_trainer as GT
    W, H = DP_GS["width"], DP_GS["height"]
    pool = padded_pool(heavy_pool_in_camera(np.eye(4), dev, DP_GS["n"]),
                       DP_GS["capacity"], dev)
    params = SceneParams(bkgd=pool, actors=None, sky=None, opt_trans=None,
                         opt_theta=None, sky_cubemap=None, color_corr=None,
                         color_corr_sky=None, pose_corr_quat=None,
                         pose_corr_trans=None)
    K = np.array([[1.1 * W, 0, W / 2], [0, 1.1 * W, H / 2], [0, 0, 1]],
                 np.float32)
    cams = []
    for dx in (-0.06, -0.02, 0.02, 0.06):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = dx
        cams.append(Camera.from_c2w(c2w, K, W, H, device=dev))
    rng = np.random.default_rng(1)
    batches = [{"gt_image": torch.tensor(rng.uniform(size=(H, W, 3)),
                                         dtype=torch.float32, device=dev),
                "frame_idx": 0, "frame": 0.0, "cam_id": 0}
               for _ in cams]
    cfg = train_config(default_config())
    o = cfg.optim
    o.lambda_lpips = o.lambda_reg = o.lambda_sky = 0.0
    o.lambda_depth_lidar = 0.0
    dcfg = cfg.clone()
    dcfg.optim.densify_grad_threshold = 1e-7
    state = GT.init_train_state(params)
    gen = torch.Generator(device=dev).manual_seed(5)
    step = GT.make_train_step(cfg, None, spatial_lr_scale=1.0,
                              active_sh_degree=1, generator=gen,
                              batch_size=DP_B, mesh=mesh)
    densify = GT.make_densify_step(dcfg)
    mine = mesh.local_slice(DP_B) if mesh is not None else slice(0, DP_B)
    G.reset_launch_counts()
    valid = None
    for i, pair in enumerate(DP_GS_ORDER):
        idx = pair[mine]
        step(state, [cams[j] for j in idx], [batches[j] for j in idx])
        if i == DP_GS_DENSIFY_AFTER:
            before = state.params.bkgd.num_valid()
            densify(state, gen, 10.0)
            GT.check_replicated(state, mesh)
            valid = (before, state.params.bkgd.num_valid())
    device_sync(dev)()
    return {"state": train_state_to_numpy(state), "counts": dict(G.launches),
            "valid": valid}


def dp_vdm_config(model_path: str, dev, tiny: bool = False):
    from street_crafter_tpu_torch.config import default_config
    cfg = default_config()
    cfg.merge({"device": dev.type, "model_path": model_path, "resume": False,
               "diffusion": {"tiny": tiny, "ckpt_path": "",
                             "init_zero_layers_std": 1.0,
                             "remat_policy": "flash0"},
               "vdm_train": {"height": DP_VDM["height"],
                             "width": DP_VDM["width"],
                             "num_frames": DP_VDM["frames"],
                             "batch_size": DP_B, "fsdp": True,
                             "slow_temporal_layers": True,
                             "slow_temporal_layers_scale": 0.0}})
    return cfg


def dp_vdm_step(mesh, model_path: str, tiny: bool = False) -> dict:
    """Phase 18 (c)'s fine-tune, each rank: runner.vdm_train's trainer
    (phase 12's engine at full width, seeded random weights, the frozen
    temporal recipe) under ``vdm_train.fsdp``, one clip of a seeded
    2-clip global batch encoded by the runner's encoder, one step: its
    time, the all-reduce's and the master gathers' times, the peak memory
    and the launch counts. Then rank 0 runs the one-rank step over both
    clips with ``accumulate: 2`` from the same initial weights and draws,
    and the ranks' masters, gathered leaf by leaf, are held against it:
    within VDM_UPDATE_RTOL of each leaf's update, leaves that do not move
    bit-equal."""
    import gc

    import torch
    from street_crafter_tpu_torch.models.vdm import weights as PW
    from street_crafter_tpu_torch.models.vdm.conditioner import Conditioning
    from street_crafter_tpu_torch.models.vdm.lr_schedule import \
        schedule_from_config
    from street_crafter_tpu_torch.runner import vdm_train as VT
    from street_crafter_tpu_torch.training.vdm_trainer import (
        VDMTrainer, groups_from_config)
    dev = mesh.device
    sync = device_sync(dev)
    cfg = dp_vdm_config(model_path, dev, tiny)
    v = cfg.vdm_train
    t0 = time.perf_counter()
    tr, _ = VT.build_trainer(cfg, mesh)
    build_s = time.perf_counter() - t0
    eng = tr.engine
    encode = VT.make_encode_fn(eng)
    rng = np.random.default_rng(7)
    shape = (DP_B, v.num_frames, v.height, v.width, 3)
    img = rng.uniform(-1, 1, shape).astype(np.float32)
    guide = rng.uniform(-1, 1, shape).astype(np.float32)
    mine = mesh.local_slice(DP_B)
    t0 = time.perf_counter()
    batch = encode(img[mine], guide[mine])
    sync()
    encode_s = time.perf_counter() - t0
    del img, guide
    gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    scalars = tr.train_step(batch, generator=gen)
    sync()
    step_s = time.perf_counter() - t0
    counts = launches_now()
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0)
    rules = tr.rules
    shapes = {n: p.shape for n, p in tr.params.items()}
    out = {"build_s": build_s, "encode_s": encode_s, "step_s": step_s,
           "loss": scalars["loss"], "comm_s": dict(tr.comm_s),
           "peak_gib": peak, "counts": counts,
           "grad_gb": 4e-9 * sum(p.numel() for p in tr.params.values()),
           "sharded": sum(rules.param_spec(s) is not None
                          for s in shapes.values()),
           "leaves": len(shapes)}
    glob = {k: mesh.all_gather(batch[k]) for k in ("latents",
                                                   "guidance_latents")}
    glob["cond"] = Conditioning(*(mesh.all_gather(x) for x in batch["cond"]))
    shards = tr.state.masters
    del tr, batch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = init = None
    if mesh.rank == 0:
        masters: dict = {}
        PW.init_random_(eng, 0, float(cfg.diffusion.init_zero_layers_std),
                        masters)
        init = {n: m.to("cpu", copy=True) for n, m in masters.items()}
        flags, scale = groups_from_config(v)
        ref = VDMTrainer(eng, masters, lr=v.lr, grad_clip=v.grad_clip,
                         ema_decay=v.ema_decay,
                         guidance_dropout=v.guidance_dropout, accumulate=DP_B,
                         group_flags=flags, slow_scale=scale,
                         schedule=schedule_from_config(v.get("scheduler")))
        t0 = time.perf_counter()
        ref.train_step(glob, generator=torch.Generator(
            device=dev).manual_seed(0))
        sync()
        out["ref_step_s"] = time.perf_counter() - t0
    mesh.barrier()
    worst, worst_leaf, moved, still = 0.0, "", 0, 0
    for name, shard in shards.items():
        whole = rules.unshard(shard, rules.param_spec(shapes[name]))
        if ref is None:
            continue
        new = ref.state.masters[name]
        upd = float((new - init[name].to(dev)).abs().max())
        err = float((whole - new).abs().max())
        if upd == 0.0:
            still += 1
            if err != 0.0:
                raise AssertionError(f"{name}: does not move on one rank, "
                                     f"moves by {err} on two")
        else:
            moved += 1
            if err / upd > worst:
                worst, worst_leaf = err / upd, name
    out.update(worst=worst, worst_leaf=worst_leaf, moved=moved, still=still)
    return out


def dp_rank_main(mesh, tmp: str) -> dict:
    """Phase 18 (c), each of two ranks sharing the card through gloo: X1
    on its shard, the GS steps, the fine-tune step. TF32 off as in the
    parent; cuDNN deterministic, so that a rank's per-clip gradient is the
    one-rank step's micro-batch gradient bit for bit."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return {"x1": x1_on_shard(mesh), "gs": dp_gs_steps(mesh, mesh.device),
            "vdm": dp_vdm_step(mesh, os.path.join(tmp, f"vdm_{mesh.rank}"))}


def leaf_errors(got: dict, want: dict, path: str = "") -> list:
    """(path, max |got - want| / max |want|) of every float leaf of two
    numpy train states; integer and bool leaves must be equal."""
    out = []
    if isinstance(want, dict):
        for k in want:
            out += leaf_errors(got[k], want[k], f"{path}/{k}")
        return out
    if want is None:
        return out
    a, b = np.asarray(got), np.asarray(want)
    if b.dtype.kind in "biu":
        if not np.array_equal(a, b):
            raise AssertionError(f"{path}: integer / bool leaves differ")
        return out
    scale = float(np.abs(b).max()) if b.size else 0.0
    err = float(np.abs(a - b).max()) if b.size else 0.0
    out.append((path, err / scale if scale else err))
    return out


def dp_two_ranks(gpu: str) -> tuple[dict, dict]:
    """Phase 18 (c): one-rank GS run in this process, then two spawned
    ranks sharing the card through gloo (file:// rendezvous). Returns the
    ranks' launch counts summed (the main paths' runs) and X1's row."""
    import torch
    from street_crafter_tpu_torch.parallel import kernel_shard as KS
    from street_crafter_tpu_torch.parallel.mesh import run_ranks
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    one = dp_gs_steps(None, dev)
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(dp_rank_main, 2, tmp, tmp, backend="gloo",
                          device="cuda", threads=0, timeout_s=DP_TIMEOUT_S)
        wall = time.perf_counter() - t0
    # X1
    x1 = [r["x1"] for r in ranks]
    x1_counts = [r["counts"] for r in x1]
    if not all(r["equal"] for r in x1) or any(r["err"] for r in x1):
        raise AssertionError(f"X1 through the bridge: {x1}")
    if x1_counts != [{"x2": 1}] * 2:
        raise AssertionError(f"X1 launches a rank {x1_counts}, expected one")
    log(f"[18] (c) two ranks sharing the card through gloo ({wall:.1f} s, "
        f"spawn included): X1 on each rank's [1, 8, 128] shard of "
        f"{list(X1_SHAPE)}, gathered: equal to 2 x; the kernel equal to its "
        f"plain version on the shard; launches a rank {x1_counts}; gloo and "
        f"CUDA tensors in reduce_scatter_tensor: {x1[0]['reduce_scatter']}")
    # GS
    gs = [r["gs"] for r in ranks]
    same = leaf_errors(gs[1]["state"], gs[0]["state"])
    bad = [p for p, e in same if e != 0.0]
    if bad:
        raise AssertionError(f"the ranks' GS states differ: {bad[:5]}")
    errs = leaf_errors(gs[0]["state"], one["state"])
    worst = max(errs, key=lambda pe: pe[1])
    frac = np.mean([np.isclose(np.asarray(gs[0]["state"]["params"]["bkgd"][k]),
                               np.asarray(one["state"]["params"]["bkgd"][k]),
                               rtol=1e-5, atol=1e-7).mean()
                    for k in ("xyz", "features_dc", "opacity", "scaling")])
    log(f"[18] (c) GS at batch_size {DP_B} on {DP_GS['n']} splats "
        f"({DP_GS['width']}x{DP_GS['height']}), {len(DP_GS_ORDER)} steps, a "
        f"densify after step {DP_GS_DENSIFY_AFTER + 1} (valid {gs[0]['valid']}"
        f", one rank {one['valid']}): the two ranks' states bit-equal; "
        f"against one rank ({one_s:.1f} s) the largest error "
        f"{worst[1]:.3g} of the leaf's largest |value| at {worst[0]} "
        f"(limit {DP_GS_TOL}); {100 * frac:.2f}% of the bkgd values within "
        f"1e-5; launches a rank {[g['counts'] for g in gs]}")
    if worst[1] > DP_GS_TOL or gs[0]["valid"] != one["valid"]:
        raise AssertionError(f"two ranks against one: {worst}, valid "
                             f"{gs[0]['valid']} / {one['valid']}")
    for g in gs:
        check_kernels_only(g["counts"], dev, "a rank's GS steps")
        if g["counts"].get("composite_backward", 0) < len(DP_GS_ORDER):
            raise AssertionError(f"a rank's GS steps missed kernel C: "
                                 f"{g['counts']}")
    # the fine-tune
    vd = [r["vdm"] for r in ranks]
    log(f"[18] (c) fine-tune under vdm_train.fsdp, one clip of "
        f"{DP_VDM['frames']} frames at {DP_VDM['height']}x{DP_VDM['width']} "
        f"a rank (global batch {DP_B}): masters and EMA sharded in "
        f"{vd[0]['sharded']} of {vd[0]['leaves']} leaves; engine build "
        f"{[round(x['build_s'], 1) for x in vd]} s, encode "
        f"{[round(x['encode_s'], 2) for x in vd]} s; step "
        f"{[round(x['step_s'], 3) for x in vd]} s (one rank's step over "
        f"both clips, accumulate 2: {vd[0]['ref_step_s']:.3f} s); gradient "
        f"all-reduce ({vd[0]['grad_gb']:.2f} GB of f32 through host memory) "
        f"{[round(x['comm_s']['all_reduce'], 3) for x in vd]} s; master "
        f"gathers into the bf16 module "
        f"{[round(x['comm_s']['all_gather'], 3) for x in vd]} s; peak "
        f"max_memory_allocated {[round(x['peak_gib'], 2) for x in vd]} GiB "
        f"(phase 12's one rank: 43.5 GiB); loss "
        f"{[round(x['loss'], 4) for x in vd]}; masters against one rank: "
        f"{vd[0]['moved']} leaves moved, the largest error "
        f"{vd[0]['worst']:.3g} of the leaf's update ({vd[0]['worst_leaf']}"
        f"; limit {VDM_UPDATE_RTOL}), {vd[0]['still']} still leaves "
        f"bit-equal; launches a rank {[x['counts'] for x in vd]}; {gpu}")
    if vd[0]["worst"] > VDM_UPDATE_RTOL or not vd[0]["moved"]:
        raise AssertionError("the two-rank fine-tune step is not the "
                             "one-rank step")
    if not all(np.isfinite(x["loss"]) for x in vd):
        raise AssertionError("non-finite fine-tune loss")
    for x in vd:
        check_kernels_only(x["counts"], dev, "a rank's fine-tune step")
        want = {k: v for k, v in TRAIN_PER_STEP.items()}
        got = {k: x["counts"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"a rank's fine-tune step launched {got}, "
                                 f"expected {want}")
    total: dict = {}
    for r in ranks:
        for part in ("x1", "gs", "vdm"):
            for k, n in r[part]["counts"].items():
                total[k] = total.get(k, 0) + n
    # X1's row: its times at the main path's shape (a rank's shard)
    x = torch.arange(int(np.prod(X1_SHAPE[1:])), dtype=torch.float32,
                     device=dev).reshape((1,) + X1_SHAPE[1:])
    # the kernel and torch.mul in turns (x2, mul, mul, x2), 200 calls each
    fns = {"x2": lambda: KS.x2(x), "mul": lambda: torch.mul(x, 2.0)}
    turns = {"x2": [], "mul": []}
    for k in ("x2", "mul", "mul", "x2"):
        turns[k].append(cuda_ms(fns[k], 200, 10))
    row = {"ms": statistics.mean(turns["x2"]),
           "plain_ms": cuda_ms(lambda: KS.x2_reference(x), 200, 10),
           "library_ms": statistics.mean(turns["mul"]),
           "bound_ms": 1e3 * 2 * x.numel() * 4 / PEAK_BYTES_S,
           "max_abs_err": max(r["err"] for r in x1),
           "launches": sum(c.get("x2", 0) for c in x1_counts)}
    log(f"[18] x2 (X1) at a rank's [1, 8, 128]: {row['ms']:.5f} ms "
        f"({turns['x2']}), bound {row['bound_ms']:.6f} ms (bytes), plain "
        f"{row['plain_ms']:.5f} ms, torch.mul {row['library_ms']:.5f} ms "
        f"({turns['mul']}; launch-bound at this size): "
        f"{row['ms'] / row['library_ms']:.3f}x torch.mul; {gpu}")
    return total, row


# ---------------------------------------------------------------------------
# phase 19: the fine-tune's options at full width (remat policies, LoRA)
# ---------------------------------------------------------------------------

# the remat policies beside phase 13's flash0, and kernel D with lse a step
# under each: the forwards of the 15 flash sites (5 a level at levels 0-2)
# and the recompute of the sites the policy does not keep
POLICIES = ("nothing", "flash01", "flash", "flashx", "dots")
POLICY_D_PER_STEP = {"flash0": 25, "nothing": 30, "flash01": 20,
                     "flash": 15, "flashx": 20, "dots": 30}
# the same weights, batch and draws under every policy: the policies keep
# or recompute the same operations, so the loss and the gradient agree up
# to summation orders that vary from run to run (cuDNN's backward, the
# atomics of kernel G); the gradient's global norm within this of flash0's
POLICY_NORM_RTOL = 1e-4
# the clip "dots" runs at: at 25 frames its step does not fit the card
# (it asks for more than the 79.18 GiB there are), at 22 it peaks at 76.24
# GiB and at 23 it does not fit (one policy alone on the H100, 700 W)
DOTS_FRAMES = 22
LORA_STEPS = 2             # cut from 3 to pay for phases 24-25


def cut_clip(batch: dict, frames: int) -> dict:
    """A fine-tune batch ([B, T, ...] leaves) cut to its first frames."""
    from street_crafter_tpu_torch.models.vdm.conditioner import Conditioning
    return {"latents": batch["latents"][:, :frames],
            "cond": Conditioning(*(x[:, :frames] for x in batch["cond"])),
            "guidance_latents": batch["guidance_latents"][:, :frames]}


def step_gradient(tr, batch: dict, draws) -> tuple[float, float, dict]:
    """One train step of ``tr`` on ``batch`` and ``draws`` with its update
    skipped: (loss, the gradient's global norm in f64, launches)."""
    import torch
    from street_crafter_tpu_torch.ops import flash_attention as FA
    norms = []

    def norm_only(grads):
        norms.append(float(torch.stack([g.double().pow(2).sum() for g in
                                        grads.values()]).sum().sqrt()))

    FA.reset_launch_counts()
    tr._apply = norm_only
    try:
        scalars = tr.train_step(batch, draws=draws)
    finally:
        del tr._apply
    return scalars["loss"], norms[0], dict(FA.launches)


def remat_policy_steps(tr, batch: dict, gpu: str) -> tuple[dict, dict]:
    """Phase 19 (a): phase 12's trainer on phase 13's batch under each
    remat policy. First every policy's loss and gradient norm from the
    same weights and draws (the update skipped), against flash0's; then
    per policy a timed step (CUDA synchronised), its peak, and its
    launches. Returns
    (the timed steps' launches, summed; per policy {step_s, peak_gib,
    launches, frames})."""
    import gc

    import torch
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    eng, unet = tr.engine, tr.engine.unet
    cfg0, ecfg0 = unet.cfg, eng.cfg
    frames = batch["latents"].shape[1]
    g = torch.Generator(device=eng.device).manual_seed(19)
    draws = {}

    def use(policy: str, T: int) -> dict:
        unet.cfg = dataclasses.replace(cfg0, remat_policy=policy)
        eng.cfg = dataclasses.replace(ecfg0, num_frames=T)
        if T not in draws:      # one clip of T frames, drawn once
            draws[T] = tr.draw(1, (T, *batch["latents"].shape[2:]), g)
        return batch if T == frames else cut_clip(batch, T)

    runs = [("flash0", frames)] + [(p, DOTS_FRAMES if p == "dots" else
                                    frames) for p in POLICIES]
    if DOTS_FRAMES != frames:
        runs.insert(1, ("flash0", DOTS_FRAMES))
    total: dict = {}
    out: dict = {}
    try:
        ref = {}
        for policy, T in runs:
            b = use(policy, T)
            loss, norm, counts = step_gradient(tr, b, draws[T])
            want = dict(POLICY_D_PER_STEP, flash0=25)[policy]
            if policy == "flash0":
                ref[T] = (loss, norm)
            d_loss = abs(loss - ref[T][0]) / abs(ref[T][0])
            d_norm = abs(norm - ref[T][1]) / ref[T][1]
            log(f"[19] {policy} at {T} frames, the update skipped: loss "
                f"{loss:.6f}, gradient norm {norm:.6f}; against flash0 at "
                f"{T} frames: loss {d_loss:.3e}, norm {d_norm:.3e} relative "
                f"(tolerance {POLICY_NORM_RTOL}); launches {counts}")
            if not (np.isfinite(loss) and np.isfinite(norm)) \
                    or d_loss > POLICY_NORM_RTOL or d_norm > POLICY_NORM_RTOL:
                raise AssertionError(f"{policy}: the loss or gradient moved")
            if counts != {"flash_attention_lse": want,
                          "flash_attention_bwd_dkv": 15,
                          "flash_attention_bwd_dq": 15}:
                raise AssertionError(f"{policy}: launches {counts}, want "
                                     f"{want} / 15 / 15 of D-lse / G / H")
            out.setdefault(policy, {})["norm_rel"] = d_norm
        for policy, T in runs:
            if policy == "flash0" and T != frames:
                continue
            b = use(policy, T)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # no warm-up step (cut to pay for phases 24-25): the gradient
            # pass above ran this policy's forward and backward once
            FA.reset_launch_counts()
            TB.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scalars = tr.train_step(b, generator=g)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            counts = {**FA.launches, **TB.launches}
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            want = {"flash_attention_lse": POLICY_D_PER_STEP[policy],
                    "flash_attention_bwd_dkv": 15,
                    "flash_attention_bwd_dq": 15}
            log(f"[19] remat {policy}: train step ({T} frames at 576x1024, "
                f"encode outside) {step_s:.3f} s after its gradient pass, loss "
                f"{scalars['loss']:.4f}; max_memory_allocated {peak:.2f} GiB"
                f"; launches {counts}; card {gpu}")
            if counts != want or not np.isfinite(scalars["loss"]):
                raise AssertionError(f"{policy}: launches {counts}, want "
                                     f"{want}; loss {scalars['loss']}")
            out[policy].update(step_s=step_s, peak_gib=peak, frames=T,
                               d_lse=counts["flash_attention_lse"])
    finally:
        unet.cfg, eng.cfg = cfg0, ecfg0
    return total, out


def lora_steps(cfg_path: str, gpu: str) -> dict:
    """Phase 19 (b): runner.vdm_train's build_trainer at full width with
    diffusion.add_lora and vdm_train.train_peft_adapters (the recipe's
    slow temporal group off: the groups are exclusive), LORA_STEPS steps
    on phase 12's clip: their times, the peak, the launches of each step,
    and which leaves moved. Returns the launches, summed."""
    import gc

    import torch
    from street_crafter_tpu_torch.config import (default_config, load_config,
                                                 merge_dotlist)
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.runner import vdm_train as VT
    cfg = default_config()
    cfg.merge(load_config(cfg_path))
    # a model path of its own: phase 12's holds a checkpoint without
    # adapters, which build_trainer would resume from
    merge_dotlist(cfg, ["diffusion.add_lora=true",
                        "vdm_train.train_peft_adapters=true",
                        "vdm_train.slow_temporal_layers=false",
                        f"model_path={cfg.model_path}_lora"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr, _ = VT.build_trainer(cfg)
    build_s = time.perf_counter() - t0
    clip = VT.build_sampler(cfg).datasets[0][0]
    encode = VT.make_encode_fn(tr.engine)
    batch = encode(clip["img_seq"][None], clip["guide_seq"][None])
    start = {n: m.to("cpu", copy=True) for n, m in tr.state.masters.items()}
    g = torch.Generator(device=tr.engine.device).manual_seed(24)
    total, times, losses = {}, [], []
    for i in range(LORA_STEPS):
        FA.reset_launch_counts()
        TB.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scalars = tr.train_step(batch, generator=g)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(scalars["loss"])
        counts = {**FA.launches, **TB.launches}
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        if counts != TRAIN_PER_STEP:
            raise AssertionError(f"LoRA step {i}: launches {counts}, want "
                                 f"{TRAIN_PER_STEP}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    base = [n for n, lab in tr.labels.items() if lab == "base"]
    adapters = [n for n in base if "adapter" in n]
    frozen = [n for n, lab in tr.labels.items() if lab == "frozen"]
    # a length-1 context: the cross-attention's q and k (and their
    # adapters) get no gradient, as in the JAX package
    unused = {n for n in adapters if re.search(r"attn2\.[qk]_adapter", n)}
    still = [n for n in base if n not in unused
             and torch.equal(tr.state.masters[n].cpu(), start[n])]
    moved = [n for n in frozen
             if not torch.equal(tr.state.masters[n].cpu(), start[n])
             or not torch.equal(tr.params[n].detach().cpu(),
                                start[n].to(tr.params[n].dtype))]
    log(f"[19] LoRA (add_lora, train_peft_adapters): build {build_s:.1f} s; "
        f"{LORA_STEPS} steps (25 frames at 576x1024, encode outside) "
        f"{[round(t, 3) for t in times]} s, median "
        f"{statistics.median(times):.3f} s, losses "
        f"{[round(x, 4) for x in losses]}; max_memory_allocated {peak:.2f} "
        f"GiB; trained leaves {len(base)} ({len(adapters)} adapter leaves, "
        f"{len(unused)} of them unused by the length-1 cross-attention), "
        f"{len(still)} of the rest did not move; frozen leaves {len(frozen)}"
        f", {len(moved)} moved (masters or bf16 weights); launches per step "
        f"{TRAIN_PER_STEP}; card {gpu}")
    if not adapters or still or moved or not all(np.isfinite(losses)):
        raise AssertionError(f"LoRA: still {still[:5]}, frozen moved "
                             f"{moved[:5]}, losses {losses}")
    del tr, batch, start
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 20: the sampling options at full width (fixed blender, reward)
# ---------------------------------------------------------------------------

REWARD_ENS, REWARD_STEPS = 2, 2


def drop_mixers(tree: dict) -> int:
    """Remove every ``time_mixer`` subtree of a JAX parameter tree, in
    place; returns how many."""
    n = 0
    for k in list(tree):
        if k == "time_mixer":
            del tree[k]
            n += 1
        elif isinstance(tree[k], dict):
            n += drop_mixers(tree[k])
    return n


def fixed_blender_eval(cfg_path: str, gpu: str) -> dict:
    """Phase 20 (a): phase 9's engine (its seeded weights), its UNet carried
    through models.vdm.convert into a UNet with merge_strategy="fixed"
    (the JAX layout and back, less the mixers) and fused_temporal; one CFG
    eval on seeded inputs: launches, finite output; then kernels E (at
    the fixed alpha) and F against their plain versions at phase 8's
    main-path shapes. Returns the CFG eval's launches."""
    import torch
    from street_crafter_tpu_torch.config import default_config, load_config
    from street_crafter_tpu_torch.models.vdm import convert as CV
    from street_crafter_tpu_torch.models.vdm.conditioner import Conditioning
    from street_crafter_tpu_torch.models.vdm.engine import materialize
    from street_crafter_tpu_torch.models.vdm.unet import VideoUNet
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    cfg = default_config()
    cfg.merge(load_config(cfg_path))
    eng = VS.build_engine(cfg, 25)
    dev = eng.device
    t0 = time.perf_counter()
    tree = CV.unet_params_to_jax(eng.unet.state_dict(), eng.cfg.unet)
    n_mix = drop_mixers(tree)
    fcfg = dataclasses.replace(eng.cfg.unet, merge_strategy="fixed")
    sd = CV.state_dict_from_jax(tree, CV.unet_name_map(fcfg), "unet")
    del tree
    eng.unet = None
    torch.cuda.empty_cache()
    with torch.device("meta"):
        unet = VideoUNet(fcfg)
    unet = materialize(unet, dev, torch.bfloat16)
    unet.load_state_dict(sd)
    del sd
    eng.unet = unet
    eng.cfg = dataclasses.replace(eng.cfg, unet=fcfg)
    convert_s = time.perf_counter() - t0
    mixers = [n for n, _ in unet.named_parameters() if "mix_factor" in n]
    g = torch.Generator(device=dev).manual_seed(20)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)
    cond = Conditioning(r(25, 1, 1024), r(25, 768), r(25, 72, 128, 4))
    uc = Conditioning(torch.zeros_like(cond.crossattn), cond.vector,
                      torch.zeros_like(cond.concat))
    cm = torch.zeros(25, device=dev)
    cm[0] = 1.0
    denoise = eng.make_cfg_denoise_fn(cond, uc, r(25, 72, 128, 4), cm)
    x = r(25, 72, 128, 4)
    sigma = torch.full((25,), 10.0, device=dev)
    FA.reset_launch_counts()
    TB.reset_launch_counts()
    out = denoise(x, sigma)
    torch.cuda.synchronize()
    counts = {**FA.launches, **TB.launches}
    ms = sync_ms(lambda: denoise(x, sigma), 2)
    log(f"[20] fixed blender: phase 9's weights through convert.py "
        f"({n_mix} time_mixer leaves dropped, {len(mixers)} mix_factor in "
        f"the new UNet) in {convert_s:.1f} s; one CFG eval (2 x 25 frames "
        f"at 72x128, fused temporal, alpha {fcfg.merge_factor}): launches "
        f"{counts}, output {tuple(out.shape)} finite "
        f"{bool(torch.isfinite(out).all())}, std {float(out.float().std()):.4f}"
        f"; median {statistics.median(ms):.1f} ms of "
        f"{[round(t, 1) for t in ms]}; card {gpu}")
    if counts != PER_STEP or mixers or n_mix == 0 \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"fixed blender: launches {counts}, want "
                             f"{PER_STEP}; mixers {mixers[:3]}; dropped "
                             f"{n_mix}")
    del eng, denoise, cond, uc, out, unet
    torch.cuda.empty_cache()
    for i, (B, T, S, C, heads) in enumerate(E_SHAPES):
        args, kw = e_args(TB, dev, B, T, S, C, heads, 300 + i)
        args = (args[0], args[1], fcfg.merge_factor, *args[3:])
        e = bf16_errors(TB.temporal_block_fused(*args, **kw),
                        TB.temporal_block_fused_reference(*args, **kw))
        check_errors(f"kernel E at the fixed alpha {fcfg.merge_factor}, "
                     f"[{B * T}, {S}, {C}]", e, 20)
        del args
    for i, (B, T, S, C, heads) in enumerate(F_SHAPES):
        args, kw = f_args(TB, dev, B, T, S, C, heads, 310 + i)
        e = bf16_errors(TB.temporal_attention_fused(*args, **kw),
                        TB.temporal_attention_fused_reference(*args, **kw))
        check_errors(f"kernel F (its blend with the fixed alpha is the "
                     f"caller's) [{B * T}, {S}, {C}]", e, 20)
        del args
    torch.cuda.empty_cache()
    return counts


def reward_main_path(cfg_path: str, tmp: str, gpu: str) -> dict:
    """Phase 20 (b): ``python -m street_crafter_tpu_torch.runner.reward
    --dataset IMG`` (its main) on phase 9's frames at 576x1024, phase 9's
    seeded weights, REWARD_ENS members of REWARD_STEPS Euler steps: one
    record in (0, 1] appended to rewards.jsonl, every member's frame 0 the
    real latent, 15 / 5 / 11 launches of D / E / F per CFG eval; the wall,
    the encode and each member's time. Returns the launches."""
    import torch
    from street_crafter_tpu_torch.ops import flash_attention as FA
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.runner import reward as RW
    with open(cfg_path) as f:
        vcfg = json.load(f)
    root = vcfg["vdm_train"]["data_root"]
    scene = next(d for d in sorted(os.listdir(root))
                 if os.path.isdir(os.path.join(root, d)))
    images = os.path.join(root, scene, "images")
    save = os.path.join(tmp, "reward")
    seen, times = {}, {"member": []}
    ens, sample = RW.ensemble_reward, RW.euler_edm_sample

    def keeping(engine, images_, *a, **kw):
        enc = engine.encode_images_chunked

        def timed_encode(x, *ea, **ekw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z = enc(x, *ea, **ekw)
            torch.cuda.synchronize()
            times["encode"] = time.perf_counter() - t0
            seen["z"] = z.float()
            return z
        engine.encode_images_chunked = timed_encode
        try:
            reward, samples = ens(engine, images_, *a, **kw)
        finally:
            del engine.encode_images_chunked
        seen["samples"], seen["reward"] = samples, reward
        return reward, samples

    def timed_sample(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(*a, **kw)
        torch.cuda.synchronize()
        times["member"].append(time.perf_counter() - t0)
        return out

    FA.reset_launch_counts()
    TB.reset_launch_counts()
    RW.ensemble_reward, RW.euler_edm_sample = keeping, timed_sample
    t0 = time.perf_counter()
    try:
        recs = RW.main(["--dataset", "IMG", "--data_root", images,
                        "--save", save, "--ens_size", str(REWARD_ENS),
                        "--n_steps", str(REWARD_STEPS), "device=cuda",
                        "diffusion.tiny=false", "diffusion.ckpt_path=",
                        "diffusion.init_zero_layers_std=1.0"])
        torch.cuda.synchronize()
    finally:
        RW.ensemble_reward, RW.euler_edm_sample = ens, sample
    wall = time.perf_counter() - t0
    counts = {**FA.launches, **TB.launches}
    with open(os.path.join(save, "rewards.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    evals = REWARD_ENS * REWARD_STEPS
    z, samples = seen["z"], seen["samples"]
    pinned = all(torch.equal(samples[e, 0], z[0]) for e in range(REWARD_ENS))
    r = lines[-1]["reward"] if lines else float("nan")
    log(f"[20] runner.reward.main --dataset IMG ({REWARD_ENS} members x "
        f"{REWARD_STEPS} Euler steps, 25 frames at 576x1024): {wall:.1f} s "
        f"incl. engine build; encode {times['encode']:.3f} s; members "
        f"{[round(t, 3) for t in times['member']]} s; reward {r!r}; "
        f"rewards.jsonl {lines}; samples {tuple(samples.shape)}, frame 0 "
        f"pinned to the real latent in every member: {pinned}; launches "
        f"{counts} over {evals} CFG evals; card {gpu}")
    want = {k: n * evals for k, n in PER_STEP.items()}
    if len(recs) != 1 or len(lines) != 1 or not (0.0 < r <= 1.0) \
            or not pinned or counts != want \
            or not bool(torch.isfinite(samples).all()):
        raise AssertionError(f"reward: records {lines}, pinned {pinned}, "
                             f"launches {counts} (want {want})")
    return counts


# ---------------------------------------------------------------------------
# phase 21: the semantic channel (kernels B and C past 7 channels)
# ---------------------------------------------------------------------------

# 4 + K channels of phase 21 (a): the instances' widths (9, 13, ..., 29,
# 32) and a count padded up to each kind of neighbour (8, 23: rgb + depth
# + Cityscapes' 19 classes, 30)
WIDE_CASES = (8, 9, 13, 17, 21, 23, 25, 29, 30, 32)
SEM_CLASSES = 19        # Cityscapes' evaluation classes


def with_channels(args: dict, C: int, seed: int) -> dict:
    """Raster args with C channels: their rgb + depth, then C - 4 seeded
    logits N(0, 2^2)."""
    import torch
    base = args["colors"][:, :4]
    g = torch.Generator(device=base.device).manual_seed(seed)
    extra = 2.0 * torch.randn((base.shape[0], C - 4), generator=g,
                              device=base.device)
    return dict(args, colors=torch.cat([base, extra], 1).contiguous())


def wide_channel_cases(G, args: dict, label: str) -> float:
    """Phase 21 (a): the pack, B (both forms) and C at each WIDE_CASES
    width on phase 2's splats, phase 2's and phase 5's limits. Returns the
    largest B error."""
    worst = 0.0
    for C in WIDE_CASES:
        cargs = with_channels(args, C, 210 + C)
        lab = f"{label}, {C} channels"
        worst = max(worst, compare(G, cargs, lab, 21)["composite_err"])
        compare_backward(G, cargs, lab, 210 + C, phase=21)
    return worst


def wide_times(G, wl, comp: dict, rec, bwd: dict) -> dict:
    """CUDA-event ms of the pack, B (both forms) and C on one input."""
    pack = [comp[k] for k in ("u", "v", "conic_a", "conic_b", "conic_c",
                              "colors", "opacities")]
    return {"pair_records": cuda_ms(lambda: G.pair_records(wl, *pack), 20),
            "composite": cuda_ms(
                lambda: G.composite(wl, **comp, records=rec), 20),
            "composite (train)": cuda_ms(
                lambda: G.composite(wl, **comp, train=True, records=rec), 20),
            "composite_backward": cuda_ms(
                lambda: G.composite_backward(wl, **bwd, records=rec), 20)}


def semantic_headline(G, cfg, dev, fg: dict, gpu: str) -> tuple[dict, dict]:
    """Phase 21 (b): the headline frame's foreground with a SemanticField
    of SEM_CLASSES classes: render_flat(extra_channels=) forward and
    backward through semantic_loss against a seeded label map (launches,
    finite, the logits' gradient); B and C against their plain versions
    at 4 + SEM_CLASSES channels (phase 4's and 5's limits, C also on the
    logits' columns alone); the times of A, the pack, B and C beside phase
    5's 4-channel ones, then at MAX_CHANNELS; the peak. Returns (the
    render's launches, {channels: times and bounds})."""
    import torch
    from street_crafter_tpu_torch.models.gs.renderer import render_flat
    from street_crafter_tpu_torch.models.gs.scene import flatten_scene
    from street_crafter_tpu_torch.models.gs.semantic import (init_semantic,
                                                             semantic_loss)
    scene, params, cam, batch = headline_scene(cfg, dev)
    flat = flatten_scene(params, scene.meta, batch["cam_id"],
                         batch["frame_idx"], batch["frame"],
                         batch["timestamp"], include_sky=False,
                         interpolate=True)
    n = flat.xyz.shape[0]
    g = torch.Generator(device=dev).manual_seed(21)
    field = init_semantic(n, SEM_CLASSES, device=dev)
    field.logits = (2.0 * torch.randn(field.logits.shape, generator=g,
                                      device=dev)).requires_grad_(True)
    labels = torch.randint(0, SEM_CLASSES, (cam.height, cam.width),
                           generator=g, device=dev)
    center = -(cam.w2c[:3, :3].T @ cam.w2c[:3, 3])
    torch.cuda.reset_peak_memory_stats()
    G.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render_flat(flat, cam.w2c, cam.K, center, cam.width, cam.height,
                      extra_channels=field.get_semantic())
    loss = semantic_loss(out["semantic"], labels, 1.0)
    loss.backward()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    counts = dict(G.launches)
    grad = field.logits.grad
    log(f"[21] render_flat at the headline frame ({cam.width}x{cam.height}, "
        f"{n} splats) with a SemanticField of {SEM_CLASSES} classes, "
        f"semantic_loss against a seeded label map and its backward: "
        f"{wall:.1f} ms, loss {float(loss):.4f}, semantic "
        f"{tuple(out['semantic'].shape)}, logits' gradient norm "
        f"{float(grad.norm()):.4g} (finite {bool(torch.isfinite(grad).all())}"
        f"); launches {counts}")
    want = {"tile_worklist": 1, "pair_records": 1, "composite": 1,
            "composite_backward": 1}
    if counts != want or not bool(torch.isfinite(grad).all()) \
            or not float(grad.abs().max()) > 0 \
            or out["semantic"].shape != (cam.height, cam.width, SEM_CLASSES):
        raise AssertionError(f"semantic render: launches {counts} (want "
                             f"{want}), gradient finite "
                             f"{bool(torch.isfinite(grad).all())}")
    logits = field.logits.detach()
    del out, loss, grad, field
    args = raster_args(flat, cam.w2c, cam.K, cam.width, cam.height)
    C = 4 + SEM_CLASSES
    args["colors"] = torch.cat([args["colors"], logits], 1).contiguous()
    label = (f"headline frame with {SEM_CLASSES} classes ({C} channels)")
    err = compare(G, args, label, 21)["composite_err"]
    head = compare_backward(G, args, label, 21, phase=21, shared=True)
    # the logits' columns of kernel C's rows alone
    wl, rec = head["wl"], head["records"]
    bwd = dict(head["comp"], **head["state"])
    got, want_g = head["grads"]
    e = grad_errors(got[:, G.GRAD_COLORS + 4:], want_g[:, G.GRAD_COLORS + 4:])
    log(f"[21] {label}: kernel C on the logits' columns alone: "
        f"{e['max_rel']:.2e} of the largest, {e['norm_rel']:.2e} of the "
        f"norm, median per splat {e['median_rel']:.2e} (tolerance "
        f"{GRAD_RTOL} on each)")
    if max(e["max_rel"], e["norm_rel"], e["median_rel"]) > GRAD_RTOL:
        raise AssertionError(f"{label}: kernel C disagrees on the logits")
    del got, want_g, head
    geo, comp = split_args(args)
    rows = {}
    for width in (C, G.MAX_CHANNELS):
        if width != C:
            args = with_channels(args, width, 221)
            geo, comp = split_args(args)
            rec = G.pair_records(wl, *(comp[k] for k in (
                "u", "v", "conic_a", "conic_b", "conic_c", "colors",
                "opacities")))
            _, _, final_T, last = G.composite(wl, **comp, train=True,
                                              records=rec)
            bwd = dict(comp, final_T=final_T, last=last,
                       grad_colors=torch.randn(
                           (cam.height, cam.width, width), generator=g,
                           device=dev),
                       grad_alpha=bwd["grad_alpha"])
        t = wide_times(G, wl, comp, rec, bwd)
        t["tile_worklist"] = cuda_ms(lambda: G.tile_worklist(**geo), 10)
        b = bounds(n, wl.n_pairs, wl.ranges.shape[0], fg["pixels"],
                   fg["prefix"], fg["hits"], width)
        rows[width] = {k: {"ms": round(t[k], 4),
                           "bound_ms": round(b[k]["bound_ms"], 6),
                           "bound_by": b[k]["bound_by"]} for k in b}
        rows[width]["composite"]["train_ms"] = round(t["composite (train)"],
                                                     4)
        log(f"[21] headline frame at {width} channels (beside phase 5's 4 "
            f"channels): " + ", ".join(
                f"{k} {t[k]:.4f} ms (4 channels "
                f"{fg['times'][k][0]:.4f})" for k in t)
            + f"; bounds (ms) " + ", ".join(
                f"{k} {b[k]['bound_ms']:.4f} ({b[k]['bound_by']})"
                for k in b) + f"; {gpu}")
    rows["composite_err"] = err
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[21] peak max_memory_allocated over the semantic phase "
        f"{peak:.2f} GiB")
    return counts, rows


def semantic_densify_ply(tmp: str, dev, gpu: str) -> None:
    """Phase 21 (c): densify_and_prune of phase 2's 50k-splat pool (in a
    pool of 2^17 slots) carrying a SemanticField of SEM_CLASSES classes
    as ``extra``, on the card and on the host from the same inputs (the
    same slots, the carried rows equal), then the PLY round trip of the
    pool and its logits (``semantic_i`` back equal)."""
    import torch
    from street_crafter_tpu_torch.models.gs import densify as DZ
    from street_crafter_tpu_torch.models.gs.optim import init_adam
    from street_crafter_tpu_torch.models.gs.params import GaussianPool
    from street_crafter_tpu_torch.models.gs.semantic import init_semantic
    from street_crafter_tpu_torch.utils import gs_ply as PLY
    cap = 1 << 17
    pool = padded_pool(heavy_pool_in_camera(np.eye(4), dev, N_SMALL), cap,
                       dev)
    g = torch.Generator(device=dev).manual_seed(22)
    field = init_semantic(cap, SEM_CLASSES, device=dev)
    field.logits.normal_(generator=g)
    state = DZ.init_densify_state((cap,), dev)
    state.grad_abs_accum.copy_(torch.rand(cap, generator=g, device=dev)
                               * 4e-4)
    state.denom.fill_(1.0)
    noise = torch.randn((2, cap, 3), generator=g, device=dev)
    kw = dict(grad_threshold=2e-4, percent_dense=0.01, extent=5.0,
              min_opacity=0.005)
    runs = {}
    for where in ("cuda", "cpu"):
        p = GaussianPool(**{k: v.to(where, copy=True)
                            for k, v in dataclasses.asdict(pool).items()})
        adam = init_adam(p.trainable_dict())
        st = DZ.init_densify_state((cap,), where)
        for f in dataclasses.fields(st):
            getattr(st, f.name).copy_(getattr(state, f.name))
        sem = field.logits.clone().to(where)
        t0 = time.perf_counter()
        info = DZ.densify_and_prune(p, adam, st, noise.to(where), **kw,
                                    extra={"semantic": sem})
        if where == "cuda":
            torch.cuda.synchronize()
        runs[where] = (p, sem, info, time.perf_counter() - t0)
    (pc, sc, ic, tc), (ph, sh, ih, th) = runs["cuda"], runs["cpu"]
    same = (torch.equal(pc.valid.cpu(), ph.valid)
            and torch.equal(sc.cpu(), sh))
    log(f"[21] densify with the semantic field ({SEM_CLASSES} classes, "
        f"{N_SMALL} splats in {cap} slots): cloned {int(ic.n_cloned)}, "
        f"split {int(ic.n_split)}, pruned {int(ic.n_pruned)}, valid "
        f"{int(ic.n_valid)}; {1e3 * tc:.1f} ms on the card; slots and "
        f"carried logits equal to the host's: {same}")
    if not same or int(ic.n_cloned) + int(ic.n_split) == 0:
        raise AssertionError("densify did not carry the semantic field as "
                             "on the host")
    path = os.path.join(tmp, "semantic.ply")
    PLY.export_gaussians_ply(path, {"background": pc},
                             semantics={"background": sc})
    pools, sems = PLY.import_gaussians_ply(path, capacity=cap, device=dev,
                                           with_semantics=True)
    n = int(pc.valid.sum())
    back = sems["background"]
    ok = (back.shape == (cap, SEM_CLASSES)
          and torch.equal(back[:n], sc[pc.valid])
          and torch.equal(pools["background"].xyz[:n], pc.xyz[pc.valid]))
    log(f"[21] PLY round trip of {n} splats with {SEM_CLASSES} semantic_i "
        f"properties ({os.path.getsize(path)} bytes): logits and positions "
        f"back equal: {ok}; {gpu}")
    if not ok:
        raise AssertionError("the PLY's semantic_i did not come back equal")


# ---------------------------------------------------------------------------
# phase 22: host-side data processing on the card
# ---------------------------------------------------------------------------

# the LiDAR frame core's float32 points, card against host: float64 on both
# sides (the card's sin / cos may differ from the host's in the last bits),
# so a point may round to the neighbouring float32: one float32 ulp at the
# frame's largest range (75 m) is 7.6e-6 m
LIDAR_POINT_ATOL = 1e-5
# three street images at 1920x1280 (Waymo's front cameras) for the sky mask
SKY_IMAGES, SKY_HW = 3, (1280, 1920)
# PandaSet condition renders: make_pandaset_scene at 1920x1080 with
# PANDA_POINTS returns a sweep; frames PANDA_FRAMES of PANDA_NUM_FRAMES,
# each aggregating +-10 sweeps (21: ~2.1 M points), camera 0, PANDA_SHIFTS
PANDA_NUM_FRAMES, PANDA_POINTS = 23, 100_000
PANDA_FRAMES, PANDA_SHIFTS = (10, 11, 12), (0.0, 2.0)
PANDA_HW = (1080, 1920)
# MoGe: phase 22 (d)'s Waymo scene (2 frames, camera 0 at 1920x1280) and
# the stand-in predictor's input area (the reference's 700 x 700)
MOGE_AREA = 700 * 700


def street_images(n: int, hw: tuple, seed: int = 0) -> np.ndarray:
    """[n, H, W, 3] float32 street-like images: a smooth bright sky above
    a skyline of textured buildings of random heights, a textured road."""
    rng = np.random.default_rng(seed)
    H, W = hw
    out = np.empty((n, H, W, 3), np.float32)
    y = np.arange(H, dtype=np.float32)[:, None, None] / H
    for i in range(n):
        horizon = int(H * (0.45 + 0.05 * i))
        sky = np.array([0.6, 0.75, 0.95], np.float32) - 0.1 * y
        img = np.broadcast_to(sky, (H, W, 3)).copy()
        tops = rng.integers(int(0.15 * H), horizon, W // 64 + 1)
        top = np.repeat(tops, 64)[:W]
        rows = np.arange(H)[:, None]
        building = (rows >= top[None, :]) & (rows < horizon)
        img[building] = rng.uniform(0.1, 0.9, (int(building.sum()), 3))
        img[horizon:] = rng.uniform(0.1, 0.5, (H - horizon, W, 3))
        out[i] = img
    return out


def stand_in_moge(seed: int = 0):
    """A seeded MoGe stand-in: for an [h, w, 3] image, camera-frame points
    over a ground plane and walls (5-60 m), their depth, 90% valid."""
    def predict(image: np.ndarray, fov_x: float) -> dict:
        rng = np.random.default_rng(seed)
        h, w = image.shape[:2]
        f = 0.5 * w / np.tan(np.deg2rad(fov_x) / 2)
        depth = rng.uniform(5.0, 60.0, (h, w)).astype(np.float32)
        u = np.arange(w, dtype=np.float32)[None, :] - w / 2
        v = np.arange(h, dtype=np.float32)[:, None] - h / 2
        pts = np.stack([u * depth / f, v * depth / f, depth], -1)
        return {"points": pts.astype(np.float32), "depth": depth,
                "mask": rng.random((h, w)) < 0.9}
    return predict


def lidar_frame_card_vs_host(gpu: str, dev: str = "cuda") -> dict:
    """(a) range_images.lidar_frame at Waymo Open Dataset sizes on the card
    and on the host: points within LIDAR_POINT_ATOL, colours, colour
    masks, the actor split, the sparse depth maps equal."""
    import torch
    from street_crafter_tpu_torch.data_processor.range_images import \
        lidar_frame
    from street_crafter_tpu_torch.datasets.synthetic import \
        make_wod_lidar_frame
    fr = make_wod_lidar_frame(seed=0)
    args = (fr["lidars"], fr["images"], fr["intrinsics"],
            fr["cam2vehicles"], fr["boxes"])
    times = {}
    for label in ("card (first)", "card"):
        t0 = time.perf_counter()
        card_out = lidar_frame(*args, device=dev)
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_out = lidar_frame(*args, device="cpu")
    times["host"] = time.perf_counter() - t0

    def same(a, b, what):
        pa, pb = a[0].cpu(), b[0]
        if pa.shape != pb.shape:
            raise AssertionError(f"[22] {what}: {pa.shape} points on the "
                                 f"card, {pb.shape} on the host")
        err = float((pa - pb).abs().max()) if len(pb) else 0.0
        if err > LIDAR_POINT_ATOL or not torch.equal(a[1].cpu(), b[1]) \
                or not torch.equal(a[2].cpu(), b[2]):
            raise AssertionError(f"[22] {what}: points {err:.3g} apart "
                                 f"(atol {LIDAR_POINT_ATOL}) or colours / "
                                 f"colour masks differ")
        return err
    err = same(card_out.background, host_out.background, "background")
    if list(card_out.actors) != list(host_out.actors):
        raise AssertionError(f"[22] actor split differs: "
                             f"{list(card_out.actors)}, "
                             f"{list(host_out.actors)}")
    for tid in host_out.actors:
        err = max(err, same(card_out.actors[tid], host_out.actors[tid],
                            tid))
    depth_px = {}
    for cam, (mask, value) in host_out.depth.items():
        cm, cv = card_out.depth[cam]
        if not (torch.equal(cm.cpu(), mask) and torch.equal(cv.cpu(), value)):
            raise AssertionError(f"[22] camera {cam}: the sparse depth map "
                                 f"differs between the card and the host")
        depth_px[cam] = int(mask.sum())
    n = sum(int((img > 0).sum()) for img, _, _ in fr["lidars"])
    log(f"[22] (a) LiDAR frame core at WOD sizes (TOP 64x2650, 4 x "
        f"200x600; 3 cameras at 1920x1280, 2 at 1920x886; "
        f"{len(fr['boxes'])} boxes): {n} points, background "
        f"{len(host_out.background[0])}, actors "
        f"{ {k: len(v[0]) for k, v in host_out.actors.items()} }, depth "
        f"pixels {depth_px}; card {times['card']:.3f} s (first call "
        f"{times['card (first)']:.3f} s), host {times['host']:.3f} s; "
        f"points within {err:.3g} m (atol {LIDAR_POINT_ATOL}), colours, "
        f"masks, actor split and depth maps equal; {gpu}")
    return times


def sky_mask_card_vs_host(gpu: str, dev: str = "cuda") -> dict:
    """(b) heuristic_sky_mask on SKY_IMAGES street images at 1920x1280, one
    batch on the card and on the host: bit-equal."""
    import torch
    from street_crafter_tpu_torch.data_processor.sky_mask import \
        heuristic_sky_mask
    imgs = street_images(SKY_IMAGES, SKY_HW)
    t0 = time.perf_counter()
    card_mask = heuristic_sky_mask(imgs, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_mask = heuristic_sky_mask(imgs, device="cpu")
    host_s = time.perf_counter() - t0
    if not torch.equal(card_mask.cpu(), host_mask):
        n = int((card_mask.cpu() != host_mask).sum())
        raise AssertionError(f"[22] sky masks: {n} pixels differ between "
                             f"the card and the host")
    share = [round(float(m.float().mean()), 4) for m in host_mask]
    if not all(0.05 < s < 0.6 for s in share):
        raise AssertionError(f"[22] sky masks cover {share} of the images")
    log(f"[22] (b) heuristic sky mask, {SKY_IMAGES} images at "
        f"{SKY_HW[1]}x{SKY_HW[0]} in one batch: card {card_s:.3f} s, host "
        f"{host_s:.3f} s, bit-equal; sky share {share}; {gpu}")
    return {"card": card_s, "host": host_s}


def pandaset_conditions(G, tmp: str, gpu: str,
                        dev: str = "cuda") -> tuple[dict, dict]:
    """(c) pandaset.render_scene_conditions at 1920x1080 on the card:
    launches of A, the pack and B counted (none of their plain versions),
    the PNGs checked, then one render against the plain versions."""
    import torch
    from street_crafter_tpu_torch.data_processor import pandaset as PS
    from street_crafter_tpu_torch.datasets.synthetic import \
        make_pandaset_scene
    from street_crafter_tpu_torch.utils.png import read_png
    t0 = time.perf_counter()
    d = make_pandaset_scene(os.path.join(tmp, "pandaset"),
                            num_frames=PANDA_NUM_FRAMES, num_cams=1,
                            img_hw=PANDA_HW, points_per_frame=PANDA_POINTS,
                            image_frames=(0,))
    data_s = time.perf_counter() - t0
    G.reset_launch_counts()
    t0 = time.perf_counter()
    written = PS.render_scene_conditions(d, cams=[0], shifts=PANDA_SHIFTS,
                                         frames=PANDA_FRAMES, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(G.launches)
    n = len(PANDA_FRAMES) * len(PANDA_SHIFTS)
    if len(written) != n or any(counts.get(k, 0) != n for k in
                                ("tile_worklist", "pair_records",
                                 "composite")):
        raise AssertionError(f"[22] PandaSet renders: {len(written)} PNGs, "
                             f"launches {counts} (expected {n} of A, the "
                             f"pack and B)")
    if any(k.endswith("_reference") for k in counts):
        raise AssertionError(f"[22] PandaSet renders ran a plain version: "
                             f"{counts}")
    cover = []
    for path in written:
        rgb = read_png(path)
        mask = read_png(path[:-4] + "_mask.png")
        if rgb.shape != PANDA_HW + (3,) or mask.shape[:2] != PANDA_HW:
            raise AssertionError(f"[22] {path}: shape {rgb.shape}")
        cover.append(round(float((mask > 0).mean()), 4))
    if not all(0.05 < c < 1.0 for c in cover):
        raise AssertionError(f"[22] PandaSet masks cover {cover}")
    scene = PS.PandaSetScene(d, dev)
    frame = PANDA_FRAMES[len(PANDA_FRAMES) // 2]
    t0 = time.perf_counter()
    ply = scene.cloud(0, frame)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    cam = scene.camera(0, frame, 0.0)
    # the PNG written on the main path is the kernels' render of this cloud
    rgb, acc = PS._splatter(dev)._splat(ply, cam, 0.01, True)
    want = read_png(os.path.join(d, "lidar_forward", "color_render",
                                 f"{frame:03d}_0.png"))
    if not np.array_equal((rgb * 255).astype(np.uint8), want):
        raise AssertionError("[22] the written PNG differs from a render "
                             "of the same cloud")
    log(f"[22] (c) PandaSet conditions: {PANDA_NUM_FRAMES} frames of "
        f"{PANDA_POINTS} points (written in {data_s:.1f} s), frames "
        f"{list(PANDA_FRAMES)} x shifts {list(PANDA_SHIFTS)} m at "
        f"{PANDA_HW[1]}x{PANDA_HW[0]} in {wall:.2f} s ({len(ply)} points "
        f"a render, aggregated on the card in {host_ms:.1f} ms); launches "
        f"{counts}; mask coverage {cover}; {gpu}")
    rows = condition_vs_plain(G, ply, cam, f"PandaSet frame {frame}",
                              host_ms, 22, gpu, scene.device)
    return counts, rows


def moge_card_vs_host(tmp: str, gpu: str, dev: str = "cuda") -> dict:
    """(d) save_moge_pcd with a seeded stand-in predictor on a 2-frame
    Waymo scene at 1920x1280, on the card and on the host: the same PLYs
    (points within LIDAR_POINT_ATOL)."""
    import torch
    from street_crafter_tpu_torch.data_processor.moge_pcd import \
        save_moge_pcd
    from street_crafter_tpu_torch.datasets.synthetic import make_scene
    from street_crafter_tpu_torch.utils.ply import read_ply
    src = make_scene(os.path.join(tmp, "moge_src"), num_frames=2,
                     img_hw=(1280, 1920), image_cameras=(0,))
    times = {}
    for where, on in (("card", dev), ("host", "cpu")):
        d = os.path.join(tmp, f"moge_{where}", "016")
        shutil.copytree(src, d)
        # save_moge_pcd counts frames as images // 5
        for f in range(2):
            for c in range(1, 5):
                shutil.copy(os.path.join(d, "images", f"{f:06d}_0.png"),
                            os.path.join(d, "images", f"{f:06d}_{c}.png"))
        t0 = time.perf_counter()
        save_moge_pcd(d, stand_in_moge(), expected_area=MOGE_AREA,
                      device=on)
        torch.cuda.synchronize()
        times[where] = time.perf_counter() - t0
    n, err = 0, 0.0
    for f in range(2):
        a = read_ply(os.path.join(tmp, "moge_card", "016", "moge",
                                  "background", f"{f:06d}.ply"))
        b = read_ply(os.path.join(tmp, "moge_host", "016", "moge",
                                  "background", f"{f:06d}.ply"))
        if a.points.shape != b.points.shape or \
                not np.array_equal(a.colors, b.colors):
            raise AssertionError(f"[22] MoGe frame {f}: the card's PLY "
                                 f"differs from the host's")
        err = max(err, float(np.abs(a.points - b.points).max()))
        n += len(a.points)
    if err > LIDAR_POINT_ATOL or n == 0:
        raise AssertionError(f"[22] MoGe points {err:.3g} apart "
                             f"({n} points)")
    log(f"[22] (d) save_moge_pcd, stand-in predictor at {MOGE_AREA} "
        f"pixels, 2 frames of 1920x1280: card {times['card']:.2f} s, host "
        f"{times['host']:.2f} s, {n} background points within {err:.3g} m; "
        f"{gpu}")
    return times


def data_processing(G, gpu: str, dev: str = "cuda") -> tuple[dict, dict]:
    """Phase 22: (a)-(d) on ``dev`` (the card; a rehearsal passes the
    CPU); returns (the PandaSet path's launches, its condition render's
    kernel rows)."""
    t0 = time.perf_counter()
    lidar_frame_card_vs_host(gpu, dev)
    t1 = time.perf_counter()
    sky_mask_card_vs_host(gpu, dev)
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        counts, rows = pandaset_conditions(G, tmp, gpu, dev)
        t3 = time.perf_counter()
        moge_card_vs_host(tmp, gpu, dev)
    t4 = time.perf_counter()
    log(f"[22] seconds: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) "
        f"{t3 - t2:.1f}, (d) {t4 - t3:.1f}; phase 22 {t4 - t0:.1f} s")
    return counts, rows


# ---------------------------------------------------------------------------
# phase 23: frames-axis sequence parallelism (ranks sharing the card)
# ---------------------------------------------------------------------------

SP_FRAMES = 5              # (a): the one frames size that divides T = 25
SP_STEPS = 1               # (a): Euler steps of the sample (cut from 2
# to pay for phases 24-25)
# (a): the chunked decode's frames a chunk (the engine's default 8 left
# five ranks ~1 GiB of the card in one run: a rank ran out of memory)
SP_DECODE_CHUNK = 6
SP_SEED = 23
SP_LOSS_RTOL = 2e-3        # (b): the step's loss against one rank's
# the frames ranks compute in bf16 with other shapes than one rank (a
# frame's share of every GEMM and convolution, the tokens' runs of the
# temporal stages, the GroupNorm statistics summed over the group), and a
# UNet eval in bf16 differs from another valid bf16 evaluation by ~2e-2 of
# its largest value (3e-3 median), a whole sample by ~0.13 (1e-2 median;
# the tiny engine in bf16 on the CPU, fused against plain temporal
# stages); bf16_errors' limits hold for one kernel, not for a network. So
# each part is held against a control, one rank's other valid evaluation
# of the same thing, in the same call: the frames ranks' errors against
# one rank within SP_NOISE_FACTOR times the control's (or within
# bf16_errors' limits, where the control is closer). (a)'s control: the
# sample with the plain temporal stages (fused_temporal off); (b)'s: the
# step on a batch of two copies of the clip (other GEMM shapes, the same
# loss and gradient)
SP_NOISE_FACTOR = 2.0


def noise_limits(control: dict) -> tuple[float, float]:
    """The (largest, median) error limits that a control sets."""
    return (max(BF16_MAX_REL, SP_NOISE_FACTOR * control["max_rel"]),
            max(BF16_MED_REL, SP_NOISE_FACTOR * control["med_rel"]))
# (b)'s fallback when SP_FRAMES ranks' trainers do not fit the card: two
# ranks of 12 frames (25 does not split over 2)
SP_FT_FALLBACK = (2, 24)
SP_TIMEOUT_S = 900.0
SP_HW = (576, 1024)        # the images' size (a CPU rehearsal cuts it)
# (a)'s fused stages (S, C, heads): E at level 0, F at levels 1, 2 and the
# middle block; rank 0 holds its token run of each
SP_STAGES = (("temporal_block_fused", 9216, 320, 5),
             ("temporal_attention_fused", 2304, 640, 10),
             ("temporal_attention_fused", 576, 1280, 20),
             ("temporal_attention_fused", 144, 1280, 20))
SP_TINY = False            # the tiny engine (a CPU rehearsal)


def sp_window(T: int = 25, seed: int = SP_SEED) -> tuple:
    """Seeded guide and conditioning images in [-1, 1] at SP_HW (a
    window's inputs; every rank makes the same)."""
    rng = np.random.default_rng(seed)
    guide = rng.uniform(-1, 1, (T, *SP_HW, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (1, *SP_HW, 3)).astype(np.float32)
    return guide, cond


def timed_all_to_all(mesh) -> list:
    """Wrap ``mesh.all_to_all`` (the exchanges of parallel/sequence.py) to
    add its seconds (from a synchronisation of the card, so the wait for
    the kernels before it is not counted) and calls to the returned
    list."""
    import torch
    spent = [0.0, 0]
    inner = mesh.all_to_all

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out
    mesh.all_to_all = timed
    return spent


def sp_sample(mesh, dev) -> dict:
    """(a) on one rank (``mesh`` None: ``engine.sample``, then the control:
    the same with the plain temporal stages) or on this rank of the frames
    mesh (``sample_on_mesh``): phase 9's engine and seeded weights, fused
    temporal stages, SP_STEPS Euler steps, CFG, the chunked decode; the
    window's frames, wall seconds, launches, all-to-all seconds and the
    peak. On a mesh, rank 0 then holds E and F at its token-shard shapes
    against their plain versions."""
    import torch
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.ops import temporal_block as TB
    from street_crafter_tpu_torch.parallel.sample import sample_on_mesh
    from street_crafter_tpu_torch.parallel.sequence import token_runs
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    cfg = default_config()
    cfg.merge({"device": dev.type,
               "diffusion": {"tiny": SP_TINY, "num_steps": SP_STEPS,
                             "ckpt_path": "", "init_zero_layers_std": 1.0,
                             "decode_chunk": SP_DECODE_CHUNK}})
    t0 = time.perf_counter()
    eng = VS.build_engine(cfg, 25, dev)
    build_s = time.perf_counter() - t0
    guide, cond = sp_window()
    g, c = torch.from_numpy(guide).to(dev), torch.from_numpy(cond).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SP_SEED)
    spent = timed_all_to_all(mesh) if mesh is not None else [0.0, 0]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    if mesh is None:
        out = eng.sample(g, c, generator=gen)
    else:
        out = sample_on_mesh(eng, g, c, mesh, generator=gen)
    torch.cuda.synchronize()
    res = {"build_s": build_s, "sample_s": time.perf_counter() - t0,
           "counts": launches_now(), "a2a_s": spent[0],
           "a2a_calls": spent[1],
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "checksum": float(out.double().sum()), "shape": tuple(out.shape)}
    if mesh is None or mesh.rank == 0:
        res["frames"] = out.cpu().numpy()
    if mesh is None:
        from street_crafter_tpu_torch.models.vdm.layers import \
            SpatialVideoTransformer
        for m in eng.unet.modules():
            if isinstance(m, SpatialVideoTransformer):
                m.fused_temporal = False
        res["control"] = eng.sample(g, c, generator=torch.Generator(
            device=dev).manual_seed(SP_SEED)).cpu().numpy()
    del eng, out, g, c
    torch.cuda.empty_cache()
    if mesh is not None and mesh.rank == 0:
        errs = {}
        f = mesh.size("frames")
        for name, S, C, heads in SP_STAGES:
            S_r = token_runs(S, f)[0]
            make = e_args if name == "temporal_block_fused" else f_args
            args, kw = make(TB, dev, 2, 25, S_r, C, heads, 400 + S_r)
            e = bf16_errors(getattr(TB, name)(*args, **kw),
                            getattr(TB, name + "_reference")(*args, **kw))
            e["shape"] = [50, S_r, C]
            errs.setdefault(name, []).append(e)
            del args
        res["shard_errs"] = errs
        torch.cuda.empty_cache()
    return res


def sp_ft_config(dev, T: int, f: int, model_path: str):
    """(b)'s config: phase 12's engine and data sizes with phase 19 (b)'s
    LoRA recipe, one clip of T frames, the mesh {data: 1, frames: f}."""
    from street_crafter_tpu_torch.config import default_config
    cfg = default_config()
    cfg.merge({"device": dev.type, "model_path": model_path,
               "resume": False,
               "diffusion": {"tiny": SP_TINY, "ckpt_path": "",
                             "init_zero_layers_std": 1.0,
                             "remat_policy": "flash0", "add_lora": True},
               "vdm_train": {"height": SP_HW[0], "width": SP_HW[1],
                             "num_frames": T,
                             "batch_size": 1, "train_peft_adapters": True,
                             "slow_temporal_layers": False},
               "mesh": {"axes": {"data": 1, "frames": f}}})
    return cfg


def sp_finetune(mesh, dev, T: int, f: int, model_path: str) -> dict:
    """(b) on one rank (``mesh`` None) or this rank of {data: 1, frames:
    f}: runner.vdm_train's trainer and encoder with the LoRA recipe, one
    step on a seeded clip of T frames with the generator's draws: the
    loss, times, launches, all-to-all seconds, peak, the memory the
    trainer holds before the step, whether the frozen leaves stayed
    bit-equal (f64 sums of masters and module weights), and (one rank or
    rank 0) the adapters' gradients before the clip and their masters
    before and after. One rank first runs the control: the loss and
    gradients of the step on two copies of the clip (the same draws for
    both), its update skipped."""
    import torch
    from street_crafter_tpu_torch.runner import vdm_train as VT
    cfg = sp_ft_config(dev, T, f, model_path)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr, _ = VT.build_trainer(cfg, mesh)
    build_s = time.perf_counter() - t0
    static = torch.cuda.memory_allocated() / 2 ** 30
    trained = [n for n, lab in tr.labels.items() if lab == "base"]
    frozen = [n for n, lab in tr.labels.items() if lab == "frozen"]

    def frozen_sums():
        with torch.no_grad():
            return [float(sum(src[n].double().sum() for n in frozen))
                    for src in (tr.state.masters, tr.params)]
    start = {n: tr.state.masters[n].cpu().numpy().copy() for n in trained}
    before = frozen_sums()
    rng = np.random.default_rng(SP_SEED + 1)
    img = rng.uniform(-1, 1, (1, T, *SP_HW, 3)).astype(np.float32)
    guide = rng.uniform(-1, 1, (1, T, *SP_HW, 3)).astype(np.float32)
    t0 = time.perf_counter()
    batch = VT.make_encode_fn(tr.engine, tr.frames)(img, guide)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    del img, guide
    grads = {}
    apply = tr._apply

    def capture(g, update=True):
        grads.update({n: g[n].cpu().numpy().copy() for n in trained})
        if update:
            apply(g)
    control = None
    if mesh is None:
        from street_crafter_tpu_torch.models.vdm.conditioner import \
            Conditioning
        from street_crafter_tpu_torch.models.vdm.loss import LossDraws
        from street_crafter_tpu_torch.training.vdm_trainer import StepDraws
        d = tr.draw(1, (T, *batch["latents"].shape[2:]),
                    torch.Generator(device=dev).manual_seed(SP_SEED))

        def two(x):
            return torch.cat([x, x])
        twice = {"latents": two(batch["latents"]),
                 "guidance_latents": two(batch["guidance_latents"]),
                 "cond": Conditioning(*map(two, batch["cond"]))}
        tr._apply = lambda g: capture(g, update=False)
        try:
            loss2 = tr.train_step(twice, draws=StepDraws(
                two(d.keep), LossDraws(*map(two, d.loss))))["loss"]
        finally:
            del tr._apply
        control = {"loss": loss2, "grads": dict(grads)}
        del twice
        torch.cuda.empty_cache()
    tr._apply = capture
    spent = timed_all_to_all(mesh) if mesh is not None else [0.0, 0]
    reset_launches()
    t0 = time.perf_counter()
    try:
        scalars = tr.train_step(batch, generator=torch.Generator(
            device=dev).manual_seed(SP_SEED))
        torch.cuda.synchronize()
    finally:
        del tr._apply
    res = {"build_s": build_s, "encode_s": encode_s,
           "step_s": time.perf_counter() - t0, "loss": scalars["loss"],
           "counts": launches_now(), "a2a_s": spent[0],
           "a2a_calls": spent[1], "comm_s": dict(tr.comm_s),
           "static_gib": static,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "frozen_equal": frozen_sums() == before, "n_frozen": len(frozen)}
    if mesh is None or mesh.rank == 0:
        res.update(grads=grads, start=start, control=control,
                   new={n: tr.state.masters[n].cpu().numpy().copy()
                        for n in trained})
    del tr, batch
    torch.cuda.empty_cache()
    return res


def sp_rank_main(mesh, part: str, tmp: str, T: int, f: int) -> dict:
    """Phase 23, each rank sharing the card through gloo: (a) or (b) on
    the frames mesh. TF32 off and cuDNN deterministic, as in the
    parent."""
    import torch
    from street_crafter_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    m = make_mesh({"data": 1, "frames": f}, device=mesh.device)
    if part == "sample":
        return sp_sample(m, m.device)
    return sp_finetune(m, m.device, T, f,
                       os.path.join(tmp, f"sp_ft_{m.rank}"))


def grad_errors_by_leaf(got: dict, want: dict) -> dict:
    """Over the leaves of two gradients (numpy): the largest of each leaf's
    bf16_errors max_rel and med_rel, and the largest share of a leaf's
    nonzero elements whose sign differs."""
    import torch
    out = {"max_rel": 0.0, "med_rel": 0.0, "flip": 0.0}
    for n, w in want.items():
        e = bf16_errors(torch.from_numpy(got[n]), torch.from_numpy(w))
        nz = (w != 0) | (got[n] != 0)
        flip = float((np.sign(got[n]) != np.sign(w))[nz].mean()) \
            if nz.any() else 0.0
        out = {"max_rel": max(out["max_rel"], e["max_rel"]),
               "med_rel": max(out["med_rel"], e["med_rel"]),
               "flip": max(out["flip"], flip)}
    return out


def sp_sum_counts(results: list) -> dict:
    total: dict = {}
    for r in results:
        for k, n in r["counts"].items():
            total[k] = total.get(k, 0) + n
    return total


def frames_sp(gpu: str, dev: str = "cuda") -> dict:
    """Phase 23: (a) the sampler on {frames: 5} and (b) the LoRA step on
    {frames: f} (5, or SP_FT_FALLBACK when five ranks' trainers do not fit
    the card), each against one rank in this process first (its results
    kept on the host, its memory freed before the spawn). Returns the
    ranks' launches, summed over (a) and (b)."""
    import gc

    import torch
    from street_crafter_tpu_torch.parallel.mesh import run_ranks
    dev = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    torch.backends.cudnn.deterministic = True
    card_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    t_start = time.perf_counter()
    # five ranks' chunk decodes (~11 GiB each) near fill the card: the
    # ranks' allocators map their memory in expandable segments, so that
    # what one rank frees between its UNet and its decode does not stay
    # reserved in blocks of the wrong size (a rank ran out of memory
    # without it)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        one = sp_sample(None, dev)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as tmp:
            ranks = run_ranks(sp_rank_main, SP_FRAMES, tmp, "sample", tmp,
                              25, SP_FRAMES, backend="gloo",
                              device=dev.type, threads=0,
                              timeout_s=SP_TIMEOUT_S)
        wall_a = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    e = bf16_errors(torch.from_numpy(ranks[0]["frames"]),
                    torch.from_numpy(one["frames"]))
    ec = bf16_errors(torch.from_numpy(one["control"]),
                     torch.from_numpy(one["frames"]))
    want = {k: v * SP_STEPS for k, v in PER_STEP.items()}
    log(f"[23] (a) sample_on_mesh on {{frames: {SP_FRAMES}}} (ranks sharing "
        f"the card through gloo): 25 frames at 576x1024, {SP_STEPS} Euler "
        f"steps, CFG, fused temporal, chunked decode; {wall_a:.1f} s with "
        f"the spawn (one rank's sample {one['sample_s']:.2f} s, engine "
        f"{one['build_s']:.1f} s); ranks' samples "
        f"{[round(r['sample_s'], 2) for r in ranks]} s, engine builds "
        f"{[round(r['build_s'], 1) for r in ranks]} s, all-to-all "
        f"{[round(r['a2a_s'], 2) for r in ranks]} s in "
        f"{ranks[0]['a2a_calls']} calls a rank (through host memory: "
        f"plumbing, not the design's time); peak max_memory_allocated "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB (one rank "
        f"{one['peak_gib']:.2f}); launches a rank "
        f"{[r['counts'] for r in ranks]}; {gpu}")
    log(f"[23] (a) against one rank's sample: the {SP_FRAMES} ranks' largest "
        f"error {e['max_rel']:.3e}, median {e['med_rel']:.3e}; the control "
        f"(one rank, plain temporal stages) {ec['max_rel']:.3e}, "
        f"{ec['med_rel']:.3e} (limits {noise_limits(ec)}: {SP_NOISE_FACTOR} x "
        f"the control's, at least bf16_errors' kernel limits)")
    lim = noise_limits(ec)
    if e["max_rel"] > lim[0] or e["med_rel"] > lim[1]:
        raise AssertionError("the frames-sharded sample is further from "
                             "one rank's than the control")
    for r in ranks:
        check_kernels_only(r["counts"], dev, "a frames rank's sample")
        if r["counts"] != want:
            raise AssertionError(f"a frames rank launched {r['counts']}, "
                                 f"expected {want}")
        if r["shape"] != (25, *SP_HW, 3) \
                or r["checksum"] != ranks[0]["checksum"] \
                or not np.isfinite(r["checksum"]):
            raise AssertionError("the ranks do not hold the same whole "
                                 "window")
    for name, rows in ranks[0]["shard_errs"].items():
        for row in rows:
            check_errors(f"(a) {name} at rank 0's token shard "
                         f"{row['shape']}", row, 23)
    counts = sp_sum_counts(ranks)
    del ranks, one
    # (b): five ranks' trainers, or the fallback
    # the one-rank step at the fallback's length first: what a trainer
    # holds before its step does not depend on it
    t0 = time.perf_counter()
    f, T = SP_FT_FALLBACK
    ref = sp_finetune(None, dev, T, 1, "")
    need = SP_FRAMES * ref["static_gib"]
    log(f"[23] (b) a LoRA trainer holds {ref['static_gib']:.2f} GiB before "
        f"its step (f32 masters and EMA of every UNet leaf, the bf16 "
        f"module, VAE, CLIP): {SP_FRAMES} ranks hold {need:.2f} GiB of the "
        f"card's {card_gib:.2f} GiB before their activations")
    if need <= card_gib:
        f, T = SP_FRAMES, 25
        ref = sp_finetune(None, dev, T, 1, "")
    log(f"[23] (b) on {{frames: {f}}} at {T} frames")
    ref_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sp_") as tmp:
        t0 = time.perf_counter()
        fts = run_ranks(sp_rank_main, f, tmp, "finetune", tmp, T, f,
                        backend="gloo", device=dev.type, threads=0,
                        timeout_s=SP_TIMEOUT_S)
        wall_b = time.perf_counter() - t0
    got, ctl = fts[0], ref["control"]
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    ctl_loss = abs(ctl["loss"] - ref["loss"]) / abs(ref["loss"])
    g_sp, g_ctl = (grad_errors_by_leaf(x["grads"], ref["grads"])
                   for x in (got, ctl))
    u_worst, flip, moved, still = 0.0, 0.0, 0, 0
    for n in ref["grads"]:
        d1 = torch.from_numpy(ref["new"][n] - ref["start"][n])
        dn = torch.from_numpy(got["new"][n] - got["start"][n])
        upd = float(d1.abs().max())
        if upd == 0.0:
            still += 1
            if float(dn.abs().max()) != 0.0:
                raise AssertionError(f"{n}: still on one rank, moves on "
                                     f"{f}")
            continue
        moved += 1
        err = (dn - d1).abs()
        u_worst = max(u_worst, float(err.max()) / upd)
        flip = max(flip, float((err > VDM_UPDATE_RTOL * upd).float().mean()))
    log(f"[23] (b) LoRA step on {{data: 1, frames: {f}}}, one clip of {T} "
        f"frames at 576x1024: {wall_b:.1f} s with the spawn (one rank's "
        f"build and step in this process {ref_s:.1f} s, step "
        f"{ref['step_s']:.2f} s); ranks' steps "
        f"{[round(r['step_s'], 2) for r in fts]} s, encodes "
        f"{[round(r['encode_s'], 2) for r in fts]} s, all-to-all "
        f"{[round(r['a2a_s'], 2) for r in fts]} s in {got['a2a_calls']} "
        f"calls, gradient all-reduce "
        f"{[round(r['comm_s']['all_reduce'], 2) for r in fts]} s (through "
        f"host memory); memory held before the step "
        f"{[round(r['static_gib'], 2) for r in fts]} GiB, peak "
        f"max_memory_allocated {[round(r['peak_gib'], 2) for r in fts]} "
        f"GiB (one rank {ref['static_gib']:.2f} / {ref['peak_gib']:.2f}); "
        f"loss {got['loss']:.6f} against {ref['loss']:.6f} ({loss_rel:.2e} "
        f"relative, limit {SP_LOSS_RTOL}; the control, two copies of the "
        f"clip on one rank: {ctl['loss']:.6f}, {ctl_loss:.2e}); adapters' "
        f"gradients against one rank's, by leaf, the largest error "
        f"{g_sp['max_rel']:.3e} of the leaf's largest, the largest median "
        f"{g_sp['med_rel']:.3e}, signs flipped {100 * g_sp['flip']:.4f}%; "
        f"the control {g_ctl['max_rel']:.3e}, {g_ctl['med_rel']:.3e}, "
        f"{100 * g_ctl['flip']:.4f}% (limits {noise_limits(g_ctl)}); "
        f"updates: {moved} leaves moved, {still} still, the "
        f"largest error {u_worst:.3g} of a leaf's update, at most "
        f"{100 * flip:.4f}% of a leaf's elements beyond {VDM_UPDATE_RTOL} "
        f"of its update (Adam's first step is lr x sign(g)); frozen leaves "
        f"bit-equal {[r['frozen_equal'] for r in fts]} ({got['n_frozen']});"
        f" launches a rank {[r['counts'] for r in fts]}; {gpu}")
    lim = noise_limits(g_ctl)
    if loss_rel > SP_LOSS_RTOL \
            or g_sp["max_rel"] > lim[0] or g_sp["med_rel"] > lim[1] \
            or not moved or not all(r["frozen_equal"] for r in fts) \
            or not ref["frozen_equal"]:
        raise AssertionError("the frames-sharded LoRA step is not the "
                             "one-rank step")
    for r in fts:
        check_kernels_only(r["counts"], dev, "a frames rank's step")
        if {k: r["counts"].get(k, 0) for k in TRAIN_PER_STEP} \
                != TRAIN_PER_STEP:
            raise AssertionError(f"a frames rank's step launched "
                                 f"{r['counts']}, expected {TRAIN_PER_STEP}")
    for k, n in sp_sum_counts(fts).items():
        counts[k] = counts.get(k, 0) + n
    log(f"[23] seconds: (a) {wall_a:.1f}, (b) {wall_b + ref_s:.1f}; phase 23 "
        f"{time.perf_counter() - t_start:.1f} s; launches "
        f"(frames_sp) {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 24: distillation on two ranks sharing the card
# ---------------------------------------------------------------------------

DPD_ITERS = 5              # GS iterations, the event at DPD_EVENT
DPD_EVENT = 2
DPD_STEPS = 3              # Euler steps: the SDS scale 0.7 runs 2 of them
DPD_SCALE = 0.7
DPD_NOVEL_PROB = 0.9       # novel-view steps after the event
DPD_TIMEOUT_S = 600.0
DPD_NOVEL = 26             # phase 16's novel views (one shift of 26 frames)
DPD_RENDERS = 1            # novel views whose condition PNGs are removed


def dp_distill_config(tmp: str, source: str):
    """Phase 16's configuration at train.batch_size 2 on {data: 2}: one
    event at DPD_EVENT of int(DPD_STEPS x DPD_SCALE) Euler steps in
    DPD_ITERS iterations, a checkpoint at the last only, the engine's
    weights left on the card (phase 16 moves them; the pinned copy costs
    seconds)."""
    cfg = distill_config(tmp, source)
    cfg.model_path = os.path.join(tmp, "dp_distill_model")
    cfg.mesh.axes = {"data": DP_B}
    t = cfg.train
    t.batch_size = DP_B
    t.iterations = DPD_ITERS
    t.checkpoint_iterations = []
    t.novel_view_prob = DPD_NOVEL_PROB
    d = cfg.diffusion
    d.num_steps = DPD_STEPS
    d.sample_iterations = [DPD_EVENT]
    d.sds_scales = [DPD_SCALE]
    d.params_on_host = False
    return cfg


def dp_distill_rank(mesh, path: str) -> dict:
    """Phase 24 on one of two ranks sharing the card through gloo:
    runner.train.main with the diffusion hook. Returns its launches, its
    events (wall, split, launches, the moves of the engine's weights),
    each condition render's launches, each GS step's kernel C launches,
    what it wrote and built, the novel frames' digest and its peak."""
    import hashlib

    import torch
    from street_crafter_tpu_torch.data_processor import pointcloud as PC
    from street_crafter_tpu_torch.models.vdm import engine as EN
    from street_crafter_tpu_torch.runner import diffusion as DR
    from street_crafter_tpu_torch.runner import train as T
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    from street_crafter_tpu_torch.training.gs_trainer import check_replicated
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tm = StageTimer()
    for owner, attr, stage in (
            (PC.PointCloudProcessor, "render_conditions", "condition"),
            (PC.PointCloudProcessor, "_splat", "condition splat"),
            (DR.DiffusionRunner, "load_guidance", "guide PNG load"),
            (DR.DiffusionRunner, "load_guidances", "guide PNG load"),
            (DR.DiffusionRunner, "load_cond_image", "cond image load"),
            (DR.DiffusionRunner, "_share", "broadcast"),
            (EN.VideoDiffusionEngine, "encode_images", "encode"),
            (EN.VideoDiffusionEngine, "clip_embed", "CLIP"),
            (EN.VideoDiffusionEngine, "decode_latents_chunked", "decode"),
            (EN, "euler_edm_sample_sds", "Euler steps"),
            (EN, "euler_edm_sample", "Euler steps"),
            (T, "create_scene", "scene build"),
            (VS, "build_engine", "engine build")):
        tm.wrap(owner, attr, stage)
    wrote = {"diffusion PNGs": 0, "checkpoints": 0}
    renders, steps, events, hooks = [], [], [], []

    def patch(owner, attr, make):
        orig = getattr(owner, attr)
        tm._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def counted(key):
        def make(orig):
            def call(*a, **kw):
                wrote[key] += 1
                return orig(*a, **kw)
            return call
        return make

    def splat(orig):
        def call(*a, **kw):
            before = counts_now()
            out = orig(*a, **kw)
            renders.append(counts_since(before))
            return out
        return call

    def step_fn(orig):
        def make(trainer, is_novel, *a, **kw):
            step = orig(trainer, is_novel, *a, **kw)

            def run(*sa, **skw):
                c0 = counts_now().get("composite_backward", 0)
                out = step(*sa, **skw)
                steps.append((is_novel, counts_now().get(
                    "composite_backward", 0) - c0))
                return out
            return run
        return make

    def eval_render_fn(orig):
        def make(trainer, sh):
            fn = orig(trainer, sh)

            def render(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                tm.ms["SDS render"] = tm.ms.get("SDS render", 0.0) + \
                    1e3 * (time.perf_counter() - t0)
                return out
            return render
        return make

    def make_hook(orig):
        def make(cfg, *m):
            hook = orig(cfg, *m)
            store = hook.param_store
            hooks.append({"samples": hook.samples,
                          "nbytes": 0 if store is None else store.nbytes})

            def event(trainer, iteration, scale):
                before, ms0 = counts_now(), dict(tm.ms)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hook(trainer, iteration, scale)
                torch.cuda.synchronize()
                events.append({
                    "iteration": iteration, "scale": scale,
                    "wall_s": time.perf_counter() - t0,
                    "launches": counts_since(before),
                    "stages_ms": {k: v - ms0.get(k, 0.0)
                                  for k, v in tm.ms.items()
                                  if v != ms0.get(k, 0.0)},
                    "moves_s": ({"acquire": 0.0, "release": 0.0}
                                if store is None else dict(store.move_s))})
            return event
        return make

    patch(PC.PointCloudProcessor, "_splat", splat)
    patch(DR, "save_image", counted("diffusion PNGs"))
    patch(T, "save_checkpoint", counted("checkpoints"))
    patch(T.GSTrainer, "step_fn", step_fn)
    patch(T.GSTrainer, "eval_render_fn", eval_render_fn)
    patch(T, "make_diffusion_hook", make_hook)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        trainer = T.main(["--config", path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches_now()
        check_replicated(trainer.state, trainer.mesh)
    finally:
        tm.restore()
    novel = trainer.scene.info.novel_view_cameras
    d = trainer.cfg.diffusion
    hw = (d.height, d.width, 3)
    frames = [c._image for c in novel]
    filled = all(f is not None and f.shape == hw and np.isfinite(f).all()
                 for f in frames)
    digest = hashlib.sha256(b"".join(
        np.ascontiguousarray(f, np.float32).tobytes() for f in frames
        if f is not None)).hexdigest()
    return {"rank": mesh.rank, "wall_s": wall, "counts": counts,
            "events": events, "renders": renders, "steps": steps,
            "hooks": hooks, "wrote": wrote, "stages_ms": dict(tm.ms),
            "novel": len(frames), "filled": filled, "digest": digest,
            "versions": sorted({c.metadata.get("diffusion_version", 0)
                                for c in novel}),
            "state_step": int(trainer.state.step),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def dp_distill(tmp: str, source: str, gpu: str, dev: str = "cuda") -> dict:
    """Phase 24: runner.train.main with the diffusion hook on {data: 2},
    two ranks spawned sharing the card through gloo, in phase 16's scene
    (its condition PNGs on disk but the first novel view's, which rank 0
    renders in the event while rank 1 waits in the condition barrier).
    Returns the two ranks' launches, summed."""
    import torch
    from street_crafter_tpu_torch.config import save_config
    from street_crafter_tpu_torch.parallel.mesh import run_ranks
    t_start = time.perf_counter()
    cfg = dp_distill_config(tmp, source)
    path = os.path.join(tmp, "dp_distill.json")
    save_config(cfg, path)
    # one novel view's condition PNGs go: rank 0 renders them in the event
    # while rank 1 waits in the condition barrier
    novel_dirs = [os.path.join(source, "lidar", n) for n in os.listdir(
        os.path.join(source, "lidar")) if n.startswith("color_render_shift")]
    for n in novel_dirs:
        for f in ("000000_0.png", "000000_0_mask.png"):
            os.remove(os.path.join(n, f))
    torch.cuda.empty_cache()
    ranks = run_ranks(dp_distill_rank, DP_B, tmp, path, backend="gloo",
                      device=dev, threads=0, timeout_s=DPD_TIMEOUT_S)
    wall = time.perf_counter() - t_start
    r0, r1 = ranks
    steps = int(DPD_STEPS * DPD_SCALE)
    windows = DISTILL_WINDOWS
    want = {k: PER_STEP[k] * steps * windows for k in VDM_KERNELS}
    ev0, ev1 = r0["events"], r1["events"]
    if [e["iteration"] for e in ev0] != [DPD_EVENT] or \
            [e["iteration"] for e in ev1] != [DPD_EVENT]:
        raise AssertionError(f"events at {[e['iteration'] for e in ev0]}, "
                             f"{[e['iteration'] for e in ev1]}")
    got0 = {k: ev0[0]["launches"].get(k, 0) for k in VDM_KERNELS}
    got1 = {k: r1["counts"].get(k, 0) for k in VDM_KERNELS}
    for r in ranks:
        check_kernels_only(r["counts"], torch.device("cuda"),
                           f"phase 24 rank {r['rank']}")
    if got0 != want or any(got1.values()):
        raise AssertionError(f"D / E / F launches: rank 0 {got0} (want "
                             f"{want}: {steps} Euler steps x {windows} "
                             f"windows), rank 1 {got1} (want none)")
    if not (r0["filled"] and r1["filled"]) or r0["digest"] != r1["digest"] \
            or r0["novel"] != DPD_NOVEL or r0["versions"] != [1] \
            or r1["versions"] != [1]:
        raise AssertionError(
            f"novel frames: filled {r0['filled']}, {r1['filled']}; digests "
            f"{r0['digest'][:16]}, {r1['digest'][:16]}; {r0['novel']} "
            f"frames; versions {r0['versions']}, {r1['versions']}")
    if [h["samples"] for h in r0["hooks"] + r1["hooks"]] != [True, False] \
            or r1["hooks"][0]["nbytes"] or \
            r1["stages_ms"].get("engine build", 0.0) or \
            any(r1["wrote"].values()) or r1["renders"]:
        raise AssertionError(f"rank 1 built an engine or wrote files: "
                             f"hooks {r1['hooks']}, wrote {r1['wrote']}, "
                             f"{len(r1['renders'])} condition renders")
    if r0["wrote"]["diffusion PNGs"] != DPD_NOVEL or \
            r0["wrote"]["checkpoints"] != 1:
        raise AssertionError(f"rank 0 wrote {r0['wrote']}")
    bad = [c for c in r0["renders"] if c != ONE_RENDER]
    if bad or len(r0["renders"]) != DPD_RENDERS:
        raise AssertionError(f"{len(r0['renders'])} condition renders on "
                             f"rank 0 (want {DPD_RENDERS}), off one A / "
                             f"pack / B: {bad[:3]}")
    for r in ranks:
        c_per_step = [c for _, c in r["steps"]]
        if len(c_per_step) != DPD_ITERS or min(c_per_step) < 1 or \
                r["state_step"] != DPD_ITERS:
            raise AssertionError(f"rank {r['rank']}: GS steps "
                                 f"{r['steps']}, state step "
                                 f"{r['state_step']}")
    novel_steps = sum(n for n, _ in r0["steps"])
    if novel_steps < 1 or [n for n, _ in r0["steps"]] != \
            [n for n, _ in r1["steps"]]:
        raise AssertionError(f"novel-view steps: rank 0 {r0['steps']}, "
                             f"rank 1 {r1['steps']}")
    e0 = ev0[0]
    log(f"[24] runner.train.main on {{data: {DP_B}}} at batch {DP_B} (two "
        f"ranks sharing the card through gloo), {DPD_ITERS} iterations, one "
        f"event at {DPD_EVENT} ({steps} Euler steps x {windows} windows): "
        f"{wall:.1f} s with the spawn (ranks' runs "
        f"{r0['wall_s']:.1f}, {r1['wall_s']:.1f} s; scene builds "
        f"{r0['stages_ms'].get('scene build', 0.0) / 1e3:.1f}, "
        f"{r1['stages_ms'].get('scene build', 0.0) / 1e3:.1f} s; rank 0's "
        f"engine build {r0['stages_ms'].get('engine build', 0.0) / 1e3:.1f}"
        f" s); {DPD_NOVEL} novel frames filled, finite and bit-equal on both "
        f"ranks (sha256 {r0['digest'][:16]}); rank 0 alone built the engine "
        f"({r0['hooks'][0]['nbytes'] / 2 ** 30:.2f} GiB of weights) and "
        f"wrote {r0['wrote']}; rank 1 built none, wrote nothing, launched "
        f"no D / E / F; check_replicated passed; {gpu}")
    log(f"[24] the event: wall {e0['wall_s']:.2f} s on rank 0, "
        f"{ev1[0]['wall_s']:.2f} s on rank 1; rank 0's split: "
        f"{event_split(e0)}; the broadcasts ({windows} window(s) through "
        f"host memory) "
        f"{e0['stages_ms'].get('broadcast', 0.0):.1f} ms on rank 0, "
        f"{ev1[0]['stages_ms'].get('broadcast', 0.0):.1f} ms on rank 1 (its "
        f"wait for rank 0's windows inside); rank 0's D / E / F "
        f"{got0['flash_attention']} / {got0['temporal_block_fused']} / "
        f"{got0['temporal_attention_fused']}, no plain version; "
        f"{len(r0['renders'])} condition renders, each one A, one pack, "
        f"one B")
    log(f"[24] GS steps (novel, kernel C launches): rank 0 {r0['steps']}, "
        f"rank 1 {r1['steps']}; peak max_memory_allocated rank 0 "
        f"{r0['peak_gib']:.2f} GiB, rank 1 {r1['peak_gib']:.2f} GiB; "
        f"launches rank 0 {r0['counts']}, rank 1 {r1['counts']}; phase 24 "
        f"{time.perf_counter() - t_start:.1f} s")
    total: dict = {}
    for r in ranks:
        for k, n in r["counts"].items():
            total[k] = total.get(k, 0) + n
    return total


# ---------------------------------------------------------------------------
# phase 25: the W8A8 eval UNet (kernel Q)
# ---------------------------------------------------------------------------

Q_SOURCE = "street_crafter_tpu_torch/csrc/int8_conv.cu"
Q_REPLACES = ("street_crafter_tpu/models/vdm/layers.py:74 (Int8Conv; not a "
              "Pallas kernel: XLA's int8 conv_general_dilated)")
PEAK_INT8_OPS = 1.979e15
Q_PER_EVAL = 50            # 22 ResBlocks x 2, 3 Downsamples, 3 Upsamples
Q_REPS = 5
Q_EVALS = 3
Q_PSNR_FLOOR = 20.0        # dB: a broken quantizer reads near 0
Q_FRAMES = 25
Q_LATENT = (72, 128)       # 576x1024 / 8
Q_TINY = False             # the tiny engine (a CPU rehearsal)


def q_inputs(dev, N, C, O, H, W, nhwc, seed):
    """Seeded bf16 activations [N, C, H, W] (channels-last memory when
    ``nhwc``), weights N(0, 1 / fan_in) and a bias, as the eval UNet
    holds them."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((N, C, H, W), generator=g, device=dev).to(torch.bfloat16)
    if nhwc:
        x = x.contiguous(memory_format=torch.channels_last)
    w = (torch.randn((O, C, 3, 3), generator=g, device=dev)
         / (9 * C) ** 0.5).to(torch.bfloat16)
    b = (0.1 * torch.randn((O,), generator=g, device=dev)).to(torch.bfloat16)
    return x, w, b


def q_bound(N, C, O, H, W, stride) -> dict:
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    ops = 2.0 * N * Ho * Wo * O * 9 * C
    nbytes = 2.0 * (N * C * H * W + O * C * 9 + O + N * O * Ho * Wo)
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_INT8_OPS
    return {"bound_ms": 1e3 * max(t_b, t_o), "ops": ops,
            "bound_by": "bytes" if t_b >= t_o else "operations"}


def bf16_ulps(got, want) -> int:
    """The largest distance in bf16 steps between two bf16 tensors."""
    import torch

    def key(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return int((key(got) - key(want)).abs().max())


Q_LAUNCHES = {"sc_int8_absmax": "absmax", "sc_int8_quantize": "quantize",
              "sc_int8_weight_quant": "weight_quant", "sc_int8_conv": "conv"}
Q_SPIN_CYCLES = 2_000_000  # ~1.1 ms of torch.cuda._sleep ahead of each call


def q_split(Q, x, w, b, s, reps: int = Q_REPS) -> dict:
    """One ``int8_conv2d`` call split by launch: CUDA events around each
    of the wrapper's four C entries, reached through a stand-in for
    ``Q._library``. Each call is enqueued behind a spin kernel, so the
    host is ahead and each interval is the device's own time of its
    launch. Also the wrapper's host time a call: the Python call to its
    return, unsynchronised, with the device busy behind it. Device ms
    are means over ``reps`` calls."""
    import torch
    lib = Q._library()
    marks: list = []

    class Timed:
        def __getattr__(self, name):
            fn = getattr(lib, name)
            if name not in Q_LAUNCHES:
                return fn

            def call(*args):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                r = fn(*args)
                e1.record()
                marks.append((Q_LAUNCHES[name], e0, e1))
                return r
            return call

    library = Q._library
    Q._library = lambda: Timed()
    try:
        Q.int8_conv2d(x, w, b, s)
        torch.cuda.synchronize()
        marks.clear()
        for _ in range(reps):
            torch.cuda._sleep(Q_SPIN_CYCLES)
            Q.int8_conv2d(x, w, b, s)
        torch.cuda.synchronize()
    finally:
        Q._library = library
    split = {k: 0.0 for k in Q_LAUNCHES.values()}
    for k, e0, e1 in marks:
        split[k] += e0.elapsed_time(e1) / reps
    split["device"] = sum(split.values())
    torch.cuda._sleep(10 * Q_SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        Q.int8_conv2d(x, w, b, s)
    split["host"] = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return split


def q_shape_row(Q, dev, shape: dict, seed: int, gpu: str) -> dict:
    """Q at one of the UNet's shapes against its plain version: the int32
    products and the scales exactly equal, the bf16 outputs within 1
    ulp; its time beside the bound, the plain version's, F.conv2d in
    bf16 and torch._int_mm on the int8 input's im2col (checked equal to
    the products too); the call split by launch (``q_split``)."""
    import torch
    import torch.nn.functional as F
    N, C, O, H, W, s = (shape[k] for k in ("N", "C", "O", "H", "W",
                                           "stride"))
    x, w, b = q_inputs(dev, N, C, O, H, W, shape["nhwc"], seed)
    with torch.no_grad():
        prod, xs, ws = Q.int8_products(x, w, s)
        pref, xsr, wsr = Q.int8_products_reference(x, w, s)
        out = Q.int8_conv2d(x, w, b, s)
        ref = Q.int8_conv2d_reference(x, w, b, s)
        torch.cuda.synchronize()
        equal = bool(torch.equal(prod, pref)) and bool(
            torch.equal(xs, xsr)) and bool(torch.equal(ws, wsr))
        ulps = bf16_ulps(out, ref)
        err = float((out.float() - ref.float()).abs().max())
        if not equal or ulps > 1 or out.shape != ref.shape:
            raise AssertionError(f"Q at {shape}: int32 products equal "
                                 f"{equal}, bf16 outputs {ulps} ulp apart")
        ms = cuda_ms(lambda: Q.int8_conv2d(x, w, b, s), Q_REPS)
        split = q_split(Q, x, w, b, s)
        plain_ms = cuda_ms(lambda: Q.int8_conv2d_reference(x, w, b, s), 1,
                           warmup=0)
        conv_ms = cuda_ms(lambda: F.conv2d(x, w, b, s, 1), Q_REPS)
        xq = Q.quantize_reference(x, xsr)
        wq = Q.quantize_reference(w, wsr[:, None, None, None])
        Ho, Wo = prod.shape[2:]
        cols = F.unfold(xq.to(torch.bfloat16), 3, padding=1, stride=s)
        a = cols.to(torch.int8).transpose(1, 2).reshape(N * Ho * Wo, C * 9)
        del cols
        bmat = wq.reshape(O, C * 9).t()
        mm = torch._int_mm(a, bmat)
        if not torch.equal(mm.reshape(N, Ho * Wo, O).transpose(1, 2).reshape(
                N, O, Ho, Wo), pref):
            raise AssertionError(f"torch._int_mm's products differ at "
                                 f"{shape}")
        int_mm_ms = cuda_ms(lambda: torch._int_mm(a, bmat), Q_REPS)
        del a, mm, prod, pref, out, ref, xq
    bound = q_bound(N, C, O, H, W, s)
    row = {"shape": [N, C, H, W], "out_channels": O, "stride": s,
           "kind": shape["kind"], "per_eval": shape["count"],
           "channels_last": shape["nhwc"], "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "library_ms": conv_ms, "int_mm_ms": int_mm_ms,
           "tops": bound["ops"] / ms / 1e9, "max_abs_err": err,
           "ulps": ulps, "split": split,
           "conv_tops": bound["ops"] / split["conv"] / 1e9}
    log(f"[25] Q at [{N}, {C}, {H}, {W}] -> {O}, stride {s} "
        f"({shape['kind']}, {shape['count']} an eval): int32 products, "
        f"scales equal, bf16 out {ulps} ulp; {ms:.4f} ms "
        f"({row['tops']:.1f} TOPS), bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']}), plain {plain_ms:.2f} ms, F.conv2d bf16 "
        f"{conv_ms:.4f} ms ({ms / conv_ms:.3f}x), torch._int_mm on the "
        f"im2col {int_mm_ms:.4f} ms ({ms / int_mm_ms:.3f}x); split (device "
        f"ms by launch) absmax {split['absmax']:.4f}, quantize "
        f"{split['quantize']:.4f}, weight_quant {split['weight_quant']:.4f}, "
        f"conv {split['conv']:.4f} ({row['conv_tops']:.1f} TOPS), sum "
        f"{split['device']:.4f}; host {split['host']:.4f} ms a call; {gpu}")
    return row


def w8a8_eval(gpu: str, dev: str = "cuda") -> tuple[dict, dict]:
    """Phase 25: the CFG UNet eval at full width (phase 9's seeded
    weights) built from UNetConfig(quant_convs=True), against the bf16
    eval of the same weights: exactly Q_PER_EVAL launches of Q an eval
    and no plain version, finite outputs, the per-frame PSNR (min and
    median) and each eval's median time; then Q against its plain version
    at each distinct shape that eval gave it. Returns (the eval's
    launches, Q's kernel row)."""
    import torch
    from street_crafter_tpu_torch.config import default_config
    from street_crafter_tpu_torch.models.vdm import layers as PL
    from street_crafter_tpu_torch.models.vdm.engine import materialize
    from street_crafter_tpu_torch.models.vdm.unet import VideoUNet
    from street_crafter_tpu_torch.ops import int8_conv as Q
    from street_crafter_tpu_torch.runner import vdm_sample as VS
    t_start = time.perf_counter()
    dev = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
    cfg = default_config()
    cfg.merge({"device": dev.type,
               "diffusion": {"tiny": Q_TINY, "ckpt_path": "",
                             "init_zero_layers_std": 1.0}})
    T, B = Q_FRAMES, 2
    eng = VS.build_engine(cfg, T, dev)
    unet = eng.unet
    del eng
    with torch.device("meta"):
        qunet = VideoUNet(dataclasses.replace(unet.cfg, quant_convs=True))
    qunet = materialize(qunet, dev, unet.input_blocks[0][0].weight.dtype)
    qunet.load_state_dict(unet.state_dict())
    rng = np.random.default_rng(25)
    mc = unet.cfg
    h, w = Q_LATENT

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    args = (t(rng.normal(size=(B * T, h, w, mc.in_channels))),
            t(np.full(B * T, 0.25 * np.log(0.7))),
            t(rng.normal(size=(B, 1, mc.context_dim))),
            t(rng.normal(size=(B, mc.adm_in_channels))))
    kw = dict(num_frames=T, cond_mask=t(np.tile(np.eye(T)[0], B)),
              guidance_input=t(rng.normal(
                  size=(B * T, h, w, mc.in_channels // 2))),
              guidance_scale=t(np.repeat([0.0, 1.0], T)))
    # the shapes the eval gives Q: each quantized convolution's input
    seen = []
    quant_conv = PL.quant_conv

    def recorded(x, mod, frames=None):
        seen.append((tuple(x.shape), mod.weight.shape[0], mod.stride[0],
                     Q._channels_last(x)))
        return quant_conv(x, mod, frames)
    PL.quant_conv = recorded
    reset_launches()
    Q.reset_launch_counts()
    try:
        with torch.no_grad():
            out_q = qunet(*args, **kw)
            torch.cuda.synchronize()
    finally:
        PL.quant_conv = quant_conv
    counts = {**launches_now(), **Q.launches}
    with torch.no_grad():
        out = unet(*args, **kw)
        q_ms = sync_ms(lambda: qunet(*args, **kw), Q_EVALS)
        ms = sync_ms(lambda: unet(*args, **kw), Q_EVALS)
    if counts.get("int8_conv", 0) != Q_PER_EVAL or \
            counts.get("int8_conv_reference", 0) or \
            {k: counts.get(k, 0) for k in VDM_KERNELS} != PER_STEP:
        raise AssertionError(f"the W8A8 eval launched {counts}: want "
                             f"{Q_PER_EVAL} of Q, {PER_STEP}, no plain "
                             f"version")
    a, r = out_q.float(), out.float()
    if out_q.shape != (B * T, h, w, 4) or not bool(
            torch.isfinite(a).all()):
        raise AssertionError(f"W8A8 eval: {tuple(out_q.shape)}, finite "
                             f"{bool(torch.isfinite(a).all())}")
    mse = ((a - r) ** 2).flatten(1).mean(1)
    peak = r.flatten(1).amax(1) - r.flatten(1).amin(1)
    psnr = (10 * torch.log10(peak ** 2 / mse.clamp(min=1e-30))).cpu()
    rel = float((a - r).abs().max() / r.abs().max())
    log(f"[25] the CFG UNet eval ({B} x {T} frames at {h}x{w}) from "
        f"UNetConfig(quant_convs=True) against the bf16 eval of phase 9's "
        f"seeded weights: per-frame PSNR min {float(psnr.min()):.2f} dB, "
        f"median {float(psnr.median()):.2f} dB (peak: the bf16 frame's "
        f"range), largest error {rel:.3e} of the largest |output|; "
        f"median of {Q_EVALS}: W8A8 {statistics.median(q_ms):.1f} ms, bf16 "
        f"{statistics.median(ms):.1f} ms; launches an eval {counts}; {gpu}")
    if not float(psnr.min()) > Q_PSNR_FLOOR:
        raise AssertionError(f"W8A8 eval: per-frame PSNR {psnr.tolist()}")
    del qunet, unet, out, out_q, a, r, args, kw
    torch.cuda.empty_cache()
    shapes: dict = {}
    for (N, C, H, W), O, s, nhwc in seen:
        key = (N, C, O, H, W, s, nhwc)
        shapes[key] = shapes.get(key, 0) + 1
    kinds = {1: "stride 1 (ResBlock, Upsample)", 2: "stride 2 (Downsample)"}
    rows = []
    for i, ((N, C, O, H, W, s, nhwc), n) in enumerate(shapes.items()):
        rows.append(q_shape_row(Q, dev, {
            "N": N, "C": C, "O": O, "H": H, "W": W, "stride": s,
            "nhwc": nhwc, "count": n, "kind": kinds[s]}, 500 + i, gpu))
        torch.cuda.empty_cache()
    head = max(rows, key=lambda r: r["per_eval"] * r["ms"])
    row = {"name": "int8_conv", "route": "cuda", "source": Q_SOURCE,
           "replaces": Q_REPLACES,
           "launches": counts["int8_conv"],
           "launches_by_path": {"w8a8_eval": counts["int8_conv"]},
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "ms": round(head["ms"], 4), "plain_ms": round(head["plain_ms"], 4),
           "bound_ms": round(head["bound_ms"], 6),
           "bound_by": head["bound_by"],
           "library_ms": round(head["library_ms"], 4),
           "library_call": "F.conv2d in bf16 (cuDNN)",
           "int_mm_ms": round(head["int_mm_ms"], 4),
           "eval_ms": {"w8a8": round(statistics.median(q_ms), 2),
                       "bf16": round(statistics.median(ms), 2)},
           "psnr_db": {"min": round(float(psnr.min()), 3),
                       "median": round(float(psnr.median()), 3)},
           "shapes": [{k: (round(v, 5) if isinstance(v, float) else v)
                       for k, v in r.items()} for r in rows]}
    total = {k: sum(r[k] * r["per_eval"] for r in rows)
             for k in ("ms", "bound_ms", "library_ms", "int_mm_ms")}
    split = {k: sum(r["split"][k] * r["per_eval"] for r in rows)
             for k in rows[0]["split"]}
    row["eval_split_ms"] = {k: round(v, 3) for k, v in split.items()}
    row["eval_sum_ms"] = {k: round(v, 3) for k, v in total.items()}
    log(f"[25] Q over one eval's {sum(r['per_eval'] for r in rows)} "
        f"convolutions at {len(rows)} shapes: {total['ms']:.2f} ms against "
        f"a bound of {total['bound_ms']:.3f} ms, F.conv2d bf16 "
        f"{total['library_ms']:.2f} ms "
        f"({total['ms'] / total['library_ms']:.3f}x), torch._int_mm "
        f"{total['int_mm_ms']:.2f} ms; split (device ms by "
        f"launch) absmax {split['absmax']:.2f}, quantize "
        f"{split['quantize']:.2f}, weight_quant {split['weight_quant']:.2f}, "
        f"conv {split['conv']:.2f}, sum {split['device']:.2f}; host "
        f"{split['host']:.2f} ms; phase 25 "
        f"{time.perf_counter() - t_start:.1f} s")
    return counts, row


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    from street_crafter_tpu_torch.models.gs.scene import FlatGaussians
    from street_crafter_tpu_torch.ops import cuda_build
    from street_crafter_tpu_torch.ops import gs_raster as G
    from street_crafter_tpu_torch.runner import render as R
    from street_crafter_tpu_torch.utils.png import read_png

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    log(f"[1] card: {gpu}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    builds = cuda_build.build()          # one nvcc per source, in parallel
    G._library()
    log(f"[1] built " + ", ".join(os.path.relpath(lib, here)
                                  for lib, _ in builds.values())
        + f" in {time.perf_counter() - t0:.1f} s")
    data = prefetch_data(tempfile.mkdtemp(prefix="chip_smoke_data_"))
    for name, (_, ptxas) in builds.items():
        for e in ptxas_entries(ptxas):
            log(f"    ptxas {name}: {e['kernel']}: {e['registers']} "
                f"registers, {e['spill_stores']} / {e['spill_loads']} bytes "
                f"spilled (stores / loads)"
                + "".join(f"; {n}" for n in e["notes"]))

    # ---- phase 2: kernels vs plain versions --------------------------------
    small = heavy_pool_in_camera(np.eye(4), dev, N_SMALL)
    flat = FlatGaussians(small.xyz, small.get_rotation(),
                         small.get_scaling(), small.get_opacity()[:, 0],
                         small.get_features(), small.valid)
    K_small = torch.tensor([[1.1 * W_SMALL, 0, W_SMALL / 2],
                            [0, 1.1 * W_SMALL, H_SMALL / 2], [0, 0, 1]],
                           device=dev)
    small_args = raster_args(flat, torch.eye(4, device=dev), K_small,
                             W_SMALL, H_SMALL)
    small_label = f"trained-like {N_SMALL} splats {W_SMALL}x{H_SMALL}"
    compare(G, small_args, small_label, 2)
    wide = wide_splat_args(dev)
    n_wide = int(((wide["radii"] > 200) & wide["valid"]).sum())
    wide_label = (f"wide splats ({n_wide} with radius > 200 px) "
                  f"{W_SMALL}x{H_SMALL}")
    compare(G, wide, wide_label, 2)
    for C in CHANNEL_CASES:
        label = f"{C} channel(s), wide splats {W_SMALL}x{H_SMALL}"
        cargs = channel_case_args(dev, C)
        compare(G, cargs, label, 2)
        compare_backward(G, cargs, label, 20 + C, phase=2)
    long_args = long_list_args(dev)
    wl_long = G.tile_worklist(**split_args(long_args)[0])
    label = (f"a tile list of {list_lengths(wl_long)['max']:.0f} pairs "
             f"{W_SMALL}x{H_SMALL}")
    compare(G, long_args, label, 2)
    compare_backward(G, long_args, label, 30, phase=2)
    del cargs, long_args, wl_long
    # ---- phase 21 (a): kernels B, C and the pack past 7 channels --------
    sem_wide_err = wide_channel_cases(G, small_args, small_label)
    forced = forced_list_args(dev)
    check_worklist(G.tile_worklist(**forced),
                   G.tile_worklist_reference(**forced), "forced list")
    log(f"[2] kernel A on {forced['u'].shape[0]} splats over one tile "
        f"{forced['width']}x{forced['height']}: a list of 40000 pairs, "
        f"sorted in passes over device memory; worklist and tile order "
        f"equal")
    del forced

    # ---- phase 3: the main path --------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg, cfg_path = build_main_path_scene(tmp, dev, data[3])
        torch.cuda.reset_peak_memory_stats()
        G.reset_launch_counts()
        t0 = time.perf_counter()
        result = R.main(["--config", cfg_path, "mode=trajectory",
                         "render.save_video=false"])
        wall = time.perf_counter() - t0
        render_counts = dict(G.launches)
        peak = torch.cuda.max_memory_allocated()
        log(f"[3] runner.render.main: {len(result['frame_ms'])} frames in "
            f"{wall:.1f} s; launches {render_counts}")
        if render_counts.get("tile_worklist", 0) < 1 or \
                render_counts.get("pair_records", 0) < 1 or \
                render_counts.get("composite", 0) < 1:
            raise AssertionError(f"main path missed a kernel: "
                                 f"{render_counts}")
        if render_counts.get("tile_worklist_reference", 0) or \
                render_counts.get("composite_reference", 0):
            raise AssertionError(f"main path ran a plain version: "
                                 f"{render_counts}")
        rgb_dir = os.path.join(result["out_dir"], "rgb")
        pngs = sorted(os.listdir(rgb_dir))
        if len(pngs) != 12:
            raise AssertionError(f"expected 12 rgb PNGs, got {pngs}")
        for name in pngs:
            img = read_png(os.path.join(rgb_dir, name))
            if img.shape != (1067, 1600, 3) or img.max() == 0:
                raise AssertionError(f"{name}: shape {img.shape}, max "
                                     f"{img.max()}")
        ms = result["frame_ms"]
        log(f"[3] {len(pngs)} PNGs {img.shape[1]}x{img.shape[0]}; ms/frame "
            f"median {statistics.median(ms):.2f} (first {ms[0]:.2f}, min "
            f"{min(ms):.2f}); headline frame pairs {result['n_pairs'][0]}; "
            f"max_memory_allocated {peak / 2 ** 30:.2f} GiB; card {gpu}")

        # ---- phases 4-5: kernels vs plain at the headline frame ----------
        # (kernel C first on phase 2's inputs, then both passes of the
        # headline frame: the foreground and the sky)
        compare_backward(G, small_args, small_label, 5)
        compare_backward(G, wide, wide_label, 6)
        args, cam0, n_splats = headline_raster_args(cfg, dev)
        fg = headline_pass(G, args, f"headline frame {cam0.width}x"
                           f"{cam0.height}, {n_splats} splats", gpu)
        sky_args, n_sky = headline_sky_args(cfg, dev)
        sky = headline_pass(G, sky_args, f"headline frame sky pass, {n_sky} "
                            f"splats", gpu)
        times, errs = fg["times"], fg["errs"]
        bound = bounds(n_splats, fg["wl"].n_pairs, fg["wl"].ranges.shape[0],
                       fg["pixels"], fg["prefix"], fg["hits"],
                       args["colors"].shape[1])
        # ---- phase 21 (b), (c): the semantic channel at the headline -----
        sem_counts, sem_rows = semantic_headline(G, cfg, dev, fg, gpu)
        semantic_densify_ply(tmp, dev, gpu)
        # phase 15 splits kernel A on these inputs, after phase 13
        split_inputs = {"foreground": fg["geo"], "sky": sky["geo"]}
        headline = {"graphs": fg["graphs"], "sort_ms": fg["sort_ms"],
                    "sky": {k: sky[k] for k in ("times", "graphs",
                                                "sort_ms")}}
        del fg, sky, args, sky_args
        torch.cuda.empty_cache()

        # ---- phase 6: the training main path ------------------------------
        train_counts = train_main_path(G, cfg.source_path, tmp, gpu)

        # ---- phase 7: the train step at the 600k shape --------------------
        phase7 = step_time(G, cfg, dev, gpu)

        # ---- phase 18 (a), (b): camera-batched GS training, one rank -----
        dp_counts = dp_step_time(G, cfg, dev, gpu, phase7)
        for k, n in dp_train_main(G, cfg.source_path, tmp, gpu).items():
            dp_counts[k] = dp_counts.get(k, 0) + n

    # ---- phase 8: kernels D, E, F vs plain versions -----------------------
    vdm_errs = compare_vdm_kernels()

    # ---- phase 9: the sampling main path -----------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vdm_") as tmp:
        vdm_counts, vdm_cfg, vdm_peak = vdm_main_path(tmp, gpu, data[9])

        # ---- phase 10: times -----------------------------------------------
        vdm_times(vdm_cfg, gpu)
        vdm_rows = vdm_kernel_times(gpu)

        # ---- phase 11: kernels D with lse, G, H vs plain versions ----------
        train_errs = compare_train_kernels()

        # ---- phase 12: the fine-tune main path -----------------------------
        ft_counts, ft = vdm_train_main_path(tmp, data[9].result(), gpu)

        # ---- phase 13: times -----------------------------------------------
        ft_batch = vdm_train_times(ft, gpu)

        # ---- phase 19: the remat policies, LoRA ----------------------------
        policy_counts, _ = remat_policy_steps(ft["trainer"], ft_batch, gpu)
        ft_config = ft["config"]
        del ft, ft_batch
        torch.cuda.empty_cache()
        lora_counts = lora_steps(ft_config, gpu)

        # ---- phase 20: the fixed blender, the reward -----------------------
        fixed_counts = fixed_blender_eval(vdm_cfg, gpu)
        reward_counts = reward_main_path(vdm_cfg, tmp, gpu)
    ft_rows = vdm_train_kernel_times(gpu)

    # ---- phase 14: kernel A's variant bench --------------------------------
    variant_rows, variant_counts = variant_bench(dev, gpu)

    # ---- phase 15: kernel A's split -----------------------------------------
    a_split = worklist_split(G, split_inputs, gpu)

    # ---- phase 16: distillation ---------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_distill_") as tmp:
        distill_counts, cond_rows, source = distill_main_path(G, tmp, gpu,
                                                              data[16])

        # ---- phase 24: distillation on two ranks sharing the card ------
        torch.cuda.empty_cache()
        dpd_counts = dp_distill(tmp, source, gpu)

    # ---- phase 17: cubemap sky, colour MLPs, COLMAP points, virtual_warp ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sky_") as tmp:
        sky_counts = sky_color_main_path(G, tmp, gpu, phase7, data[17])

    # ---- phase 18 (c): two ranks sharing the card through gloo ------------
    torch.cuda.empty_cache()
    ranks_counts, x1_row = dp_two_ranks(gpu)
    for k, n in ranks_counts.items():
        dp_counts[k] = dp_counts.get(k, 0) + n

    # ---- phase 22: host-side data processing on the card ------------------
    torch.cuda.empty_cache()
    data_counts, data_rows = data_processing(G, gpu)

    # ---- phase 23: frames-axis sequence parallelism -----------------------
    torch.cuda.empty_cache()
    sp_counts = frames_sp(gpu)

    # ---- phase 25: the W8A8 eval UNet (kernel Q) ---------------------------
    torch.cuda.empty_cache()
    q_counts, q_row = w8a8_eval(gpu)

    # each main path's counts, read right after its own reset; "launches"
    # is their sum
    by_path = {name: {"render": render_counts.get(name, 0),
                      "train": train_counts.get(name, 0), "vdm_sample": 0,
                      "vdm_train": 0,
                      "distill": distill_counts.get(name, 0),
                      "sky_color": sky_counts.get(name, 0),
                      "data_parallel": dp_counts.get(name, 0),
                      "semantic": sem_counts.get(name, 0),
                      "pandaset": data_counts.get(name, 0),
                      "dp_distill": dpd_counts.get(name, 0)}
               for name in REPLACES}
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name],
         "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name],
         "max_abs_err": errs[name], "ms": round(times[name][0], 4),
         "plain_ms": round(times[name][1], 4),
         "bound_ms": round(bound[name]["bound_ms"], 6),
         "bound_by": bound[name]["bound_by"],
         # no single PyTorch call computes these functions (for kernel A,
         # torch.sort of its keys does a part of it: "library_part_ms")
         "library_ms": None,
         "graph_ms": round(headline["graphs"][name], 4),
         "sky": {"ms": round(headline["sky"]["times"][name][0], 4),
                 "plain_ms": round(headline["sky"]["times"][name][1], 4),
                 "graph_ms": round(headline["sky"]["graphs"][name], 4)}}
        for name in ("tile_worklist", "pair_records", "composite",
                     "composite_backward")]
    # kernels A, the pack and B at one condition render (phase 16) and at
    # one PandaSet condition render (phase 22)
    for k in kernels:
        if k["name"] in cond_rows:
            k["condition_render"] = cond_rows[k["name"]]
            k["pandaset_render"] = data_rows[k["name"]]
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"],
                                    cond_rows["_errs"], data_rows["_errs"],
                                    sem_wide_err, sem_rows["composite_err"])
    # the pack, B and C at the headline frame with SEM_CLASSES classes and
    # at their widest (phase 21); kernel A's own time there too
    for k in kernels:
        k["wide"] = {str(c): sem_rows[c][k["name"]]
                     for c in (4 + SEM_CLASSES, G.MAX_CHANNELS)}
    a_row = kernels[0]
    a_row["graph_of"] = "the part after the host synchronisation"
    a_row["library_part_ms"] = round(headline["sort_ms"], 4)
    a_row["library_part"] = "torch.sort(stable=True) of the 64-bit keys"
    a_row["sky"]["library_part_ms"] = round(headline["sky"]["sort_ms"], 4)
    a_row["kernels"] = list(A_KERNELS)
    a_row["split"] = a_split
    for k in kernels:
        log(f"[7] {k['name']}: {k['ms']:.3f} ms against a bound of "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}), plain "
            f"{k['plain_ms']:.3f} ms, launches {k['launches_by_path']}")
    # kernels D, E, F: the numbers at the first (largest) sampling shape;
    # "shapes" has every sampling shape and, for kernel D, every training
    # shape (its form with lse); kernel D's vdm_train launches are its lse
    # form's
    def rounded(rows):
        return [{k: (round(v, 4) if isinstance(v, float) else
                     rounded(v) if isinstance(v, list) and v
                     and isinstance(v[0], dict) else v)
                 for k, v in r.items()} for r in rows]

    for name in VDM_KERNELS:
        head = vdm_rows[name][0]
        lse = "flash_attention_lse" if name == "flash_attention" else name
        paths = {"render": 0, "train": 0,
                 "vdm_sample": vdm_counts.get(name, 0),
                 "vdm_train": ft_counts.get(lse, 0),
                 "distill": distill_counts.get(name, 0), "sky_color": 0,
                 "data_parallel": dp_counts.get(lse, 0),
                 "remat_policies": policy_counts.get(lse, 0),
                 "lora": lora_counts.get(lse, 0),
                 "fixed_blender": fixed_counts.get(name, 0),
                 "reward": reward_counts.get(name, 0),
                 # the sampler's D, E, F and the step's D with lse
                 "frames_sp": sp_counts.get(name, 0) + (
                     sp_counts.get(lse, 0) if lse != name else 0),
                 "dp_distill": dpd_counts.get(name, 0),
                 "w8a8_eval": q_counts.get(name, 0)}
        shapes = rounded(vdm_rows[name])
        if name == "flash_attention":
            shapes += [dict(r, path="vdm_train")
                       for r in rounded(ft_rows[name])]
        kernels.append({
            "name": name, "route": "cuda", "source": VDM_SOURCES[name],
            "replaces": VDM_REPLACES[name],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": max(vdm_errs[name], train_errs.get(name, 0.0)),
            "ms": round(head["ms"], 4),
            "plain_ms": round(head["plain_ms"], 4),
            "bound_ms": round(head["bound_ms"], 6),
            "bound_by": head["bound_by"],
            "library_ms": (None if head["library_ms"] is None
                           else round(head["library_ms"], 4)),
            "shapes": shapes})
    # kernels G and H: the numbers at the first (largest) training shape;
    # library_ms is one scaled_dot_product_attention backward, which
    # computes dq, dk and dv together (G + H)
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        head = ft_rows[name][0]
        paths = {"render": 0, "train": 0, "vdm_sample": 0,
                 "vdm_train": ft_counts.get(name, 0),
                 "distill": distill_counts.get(name, 0), "sky_color": 0,
                 "data_parallel": dp_counts.get(name, 0),
                 "remat_policies": policy_counts.get(name, 0),
                 "lora": lora_counts.get(name, 0),
                 "frames_sp": sp_counts.get(name, 0),
                 "dp_distill": dpd_counts.get(name, 0)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": VDM_SOURCES["flash_attention"],
            "replaces": BWD_REPLACES[name],
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": train_errs[name], "ms": round(head["ms"], 4),
            "plain_ms": round(head["plain_ms"], 4),
            "bound_ms": round(head["bound_ms"], 6),
            "bound_by": head["bound_by"],
            "library_ms": round(head["library_ms"], 4),
            "library_covers": "dq, dk and dv (G + H)",
            "shapes": rounded(ft_rows[name])})
    # kernel A's variant bench (phase 14): its own run's launches
    for r in variant_rows:
        kernels.append({
            "name": f"row_compact_{r['name']}", "route": "cuda",
            "source": VARIANT_SOURCE,
            "replaces": VARIANT_REPLACES[r["variant"]],
            "launches": variant_counts.get(r["name"], 0),
            "launches_by_path": {"variant_bench": variant_counts.get(
                r["name"], 0), "distill": 0, "sky_color": 0,
                "data_parallel": 0},
            "max_abs_err": r["max_abs_err"],
            "ms": round(r["ms"], 4), "device_ms": round(r["device_ms"], 4),
            "plain_ms": round(r["plain_ms"], 4),
            "bound_ms": round(r["bound_ms"], 6), "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], "kb": r["kb"]})
    # the SPMD bridge's x2 (X1 / X2): its launches are the two ranks' of
    # phase 18 (c), its times at a rank's shard
    kernels.append({
        "name": "kernel_shard", "route": "cuda", "source": X1_SOURCE,
        "replaces": X1_REPLACES, "launches": x1_row["launches"],
        "launches_by_path": {"data_parallel": x1_row["launches"]},
        "max_abs_err": x1_row["max_abs_err"], "ms": round(x1_row["ms"], 5),
        "plain_ms": round(x1_row["plain_ms"], 5),
        "bound_ms": x1_row["bound_ms"], "bound_by": "bytes",
        "library_ms": round(x1_row["library_ms"], 5),
        "library_call": "torch.mul(x, 2.0)", "shape": [1, *X1_SHAPE[1:]],
        "also_replaces": "tests/test_kernel_shard.py:17"})
    # kernel Q (phase 25): its launches are one W8A8 eval's
    kernels.append(q_row)
    log(f"[10] sampling peak max_memory_allocated {vdm_peak:.2f} GiB")
    log(f"[18] data_parallel launches (phase 18's main paths): {dp_counts}")
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
