#!/usr/bin/env python3
"""TF32 wgmma throughput on the card, by the product shapes of the f32
kernels G and H (``csrc/flash_attention_f32.cu``).

    python3 street_crafter_tpu_torch/scripts/tf32_wgmma_rates.py [--iters N]

One block per SM (132), each with an idle producer warpgroup and two
consumer warpgroups as in G and H, every consumer issuing one group of
products a loop pass (fence, the products, commit, wait) on operand tiles
in shared memory (128-byte swizzle, K-major), N passes. Each group is
786,432 multiply-adds a warpgroup, as one of G's or H's per 32-row tile:

  score_3x      3 m64n32k8 from shared memory a k8 step, 2 products
                (the score tiles' three split products, separate)
  score_merged  m64n64k8 + m64n32k8 from shared memory (G's and H's form:
                A_hi against B's hi and lo rows at once, then A_lo B_hi)
  score_rs_hi   the same with A_hi from registers (m64n64k8 RS)
  update_rs     3 m64n64k8 with A from registers (dV, dK, dQ's products)
  ss_n64        m64n64k8 from shared memory only
  rs_n128       m64n128k8 with A from registers

Prints one JSON object (TF/s of TF32 products and the share of the dense
495 TF/s for each), then the card's name and power limit. The source is
compiled with nvcc (``ops.cuda_build``'s flags) into the package's build
directory.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

SOURCE = r'''
#include "hopper.cuh"

namespace {

constexpr int SMEM = 1024 + 192 * 1024;

template <int MODE>
__global__ void __launch_bounds__(384, 1) rates(float* out, int iters) {
  extern __shared__ uint8_t sm[];
  const uint32_t base = (smem_u32(sm) + 1023) & ~1023u;
  for (int i = threadIdx.x; i < 192 * 1024 / 16; i += 384)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                 :: "r"(base + 16 * i), "r"(0x3f800000u) : "memory");
  __syncthreads();
  if (threadIdx.x < 128) return;  // the producer warpgroup idles
  const int cw = threadIdx.x / 128 - 1;
  // A: two 64-row atoms (64 columns) of a 128-row tile with lo rows after
  // it (as G's K); B: a 32-row tile of two atoms with its lo rows (q)
  const uint32_t a = base + cw * 64 * 128, a_lo = 128 * 128;
  const uint32_t b = base + 2 * 32768, b_lo = 32 * 128;
  uint32_t af[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
  float d16[2][16], d32[2][32], d64[64];
#pragma unroll
  for (int i = 0; i < 16; ++i) d16[0][i] = d16[1][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) d32[0][i] = d32[1][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) d64[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if constexpr (MODE == 0 || MODE == 1 || MODE == 2) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t ao = a + (kk / 4) * 32768 + 32 * (kk % 4);
          const uint32_t bo = b + (kk / 4) * 8192 + 32 * (kk % 4);
          if constexpr (MODE == 0) {
            wgmma_tf32(d16[p], desc(ao + a_lo, 16, 1024), desc(bo, 16, 1024), 1);
            wgmma_tf32(d16[p], desc(ao, 16, 1024), desc(bo + b_lo, 16, 1024), 1);
            wgmma_tf32(d16[p], desc(ao, 16, 1024), desc(bo, 16, 1024), 1);
          } else {
            if constexpr (MODE == 1)
              wgmma_tf32(d32[p], desc(ao, 16, 1024), desc(bo, 16, 1024), 1);
            else
              wgmma_tf32(d32[p], af, desc(bo, 16, 1024));
            wgmma_tf32(*reinterpret_cast<float(*)[16]>(&d32[p]),
                       desc(ao + a_lo, 16, 1024), desc(bo, 16, 1024), 1);
          }
        }
      } else if constexpr (MODE == 3) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 3; ++e)
            wgmma_tf32(d32[p], af, desc(b + 32 * j + (e == 1 ? 8192 : 0), 16, 1024));
      } else if constexpr (MODE == 4) {
#pragma unroll
        for (int j = 0; j < 12; ++j)
          wgmma_tf32(d32[p], desc(a + 32 * (j % 4), 16, 1024),
                     desc(b + 32 * (j % 4), 16, 1024), 1);
      } else {
#pragma unroll
        for (int j = 0; j < 6; ++j)
          wgmma_tf32(d64, af, desc(b + 32 * (j % 4), 16, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d16[0]);
    fence_regs(d16[1]);
    fence_regs(d32[0]);
    fence_regs(d32[1]);
    fence_regs(d64);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += d16[0][i] + d16[1][i];
#pragma unroll
  for (int i = 0; i < 32; ++i) s += d32[0][i] + d32[1][i];
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d64[i];
  out[blockIdx.x * 256 + threadIdx.x - 128] = s;
}

template <int MODE>
int launch(float* out, int blocks, int iters, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      rates<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  rates<MODE><<<blocks, 384, SMEM, st>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sc_tf32_rates(int mode, void* out, int blocks, int iters,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* o = (float*)out;
  switch (mode) {
    case 0: return launch<0>(o, blocks, iters, st);
    case 1: return launch<1>(o, blocks, iters, st);
    case 2: return launch<2>(o, blocks, iters, st);
    case 3: return launch<3>(o, blocks, iters, st);
    case 4: return launch<4>(o, blocks, iters, st);
    case 5: return launch<5>(o, blocks, iters, st);
  }
  return (int)cudaErrorInvalidValue;
}
'''
MODES = ("score_3x", "score_merged", "score_rs_hi", "update_rs", "ss_n64",
         "rs_n128")
MACS = 786_432            # a warpgroup's multiply-adds a loop pass
PEAK_TF32 = 495e12


def build():
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "..", ".."))
    from street_crafter_tpu_torch.ops import cuda_build
    head = (cuda_build.CSRC_DIR / "hopper.cuh").read_bytes()
    digest = hashlib.sha256(SOURCE.encode() + head).hexdigest()[:16]
    lib = cuda_build.BUILD_DIR / f"tf32_wgmma_rates_{digest}.so"
    if not lib.exists():
        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = lib.with_suffix(".cu")
        src.write_text(SOURCE)
        subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                        str(cuda_build.CSRC_DIR), "-o", str(lib), str(src)],
                       check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=4000)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("tf32_wgmma_rates: needs a CUDA device")
    lib = build()
    fn = lib.sc_tf32_rates
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for mode, name in enumerate(MODES):
        for iters in (10, args.iters):   # a warm-up, then the timed launch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(mode, out.data_ptr(), blocks, iters, stream)
            end.record()
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")
            torch.cuda.synchronize()
        s = start.elapsed_time(end) / 1e3
        tflops = 2 * MACS * 2 * blocks * args.iters / s / 1e12
        res[name] = {"tf32_tflops": round(tflops, 1),
                     "share_of_495": round(tflops * 1e12 / PEAK_TF32, 4)}
    print(json.dumps({"blocks": blocks, "iters": args.iters, "modes": res}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
