// K1's row compaction for Hopper (sm_90a): kernel A's variant bench.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// row_compact.py. The entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().
//
// Replaces scripts/bench_phase1_variants.py::kernel (variants base, bf16,
// and the no-upd / no-ind ablations as count_only) and ::rowbatch_kernel,
// the TPU's in-kernel compaction of one 128-px coarse tile's depth-sorted
// candidates [kc, 11] into 8 per-16-px-row lists [kf, 11]. The TPU built
// each kept candidate's slot with a strictly triangular matmul (an
// exclusive prefix of the row mask) and scattered with a one-hot matmul
// into a window of slots. Here it is a stable stream compaction: a ballot
// of the row mask per warp, popcounts for the prefix, and the kept
// candidates staged in shared memory in list order, then written out as one
// contiguous run of slots (coalesced). Bound on this card: bytes (each
// walked candidate read once, each kept one written once).
//
// compact_rows_kernel<V> (base, bf16, count_only): one block of kKB = 128
// threads per (coarse tile, row), a candidate a thread; the block stages
// each block of candidates in shared memory (coalesced), the four warps'
// counts give the block's offsets. compact_rowbatch_kernel<KB>: one block
// of 8 warps per coarse tile, warp r for row r, over blocks of KB
// candidates staged once for all rows. Both walk blocks while the count is
// below kf (rowbatch: while any row's is) and the previous block was all
// alive; counts are not capped inside the last walked block, slots are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kA = 11;              // floats per candidate
constexpr int kDepth = 8, kY0 = 9, kY1 = 10;
constexpr int kRows = 8;            // 16-px rows of a coarse tile
constexpr float kCoarse = 128.0f, kRow = 16.0f;
constexpr int kTilesX = 13;         // coarse tiles per grid row
constexpr float kDead = 1e10f;
constexpr int kKB = 128;            // candidates per walked block (base)
constexpr int kBase = 0, kBf16 = 1, kCountOnly = 2, kRowbatch = 3;

__device__ __forceinline__ float row_value(float x, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <int V>
__global__ void __launch_bounds__(kKB)
compact_rows_kernel(const float* __restrict__ cand, int kc, int kf,
                    float* __restrict__ comp, int32_t* __restrict__ counts) {
  __shared__ float s_blk[kKB * kA];
  __shared__ float s_out[kKB * kA];
  __shared__ int s_wc[kKB / 32];
  const int t = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float ry0 = (float)(t / kTilesX) * kCoarse + (float)r * kRow;
  const float ry1 = ry0 + kRow;
  const float* src = cand + (int64_t)t * kc * kA;
  float* dst = comp + ((int64_t)t * kRows + r) * kf * kA;
  int base = 0;
  bool tail = true;
  for (int b = 0; b < kc / kKB && base < kf && tail; ++b) {
    for (int q = tid; q < kKB * kA; q += kKB)
      s_blk[q] = src[(int64_t)b * kKB * kA + q];
    __syncthreads();
    const float* c = s_blk + tid * kA;
    const bool alive = c[kDepth] < kDead;
    const bool m = c[kY0] < ry1 && c[kY1] > ry0 && alive;
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) s_wc[w] = __popc(bal);
    tail = __syncthreads_and(alive);  // also publishes s_wc
    int off = 0, total = 0;
#pragma unroll
    for (int q = 0; q < kKB / 32; ++q) {
      off += q < w ? s_wc[q] : 0;
      total += s_wc[q];
    }
    if (V != kCountOnly) {
      if (m) {
        const int pre = off + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
        for (int a = 0; a < kA; ++a)
          s_out[pre * kA + a] = row_value(c[a], V == kBf16);
      }
      __syncthreads();
      const int n_out = min(total, kf - base);  // base < kf here
      for (int q = tid; q < n_out * kA; q += kKB)
        dst[(int64_t)base * kA + q] = s_out[q];
    }
    base += total;
    __syncthreads();  // s_blk, s_out and s_wc are free again
  }
  if (tid == 0) counts[t * kRows + r] = base;
}

template <int KB>
__global__ void __launch_bounds__(32 * kRows)
compact_rowbatch_kernel(const float* __restrict__ cand, int kc, int kf,
                        float* __restrict__ comp,
                        int32_t* __restrict__ counts) {
  __shared__ float s_blk[KB * kA];
  __shared__ float s_out[kRows][32 * kA];
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, r = tid >> 5;
  const float ry0 = (float)(t / kTilesX) * kCoarse + (float)r * kRow;
  const float ry1 = ry0 + kRow;
  const float* src = cand + (int64_t)t * kc * kA;
  float* dst = comp + ((int64_t)t * kRows + r) * kf * kA;
  int base = 0;  // this warp's row
  bool tail = true;
  for (int b = 0; b < kc / KB; ++b) {
    if (!__syncthreads_or(base < kf) || !tail) break;
    for (int q = tid; q < KB * kA; q += 32 * kRows)
      s_blk[q] = src[(int64_t)b * KB * kA + q];
    __syncthreads();
    bool all_alive = true;
    for (int chunk = 0; chunk < KB / 32; ++chunk) {
      const float* c = s_blk + (chunk * 32 + lane) * kA;
      const bool alive = c[kDepth] < kDead;
      const bool m = c[kY0] < ry1 && c[kY1] > ry0 && alive;
      all_alive &= __all_sync(0xffffffffu, alive);
      const unsigned bal = __ballot_sync(0xffffffffu, m);
      const int pre = __popc(bal & ((1u << lane) - 1u));
      if (m && base + pre < kf) {
#pragma unroll
        for (int a = 0; a < kA; ++a) s_out[r][pre * kA + a] = c[a];
      }
      __syncwarp();
      const int cnt = __popc(bal);
      const int n_out = max(0, min(cnt, kf - base));
      for (int q = lane; q < n_out * kA; q += 32)
        dst[(int64_t)base * kA + q] = s_out[r][q];
      __syncwarp();
      base += cnt;
    }
    tail = all_alive;  // the same in every warp
    __syncthreads();   // s_blk is free again
  }
  if (lane == 0) counts[t * kRows + r] = base;
}

}  // namespace

extern "C" {

const char* sc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// cand [T, kc, 11] f32; comp [T, 8, kf, 11] f32 (null for count_only);
// counts [T, 8] int32. variant: 0 base, 1 bf16, 2 count_only, 3 rowbatch
// (kb 128 or 256; the others 128). kc a multiple of kb.
int sc_compact_rows(const void* cand, int T, int kc, int kf, int variant,
                    int kb, void* comp, void* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cand;
  float* o = (float*)comp;
  int32_t* n = (int32_t*)counts;
  if (T <= 0) return (int)cudaSuccess;
  if ((variant == kCountOnly) != (comp == nullptr) || kc % kb)
    return (int)cudaErrorInvalidValue;
  const dim3 rows_grid(T, kRows);
  switch (variant) {
    case kBase:
      if (kb != kKB) return (int)cudaErrorInvalidValue;
      compact_rows_kernel<kBase><<<rows_grid, kKB, 0, s>>>(c, kc, kf, o, n);
      break;
    case kBf16:
      if (kb != kKB) return (int)cudaErrorInvalidValue;
      compact_rows_kernel<kBf16><<<rows_grid, kKB, 0, s>>>(c, kc, kf, o, n);
      break;
    case kCountOnly:
      if (kb != kKB) return (int)cudaErrorInvalidValue;
      compact_rows_kernel<kCountOnly><<<rows_grid, kKB, 0, s>>>(c, kc, kf, o,
                                                                n);
      break;
    case kRowbatch:
      if (kb == 128)
        compact_rowbatch_kernel<128><<<T, 32 * kRows, 0, s>>>(c, kc, kf, o, n);
      else if (kb == 256)
        compact_rowbatch_kernel<256><<<T, 32 * kRows, 0, s>>>(c, kc, kf, o, n);
      else
        return (int)cudaErrorInvalidValue;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
