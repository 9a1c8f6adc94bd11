// K1's row compaction for Hopper (sm_90a): kernel A's variant bench.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// row_compact.py. The entry launches on the caller's stream (a memset of
// the workspace, then the kernel), allocates nothing, does not synchronise
// and returns the first error.
//
// Replaces scripts/bench_phase1_variants.py::kernel (variants base, bf16,
// and the no-upd / no-ind ablations as count_only) and ::rowbatch_kernel,
// the TPU's in-kernel compaction of one 128-px coarse tile's depth-sorted
// candidates [kc, 11] into 8 per-16-px-row lists [kf, 11]. The TPU walked
// each tile's candidates in order, a block of kb at a time, and built each
// kept candidate's slot with a strictly triangular matmul (an exclusive
// prefix of the row mask) and a one-hot matmul into a window of slots.
//
// Bound on this card: bytes (each walked candidate read once, each kept one
// written once). A walk is serial on the TPU; here it is a stream
// compaction resolved by a single-pass chained scan:
//
//   - the grid is (chunk, coarse tile), kChunk = 512 candidates a CTA,
//     two a thread. A CTA takes its chunk index from a per-tile atomic
//     ticket (so every chunk it waits on belongs to a CTA already running)
//     and loads its chunk with one 1-D bulk copy (cp.async.bulk into shared
//     memory, completing on an mbarrier): every candidate is read from
//     device memory once, for all 8 rows;
//   - each thread evaluates the 8 rows' masks with the plain version's
//     float compares; a ballot per row and group of 32 candidates gives
//     the counts, a shuffle scan per row the chunk's per-block counts;
//   - decoupled look-back: for each row a warp publishes the chunk's
//     aggregate (its count and whether every candidate of the chunk is
//     alive) as one 32-bit status word, sums its predecessors' words back
//     to the nearest inclusive prefix, and publishes its own inclusive
//     prefix;
//   - from the exact prefix before each of its blocks the CTA applies the
//     walk's stop rule (ops/row_compact.py::_walk): a block is walked while
//     the row is open (rowbatch: any row of the tile) and no earlier block
//     of the tile held a dead candidate. The CTA that holds a row's last
//     walked block writes its count; a chunk past every walk's end only
//     publishes;
//   - each row's kept candidates are ranked in list order into a list of
//     chunk indices in shared memory, then written as one contiguous run of
//     slots (at most up to kf), coalesced, in 16-byte stores where the run
//     is 16-byte aligned, all the rows' runs spread over the CTA's threads.
//     The stores are streaming (evict-first): on the H100 they left the
//     kernel ~10% faster than plain stores, which kept the lists in L2.
//
// Measured alternatives (PERF.md, kernel V): a thread a candidate, and chunks
// of 256 or 1024, were slower at [117, 4096, 11]; so were rows staged in
// shared memory and written by bulk copies (fewer CTAs an SM) and bulk
// loads with an evict-first hint. The variant (stop rule, bf16 rounding,
// scatter or not) and kb are template parameters of one kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kA = 11;              // floats per candidate
constexpr int kDepth = 8, kY0 = 9, kY1 = 10;
constexpr int kRows = 8;            // 16-px rows of a coarse tile
constexpr float kCoarse = 128.0f, kRow = 16.0f;
constexpr int kTilesX = 13;         // coarse tiles per grid row
constexpr float kDead = 1e10f;
constexpr int kBase = 0, kBf16 = 1, kCountOnly = 2, kRowbatch = 3;
constexpr int kChunk = 512;         // candidates a CTA
constexpr int kCpt = 2;             // candidates a thread
constexpr int kThreads = kChunk / kCpt;

// A (tile, chunk, row) status word: bits 31-30 its state (0 not published
// yet, 1 the chunk's aggregate, 2 the inclusive prefix through the chunk),
// bit 29 "every candidate alive" (of the chunk, or of the tile through it),
// bits 0-28 the row's kept count (of the chunk, or through it).
constexpr uint32_t kAgg = 1u << 30, kIncl = 2u << 30;
constexpr uint32_t kAliveBit = 1u << 29, kCountMask = kAliveBit - 1;

__device__ __forceinline__ uint32_t ld_status(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_status(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

template <int V, int KB>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
compact_chunks_kernel(const float* __restrict__ cand, int kc, int kf,
                      float* __restrict__ comp, int32_t* __restrict__ counts,
                      int32_t* __restrict__ tickets,
                      uint32_t* __restrict__ status) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kGroups = kChunk / 32;  // groups of 32 candidates, a ballot
  constexpr int kBlocks = kChunk / KB;
  constexpr int kGpb = KB / 32;        // groups per walked block
  static_assert(kGroups <= 32 && kChunk % KB == 0, "");
  extern __shared__ __align__(128) unsigned char s_dyn[];
  float* s_c = reinterpret_cast<float*>(s_dyn);             // [kChunk, 11]
  // [8, kChunk]: row r's kept candidates (chunk indices) in list order
  uint16_t* s_idx = reinterpret_cast<uint16_t*>(s_c + kChunk * kA);
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ uint32_t s_bal[kRows][kGroups];  // per row, each group's ballot
  __shared__ int s_gpre[kRows][kGroups];      // kept before each group
  __shared__ int s_alive[kGroups];            // the group's all alive
  __shared__ int s_P[kRows][kBlocks + 1];     // row count before each block
  __shared__ uint32_t s_tmask;  // bit b: no dead candidate before block b
  __shared__ uint32_t s_walk[kRows];          // bit b: block b walked
  __shared__ int s_nout[kRows];               // slots written for the row
  __shared__ int s_units[kRows + 1];          // prefix of the write units
  __shared__ int s_chunk;

  const int t = blockIdx.y, nchunks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const uint32_t bar = smem_u32(&s_bar);
  if (tid == 0) {
    const int c = atomicAdd(tickets + t, 1);
    s_chunk = c;
    const int n = min(kChunk, kc - c * kChunk);
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, n * kA * 4);
    bulk_load(smem_u32(s_c),
              cand + ((int64_t)t * kc + (int64_t)c * kChunk) * kA,
              n * kA * 4, bar);
  }
  __syncthreads();
  const int c = s_chunk;
  const int n = min(kChunk, kc - c * kChunk);  // a multiple of KB
  mbar_wait(bar, 0);

  // ---- the 8 rows' masks, one read of the candidate ----------------------
  // candidate k * kThreads + tid: group k * kWarps + w, its lane
  const float ty0 = (float)(t / kTilesX) * kCoarse;
  uint32_t rows = 0;  // bits 8 k + r: candidate k meets row r and is alive
#pragma unroll
  for (int k = 0; k < kCpt; ++k) {
    const int j = k * kThreads + tid;
    bool alive = true;
    uint32_t m = 0;
    if (j < n) {
      const float* p = s_c + j * kA;
      const float y0 = p[kY0], y1 = p[kY1];
      alive = p[kDepth] < kDead;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float ry0 = ty0 + (float)r * kRow;
        m |= (y0 < ry0 + kRow && y1 > ry0 && alive) ? 1u << r : 0u;
      }
    }
    const int g = k * kWarps + w;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t b = __ballot_sync(~0u, (m >> r) & 1u);
      if (lane == 0) s_bal[r][g] = b;
    }
    const bool galive = __all_sync(~0u, alive);
    if (lane == 0) s_alive[g] = galive;
    rows |= m << (8 * k);
  }
  __syncthreads();

  // ---- row r (warp r mod kWarps): its counts, the chained scan ------------
  for (int r = w; r < kRows; r += kWarps) {
    const int x = lane < kGroups ? __popc(s_bal[r][lane]) : 0;
    int incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += y;
    }
    const int agg = __shfl_sync(~0u, incl, 31);
    if (lane < kGroups) s_gpre[r][lane] = incl - x;
    const uint32_t gal = __ballot_sync(~0u, lane >= kGroups || s_alive[lane]);
    const bool chunk_alive = gal == ~0u;
    uint32_t* own = status + ((int64_t)t * nchunks + c) * kRows + r;
    int E = 0;
    bool tail = true;
    if (c == 0) {
      if (lane == 0) st_status(own, kIncl | (chunk_alive ? kAliveBit : 0u) | agg);
    } else {
      if (lane == 0) st_status(own, kAgg | (chunk_alive ? kAliveBit : 0u) | agg);
      // lane i reads chunk hi - i; chunks before 0 count as an inclusive 0
      for (int hi = c - 1;; hi -= 32) {
        const int p = hi - lane;
        uint32_t s = kIncl | kAliveBit;
        if (p >= 0) {
          const uint32_t* q = status + ((int64_t)t * nchunks + p) * kRows + r;
          do {
            s = ld_status(q);
          } while ((s >> 30) == 0);
        }
        const uint32_t inc = __ballot_sync(~0u, (s >> 30) == 2);
        const bool use = inc == 0 || lane <= __ffs(inc) - 1;
        int v = use ? (int)(s & kCountMask) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
        E += v;
        tail = __all_sync(~0u, !use || (s & kAliveBit)) && tail;
        if (inc) break;
      }
      if (lane == 0)
        st_status(own, kIncl | (tail && chunk_alive ? kAliveBit : 0u) |
                           (uint32_t)(E + agg));
    }
    const int gpre = __shfl_sync(~0u, incl - x, (lane % kBlocks) * kGpb);
    if (lane < kBlocks) s_P[r][lane] = E + gpre;
    if (lane == 0) s_P[r][kBlocks] = E + agg;
    if (r == 0 && lane == 0) {
      // bit b (b <= kBlocks): every block before b, and the tile's before
      // the chunk, all alive
      uint32_t m = tail ? 1u : 0u;
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        const uint32_t blk = (gal >> (b * kGpb)) & ((1u << kGpb) - 1u);
        if (blk == (1u << kGpb) - 1u) m |= (m >> b & 1u) << (b + 1);
      }
      s_tmask = m;
    }
  }
  __syncthreads();

  // ---- the walk: blocks walked, counts, slots written --------------------
  if (tid < 32) {
    const int r = tid;
    int units = 0;
    if (r < kRows) {
      const int nbl = n / KB;
      uint32_t walk = 0;
      bool next = false;  // the walk goes on into the next chunk
      for (int b = 0; b <= nbl; ++b) {
        bool open = s_P[r][b] < kf;
        if (V == kRowbatch) {
#pragma unroll
          for (int q = 0; q < kRows; ++q) open = open || s_P[q][b] < kf;
        }
        const bool walked = open && ((s_tmask >> b) & 1u);
        if (b < nbl)
          walk |= walked ? 1u << b : 0u;
        else
          next = walked && (c + 1) * kChunk < kc;
      }
      const int k = __popc(walk);  // a prefix of the chunk's blocks
      const int E = s_P[r][0];
      if (k > 0 && !(k == nbl && next)) counts[t * kRows + r] = s_P[r][k];
      s_walk[r] = walk;
      const int nout = max(0, min(s_P[r][k] - E, kf - E));
      s_nout[r] = nout;
      if (V != kCountOnly && nout > 0) {
        // h head floats up to a 16-byte boundary, nv float4s, the tail
        const float* dst = comp + (((int64_t)t * kRows + r) * kf + E) * kA;
        const int nf = nout * kA;
        const int h = min(nf, (int)((16u - ((uintptr_t)dst & 15u)) & 15u) >> 2);
        units = nf - 3 * ((nf - h) >> 2);
      }
    }
    int pre = units;
#pragma unroll
    for (int o = 1; o < kRows; o <<= 1) {
      const int y = __shfl_up_sync(~0u, pre, o);
      if (lane >= o) pre += y;
    }
    if (r < kRows) s_units[r + 1] = pre;
    if (r == 0) s_units[0] = 0;
  }
  if (V == kCountOnly) return;
  __syncthreads();
  const int total = s_units[kRows];
  if (total == 0) return;  // past every row's walk, or nothing to write

  // ---- rank each kept candidate in its row's list ------------------------
  const uint32_t lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kCpt; ++k) {
    const int j = k * kThreads + tid, g = k * kWarps + w, b = j / KB;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (((rows >> (8 * k + r)) & 1u) && ((s_walk[r] >> b) & 1u)) {
        const int rank = s_gpre[r][g] + __popc(s_bal[r][g] & lt);
        if (rank < s_nout[r]) s_idx[r * kChunk + rank] = (uint16_t)j;
      }
    }
  }
  __syncthreads();

  // ---- each row's run of slots, coalesced --------------------------------
  // the rows' write units in one range over the CTA's threads: a row's h
  // head floats up to a 16-byte boundary, its nv float4s, its tail floats
  for (int q = tid; q < total; q += kThreads) {
    int r = 0;
    while (q >= s_units[r + 1]) ++r;
    const int u = q - s_units[r];
    float* dst = comp + (((int64_t)t * kRows + r) * kf + s_P[r][0]) * kA;
    const int nf = s_nout[r] * kA;
    const int h = min(nf, (int)((16u - ((uintptr_t)dst & 15u)) & 15u) >> 2);
    const int nv = (nf - h) >> 2;
    const uint16_t* idx = s_idx + r * kChunk;
    auto val = [&](int f) {
      const float x = s_c[idx[f / kA] * kA + f % kA];
      return V == kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
    };
    if (u < h || u >= h + nv) {
      const int f = u < h ? u : u + 3 * nv;
      __stcs(dst + f, val(f));
    } else {
      const int f = h + 4 * (u - h);
      __stcs(reinterpret_cast<float4*>(dst + f),
             make_float4(val(f), val(f + 1), val(f + 2), val(f + 3)));
    }
  }
}

// Dynamic shared memory of an instantiation: the chunk, and the rows' lists
// of kept candidates where the variant writes them.
template <int V>
constexpr int smem_bytes() {
  return kChunk * kA * 4 + (V == kCountOnly ? 0 : kRows * kChunk * 2);
}

template <int V, int KB>
cudaError_t launch(const float* cand, int T, int kc, int kf, float* comp,
                   int32_t* counts, int32_t* tickets, uint32_t* status,
                   cudaStream_t s) {
  auto kern = compact_chunks_kernel<V, KB>;
  constexpr int smem = smem_bytes<V>();
  // once a device: as many CTAs an SM as shared memory allows (and the
  // dynamic shared memory past 48 KB)
  static uint64_t set_on = 0;  // bit d: set on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= 64 || !((set_on >> dev) & 1u))) {
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && smem > 48 * 1024)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && dev < 64) set_on |= 1ull << dev;
  }
  if (e != cudaSuccess) return e;
  const dim3 grid((kc + kChunk - 1) / kChunk, T);
  kern<<<grid, kThreads, smem, s>>>(cand, kc, kf, comp, counts, tickets,
                                    status);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// int32 words of the workspace a launch takes: a ticket per tile, then a
// status word per (tile, chunk, row).
long long sc_compact_rows_workspace(int T, int kc) {
  return (long long)T * (1 + kRows * ((kc + kChunk - 1) / kChunk));
}

// cand [T, kc, 11] f32 (16-byte aligned); comp [T, 8, kf, 11] f32 (null
// for count_only); counts [T, 8] int32; work: sc_compact_rows_workspace
// int32 words, zeroed here. variant: 0 base, 1 bf16, 2 count_only,
// 3 rowbatch (kb 128 or 256; the others 128). kc a multiple of kb, below
// 2^29.
int sc_compact_rows(const void* cand, int T, int kc, int kf, int variant,
                    int kb, void* comp, void* counts, void* work,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cand;
  float* o = (float*)comp;
  int32_t* n = (int32_t*)counts;
  if ((variant == kCountOnly) != (comp == nullptr) || kc < 0 || kc % kb ||
      kc >= (1 << 29) || kf <= 0)
    return (int)cudaErrorInvalidValue;
  if (variant != kRowbatch && kb != 128) return (int)cudaErrorInvalidValue;
  if (T <= 0) return (int)cudaSuccess;
  if (kc == 0)  // nothing to walk: every count 0
    return (int)cudaMemsetAsync(n, 0, (size_t)T * kRows * 4, s);
  int32_t* tickets = (int32_t*)work;
  uint32_t* status = (uint32_t*)(tickets + T);
  cudaError_t e = cudaMemsetAsync(
      work, 0, (size_t)sc_compact_rows_workspace(T, kc) * 4, s);
  if (e != cudaSuccess) return (int)e;
  switch (variant) {
    case kBase:
      e = launch<kBase, 128>(c, T, kc, kf, o, n, tickets, status, s);
      break;
    case kBf16:
      e = launch<kBf16, 128>(c, T, kc, kf, o, n, tickets, status, s);
      break;
    case kCountOnly:
      e = launch<kCountOnly, 128>(c, T, kc, kf, o, n, tickets, status, s);
      break;
    case kRowbatch:
      if (kb == 128)
        e = launch<kRowbatch, 128>(c, T, kc, kf, o, n, tickets, status, s);
      else if (kb == 256)
        e = launch<kRowbatch, 256>(c, T, kc, kf, o, n, tickets, status, s);
      else
        e = cudaErrorInvalidValue;
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return (int)e;
}

}  // extern "C"
