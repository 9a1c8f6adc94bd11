// Gaussian raster for Hopper (sm_90a): tile worklist, compositing and its
// backward.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// gs_raster.py. Every entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// Kernel A, the tile worklist: worklist_count_kernel, tile_scan_kernel,
// tile_order_kernel, worklist_emit_kernel and tile_sort_kernel. Replaces
// street_crafter_tpu/ops/gs_raster_fused.py::_compact_kernel (K1), which
// compacted each 128-px coarse tile's depth-selected candidates into
// per-16-px-row lists under fixed VMEM capacities. Here every splat is
// listed in EVERY 16x16 tile its 3-sigma box overlaps, so no tile drops a
// splat and wide splats keep their interior tiles; each list is in (depth,
// splat id) order, and the tiles come with the order kernels B and C take
// them in (list length descending, tile ascending). Bound on this card:
// bytes (17 read per splat, a tile id and a splat id written per pair, the
// ranges and the order per tile); between them lies a sort of 64-bit keys,
// which the first port left to torch.sort (CUB's radix sort over every
// pair, 0.23 of its 0.40 ms). Design, gsplat's binning turned around so
// that one long sort of every pair becomes a short sort per tile:
//   - count: persistent blocks of 512 take the splats a block-width at a
//     time and spread each step's (splat, tile) pairs evenly over their
//     threads (block_pairs: a few splats near the camera cover thousands of
//     tiles each); each block counts per tile in shared memory and adds its
//     nonzero counts to the bins once;
//   - scan: one block turns the bins into each tile's range, its key for
//     the tile order, the pair total and the longest list, and zeroes the
//     bins for the emit. The host reads the total (the one synchronisation:
//     it sizes the lists) while the order kernel runs;
//   - tile order: one block, a stable radix sort of the lengths (8 bits a
//     pass, as many passes as the longest list needs);
//   - emit: the count's walk again, twice: each block counts its pairs per
//     tile, takes each tile's run of bucket slots with one atomic, then
//     writes each pair's (depth bits << 32 | splat id) key at a slot handed
//     out in shared memory;
//   - sort: persistent blocks take tiles longest list first. A list of up
//     to 512 keys goes to one warp, a longer one to a group of warps (named
//     barriers), all 16 past 8,192 keys. Each thread holds 16 keys and
//     sorts them in registers (a bitonic network), then runs are merged
//     pairwise through shared memory along merge paths (group_sort_regs);
//     a list longer than a block holds is sorted in passes over its segment
//     in device memory (group_sort). Keys are unique, so the result does
//     not depend on the atomics' order: it is the stable (tile, depth) sort
//     of the pairs in splat order, bit for bit. The sort also zeroes each
//     tile's bucket counter, and the emit the tile counter, so the part
//     after the synchronisation can be replayed (a CUDA graph).
//
// Channels: up to kMaxChannels (32), through kernel instances of widths 1-7,
// 9, 13, ..., 29 and 32 (instance_width; the channels an instance carries
// past the caller's are zero and are neither written nor differentiated).
//
// Kernel B, compositing: composite_kernel<C, kTrain>. Replaces
// street_crafter_tpu/ops/gs_raster_fused.py::_composite_kernel (K2), which
// composited 16x128 pixel strips with MXU matmuls, a Cholesky-factored
// sigma and a row-granular early exit. Kernel C, compositing backward:
// composite_bwd_kernel<C>. Replaces street_crafter_tpu/ops/
// gs_raster_train.py:60 _composite_bwd_kernel (K3), which recomputed alpha
// and log-T per 16x128 row in two passes on the packed Cholesky layout.
//
// Bound on this card, both: operations. Per (pixel, splat) pair in the
// pixels' prefixes the recompute of sigma and alpha (an exp); per
// contributing pair the T update and a multiply-add per channel (B), or the
// adjoint's ~40 + 4 C operations and the per-splat sums (C). The bytes (a
// splat's attributes per pair, the image) are small beside them. What held
// the first versions back was not the bound: 79% of the evaluated pairs
// were skipped (alpha < 1/255), a block barrier per batch of 256 splats
// with nothing of the next batch in flight, a long last wave of uneven
// tiles, and in C 60 shuffles and 12 global atomics per warp and splat.
// Tensor cores do not help: the work per pair is an exp and a sequential
// product of T along the list, the channel sum 4 FMAs per contributing
// pair, and rounding through TF32 or bf16 would break the exact equality of
// `last` with the plain version and B's 2e-4 limit.
//
// Design, shared by B and C:
//   - pair records: the pack (splat_records_kernel, pair_records_kernel)
//     gathers each (tile, splat) pair's splat into one record, in list
//     order, so a tile's list is one contiguous run of records: u, v,
//     conic a, b, c, opacity, the cull threshold t and the C channels,
//     padded to a multiple of 16 bytes (7 + C floats: 32 B at C = 1, 48 B
//     at C = 2-5, 64 B at C = 6-9, ..., 160 B at C = 30-32). The wrappers
//     launch it before B and C (C packs anew);
//   - a bulk-copy ring: one producer warp copies batches of records with
//     1-D bulk copies (cp.async.bulk, mbarrier completion) into a ring of
//     full / empty stages; the eight consumer warps, two pixel rows of the
//     tile each, take the stages in order. No block barrier per batch. C
//     walks each list back to front the same way. Batch and depth, as
//     measured at the headline frame: B 256 records x 3 stages (128 for
//     records past 64 B, so that the ring of the widest still leaves three
//     blocks an SM), C 128 x 2 (C's per-pair registers leave fewer blocks
//     per SM; a shorter batch keeps its ring turning);
//   - a per-warp cull: when a batch lands, each lane tests its records (8
//     of 256) against its warp's 16x2 pixel rectangle (warp_culls) and the
//     warp ballots a mask; the walk visits only the set bits. A culled
//     pair is one that every pixel of the warp skips (alpha < 1/255), and
//     each lane still applies every skip and stop rule in list order, so
//     B's outputs and C's per-pixel terms are the same as without it;
//   - longest list first: a persistent grid (as many blocks as fit on the
//     card) takes tiles through an atomic counter, in the order the wrapper
//     gives: tiles by list length, descending.
// B: a consumer warp whose pixels have all stopped skips the rest of the
// tile; the producer stops loading a tile once all eight have (a count of
// done warps in shared memory). Tiles with empty lists come last in the
// order: the first one drawn ends the ring, and the consumer warps write
// them (fill_empty_tile) without stages. The training variant (kTrain) also
// writes each pixel's final T and the index, in its tile's list, one past
// the last splat that contributed: kernel C's starting point.
// C: gsplat's rasterize_to_pixels_bwd walk. Each pixel starts at its own
// last contributor with the forward's final T and walks back, rebuilding
// T_j = T_{j+1} / (1 - alpha_j): a division, not a forward re-walk, since
// alpha <= 0.999 bounds the factor by 1000 and T >= 1e-4 on every
// contributor, so no T underflows (each step adds two roundings: a
// correctly rounded reciprocal, then a product). With
// S_j the suffix sum of w c.g_c behind splat j, per pair:
//   dalpha = T_j (c_j.g_c) - (S_j - g_a T_N) / (1 - alpha_j),
//   dsigma = -alpha dalpha, dopacity = dalpha exp(-sigma) (0 where alpha is
//   clamped at 0.999), du = -dsigma (a dx + b dy), dv = -dsigma (c dy + b dx),
//   da = dx^2 dsigma / 2, db = dx dy dsigma, dc = dy^2 dsigma / 2,
//   dcolor = w g_c, and the absgrad columns |du|, |dv| (gsplat absgrad=True).
// A warp walks only up to its own largest last index. Per splat that one of
// its pixels touched, one transposed warp reduction per 16 of the 8 + C
// fields (warp_sum16: 16 shuffles, in place of 5 per field; warp_sum12, 13,
// at C = 4) leaves each field's sum in one lane, and those lanes add them
// to the splat's [N, 8 + C] row in device memory: one red.global.add.f32
// instruction per warp and splat, in place of lane 0's 8 + C in a row.
// The producer warp stages each batch's splat ids beside it. (Gradient
// rows per batch in shared memory, flushed once per batch by the producer
// warp, measured no faster than these direct adds: not kept.)
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;       // one consumer thread per pixel
constexpr int kConsumers = kBlock / 32;     // warps, two pixel rows each
constexpr int kRasterThreads = kBlock + 32;  // + the producer warp
// records per bulk copy and ring depth, of kernels B and C
constexpr int kBatchB = 256, kStagesB = 3;
constexpr int kBatchC = 128, kStagesC = 2;
constexpr int kThreads1D = 256;
constexpr float kAlphaClamp = 0.999f;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTStop = 1e-4f;

// Tiles [tx0, tx1) x [ty0, ty1) overlapped by the splat's box
// [u - r, u + r] x [v - r, v + r]. Tile tx overlaps iff
// x0 < (tx + 1) * 16 && x1 > tx * 16, i.e. floor(x0 / 16) <= tx < ceil(x1 / 16)
// (exact in f32: the scale is a power of two). Clamped to the grid.
__device__ __forceinline__ bool tile_range(float u, float v, float r,
                                           bool valid, int tw, int th,
                                           int& tx0, int& tx1, int& ty0,
                                           int& ty1) {
  if (!valid || !(r > 0.0f)) return false;
  const float s = 1.0f / kTile;
  tx0 = (int)fminf(fmaxf(floorf((u - r) * s), 0.0f), (float)tw);
  tx1 = (int)fminf(fmaxf(ceilf((u + r) * s), 0.0f), (float)tw);
  ty0 = (int)fminf(fmaxf(floorf((v - r) * s), 0.0f), (float)th);
  ty1 = (int)fminf(fmaxf(ceilf((v + r) * s), 0.0f), (float)th);
  return tx1 > tx0 && ty1 > ty0;
}

// ------------------------------------------------------------ kernel A

constexpr int kBinThreads = 512;     // count and emit blocks
constexpr int kScanThreads = 1024;   // tile_scan_kernel (one block)
constexpr int kScanStage = 49152;    // bins the scan stages in shared memory
constexpr int kPrivTiles = 8192;     // bins a block keeps in shared memory
constexpr int kSortKeys = 16;        // keys a thread holds in sorts
constexpr int kSortThreads = 512;    // tile sort and order blocks
constexpr int kSortCap = kSortThreads * kSortKeys;  // keys a block sorts
constexpr int kWarpCap = 32 * kSortKeys;  // lists one warp sorts alone
constexpr uint64_t kNoKey = ~0ull;   // above every key (ids are < 2^31)

__host__ __device__ inline int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Exclusive prefix sum of x over the block's threads in thread order, and
// the block's total. blockDim.x a multiple of 32.
__device__ long long block_exclusive_sum(long long x, long long* total) {
  __shared__ long long s_warp[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) s_warp[w] = inc;
  __syncthreads();
  if (w == 0) {
    long long wv = lane < nw ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, wv, o);
      if (lane >= o) wv += y;
    }
    s_warp[lane] = wv;  // inclusive over the warps
  }
  __syncthreads();
  const long long before = w ? s_warp[w - 1] : 0;
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp is reused by the next call
  return before + inc - x;
}

__device__ int block_max(int x) {
  __shared__ int s_max[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  x = __reduce_max_sync(0xffffffffu, x);
  if (lane == 0) s_max[w] = x;
  __syncthreads();
  int m = 0;
  for (int q = 0; q < (int)(blockDim.x >> 5); ++q) m = max(m, s_max[q]);
  __syncthreads();
  return m;
}

// Bins -> per tile its range [start, end) ([0, 0) when empty, as the plain
// version has it) and its order key (~length << 32 | tile: ascending is
// length descending, tile ascending); info = (pairs, longest list). The
// bins are read through L2 (other blocks' atomics) and left at zero; with
// `stage` (room for n_tiles ints) they are read once, coalesced, into
// shared memory, each thread scans its run of tiles there and leaves each
// tile's start in place of its count, and the outputs are written
// coalesced (a tile's count: the next start less its own). One SM writing
// a thread's run of tiles at a time (a 56-byte stride across a warp) took
// ~17 us at 6,700 tiles whatever the counts.
__device__ void scan_tiles(int32_t* bins, int n_tiles, int* stage,
                           int32_t* ranges, uint64_t* order_keys,
                           int64_t* info) {
  if (stage != nullptr) {
    // four loads in flight a thread, then their stores
    for (int t0 = threadIdx.x; t0 < n_tiles; t0 += 4 * blockDim.x) {
      int c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + q * blockDim.x;
        c[q] = t < n_tiles ? __ldcg(bins + t) : 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = t0 + q * blockDim.x;
        if (t < n_tiles) {
          stage[t] = c[q];
          bins[t] = 0;
        }
      }
    }
    __syncthreads();
  }
  const int per = (n_tiles + blockDim.x - 1) / blockDim.x;
  const int b0 = min((int)threadIdx.x * per, n_tiles);
  const int b1 = min(b0 + per, n_tiles);
  long long sum = 0;
  int longest = 0;
  for (int t = b0; t < b1; ++t) {
    const int c = stage ? stage[t] : __ldcg(bins + t);
    sum += c;
    longest = max(longest, c);
  }
  long long total;
  long long start = block_exclusive_sum(sum, &total);
  longest = block_max(longest);
  if (threadIdx.x == 0) {
    info[0] = total;
    info[1] = longest;
  }
  if (stage != nullptr) {
    // starts wrap as the int32 ranges do (the host refuses 2^31 pairs)
    for (int t = b0; t < b1; ++t) {
      const int c = stage[t];
      stage[t] = (int)start;
      start += c;
    }
    __syncthreads();
    int2* pairs = reinterpret_cast<int2*>(ranges);  // 8-byte aligned rows
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
      const int s0 = stage[t];
      const int c = (t + 1 < n_tiles ? stage[t + 1] : (int)total) - s0;
      pairs[t] = c ? make_int2(s0, s0 + c) : make_int2(0, 0);
      order_keys[t] = ((uint64_t)(~(uint32_t)c) << 32) | (uint32_t)t;
    }
    return;
  }
  for (int t = b0; t < b1; ++t) {
    const int c = __ldcg(bins + t);
    bins[t] = 0;
    ranges[2 * t] = c ? (int32_t)start : 0;
    ranges[2 * t + 1] = c ? (int32_t)(start + c) : 0;
    order_keys[t] = ((uint64_t)(~(uint32_t)c) << 32) | (uint32_t)t;
    start += c;
  }
}

// A splat's tile rectangle as block_pairs takes it.
__device__ __forceinline__ int splat_tiles(int i, int n,
                                           const float* __restrict__ u,
                                           const float* __restrict__ v,
                                           const float* __restrict__ radii,
                                           const uint8_t* __restrict__ valid,
                                           int tw, int th, int& tx0, int& nx,
                                           int& ty0) {
  int tx1 = 0, ty1 = 0;
  tx0 = ty0 = 0;
  nx = 1;
  if (i >= n || !tile_range(u[i], v[i], radii[i], valid[i] != 0, tw, th, tx0,
                            tx1, ty0, ty1))
    return 0;
  nx = tx1 - tx0;
  return nx * (ty1 - ty0);
}

// The (splat, tile) pairs of this block's share of the splats, with every
// thread of the block busy whatever the splats' sizes: a persistent grid
// takes the splats a block-width at a time; per step the block scans its
// splats' tile counts, and each thread takes an equal run of the step's
// pairs: it finds the splat of its first pair (the last whose exclusive
// offset is <= it, a binary search in shared memory) and walks on through
// that splat's tiles, row-major in its rectangle, and the next splats'.
// f(tile, key) runs once per pair, the key (depth bits << 32 | splat id)
// only when `depths` is given. Every thread of the block must call it.
// `step`: the kernel's shared memory for it.
struct PairStep {
  int off[kBinThreads];
  struct {
    int tx0, nx, ty0;
    uint64_t key;
  } splat[kBinThreads];
};

template <typename F>
__device__ __forceinline__ void block_pairs(
    PairStep& step, int n, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ radii,
    const uint8_t* __restrict__ valid, const float* __restrict__ depths,
    int tw, int th, F&& f) {
  int* s_off = step.off;
  for (int b = blockIdx.x * blockDim.x; b < n; b += gridDim.x * blockDim.x) {
    const int i = b + threadIdx.x;
    int tx0, nx, ty0;
    const int cnt = splat_tiles(i, n, u, v, radii, valid, tw, th, tx0, nx,
                                ty0);
    long long total;
    const int off = (int)block_exclusive_sum(cnt, &total);
    s_off[threadIdx.x] = off;
    // the raw f32 bits, as unsigned, order the depths as the plain
    // version's keys do (depth > near plane > 0: like the values)
    step.splat[threadIdx.x] = {
        tx0, nx, ty0,
        cnt && depths != nullptr
            ? ((uint64_t)__float_as_uint(depths[i]) << 32) | (uint32_t)i
            : 0};
    __syncthreads();
    const int per = ((int)total + blockDim.x - 1) / blockDim.x;
    int q = threadIdx.x * per;
    const int q_end = min(q + per, (int)total);
    if (q < q_end) {
      int j = 0, hi = blockDim.x - 1;
      while (j < hi) {
        const int mid = (j + hi + 1) >> 1;
        if (s_off[mid] <= q)
          j = mid;
        else
          hi = mid - 1;
      }
      // splat j has pairs (the last with offset <= q); its end
      const int last = blockDim.x - 1;
      int end = j < last ? s_off[j + 1] : (int)total;
      auto sp = step.splat[j];
      const int k = q - s_off[j];
      int ty = k / sp.nx, tx = k - ty * sp.nx;
      for (; q < q_end; ++q) {
        if (q == end) {  // the next splat with pairs
          do {
            ++j;
          } while (j < last && s_off[j + 1] <= q);
          end = j < last ? s_off[j + 1] : (int)total;
          sp = step.splat[j];
          tx = ty = 0;
        }
        f((sp.ty0 + ty) * tw + sp.tx0 + tx, sp.key);
        if (++tx == sp.nx) {
          tx = 0;
          ++ty;
        }
      }
    }
    __syncthreads();  // `step` is free for the next step
  }
}

// bins [n_tiles] zeroed by the caller. priv: the block counts in shared
// memory (n_tiles <= kPrivTiles) and adds its nonzero bins once, so that a
// tile many splats overlap sees one atomic per block, not one per pair;
// else atomics straight to the bins.
__global__ void __launch_bounds__(kBinThreads)
worklist_count_kernel(const float* __restrict__ u, const float* __restrict__ v,
                      const float* __restrict__ radii,
                      const uint8_t* __restrict__ valid, int n, int tw, int th,
                      bool priv, int32_t* __restrict__ bins) {
  __shared__ int s_bins[kPrivTiles];
  __shared__ PairStep step;
  const int n_tiles = tw * th;
  if (priv) {
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) s_bins[t] = 0;
    __syncthreads();
  }
  block_pairs(step, n, u, v, radii, valid, nullptr, tw, th,
              [&](int t, uint64_t) {
                if (priv)
                  atomicAdd(s_bins + t, 1);
                else
                  atomicAdd(bins + t, 1);
              });
  if (priv) {
    __syncthreads();
    for (int t = threadIdx.x; t < n_tiles; t += blockDim.x)
      if (s_bins[t]) atomicAdd(bins + t, s_bins[t]);
  }
}

// One block: the bins scanned (scan_tiles), staged in dynamic shared memory
// when `stage` (room for n_tiles ints).
__global__ void __launch_bounds__(kScanThreads)
tile_scan_kernel(int32_t* __restrict__ bins, int n_tiles, bool stage,
                 int32_t* __restrict__ ranges,
                 uint64_t* __restrict__ order_keys, int64_t* __restrict__ info) {
  extern __shared__ int s_stage[];
  scan_tiles(bins, n_tiles, stage ? s_stage : nullptr, ranges, order_keys,
             info);
}

// fill: [n_tiles] bucket counters at zero (scan_tiles leaves them so).
// Each key goes to its tile's bucket at a slot taken with an atomic. priv:
// the block counts its pairs per tile in shared memory, takes each tile's
// run of slots with one atomic, then hands the slots out in shared memory.
__global__ void __launch_bounds__(kBinThreads)
worklist_emit_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ radii,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ depths, int n, int tw, int th,
                     bool priv, const int32_t* __restrict__ ranges,
                     int32_t* __restrict__ fill, int32_t* __restrict__ next_tile,
                     uint64_t* __restrict__ keys) {
  __shared__ int s_slot[kPrivTiles];
  __shared__ PairStep step;
  const int n_tiles = tw * th;
  if (blockIdx.x == 0 && threadIdx.x == 0) *next_tile = 0;  // the sort's
  if (!priv) {
    block_pairs(step, n, u, v, radii, valid, depths, tw, th,
                [&](int t, uint64_t k) {
                  keys[ranges[2 * t] + atomicAdd(fill + t, 1)] = k;
                });
    return;
  }
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) s_slot[t] = 0;
  __syncthreads();
  block_pairs(step, n, u, v, radii, valid, nullptr, tw, th,
              [&](int t, uint64_t) { atomicAdd(s_slot + t, 1); });
  __syncthreads();
  // each tile's run of slots: four atomics in flight a thread
  for (int t0 = threadIdx.x; t0 < n_tiles; t0 += 4 * blockDim.x) {
    int c[4], first[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = t0 + q * blockDim.x;
      c[q] = t < n_tiles ? s_slot[t] : 0;
      first[q] = c[q] ? ranges[2 * t] + atomicAdd(fill + t, c[q]) : 0;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c[q]) s_slot[t0 + q * blockDim.x] = first[q];
  }
  __syncthreads();
  block_pairs(step, n, u, v, radii, valid, depths, tw, th,
              [&](int t, uint64_t k) { keys[atomicAdd(s_slot + t, 1)] = k; });
}

// ---- sorts of 64-bit keys (kernel A's per-tile sort). A group of T
// threads (one warp, or G warps of a block with a named barrier) sorts up
// to 16 T keys, blocked: thread t holds keys 16 t .. 16 t + 15 in x, +inf
// past the list. Each thread sorts its 16 in registers (the bitonic network
// in its flip form: key e against its mirror e ^ (k - 1) in each block of
// k, then e ^ j for j = k / 4 .. 1, the smaller key to the lower index;
// compile-time indices), then runs of 16, 32, ... are merged pairwise
// through shared memory: each thread finds where its 16 outputs start on
// its merge path (a binary search) and merges them serially (CUB's block
// merge sort). Real keys are unique; ties (the padding) take the left run
// first.

constexpr int kKeys = kSortKeys;

// shared-memory slot of key e: one slot of skew per 16 keys, so that the
// threads' rows of 16 fall on different banks
__device__ __forceinline__ int padded(int e) { return e + e / kKeys; }
constexpr int kPadded = 32 * (kKeys + 1);  // slots a warp's keys take

__device__ __forceinline__ void cas(uint64_t& a, uint64_t& b) {
  const uint64_t lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

template <int M>  // partner r ^ M inside the thread
__device__ __forceinline__ void thread_stage(uint64_t (&x)[kKeys]) {
#pragma unroll
  for (int r = 0; r < kKeys; ++r)
    if ((r ^ M) > r) cas(x[r], x[r ^ M]);
}

__device__ __forceinline__ void thread_sort(uint64_t (&x)[kKeys]) {
  static_assert(kKeys == 8 || kKeys == 16, "the network sorts 8 or 16 keys");
  thread_stage<1>(x);  // k = 2
  thread_stage<3>(x);  // k = 4
  thread_stage<1>(x);
  thread_stage<7>(x);  // k = 8
  thread_stage<2>(x);
  thread_stage<1>(x);
  if constexpr (kKeys == 16) {
    thread_stage<15>(x);  // k = 16
    thread_stage<4>(x);
    thread_stage<2>(x);
    thread_stage<1>(x);
  }
}

// The barrier of a group of `threads` threads: a warp's, or named barrier
// 1 + id.
__device__ __forceinline__ void group_sync(int id, int threads) {
  if (threads == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(id + 1), "r"(threads) : "memory");
}

// Sorts the group's keys in x (t: the thread's index in the group of T,
// bar: its barrier, s: its 17 T / 16 slots of shared memory); P, a power
// of two, bounds the real keys. Threads past P only keep the barriers.
__device__ void group_sort_regs(uint64_t (&x)[kKeys], uint64_t* s, int t,
                                int T, int bar, int P) {
  thread_sort(x);
  const int e0 = t * kKeys;
  for (int R = kKeys; R < P; R <<= 1) {
#pragma unroll
    for (int r = 0; r < kKeys; ++r) s[padded(e0 + r)] = x[r];
    group_sync(bar, T);
    if (e0 < P) {
      const int a0 = e0 & ~(2 * R - 1);  // the left run, then the right
      const int b0 = a0 + R;
      const int d = e0 - a0;             // outputs of the pair before mine
      int lo = max(0, d - R), hi = min(d, R);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s[padded(a0 + mid)] <= s[padded(b0 + d - 1 - mid)])
          lo = mid + 1;
        else
          hi = mid;
      }
      int i = lo, j = d - lo;
      uint64_t a = i < R ? s[padded(a0 + i)] : 0;
      uint64_t b = j < R ? s[padded(b0 + j)] : 0;
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const bool take_a = j >= R || (i < R && a <= b);
        x[r] = take_a ? a : b;
        if (take_a) {
          ++i;
          a = i < R ? s[padded(a0 + i)] : 0;
        } else {
          ++j;
          b = j < R ? s[padded(b0 + j)] : 0;
        }
      }
    }
    group_sync(bar, T);
  }
}

__device__ __forceinline__ void load_keys(uint64_t (&x)[kKeys],
                                          const uint64_t* g, int n, int t) {
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const int e = t * kKeys + r;
    x[r] = e < n ? g[e] : kNoKey;
  }
}

__device__ __forceinline__ void store_keys(const uint64_t (&x)[kKeys],
                                           uint64_t* g, int n, int t) {
#pragma unroll
  for (int r = 0; r < kKeys; ++r) {
    const int e = t * kKeys + r;
    if (e < n) g[e] = x[r];
  }
}

// One stage of the flip-form bitonic network over n keys of g in device
// memory (merge k's strides of kSortCap and more, for a list longer than a
// block holds), every pair with its upper key past n skipped (+inf).
__device__ __forceinline__ void global_stage(uint64_t* g, int n, int P,
                                             bool flip, int m) {
  for (int i = threadIdx.x; i < (P >> 1); i += blockDim.x) {
    const int o = i & (m - 1);
    const int base = (i - o) << 1;
    const int lo = base + o;
    const int hi = flip ? base + 2 * m - 1 - o : lo + m;
    if (hi < n) {
      const uint64_t a = g[lo], b = g[hi];
      if (a > b) {
        g[lo] = b;
        g[hi] = a;
      }
    }
  }
}

// Sorts n keys of g ascending with a group (as group_sort_regs). n <= 16 T:
// in registers, left in x; returns true. Longer (only the whole block, T =
// kSortThreads): in place in g, in passes: each chunk of kSortCap keys
// sorted as above, then for each larger merge k of the flip-form bitonic
// network its strides of kSortCap and more over g, after which each chunk
// holds its final keys and is sorted again in registers; returns false.
__device__ bool group_sort(uint64_t* g, int n, uint64_t* s,
                           uint64_t (&x)[kKeys], int t, int T, int bar) {
  if (n <= T * kKeys) {
    load_keys(x, g, n, t);
    group_sort_regs(x, s, t, T, bar, pow2ceil(n));
    return true;
  }
  constexpr int C = kSortCap;
  const int P = pow2ceil(n);
  for (int k = C; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= C; j >>= 1) {
      global_stage(g, n, P, j == (k >> 1), j);
      group_sync(bar, T);
    }
    for (int c0 = 0; c0 < n; c0 += C) {
      load_keys(x, g + c0, n - c0, t);
      group_sort_regs(x, s, t, T, bar, pow2ceil(min(C, n - c0)));
      store_keys(x, g + c0, n - c0, t);
    }
    group_sync(bar, T);
  }
  return false;
}

// The tile order: a stable LSD radix sort of scan_tiles's keys by the low
// bits of ~length (8 a pass, as many as the longest list needs: the bits
// above are all ones), so that ties keep tile order; one block, keys
// ping-ponged between `keys` and `order`, then order[i] = the tile. Per
// pass each warp takes one run of the keys in order, counts its digits
// (a match per 32 keys, the first lane of each digit adds), the counts are
// scanned digit-major then warp-major, and the warp scatters in the same
// order.
constexpr int kOrderWarps = kSortThreads / 32;

__global__ void __launch_bounds__(kSortThreads)
tile_order_kernel(uint64_t* keys, int n_tiles, const int64_t* info,
                  int64_t* order) {
  __shared__ int s_cnt[256][kOrderWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int longest = (int)info[1];
  const int bits = longest ? 32 - __clz(longest) : 0;
  const int per = (n_tiles + kOrderWarps - 1) / kOrderWarps;
  const int r0 = min(w * per, n_tiles), r1 = min(r0 + per, n_tiles);
  const unsigned below = (1u << lane) - 1u;
  uint64_t* src = keys;
  uint64_t* dst = (uint64_t*)order;
  for (int shift = 32; shift < 32 + bits; shift += 8) {
    for (int q = threadIdx.x; q < 256 * kOrderWarps; q += blockDim.x)
      (&s_cnt[0][0])[q] = 0;
    __syncthreads();
    for (int e0 = r0; e0 < r1; e0 += 32) {
      const int e = e0 + lane;
      const int d = e < r1 ? (int)((src[e] >> shift) & 0xFF) : 256;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d < 256 && (peers & below) == 0) s_cnt[d][w] += __popc(peers);
    }
    __syncthreads();
    // exclusive offsets, digit-major: thread q scans 8 counters
    long long sum = 0;
    int* flat = &s_cnt[0][0];
    const int q0 = threadIdx.x * (256 * kOrderWarps / kSortThreads);
    for (int q = 0; q < 256 * kOrderWarps / kSortThreads; ++q)
      sum += flat[q0 + q];
    long long total;
    int off = (int)block_exclusive_sum(sum, &total);
    for (int q = 0; q < 256 * kOrderWarps / kSortThreads; ++q) {
      const int c = flat[q0 + q];
      flat[q0 + q] = off;
      off += c;
    }
    __syncthreads();
    for (int e0 = r0; e0 < r1; e0 += 32) {
      const int e = e0 + lane;
      const uint64_t key = e < r1 ? src[e] : 0;
      const int d = e < r1 ? (int)((key >> shift) & 0xFF) : 256;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d < 256) {
        const int base = s_cnt[d][w];
        dst[base + __popc(peers & below)] = key;
      }
      __syncwarp();
      if (d < 256 && (peers & below) == 0) s_cnt[d][w] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    uint64_t* tmp = src;
    src = dst;
    dst = tmp;
  }
  // the result is in src (keys, or order after an odd number of passes)
  for (int e = threadIdx.x; e < n_tiles; e += blockDim.x)
    order[e] = (int64_t)(uint32_t)src[e];
}

// Persistent blocks take tiles in `order` (longest list first) through the
// counter next_tile (zeroed by the emit) and sort each tile's bucket of
// keys. A list of up to kWarpCap keys goes to one warp: the first block to
// draw one hands it to its warp 0, and from then on each of its warps draws
// its own (every tile still to draw is as short); an empty list ends the
// drawing warp. A longer list goes to a group of G = pow2ceil(len) /
// kWarpCap warps (all 16 past kSortCap keys), and the block draws 16 / G
// tiles at once, one for each group of its warps: every later tile is as
// short, so each group's list fits it. Each tile's fill counter is set
// back to zero.
__global__ void __launch_bounds__(kSortThreads)
tile_sort_kernel(uint64_t* __restrict__ keys, const int32_t* __restrict__ ranges,
                 const int64_t* __restrict__ order, int32_t* next_tile,
                 int32_t* __restrict__ fill, int n_tiles,
                 int32_t* __restrict__ tile_ids,
                 int32_t* __restrict__ gauss_ids) {
  constexpr int kWarps = kSortThreads / 32;
  extern __shared__ __align__(16) uint64_t s_skeys[];  // kPadded a warp
  __shared__ int s_draw[3];  // first index drawn, first extra index, G
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t x[kKeys];
  for (;;) {
    if (threadIdx.x == 0) {
      const int i = atomicAdd(next_tile, 1);
      int G = 1;
      if (i < n_tiles) {
        const int tile = (int)order[i];
        const int len = ranges[2 * tile + 1] - ranges[2 * tile];
        if (len > kWarpCap) G = min(kWarps, pow2ceil(len) / kWarpCap);
      }
      s_draw[0] = i;
      s_draw[1] = G > 1 ? atomicAdd(next_tile, kWarps / G - 1) : n_tiles;
      s_draw[2] = G;
    }
    __syncthreads();
    const int first = s_draw[0], extra = s_draw[1], G = s_draw[2];
    __syncthreads();  // every thread has read s_draw
    if (first >= n_tiles) return;
    const int group = warp / G;
    // warps on their own (G = 1): warp 0 takes the tile drawn, the others
    // draw theirs
    int idx = group == 0 ? first : (G > 1 ? extra + group - 1 : -1);
    for (;;) {
      if (idx < 0) {
        if (lane == 0) idx = atomicAdd(next_tile, 1);
        idx = __shfl_sync(0xffffffffu, idx, 0);
      }
      if (idx >= n_tiles) break;
      const int tile = (int)order[idx];
      const int start = ranges[2 * tile];
      const int len = ranges[2 * tile + 1] - start;
      if (len == 0) break;  // every later tile is empty too
      const int T = 32 * G;
      const int t = threadIdx.x - group * T;
      uint64_t* s = s_skeys + group * G * kPadded;
      if (group_sort(keys + start, len, s, x, t, T, group)) {
#pragma unroll
        for (int r = 0; r < kKeys; ++r) {
          const int e = t * kKeys + r;
          if (e < len) {
            gauss_ids[start + e] = (int32_t)(uint32_t)x[r];
            tile_ids[start + e] = tile;
          }
        }
      } else {
        for (int e = t; e < len; e += T) {
          gauss_ids[start + e] = (int32_t)(uint32_t)keys[start + e];
          tile_ids[start + e] = tile;
        }
      }
      if (t == 0) fill[tile] = 0;
      if (G > 1) break;
      idx = -1;
    }
    if (G == 1) return;
  }
}

// sigma = 0.5 (a dx dx + c dy dy) + b dx dy, rounded after every operation
// (no FMA contraction) so that the 1/255 and 1e-4 thresholds decide exactly
// as the plain torch version does, and kernels B and C decide alike.
__device__ __forceinline__ float splat_sigma(float a, float b, float c,
                                             float dx, float dy) {
  return __fadd_rn(
      __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                __fmul_rn(__fmul_rn(c, dy), dy))),
      __fmul_rn(__fmul_rn(b, dx), dy));
}

// ------------------------------------------------------------ pair records

// Record fields, in floats; the channels follow, then zeros to a multiple
// of 4 floats (16 bytes, what a bulk copy needs).
constexpr int kRU = 0, kRV = 1, kRA = 2, kRB = 3, kRC = 4, kRO = 5, kRT = 6,
              kRCol = 7;

__host__ __device__ constexpr int record_floats(int C) {
  return (kRCol + C + 3) / 4 * 4;
}

// Channel counts are served by kernel instances of width CI: C itself up
// to 7, then CI = 9, 13, ..., 29 (7 + CI a multiple of 4) and 32, each for
// the C above the instance before it. record_floats(C) equals
// record_floats(CI), so the records of C channels are those of CI with
// the channels past C zero (the record's padding). A kernel reads and
// writes C channels of its caller's arrays; the CI - C it carries on top
// are zero throughout and are not written.
constexpr int kMaxChannels = 32;

__host__ __device__ constexpr int instance_width(int C) {
  return C <= 7 ? C : (C >= 30 ? 32 : (C - 6) / 4 * 4 + 9);
}

// Records per bulk copy of kernel B: kBatchB, halved for records past 16
// floats so that three blocks still share an SM's shared memory.
__host__ __device__ constexpr int batch_b(int C) {
  return record_floats(C) <= 16 ? kBatchB : kBatchB / 2;
}

// The cull's margins (warp_culls). A pixel computes sigma_f with
// splat_sigma at (dx_f, dy_f) = (fl(fx - u), fl(fy - v)); its alpha passes
// only if fl(o expf(-sigma_f)) >= fl(1/255).
//   - Absolute, on the alpha side: expf is within 2 ulp, the product and
//     fl(1/255) round once each, and t's logf and its product 255 o once
//     each: together under ~8 u = 4.8e-7 in sigma (u = 2^-24). kCullAbs,
//     1e-5, is twenty times that.
//   - Relative, on the sigma side: with M = |a| X^2 + |c| Y^2 + 2 |b| X Y
//     (X, Y the largest |dx|, |dy| of the rectangle), each splat_sigma is
//     within 2 u M of the exact quadratic at its rounded arguments; every
//     pixel's dx_f lies in [dx_lo, dx_hi] (rounding is monotone), so the
//     exact row minimum bounds it from below, and the vertex evaluated at a
//     rounded dx* exceeds that minimum by O(u^2 M) only. Together 4 u M;
//     kCullRel = 2^-20 = 16 u is four times that.
constexpr float kCullAbs = 1e-5f;
constexpr float kCullRel = 9.5367431640625e-07f;  // 2^-20

// t = ln(255 opacity) + kCullAbs: sigma above it everywhere in the
// rectangle (by the relative margin) means alpha < 1/255 at every pixel.
// -inf (always culled) for an opacity below 1/255: alpha <= opacity then,
// exactly, since expf(-sigma) <= 1 for sigma >= 0. +inf (never culled) for
// a conic that is not positive definite.
__device__ __forceinline__ float cull_threshold(float a, float b, float c,
                                                float o) {
  if (o < kAlphaMin) return -__int_as_float(0x7f800000);
  if (!(a > 0.0f && __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, b)) > 0.0f))
    return __int_as_float(0x7f800000);
  return __fadd_rn(logf(__fmul_rn(255.0f, o)), kCullAbs);
}

// The pack, in two passes: each splat's record into a table [N, RS]
// (coalesced reads of the seven attribute arrays), then each pair's record
// from the table, 16 bytes a thread (one gather of 2-4 sectors per pair in
// place of eight scattered 4-byte loads).
template <int CI>
__global__ void splat_records_kernel(const float* __restrict__ u,
                                     const float* __restrict__ v,
                                     const float* __restrict__ conic_a,
                                     const float* __restrict__ conic_b,
                                     const float* __restrict__ conic_c,
                                     const float* __restrict__ colors,
                                     const float* __restrict__ opacities,
                                     int n, int C, float* __restrict__ table) {
  constexpr int RS = record_floats(CI);
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  float r[RS];
  r[kRU] = u[g];
  r[kRV] = v[g];
  r[kRA] = conic_a[g];
  r[kRB] = conic_b[g];
  r[kRC] = conic_c[g];
  r[kRO] = opacities[g];
  r[kRT] = cull_threshold(r[kRA], r[kRB], r[kRC], r[kRO]);
#pragma unroll
  for (int c = 0; c < CI; ++c)
    r[kRCol + c] = c < C ? colors[(int64_t)g * C + c] : 0.0f;
#pragma unroll
  for (int i = kRCol + CI; i < RS; ++i) r[i] = 0.0f;
  float4* dst = reinterpret_cast<float4*>(table + (int64_t)g * RS);
#pragma unroll
  for (int q = 0; q < RS / 4; ++q)
    dst[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

// Q = RS / 4 chunks of 16 bytes per record; one thread per chunk.
template <int Q>
__global__ void pair_records_kernel(const int32_t* __restrict__ gids,
                                    const float4* __restrict__ table,
                                    int64_t n_pairs,
                                    float4* __restrict__ rec) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_pairs * Q) return;
  const int64_t pair = k / Q;
  rec[k] = table[(int64_t)gids[pair] * Q + (k - pair * Q)];
}

// ------------------------------------------------------------ the cull

// min over dx in [lo, hi] of sigma on the row at dy: the vertex
// dx* = -b dy / a clamped to the interval (a > 0 wherever the threshold is
// finite and above -inf).
__device__ __forceinline__ float row_min_sigma(float a, float b, float c,
                                               float dy, float lo, float hi) {
  const float x = fminf(fmaxf(__fdiv_rn(-__fmul_rn(b, dy), a), lo), hi);
  return splat_sigma(a, b, c, x, dy);
}

// True if no pixel of the warp's rectangle, columns [fx0, fx0 + 15] and
// rows fy0, fy0 + 1 (pixel centres), can take the record: alpha < 1/255 at
// each. Operation for operation the plain warp_cull_reference.
__device__ __forceinline__ bool warp_culls(float u, float v, float a,
                                           float b, float c, float t,
                                           float fx0, float fy0) {
  const float lo = fx0 - u;
  const float hi = (fx0 + (float)(kTile - 1)) - u;
  const float dy0 = fy0 - v;
  const float dy1 = (fy0 + 1.0f) - v;
  const float X = fmaxf(fabsf(lo), fabsf(hi));
  const float Y = fmaxf(fabsf(dy0), fabsf(dy1));
  const float m = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(fabsf(a), X), X),
                __fmul_rn(__fmul_rn(fabsf(c), Y), Y)),
      __fmul_rn(__fmul_rn(2.0f * fabsf(b), X), Y));
  const float thr = __fadd_rn(t, __fmul_rn(kCullRel, m));
  // a NaN anywhere compares false: not culled
  return row_min_sigma(a, b, c, dy0, lo, hi) > thr &&
         row_min_sigma(a, b, c, dy1, lo, hi) > thr;
}

// Ballots of the warp: bit l of keep[k] is record 32 k + l of the batch,
// set if it is one of the first n and the warp's rectangle may take it.
template <int RS, int NB>
__device__ __forceinline__ void warp_keep(const float* sb, int n, int lane,
                                          float fx0, float fy0,
                                          unsigned (&keep)[NB]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int j = 32 * k + lane;
    bool kp = false;
    if (j < n) {
      const float4 h0 = *reinterpret_cast<const float4*>(sb + j * RS);
      const float4 h1 = *reinterpret_cast<const float4*>(sb + j * RS + 4);
      kp = !warp_culls(h0.x, h0.y, h0.z, h0.w, h1.x, h1.z, fx0, fy0);
    }
    keep[k] = __ballot_sync(0xffffffffu, kp);
  }
}

// keep[k] without indexing local memory (k is not a compile-time
// constant in the walks).
template <int NB>
__device__ __forceinline__ unsigned pick(const unsigned (&keep)[NB], int k) {
  unsigned r = keep[0];
#pragma unroll
  for (int q = 1; q < NB; ++q) r = k == q ? keep[q] : r;
  return r;
}

// ------------------------------------------------------------ kernel B

// The outputs of a tile with an empty list, written by one warp: colours
// and alpha 0, T 1, last 0.
template <bool kTrain>
__device__ __forceinline__ void fill_empty_tile(
    int tile, int lane, int width, int height, int tw, int C,
    float* __restrict__ out_colors, float* __restrict__ out_alpha,
    float* __restrict__ out_T, int32_t* __restrict__ out_last) {
  const int tx = tile % tw, ty = tile / tw;
  for (int q = lane; q < kBlock; q += 32) {
    const int px = tx * kTile + q % kTile, py = ty * kTile + q / kTile;
    if (px >= width || py >= height) continue;
    const int64_t p = (int64_t)py * width + px;
    for (int c = 0; c < C; ++c) out_colors[p * C + c] = 0.0f;
    out_alpha[p] = 0.0f;
    if (kTrain) {
      out_T[p] = 1.0f;
      out_last[p] = 0;
    }
  }
}

// CI: the instance's channels (acc in registers); C <= CI: the channels
// of out_colors (the records carry CI, zero past C).
template <int CI, bool kTrain>
__global__ void __launch_bounds__(kRasterThreads)
composite_kernel(const int32_t* __restrict__ ranges,
                 const float* __restrict__ rec,
                 const int64_t* __restrict__ order,
                 int32_t* __restrict__ next_tile, int n_tiles, int width,
                 int height, int tw, int C, float* __restrict__ out_colors,
                 float* __restrict__ out_alpha, float* __restrict__ out_T,
                 int32_t* __restrict__ out_last) {
  constexpr int RS = record_floats(CI);
  constexpr int KB = batch_b(CI);
  constexpr int NB = KB / 32;
  extern __shared__ __align__(16) float s_ring[];  // kStagesB x KB x RS
  __shared__ __align__(8) uint64_t s_bar[2 * kStagesB];  // full, empty
  // per stage: tile, index in the tile's list of the batch's first record,
  // record count, the tile's done slot; or the sentinel: -1, then the
  // first empty tile drawn (-1 if none)
  __shared__ int4 s_meta[kStagesB];
  // per tile in flight (slot = tile sequence mod kStagesB + 1): its warps
  // whose pixels have all stopped
  __shared__ int s_done[kStagesB + 1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t full0 = smem_u32(s_bar);
  const uint32_t empty0 = smem_u32(s_bar + kStagesB);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesB; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kBlock);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // the producer: one thread takes tiles, longest list first, and
    // streams each list through the ring; a sentinel stage ends the block
    if (lane != 0) return;
    for (int seq = 0, it = 0;; ++seq) {
      const int i = atomicAdd(next_tile, 1);
      const int tile = i < n_tiles ? (int)order[i] : -1;
      const int start = tile < 0 ? 0 : ranges[2 * tile];
      const int len = tile < 0 ? 0 : ranges[2 * tile + 1] - start;
      int s = it % kStagesB;
      if (it >= kStagesB) mbar_wait(empty0 + 8 * s, (it / kStagesB - 1) & 1);
      if (len == 0) {
        // no tile left, or the first empty one: the order is by list
        // length, descending, so every tile still to draw is empty. The
        // consumers write them, this one first.
        s_meta[s] = make_int4(-1, tile, 0, 0);
        mbar_arrive(full0 + 8 * s);
        return;
      }
      // a slot is reused kStagesB + 1 tiles later: by then every warp has
      // released the stages of its previous tile, and with them its count
      const int slot = seq % (kStagesB + 1);
      s_done[slot] = 0;
      for (int base = 0;;) {
        const int cnt = min(KB, len - base);
        s_meta[s] = make_int4(tile, base, cnt, slot);
        mbar_expect_tx(full0 + 8 * s, cnt * RS * 4);
        bulk_load(smem_u32(s_ring + s * KB * RS),
                  rec + (int64_t)(start + base) * RS, cnt * RS * 4,
                  full0 + 8 * s);
        ++it;
        base += KB;
        if (base >= len || *(volatile int*)&s_done[slot] == kConsumers)
          break;
        s = it % kStagesB;
        if (it >= kStagesB) mbar_wait(empty0 + 8 * s, (it / kStagesB - 1) & 1);
      }
    }
  }

  const int t = threadIdx.x;
  const int col = t % kTile;
  const int row = t / kTile;
  int cur = -2;  // the tile of the pixel state: none yet (-1 ends)
  int px = 0, py = 0;
  bool inside = false, done = true;
  float fx = 0.0f, fy = 0.0f, fx0 = 0.0f, fy0 = 0.0f;
  float T = 1.0f;
  float acc[CI];
  int last = 0;  // one past the last contributor, in the tile's list
  for (int it = 0;; ++it) {
    const int s = it % kStagesB;
    mbar_wait(full0 + 8 * s, (it / kStagesB) & 1);
    const int4 m = s_meta[s];
    if (m.x != cur) {
      if (cur >= 0 && inside) {
        const int64_t p = (int64_t)py * width + px;
#pragma unroll
        for (int c = 0; c < CI; ++c)
          if (c < C) out_colors[p * C + c] = acc[c];
        out_alpha[p] = 1.0f - T;
        if (kTrain) {
          out_T[p] = T;
          out_last[p] = last;
        }
      }
      if (m.x < 0) {
        // the empty tiles: the one the producer drew, then the rest
        int tile = warp == 0 ? m.y : -1;
        for (;;) {
          if (tile < 0) {
            int i = 0;
            if (lane == 0) i = atomicAdd(next_tile, 1);
            i = __shfl_sync(0xffffffffu, i, 0);
            if (i >= n_tiles) return;
            tile = (int)order[i];
          }
          fill_empty_tile<kTrain>(tile, lane, width, height, tw, C,
                                  out_colors, out_alpha, out_T, out_last);
          tile = -1;
        }
      }
      cur = m.x;
      const int tx = cur % tw, ty = cur / tw;
      px = tx * kTile + col;
      py = ty * kTile + row;
      inside = px < width && py < height;
      fx = (float)px + 0.5f;
      fy = (float)py + 0.5f;
      fx0 = (float)(tx * kTile) + 0.5f;
      fy0 = (float)(ty * kTile + 2 * warp) + 0.5f;
      T = 1.0f;
#pragma unroll
      for (int c = 0; c < CI; ++c) acc[c] = 0.0f;
      last = 0;
      done = !inside;
      if (__all_sync(0xffffffffu, done) && lane == 0)
        atomicAdd(&s_done[m.w], 1);
    }
    if (!__all_sync(0xffffffffu, done)) {
      const float* sb = s_ring + s * KB * RS;
      unsigned keep[NB];
      warp_keep<RS, NB>(sb, m.z, lane, fx0, fy0, keep);
      // the records the warp may take, in list order; each pixel applies
      // every skip and stop rule as if it walked them all
      for (int k = 0; k < NB && !done; ++k) {
        unsigned bits = pick(keep, k);
        while (bits != 0u && !done) {
          const int j = 32 * k + __ffs(bits) - 1;
          bits &= bits - 1u;
          const float* r = sb + j * RS;
          // u v a b, then c o t and a channel
          const float4 h0 = *reinterpret_cast<const float4*>(r);
          const float4 h1 = *reinterpret_cast<const float4*>(r + 4);
          const float dx = fx - h0.x;
          const float dy = fy - h0.y;
          const float sigma = splat_sigma(h0.z, h0.w, h1.x, dx, dy);
          if (sigma < 0.0f) continue;
          const float alpha = fminf(kAlphaClamp, h1.y * expf(-sigma));
          if (alpha < kAlphaMin) continue;
          const float next_T = T * (1.0f - alpha);
          if (next_T <= kTStop) {  // stop; this splat is excluded
            done = true;
            break;
          }
          const float w = alpha * T;
#pragma unroll
          for (int c = 0; c < CI; ++c) acc[c] += r[kRCol + c] * w;
          T = next_T;
          if (kTrain) last = m.y + j + 1;
        }
      }
      if (__all_sync(0xffffffffu, done) && lane == 0)
        atomicAdd(&s_done[m.w], 1);
    }
    mbar_arrive(empty0 + 8 * s);
  }
}

// ------------------------------------------------------------ kernel C

// Gradient row of a splat: NG = 8 + C floats, in this order.
constexpr int kGU = 0, kGV = 1, kGA = 2, kGB = 3, kGC = 4, kGO = 5,
              kGAbsU = 6, kGAbsV = 7, kGCol = 8;

// One round of the transposed warp sum: a lane keeps W of its 2 W values
// (the upper half if bit W of its lane is set) and adds its partner's
// (lane ^ W) copy of the same half. Compile-time indices: x stays in
// registers.
template <int W>
__device__ __forceinline__ void fold_half(float (&x)[16], int lane) {
  const bool up = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float give = up ? x[i] : x[i + W];
    const float keep = up ? x[i + W] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, give, W);
  }
}

// Transposed warp sum of 16 values: rounds of 8, 4, 2 and 1 shuffles, then
// one more adds the two half-warps. Lane l ends with the warp's sum of
// x[l & 15]: 16 shuffles in place of 5 per value.
__device__ __forceinline__ float warp_sum16(float (&x)[16], int lane) {
  fold_half<8>(x, lane);
  fold_half<4>(x, lane);
  fold_half<2>(x, lane);
  fold_half<1>(x, lane);
  return x[0] + __shfl_xor_sync(0xffffffffu, x[0], 16);
}

// The same for the 12 fields of C = 4 (the main path's rgb + depth), in 13
// shuffles: halves of 6 and 3 (over lane bits 4 and 3), then 3 values
// split 2 / 1 over bit 2 (lanes without it keep fields 0 and 1, lanes
// with it field 2), halves again over bit 1 (lanes with bit 2 just add),
// and a last sum over bit 0. Returns the sum of field *f; *add is set in
// exactly one lane per field. Measured 7% faster kernel C than
// warp_sum16 at the headline frame.
__device__ __forceinline__ float warp_sum12(float (&x)[16], int lane,
                                            int* f, bool* add) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float give = b4 ? x[i] : x[i + 6];
    const float keep = b4 ? x[i + 6] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float give = b3 ? x[i] : x[i + 3];
    const float keep = b3 ? x[i + 3] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
  }
  const float r0 = __shfl_xor_sync(0xffffffffu, b2 ? x[0] : x[2], 4);
  const float r1 = __shfl_xor_sync(0xffffffffu, x[1], 4);
  float y = x[2] + r0;  // lanes with bit 2: field 2
  if (!b2) {
    x[0] += r0;
    x[1] += r1;
  }
  const float give = b2 ? y : (b1 ? x[0] : x[1]);
  const float keep = b2 ? y : (b1 ? x[1] : x[0]);
  y = keep + __shfl_xor_sync(0xffffffffu, give, 2);
  y += __shfl_xor_sync(0xffffffffu, y, 1);
  *f = (b3 ? 3 : 0) + (b4 ? 6 : 0) + (b2 ? 2 : (b1 ? 1 : 0));
  *add = (lane & 1) == 0 && !(b2 && b1);
  return y;
}

// CI: the instance's channels; C <= CI: those of grad_colors and of the
// [N, 8 + C] gradient rows (the CI - C past them are zero: not written).
template <int CI>
__global__ void __launch_bounds__(kRasterThreads)
composite_bwd_kernel(const int32_t* __restrict__ ranges,
                     const int32_t* __restrict__ gids,
                     const float* __restrict__ rec,
                     const int64_t* __restrict__ order,
                     int32_t* __restrict__ next_tile, int n_tiles, int width,
                     int height, int tw, int C,
                     const float* __restrict__ final_T,
                     const int32_t* __restrict__ last,
                     const float* __restrict__ grad_colors,
                     const float* __restrict__ grad_alpha,
                     float* __restrict__ grads) {
  constexpr int RS = record_floats(CI);
  constexpr int NGI = kGCol + CI;  // fields a warp sums, in rounds of 16
  constexpr int NB = kBatchC / 32;
  const int NG = kGCol + C;        // the row's stride
  extern __shared__ __align__(16) float s_ring[];  // kStagesC x kBatchC x RS
  __shared__ __align__(8) uint64_t s_bar[2 * kStagesC];  // full, empty
  // per stage: tile (-1: no more tiles), index in the tile's list of the
  // batch's first record, record count
  __shared__ int4 s_meta[kStagesC];
  __shared__ int32_t s_gid[kStagesC][kBatchC];  // the stage's splat ids

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t full0 = smem_u32(s_bar);
  const uint32_t empty0 = smem_u32(s_bar + kStagesC);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStagesC; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kBlock);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // the producer warp: takes tiles, longest list first, and streams
    // each list back to front from the longest prefix any of its pixels
    // walks, with the batch's splat ids
    int it = 0;
    for (;;) {
      int i = 0;
      if (lane == 0) i = atomicAdd(next_tile, 1);
      i = __shfl_sync(0xffffffffu, i, 0);
      if (i >= n_tiles) break;
      const int tile = (int)order[i];
      const int start = ranges[2 * tile];
      // the order is by list length, descending: the rest are empty too
      if (ranges[2 * tile + 1] == start) break;
      const int tx = tile % tw, ty = tile / tw;
      int len = 0;
      for (int q = lane; q < kBlock; q += 32) {
        const int px = tx * kTile + q % kTile, py = ty * kTile + q / kTile;
        if (px < width && py < height)
          len = max(len, last[(int64_t)py * width + px]);
      }
      len = __reduce_max_sync(0xffffffffu, len);
      for (int bend = len; bend > 0; bend -= kBatchC, ++it) {
        const int bstart = max(bend - kBatchC, 0);
        const int cnt = bend - bstart;
        const int s = it % kStagesC;
        if (it >= kStagesC)
          mbar_wait(empty0 + 8 * s, (it / kStagesC - 1) & 1);
        for (int q = lane; q < cnt; q += 32)
          s_gid[s][q] = gids[start + bstart + q];
        __syncwarp();  // the ids before lane 0's arrive releases them
        if (lane == 0) {
          s_meta[s] = make_int4(tile, bstart, cnt, 0);
          mbar_expect_tx(full0 + 8 * s, cnt * RS * 4);
          bulk_load(smem_u32(s_ring + s * kBatchC * RS),
                    rec + (int64_t)(start + bstart) * RS, cnt * RS * 4,
                    full0 + 8 * s);
        }
      }
    }
    if (lane == 0) {
      const int s = it % kStagesC;
      if (it >= kStagesC)
        mbar_wait(empty0 + 8 * s, (it / kStagesC - 1) & 1);
      s_meta[s] = make_int4(-1, 0, 0, 0);
      mbar_arrive(full0 + 8 * s);
    }
    return;
  }

  const int t = threadIdx.x;
  const int col = t % kTile;
  const int row = t / kTile;
  int cur = -1;
  int my_last = 0, wlen = 0;
  float fx = 0.0f, fy = 0.0f, fx0 = 0.0f, fy0 = 0.0f;
  float T = 1.0f, T_N = 1.0f, g_a = 0.0f, S = 0.0f;
  float g_c[CI];
  for (int it = 0;; ++it) {
    const int s = it % kStagesC;
    mbar_wait(full0 + 8 * s, (it / kStagesC) & 1);
    const int4 m = s_meta[s];
    if (m.x < 0) return;
    if (m.x != cur) {
      cur = m.x;
      const int tx = cur % tw, ty = cur / tw;
      const int px = tx * kTile + col;
      const int py = ty * kTile + row;
      fx = (float)px + 0.5f;
      fy = (float)py + 0.5f;
      fx0 = (float)(tx * kTile) + 0.5f;
      fy0 = (float)(ty * kTile + 2 * warp) + 0.5f;
      T_N = 1.0f;
      my_last = 0;
      g_a = 0.0f;
      S = 0.0f;
#pragma unroll
      for (int c = 0; c < CI; ++c) g_c[c] = 0.0f;
      if (px < width && py < height) {
        const int64_t p = (int64_t)py * width + px;
        T_N = final_T[p];
        my_last = last[p];
        g_a = grad_alpha[p];
#pragma unroll
        for (int c = 0; c < CI; ++c)
          if (c < C) g_c[c] = grad_colors[p * C + c];
      }
      T = T_N;
      wlen = __reduce_max_sync(0xffffffffu, my_last);
    }
    if (m.y < wlen) {
      const float* sb = s_ring + s * kBatchC * RS;
      const int32_t* sg = s_gid[s];
      unsigned keep[NB];
      warp_keep<RS, NB>(sb, min(m.z, wlen - m.y), lane, fx0, fy0, keep);
      for (int k = NB - 1; k >= 0; --k) {
        unsigned bits = pick(keep, k);
        while (bits != 0u) {
          const int hb = 31 - __clz(bits);
          bits ^= 1u << hb;
          const int j = 32 * k + hb;
          // the splat's fields at this pixel: the 8 of geometry and
          // opacity, and w times each channel's cotangent (w = 0: no hit)
          float g8[kGCol];
#pragma unroll
          for (int q = 0; q < kGCol; ++q) g8[q] = 0.0f;
          float w = 0.0f;
          bool hit = false;
          if (m.y + j < my_last) {
            const float* r = sb + j * RS;
            // u v a b, then c o t and a channel
            const float4 h0 = *reinterpret_cast<const float4*>(r);
            const float4 h1 = *reinterpret_cast<const float4*>(r + 4);
            const float a = h0.z, b = h0.w, c = h1.x;
            const float dx = fx - h0.x;
            const float dy = fy - h0.y;
            const float sigma = splat_sigma(a, b, c, dx, dy);
            const float e = expf(-sigma);
            const float raw = h1.y * e;
            const float alpha = fminf(kAlphaClamp, raw);
            if (sigma >= 0.0f && alpha >= kAlphaMin) {
              hit = true;
              const float one_m = 1.0f - alpha;
              // one correctly rounded reciprocal for both divisions by
              // 1 - alpha (two IEEE divisions cost ~5% of the kernel)
              const float inv = __frcp_rn(one_m);
              T = T * inv;  // T before splat j
              w = alpha * T;
              float cg = 0.0f;
#pragma unroll
              for (int ch = 0; ch < CI; ++ch) cg += r[kRCol + ch] * g_c[ch];
              const float dalpha = T * cg - (S - g_a * T_N) * inv;
              S += w * cg;
              if (raw < kAlphaClamp) {  // the clamp passes no gradient
                const float dsig = -alpha * dalpha;
                g8[kGU] = -dsig * (a * dx + b * dy);
                g8[kGV] = -dsig * (c * dy + b * dx);
                g8[kGA] = 0.5f * dx * dx * dsig;
                g8[kGB] = dx * dy * dsig;
                g8[kGC] = 0.5f * dy * dy * dsig;
                g8[kGO] = dalpha * e;
                g8[kGAbsU] = fabsf(g8[kGU]);
                g8[kGAbsV] = fabsf(g8[kGV]);
              }
            }
          }
          if (!__any_sync(0xffffffffu, hit)) continue;  // warp-uniform
          // the warp's sums, one field per adding lane; the atomics'
          // results are unused, so the warp issues one red.global.add.f32
          float* dst = grads + (int64_t)sg[j] * NG;
          // the row in rounds of 16 fields (compile-time indices: the
          // fields stay in registers); lanes 0-15 add field k0 + lane
#pragma unroll
          for (int k0 = 0; k0 < NGI; k0 += 16) {
            float x[16];
#pragma unroll
            for (int q = 0; q < 16; ++q) {
              const int f = k0 + q;
              x[q] = f < kGCol ? g8[f < kGCol ? f : 0]
                               : (f < NGI ? w * g_c[f < NGI ? f - kGCol : 0]
                                          : 0.0f);
            }
            if constexpr (CI == 4) {
              int f;
              bool add;
              const float sum = warp_sum12(x, lane, &f, &add);
              if (add) atomicAdd(dst + f, sum);
            } else {
              const float sum = warp_sum16(x, lane);
              if (lane < 16 && k0 + lane < NG) atomicAdd(dst + k0 + lane, sum);
            }
          }
        }
      }
    }
    mbar_arrive(empty0 + 8 * s);
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads1D - 1) / kThreads1D);
}

// A persistent grid for a raster kernel: as many blocks as fit on the card
// at once, at most one per tile. The first call for a device raises the
// kernel's dynamic shared memory limit to `smem` and asks for its
// occupancy; later calls reuse the answer (a host query per call costs
// more than a small pass's kernel). One cache per kernel: Kern is a
// template argument, since kernels of one signature share a pointer type.
template <auto Kern>
cudaError_t persistent_grid(int smem, int n_tiles, int* grid) {
  constexpr int kMaxDevices = 64;
  static int fits[kMaxDevices] = {};  // blocks the card holds at once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (fits[dev] == 0) {
    e = cudaFuncSetAttribute(Kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kern,
                                                      kRasterThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    fits[dev] = sms * per_sm;
  }
  *grid = n_tiles < 1 ? 1 : (n_tiles < fits[dev] ? n_tiles : fits[dev]);
  return cudaSuccess;
}

// Blocks of Kern the card holds at once with `smem` bytes of dynamic shared
// memory each (one size per kernel: 0 or the one given), asked once per
// device and cached; the first ask with smem > 0 raises the kernel's limit.
template <auto Kern>
cudaError_t resident_blocks(int threads, int smem, int* blocks) {
  constexpr int kMaxDevices = 64;
  static int fits[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& f = fits[dev][smem > 0];
  if (f == 0) {
    if (smem > 0) {
      e = cudaFuncSetAttribute(
          Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kern, threads,
                                                      smem);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    f = sms * per_sm;
  }
  *blocks = f;
  return cudaSuccess;
}

// A persistent grid over n splats: at most the resident blocks, at most
// one per kBinThreads splats, at least one.
template <auto Kern>
cudaError_t bin_grid(int n, int* grid) {
  int fit = 0;
  const cudaError_t e = resident_blocks<Kern>(kBinThreads, 0, &fit);
  if (e != cudaSuccess) return e;
  const int need = (n + kBinThreads - 1) / kBinThreads;
  *grid = need < 1 ? 1 : (need < fit ? need : fit);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* sc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Kernel A before the host's synchronisation: the count and the scan.
// scratch: [n_tiles + 1] int32 (the bins, then the sort's tile counter),
// zeroed here; ranges [n_tiles, 2] int32, order_keys [n_tiles] uint64 and
// info [2] int64 (pairs, longest list) are written.
int sc_worklist_count(const void* u, const void* v, const void* radii,
                      const void* valid, int n, int tw, int th, void* scratch,
                      void* ranges, void* order_keys, void* info,
                      void* stream) {
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = tw * th;
  int32_t* bins = (int32_t*)scratch;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(tile_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kScanStage * (int)sizeof(int));
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  e = cudaMemsetAsync(bins, 0, (size_t)(n_tiles + 1) * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  int grid = 0;
  e = bin_grid<worklist_count_kernel>(n, &grid);
  if (e != cudaSuccess) return (int)e;
  worklist_count_kernel<<<grid, kBinThreads, 0, s>>>(
      (const float*)u, (const float*)v, (const float*)radii,
      (const uint8_t*)valid, n, tw, th, n_tiles <= kPrivTiles, bins);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool stage = n_tiles <= kScanStage;
  tile_scan_kernel<<<1, kScanThreads, stage ? n_tiles * sizeof(int) : 0, s>>>(
      bins, n_tiles, stage, (int32_t*)ranges, (uint64_t*)order_keys,
      (int64_t*)info);
  return (int)cudaGetLastError();
}

// The tile order from sc_worklist_count's order_keys (sorted in place) and
// info: order [n_tiles] int64.
int sc_tile_order(void* order_keys, int n_tiles, const void* info,
                  void* order, void* stream) {
  tile_order_kernel<<<1, kSortThreads, 0, (cudaStream_t)stream>>>(
      (uint64_t*)order_keys, n_tiles, (const int64_t*)info, (int64_t*)order);
  return (int)cudaGetLastError();
}

// Kernel A after the synchronisation: the emit into buckets and the
// per-tile sort. scratch, ranges and order from the two calls above;
// keys [n_pairs] uint64 scratch; tile_ids and gauss_ids [n_pairs] int32
// out. The sort's grid is persistent.
int sc_worklist_emit(const void* u, const void* v, const void* radii,
                     const void* valid, const void* depths, int n, int tw,
                     int th, void* scratch, const void* ranges,
                     const void* order, void* keys, void* tile_ids,
                     void* gauss_ids, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = tw * th;
  int32_t* fill = (int32_t*)scratch;
  int grid = 0;
  cudaError_t e = bin_grid<worklist_emit_kernel>(n, &grid);
  if (e != cudaSuccess) return (int)e;
  worklist_emit_kernel<<<grid, kBinThreads, 0, s>>>(
      (const float*)u, (const float*)v, (const float*)radii,
      (const uint8_t*)valid, (const float*)depths, n, tw, th,
      n_tiles <= kPrivTiles, (const int32_t*)ranges, fill, fill + n_tiles,
      (uint64_t*)keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int smem = kSortThreads / 32 * kPadded * (int)sizeof(uint64_t);
  e = resident_blocks<tile_sort_kernel>(kSortThreads, smem, &grid);
  if (e != cudaSuccess) return (int)e;
  tile_sort_kernel<<<n_tiles < grid ? n_tiles : grid, kSortThreads, smem,
                     s>>>((uint64_t*)keys, (const int32_t*)ranges,
                          (const int64_t*)order, fill + n_tiles, fill,
                          n_tiles, (int32_t*)tile_ids, (int32_t*)gauss_ids);
  return (int)cudaGetLastError();
}

// The kernel instances (instance_width): SC_WIDTHS(X) applies X to each.
#define SC_WIDTHS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(9) X(13) X(17) X(21) X(25) X(29) X(32)

// records: [n_pairs, record_floats(C)] f32; table: [n, record_floats(C)]
// f32 scratch; both 16-byte aligned. C <= kMaxChannels.
int sc_pair_records(const void* gids, const void* u, const void* v,
                    const void* conic_a, const void* conic_b,
                    const void* conic_c, const void* colors,
                    const void* opacities, int n, long long n_pairs, int C,
                    void* table, void* records, void* stream) {
  if (n_pairs <= 0) return (int)cudaSuccess;
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SC_CASE(CH)                                                          \
  case CH:                                                                   \
    splat_records_kernel<CH><<<blocks_for(n), kThreads1D, 0, s>>>(           \
        (const float*)u, (const float*)v, (const float*)conic_a,             \
        (const float*)conic_b, (const float*)conic_c, (const float*)colors,  \
        (const float*)opacities, n, C, (float*)table);                       \
    break;
  switch (instance_width(C)) {
    SC_WIDTHS(SC_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SC_CASE
  const int q = record_floats(C) / 4;
  const unsigned blocks = blocks_for(n_pairs * q);
  const int32_t* g = (const int32_t*)gids;
  const float4* tab = (const float4*)table;
  float4* rec = (float4*)records;
#define SC_CASE(Q)                                                            \
  case Q:                                                                     \
    pair_records_kernel<Q><<<blocks, kThreads1D, 0, s>>>(g, tab, n_pairs, rec); \
    break;
  switch (q) {
    SC_CASE(2) SC_CASE(3) SC_CASE(4) SC_CASE(5) SC_CASE(6) SC_CASE(7)
    SC_CASE(8) SC_CASE(9) SC_CASE(10)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SC_CASE
  return (int)cudaGetLastError();
}

// records from sc_pair_records; order: [tw * th] int64, the tiles in the
// order blocks take them; next_tile: one int32, zeroed by the caller.
// out_T and out_last: both null (eval) or both set (training variant).
int sc_composite(const void* ranges, const void* records, const void* order,
                 void* next_tile, int C, int width, int height, int tw,
                 int th, void* out_colors, void* out_alpha, void* out_T,
                 void* out_last, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool train = out_T != nullptr;
  if (train != (out_last != nullptr)) return (int)cudaErrorInvalidValue;
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  const int n_tiles = tw * th;
#define SC_LAUNCH(CH, TR)                                                     \
  {                                                                           \
    const int smem = kStagesB * batch_b(CH) * record_floats(CH) * 4;          \
    int grid = 0;                                                             \
    const cudaError_t e =                                                     \
        persistent_grid<composite_kernel<CH, TR>>(smem, n_tiles, &grid);      \
    if (e != cudaSuccess) return (int)e;                                      \
    composite_kernel<CH, TR><<<grid, kRasterThreads, smem, s>>>(              \
        (const int32_t*)ranges, (const float*)records, (const int64_t*)order, \
        (int32_t*)next_tile, n_tiles, width, height, tw, C,                   \
        (float*)out_colors, (float*)out_alpha, (float*)out_T,                 \
        (int32_t*)out_last);                                                  \
  }
#define SC_CASE(CH)                \
  case CH:                         \
    if (train)                     \
      SC_LAUNCH(CH, true)          \
    else                           \
      SC_LAUNCH(CH, false)         \
    break;
  switch (instance_width(C)) {
    SC_WIDTHS(SC_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SC_CASE
#undef SC_LAUNCH
  return (int)cudaGetLastError();
}

// As sc_composite, plus kernel B's final T and last index and the
// cotangents. grads [N, 8 + C] must be zeroed by the caller (atomics add
// into it).
int sc_composite_backward(const void* ranges, const void* gids,
                          const void* records, const void* order,
                          void* next_tile, int C, int width, int height,
                          int tw, int th, const void* final_T,
                          const void* last, const void* grad_colors,
                          const void* grad_alpha, void* grads, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C < 1 || C > kMaxChannels) return (int)cudaErrorInvalidValue;
  const int n_tiles = tw * th;
#define SC_CASE(CH)                                                           \
  case CH: {                                                                  \
    const int smem =                                                          \
        kStagesC * kBatchC * record_floats(CH) * 4;                          \
    int grid = 0;                                                             \
    const cudaError_t e =                                                     \
        persistent_grid<composite_bwd_kernel<CH>>(smem, n_tiles, &grid);      \
    if (e != cudaSuccess) return (int)e;                                      \
    composite_bwd_kernel<CH><<<grid, kRasterThreads, smem, s>>>(              \
        (const int32_t*)ranges, (const int32_t*)gids, (const float*)records,  \
        (const int64_t*)order, (int32_t*)next_tile, n_tiles, width, height,   \
        tw, C, (const float*)final_T, (const int32_t*)last,                   \
        (const float*)grad_colors, (const float*)grad_alpha, (float*)grads);  \
    break;                                                                    \
  }
  switch (instance_width(C)) {
    SC_WIDTHS(SC_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SC_CASE
  return (int)cudaGetLastError();
}

}  // extern "C"
