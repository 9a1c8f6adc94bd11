// Gaussian raster for Hopper (sm_90a): tile worklist, compositing and its
// backward.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// gs_raster.py. Every entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().
//
// ---------------------------------------------------------------------------
// Kernel A, the tile worklist: isect_count_kernel, isect_emit_kernel and
// tile_ranges_kernel (a stable torch.sort of the keys runs between emit and
// ranges). Replaces street_crafter_tpu/ops/gs_raster_fused.py::_compact_kernel
// (K1), which compacted each 128-px coarse tile's depth-selected candidates
// into per-16-px-row lists under fixed VMEM capacities. Here every splat
// emits one (tile << 32 | depth bits) key for EVERY 16x16 tile its 3-sigma
// box overlaps, so no tile drops a splat and wide splats keep their interior
// tiles. Bound on this card: memory traffic and atomics-free scatter of
// 12 bytes per pair (key + id); the count pass reads 13 bytes per splat.
// Design: one thread per splat, a prefix sum gives each splat its own
// output slice (no atomics, deterministic order), and the range pass is one
// thread per sorted pair comparing its tile with its left neighbour.
//
// Kernel B, compositing: composite_kernel<C, kTrain>. Replaces
// street_crafter_tpu/ops/gs_raster_fused.py::_composite_kernel (K2), which
// composited 16x128 pixel strips with MXU matmuls, a Cholesky-factored
// sigma and a row-granular early exit. Here one block of 256 threads owns
// one 16x16 tile, one thread per pixel. Bound on this card: the per-pixel
// exp and FMA chain over the tile's list (compute), and the gather of each
// splat's attributes (latency). Design: the tile's depth-sorted list is
// streamed in batches of 256 splats staged in shared memory (one gather per
// splat per tile, then a broadcast read by all 256 pixels); each pixel stops
// once its transmittance would fall to 1e-4, and the block leaves as soon as
// all of its pixels have stopped (__syncthreads_count). The training variant
// (kTrain) also writes each pixel's final T and the index, in its tile's
// list, one past the last splat that contributed: kernel C's starting point.
//
// Kernel C, compositing backward: composite_bwd_kernel<C>. Replaces
// street_crafter_tpu/ops/gs_raster_train.py:60 _composite_bwd_kernel (K3),
// which recomputed alpha and log-T per 16x128 row in two passes (a forward
// pass storing per-block base log-T, then a reverse pass with MXU suffix
// sums) on the packed Cholesky layout. Here, gsplat's rasterize_to_pixels_bwd
// layout: one 256-thread block per 16x16 tile, one thread per pixel, the
// tile's list staged in shared memory in batches of 256 from the back. Each
// pixel starts at its own last contributor with the forward's final T and
// walks back, rebuilding T_j = T_{j+1} / (1 - alpha_j): a division, not a
// forward re-walk, since alpha <= 0.999 bounds the factor by 1000 and T >=
// 1e-4 on every contributor, so no T underflows and each step adds one
// rounding; a forward recompute would cost a second walk per pixel. With
// S_j the suffix sum of w c.g_c behind splat j, per pair:
//   dalpha = T_j (c_j.g_c) - (S_j - g_a T_N) / (1 - alpha_j),
//   dsigma = -alpha dalpha, dopacity = dalpha exp(-sigma) (0 where alpha is
//   clamped at 0.999), du = -dsigma (a dx + b dy), dv = -dsigma (c dy + b dx),
//   da = dx^2 dsigma / 2, db = dx dy dsigma, dc = dy^2 dsigma / 2,
//   dcolor = w g_c, and the absgrad columns |du|, |dv| (gsplat absgrad=True).
// sigma comes from the same rounded expression as in kernel B
// (splat_sigma), so every skip and stop decision is the forward's. Bound on
// this card: per pair, the warp reductions of 8 + C values and one atomicAdd
// per value per warp into the [N, 8 + C] gradient rows (instruction issue and
// L2 atomics; the bytes are small). Design: a warp skips the reduction of a
// splat none of its pixels touched (__any_sync), and the walk covers only
// the tile's list up to the largest last index of its pixels.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;       // one thread per pixel of a tile
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

__global__ void isect_count_kernel(const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   const float* __restrict__ radii,
                                   const uint8_t* __restrict__ valid, int n,
                                   int tw, int th, int32_t* __restrict__ counts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int tx0, tx1, ty0, ty1;
  counts[i] = tile_range(u[i], v[i], radii[i], valid[i] != 0, tw, th, tx0,
                         tx1, ty0, ty1)
                  ? (tx1 - tx0) * (ty1 - ty0)
                  : 0;
}

// offsets: inclusive prefix sum of the counts (int64).
__global__ void isect_emit_kernel(const float* __restrict__ u,
                                  const float* __restrict__ v,
                                  const float* __restrict__ radii,
                                  const uint8_t* __restrict__ valid,
                                  const float* __restrict__ depths,
                                  const int64_t* __restrict__ offsets, int n,
                                  int tw, int th, int64_t* __restrict__ keys,
                                  int32_t* __restrict__ gids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int tx0, tx1, ty0, ty1;
  if (!tile_range(u[i], v[i], radii[i], valid[i] != 0, tw, th, tx0, tx1, ty0,
                  ty1))
    return;
  // depth > near_plane > 0, so the raw f32 bits sort like the values
  const int64_t dbits = (int64_t)__float_as_uint(depths[i]);
  int64_t k = i ? offsets[i - 1] : 0;
  for (int ty = ty0; ty < ty1; ++ty) {
    for (int tx = tx0; tx < tx1; ++tx, ++k) {
      keys[k] = ((int64_t)(ty * tw + tx) << 32) | dbits;
      gids[k] = i;
    }
  }
}

// ranges [n_tiles, 2] must be zeroed by the caller (empty tiles stay [0,0)).
__global__ void tile_ranges_kernel(const int64_t* __restrict__ keys,
                                   int64_t n_pairs,
                                   int32_t* __restrict__ ranges) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_pairs) return;
  const int tile = (int)(keys[k] >> 32);
  if (k == 0) {
    ranges[2 * tile] = 0;
  } else {
    const int prev = (int)(keys[k - 1] >> 32);
    if (prev != tile) {
      ranges[2 * prev + 1] = (int32_t)k;
      ranges[2 * tile] = (int32_t)k;
    }
  }
  if (k == n_pairs - 1) ranges[2 * tile + 1] = (int32_t)n_pairs;
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

template <int C, bool kTrain>
__global__ void __launch_bounds__(kBlock)
composite_kernel(const int32_t* __restrict__ ranges,
                 const int32_t* __restrict__ gids,
                 const float* __restrict__ u, const float* __restrict__ v,
                 const float* __restrict__ conic_a,
                 const float* __restrict__ conic_b,
                 const float* __restrict__ conic_c,
                 const float* __restrict__ colors,
                 const float* __restrict__ opacities, int width, int height,
                 int tw, float* __restrict__ out_colors,
                 float* __restrict__ out_alpha, float* __restrict__ out_T,
                 int32_t* __restrict__ out_last) {
  __shared__ float s_u[kBlock], s_v[kBlock], s_a[kBlock], s_b[kBlock],
      s_c[kBlock], s_o[kBlock];
  __shared__ float s_col[kBlock * C];

  const int t = threadIdx.x;
  const int tile = blockIdx.y * tw + blockIdx.x;
  const int px = blockIdx.x * kTile + t % kTile;
  const int py = blockIdx.y * kTile + t / kTile;
  const bool inside = px < width && py < height;
  const float fx = (float)px + 0.5f;
  const float fy = (float)py + 0.5f;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  bool done = !inside;
  int last = 0;  // one past the last contributor, relative to start

  for (int base = start; base < end; base += kBlock) {
    // barrier: the previous batch is fully read before it is overwritten
    if (__syncthreads_count(done) == kBlock) break;
    const int k = base + t;
    if (k < end) {
      const int g = gids[k];
      s_u[t] = u[g];
      s_v[t] = v[g];
      s_a[t] = conic_a[g];
      s_b[t] = conic_b[g];
      s_c[t] = conic_c[g];
      s_o[t] = opacities[g];
#pragma unroll
      for (int c = 0; c < C; ++c) s_col[t * C + c] = colors[(int64_t)g * C + c];
    }
    __syncthreads();
    const int cnt = min(kBlock, end - base);
    for (int j = 0; j < cnt && !done; ++j) {
      const float dx = fx - s_u[j];
      const float dy = fy - s_v[j];
      const float sigma = splat_sigma(s_a[j], s_b[j], s_c[j], dx, dy);
      if (sigma < 0.0f) continue;
      const float alpha = fminf(kAlphaClamp, s_o[j] * expf(-sigma));
      if (alpha < kAlphaMin) continue;
      const float next_T = T * (1.0f - alpha);
      if (next_T <= kTStop) {  // stop; this splat is excluded
        done = true;
        break;
      }
      const float w = alpha * T;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += s_col[j * C + c] * w;
      T = next_T;
      if (kTrain) last = base - start + j + 1;
    }
  }
  if (inside) {
    const int64_t p = (int64_t)py * width + px;
#pragma unroll
    for (int c = 0; c < C; ++c) out_colors[p * C + c] = acc[c];
    out_alpha[p] = 1.0f - T;
    if (kTrain) {
      out_T[p] = T;
      out_last[p] = last;
    }
  }
}

// Gradient row of a splat: NG = 8 + C floats, in this order.
constexpr int kGU = 0, kGV = 1, kGA = 2, kGB = 3, kGC = 4, kGO = 5,
              kGAbsU = 6, kGAbsV = 7, kGCol = 8;

template <int C>
__global__ void __launch_bounds__(kBlock)
composite_bwd_kernel(const int32_t* __restrict__ ranges,
                     const int32_t* __restrict__ gids,
                     const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ conic_a,
                     const float* __restrict__ conic_b,
                     const float* __restrict__ conic_c,
                     const float* __restrict__ colors,
                     const float* __restrict__ opacities, int width,
                     int height, int tw, const float* __restrict__ final_T,
                     const int32_t* __restrict__ last,
                     const float* __restrict__ grad_colors,
                     const float* __restrict__ grad_alpha,
                     float* __restrict__ grads) {
  constexpr int NG = kGCol + C;
  __shared__ float s_u[kBlock], s_v[kBlock], s_a[kBlock], s_b[kBlock],
      s_c[kBlock], s_o[kBlock];
  __shared__ float s_col[kBlock * C];
  __shared__ int32_t s_gid[kBlock];
  __shared__ int s_len;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int tile = blockIdx.y * tw + blockIdx.x;
  const int px = blockIdx.x * kTile + t % kTile;
  const int py = blockIdx.y * kTile + t / kTile;
  const bool inside = px < width && py < height;
  const float fx = (float)px + 0.5f;
  const float fy = (float)py + 0.5f;
  const int start = ranges[2 * tile];

  float T = 1.0f, T_N = 1.0f, g_a = 0.0f, S = 0.0f;
  float g_c[C];
  int my_last = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) g_c[c] = 0.0f;
  if (inside) {
    const int64_t p = (int64_t)py * width + px;
    T_N = final_T[p];
    T = T_N;
    my_last = last[p];
    g_a = grad_alpha[p];
#pragma unroll
    for (int c = 0; c < C; ++c) g_c[c] = grad_colors[p * C + c];
  }
  if (t == 0) s_len = 0;
  __syncthreads();
  if (my_last > 0) atomicMax(&s_len, my_last);
  __syncthreads();
  const int len = s_len;  // the longest prefix any pixel of the tile used

  for (int bend = len; bend > 0; bend -= kBlock) {
    const int bstart = max(bend - kBlock, 0);
    const int cnt = bend - bstart;
    __syncthreads();  // the previous batch is fully read
    if (t < cnt) {
      const int g = gids[start + bstart + t];
      s_gid[t] = g;
      s_u[t] = u[g];
      s_v[t] = v[g];
      s_a[t] = conic_a[g];
      s_b[t] = conic_b[g];
      s_c[t] = conic_c[g];
      s_o[t] = opacities[g];
#pragma unroll
      for (int c = 0; c < C; ++c) s_col[t * C + c] = colors[(int64_t)g * C + c];
    }
    __syncthreads();
    for (int j = cnt - 1; j >= 0; --j) {
      float gr[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k) gr[k] = 0.0f;
      bool hit = false;
      if (bstart + j < my_last) {
        const float dx = fx - s_u[j];
        const float dy = fy - s_v[j];
        const float sigma = splat_sigma(s_a[j], s_b[j], s_c[j], dx, dy);
        const float e = expf(-sigma);
        const float raw = s_o[j] * e;
        const float alpha = fminf(kAlphaClamp, raw);
        if (sigma >= 0.0f && alpha >= kAlphaMin) {
          hit = true;
          const float one_m = 1.0f - alpha;
          T = T / one_m;  // T before splat j
          const float w = alpha * T;
          float cg = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            cg += s_col[j * C + c] * g_c[c];
            gr[kGCol + c] = w * g_c[c];
          }
          const float dalpha = T * cg - (S - g_a * T_N) / one_m;
          S += w * cg;
          if (raw < kAlphaClamp) {  // the clamp passes no gradient
            const float dsig = -alpha * dalpha;
            gr[kGU] = -dsig * (s_a[j] * dx + s_b[j] * dy);
            gr[kGV] = -dsig * (s_c[j] * dy + s_b[j] * dx);
            gr[kGA] = 0.5f * dx * dx * dsig;
            gr[kGB] = dx * dy * dsig;
            gr[kGC] = 0.5f * dy * dy * dsig;
            gr[kGO] = dalpha * e;
            gr[kGAbsU] = fabsf(gr[kGU]);
            gr[kGAbsV] = fabsf(gr[kGV]);
          }
        }
      }
      if (!__any_sync(0xffffffffu, hit)) continue;  // warp-uniform
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        float x = gr[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(0xffffffffu, x, off);
        gr[k] = x;
      }
      if (lane == 0) {
        float* row = grads + (int64_t)s_gid[j] * NG;
#pragma unroll
        for (int k = 0; k < NG; ++k) atomicAdd(row + k, gr[k]);
      }
    }
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads1D - 1) / kThreads1D);
}

}  // namespace

extern "C" {

const char* sc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int sc_isect_count(const void* u, const void* v, const void* radii,
                   const void* valid, int n, int tw, int th, void* counts,
                   void* stream) {
  isect_count_kernel<<<blocks_for(n), kThreads1D, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)radii,
      (const uint8_t*)valid, n, tw, th, (int32_t*)counts);
  return (int)cudaGetLastError();
}

int sc_isect_emit(const void* u, const void* v, const void* radii,
                  const void* valid, const void* depths, const void* offsets,
                  int n, int tw, int th, void* keys, void* gids, void* stream) {
  isect_emit_kernel<<<blocks_for(n), kThreads1D, 0, (cudaStream_t)stream>>>(
      (const float*)u, (const float*)v, (const float*)radii,
      (const uint8_t*)valid, (const float*)depths, (const int64_t*)offsets, n,
      tw, th, (int64_t*)keys, (int32_t*)gids);
  return (int)cudaGetLastError();
}

int sc_tile_ranges(const void* keys, long long n_pairs, void* ranges,
                   void* stream) {
  tile_ranges_kernel<<<blocks_for(n_pairs), kThreads1D, 0,
                       (cudaStream_t)stream>>>((const int64_t*)keys,
                                               (int64_t)n_pairs,
                                               (int32_t*)ranges);
  return (int)cudaGetLastError();
}

// out_T and out_last: both null (eval) or both set (training variant).
int sc_composite(const void* ranges, const void* gids, const void* u,
                 const void* v, const void* conic_a, const void* conic_b,
                 const void* conic_c, const void* colors,
                 const void* opacities, int C, int width, int height, int tw,
                 int th, void* out_colors, void* out_alpha, void* out_T,
                 void* out_last, void* stream) {
  const dim3 grid(tw, th);
  cudaStream_t s = (cudaStream_t)stream;
  const bool train = out_T != nullptr;
  if (train != (out_last != nullptr)) return (int)cudaErrorInvalidValue;
#define SC_LAUNCH(CH, TR)                                                   \
  composite_kernel<CH, TR><<<grid, kBlock, 0, s>>>(                         \
      (const int32_t*)ranges, (const int32_t*)gids, (const float*)u,        \
      (const float*)v, (const float*)conic_a, (const float*)conic_b,        \
      (const float*)conic_c, (const float*)colors, (const float*)opacities, \
      width, height, tw, (float*)out_colors, (float*)out_alpha,             \
      (float*)out_T, (int32_t*)out_last)
#define SC_CASE(CH)                \
  case CH:                         \
    if (train)                     \
      SC_LAUNCH(CH, true);         \
    else                           \
      SC_LAUNCH(CH, false);        \
    break;
  switch (C) {
    SC_CASE(1)
    SC_CASE(2)
    SC_CASE(3)
    SC_CASE(4)
    SC_CASE(5)
    SC_CASE(6)
    SC_CASE(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SC_CASE
#undef SC_LAUNCH
  return (int)cudaGetLastError();
}

// grads [N, 8 + C] must be zeroed by the caller (atomics add into it).
int sc_composite_backward(const void* ranges, const void* gids, const void* u,
                          const void* v, const void* conic_a,
                          const void* conic_b, const void* conic_c,
                          const void* colors, const void* opacities, int C,
                          int width, int height, int tw, int th,
                          const void* final_T, const void* last,
                          const void* grad_colors, const void* grad_alpha,
                          void* grads, void* stream) {
  const dim3 grid(tw, th);
  cudaStream_t s = (cudaStream_t)stream;
#define SC_CASE(CH)                                                         \
  case CH:                                                                  \
    composite_bwd_kernel<CH><<<grid, kBlock, 0, s>>>(                       \
        (const int32_t*)ranges, (const int32_t*)gids, (const float*)u,      \
        (const float*)v, (const float*)conic_a, (const float*)conic_b,      \
        (const float*)conic_c, (const float*)colors,                        \
        (const float*)opacities, width, height, tw, (const float*)final_T,  \
        (const int32_t*)last, (const float*)grad_colors,                    \
        (const float*)grad_alpha, (float*)grads);                           \
    break;
  switch (C) {
    SC_CASE(1)
    SC_CASE(2)
    SC_CASE(3)
    SC_CASE(4)
    SC_CASE(5)
    SC_CASE(6)
    SC_CASE(7)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SC_CASE
  return (int)cudaGetLastError();
}

}  // extern "C"
