// Attention forward and backward for Hopper (sm_90a): kernels D, G and H.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// flash_attention.py. Every entry launches on the caller's stream,
// allocates nothing, does not synchronise and returns cudaGetLastError().
// q, o, dq, do: [B, Sq, H, D]; k, v, dk, dv: [B, Skv, H, D]; all bf16,
// read and written with the row stride H*D (the layout the UNet's
// projections produce), so no transpose is needed. lse, delta: [B, H, Sq]
// f32. Everything is non-causal, with f32 scores, softmax and accumulators,
// on the tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//
// Kernel D replaces street_crafter_tpu/ops/flash_attention.py:29
// _flash_kernel (K4), the TPU's online-softmax forward: q blocks over the
// grid, the whole (padded) K/V resident in VMEM, a ones column in V to get
// the softmax denominator out of the PV matmul, and the power-of-two scale
// folded into q. It computes o = softmax(q k^T * scale) v per (batch, head)
// and, in its training form (sc_flash_forward_lse), the logsumexp
// lse = m + log(l) of each query row, which the backward needs; the
// sampling path writes no lse (the JAX package's need_lse=False).
//
// Bound on this card: the two products, 4 * Sq * Skv * D operations per
// (batch, head) on the tensor cores; the bytes (q, k, v read once, o written
// once) are ~1/500 of that at the UNet's S = 9216, so the kernel is compute
// bound. Design (FlashAttention-2's layout, without its pipelining):
//   - one block of 4 warps per (batch*head, 64-row q tile); each warp owns
//     16 q rows and keeps its Q fragments in registers for the whole kv loop;
//   - K and V tiles of 64 keys are staged through shared memory (V stored
//     transposed so its mma B fragments are single 32-bit loads; rows past
//     Skv are zero, so the ragged kv edge adds nothing);
//   - S = Q K^T and O += P V on the tensor cores; the score fragments are
//     reused in registers as the A operand of P V (the accumulator layout of
//     two n8 tiles is the A layout of one k16 step);
//   - the online softmax runs on the score fragments in f32: row max and
//     row sum over the four threads that share a row (shuffles), the running
//     output rescaled by exp(m_old - m_new) on each new tile;
//   - columns past Skv get -inf before the max; rows past Sq are computed on
//     zero queries and not stored (the ragged q edge).
//
// Kernel G replaces flash_attention.py:195 _bwd_dkv_kernel (K5): dK and dV
// of one block of 64 keys, with q, dO, lse and delta streaming in tiles and
// p recomputed from lse (no [Sq, Skv] tensor touches device memory):
//   p = exp(s * scale - lse), dV += p^T dO, dp = dO v^T,
//   ds = p * (dp - delta) * scale, dK += ds^T q.
// Kernel H replaces flash_attention.py:246 _bwd_dq_kernel (K6): dQ of one
// block of 64 queries, with k and v streaming: dQ += ds k.
// Both are computed in the TPU kernels' order (G key-major, so its score
// tile is k q^T), with p and ds rounded to bf16 before their products, as
// the TPU kernels round them. Bounds: G does 8 * Sq * Skv * D operations
// per (batch, head) (four products), H 6 * Sq * Skv * D (three), both on
// the tensor cores; compute bound at the UNet's sequence lengths. Design,
// the forward's, turned around:
//   - G: one block of 4 warps per (batch*head, 64-key tile); each warp owns
//     16 keys and keeps their K and V fragments in registers, the dK and dV
//     accumulators too; each q tile (64 queries, 32 at head dim 128) is
//     staged in shared memory twice, row-major (the B operand of k q^T and
//     v dO^T) and transposed (the B operand of p^T dO and ds^T q), with its
//     lse and delta. Queries past Sq are zero and their p is forced to 0
//     (the JAX code pads lse with +1e30 and masks the rows: ragged Sq must
//     not reach dK or dV); keys past Skv are zero and not stored;
//   - H: one block of 4 warps per (batch*head, 64-query tile); each warp
//     owns 16 queries and keeps their Q and dO fragments, lse and delta in
//     registers; each kv tile (64 keys, 32 at head dim 128) is staged
//     row-major (the B operand of q k^T and dO v^T) and K also transposed
//     (the B operand of ds k). Keys past Skv get s = -inf, so p = 0;
//   - delta = rowsum(dO * O) is one torch op in the wrapper (f32), as the
//     JAX package computes it outside its kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block: 4 warps x 16
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Skv, float scale) {
  constexpr int KPAD = D + 8;   // Ks row stride (bf16): conflict-free reads
  constexpr int VPAD = BK + 8;  // Vt row stride (bf16)
  __shared__ __align__(16) __nv_bfloat16 Ks[BK * KPAD];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * VPAD];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long rs = (long)H * D;  // elements between consecutive positions
  const __nv_bfloat16* qb = q + ((long)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long)b * Skv * H + h) * D;
  const __nv_bfloat16* vb = v + ((long)b * Skv * H + h) * D;
  __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * D;

  // this thread's two q rows (g and g + 8 of the warp's 16)
  const int r0 = blockIdx.y * BQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t4;
    qa[ks][0] = r0 < Sq ? ld32(qb + r0 * rs + c) : 0u;
    qa[ks][1] = r1 < Sq ? ld32(qb + r1 * rs + c) : 0u;
    qa[ks][2] = r0 < Sq ? ld32(qb + r0 * rs + c + 8) : 0u;
    qa[ks][3] = r1 < Sq ? ld32(qb + r1 * rs + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < BK * D / 8; idx += THREADS) {
      const int r = idx / (D / 8), c8 = (idx - r * (D / 8)) * 8;
      const int key = kv0 + r;
      uint4 k4 = make_uint4(0u, 0u, 0u, 0u), v4 = k4;
      if (key < Skv) {
        k4 = *reinterpret_cast<const uint4*>(kb + key * rs + c8);
        v4 = *reinterpret_cast<const uint4*>(vb + key * rs + c8);
      }
      *reinterpret_cast<uint4*>(&Ks[r * KPAD + c8]) = k4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&v4);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c8 + e) * VPAD + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const __nv_bfloat16* kr = &Ks[(nt * 8 + g) * KPAD + ks * 16 + 2 * t4];
        mma_bf16(s[nt], qa[ks], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask the ragged kv edge, online softmax in f32
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * t4 + (e & 1);
        s[nt][e] = col < Skv ? s[nt][e] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - m0);
      s[nt][1] = expf(s[nt][1] - m0);
      s[nt][2] = expf(s[nt][2] - m1);
      s[nt][3] = expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }

    // O += P V: P (bf16) straight from the score fragments
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vr = &Vt[(dt * 8 + g) * VPAD + j * 16 + 2 * t4];
        mma_bf16(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (LSE && t4 == 0) {
    float* lrow = lse + (long)bh * Sq;
    if (r0 < Sq) lrow[r0] = m0 + logf(l0);
    if (r1 < Sq) lrow[r1] = m1 + logf(l1);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * rs + c) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * rs + c) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

// ---------------------------------------------------------------- backward

// Stage rows [r0, r0 + R) of one (batch, head) of a [B, S, H, D] tensor
// into shared memory: row-major at `rows` (stride D + 8) and, when `cols` is
// not null, transposed at `cols` (stride R + 8). Rows past S are zero.
template <int D, int R>
__device__ __forceinline__ void stage_tile(const __nv_bfloat16* base,
                                           long rs, int r0, int S,
                                           __nv_bfloat16* rows,
                                           __nv_bfloat16* cols) {
  for (int idx = threadIdx.x; idx < R * D / 8; idx += THREADS) {
    const int r = idx / (D / 8), c8 = (idx - r * (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      x = *reinterpret_cast<const uint4*>(base + (long)(r0 + r) * rs + c8);
    *reinterpret_cast<uint4*>(&rows[r * (D + 8) + c8]) = x;
    if (cols != nullptr) {
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) cols[(c8 + e) * (R + 8) + r] = xe[e];
    }
  }
}

// A fragments (16 rows x D) of the rows ra, ra + 8 of a [B, S, H, D] slice,
// zero past S.
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[D / 16][4],
                                       const __nv_bfloat16* base, long rs,
                                       int ra, int S, int t4) {
  const int rb = ra + 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t4;
    a[ks][0] = ra < S ? ld32(base + ra * rs + c) : 0u;
    a[ks][1] = rb < S ? ld32(base + rb * rs + c) : 0u;
    a[ks][2] = ra < S ? ld32(base + ra * rs + c + 8) : 0u;
    a[ks][3] = rb < S ? ld32(base + rb * rs + c + 8) : 0u;
  }
}

// C (16 x N) = A (16 x D, fragments) * B^T, B row-major in shared memory
// [N][D + 8]: N / 8 accumulator tiles.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float c[N / 8][4],
                                        const uint32_t a[D / 16][4],
                                        const __nv_bfloat16* b, int g,
                                        int t4) {
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const __nv_bfloat16* br = &b[(nt * 8 + g) * (D + 8) + ks * 16 + 2 * t4];
      mma_bf16(c[nt], a[ks], ld32(br), ld32(br + 8));
    }
  }
}

// acc (16 x D) += P (16 x N, bf16 from accumulator tiles) * B, B stored
// transposed in shared memory [D][N + 8].
template <int D, int N>
__device__ __forceinline__ void mma_pb(float acc[D / 8][4],
                                       const float p[N / 8][4],
                                       const __nv_bfloat16* bt, int g,
                                       int t4) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                            pack_bf16(p[2 * j][2], p[2 * j][3]),
                            pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                            pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const __nv_bfloat16* br = &bt[(dt * 8 + g) * (N + 8) + j * 16 + 2 * t4];
      mma_bf16(acc[dt], pa, ld32(br), ld32(br + 8));
    }
  }
}

// Store a 16 x D f32 accumulator as bf16 rows ra, ra + 8 (those below S).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long rs,
                                           const float acc[D / 8][4], int ra,
                                           int S, int t4) {
  const int rb = ra + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (ra < S)
      *reinterpret_cast<uint32_t*>(base + ra * rs + c) =
          pack_bf16(acc[dt][0], acc[dt][1]);
    if (rb < S)
      *reinterpret_cast<uint32_t*>(base + rb * rs + c) =
          pack_bf16(acc[dt][2], acc[dt][3]);
  }
}

// Kernel G: dK, dV of 64 keys (16 per warp); q tiles of BQT queries stream.
template <int D, int BQT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv,
                     float scale) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BQT * (D + 8)];
  __shared__ __align__(16) __nv_bfloat16 Qt[D * (BQT + 8)];
  __shared__ __align__(16) __nv_bfloat16 Os[BQT * (D + 8)];   // dO
  __shared__ __align__(16) __nv_bfloat16 Ot[D * (BQT + 8)];   // dO^T
  __shared__ float Ls[BQT], Ds[BQT];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long rs = (long)H * D;
  const long qoff = ((long)b * Sq * H + h) * D;
  const long koff = ((long)b * Skv * H + h) * D;
  const float* lrow = lse + (long)bh * Sq;
  const float* drow = delta + (long)bh * Sq;

  const int k0 = blockIdx.y * BQ + warp * 16 + g;   // this thread's keys
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a<D>(ka, k + koff, rs, k0, Skv, t4);
  load_a<D>(va, v + koff, rs, k0, Skv, t4);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dt][e] = dva[dt][e] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += BQT) {
    __syncthreads();  // the previous tile's readers are done
    stage_tile<D, BQT>(q + qoff, rs, q0, Sq, Qs, Qt);
    stage_tile<D, BQT>(dout + qoff, rs, q0, Sq, Os, Ot);
    for (int i = threadIdx.x; i < BQT; i += THREADS) {
      const bool in = q0 + i < Sq;
      Ls[i] = in ? lrow[q0 + i] : 0.f;
      Ds[i] = in ? drow[q0 + i] : 0.f;
    }
    __syncthreads();

    // p^T = exp(k q^T * scale - lse): 16 keys x BQT queries per warp
    float p[BQT / 8][4], dp[BQT / 8][4];
    mma_abt<D, BQT>(p, ka, Qs, g, t4);
    mma_abt<D, BQT>(dp, va, Os, g, t4);   // (dO v^T)^T = v dO^T
#pragma unroll
    for (int nt = 0; nt < BQT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);
        const float pe = q0 + c < Sq ? expf(p[nt][e] * scale - Ls[c]) : 0.f;
        p[nt][e] = pe;
        // ds^T = p^T (dp^T - delta) * scale, rounded to bf16 in mma_pb
        dp[nt][e] = pe * (dp[nt][e] - Ds[c]) * scale;
      }
    }
    mma_pb<D, BQT>(dva, p, Ot, g, t4);    // dV += p^T dO
    mma_pb<D, BQT>(dka, dp, Qt, g, t4);   // dK += ds^T q
  }
  store_rows<D>(dk + koff, rs, dka, k0, Skv, t4);
  store_rows<D>(dv + koff, rs, dva, k0, Skv, t4);
}

// Kernel H: dQ of 64 queries (16 per warp); kv tiles of BKT keys stream.
template <int D, int BKT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv,
                    float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BKT * (D + 8)];
  __shared__ __align__(16) __nv_bfloat16 Kt[D * (BKT + 8)];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKT * (D + 8)];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long rs = (long)H * D;
  const long qoff = ((long)b * Sq * H + h) * D;
  const long koff = ((long)b * Skv * H + h) * D;

  const int r0 = blockIdx.y * BQ + warp * 16 + g, r1 = r0 + 8;
  uint32_t qa[D / 16][4], oa[D / 16][4];
  load_a<D>(qa, q + qoff, rs, r0, Sq, t4);
  load_a<D>(oa, dout + qoff, rs, r0, Sq, t4);
  const float* lrow = lse + (long)bh * Sq;
  const float* drow = delta + (long)bh * Sq;
  const float ls0 = r0 < Sq ? lrow[r0] : 0.f, ls1 = r1 < Sq ? lrow[r1] : 0.f;
  const float dl0 = r0 < Sq ? drow[r0] : 0.f, dl1 = r1 < Sq ? drow[r1] : 0.f;
  float dqa[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BKT) {
    __syncthreads();
    stage_tile<D, BKT>(k + koff, rs, kv0, Skv, Ks, Kt);
    stage_tile<D, BKT>(v + koff, rs, kv0, Skv, Vs, nullptr);
    __syncthreads();

    float p[BKT / 8][4], dp[BKT / 8][4];
    mma_abt<D, BKT>(p, qa, Ks, g, t4);    // q k^T
    mma_abt<D, BKT>(dp, oa, Vs, g, t4);   // dO v^T
#pragma unroll
    for (int nt = 0; nt < BKT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + 2 * t4 + (e & 1);
        const float lsr = e < 2 ? ls0 : ls1, dlr = e < 2 ? dl0 : dl1;
        const float pe = col < Skv ? expf(p[nt][e] * scale - lsr) : 0.f;
        dp[nt][e] = pe * (dp[nt][e] - dlr) * scale;   // ds
      }
    }
    mma_pb<D, BKT>(dqa, dp, Kt, g, t4);   // dQ += ds k
  }
  store_rows<D>(dq + qoff, rs, dqa, r0, Sq, t4);
}

}  // namespace

namespace {

template <bool LSE>
int forward(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int H, int Sq, int Skv, int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  cudaStream_t st = (cudaStream_t)stream;
  const auto* qp = (const __nv_bfloat16*)q;
  const auto* kp = (const __nv_bfloat16*)k;
  const auto* vp = (const __nv_bfloat16*)v;
  auto* op = (__nv_bfloat16*)o;
  if (D == 64)
    flash_fwd_kernel<64, LSE><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, lse,
                                                        H, Sq, Skv, scale);
  else if (D == 128)
    flash_fwd_kernel<128, LSE><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, lse,
                                                         H, Sq, Skv, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sc_flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o: [B, Sq, H, D]; k, v: [B, Skv, H, D]; bf16, contiguous. D: 64 or 128.
int sc_flash_forward(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Sq, int Skv, int D, float scale,
                     void* stream) {
  return forward<false>(q, k, v, o, nullptr, B, H, Sq, Skv, D, scale,
                        stream);
}

// The same, also writing lse [B, H, Sq] f32 (the training forward).
int sc_flash_forward_lse(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Sq, int Skv, int D,
                         float scale, void* stream) {
  return forward<true>(q, k, v, o, (float*)lse, B, H, Sq, Skv, D, scale,
                       stream);
}

// Kernel G: dk, dv [B, Skv, H, D] bf16 from q, do [B, Sq, H, D], k, v,
// lse and delta [B, H, Sq] f32.
int sc_flash_backward_dkv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B, int H,
                          int Sq, int Skv, int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((Skv + BQ - 1) / BQ));
  cudaStream_t st = (cudaStream_t)stream;
  const auto* qp = (const __nv_bfloat16*)q;
  const auto* kp = (const __nv_bfloat16*)k;
  const auto* vp = (const __nv_bfloat16*)v;
  const auto* op = (const __nv_bfloat16*)dout;
  const auto* lp = (const float*)lse;
  const auto* dp = (const float*)delta;
  auto* dkp = (__nv_bfloat16*)dk;
  auto* dvp = (__nv_bfloat16*)dv;
  if (D == 64)
    flash_bwd_dkv_kernel<64, 64><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, op, lp, dp, dkp, dvp, H, Sq, Skv, scale);
  else if (D == 128)
    flash_bwd_dkv_kernel<128, 32><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, op, lp, dp, dkp, dvp, H, Sq, Skv, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Kernel H: dq [B, Sq, H, D] bf16 from the same inputs.
int sc_flash_backward_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int H, int Sq, int Skv, int D,
                         float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  cudaStream_t st = (cudaStream_t)stream;
  const auto* qp = (const __nv_bfloat16*)q;
  const auto* kp = (const __nv_bfloat16*)k;
  const auto* vp = (const __nv_bfloat16*)v;
  const auto* op = (const __nv_bfloat16*)dout;
  const auto* lp = (const float*)lse;
  const auto* dp = (const float*)delta;
  auto* dqp = (__nv_bfloat16*)dq;
  if (D == 64)
    flash_bwd_dq_kernel<64, 64><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, op, lp, dp, dqp, H, Sq, Skv, scale);
  else if (D == 128)
    flash_bwd_dq_kernel<128, 32><<<grid, THREADS, 0, st>>>(
        qp, kp, vp, op, lp, dp, dqp, H, Sq, Skv, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
