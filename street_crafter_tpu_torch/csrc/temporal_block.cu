// The temporal transformer stage for Hopper (sm_90a): kernels E and F.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// temporal_block.py. Every entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError(). The Hopper
// building blocks (mbarriers, TMA, wgmma descriptors) are in hopper.cuh;
// every matrix the GEMM reads through TMA needs a 16-byte aligned base.
//
// Kernel E replaces street_crafter_tpu/ops/temporal_block.py:72 _kernel
// (K7): the whole temporal stage of SpatialVideoTransformer at C <= 384,
//   x = h + frame_emb; x += ff_in(LN(x)); x += out(attn_T(LN(x))); x += bias;
//   x += ff(LN(x)); o = a h + (1 - a) x,
// with GEGLU feed-forwards (tanh GELU) and self-attention over the T frames
// of each spatial token. Kernel F replaces temporal_block.py:138
// _attn_kernel (K8): only o = h + out(attn_T(LN(h))) + bias, at
// 384 < C <= 1280, with the feed-forwards left to plain torch around it.
// The TPU kernels keep every weight in VMEM and run the attention as an
// [M, M] product under a strided block-diagonal mask, one grid step per
// [T, rows, C] block. Neither carries over: ff_in's first weight alone is
// 320 x 2560 bf16 = 1.6 MB against 227 KB of shared memory, and a masked
// [M, M] product wastes RS-fold work.
//
// Bound on this card: the products. At the UNet's level 0 (C = 320, 460,800
// tokens) the stage is ~2.6 TFLOP on the tensor cores against ~0.6 GB of
// activations (ops/temporal_block.py::stage_cost counts both); the
// attention over T = 25 is under 1% of the operations. Design: a small
// family of kernels that kernels E and F chain, each reading its operands
// from the (b t) s c layout directly (no transposes):
//   - ln_kernel: one warp per row, statistics in f32 as E[x^2] - mu^2, eps
//     1e-6 (the TPU kernel's _ln); the first LayerNorm also adds the frame
//     embedding and writes x;
//   - gemm_kernel<EPI>: out = A W^T on the tensor cores by wgmma (bf16 in,
//     f32 accumulators in registers), warp-specialised and persistent: a
//     producer thread TMA-loads A [M, K] and W [N, K] (torch Linear layout,
//     K-major like A) in stages of 64 along K (one 128-byte swizzle atom)
//     into a ring of GSTAGES stages with full / empty mbarriers; two
//     consumer warpgroups each run 64 rows x 128 columns by wgmma
//     m64n128k16 with both operands from shared memory. A GEGLU stage
//     carries 64 rows of a and the 64 matching gate rows, so one product
//     gives both. Tiles of 128 x 128 (GEGLU 128 x 64); the blocks in flight
//     share their A rows through L2, and the stage's weights (0.4-3 MB)
//     stay there. TMA zero-fills past M, N and K; the epilogue masks rows
//     >= M and columns >= N. Epilogues run from the accumulator registers straight to bf16
//     stores and fuse what follows each product: bias; GEGLU (out = a
//     gelu_tanh(gate)); the bf16 residual add (in place: each element is
//     read, then written, by one thread); the per-batch cross-attention
//     bias; the AlphaBlender; kernel F's single-rounding h + out + bias.
//     LayerNorm is not folded into the prologue, and the GEGLU
//     intermediate [M, 4C] goes through device memory (later work);
//   - tattn_kernel: attention over the T frames of one (batch, spatial
//     token, head) per warp, T padded to 32, both products on the tensor
//     cores by mma.sync m16n8k16 (a 32 x 32 score tile per group: below
//     wgmma's 64 rows), the softmax in f32 on the fragments.
// Rounding to bf16 follows the TPU kernel: after each LayerNorm, after the
// QKV product, on the softmax probabilities and the attention output, on
// each feed-forward / projection output before its residual add, after the
// bias add, and on the stage output.

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 r16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float rr(float x) { return f(r16(x)); }

// jax.nn.gelu(approximate=True): 0.5 x (1 + tanh(u)), u = sqrt(2 / pi) (x +
// 0.044715 x^3), evaluated as x / (1 + exp(-2 u)), the same function (1 +
// tanh(u) = 2 / (1 + exp(-2 u))): one exponential and one reciprocal where
// tanhf takes a branch and a division, in the GEGLU epilogue's 2 x 64
// values a tile a thread. Its f32 value differs from tanhf's by rounding
// (~1e-7 relative), far below the bf16 rounding that follows.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k2 = 2.f * 0.7978845608028654f;  // 2 sqrt(2 / pi)
  return __fdividef(x, 1.f + __expf(-k2 * (x + 0.044715f * x * x * x)));
}

// ---------------------------------------------------------------- LayerNorm
// y = LN(x) per row of C, f32 statistics. With emb: x = bf16(h + emb[row /
// S]) is formed first and written to x_out. One warp per row, NP bf16 pairs
// a lane (C even, C <= 64 NP): NP follows C, so the row stays in registers
// and the kernel keeps enough warps resident to hide its loads.
template <int NP>
__global__ void ln_kernel(const bf16* __restrict__ h,
                          const bf16* __restrict__ emb, bf16* __restrict__ x_out,
                          bf16* __restrict__ y, const bf16* __restrict__ scale,
                          const bf16* __restrict__ bias, long rows, int C,
                          int S, float eps) {
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int npairs = C >> 1;
  const __nv_bfloat162* hr =
      reinterpret_cast<const __nv_bfloat162*>(h + row * C);
  const __nv_bfloat162* er =
      emb ? reinterpret_cast<const __nv_bfloat162*>(emb + (row / S) * C)
          : nullptr;
  float2 xv[NP];
  float sum = 0.f, sum2 = 0.f;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = i * 32 + lane;
    if (p < npairs) {
      float2 v = __bfloat1622float2(hr[p]);
      if (er) {
        const float2 e = __bfloat1622float2(er[p]);
        v.x = rr(v.x + e.x);
        v.y = rr(v.y + e.y);
        reinterpret_cast<__nv_bfloat162*>(x_out + row * C)[p] =
            __floats2bfloat162_rn(v.x, v.y);
      }
      xv[i] = v;
      sum += v.x + v.y;
      sum2 += v.x * v.x + v.y * v.y;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    sum2 += __shfl_xor_sync(0xffffffffu, sum2, off);
  }
  const float mu = sum / C;
  const float var = sum2 / C - mu * mu;
  const float rs = rsqrtf(var + eps);
  __nv_bfloat162* yr = reinterpret_cast<__nv_bfloat162*>(y + row * C);
  const __nv_bfloat162* sp = reinterpret_cast<const __nv_bfloat162*>(scale);
  const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(bias);
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int p = i * 32 + lane;
    if (p < npairs) {
      const float2 s = __bfloat1622float2(sp[p]);
      const float2 b = __bfloat1622float2(bp[p]);
      yr[p] = __floats2bfloat162_rn((xv[i].x - mu) * rs * s.x + b.x,
                                    (xv[i].y - mu) * rs * s.y + b.y);
    }
  }
}

// --------------------------------------------------------------------- GEMM
// out[M, N] = epilogue(A[M, K] W[N, K]^T). GEGLU: W is [2N, K]; rows [0, N)
// give a, rows [N, 2N) the gate. K % 8 == 0 (16-byte rows); M and N any.
enum Epi {
  EPI_STORE = 0,        // bf16(acc (+ bias))
  EPI_GEGLU = 1,        // bf16((acc_a + b_a) gelu_tanh(acc_g + b_g))
  EPI_RESID = 2,        // bf16(resid + bf16(acc + bias))
  EPI_RESID_BIAS = 3,   // bf16(bf16(resid + bf16(acc + bias)) + rowbias[b])
  EPI_RESID_BLEND = 4,  // x = bf16(resid + bf16(acc + bias));
                        // bf16(alpha h + (1 - alpha) x)
  EPI_ADD_F32 = 5,      // bf16(resid + (acc + bias) + rowbias[b])
};

struct EpiArgs {
  const bf16* bias;     // [N] ([2N] for GEGLU) or null
  const bf16* resid;    // [M, N] (may be the output itself)
  const bf16* rowbias;  // [M / rows_per_batch, N]
  long rows_per_batch;
  const bf16* blend_h;  // [M, N]
  float alpha;
};

constexpr int WG3 = 384;       // a producer warpgroup + two consumers
constexpr int GBM = 128;       // rows of A a tile: two consumers x 64
constexpr int GBK = 64;        // K a stage: one 128-byte swizzle atom
constexpr int GSTAGES = 6;     // 192 KB, ~1.7 us of TMA latency
constexpr uint32_t GA_BYTES = GBM * 128;      // A: 128 rows x 64 bf16
constexpr uint32_t GW_BYTES = 128 * 128;      // W: 128 rows x 64 bf16
constexpr uint32_t GSTAGE = GA_BYTES + GW_BYTES;
// Dynamic shared memory of gemm_kernel: the alignment pad, the ring and its
// full / empty barriers.
constexpr int GEMM_SMEM = 1024 + GSTAGES * GSTAGE + 16 * GSTAGES;

// Output columns a tile: 128, or 64 for GEGLU, whose stage carries 64 rows
// of a and the 64 matching rows of the gate (one m64n128 product gives both)
template <int EPI>
__host__ __device__ constexpr int gemm_bn() {
  return EPI == EPI_GEGLU ? 64 : 128;
}

// Two adjacent bf16 values at p[i] (the second only if `both`; zeros if
// not `ok`), as one bf16 pair.
__device__ __forceinline__ __nv_bfloat162 ld_pair(const bf16* p, long i,
                                                  bool ok, bool both,
                                                  bool vec) {
  if (!ok) return __floats2bfloat162_rn(0.f, 0.f);
  if (vec) return *reinterpret_cast<const __nv_bfloat162*>(p + i);
  __nv_bfloat162 v;
  v.x = p[i];
  v.y = both ? p[i + 1] : __float2bfloat16_rn(0.f);
  return v;
}

// 4 x 4 transpose of 32-bit words across the four lanes of a quad (lanes
// 4 g .. 4 g + 3): lane t's w[c] becomes lane c's w[t]. In the m64nN
// accumulator layout lane t of a quad holds columns 2 t, 2 t + 1 of each
// 8-column group of its row; after the transpose it holds all 8 columns of
// one group, so the epilogue reads and writes device memory in 16-byte
// chunks (a warp instruction then touches 8 rows x 64 bytes, not 8 x 16).
__device__ __forceinline__ void quad_transpose(uint32_t* w, int t4) {
  const bool hi2 = t4 & 2, hi1 = t4 & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // swap the off-diagonal 2 x 2 blocks
    const uint32_t r =
        __shfl_xor_sync(0xffffffffu, hi2 ? w[i] : w[2 + i], 2);
    if (hi2) w[i] = r; else w[2 + i] = r;
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {  // transpose each 2 x 2 block
    const uint32_t r =
        __shfl_xor_sync(0xffffffffu, hi1 ? w[2 * b] : w[2 * b + 1], 1);
    if (hi1) w[2 * b] = r; else w[2 * b + 1] = r;
  }
}

// The 8 bf16 at p[off + cb ..] (columns cb .. cb + 7 of a row of N) as four
// pairs into w[0 .. 3]; columns at or past N, and all if !ok, read as zeros.
__device__ __forceinline__ void ld_chunk(uint32_t* w, const bf16* p, long off,
                                         int cb, int N, bool ok) {
  if (ok && !(N & 7) && cb + 8 <= N) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + off + cb);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    return;
  }
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p + off);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = ok && cb + 2 * e < N ? u[cb + 2 * e] : 0u;
    const uint32_t hi = ok && cb + 2 * e + 1 < N ? u[cb + 2 * e + 1] : 0u;
    w[e] = lo | hi << 16;
  }
}

// Stores the four pairs w[0 .. 3] at columns cb .. cb + 7 (those below N)
// of a row.
__device__ __forceinline__ void st_chunk(bf16* p, long off, int cb, int N,
                                         const uint32_t* w) {
  if (!(N & 7) && cb + 8 <= N) {
    *reinterpret_cast<uint4*>(p + off + cb) =
        make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  unsigned short* u = reinterpret_cast<unsigned short*>(p + off);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (cb + 2 * e < N) u[cb + 2 * e] = (unsigned short)(w[e] & 0xffffu);
    if (cb + 2 * e + 1 < N) u[cb + 2 * e + 1] = (unsigned short)(w[e] >> 16);
  }
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// What the epilogue of one consumer thread's share of a tile reads (rows r0
// and r0 + 8, column pair 2 t4 of the 8-column groups c < BN / 8 from n0):
// the bias pairs, and resid, rowbias and blend_h as 16-byte chunks (lane t4
// of a quad holds group 4 j + t4), turned to the accumulator's layout by
// quad_transpose in epi_store.
template <int EPI>
struct EpiIn {
  static constexpr int NP = gemm_bn<EPI>() / 8;
  static constexpr bool RES = EPI >= EPI_RESID;
  static constexpr bool RB = EPI == EPI_RESID_BIAS || EPI == EPI_ADD_F32;
  static constexpr bool BL = EPI == EPI_RESID_BLEND;
  __nv_bfloat162 bi[NP], gb[EPI == EPI_GEGLU ? NP : 1];
  uint32_t x[2][RES ? NP : 4], rb[2][RB ? NP : 4], hb[2][BL ? NP : 4];
};

// Issues every load of the epilogue; called before the tile's mainloop, so
// the loads are in flight under its products. resid may be out itself: each
// element is read here before epi_store writes it, by the same thread.
template <int EPI>
__device__ __forceinline__ void epi_load(EpiIn<EPI>& in, long r0, int n0,
                                         long M, int N, int t4,
                                         const EpiArgs& ep) {
  using E = EpiIn<EPI>;
  const bool vec = !(N & 1);
#pragma unroll
  for (int c = 0; c < E::NP; ++c) {
    const int gc = n0 + 8 * c + 2 * t4;
    in.bi[c] = ld_pair(ep.bias, gc, gc < N && ep.bias, gc + 1 < N, vec);
    if (EPI == EPI_GEGLU)
      in.gb[c] = ld_pair(ep.bias, N + gc, gc < N && ep.bias, gc + 1 < N, vec);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long row = r0 + 8 * hf;
    const bool ok = row < M;
    const long rbase = E::RB ? row / ep.rows_per_batch * N : 0;
#pragma unroll
    for (int j = 0; j < E::NP / 4; ++j) {  // this lane's chunk: group 4 j + t4
      const int cb = n0 + 8 * (4 * j + t4);
      if (E::RES) ld_chunk(&in.x[hf][4 * j], ep.resid, row * N, cb, N, ok);
      if (E::RB) ld_chunk(&in.rb[hf][4 * j], ep.rowbias, rbase, cb, N, ok);
      if (E::BL) ld_chunk(&in.hb[hf][4 * j], ep.blend_h, row * N, cb, N, ok);
    }
  }
}

// The epilogue from the m64n128 accumulator and what epi_load read, rounded
// to bf16 where the plain version (ops/temporal_block.py) rounds; out is
// written in 16-byte chunks through quad_transpose.
template <int EPI>
__device__ __forceinline__ void epi_store(const float (&acc)[64],
                                          EpiIn<EPI>& in, bf16* out, long r0,
                                          int n0, long M, int N, int t4,
                                          const EpiArgs& ep) {
  using E = EpiIn<EPI>;
  constexpr int NP = E::NP;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const long row = r0 + 8 * hf;
    uint32_t o[NP];
#pragma unroll
    for (int j = 0; j < NP / 4; ++j) {  // chunks to the accumulator layout
      if (E::RES) quad_transpose(&in.x[hf][4 * j], t4);
      if (E::RB) quad_transpose(&in.rb[hf][4 * j], t4);
      if (E::BL) quad_transpose(&in.hb[hf][4 * j], t4);
    }
#pragma unroll
    for (int c = 0; c < NP; ++c) {
      const int i = 4 * c + 2 * hf;  // GEGLU: the gate is 32 registers on
      const float v0 = acc[i], v1 = acc[i + 1];
      const float2 b = __bfloat1622float2(in.bi[c]);
      float q0, q1;
      if (EPI == EPI_STORE) {
        q0 = v0 + b.x;
        q1 = v1 + b.y;
      } else if (EPI == EPI_GEGLU) {
        const float2 g = __bfloat1622float2(in.gb[EPI == EPI_GEGLU ? c : 0]);
        q0 = (v0 + b.x) * gelu_tanh(acc[(i + 32) & 63] + g.x);
        q1 = (v1 + b.y) * gelu_tanh(acc[(i + 33) & 63] + g.y);
      } else {
        const float2 r = unpack(in.x[hf][E::RES ? c : 0]);
        if (EPI == EPI_ADD_F32) {
          const float2 e = unpack(in.rb[hf][E::RB ? c : 0]);
          q0 = __fadd_rn(__fadd_rn(r.x, v0 + b.x), e.x);
          q1 = __fadd_rn(__fadd_rn(r.y, v1 + b.y), e.y);
        } else {
          q0 = r.x + rr(v0 + b.x);
          q1 = r.y + rr(v1 + b.y);
          if (EPI == EPI_RESID_BIAS) {
            const float2 e = unpack(in.rb[hf][E::RB ? c : 0]);
            q0 = rr(q0) + e.x;
            q1 = rr(q1) + e.y;
          } else if (EPI == EPI_RESID_BLEND) {
            const float2 h = unpack(in.hb[hf][E::BL ? c : 0]);
            q0 = __fadd_rn(__fmul_rn(ep.alpha, h.x),
                           __fmul_rn(1.f - ep.alpha, rr(q0)));
            q1 = __fadd_rn(__fmul_rn(ep.alpha, h.y),
                           __fmul_rn(1.f - ep.alpha, rr(q1)));
          }
        }
      }
      o[c] = pack_bf16(q0, q1);
    }
#pragma unroll
    for (int j = 0; j < NP / 4; ++j) {
      quad_transpose(&o[4 * j], t4);
      if (row < M) st_chunk(out, row * N, n0 + 8 * (4 * j + t4), N, &o[4 * j]);
    }
  }
}

// Persistent: each block walks the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... of [M / 128] x [N / BN] (column tiles fastest, so the
// blocks in flight share their A rows through L2); a stage carries 64
// columns of K of both A and W. The producer's ring runs across tiles: it
// loads the next tile's stages while the consumers run this tile's
// epilogue.
template <int EPI>
__global__ void __launch_bounds__(WG3, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tw, bf16* out, long M, int N,
            int K, int n_tiles, long tiles, EpiArgs ep) {
  constexpr int BN = gemm_bn<EPI>();
  extern __shared__ uint8_t smem[];
  const int k_steps = (K + GBK - 1) / GBK;
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;  // stage: A, W
  const uint32_t full = ring + GSTAGES * GSTAGE, empty = full + 8 * GSTAGES;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues the TMA loads
    regs_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (long i = blockIdx.x; i < tiles; i += gridDim.x) {
        const long mt = i / n_tiles;
        // W rows of the column tile: BN nt and 64 on (GEGLU: the gate rows)
        const int w0 = BN * (int)(i - mt * n_tiles);
        const int w1 = EPI == EPI_GEGLU ? N + w0 : w0 + 64;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          mbar_expect_tx(full + 8 * s, GSTAGE);
          const uint32_t sa = ring + s * GSTAGE;
          tma_load_2d(sa, &ta, full + 8 * s, GBK * ks, (int)(GBM * mt));
          tma_load_2d(sa + GA_BYTES, &tw, full + 8 * s, GBK * ks, w0);
          tma_load_2d(sa + GA_BYTES + 64 * 128, &tw, full + 8 * s, GBK * ks,
                      w1);
          if (++s == GSTAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile
    regs_inc<232>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (long i = blockIdx.x; i < tiles; i += gridDim.x) {
      const long mt = i / n_tiles;
      const int nt = (int)(i - mt * n_tiles);
      const long r0 = GBM * mt + 64 * cw + 16 * warp + g;
      EpiIn<EPI> in;
      epi_load<EPI>(in, r0, BN * nt, M, N, t4, ep);
      float acc[64];  // m64n128: rows g and g + 8 of the warp
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(full + 8 * s, phase);
        const uint32_t sa = ring + s * GSTAGE + cw * 64 * 128;
        const uint32_t sw = ring + s * GSTAGE + GA_BYTES;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(acc, desc(sa + 32 * kk, 16, 1024),
                   desc(sw + 32 * kk, 16, 1024), ks + kk > 0);
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();  // the previous stage's products are done
        fence_regs(acc);
        if (ks > 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == GSTAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * prev);
      epi_store<EPI>(acc, in, out, r0, BN * nt, M, N, t4, ep);
    }
  }
}

// ------------------------------------------------------- temporal attention
// qkv: [B*T*S, 3C] in (b t) s c row order (q | k | v, heads of DH each);
// out: [B*T*S, C]. One warp per (b, s, head): the T <= 32 frames padded to
// 32, S = Q K^T and O = P V by mma.sync m16n8k16 (bf16 in, f32
// accumulators), the softmax in f32 on the accumulator fragments; p is
// rounded to bf16 before its product and O once at the store, as the plain
// version rounds them.
constexpr int TMAX = 32;
constexpr int AWARPS = 4;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 bf16 matrices from shared memory (lane l gives the
// address of row l % 8 of matrix l / 8).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int DH>
__global__ void __launch_bounds__(AWARPS * 32)
tattn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T,
             int S, int C, int heads, long groups, float scale) {
  constexpr int VLD = DH + 8;  // V's row stride: ldmatrix rows, distinct banks
  __shared__ __align__(16) bf16 Vs[AWARPS][TMAX * VLD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long gid = (long)blockIdx.x * AWARPS + warp;
  if (gid >= groups) return;
  const int hd = (int)(gid % heads);
  const long bs = gid / heads;
  const long s = bs % S, b = bs / S;
  const long fs = (long)S * 3 * C;  // from one frame's row to the next
  const bf16* q = qkv + (b * T * S + s) * 3L * C + hd * DH;  // frame 0's q
  const bf16* k = q + C;
  bf16* vs = Vs[warp];

  // V [32 frames][DH] into shared memory, frames past T zero
  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  for (int idx = lane; idx < TMAX * CH; idx += 32) {
    const int t = idx / CH, c8 = (idx - t * CH) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) v = *reinterpret_cast<const uint4*>(k + t * fs + C + c8);
    *reinterpret_cast<uint4*>(&vs[t * VLD + c8]) = v;
  }

  // S = Q K^T (query frames x key frames), fragments straight from qkv
  float sc[2][4][4] = {};
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const int d = 16 * ks + 2 * t4;
    uint32_t qa[2][4], kb[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int f0 = 16 * mt + g, f1 = f0 + 8;
      qa[mt][0] = f0 < T ? ld32(q + f0 * fs + d) : 0u;
      qa[mt][1] = f1 < T ? ld32(q + f1 * fs + d) : 0u;
      qa[mt][2] = f0 < T ? ld32(q + f0 * fs + d + 8) : 0u;
      qa[mt][3] = f1 < T ? ld32(q + f1 * fs + d + 8) : 0u;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int f = 8 * nt + g;
      kb[nt][0] = f < T ? ld32(k + f * fs + d) : 0u;
      kb[nt][1] = f < T ? ld32(k + f * fs + d + 8) : 0u;
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma16816(sc[mt][nt], qa[mt], kb[nt][0], kb[nt][1]);
  }

  // softmax over the T key frames of rows g and g + 8 of each m-tile (four
  // lanes share a row); p = bf16(exp(s - max) / sum), packed as the
  // register-A fragments of P V (two k16 steps of 16 key frames)
  uint32_t pa[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float m = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[mt][nt][2 * hf + e];
          x = 8 * nt + 2 * t4 + e < T ? x * scale : -INFINITY;
          m = fmaxf(m, x);
        }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float l = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[mt][nt][2 * hf + e];
          x = expf(x - m);
          l += x;
        }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) sc[mt][nt][2 * hf + e] /= l;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[mt][kk][0] = pack_bf16(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
      pa[mt][kk][1] = pack_bf16(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
      pa[mt][kk][2] = pack_bf16(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
      pa[mt][kk][3] = pack_bf16(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
    }
  }
  __syncwarp();

  // O = P V: V's k16 x n8 fragments by ldmatrix.trans (V is never
  // transposed in memory); two n-tiles per ldmatrix
  float o[2][DH / 8][4] = {};
  const int mtx = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t vb[4];
      const int key = 16 * kk + 8 * (mtx & 1) + r8;
      ldsm_x4_t(vb, smem_u32(&vs[key * VLD + 16 * np + 8 * (mtx >> 1)]));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma16816(o[mt][2 * np], pa[mt][kk], vb[0], vb[1]);
        mma16816(o[mt][2 * np + 1], pa[mt][kk], vb[2], vb[3]);
      }
    }

  bf16* ob = out + (b * T * S + s) * C + hd * DH;  // frame t: + t S C
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int f = 16 * mt + 8 * hf + g;
      if (f >= T) continue;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(ob + f * (long)S * C + 8 * nt +
                                           2 * t4) =
            __floats2bfloat162_rn(o[mt][nt][2 * hf], o[mt][nt][2 * hf + 1]);
    }
}

// ---------------------------------------------------------------- launchers
template <int NP>
int ln_launch(const bf16* h, const bf16* emb, bf16* x_out, bf16* y,
              const bf16* s, const bf16* b, long rows, int C, int S,
              cudaStream_t st) {
  const int warps = 8;
  ln_kernel<NP><<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0,
                  st>>>(h, emb, x_out, y, s, b, rows, C, S, 1e-6f);
  return (int)cudaGetLastError();
}

// LayerNorm of rows of C <= 2048 (C even), NP = the pairs a lane holds.
int ln(const bf16* h, const bf16* emb, bf16* x_out, bf16* y, const bf16* s,
       const bf16* b, long rows, int C, int S, cudaStream_t st) {
  if (C % 2 || C <= 0) return (int)cudaErrorInvalidValue;
  const int np = (C / 2 + 31) / 32;
  if (np <= 1) return ln_launch<1>(h, emb, x_out, y, s, b, rows, C, S, st);
  if (np <= 2) return ln_launch<2>(h, emb, x_out, y, s, b, rows, C, S, st);
  if (np <= 5) return ln_launch<5>(h, emb, x_out, y, s, b, rows, C, S, st);
  if (np <= 10) return ln_launch<10>(h, emb, x_out, y, s, b, rows, C, S, st);
  if (np <= 20) return ln_launch<20>(h, emb, x_out, y, s, b, rows, C, S, st);
  if (np <= 32) return ln_launch<32>(h, emb, x_out, y, s, b, rows, C, S, st);
  return (int)cudaErrorInvalidValue;
}

// The 2-D TMA map of a row-major [rows, cols] bf16 matrix, box {64,
// box_rows}, 128-byte swizzled; elements past either edge read as zeros.
int matrix_map(CUtensorMap* map, const void* ptr, long rows, int cols,
               int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int sm_count(int* n) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *n = count;
  return 0;
}

template <int EPI>
int gemm(const bf16* A, const bf16* W, bf16* out, long M, int N, int K,
         const EpiArgs& ep, cudaStream_t st) {
  if (K % 8 || K <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  constexpr int BN = gemm_bn<EPI>();
  CUtensorMap ma, mw;
  int err = matrix_map(&ma, A, M, K, GBM);
  if (!err) err = matrix_map(&mw, W, EPI == EPI_GEGLU ? 2L * N : N, K, 64);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const int n_tiles = (N + BN - 1) / BN;
  const long tiles = (M + GBM - 1) / GBM * n_tiles;
  cudaError_t e = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      GEMM_SMEM);
  if (e != cudaSuccess) return (int)e;
  gemm_kernel<EPI><<<(unsigned)(tiles < sms ? tiles : sms), WG3, GEMM_SMEM,
                     st>>>(ma, mw, out, M, N, K, n_tiles, tiles, ep);
  return (int)cudaGetLastError();
}

int tattn(const bf16* qkv, bf16* out, int B, int T, int S, int C, int heads,
          cudaStream_t st) {
  const int dh = C / heads;
  if (T > TMAX || dh * heads != C) return (int)cudaErrorInvalidValue;
  const long groups = (long)B * S * heads;
  const unsigned blocks = (unsigned)((groups + AWARPS - 1) / AWARPS);
  const float scale = 1.f / sqrtf((float)dh);
  switch (dh) {
    case 16:
      tattn_kernel<16><<<blocks, AWARPS * 32, 0, st>>>(qkv, out, T, S, C,
                                                       heads, groups, scale);
      break;
    case 32:
      tattn_kernel<32><<<blocks, AWARPS * 32, 0, st>>>(qkv, out, T, S, C,
                                                       heads, groups, scale);
      break;
    case 64:
      tattn_kernel<64><<<blocks, AWARPS * 32, 0, st>>>(qkv, out, T, S, C,
                                                       heads, groups, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#define SC_TRY(call)                \
  do {                              \
    const int e_ = (call);          \
    if (e_ != 0) return e_;         \
  } while (0)

}  // namespace

extern "C" {

const char* sc_temporal_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One GEMM of the chains below, launched alone, so that it can be timed
// and held against its plain version (chip_smoke.py, tests).
// out [M, N] = epilogue `epi` (enum Epi) of a [M, K] w^T, w [N, K] ([2N, K]
// for GEGLU); bias, resid, rowbias, blend_h as EpiArgs (null where the
// epilogue reads none).
int sc_temporal_gemm(int epi, const void* a, const void* w, void* out,
                     long long M, int N, int K, const void* bias,
                     const void* resid, const void* rowbias,
                     long long rows_per_batch, const void* blend_h,
                     float alpha, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  auto P = [](const void* p) { return (const bf16*)p; };
  const EpiArgs ep{P(bias), P(resid), P(rowbias), (long)rows_per_batch,
                   P(blend_h), alpha};
  const bf16 *A = P(a), *W = P(w);
  bf16* o = (bf16*)out;
  switch (epi) {
    case EPI_STORE: return gemm<EPI_STORE>(A, W, o, M, N, K, ep, st);
    case EPI_GEGLU: return gemm<EPI_GEGLU>(A, W, o, M, N, K, ep, st);
    case EPI_RESID: return gemm<EPI_RESID>(A, W, o, M, N, K, ep, st);
    case EPI_RESID_BIAS:
      return gemm<EPI_RESID_BIAS>(A, W, o, M, N, K, ep, st);
    case EPI_RESID_BLEND:
      return gemm<EPI_RESID_BLEND>(A, W, o, M, N, K, ep, st);
    case EPI_ADD_F32: return gemm<EPI_ADD_F32>(A, W, o, M, N, K, ep, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Kernel E. h, out: [B*T*S, C]; emb: [B*T, C]; bias: [B, C]; weights in
// torch Linear layout. Scratch (allocated by the caller): x, y: [M, C];
// big: [M, max(3C, 4C)] for the QKV and GEGLU intermediates; att: [M, C].
int sc_temporal_block(const void* h, const void* emb, const void* bias,
                      float alpha, const void* nin_s, const void* nin_b,
                      const void* fi_w1, const void* fi_b1, const void* fi_w2,
                      const void* fi_b2, const void* n1_s, const void* n1_b,
                      const void* wqkv, const void* wout, const void* bout,
                      const void* n3_s, const void* n3_b, const void* ff_w1,
                      const void* ff_b1, const void* ff_w2, const void* ff_b2,
                      void* out, void* x, void* y, void* big, void* att,
                      int B, int T, int S, int C, int heads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)B * T * S;
  const int inner = 4 * C;
  auto P = [](const void* p) { return (const bf16*)p; };
  bf16 *xp = (bf16*)x, *yp = (bf16*)y, *gp = (bf16*)big, *ap = (bf16*)att;
  EpiArgs ep{};
  // x = h + emb; y = LN_in(x)
  SC_TRY(ln(P(h), P(emb), xp, yp, P(nin_s), P(nin_b), M, C, S, st));
  // x += ff_in(y)
  ep = EpiArgs{P(fi_b1), nullptr, nullptr, 1, nullptr, 0.f};
  SC_TRY(gemm<EPI_GEGLU>(yp, P(fi_w1), gp, M, inner, C, ep, st));
  ep = EpiArgs{P(fi_b2), xp, nullptr, 1, nullptr, 0.f};
  SC_TRY(gemm<EPI_RESID>(gp, P(fi_w2), xp, M, C, inner, ep, st));
  // x += out(attn_T(LN1(x))) ; x += bias
  SC_TRY(ln(xp, nullptr, nullptr, yp, P(n1_s), P(n1_b), M, C, S, st));
  ep = EpiArgs{nullptr, nullptr, nullptr, 1, nullptr, 0.f};
  SC_TRY(gemm<EPI_STORE>(yp, P(wqkv), gp, M, 3 * C, C, ep, st));
  SC_TRY(tattn(gp, ap, B, T, S, C, heads, st));
  ep = EpiArgs{P(bout), xp, P(bias), (long)T * S, nullptr, 0.f};
  SC_TRY(gemm<EPI_RESID_BIAS>(ap, P(wout), xp, M, C, C, ep, st));
  // out = a h + (1 - a) (x + ff(LN3(x)))
  SC_TRY(ln(xp, nullptr, nullptr, yp, P(n3_s), P(n3_b), M, C, S, st));
  ep = EpiArgs{P(ff_b1), nullptr, nullptr, 1, nullptr, 0.f};
  SC_TRY(gemm<EPI_GEGLU>(yp, P(ff_w1), gp, M, inner, C, ep, st));
  ep = EpiArgs{P(ff_b2), xp, nullptr, 1, P(h), alpha};
  SC_TRY(gemm<EPI_RESID_BLEND>(gp, P(ff_w2), (bf16*)out, M, C, inner, ep,
                               st));
  return 0;
}

// Kernel F. out = h + out_proj(attn_T(LN1(h))) + bias[b]. Scratch: y, att:
// [M, C]; qkv: [M, 3C].
int sc_temporal_attention(const void* h, const void* bias, const void* n1_s,
                          const void* n1_b, const void* wqkv, const void* wout,
                          const void* bout, void* out, void* y, void* qkv,
                          void* att, int B, int T, int S, int C, int heads,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long M = (long)B * T * S;
  auto P = [](const void* p) { return (const bf16*)p; };
  bf16 *yp = (bf16*)y, *qp = (bf16*)qkv, *ap = (bf16*)att;
  EpiArgs ep{};
  SC_TRY(ln(P(h), nullptr, nullptr, yp, P(n1_s), P(n1_b), M, C, S, st));
  SC_TRY(gemm<EPI_STORE>(yp, P(wqkv), qp, M, 3 * C, C, ep, st));
  SC_TRY(tattn(qp, ap, B, T, S, C, heads, st));
  ep = EpiArgs{P(bout), P(h), P(bias), (long)T * S, nullptr, 0.f};
  SC_TRY(gemm<EPI_ADD_F32>(ap, P(wout), (bf16*)out, M, C, C, ep, st));
  return 0;
}

}  // extern "C"
