// The temporal transformer stage for Hopper (sm_90a): kernels E and F.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// temporal_block.py. Every entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().
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
//   - gemm_kernel<EPI>: out = A W^T on the tensor cores (nvcuda::wmma
//     16x16x16, bf16 in, f32 accumulate), 128x64 tiles, A and W staged
//     through shared memory with the next K slice prefetched into registers.
//     The weights (torch Linear layout [out, in]) stream from L2, where all
//     of a stage's weights fit. Epilogues fuse what follows each product:
//     bias; GEGLU (two accumulators, a and gate, out = a gelu_tanh(gate));
//     the bf16 residual add; the per-batch cross-attention bias; the
//     AlphaBlender; kernel F's single-rounding h + out + bias;
//   - tattn_kernel: attention over the T frames of one (batch, spatial
//     token, head) per warp, one query frame per lane, in f32 on the CUDA
//     cores (25 x 25 scores per group: too small for a tensor-core tile).
// Rounding to bf16 follows the TPU kernel: after each LayerNorm, after the
// QKV product, on the softmax probabilities and the attention output, on
// each feed-forward / projection output before its residual add, after the
// bias add, and on the stage output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

__device__ __forceinline__ float f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 r16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float rr(float x) { return f(r16(x)); }

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True)
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// ---------------------------------------------------------------- LayerNorm
// y = LN(x) per row of C, f32 statistics. With emb: x = bf16(h + emb[row /
// S]) is formed first and written to x_out. One warp per row; C even,
// C <= 2 * 32 * MAXP.
constexpr int MAXP = 32;

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
  float2 xv[MAXP];
  float sum = 0.f, sum2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAXP; ++i) {
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
  for (int i = 0; i < MAXP; ++i) {
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

constexpr int GBM = 128, GBN = 64, GBK = 32, GTHREADS = 256;
constexpr int ALD = GBK + 8;  // smem row stride (bf16) of the A and W tiles
constexpr int CLD = GBN + 4;  // smem row stride (f32) of the output tile

template <int EPI>
__host__ __device__ constexpr int gemm_nacc() { return EPI == EPI_GEGLU ? 2 : 1; }

template <int EPI>
__host__ __device__ constexpr size_t gemm_smem() {
  const size_t stage = (size_t)(GBM + gemm_nacc<EPI>() * GBN) * ALD * 2;
  const size_t out = (size_t)gemm_nacc<EPI>() * GBM * CLD * 4;
  return stage > out ? stage : out;
}

template <int EPI>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
            bf16* out, long M, int N, int K, EpiArgs ep) {
  constexpr int NACC = gemm_nacc<EPI>();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [GBM][ALD]
  bf16* Ws = As + GBM * ALD;                 // [NACC][GBN][ALD]
  float* Cs = reinterpret_cast<float*>(smem);  // after the loop

  const long m0 = (long)blockIdx.x * GBM;
  const int n0 = blockIdx.y * GBN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // 4 x 2 warps, 32 x 32 each

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NACC][2][2];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[a][i][j], 0.f);

  // per thread: 2 chunks of A (128 rows x 4 chunks of 8) and NACC of W
  uint4 ra[2], rw[NACC];
  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = threadIdx.x + c * GTHREADS;
      const int r = idx >> 2, kc = (idx & 3) * 8;
      const long gr = m0 + r;
      ra[c] = (gr < M && k0 + kc < K)
                  ? *reinterpret_cast<const uint4*>(A + gr * K + k0 + kc)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      const int r = threadIdx.x >> 2, kc = (threadIdx.x & 3) * 8;
      const int gn = n0 + r;
      rw[a] = (gn < N && k0 + kc < K)
                  ? *reinterpret_cast<const uint4*>(
                        W + ((long)a * N + gn) * K + k0 + kc)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int idx = threadIdx.x + c * GTHREADS;
      *reinterpret_cast<uint4*>(&As[(idx >> 2) * ALD + (idx & 3) * 8]) = ra[c];
    }
#pragma unroll
    for (int a = 0; a < NACC; ++a)
      *reinterpret_cast<uint4*>(
          &Ws[(a * GBN + (threadIdx.x >> 2)) * ALD + (threadIdx.x & 3) * 8]) =
          rw[a];
  };

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += GBK) {
    const bool more = k0 + GBK < K;
    if (more) load(k0 + GBK);
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * ALD + kk, ALD);
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(
              fb, Ws + (a * GBN + wn * 32 + j * 16) * ALD + kk, ALD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc[a][i][j], fa[i], fb, acc[a][i][j]);
        }
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(
            Cs + a * GBM * CLD + (wm * 32 + i * 16) * CLD + wn * 32 + j * 16,
            acc[a][i][j], CLD, wmma::mem_row_major);
  __syncthreads();

  for (int e = threadIdx.x; e < GBM * GBN; e += GTHREADS) {
    const int r = e / GBN, c = e - r * GBN;
    const long gr = m0 + r;
    const int gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const float v = Cs[r * CLD + c];
    const long o = gr * N + gc;
    const float b = ep.bias ? f(ep.bias[gc]) : 0.f;
    float res;
    if (EPI == EPI_STORE) {
      res = v + b;
    } else if (EPI == EPI_GEGLU) {
      const float g = Cs[GBM * CLD + r * CLD + c] + f(ep.bias[N + gc]);
      res = (v + b) * gelu_tanh(g);
    } else if (EPI == EPI_RESID) {
      res = f(ep.resid[o]) + rr(v + b);
    } else if (EPI == EPI_RESID_BIAS) {
      const float x = rr(f(ep.resid[o]) + rr(v + b));
      res = x + f(ep.rowbias[(gr / ep.rows_per_batch) * N + gc]);
    } else if (EPI == EPI_RESID_BLEND) {
      const float x = rr(f(ep.resid[o]) + rr(v + b));
      res = __fadd_rn(__fmul_rn(ep.alpha, f(ep.blend_h[o])),
                      __fmul_rn(1.f - ep.alpha, x));
    } else {  // EPI_ADD_F32
      res = __fadd_rn(__fadd_rn(f(ep.resid[o]), v + b),
                      f(ep.rowbias[(gr / ep.rows_per_batch) * N + gc]));
    }
    out[o] = r16(res);
  }
}

// ------------------------------------------------------- temporal attention
// qkv: [B*T*S, 3C] in (b t) s c row order (q | k | v, heads of DH each);
// out: [B*T*S, C]. One warp per (b, s, head); lane t < T is query frame t.
constexpr int TMAX = 32;
constexpr int AWARPS = 4;

template <int DH>
__global__ void __launch_bounds__(AWARPS * 32)
tattn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int T,
             int S, int C, int heads, long groups, float scale) {
  __shared__ __align__(16) bf16 Ks[AWARPS][TMAX * DH];
  __shared__ __align__(16) bf16 Vs[AWARPS][TMAX * DH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long gid = (long)blockIdx.x * AWARPS + warp;
  if (gid >= groups) return;
  const int hd = (int)(gid % heads);
  const long bs = gid / heads;
  const long s = bs % S, b = bs / S;
  const long C3 = 3L * C;
  const long row0 = b * T * S + s;  // row of frame t: row0 + t * S

  constexpr int CH = DH / 8;  // 16-byte chunks per head row
  for (int idx = lane; idx < T * CH; idx += 32) {
    const int t = idx / CH, c8 = (idx - t * CH) * 8;
    const bf16* src = qkv + (row0 + (long)t * S) * C3 + hd * DH + c8;
    *reinterpret_cast<uint4*>(&Ks[warp][t * DH + c8]) =
        *reinterpret_cast<const uint4*>(src + C);
    *reinterpret_cast<uint4*>(&Vs[warp][t * DH + c8]) =
        *reinterpret_cast<const uint4*>(src + 2 * C);
  }
  __syncwarp();
  if (lane >= T) return;

  float qf[DH];
  const bf16* qr = qkv + (row0 + (long)lane * S) * C3 + hd * DH;
#pragma unroll
  for (int d = 0; d < DH; d += 2) {
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(qr + d));
    qf[d] = v.x;
    qf[d + 1] = v.y;
  }
  float sc[TMAX];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < TMAX; ++j) {
    if (j < T) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot += qf[d] * f(Ks[warp][j * DH + d]);
      sc[j] = dot * scale;
      m = fmaxf(m, sc[j]);
    }
  }
  float l = 0.f;
#pragma unroll
  for (int j = 0; j < TMAX; ++j)
    if (j < T) {
      sc[j] = expf(sc[j] - m);
      l += sc[j];
    }
  float o[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) o[d] = 0.f;
#pragma unroll
  for (int j = 0; j < TMAX; ++j) {
    if (j < T) {
      const float p = rr(sc[j] / l);
#pragma unroll
      for (int d = 0; d < DH; ++d) o[d] += p * f(Vs[warp][j * DH + d]);
    }
  }
  __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(
      out + (row0 + (long)lane * S) * C + hd * DH);
#pragma unroll
  for (int d = 0; d < DH; d += 2)
    orow[d / 2] = __floats2bfloat162_rn(o[d], o[d + 1]);
}

// ---------------------------------------------------------------- launchers
int ln(const bf16* h, const bf16* emb, bf16* x_out, bf16* y, const bf16* s,
       const bf16* b, long rows, int C, int S, cudaStream_t st) {
  if (C % 2 || C > 64 * MAXP) return (int)cudaErrorInvalidValue;
  const int warps = 8;
  ln_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, st>>>(
      h, emb, x_out, y, s, b, rows, C, S, 1e-6f);
  return (int)cudaGetLastError();
}

template <int EPI>
int gemm(const bf16* A, const bf16* W, bf16* out, long M, int N, int K,
         const EpiArgs& ep, cudaStream_t st) {
  if (K % 8 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = gemm_smem<EPI>();
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + GBM - 1) / GBM), (unsigned)((N + GBN - 1) / GBN));
  gemm_kernel<EPI><<<grid, GTHREADS, smem, st>>>(A, W, out, M, N, K, ep);
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
