// Attention forward and backward in float32 for Hopper (sm_90a): the f32
// forms of kernels D, G and H.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// flash_attention.py beside the bf16 forms of csrc/flash_attention.cu, and
// the same contract: every entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError(). q, o, dq,
// do: [B, Sq, H, D]; k, v, dk, dv: [B, Skv, H, D]; all f32, read and
// written with the row stride H*D; lse, delta: [B, H, Sq] f32. Non-causal,
// scale 1/sqrt(D) (passed in), ragged Sq and Skv (positions past S read as
// zero and are masked), head dims 64 and 128. Each form computes what its
// bf16 form computes, with nothing rounded to bf16: p and ds stay f32.
//
// The arithmetic. Hopper's tensor cores have no f32 product: TF32 keeps 10
// mantissa bits (~1e-3 relative), too few for f32 parity. Each operand is
// split into two TF32 parts, x = hi + lo (hi = x rounded to TF32, lo = the
// rest rounded to TF32), and every product is a_hi b_hi + a_hi b_lo +
// a_lo b_hi accumulated in f32 (3xTF32, as CUTLASS's "fast f32" GEMMs do):
// three mma.sync.m16n8k8 TF32 products, the two small ones first. The term
// dropped, a_lo b_lo, is ~2^-22 of the product, so the sums keep f32's
// precision. FFMA on the CUDA cores would be exact too, at 67 TFLOP/s
// against 3xTF32's 495 / 3 = 165: the split was chosen for that rate.
//
// Bound on this card: the products, at 165 TFLOP/s (TF32's dense 495 over
// the split's three products): 4 Sq Skv D operations per (batch, head) for
// D, 8 for G and 6 for H; the bytes (each input read once, each output
// written once, at 3.35 TB/s) take ~1/16 of that at the UNet's S = 9216.
//
// Design, the same for the three kernels (a simple one that is right; the
// TMA / wgmma shapes of the bf16 forms are for later work):
//   - a block of warps, each warp owning 16 rows of the resident side (the
//     query rows of D and H, the key rows of G); the streamed side's tiles
//     go through a cp.async double buffer (the next tile loads while this
//     one is computed); rows past S are zero-filled by the copy itself
//     (src-size 0), never read from the next batch or head;
//   - tiles in shared memory at a row stride of D + 4 floats: the fragment
//     loads of mma.sync (8 rows x 4 columns, or 4 rows x 8 columns read
//     along the other axis) then fall on 32 distinct banks;
//   - a product whose A operand is a score tile (P V in D, P^T dO and
//     dS^T q in G, dS K in H) takes it from the m16n8 accumulators without
//     a shuffle: a thread holds keys 2t and 2t + 1 of each 8, and A's
//     k-columns t and t + 4 are mapped to those keys; the B operand is read
//     from rows 2t and 2t + 1 to match (the sum over k does not depend on
//     its order);
//   - the online softmax in f32 and base 2 (scale * log2(e) folded into
//     one multiply), row max and sum over the four threads of a row; keys
//     past Skv get -inf (D) or p = 0 (H), queries past Sq p = 0 (G);
//   - G: one block of 8 warps per (batch * head, 128 keys), K and V
//     resident, q, dO, lse and delta streaming in tiles of BQ queries (64;
//     32 at head dim 128, which keeps dK and dV, 128 registers there, in
//     registers); dK and dV accumulate in registers and are written once;
//   - H: one block of 8 warps per (batch * head, 128 queries), Q and dO
//     resident, K and V streaming in tiles of BK keys (64; 32 at head dim
//     128); lse and delta of the warp's rows in registers;
//   - D: one block of 4 warps per (batch * head, 64 query rows), K and V
//     streaming in tiles of 64 keys (32 at head dim 128), so that two
//     blocks share an SM.
// delta = rowsum(dO * O) is one torch op in the wrapper (f32), as for the
// bf16 forms.
//
// Replaces, as the bf16 forms do: street_crafter_tpu/ops/flash_attention.py
// :29 _flash_kernel (K4, with and without lse), :195 _bwd_dkv_kernel (K5)
// and :246 _bwd_dq_kernel (K6), which follow their inputs' dtype and so run
// in f32 under the JAX package's float32 compute dtype.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global src to shared dst, or 16 zero bytes when !valid (src
// is then not read).
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, likewise (lse and delta rows).
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo, both TF32 (f32 with the low 13 mantissa bits clear); x - hi
// is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// An A fragment of m16n8k8 (rows g, g + 8; k-columns t, t + 4), split.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// A B fragment of m16n8k8 (k-rows t, t + 4; column g), split.
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small products first.
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// Rows [row0, row0 + ROWS) of head h of batch b of a [B, S, H, D] tensor
// into shared memory at a row stride of D + 4 floats, rows past S as zeros;
// NT threads, one 16-byte copy each at a time (not committed).
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int b, int h, int H, int S,
                                          int row0) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = i - r * CPR, s = row0 + r;
    const bool ok = s < S;
    const float* g = src + (((size_t)b * S + (ok ? s : 0)) * H + h) * D + 4 * c;
    cp16(smem_u32(dst + r * (D + 4) + 4 * c), g, ok);
  }
}

// The A fragment of k-step kk from rows r, r + 8 of a tile at stride DP.
template <int DP>
__device__ __forceinline__ void rows_a(FragA& a, const float* tile, int r,
                                      int kk, int t4) {
  const float* p0 = tile + r * DP + 8 * kk + t4;
  const float* p1 = p0 + 8 * DP;
  a.set(p0[0], p1[0], p0[4], p1[4]);
}

// The B fragment (k = the tile's columns 8 kk + t, + 4; n = its row n0 + g)
// of a row-major tile: B = tile^T.
template <int DP>
__device__ __forceinline__ void rows_bt(FragB& b, const float* tile, int n0,
                                       int kk, int g, int t4) {
  const float* p = tile + (n0 + g) * DP + 8 * kk + t4;
  b.set(p[0], p[4]);
}

// The B fragment (k = rows 8 j + 2 t, + 1; n = column 8 n + g) of a
// row-major tile, the k order matching score_a.
template <int DP>
__device__ __forceinline__ void rows_b(FragB& b, const float* tile, int j,
                                      int n, int g, int t4) {
  const float* p = tile + (8 * j + 2 * t4) * DP + 8 * n + g;
  b.set(p[0], p[DP]);
}

// The A fragment of k-step j from the accumulators of score columns 8 j ..
// 8 j + 7 (a thread holds rows g, g + 8 at columns 2 t, 2 t + 1): k-column
// t is column 2 t, k-column t + 4 is column 2 t + 1.
__device__ __forceinline__ void score_a(FragA& a, const float (&c)[4]) {
  a.set(c[0], c[2], c[1], c[3]);
}

// ------------------------------------------------------------- kernel D

template <int D, int BK>
constexpr int fwd_smem_bytes() {
  return (64 + 4 * BK) * (D + 4) * 4;
}

// o (and lse) of 64 query rows of one (batch, head): grid q_tiles * B * H,
// 4 warps of 16 rows.
template <int D, int BK, bool LSE>
__global__ void __launch_bounds__(128)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Skv,
                     int q_tiles, float sl2) {
  constexpr int DP = D + 4, BQ = 64, NT = 128;
  extern __shared__ float smem[];
  float* sq = smem;
  float* skv = sq + BQ * DP;  // stage s: K at skv + 2 s BK DP, then V

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * BQ, n_kv = (Skv + BK - 1) / BK;

  load_rows<BQ, D, NT>(sq, q, b, h, H, Sq, q0);
  load_rows<BK, D, NT>(skv, k, b, h, H, Skv, 0);
  load_rows<BK, D, NT>(skv + BK * DP, v, b, h, H, Skv, 0);
  cp_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (base 2, scaled)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
  const int r = warp * 16 + g;           // the thread's rows r, r + 8

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      float* nk = skv + ((t + 1) & 1) * 2 * BK * DP;
      load_rows<BK, D, NT>(nk, k, b, h, H, Skv, (t + 1) * BK);
      load_rows<BK, D, NT>(nk + BK * DP, v, b, h, H, Skv, (t + 1) * BK);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* ks = skv + (t & 1) * 2 * BK * DP;
    const float* vs = ks + BK * DP;

    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA a;
      rows_a<DP>(a, sq, r, kk, t4);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        FragB bf;
        rows_bt<DP>(bf, ks, 8 * j, kk, g, t4);
        mma3(sc[j], a, bf);
      }
    }

    // the online softmax of this tile
    const int kv0 = t * BK;
    if (kv0 + BK > Skv) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + 8 * j + 2 * t4 + (e & 1) >= Skv) sc[j][e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * sl2), mn1 = fmaxf(m1, mx1 * sl2);
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[j][0] = ex2(fmaf(sc[j][0], sl2, -m0));
      sc[j][1] = ex2(fmaf(sc[j][1], sl2, -m0));
      sc[j][2] = ex2(fmaf(sc[j][2], sl2, -m1));
      sc[j][3] = ex2(fmaf(sc[j][3], sl2, -m1));
      rs0 += sc[j][0] + sc[j][1];
      rs1 += sc[j][2] + sc[j][3];
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // O += P V
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      FragA a;
      score_a(a, sc[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB bf;
        rows_b<DP>(bf, vs, j, n, g, t4);
        mma3(acc[n], a, bf);
      }
    }
    __syncthreads();  // this stage is loaded again at t + 2
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + r, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (row0 < Sq)
      *reinterpret_cast<float2*>(
          o + (((size_t)b * Sq + row0) * H + h) * D + 8 * n + 2 * t4) =
          make_float2(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(
          o + (((size_t)b * Sq + row1) * H + h) * D + 8 * n + 2 * t4) =
          make_float2(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (LSE && t4 == 0) {
    // natural-log logsumexp of the scaled scores: (m + log2 l) ln 2
    if (row0 < Sq) lse[(size_t)bh * Sq + row0] = (m0 + log2f(l0)) * LN2;
    if (row1 < Sq) lse[(size_t)bh * Sq + row1] = (m1 + log2f(l1)) * LN2;
  }
}

// ------------------------------------------------------------- kernel G

template <int D, int BQ>
constexpr int dkv_smem_bytes() {
  return (2 * 128 + 4 * BQ) * (D + 4) * 4 + 2 * 2 * BQ * 4;
}

// dk, dv of 128 keys of one (batch, head): grid k_tiles * B * H, 8 warps of
// 16 keys.
template <int D, int BQ>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Skv, int k_tiles, float scale,
                         float sl2) {
  constexpr int DP = D + 4, BKV = 128, NT = 256;
  constexpr int STAGE = 2 * BQ * DP + 2 * BQ;  // q, dO, lse, delta
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + BKV * DP;
  float* stages = sv + BKV * DP;

  const int bh = blockIdx.x / k_tiles, kt = blockIdx.x - bh * k_tiles;
  const int b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k0 = kt * BKV, n_q = (Sq + BQ - 1) / BQ;
  const float* lse_bh = lse + (size_t)bh * Sq;
  const float* delta_bh = delta + (size_t)bh * Sq;

  auto load_stage = [&](int t) {
    float* st = stages + (t & 1) * STAGE;
    load_rows<BQ, D, NT>(st, q, b, h, H, Sq, t * BQ);
    load_rows<BQ, D, NT>(st + BQ * DP, dout, b, h, H, Sq, t * BQ);
    for (int i = threadIdx.x; i < 2 * BQ; i += NT) {
      const int qi = t * BQ + (i % BQ);
      const bool ok = qi < Sq;
      const float* src = (i < BQ ? lse_bh : delta_bh) + (ok ? qi : 0);
      cp4(smem_u32(st + 2 * BQ * DP + i), src, ok);
    }
  };

  load_rows<BKV, D, NT>(sk, k, b, h, H, Skv, k0);
  load_rows<BKV, D, NT>(sv, v, b, h, H, Skv, k0);
  load_stage(0);
  cp_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int r = warp * 16 + g;  // the thread's keys r, r + 8 of the block

  for (int t = 0; t < n_q; ++t) {
    if (t + 1 < n_q) {
      load_stage(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sq = stages + (t & 1) * STAGE;
    const float* sdo = sq + BQ * DP;
    const float* slse = sdo + BQ * DP;
    const float* sdelta = slse + BQ;

    // S^T = K q^T and dP^T = V dO^T: [16 keys, BQ queries] a warp
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA ak, av;
      rows_a<DP>(ak, sk, r, kk, t4);
      rows_a<DP>(av, sv, r, kk, t4);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        FragB bq, bo;
        rows_bt<DP>(bq, sq, 8 * j, kk, g, t4);
        rows_bt<DP>(bo, sdo, 8 * j, kk, g, t4);
        mma3(st[j], ak, bq);
        mma3(dpt[j], av, bo);
      }
    }

    // p^T = exp(s scale - lse), ds^T = p^T (dP^T - delta) scale; queries
    // past Sq get p = 0 (their zero-filled q would give p = exp(-lse))
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        const float p = (t * BQ + c < Sq)
                            ? ex2(fmaf(st[j][e], sl2, -slse[c] * LOG2E))
                            : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sdelta[c]) * scale;
      }

    // dV += P^T dO, dK += dS^T q
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      FragA ap, ads;
      score_a(ap, st[j]);
      score_a(ads, dpt[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB bo, bq;
        rows_b<DP>(bo, sdo, j, n, g, t4);
        rows_b<DP>(bq, sq, j, n, g, t4);
        mma3(dva[n], ap, bo);
        mma3(dka[n], ads, bq);
      }
    }
    __syncthreads();  // this stage is loaded again at t + 2
  }

  const int key0 = k0 + r, key1 = key0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t4;
    if (key0 < Skv) {
      const size_t at = (((size_t)b * Skv + key0) * H + h) * D + c;
      *reinterpret_cast<float2*>(dk + at) = make_float2(dka[n][0], dka[n][1]);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dva[n][0], dva[n][1]);
    }
    if (key1 < Skv) {
      const size_t at = (((size_t)b * Skv + key1) * H + h) * D + c;
      *reinterpret_cast<float2*>(dk + at) = make_float2(dka[n][2], dka[n][3]);
      *reinterpret_cast<float2*>(dv + at) = make_float2(dva[n][2], dva[n][3]);
    }
  }
}

// ------------------------------------------------------------- kernel H

template <int D, int BK>
constexpr int dq_smem_bytes() {
  return (2 * 128 + 4 * BK) * (D + 4) * 4;
}

// dq of 128 queries of one (batch, head): grid q_tiles * B * H, 8 warps of
// 16 queries.
template <int D, int BK>
__global__ void __launch_bounds__(256)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Sq, int Skv,
                        int q_tiles, float scale, float sl2) {
  constexpr int DP = D + 4, BQ = 128, NT = 256;
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + BQ * DP;
  float* skv = sdo + BQ * DP;  // stage s: K at skv + 2 s BK DP, then V

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = qt * BQ, n_kv = (Skv + BK - 1) / BK;

  load_rows<BQ, D, NT>(sq, q, b, h, H, Sq, q0);
  load_rows<BQ, D, NT>(sdo, dout, b, h, H, Sq, q0);
  load_rows<BK, D, NT>(skv, k, b, h, H, Skv, 0);
  load_rows<BK, D, NT>(skv + BK * DP, v, b, h, H, Skv, 0);
  cp_commit();

  const int r = warp * 16 + g;  // the thread's queries r, r + 8 of the block
  const int row0 = q0 + r, row1 = row0 + 8;
  const float* lse_bh = lse + (size_t)bh * Sq;
  const float* delta_bh = delta + (size_t)bh * Sq;
  const float nl0 = row0 < Sq ? -lse_bh[row0] * LOG2E : 0.f;
  const float nl1 = row1 < Sq ? -lse_bh[row1] * LOG2E : 0.f;
  const float de0 = row0 < Sq ? delta_bh[row0] : 0.f;
  const float de1 = row1 < Sq ? delta_bh[row1] : 0.f;

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      float* nk = skv + ((t + 1) & 1) * 2 * BK * DP;
      load_rows<BK, D, NT>(nk, k, b, h, H, Skv, (t + 1) * BK);
      load_rows<BK, D, NT>(nk + BK * DP, v, b, h, H, Skv, (t + 1) * BK);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* ks = skv + (t & 1) * 2 * BK * DP;
    const float* vs = ks + BK * DP;

    // S = Q K^T and dP = dO V^T: [16 queries, BK keys] a warp
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      FragA aq, ao;
      rows_a<DP>(aq, sq, r, kk, t4);
      rows_a<DP>(ao, sdo, r, kk, t4);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        FragB bk, bv;
        rows_bt<DP>(bk, ks, 8 * j, kk, g, t4);
        rows_bt<DP>(bv, vs, 8 * j, kk, g, t4);
        mma3(s[j], aq, bk);
        mma3(dp[j], ao, bv);
      }
    }

    // ds = p (dP - delta) scale, p = exp(s scale - lse); keys past Skv get
    // ds = 0 (their zero-filled k would give p = exp(-lse))
    const int kv0 = t * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lower = e & 2;
        const float p = ex2(fmaf(s[j][e], sl2, lower ? nl1 : nl0));
        const float ds = p * (dp[j][e] - (lower ? de1 : de0)) * scale;
        s[j][e] = (kv0 + 8 * j + 2 * t4 + (e & 1) < Skv) ? ds : 0.f;
      }

    // dQ += dS K
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      FragA a;
      score_a(a, s[j]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        FragB bk;
        rows_b<DP>(bk, ks, j, n, g, t4);
        mma3(dqa[n], a, bk);
      }
    }
    __syncthreads();  // this stage is loaded again at t + 2
  }

#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t4;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(dq + (((size_t)b * Sq + row0) * H + h) * D +
                                 c) = make_float2(dqa[n][0], dqa[n][1]);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(dq + (((size_t)b * Sq + row1) * H + h) * D +
                                 c) = make_float2(dqa[n][2], dqa[n][3]);
  }
}

// ------------------------------------------------------------- launches

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D, int BK, bool LSE>
int launch_forward(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int H, int Sq, int Skv, float scale,
                   cudaStream_t st) {
  constexpr int smem = fwd_smem_bytes<D, BK>();
  auto kern = flash_fwd_f32_kernel<D, BK, LSE>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int q_tiles = (Sq + 63) / 64;
  kern<<<(unsigned)(q_tiles * B * H), 128, smem, st>>>(
      q, k, v, o, lse, H, Sq, Skv, q_tiles, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <bool LSE>
int forward(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int H, int Sq, int Skv, int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto *fq = (const float*)q, *fk = (const float*)k,
             *fv = (const float*)v;
  if (D == 64)
    return launch_forward<64, 64, LSE>(fq, fk, fv, (float*)o, lse, B, H, Sq,
                                       Skv, scale, st);
  if (D == 128)
    return launch_forward<128, 32, LSE>(fq, fk, fv, (float*)o, lse, B, H, Sq,
                                        Skv, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <int D, int BQ>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Sq, int Skv, float scale, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<D, BQ>();
  auto kern = flash_bwd_dkv_f32_kernel<D, BQ>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int k_tiles = (Skv + 127) / 128;
  kern<<<(unsigned)(k_tiles * B * H), 256, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, H, Sq,
      Skv, k_tiles, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D, int BK>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Sq, int Skv, float scale, cudaStream_t st) {
  constexpr int smem = dq_smem_bytes<D, BK>();
  auto kern = flash_bwd_dq_f32_kernel<D, BK>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const int q_tiles = (Sq + 127) / 128;
  kern<<<(unsigned)(q_tiles * B * H), 256, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, H, Sq, Skv,
      q_tiles, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sc_flash_error_string_f32(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o: [B, Sq, H, D]; k, v: [B, Skv, H, D]; f32, contiguous, 16-byte
// aligned. D: 64 or 128.
int sc_flash_forward_f32(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Sq, int Skv, int D,
                         float scale, void* stream) {
  return forward<false>(q, k, v, o, nullptr, B, H, Sq, Skv, D, scale,
                        stream);
}

// The same, also writing lse [B, H, Sq] f32 (the training forward).
int sc_flash_forward_lse_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Sq,
                             int Skv, int D, float scale, void* stream) {
  return forward<true>(q, k, v, o, (float*)lse, B, H, Sq, Skv, D, scale,
                       stream);
}

// Kernel G in f32: dk, dv [B, Skv, H, D] from q, do [B, Sq, H, D], k, v,
// lse and delta [B, H, Sq].
int sc_flash_backward_dkv_f32(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Skv, int D, float scale,
                              void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch_dkv<64, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                              Skv, scale, st);
  if (D == 128)
    return launch_dkv<128, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                               Skv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel H in f32: dq [B, Sq, H, D] from the same inputs.
int sc_flash_backward_dq_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, int B, int H,
                             int Sq, int Skv, int D, float scale,
                             void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch_dq<64, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv,
                             scale, st);
  if (D == 128)
    return launch_dq<128, 32>(q, k, v, dout, lse, delta, dq, B, H, Sq, Skv,
                              scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
