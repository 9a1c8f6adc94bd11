// Attention forward and backward for Hopper (sm_90a): kernels D, G and H.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// flash_attention.py. Every entry launches on the caller's stream,
// allocates nothing, does not synchronise and returns cudaGetLastError().
// q, o, dq, do: [B, Sq, H, D]; k, v, dk, dv: [B, Skv, H, D]; all bf16,
// read and written with the row stride H*D (the layout the UNet's
// projections produce), so no transpose is needed. lse, delta: [B, H, Sq]
// f32. Everything is non-causal, with f32 scores, softmax and accumulators;
// bf16 products on the tensor cores through wgmma. Head dims 64 and 128.
// The Hopper building blocks (mbarriers, TMA, wgmma descriptors) are in
// hopper.cuh.
//
// Kernel D replaces street_crafter_tpu/ops/flash_attention.py:29
// _flash_kernel (K4), the TPU's online-softmax forward: q blocks over the
// grid, the whole (padded) K/V resident in VMEM, a ones column in V to get
// the softmax denominator out of the PV matmul, and the power-of-two scale
// folded into q. It computes o = softmax(q k^T * scale) v per (batch, head)
// and, in its training form (sc_flash_forward_lse), the logsumexp
// lse = m + log(l) of each query row, natural log, which the backward
// needs; the sampling path writes no lse (the JAX package's need_lse=False).
// Bound on this card: the two products, 4 * Sq * Skv * D operations per
// (batch, head) at 989 TFLOP/s; the bytes (q, k, v read once, o written
// once) take ~1/16 of that at the UNet's S = 9216. At head dim 64 the
// exponentials are the second limit: 16 ex2 a clock on an SM make one
// 128 x 128 score tile's softmax as long as its two products. Design
// (FlashAttention-3's shape):
//   - one block of three warpgroups per (batch*head, 128 query rows): a
//     producer (one thread issues the TMA loads; setmaxnreg gives its
//     registers to the others) and two consumers of 64 rows each;
//   - Q is loaded once by TMA; K and V tiles of 128 keys go through a ring
//     of STAGES stages in dynamic shared memory, each with a "full" mbarrier
//     (TMA transaction bytes) and an "empty" one that both consumer
//     warpgroups must release (256 arrivals) before it is loaded again, so
//     loads stay in flight while the consumers compute;
//   - TMA reads through a 4-D map over [B, S, H, D] (box {64, 1, rows, 1},
//     128-byte swizzle): positions past S come in as zeros, never as the
//     next batch's rows. Head dim 128 is two 64-column boxes per row (two
//     swizzle atoms), at the same 128-row tiles;
//   - S = Q K^T by wgmma m64n128k16, A and B from shared-memory descriptors
//     in the TMA's 128-byte swizzle (K-major);
//   - the online softmax runs in f32 on the accumulator fragments in base 2
//     (scale * log2(e) folded into one multiply, ex2.approx); row max and
//     sum over the four threads that share a row; keys past Skv get -inf;
//   - O += P V by wgmma m64nDk16 with A = P in registers (the m64n128 f32
//     accumulator layout packs into the register-A fragments of eight k16
//     steps without shuffles) and B = the V tile as it lies, through the
//     transpose bit (MN-major descriptor): V is never transposed in memory;
//   - the exponentials run under the products twice over: within a
//     warpgroup, tile t's S = Q K^T and tile t - 1's P V are issued
//     together and tile t's softmax runs while P V is in flight; across
//     the two, named barriers hand the tensor cores from one warpgroup to
//     the other (ping-pong), so one's softmax runs under the other's
//     products;
//   - query rows past Sq are computed on zeros and not stored.
// At head dim 128 the S, P and O fragments (64 + 32 + 64 registers) do not
// fit the 168 registers ptxas allots each thread of a 384-thread block:
// it spills a little and serialises some products (its report is printed
// by chip_smoke.py). The UNet runs head dim 64 only.
//
// Kernel G replaces flash_attention.py:195 _bwd_dkv_kernel (K5): dK and dV
// of one block of 128 keys, with q, dO, lse and delta streaming in tiles of
// BQT queries (64; 32 at head dim 128, to keep the dK and dV accumulators,
// 128 registers there, in registers) and p recomputed from lse (no
// [Sq, Skv] tensor touches device memory):
//   p = exp(s * scale - lse), dV += p^T dO, dp = dO v^T,
//   ds = p * (dp - delta) * scale, dK += ds^T q,
// in the TPU kernel's order (key-major: the score tile is k q^T), with p
// and ds rounded to bf16 before their products, where K5 rounds them.
// Bound: four products, 8 * Sq * Skv * D operations per (batch, head).
// Design (FlashAttention-3's dK/dV pass):
//   - one block of three warpgroups per (batch*head, 128 keys): a producer
//     and two consumers of 64 keys each. K and V are loaded once by TMA and
//     stay in shared memory; dK and dV stay in f32 registers, written once;
//   - q and dO tiles stream through a TMA ring (STAGES stages, full / empty
//     mbarriers as in D); a second producer warp copies each tile's lse
//     (times log2(e)) and delta rows into the stage with plain loads and
//     arrives on the same full barrier (1 + 32 arrivals);
//   - S^T = K q^T and dP^T = V dO^T by wgmma m64nBQTk16, B the q and dO
//     tiles as they lie (K-major);
//   - p^T = exp2(S^T * scale * log2(e) - lse * log2(e)) and
//     ds^T = p^T (dP^T - delta) * scale on the fragments; queries past Sq
//     are masked explicitly (p = 0): TMA's zero fill alone would give q = 0
//     and lse = 0, so p = 1;
//   - dV += P^T dO and dK += dS^T q by wgmma with A from registers and B
//     the same dO and q tiles through the transpose bit: each tile is
//     staged once. Keys past Skv are zeros and are not stored.
//
// Where this goes wrong, and how the design guards against it:
//   - a wgmma descriptor whose swizzle or byte offsets disagree with the
//     TMA's layout gives wrong numbers, not a crash: K-major tiles use
//     stride offset 1024 (eight 128-byte rows) and advance 32 bytes per k16
//     step; MN-major tiles (V in D; q, dO in G; K in H) use stride offset
//     1024 along K, leading offset one swizzle atom along N, and advance
//     16 rows (2048 bytes) per k16 step. Ragged shapes in the tests and
//     chip_smoke.py cross every tile edge;
//   - asynchronous products: wgmma.fence before each group of products,
//     commit_group / wait_group before its fragments are read, and an
//     empty compiler barrier on the accumulators around them; nothing but
//     a wgmma writes an accumulator between its fence and its wait (ptxas
//     serialises the products otherwise);
//   - a stage is reloaded only after both consumer warpgroups have released
//     it; a wait that lasts seconds is a deadlock and traps, so the launch
//     fails instead of hanging the card;
//   - the tensor map: cuTensorMapEncodeTiled lives in libcuda; it is
//     reached through the runtime's entry-point query (no -lcuda), encoded
//     per call on the host (microseconds) and passed as a __grid_constant__
//     parameter. TMA needs a 16-byte aligned base and 16-byte multiple
//     strides (H*D*2 is one for D = 64 and 128); the wrapper checks the
//     alignment;
//   - dynamic shared memory above 48 KB needs cudaFuncSetAttribute, whose
//     error is returned like a refused launch's.
//
// Kernel H replaces flash_attention.py:246 _bwd_dq_kernel (K6): dQ of one
// block of 128 queries, with k and v streaming: dQ += ds k, ds = p (dp -
// delta) scale rounded to bf16 (where K6 rounds ds_t), p = exp(s - lse) in
// f32. Bound: three products, 6 * Sq * Skv * D operations per (batch,
// head). Design (kernel G's, turned around):
//   - one block of three warpgroups per (batch*head, 128 queries): a
//     producer and two consumers of 64 queries each. Q and dO are loaded
//     once by TMA and stay in shared memory; the row warp of the producer
//     copies the block's lse (times log2(e)) and delta rows once; dQ stays
//     in f32 registers, written once;
//   - K and V tiles of BKT keys (64; 32 at head dim 128) stream through a
//     TMA ring of STAGES stages with full / empty mbarriers, as in D;
//   - S = Q K^T and dP = dO V^T by wgmma m64nBKTk16, both operands K-major
//     from shared memory; p and ds on the fragments; keys past Skv are
//     masked explicitly (TMA's zero fill gives s = 0, not -inf);
//   - dQ += dS K by wgmma with A = dS from registers and B the K tile
//     through the transpose bit (MN-major): K is never transposed;
//   - tile t's S and dP are issued with tile t - 1's dS K, its exponentials
//     run while that product is in flight, and the two consumers take the
//     tensor cores in turns (named barriers, D's ping-pong);
//   - BKT = 64 keeps S, dP (32 registers each), dQ (32) and the dS
//     fragments (16) of a thread inside the 168 registers ptxas allots a
//     384-thread block; at BKT = 128 they would need ~190;
//   - query rows past Sq are computed on zeros and not stored.
// delta = rowsum(dO * O) is one torch op in the wrapper (f32), as the JAX
// package computes it outside its kernels.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int WG3 = 384;      // a producer warpgroup + two consumers
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Rows [row, row + box rows) of head h of batch b through a 4-D map, as NA
// 64-column boxes (128-byte swizzle atoms) `atom` bytes apart at dst.
template <int NA>
__device__ __forceinline__ void tma_rows(uint32_t dst, uint32_t atom,
                                         const CUtensorMap* map, uint32_t bar,
                                         int h, int row, int b) {
#pragma unroll
  for (int a = 0; a < NA; ++a)
    tma_load(dst + a * atom, map, bar, 64 * a, h, row, b);
}

// ------------------------------------------------------------- kernel D

// S = Q K^T of one 128-key tile for this warpgroup's 64 rows (issued and
// committed, not waited for): Q at qa, K at ks.
template <int NA>
__device__ __forceinline__ void qk_tile(float (&sc)[64], uint32_t qa,
                                        uint32_t ks) {
  fence_regs(sc);
  wgmma_fence();
  wgmma_abt<NA>(sc, qa, 128 * 128, ks, 128 * 128);
  wgmma_commit();
  fence_regs(sc);
}

// O += P V of one 128-key tile (issued and committed): P in registers, the
// V tile at vs as it lies.
template <int N>
__device__ __forceinline__ void pv_tile(float (&acc)[N],
                                        const uint32_t (&pa)[8][4],
                                        uint32_t vs) {
  fence_regs(acc);
  wgmma_fence();
  wgmma_ab(acc, pa, vs, 128 * 128);
  wgmma_commit();
  fence_regs(acc);
}

// Dynamic shared memory of kernel D: the alignment pad, Q, the K/V ring and
// the barriers (q_full, STAGES full, STAGES empty).
template <int D, int STAGES>
constexpr int fwd_smem_bytes() {
  return 1024 + (D / 64) * 128 * 128 * (1 + 2 * STAGES) + 8 * (1 + 2 * STAGES);
}

// o (and lse) of 128 query rows of one (batch, head): grid q_tiles * B * H.
template <int D, int STAGES, bool LSE>
__global__ void __launch_bounds__(WG3, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Skv, int q_tiles, float scale_log2) {
  constexpr int NA = D / 64;                // 64-column swizzle atoms a row
  constexpr uint32_t ATOM = 128 * 128;      // one atom of a 128-row tile
  constexpr uint32_t TILE = NA * ATOM;      // a 128-row tile of Q, K or V
  extern __shared__ uint8_t smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t skv = sq + TILE;           // stage s: K, then V
  const uint32_t q_full = skv + 2 * STAGES * TILE;
  const uint32_t kv_full = q_full + 8, kv_empty = kv_full + 8 * STAGES;

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int n_kv = (Skv + 127) / 128;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    regs_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, TILE);
      tma_rows<NA>(sq, ATOM, &tq, q_full, h, 128 * qt, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % STAGES;
        mbar_wait(kv_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(kv_full + 8 * s, 2 * TILE);
        const uint32_t ks = skv + 2 * s * TILE;
        tma_rows<NA>(ks, ATOM, &tk, kv_full + 8 * s, h, 128 * t, b);
        tma_rows<NA>(ks + TILE, ATOM, &tv, kv_full + 8 * s, h, 128 * t, b);
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63 of the tile
    regs_inc<240>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const uint32_t qa = sq + cw * 64 * 128;
    float acc[D / 2];  // O: m64nD accumulator, rows g and g + 8 of the warp
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max (base 2, scaled)
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
    mbar_wait(q_full, 0);

    // Tile t's S = Q K^T and tile t - 1's O += P V are issued together, and
    // the softmax of tile t runs while P V is in flight (FlashAttention-3's
    // intra-warpgroup overlap); O is rescaled between the two issues.
    uint32_t pa[8][4];            // P of the previous tile, register-A bf16
    float al0 = 0.f, al1 = 0.f;   // its rescale of O
    // consumer 0 takes the first turn; consumer 1's last hand-over finds no
    // waiter, and a named barrier's count does not outlive the block
    if (cw == 1) turn_pass(cw);
    {
      mbar_wait(kv_full, 0);
      float sc[64];
      turn_wait(cw);
      qk_tile<NA>(sc, qa, skv);
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax_tile(sc, 0, Skv, t4, scale_log2, m0, m1, l0, l1, al0, al1);
      a_frags(pa, sc);
    }
    for (int t = 1; t < n_kv; ++t) {
      const int s = t % STAGES, sp = (t - 1) % STAGES;
      mbar_wait(kv_full + 8 * s, (t / STAGES) & 1);
      float sc[64];
      turn_wait(cw);
      qk_tile<NA>(sc, qa, skv + 2 * s * TILE);
      rescale(acc, al0, al1);
      pv_tile(acc, pa, skv + (2 * sp + 1) * TILE);
      turn_pass(cw);
      wgmma_wait<1>();
      fence_regs(sc);
      softmax_tile(sc, 128 * t, Skv, t4, scale_log2, m0, m1, l0, l1, al0,
                   al1);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(kv_empty + 8 * sp);  // both products of tile t - 1 are done
      a_frags(pa, sc);
    }
    rescale(acc, al0, al1);  // the last tile's P V
    turn_wait(cw);
    pv_tile(acc, pa, skv + (2 * ((n_kv - 1) % STAGES) + 1) * TILE);
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int r0 = 128 * qt + 64 * cw + 16 * warp + g, r1 = r0 + 8;
    if (LSE && t4 == 0) {  // natural log: m0 is max * scale * log2(e)
      float* lrow = lse + (long)bh * Sq;
      if (r0 < Sq) lrow[r0] = m0 * LN2 + logf(l0);
      if (r1 < Sq) lrow[r1] = m1 * LN2 + logf(l1);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const long rs = (long)H * D;
    __nv_bfloat16* ob = o + ((long)b * Sq * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t4;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * rs + col) =
            pack_bf16(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r1 * rs + col) =
            pack_bf16(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
    }
  }
}

// ------------------------------------------------------------- kernel G

// Dynamic shared memory of kernel G: the alignment pad, K, V, the q / dO
// ring, the lse / delta rows of each stage and the barriers (kv_full,
// STAGES full, STAGES empty).
template <int D, int BQT, int STAGES>
constexpr int dkv_smem_bytes() {
  return 1024 + (D / 64) * (2 * 128 * 128 + STAGES * 2 * BQT * 128) +
         STAGES * 512 + 8 * (1 + 2 * STAGES);
}

// dK, dV of 128 keys of one (batch, head), q tiles of BQT queries: grid
// k_tiles * B * H.
template <int D, int BQT, int STAGES>
__global__ void __launch_bounds__(WG3, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv,
                     int k_tiles, float scale, float scale_log2) {
  constexpr int NA = D / 64;
  constexpr uint32_t KATOM = 128 * 128, KTILE = NA * KATOM;  // 128 keys
  constexpr uint32_t QATOM = BQT * 128, QTILE = NA * QATOM;  // BQT queries
  extern __shared__ uint8_t smem[];
  const uint32_t sk = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sv = sk + KTILE;
  const uint32_t ring = sv + KTILE;              // stage s: q, then dO
  const uint32_t rows = ring + 2 * STAGES * QTILE;  // stage s: lse, delta
  const uint32_t kv_full = rows + 512 * STAGES;
  const uint32_t full = kv_full + 8, empty = full + 8 * STAGES;
  float* const row_buf =
      reinterpret_cast<float*>(smem + (rows - smem_u32(smem)));

  const int bh = blockIdx.x / k_tiles, kt = blockIdx.x - bh * k_tiles;
  const int b = bh / H, h = bh - b * H;
  const int n_q = (Sq + BQT - 1) / BQT;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the TMA thread + the row warp
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0 issues TMA, warp 1 copies the rows
    regs_dec<24>();
    const int warp = tid / 32, lane = tid % 32;
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * KTILE);
      tma_rows<NA>(sk, KATOM, &tk, kv_full, h, 128 * kt, b);
      tma_rows<NA>(sv, KATOM, &tv, kv_full, h, 128 * kt, b);
      for (int t = 0; t < n_q; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * QTILE);
        const uint32_t qs = ring + 2 * s * QTILE;
        tma_rows<NA>(qs, QATOM, &tq, full + 8 * s, h, BQT * t, b);
        tma_rows<NA>(qs + QTILE, QATOM, &tdo, full + 8 * s, h, BQT * t, b);
      }
    } else if (warp == 1) {
      const float* lrow = lse + (long)bh * Sq;
      const float* drow = delta + (long)bh * Sq;
      for (int t = 0; t < n_q; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        float* lr = row_buf + 128 * s;
        for (int i = lane; i < BQT; i += 32) {
          const int q = BQT * t + i;
          lr[i] = q < Sq ? lrow[q] * LOG2E : 0.f;
          lr[64 + i] = q < Sq ? drow[q] : 0.f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup cw owns keys 64 cw .. 64 cw + 63 of the block
    regs_inc<240>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32, t4 = lane % 4;
    const uint32_t ka = sk + cw * 64 * 128, va = sv + cw * 64 * 128;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int t = 0; t < n_q; ++t) {
      const int s = t % STAGES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
      const uint32_t qs = ring + 2 * s * QTILE, os = qs + QTILE;
      const float* lr = row_buf + 128 * s;  // lse * log2(e), then delta

      // S^T = K q^T and dP^T = V dO^T: 64 keys x BQT queries each
      float st[BQT / 2], dpt[BQT / 2];
      wgmma_fence();
      wgmma_abt<NA>(st, ka, KATOM, qs, QATOM);
      wgmma_abt<NA>(dpt, va, KATOM, os, QATOM);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // p^T and ds^T on the fragments; column c is query BQT t + c
      const bool ragged = BQT * (t + 1) > Sq;
#pragma unroll
      for (int r = 0; r < BQT / 2; ++r) {
        const int c = 8 * (r / 4) + 2 * t4 + (r & 1);
        float p = ex2(fmaf(st[r], scale_log2, -lr[c]));
        if (ragged && BQT * t + c >= Sq) p = 0.f;
        st[r] = p;
        dpt[r] = p * (dpt[r] - lr[64 + c]) * scale;
      }

      // dV += P^T dO and dK += dS^T q: A from registers, B the same tiles
      // through the transpose bit
      uint32_t pf[BQT / 16][4], sf[BQT / 16][4];
      a_frags(pf, st);
      a_frags(sf, dpt);
      wgmma_fence();
      wgmma_ab(dva, pf, os, QATOM);
      wgmma_ab(dka, sf, qs, QATOM);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      mbar_arrive(empty + 8 * s);
    }

    const int g = lane / 4;
    const int k0 = 128 * kt + 64 * cw + 16 * warp + g, k1 = k0 + 8;
    const long rs = (long)H * D;
    const long off = ((long)b * Skv * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t4;
      if (k0 < Skv) {
        *reinterpret_cast<uint32_t*>(dk + off + k0 * rs + col) =
            pack_bf16(dka[4 * c], dka[4 * c + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + k0 * rs + col) =
            pack_bf16(dva[4 * c], dva[4 * c + 1]);
      }
      if (k1 < Skv) {
        *reinterpret_cast<uint32_t*>(dk + off + k1 * rs + col) =
            pack_bf16(dka[4 * c + 2], dka[4 * c + 3]);
        *reinterpret_cast<uint32_t*>(dv + off + k1 * rs + col) =
            pack_bf16(dva[4 * c + 2], dva[4 * c + 3]);
      }
    }
  }
}

// ------------------------------------------------------------- kernel H

// Dynamic shared memory of kernel H: the alignment pad, Q, dO, the K / V
// ring, the lse / delta rows and the barriers (q_full, STAGES full, STAGES
// empty).
template <int D, int BKT, int STAGES>
constexpr int dq_smem_bytes() {
  return 1024 + (D / 64) * (2 * 128 * 128 + STAGES * 2 * BKT * 128) + 1024 +
         8 * (1 + 2 * STAGES);
}

// S = Q K^T and dP = dO V^T of one key tile for this warpgroup's 64 rows
// (issued and committed, not waited for): Q at qa, dO at oa, the tile's K
// at ks and V at ks + KTILE.
template <int NA, int BKT>
__device__ __forceinline__ void sdp_tile(float (&st)[BKT / 2],
                                         float (&dpt)[BKT / 2], uint32_t qa,
                                         uint32_t oa, uint32_t ks) {
  constexpr uint32_t KATOM = BKT * 128;
  fence_regs(st);
  fence_regs(dpt);
  wgmma_fence();
  wgmma_abt<NA>(st, qa, 128 * 128, ks, KATOM);
  wgmma_abt<NA>(dpt, oa, 128 * 128, ks + NA * KATOM, KATOM);
  wgmma_commit();
  fence_regs(st);
  fence_regs(dpt);
}

// dQ += dS K of one key tile (issued and committed): dS in registers, the K
// tile at ks as it lies (MN-major, through the transpose bit).
template <int BKT, int N>
__device__ __forceinline__ void dq_tile(float (&acc)[N],
                                        const uint32_t (&sf)[BKT / 16][4],
                                        uint32_t ks) {
  fence_regs(acc);
  wgmma_fence();
  wgmma_ab(acc, sf, ks, BKT * 128);
  wgmma_commit();
  fence_regs(acc);
}

// p = exp2(s * scale * log2(e) - lse * log2(e)) and ds = p (dp - delta)
// scale on the fragments of one key tile (keys kv0 .. kv0 + BKT - 1); ds
// replaces dp. Keys past Skv are masked explicitly (p = 0): TMA's zero fill
// gives s = 0 there, not -inf. ls and dl: lse * log2(e) and delta of rows
// g and g + 8.
template <int N>
__device__ __forceinline__ void ds_tile(const float (&st)[N], float (&dpt)[N],
                                        int kv0, int Skv, int t4, float sl2,
                                        float scale, float ls0, float ls1,
                                        float dl0, float dl1) {
  const bool ragged = kv0 + 2 * N > Skv;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const bool hi = r & 2;
    float p = ex2(fmaf(st[r], sl2, -(hi ? ls1 : ls0)));
    if (ragged && kv0 + 8 * (r / 4) + 2 * t4 + (r & 1) >= Skv) p = 0.f;
    dpt[r] = p * (dpt[r] - (hi ? dl1 : dl0)) * scale;
  }
}

// dQ of 128 query rows of one (batch, head), key tiles of BKT keys: grid
// q_tiles * B * H.
template <int D, int BKT, int STAGES>
__global__ void __launch_bounds__(WG3, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv,
                    int q_tiles, float scale, float scale_log2) {
  constexpr int NA = D / 64;
  constexpr uint32_t QATOM = 128 * 128, QTILE = NA * QATOM;  // 128 queries
  constexpr uint32_t KATOM = BKT * 128, KTILE = NA * KATOM;  // BKT keys
  extern __shared__ uint8_t smem[];
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t sdo = sq + QTILE;
  const uint32_t ring = sdo + QTILE;                 // stage s: K, then V
  const uint32_t rows = ring + 2 * STAGES * KTILE;   // lse * log2(e), delta
  const uint32_t q_full = rows + 1024;
  const uint32_t full = q_full + 8, empty = full + 8 * STAGES;
  float* const row_buf =
      reinterpret_cast<float*>(smem + (rows - smem_u32(smem)));

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int n_kv = (Skv + BKT - 1) / BKT;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1 + 32);  // the TMA thread + the row warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0 issues TMA, warp 1 copies the rows
    regs_dec<24>();
    const int warp = tid / 32, lane = tid % 32;
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * QTILE);
      tma_rows<NA>(sq, QATOM, &tq, q_full, h, 128 * qt, b);
      tma_rows<NA>(sdo, QATOM, &tdo, q_full, h, 128 * qt, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * KTILE);
        const uint32_t ks = ring + 2 * s * KTILE;
        tma_rows<NA>(ks, KATOM, &tk, full + 8 * s, h, BKT * t, b);
        tma_rows<NA>(ks + KTILE, KATOM, &tv, full + 8 * s, h, BKT * t, b);
      }
    } else if (warp == 1) {
      const float* lrow = lse + (long)bh * Sq;
      const float* drow = delta + (long)bh * Sq;
      for (int i = lane; i < 128; i += 32) {
        const int q = 128 * qt + i;
        row_buf[i] = q < Sq ? lrow[q] * LOG2E : 0.f;
        row_buf[128 + i] = q < Sq ? drow[q] : 0.f;
      }
      mbar_arrive(q_full);
    }
  } else {
    // consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63 of the tile
    regs_inc<240>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const uint32_t qa = sq + cw * 64 * 128, oa = sdo + cw * 64 * 128;
    float acc[D / 2];  // dQ: m64nD accumulator, rows g and g + 8 of the warp
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);
    const int lr = 64 * cw + 16 * warp + g;  // row g within the block
    const float ls0 = row_buf[lr], ls1 = row_buf[lr + 8];
    const float dl0 = row_buf[128 + lr], dl1 = row_buf[128 + lr + 8];

    // Tile t's S and dP are issued together with tile t - 1's dQ += dS K,
    // and tile t's p and ds run while that product is in flight; named
    // barriers hand the tensor cores from one warpgroup to the other
    // (ping-pong), as in kernel D.
    uint32_t sf[BKT / 16][4];  // dS of the previous tile, register-A bf16
    if (cw == 1) turn_pass(cw);
    {
      mbar_wait(full, 0);
      float st[BKT / 2], dpt[BKT / 2];
      turn_wait(cw);
      sdp_tile<NA, BKT>(st, dpt, qa, oa, ring);
      turn_pass(cw);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      ds_tile(st, dpt, 0, Skv, t4, scale_log2, scale, ls0, ls1, dl0, dl1);
      a_frags(sf, dpt);
    }
    for (int t = 1; t < n_kv; ++t) {
      const int s = t % STAGES, sp = (t - 1) % STAGES;
      mbar_wait(full + 8 * s, (t / STAGES) & 1);
      float st[BKT / 2], dpt[BKT / 2];
      turn_wait(cw);
      sdp_tile<NA, BKT>(st, dpt, qa, oa, ring + 2 * s * KTILE);
      dq_tile<BKT>(acc, sf, ring + 2 * sp * KTILE);
      turn_pass(cw);
      wgmma_wait<1>();
      fence_regs(st);
      fence_regs(dpt);
      ds_tile(st, dpt, BKT * t, Skv, t4, scale_log2, scale, ls0, ls1, dl0,
              dl1);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * sp);  // tile t - 1's products are done
      a_frags(sf, dpt);
    }
    turn_wait(cw);  // the last tile's dQ += dS K
    dq_tile<BKT>(acc, sf, ring + 2 * ((n_kv - 1) % STAGES) * KTILE);
    turn_pass(cw);
    wgmma_wait<0>();
    fence_regs(acc);

    const int r0 = 128 * qt + lr, r1 = r0 + 8;
    const long rs = (long)H * D;
    __nv_bfloat16* qb = dq + ((long)b * Sq * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t4;
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(qb + r0 * rs + col) =
            pack_bf16(acc[4 * c], acc[4 * c + 1]);
      if (r1 < Sq)
        *reinterpret_cast<uint32_t*>(qb + r1 * rs + col) =
            pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

}  // namespace

namespace {

// The 4-D TMA map of a [B, S, H, D] bf16 tensor (dims innermost first: D,
// H, S, B), box {64, 1, rows, 1}: 64 columns of `rows` positions of one
// (batch, head), 128-byte swizzled; positions past S read as zeros.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
               int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int STAGES, bool LSE>
int launch_forward(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Skv, float scale,
                   cudaStream_t st) {
  constexpr int smem = fwd_smem_bytes<D, STAGES>();
  auto kern = flash_fwd_kernel<D, STAGES, LSE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, B, Sq, H, D, 128);
  if (!err) err = tensor_map(&mk, k, B, Skv, H, D, 128);
  if (!err) err = tensor_map(&mv, v, B, Skv, H, D, 128);
  if (err) return err;
  const int q_tiles = (Sq + 127) / 128;
  kern<<<(unsigned)(q_tiles * B * H), WG3, smem, st>>>(
      mq, mk, mv, (__nv_bfloat16*)o, lse, H, Sq, Skv, q_tiles,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <bool LSE>
int forward(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int H, int Sq, int Skv, int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch_forward<64, 3, LSE>(q, k, v, o, lse, B, H, Sq, Skv, scale,
                                      st);
  if (D == 128)
    return launch_forward<128, 2, LSE>(q, k, v, o, lse, B, H, Sq, Skv, scale,
                                       st);
  return (int)cudaErrorInvalidValue;
}

template <int D, int BQT, int STAGES>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Sq, int Skv, float scale, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<D, BQT, STAGES>();
  auto kern = flash_bwd_dkv_kernel<D, BQT, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv, mo;
  int err = tensor_map(&mq, q, B, Sq, H, D, BQT);
  if (!err) err = tensor_map(&mo, dout, B, Sq, H, D, BQT);
  if (!err) err = tensor_map(&mk, k, B, Skv, H, D, 128);
  if (!err) err = tensor_map(&mv, v, B, Skv, H, D, 128);
  if (err) return err;
  const int k_tiles = (Skv + 127) / 128;
  kern<<<(unsigned)(k_tiles * B * H), WG3, smem, st>>>(
      mq, mk, mv, mo, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H,
      Sq, Skv, k_tiles, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D, int BKT, int STAGES>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int Sq, int Skv, float scale, cudaStream_t st) {
  constexpr int smem = dq_smem_bytes<D, BKT, STAGES>();
  auto kern = flash_bwd_dq_kernel<D, BKT, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv, mo;
  int err = tensor_map(&mq, q, B, Sq, H, D, 128);
  if (!err) err = tensor_map(&mo, dout, B, Sq, H, D, 128);
  if (!err) err = tensor_map(&mk, k, B, Skv, H, D, BKT);
  if (!err) err = tensor_map(&mv, v, B, Skv, H, D, BKT);
  if (err) return err;
  const int q_tiles = (Sq + 127) / 128;
  kern<<<(unsigned)(q_tiles * B * H), WG3, smem, st>>>(
      mq, mk, mv, mo, lse, delta, (__nv_bfloat16*)dq, H, Sq, Skv, q_tiles,
      scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sc_flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o: [B, Sq, H, D]; k, v: [B, Skv, H, D]; bf16, contiguous, 16-byte
// aligned. D: 64 or 128.
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
  cudaStream_t st = (cudaStream_t)stream;
  const auto* lp = (const float*)lse;
  const auto* dp = (const float*)delta;
  if (D == 64)
    return launch_dkv<64, 64, 3>(q, k, v, dout, lp, dp, dk, dv, B, H, Sq,
                                 Skv, scale, st);
  if (D == 128)
    return launch_dkv<128, 32, 3>(q, k, v, dout, lp, dp, dk, dv, B, H, Sq,
                                  Skv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Kernel H: dq [B, Sq, H, D] bf16 from the same inputs.
int sc_flash_backward_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int B, int H, int Sq, int Skv, int D,
                         float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* lp = (const float*)lse;
  const auto* dp = (const float*)delta;
  if (D == 64)
    return launch_dq<64, 64, 4>(q, k, v, dout, lp, dp, dq, B, H, Sq, Skv,
                                scale, st);
  if (D == 128)
    return launch_dq<128, 32, 4>(q, k, v, dout, lp, dp, dq, B, H, Sq, Skv,
                                 scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
