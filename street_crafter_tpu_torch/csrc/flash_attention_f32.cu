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
// split into two TF32 parts, x = hi + lo, and every product is
// a_hi b_hi + a_hi b_lo + a_lo b_hi accumulated in f32 (3xTF32, as
// CUTLASS's "fast f32" GEMMs do). The term dropped, a_lo b_lo, is below
// 2^-22 of the product, so the sums keep f32's precision. The split uses
// that a TF32 product reads an f32 operand with its low 13 mantissa bits
// cleared (the card's behaviour, checked by tf32_probe_kernel below and
// the card tests): hi is x's bits plus half a TF32 step, written over the
// TMA tile in place and read as x rounded to nearest, and lo = x - hi as
// read, exact in f32, read truncated (hopper.cuh's tf32_hi, tf32_lo;
// ops/flash_attention.py's tf32_split models it): hi + lo within 2^-21
// |x|. FFMA on the CUDA cores would be exact too, at 67 TFLOP/s against
// 3xTF32's 495 / 3 = 165: the split was chosen for that rate.
//
// Bound on this card: the products, at 165 TFLOP/s (TF32's dense 495 over
// the split's three products): 4 Sq Skv D operations per (batch, head) for
// D, 8 for G and 6 for H; the bytes (each input read once, each output
// written once, at 3.35 TB/s) take ~1/16 of that at the UNet's S = 9216.
//
// All three: TF32 wgmma fed by TMA, each tile split once. What held their
// first forms (mma.sync.m16n8k8 on fragments split as they were loaded, a
// cp.async double buffer) at 22-29% of the bound was splitting every
// operand fragment again at each use, with scalar shared-memory loads.
// The design:
//   - D: one block per (batch * head, 64 NC queries) of a producer
//     warpgroup and NC consumer warpgroups of 64 queries each (NC = 2 at
//     head dim 64). Q comes in once by TMA and each consumer warpgroup
//     splits its own 64 rows once. K and V stream in
//     tiles of 32 keys through a TMA ring of SR stages (full / empty
//     mbarriers); the consumers split each K tile's rows in place and write
//     V's transposed copy into one of two slots, once a tile, together
//     (V is read only by P V, so its tile stays as TMA wrote it). O stays
//     in f32 registers and is written once, with lse.
//   - G: one block per (batch * head, 64 NC keys): K and V come in once by
//     TMA and each consumer warpgroup splits its own 64 rows once. q and dO
//     stream in tiles of 32 queries through the ring; the producer's second
//     warp copies each tile's lse * log2(e) and delta rows into the stage
//     and arrives on the same full barrier (1 + 32 arrivals). dK and dV
//     stay in f32 registers and are written once.
//   - H: the same turned around: 64 NC queries a block, Q and dO resident
//     and split once, the block's lse and delta rows copied once; K and V
//     tiles of 32 keys stream through the ring; dQ in registers. No atomics:
//     dQ has its own kernel, and the result is deterministic.
//   - A split tile of R rows keeps, in each 128-byte atom (32 columns), its R
//     rows as TMA wrote them, turned into their hi parts in place, and then R
//     rows of lo parts at the same swizzled offsets. The consumer warpgroups
//     split each streamed tile once, together, each pass under products already
//     in flight: its rows (under the previous tile's last products), read by
//     the products that sum over D (S = Q K^T in D; S^T = K q^T, dP^T = V
//     dO^T in G; S = Q K^T, dP = dO V^T in H), and its transposed copy, hi
//     and lo (under the score products), read by the products that sum
//     over the streamed index (O += P V in D; dV += P^T dO, dK += dS^T q in
//     G; dQ += dS K in H): TF32 wgmma has no transpose bit, both operands
//     are K-major, so such a B operand needs the streamed index contiguous.
//     The transpose costs no extra pass: the split touches every element
//     anyway. A named barrier of the consumers hands each pass's shares
//     over (after a proxy fence), and one at the end of each tile frees
//     what it read.
//   - products: a score tile (64 x 32) by one wgmma m64n64k8 of A's hi
//     against B's hi and lo rows at once (they lie next to each other)
//     and one m64n32k8 of A's lo against B's hi, both from shared memory,
//     the two halves added after the wait: A is read once for two of the
//     three products (7 KB a k8 step, not 9 KB). P (D), P^T and dS^T (G)
//     or dS (H) are split in registers and fed as
//     A from registers (m64nDk8, 3 a k8 step). An accumulator's column
//     pair (2u, 2u + 1) of each 8 is A's k-columns u and u + 4: the
//     transposed copy is written with its positions in that order
//     (split_t), no shuffle.
//   - D's online softmax runs in f32 and base 2 on the folded score
//     fragments (row max and sum over the four threads of a row,
//     ex2.approx), under products: tile t's S and tile t - 1's P V are
//     issued together, O rescaled before them; the softmax of tile t runs
//     while P V is in flight, and only a wgmma writes O in flight.
//   - masks: keys past Skv get -inf in D and ds = 0 in H, queries past Sq
//     p = 0 in G (TMA's zero fill gives s = 0, not -inf, and lse = 0 gives
//     p = 1); 4-D tensor maps (D, H, S, B), so the fill never reads the
//     next batch or head; rows past S are not stored.
//   - shared memory decides the tile sizes. Head dim 64, G: K and V with
//     their lo rows 128 KB, two ring stages of q and dO with their lo rows
//     2 x 32 KB, two transposed slots (dO^T, q^T, hi and lo) 2 x 16 KB:
//     224 of the 227 KB. H: 128 + 2 x 32 + one 16 KB slot (K^T). A
//     streamed tile of 64 would not fit; keeping the hi parts in the TMA
//     tile itself is what makes 32 fit. Head dim 128 (not a speed target: the
//     UNet runs 64): one consumer warpgroup (64 rows a block), one ring
//     stage and one slot, G splitting q^T after dV's products: 128 + 64 +
//     32 KB. A transposed row is one atom, so the streamed tile is 32. D:
//     Q with its lo rows 64 KB, a stage (K with its lo rows, V) 24 KB, a
//     slot 16 KB; four stages and two slots, 193 KB. Head dim 128: one
//     consumer, 64 + 2 x 48 + 2 x 32 KB.
//   - registers: ptxas gives each thread of a 384-thread block 168,
//     setmaxnreg or not; G at head dim 64 holds dK, dV (64) and the score
//     tiles' halves (64), then dK, dV and the split P^T, dS^T fragments
//     (64). That rules out what would lift the products' rate next (in
//     street_crafter_tpu_torch/scripts/tf32_wgmma_rates.py's loops, the
//     register-A m64n64k8 of the update products runs well below the TF32
//     peak and an m64n128k8 near it, and the score pair gains with A_hi
//     from registers): both need dK, dV or Q, dO's hi fragments in more
//     registers than a 384-thread block has. D at head dim 64 holds O
//     (32), the score pair (32) and P's split fragments (32); Q_hi fits
//     beside them as register-A fragments, but that form (the score pair
//     at 91.5% of TF32's peak in the rates script, not 84.7%) ran no
//     faster than this one within the card's spread (PERF.md's findings
//     on the f32 D), so Q stays a split tile in shared memory.
// Where this goes wrong, and how the design guards against it:
//   - descriptor offsets in TMA's 128-byte swizzle: a K-major f32 row of 32
//     values is one atom, a k8 step advances 32 bytes in it, eight rows
//     (1024 bytes) are the stride offset; the lo rows lie R * 128 bytes
//     after the raw ones (R a multiple of 8, so the swizzle's row phase
//     holds); the split pass computes the same swizzle by hand (swz).
//     Wrong offsets give wrong numbers, not a crash: the card tests' ragged
//     grid crosses every tile edge;
//   - asynchronous products: wgmma.fence before each group, commit, and a
//     wait before its accumulators are read; nothing but a wgmma writes an
//     accumulator in flight (ptxas serialises otherwise, C7515), and the
//     register A fragments are not touched until the wait;
//   - shared memory that threads write and wgmma reads: each writer fences
//     the async proxy before the consumers' named barrier; a slot or lo
//     region is rewritten only after the named barrier that ends each
//     tile, which every consumer passes after waiting on its products; a
//     ring stage is reloaded only after all 128 NC consumer threads have
//     released it (both consumers read every streamed tile);
//   - the mbarrier trap: a wait that lasts seconds is a deadlock and traps,
//     so the launch fails instead of hanging the card;
//   - dynamic shared memory above 48 KB needs cudaFuncSetAttribute, whose
//     error is returned like a refused launch's.
// delta = rowsum(dO * O) is one torch op in the wrapper (f32), as for the
// bf16 forms.
//
// Replaces, as the bf16 forms do: street_crafter_tpu/ops/flash_attention.py
// :29 _flash_kernel (K4, with and without lse), :195 _bwd_dkv_kernel (K5)
// and :246 _bwd_dq_kernel (K6), which follow their inputs' dtype and so run
// in f32 under the JAX package's float32 compute dtype.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// --------------------------------------------- pieces of kernels D, G and H

__device__ __forceinline__ float4 lds4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts4(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts1(uint32_t a, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v) : "memory");
}

// Byte offset of 16-byte chunk k of row r in a 1024-aligned tile of
// 128-byte rows, in TMA's 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int k) {
  return r * 128 + ((k ^ (r & 7)) << 4);
}

// The named barrier of the consumer warpgroups (NT threads).
template <int NT>
__device__ __forceinline__ void consumers_sync() {
  bar_sync(1, NT);
}

// Split tiles: a tile of R rows x 32 NA f32 columns lies as NA atoms 256 R
// bytes apart, each its R rows as TMA wrote them, turned into their hi
// parts in place (tf32_hi), then R rows of lo parts at the same swizzled
// offsets.
//
// Splits rows [row0, row0 + 32 RB) of a split tile, by the warps
// w, w + NW, ...: a task is one 16-byte chunk of 32 rows, the lane's row
// (a warp's loads and stores then take the fewest wavefronts).
template <int NA, int R, int RB, int NW>
__device__ __forceinline__ void split_rows(uint32_t tile, int row0, int w,
                                         int lane) {
  constexpr int TASKS = NA * 8 * RB;
  static_assert(TASKS % NW == 0, "whole tasks a warp");
#pragma unroll
  for (int i = 0; i < TASKS / NW; ++i) {
    const int task = w + i * NW;
    const int a = task / (8 * RB), k = task % 8, rb = (task / 8) % RB;
    const int r = row0 + 32 * rb + lane;
    const uint32_t at = tile + a * (256 * R) + swz(r, k);
    const float4 x = lds4(at);
    const float4 hi = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z),
                                  tf32_hi(x.w));
    sts4(at, hi);
    sts4(at + 128 * R, make_float4(tf32_lo(x.x, hi.x), tf32_lo(x.y, hi.y),
                                   tf32_lo(x.z, hi.z), tf32_lo(x.w, hi.w)));
  }
}

// The transposed copy of a 32-row tile, split: hi at t_hi and lo 32 NA *
// 128 bytes further. Its row c is the tile's column c, one 128-byte atom
// whose position 8 j + u holds the tile's row 8 j + 2 u and position
// 8 j + u + 4 its row 8 j + 2 u + 1 (u < 4), the k order of the
// register-A score fragments (tf32_frags). The tile is a split tile after
// split_rows (its rows, the streamed index, in their hi form), or with RAW
// 32 rows as TMA wrote them (atoms 32 * 128 bytes apart: kernel D's V,
// which no product reads by rows). A warp's scalar stores fall on 32
// distinct banks (one row c, 32 positions).
template <int NA, int NW, bool RAW = false>
__device__ __forceinline__ void split_t(uint32_t tile, uint32_t t_hi, int w,
                                        int lane) {
  constexpr int TASKS = NA * 8;
  constexpr uint32_t T_LO = NA * 32 * 128, ATOM = (RAW ? 128 : 256) * 32;
  static_assert(TASKS % NW == 0, "whole tasks a warp");
  const int p = (lane & ~7) | ((lane & 7) >> 1) | ((lane & 1) << 2);
#pragma unroll
  for (int i = 0; i < TASKS / NW; ++i) {
    const int task = w + i * NW;
    const int a = task / 8, k = task % 8;
    const float4 x = lds4(tile + a * ATOM + swz(lane, k));
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 32 * a + 4 * k + e;
      const uint32_t o =
          t_hi + c * 128 + (((p >> 2) ^ (c & 7)) << 4) + 4 * (p & 3);
      const float hi = RAW ? tf32_hi(v[e]) : v[e];
      sts1(o, hi);
      sts1(o + T_LO, tf32_lo(RAW ? v[e] : tf32_x(v[e]), hi));
    }
  }
}

// acc = A B^T over 32 NA columns in 3xTF32, both split tiles, K-major:
// A's 64 rows at a (atoms a_atom bytes apart, lo rows a_lo bytes after the
// hi ones), B's N / 2 rows at b likewise, its lo rows right after them.
// One m64nNk8 product takes A's hi against B's hi and lo rows together
// (acc's first N / 2 columns A_hi B_hi, the rest A_hi B_lo: A is read
// once for both) and one m64n(N / 2)k8 adds A_lo B_hi to the first half;
// the caller adds the halves. Shared memory a k8 step: 7 KB, not the 9 KB
// of three separate m64n32k8 products.
template <int NA, int N>
__device__ __forceinline__ void mma3_ss(float (&acc)[N], uint32_t a,
                                        uint32_t a_atom, uint32_t a_lo,
                                        uint32_t b, uint32_t b_atom) {
  float(&head)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&acc);
#pragma unroll
  for (int i = 0; i < NA; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t ao = a + i * a_atom + 32 * kk;
      const uint32_t bo = b + i * b_atom + 32 * kk;
      wgmma_tf32(acc, desc(ao, 16, 1024), desc(bo, 16, 1024), i + kk > 0);
      wgmma_tf32(head, desc(ao + a_lo, 16, 1024), desc(bo, 16, 1024), 1);
    }
}

// The score tile of mma3_ss's accumulator: its two halves summed.
template <int N>
__device__ __forceinline__ void fold(const float (&acc)[2 * N],
                                     float (&s)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) s[r] = acc[r] + acc[N + r];
}

// acc += A B^T in 3xTF32 over 8 K8 positions: A as register fragments (hi,
// lo), B a transposed copy (split_t: rows of one atom, hi at b, lo b_lo
// bytes further).
template <int K8, int N>
__device__ __forceinline__ void mma3_rs(float (&acc)[N],
                                        const uint32_t (&ah)[K8][4],
                                        const uint32_t (&al)[K8][4],
                                        uint32_t b, uint32_t b_lo) {
#pragma unroll
  for (int j = 0; j < K8; ++j) {
    wgmma_tf32(acc, al[j], desc(b + 32 * j, 16, 1024));
    wgmma_tf32(acc, ah[j], desc(b + b_lo + 32 * j, 16, 1024));
    wgmma_tf32(acc, ah[j], desc(b + 32 * j, 16, 1024));
  }
}

// The register-A fragments (hi, lo) of K8 k8 steps from an m64n(8 K8) f32
// accumulator: step j is its columns 8 j .. 8 j + 7, of which a thread
// holds 2 t and 2 t + 1 in rows g and g + 8; A's k-column t is taken from
// column 2 t and k-column t + 4 from 2 t + 1 (split_t writes the B tiles'
// positions in that order).
template <int K8>
__device__ __forceinline__ void tf32_frags(uint32_t (&hi)[K8][4],
                                           uint32_t (&lo)[K8][4],
                                           const float (&d)[4 * K8]) {
#pragma unroll
  for (int j = 0; j < K8; ++j) {
    const float x[4] = {d[4 * j], d[4 * j + 2], d[4 * j + 1], d[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float h = tf32_hi(x[e]);
      hi[j][e] = __float_as_uint(h);
      lo[j][e] = __float_as_uint(tf32_lo(x[e], h));
    }
  }
}

// ------------------------------------------------------------- kernel D

// S = Q K^T of the key tile at ks into the pair's accumulator (issued and
// committed, not waited for; fold sums its halves): Q a split tile of RQ
// rows, this warpgroup's 64 at qa.
template <int NA, int RQ>
__device__ __forceinline__ void qk_tile(float (&acc)[32], uint32_t qa,
                                        uint32_t ks) {
  fence_regs(acc);
  wgmma_fence();
  mma3_ss<NA>(acc, qa, 256 * RQ, RQ * 128, ks, 256 * 32);
  wgmma_commit();
  fence_regs(acc);
}

// O += P V of one key tile (issued and committed): P's split fragments in
// registers, V^T's split copy at slot (D rows of hi, then of lo).
template <int N>
__device__ __forceinline__ void pv_tile(float (&acc)[N],
                                        const uint32_t (&ph)[4][4],
                                        const uint32_t (&pl)[4][4],
                                        uint32_t slot) {
  fence_regs(acc);
  wgmma_fence();
  mma3_rs(acc, ph, pl, slot, 2 * N * 128);
  wgmma_commit();
  fence_regs(acc);
}

// Dynamic shared memory of kernel D in f32: the alignment pad, Q (a split
// tile of 64 NC rows), SR ring stages (K as a split tile of BK rows, then
// V as TMA wrote it), two transposed slots (V^T of the even and the odd
// tiles, hi then lo) and the barriers (q_full, SR full, SR empty).
template <int D, int NC, int BK, int SR>
constexpr int fwd_smem_bytes() {
  return 1024 + (D / 32) * 256 * 64 * NC +
         SR * 3 * (D / 32) * 128 * BK + 2 * 2 * D * 128 + 8 * (1 + 2 * SR);
}

// o (and lse) of 64 NC query rows of one (batch, head), key tiles of BK
// keys: grid q_tiles * B * H, a producer warpgroup and NC consumers.
template <int D, int NC, int BK, int SR, bool LSE>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_fwd_f32_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     float* __restrict__ o, float* __restrict__ lse, int H,
                     int Sq, int Skv, int q_tiles, float sl2) {
  static_assert(BK == 32, "a transposed row is one atom of BK positions");
  constexpr int NA = D / 32, RQ = 64 * NC, NT = 128 * NC, NW = 4 * NC;
  constexpr uint32_t QATOM = 256 * RQ, QTILE = NA * QATOM;
  constexpr uint32_t KATOM = 256 * BK, KTILE = NA * KATOM;
  constexpr uint32_t VATOM = 128 * BK, STAGE = KTILE + NA * VATOM;
  constexpr uint32_t SLOT = 2 * D * 128;
  extern __shared__ uint8_t smem_b[];
  const uint32_t sq = (smem_u32(smem_b) + 1023) & ~1023u;
  const uint32_t ring = sq + QTILE;          // stage s: K, then V
  const uint32_t slots = ring + SR * STAGE;  // V^T of even, odd tiles
  const uint32_t q_full = slots + 2 * SLOT;
  const uint32_t full = q_full + 8, empty = full + 8 * SR;

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int n_kv = (Skv + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < SR; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread issues TMA
    if constexpr (NC == 2) regs_dec<24>();
    if (tid == 0) {
      mbar_expect_tx(q_full, NA * RQ * 128);
      for (int a = 0; a < NA; ++a)
        tma_load(sq + a * QATOM, &tq, q_full, 32 * a, h, RQ * qt, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % SR;
        mbar_wait(empty + 8 * s, ((t / SR) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * NA * BK * 128);
        const uint32_t ks = ring + s * STAGE;
        for (int a = 0; a < NA; ++a) {
          tma_load(ks + a * KATOM, &tk, full + 8 * s, 32 * a, h, BK * t, b);
          tma_load(ks + KTILE + a * VATOM, &tv, full + 8 * s, 32 * a, h,
                   BK * t, b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63
    if constexpr (NC == 2) regs_inc<240>();
    const int cw = wg - 1, ct = threadIdx.x - 128;
    const int cwarp = ct / 32, lane = ct % 32, warp = cwarp % 4;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = RQ * qt + 64 * cw + 16 * warp + g, r1 = r0 + 8;
    const uint32_t qa = sq + cw * 64 * 128;

    // Q: each warpgroup splits its own 64 rows, once a block; then the
    // first K tile, by all consumers
    mbar_wait(q_full, 0);
    split_rows<NA, RQ, 2, 4>(sq, 64 * cw, warp, lane);
    mbar_wait(full, 0);
    split_rows<NA, BK, 1, NW>(ring, 0, cwarp, lane);
    fence_async_smem();
    consumers_sync<NT>();

    float acc[D / 2];  // O: m64nD accumulator, rows g and g + 8 of the warp
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max (base 2, scaled)
    float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
    float al0 = 0.f, al1 = 0.f;            // O's rescale before the next P V
    uint32_t ph[BK / 8][4], pl[BK / 8][4];  // P of the last tile, split

    // Tile t's S and tile t - 1's P V are issued together; V^T of tile t
    // and tile t + 1's K rows are split while they run, and tile t's
    // softmax runs while P V is still in flight. Tile 0 has its S alone,
    // the last P V comes after the loop.
    {
      float acc_s[BK];  // hi and lo halves (the pair)
      qk_tile<NA, RQ>(acc_s, qa, ring);
      split_t<NA, NW, true>(ring + KTILE, slots, cwarp, lane);
      if (n_kv > 1) {
        mbar_wait(full + 8 * (1 % SR), (1 / SR) & 1);
        split_rows<NA, BK, 1, NW>(ring + (1 % SR) * STAGE, 0, cwarp, lane);
      }
      fence_async_smem();
      wgmma_wait<0>();
      fence_regs(acc_s);
      mbar_arrive(empty);  // this thread's last read of the stage
      float sc[BK / 2];
      fold(acc_s, sc);
      softmax_tile(sc, 0, Skv, t4, sl2, m0, m1, l0, l1, al0, al1);
      tf32_frags(ph, pl, sc);
      consumers_sync<NT>();  // V^T of tile 0 and K of tile 1 complete
    }
    for (int t = 1; t < n_kv; ++t) {
      const int s = t % SR;
      const uint32_t ks = ring + s * STAGE;
      float acc_s[BK];
      rescale(acc, al0, al1);  // tile t - 2's P V is done
      qk_tile<NA, RQ>(acc_s, qa, ks);
      pv_tile(acc, ph, pl, slots + ((t - 1) & 1) * SLOT);
      split_t<NA, NW, true>(ks + KTILE, slots + (t & 1) * SLOT, cwarp, lane);
      if (t + 1 < n_kv) {
        const int s1 = (t + 1) % SR;
        mbar_wait(full + 8 * s1, ((t + 1) / SR) & 1);
        split_rows<NA, BK, 1, NW>(ring + s1 * STAGE, 0, cwarp, lane);
      }
      fence_async_smem();
      wgmma_wait<1>();  // S
      fence_regs(acc_s);
      mbar_arrive(empty + 8 * s);
      float sc[BK / 2];
      fold(acc_s, sc);
      softmax_tile(sc, BK * t, Skv, t4, sl2, m0, m1, l0, l1, al0, al1);
      wgmma_wait<0>();  // P V
      fence_regs(acc);
      tf32_frags(ph, pl, sc);
      consumers_sync<NT>();  // V^T of tile t and K of tile t + 1 complete
    }
    rescale(acc, al0, al1);
    pv_tile(acc, ph, pl, slots + ((n_kv - 1) & 1) * SLOT);
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (LSE && t4 == 0) {
      // natural-log logsumexp of the scaled scores: (m + log2 l) ln 2
      if (r0 < Sq) lse[(long)bh * Sq + r0] = (m0 + log2f(l0)) * LN2;
      if (r1 < Sq) lse[(long)bh * Sq + r1] = (m1 + log2f(l1)) * LN2;
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const long rs = (long)H * D;
    float* ob = o + ((long)b * Sq * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t4;
      if (r0 < Sq)
        *reinterpret_cast<float2*>(ob + r0 * rs + col) =
            make_float2(acc[4 * c] * inv0, acc[4 * c + 1] * inv0);
      if (r1 < Sq)
        *reinterpret_cast<float2*>(ob + r1 * rs + col) =
            make_float2(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1);
    }
  }
}

// ------------------------------------------------------ kernels G and H

// Dynamic shared memory of kernel G in f32: the alignment pad, K and V
// (split tiles of 64 NC rows), SR ring stages (q, then dO: split tiles of
// BQ rows), TS transposed slots (hi, then lo), the lse / delta rows of each
// stage and the barriers (kv_full, SR full, SR empty).
template <int D, int NC, int BQ, int SR, int TS>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * (D / 32) * 256 * 64 * NC + SR * 2 * (D / 32) * 256 * BQ +
         TS * 2 * D * 128 + SR * 2 * BQ * 4 + 8 * (1 + 2 * SR);
}

// dK, dV of 64 NC keys of one (batch, head), q tiles of BQ queries: grid
// k_tiles * B * H, a producer warpgroup and NC consumers. TS = 2: dO^T and
// q^T have a slot each, q^T is split while dV's products run; TS = 1: one
// slot, q^T is split after them.
template <int D, int NC, int BQ, int SR, int TS>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_bwd_dkv_f32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Sq, int Skv, int k_tiles, float scale,
                         float sl2) {
  static_assert(BQ == 32, "a transposed row is one atom of BQ positions");
  constexpr int NA = D / 32, RK = 64 * NC, NT = 128 * NC, NW = 4 * NC;
  constexpr uint32_t KATOM = 256 * RK, KTILE = NA * KATOM;
  constexpr uint32_t QATOM = 256 * BQ, QTILE = NA * QATOM;
  constexpr uint32_t SLOT = 2 * D * 128;
  extern __shared__ uint8_t smem_b[];
  const uint32_t sk = (smem_u32(smem_b) + 1023) & ~1023u;
  const uint32_t sv = sk + KTILE;
  const uint32_t ring = sv + KTILE;               // stage s: q, then dO
  const uint32_t slots = ring + SR * 2 * QTILE;   // dO^T, then q^T
  const uint32_t rows = slots + TS * SLOT;        // stage s: lse, delta
  const uint32_t kv_full = rows + SR * 2 * BQ * 4;
  const uint32_t full = kv_full + 8, empty = full + 8 * SR;
  float* const row_buf =
      reinterpret_cast<float*>(smem_b + (rows - smem_u32(smem_b)));

  const int bh = blockIdx.x / k_tiles, kt = blockIdx.x - bh * k_tiles;
  const int b = bh / H, h = bh - b * H;
  const int n_q = (Sq + BQ - 1) / BQ;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < SR; ++s) {
      mbar_init(full + 8 * s, 1 + 32);  // the TMA thread + the row warp
      mbar_init(empty + 8 * s, NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0 issues TMA, warp 1 copies the rows
    if constexpr (NC == 2) regs_dec<24>();
    const int warp = tid / 32, lane = tid % 32;
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * NA * RK * 128);
      for (int a = 0; a < NA; ++a) {
        tma_load(sk + a * KATOM, &tk, kv_full, 32 * a, h, RK * kt, b);
        tma_load(sv + a * KATOM, &tv, kv_full, 32 * a, h, RK * kt, b);
      }
      for (int t = 0; t < n_q; ++t) {
        const int s = t % SR;
        mbar_wait(empty + 8 * s, ((t / SR) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * NA * BQ * 128);
        const uint32_t qs = ring + 2 * s * QTILE;
        for (int a = 0; a < NA; ++a) {
          tma_load(qs + a * QATOM, &tq, full + 8 * s, 32 * a, h, BQ * t, b);
          tma_load(qs + QTILE + a * QATOM, &tdo, full + 8 * s, 32 * a, h,
                   BQ * t, b);
        }
      }
    } else if (warp == 1) {
      const float* lrow = lse + (long)bh * Sq;
      const float* drow = delta + (long)bh * Sq;
      for (int t = 0; t < n_q; ++t) {
        const int s = t % SR;
        mbar_wait(empty + 8 * s, ((t / SR) & 1) ^ 1);
        float* lr = row_buf + 2 * BQ * s;
        for (int i = lane; i < BQ; i += 32) {
          const int q = BQ * t + i;
          lr[i] = q < Sq ? lrow[q] * LOG2E : 0.f;
          lr[BQ + i] = q < Sq ? drow[q] : 0.f;
        }
        mbar_arrive(full + 8 * s);
      }
    }
  } else {
    // consumers: warpgroup cw owns keys 64 cw .. 64 cw + 63 of the block
    if constexpr (NC == 2) regs_inc<240>();
    const int cw = wg - 1, ct = threadIdx.x - 128;
    const int cwarp = ct / 32, lane = ct % 32, warp = cwarp % 4;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t ka = sk + cw * 64 * 128, va = sv + cw * 64 * 128;
    const uint32_t slot_do = slots, slot_q = slots + (TS - 1) * SLOT;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;

    // K and V: each warpgroup splits its own 64 rows, once a block; then
    // the first q / dO tile, by all consumers
    mbar_wait(kv_full, 0);
    split_rows<NA, RK, 2, 4>(sk, 64 * cw, warp, lane);
    split_rows<NA, RK, 2, 4>(sv, 64 * cw, warp, lane);
    mbar_wait(full, 0);
    split_rows<NA, BQ, 1, NW>(ring, 0, cwarp, lane);
    split_rows<NA, BQ, 1, NW>(ring + QTILE, 0, cwarp, lane);
    fence_async_smem();
    consumers_sync<NT>();

    for (int t = 0; t < n_q; ++t) {
      const int s = t % SR;
      const uint32_t qs = ring + 2 * s * QTILE, os = qs + QTILE;

      // S^T = K q^T and dP^T = V dO^T: 64 keys x BQ queries each; dO^T is
      // split while they run
      float acc_s[BQ], acc_dp[BQ];  // hi and lo halves (mma3_ss)
      fence_regs(acc_s);
      fence_regs(acc_dp);
      wgmma_fence();
      mma3_ss<NA>(acc_s, ka, KATOM, RK * 128, qs, QATOM);
      mma3_ss<NA>(acc_dp, va, KATOM, RK * 128, os, QATOM);
      wgmma_commit();
      fence_regs(acc_s);
      fence_regs(acc_dp);
      split_t<NA, NW>(os, slot_do, cwarp, lane);
      fence_async_smem();
      wgmma_wait<0>();
      fence_regs(acc_s);
      fence_regs(acc_dp);
      float st[BQ / 2], dpt[BQ / 2];
      fold(acc_s, st);
      fold(acc_dp, dpt);

      // p^T and ds^T on the fragments; column c is query BQ t + c; queries
      // past Sq get p = 0 (their zero-filled q would give p = exp(-lse))
      const float* lr = row_buf + 2 * BQ * s;  // lse * log2(e), then delta
      const bool ragged = BQ * (t + 1) > Sq;
#pragma unroll
      for (int r = 0; r < BQ / 2; ++r) {
        const int c = 8 * (r / 4) + 2 * t4 + (r & 1);
        float p = ex2(fmaf(st[r], sl2, -lr[c]));
        if (ragged && BQ * t + c >= Sq) p = 0.f;
        st[r] = p;
        dpt[r] = p * (dpt[r] - lr[BQ + c]) * scale;
      }
      uint32_t ph[BQ / 8][4], pl[BQ / 8][4], sh[BQ / 8][4], sl[BQ / 8][4];
      tf32_frags(ph, pl, st);
      tf32_frags(sh, sl, dpt);
      consumers_sync<NT>();  // dO^T complete

      // dV += P^T dO, then dK += dS^T q (q^T split in between)
      fence_regs(dva);
      wgmma_fence();
      mma3_rs(dva, ph, pl, slot_do, D * 128);
      wgmma_commit();
      fence_regs(dva);
      if constexpr (TS == 1) {  // one slot: dV's products read it first
        wgmma_wait<0>();
        fence_regs(dva);
        consumers_sync<NT>();
      }
      split_t<NA, NW>(qs, slot_q, cwarp, lane);
      fence_async_smem();
      mbar_arrive(empty + 8 * s);  // this thread's last read of the stage
      consumers_sync<NT>();        // q^T complete
      fence_regs(dka);
      wgmma_fence();
      mma3_rs(dka, sh, sl, slot_q, D * 128);
      wgmma_commit();
      fence_regs(dka);

      // the next tile's rows split while the products run
      if (t + 1 < n_q) {
        const int s1 = (t + 1) % SR;
        const uint32_t q1 = ring + 2 * s1 * QTILE;
        mbar_wait(full + 8 * s1, ((t + 1) / SR) & 1);
        split_rows<NA, BQ, 1, NW>(q1, 0, cwarp, lane);
        split_rows<NA, BQ, 1, NW>(q1 + QTILE, 0, cwarp, lane);
        fence_async_smem();
      }
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
      consumers_sync<NT>();  // tile t's products done everywhere
    }

    const int k0 = RK * kt + 64 * cw + 16 * warp + g, k1 = k0 + 8;
    const long rs = (long)H * D;
    const long off = ((long)b * Skv * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t4;
      if (k0 < Skv) {
        *reinterpret_cast<float2*>(dk + off + k0 * rs + col) =
            make_float2(dka[4 * c], dka[4 * c + 1]);
        *reinterpret_cast<float2*>(dv + off + k0 * rs + col) =
            make_float2(dva[4 * c], dva[4 * c + 1]);
      }
      if (k1 < Skv) {
        *reinterpret_cast<float2*>(dk + off + k1 * rs + col) =
            make_float2(dka[4 * c + 2], dka[4 * c + 3]);
        *reinterpret_cast<float2*>(dv + off + k1 * rs + col) =
            make_float2(dva[4 * c + 2], dva[4 * c + 3]);
      }
    }
  }
}

// p = exp2(s * scale * log2(e) - lse * log2(e)) and ds = p (dp - delta)
// scale on the fragments of one key tile (keys kv0 .. kv0 + 2 N - 1); ds
// replaces dp. Keys past Skv are masked explicitly (ds = 0): TMA's zero
// fill gives s = 0 there, not -inf. ls and dl: lse * log2(e) and delta of
// rows g and g + 8.
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

// Dynamic shared memory of kernel H in f32: the alignment pad, Q and dO
// (split tiles of 64 NC rows), SR ring stages (K, then V: split tiles of
// BK rows), one transposed slot (K^T, hi then lo), the block's lse / delta
// rows and the barriers (q_full, SR full, SR empty).
template <int D, int NC, int BK, int SR>
constexpr int dq_smem_bytes() {
  return 1024 + 2 * (D / 32) * 256 * 64 * NC + SR * 2 * (D / 32) * 256 * BK +
         2 * D * 128 + 2 * 64 * NC * 4 + 8 * (1 + 2 * SR);
}

// dQ of 64 NC query rows of one (batch, head), key tiles of BK keys: grid
// q_tiles * B * H, a producer warpgroup and NC consumers.
template <int D, int NC, int BK, int SR>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Sq, int Skv,
                        int q_tiles, float scale, float sl2) {
  static_assert(BK == 32, "a transposed row is one atom of BK positions");
  constexpr int NA = D / 32, RQ = 64 * NC, NT = 128 * NC, NW = 4 * NC;
  constexpr uint32_t QATOM = 256 * RQ, QTILE = NA * QATOM;
  constexpr uint32_t KATOM = 256 * BK, KTILE = NA * KATOM;
  extern __shared__ uint8_t smem_b[];
  const uint32_t sq = (smem_u32(smem_b) + 1023) & ~1023u;
  const uint32_t sdo = sq + QTILE;
  const uint32_t ring = sdo + QTILE;               // stage s: K, then V
  const uint32_t slot = ring + SR * 2 * KTILE;     // K^T: hi, then lo
  const uint32_t rows = slot + 2 * D * 128;        // lse * log2(e), delta
  const uint32_t q_full = rows + 2 * RQ * 4;
  const uint32_t full = q_full + 8, empty = full + 8 * SR;
  float* const row_buf =
      reinterpret_cast<float*>(smem_b + (rows - smem_u32(smem_b)));

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int n_kv = (Skv + BK - 1) / BK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1 + 32);  // the TMA thread + the row warp
    for (int s = 0; s < SR; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0 issues TMA, warp 1 copies the rows
    if constexpr (NC == 2) regs_dec<24>();
    const int warp = tid / 32, lane = tid % 32;
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * NA * RQ * 128);
      for (int a = 0; a < NA; ++a) {
        tma_load(sq + a * QATOM, &tq, q_full, 32 * a, h, RQ * qt, b);
        tma_load(sdo + a * QATOM, &tdo, q_full, 32 * a, h, RQ * qt, b);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % SR;
        mbar_wait(empty + 8 * s, ((t / SR) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * NA * BK * 128);
        const uint32_t ks = ring + 2 * s * KTILE;
        for (int a = 0; a < NA; ++a) {
          tma_load(ks + a * KATOM, &tk, full + 8 * s, 32 * a, h, BK * t, b);
          tma_load(ks + KTILE + a * KATOM, &tv, full + 8 * s, 32 * a, h,
                   BK * t, b);
        }
      }
    } else if (warp == 1) {
      const float* lrow = lse + (long)bh * Sq;
      const float* drow = delta + (long)bh * Sq;
      for (int i = lane; i < RQ; i += 32) {
        const int q = RQ * qt + i;
        row_buf[i] = q < Sq ? lrow[q] * LOG2E : 0.f;
        row_buf[RQ + i] = q < Sq ? drow[q] : 0.f;
      }
      mbar_arrive(q_full);
    }
  } else {
    // consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63
    if constexpr (NC == 2) regs_inc<240>();
    const int cw = wg - 1, ct = threadIdx.x - 128;
    const int cwarp = ct / 32, lane = ct % 32, warp = cwarp % 4;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t qa = sq + cw * 64 * 128, oa = sdo + cw * 64 * 128;
    float acc[D / 2];  // dQ: m64nD accumulator, rows g and g + 8 of the warp
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // Q and dO: each warpgroup splits its own 64 rows, once a block; then
    // the first K / V tile, by all consumers
    mbar_wait(q_full, 0);
    const int lr = 64 * cw + 16 * warp + g;  // row g within the block
    const float ls0 = row_buf[lr], ls1 = row_buf[lr + 8];
    const float dl0 = row_buf[RQ + lr], dl1 = row_buf[RQ + lr + 8];
    split_rows<NA, RQ, 2, 4>(sq, 64 * cw, warp, lane);
    split_rows<NA, RQ, 2, 4>(sdo, 64 * cw, warp, lane);
    mbar_wait(full, 0);
    split_rows<NA, BK, 1, NW>(ring, 0, cwarp, lane);
    split_rows<NA, BK, 1, NW>(ring + KTILE, 0, cwarp, lane);
    fence_async_smem();
    consumers_sync<NT>();

    for (int t = 0; t < n_kv; ++t) {
      const int s = t % SR;
      const uint32_t ks = ring + 2 * s * KTILE, vs = ks + KTILE;

      // S = Q K^T and dP = dO V^T: 64 queries x BK keys each; K^T is split
      // while they run
      float acc_s[BK], acc_dp[BK];  // hi and lo halves (mma3_ss)
      fence_regs(acc_s);
      fence_regs(acc_dp);
      wgmma_fence();
      mma3_ss<NA>(acc_s, qa, QATOM, RQ * 128, ks, KATOM);
      mma3_ss<NA>(acc_dp, oa, QATOM, RQ * 128, vs, KATOM);
      wgmma_commit();
      fence_regs(acc_s);
      fence_regs(acc_dp);
      split_t<NA, NW>(ks, slot, cwarp, lane);
      fence_async_smem();
      wgmma_wait<0>();
      fence_regs(acc_s);
      fence_regs(acc_dp);
      mbar_arrive(empty + 8 * s);  // this thread's last read of the stage
      float st[BK / 2], dpt[BK / 2];
      fold(acc_s, st);
      fold(acc_dp, dpt);

      ds_tile(st, dpt, BK * t, Skv, t4, sl2, scale, ls0, ls1, dl0, dl1);
      uint32_t sh[BK / 8][4], sl[BK / 8][4];
      tf32_frags(sh, sl, dpt);
      consumers_sync<NT>();  // K^T complete

      // dQ += dS K
      fence_regs(acc);
      wgmma_fence();
      mma3_rs(acc, sh, sl, slot, D * 128);
      wgmma_commit();
      fence_regs(acc);

      // the next tile's rows split while the products run
      if (t + 1 < n_kv) {
        const int s1 = (t + 1) % SR;
        const uint32_t k1 = ring + 2 * s1 * KTILE;
        mbar_wait(full + 8 * s1, ((t + 1) / SR) & 1);
        split_rows<NA, BK, 1, NW>(k1, 0, cwarp, lane);
        split_rows<NA, BK, 1, NW>(k1 + KTILE, 0, cwarp, lane);
        fence_async_smem();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      consumers_sync<NT>();  // tile t's products done everywhere
    }

    const int r0 = RQ * qt + lr, r1 = r0 + 8;
    const long rs = (long)H * D;
    float* qb = dq + ((long)b * Sq * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * t4;
      if (r0 < Sq)
        *reinterpret_cast<float2*>(qb + r0 * rs + col) =
            make_float2(acc[4 * c], acc[4 * c + 1]);
      if (r1 < Sq)
        *reinterpret_cast<float2*>(qb + r1 * rs + col) =
            make_float2(acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

// One TF32 product as the tensor cores compute it, on operands passed as
// they are: d = a b^T, a [64, 8] and b [8, 8] row-major f32, by wgmma
// m64n8k8 from two K-major tiles in the 128-byte swizzle. With b the
// identity, d shows the value a TF32 product reads of each f32 bit pattern
// of a (G and H rely on it being a with its low 13 mantissa bits cleared).
__global__ void __launch_bounds__(128)
tf32_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ d) {
  __shared__ uint8_t buf[1024 + 64 * 128 + 8 * 128];
  const uint32_t sa = (smem_u32(buf) + 1023) & ~1023u, sb = sa + 64 * 128;
  for (int i = threadIdx.x; i < 64 * 8; i += 128) {
    const int r = i / 8, c = i % 8;
    sts1(sa + swz(r, c / 4) + 4 * (c % 4), a[i]);
    if (i < 64) sts1(sb + swz(r, c / 4) + 4 * (c % 4), b[i]);
  }
  fence_async_smem();
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  fence_regs(acc);
  wgmma_fence();
  wgmma_tf32(acc, desc(sa, 16, 1024), desc(sb, 16, 1024), 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
  d[8 * r + c] = acc[0];
  d[8 * r + c + 1] = acc[1];
  d[8 * (r + 8) + c] = acc[2];
  d[8 * (r + 8) + c + 1] = acc[3];
}

// ------------------------------------------------------------- launches

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The 4-D TMA map of a [B, S, H, D] f32 tensor (dims innermost first: D, H,
// S, B), box {32, 1, rows, 1}: 32 columns (one 128-byte swizzle atom) of
// `rows` positions of one (batch, head); positions past S read as zeros.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
               int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)S * H * D * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int NC, int SR, bool LSE>
int launch_forward(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Skv, float scale,
                   cudaStream_t st) {
  constexpr int smem = fwd_smem_bytes<D, NC, 32, SR>();
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  auto kern = flash_fwd_f32_kernel<D, NC, 32, SR, LSE>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv;
  int err = tensor_map(&mq, q, B, Sq, H, D, 64 * NC);
  if (!err) err = tensor_map(&mk, k, B, Skv, H, D, 32);
  if (!err) err = tensor_map(&mv, v, B, Skv, H, D, 32);
  if (err) return err;
  const int q_tiles = (Sq + 64 * NC - 1) / (64 * NC);
  kern<<<(unsigned)(q_tiles * B * H), 128 * (NC + 1), smem, st>>>(
      mq, mk, mv, (float*)o, lse, H, Sq, Skv, q_tiles, scale * LOG2E);
  return (int)cudaGetLastError();
}

// Kernel D in f32: head dim 64 with two consumers and four ring stages,
// head dim 128 with one consumer and two (shared memory).
template <bool LSE>
int forward(const void* q, const void* k, const void* v, void* o, float* lse,
            int B, int H, int Sq, int Skv, int D, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch_forward<64, 2, 4, LSE>(q, k, v, o, lse, B, H, Sq, Skv,
                                         scale, st);
  if (D == 128)
    return launch_forward<128, 1, 2, LSE>(q, k, v, o, lse, B, H, Sq, Skv,
                                          scale, st);
  return (int)cudaErrorInvalidValue;
}

template <int D, int NC, int BQ, int SR, int TS>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Sq, int Skv, float scale, cudaStream_t st) {
  constexpr int smem = dkv_smem_bytes<D, NC, BQ, SR, TS>();
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  auto kern = flash_bwd_dkv_f32_kernel<D, NC, BQ, SR, TS>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv, mo;
  int err = tensor_map(&mq, q, B, Sq, H, D, BQ);
  if (!err) err = tensor_map(&mo, dout, B, Sq, H, D, BQ);
  if (!err) err = tensor_map(&mk, k, B, Skv, H, D, 64 * NC);
  if (!err) err = tensor_map(&mv, v, B, Skv, H, D, 64 * NC);
  if (err) return err;
  const int k_tiles = (Skv + 64 * NC - 1) / (64 * NC);
  kern<<<(unsigned)(k_tiles * B * H), 128 * (NC + 1), smem, st>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, H, Sq, Skv, k_tiles, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D, int NC, int BK, int SR>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Sq, int Skv, float scale, cudaStream_t st) {
  constexpr int smem = dq_smem_bytes<D, NC, BK, SR>();
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  auto kern = flash_bwd_dq_f32_kernel<D, NC, BK, SR>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mq, mk, mv, mo;
  int err = tensor_map(&mq, q, B, Sq, H, D, 64 * NC);
  if (!err) err = tensor_map(&mo, dout, B, Sq, H, D, 64 * NC);
  if (!err) err = tensor_map(&mk, k, B, Skv, H, D, BK);
  if (!err) err = tensor_map(&mv, v, B, Skv, H, D, BK);
  if (err) return err;
  const int q_tiles = (Sq + 64 * NC - 1) / (64 * NC);
  kern<<<(unsigned)(q_tiles * B * H), 128 * (NC + 1), smem, st>>>(
      mq, mk, mv, mo, (const float*)lse, (const float*)delta, (float*)dq, H,
      Sq, Skv, q_tiles, scale, scale * LOG2E);
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
    return launch_dkv<64, 2, 32, 2, 2>(q, k, v, dout, lse, delta, dk, dv, B,
                                       H, Sq, Skv, scale, st);
  if (D == 128)
    return launch_dkv<128, 1, 32, 1, 1>(q, k, v, dout, lse, delta, dk, dv, B,
                                        H, Sq, Skv, scale, st);
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
    return launch_dq<64, 2, 32, 2>(q, k, v, dout, lse, delta, dq, B, H, Sq,
                                   Skv, scale, st);
  if (D == 128)
    return launch_dq<128, 1, 32, 1>(q, k, v, dout, lse, delta, dq, B, H, Sq,
                                    Skv, scale, st);
  return (int)cudaErrorInvalidValue;
}

// One TF32 product of a [64, 8] and b [8, 8] f32 (row-major, contiguous)
// into d [64, 8] f32 = a b^T, the operands' bits passed as they are
// (tf32_probe_kernel).
int sc_tf32_probe_f32(const void* a, const void* b, void* d, void* stream) {
  tf32_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)d);
  return (int)cudaGetLastError();
}

}  // extern "C"
