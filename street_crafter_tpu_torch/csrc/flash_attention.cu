// Attention forward for Hopper (sm_90a): kernel D.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// flash_attention.py. The entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().
//
// Kernel D replaces street_crafter_tpu/ops/flash_attention.py:29
// _flash_kernel (K4), the TPU's online-softmax forward: q blocks over the
// grid, the whole (padded) K/V resident in VMEM, a ones column in V to get
// the softmax denominator out of the PV matmul, and the power-of-two scale
// folded into q. It computes o = softmax(q k^T * scale) v per (batch, head),
// non-causal, with f32 scores, running max and denominator, and no lse (the
// sampling path needs none).
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
//   - S = Q K^T and O += P V on the tensor cores with
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate); the score fragments are
//     reused in registers as the A operand of P V (the accumulator layout of
//     two n8 tiles is the A layout of one k16 step);
//   - the online softmax runs on the score fragments in f32: row max and
//     row sum over the four threads that share a row (shuffles), the running
//     output rescaled by exp(m_old - m_new) on each new tile;
//   - columns past Skv get -inf before the max; rows past Sq are computed on
//     zero queries and not stored (the ragged q edge).
// q, k, v and o are [B, S, H, D] bf16 (the layout the UNet's projections
// produce), read with the row stride H*D, so no transpose is needed.

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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int Sq, int Skv,
                 float scale) {
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

}  // namespace

extern "C" {

const char* sc_flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q, o: [B, Sq, H, D]; k, v: [B, Skv, H, D]; bf16, contiguous. D: 64 or 128.
int sc_flash_forward(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Sq, int Skv, int D, float scale,
                     void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + BQ - 1) / BQ));
  cudaStream_t st = (cudaStream_t)stream;
  const auto* qp = (const __nv_bfloat16*)q;
  const auto* kp = (const __nv_bfloat16*)k;
  const auto* vp = (const __nv_bfloat16*)v;
  auto* op = (__nv_bfloat16*)o;
  if (D == 64)
    flash_fwd_kernel<64><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, H, Sq, Skv,
                                                   scale);
  else if (D == 128)
    flash_fwd_kernel<128><<<grid, THREADS, 0, st>>>(qp, kp, vp, op, H, Sq,
                                                    Skv, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
