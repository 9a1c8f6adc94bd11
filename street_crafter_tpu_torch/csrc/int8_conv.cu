// W8A8 int8 3x3 convolution for Hopper (sm_90a): kernel Q of the port.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// int8_conv.py. Every entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().
//
// Replaces no Pallas kernel: the JAX package computes its W8A8 eval convs
// (street_crafter_tpu/models/vdm/layers.py:74-124, Int8Conv) with XLA's
// int8 conv_general_dilated and an int32 accumulator. PyTorch has no int8
// convolution on CUDA, so the port writes one. It computes what Int8Conv
// computes:
//   wscale[o] = max(max |w[o]|, 1e-12) / 127, wq = clip(rint(w / wscale))
//   xscale    = max(max |x|, 1e-12) / 127 over the whole tensor, xq alike
//   out       = float(int32 conv(xq, wq)) * (wscale * xscale) + bias
// with rounding half to even (rintf, as jnp.round and torch.round) and the
// epilogue's multiply and add kept apart (__fmul_rn, __fadd_rn: no FMA),
// so that the result is bit-equal to the plain version's float32.
//
// Four kernels, one entry each:
//   (a) int8_absmax_kernel: max |x| over the tensor (grid-stride, 16-byte
//       loads, a block reduction, one atomicMax on the float's bits: the
//       bits of non-negative floats order as unsigned integers);
//   (b) quantize_*_kernel: xscale from (a)'s maximum, and x quantized into
//       channels-last int8 [N, H, W, Cp] (Cp: C rounded up to 32, zeros
//       in the pad), from NCHW (a 32 x 32 transpose through shared memory)
//       or from channels-last memory (a straight pass);
//   (d) weight_quant_kernel: one block an output channel, its scale and
//       its weights as [O, 3, 3, Cp] int8 (the GEMM's K order);
//   (c) int8_conv_kernel: the implicit GEMM. M = N Ho Wo output pixels, N
//       = O output channels, K = 9 Cp (tap-major, channels inner). A block
//       computes a 128 x 128 tile of the output with 8 warps (2 along M x
//       4 along N, 64 x 32 each) from a 3-stage cp.async ring of 32-byte
//       K slices (one tap, 32 channels: the im2col rows are gathered by
//       the copies, zero-filled at the padding and past the edges), with
//       mma.sync.m16n8k32.s32.s8.s8.s32 into int32 registers. The
//       epilogue writes the raw int32 products, or dequantises, adds the
//       bias and writes float32 or bf16, NCHW or channels-last.
//
// Bound on this card: at the UNet's shapes, operations (2 N Ho Wo O 9 C
// int8 operations at 1,979 TOPS dense) for the 3x3 convolutions with
// C >= 320; the activation's and output's bytes come second. This first
// design is plain mma.sync with a cp.async ring; wgmma over TMA-fed
// shared memory is its redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;

// the conv's tiles
constexpr int BM = 128;        // output pixels a block
constexpr int BN = 128;        // output channels a block
constexpr int BK = 32;         // bytes of K a stage (one tap, 32 channels)
constexpr int kRow = 48;       // shared-memory row stride: 32 + 16 pad
constexpr int kStages = 3;

template <int kDtype> struct Elem;
template <> struct Elem<0> {
  using T = float;
  static __device__ __forceinline__ float f(float v) { return v; }
};
template <> struct Elem<1> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
};

__device__ __forceinline__ int8_t quantize(float v, float scale) {
  float r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)__float2int_rn(r);
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

__device__ __forceinline__ float block_max(float m, float* red) {
  for (int o = 16; o; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int o = 16; o; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  return red[0];
}

// ---- (a) max |x| over the tensor --------------------------------------

template <int kDtype>
__global__ void __launch_bounds__(kThreads)
int8_absmax_kernel(const typename Elem<kDtype>::T* __restrict__ x, int64_t n,
                   unsigned int* __restrict__ amax_bits) {
  using T = typename Elem<kDtype>::T;
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kThreads / 32];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nv = n / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  float m = 0.0f;
  for (int64_t i = first; i < nv; i += stride) {
    uint4 u = __ldg(xv + i);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(Elem<kDtype>::f(e[j])));
  }
  for (int64_t i = nv * V + first; i < n; i += stride)
    m = fmaxf(m, fabsf(Elem<kDtype>::f(x[i])));
  m = block_max(m, red);
  if (threadIdx.x == 0) atomicMax(amax_bits, __float_as_uint(m));
}

// ---- (b) x to channels-last int8 ----------------------------------------

// NCHW input: a 32-channel x 32-pixel tile through shared memory, read
// along the pixels and written along the channels. grid (HW/32, Cp/32, N),
// block (32, 8).
template <int kDtype>
__global__ void __launch_bounds__(kThreads)
quantize_nchw_kernel(const typename Elem<kDtype>::T* __restrict__ x, int C,
                     int HW, int Cp, const float* __restrict__ amax,
                     int8_t* __restrict__ xq, float* __restrict__ xscale) {
  __shared__ int8_t tile[32][33];
  const float s = scale_of(*amax);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0 && threadIdx.y == 0)
    *xscale = s;
  const int n = blockIdx.z, hw0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, hw = hw0 + threadIdx.x;
    int8_t q = 0;
    if (c < C && hw < HW)
      q = quantize(Elem<kDtype>::f(x[((int64_t)n * C + c) * HW + hw]), s);
    tile[i][threadIdx.x] = q;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int hw = hw0 + i;
    if (hw < HW)
      xq[((int64_t)n * HW + hw) * Cp + c0 + threadIdx.x] =
          tile[threadIdx.x][i];
  }
}

// channels-last input [P, C] (P = N H W pixels): a grid-stride pass over
// the [P, Cp] output.
template <int kDtype>
__global__ void __launch_bounds__(kThreads)
quantize_nhwc_kernel(const typename Elem<kDtype>::T* __restrict__ x,
                     int64_t P, int C, int Cp, const float* __restrict__ amax,
                     int8_t* __restrict__ xq, float* __restrict__ xscale) {
  const float s = scale_of(*amax);
  if (blockIdx.x == 0 && threadIdx.x == 0) *xscale = s;
  const int64_t total = P * Cp;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t p = i / Cp;
    const int c = (int)(i - p * Cp);
    xq[i] = c < C ? quantize(Elem<kDtype>::f(x[p * C + c]), s) : (int8_t)0;
  }
}

// ---- (d) the weights ----------------------------------------------------

// w [O, I, 3, 3] -> wq [O, 3, 3, Cp] (zeros past I), wscale [O]. One
// block an output channel.
template <int kDtype>
__global__ void __launch_bounds__(kThreads)
weight_quant_kernel(const typename Elem<kDtype>::T* __restrict__ w, int I,
                    int Cp, int8_t* __restrict__ wq,
                    float* __restrict__ wscale) {
  __shared__ float red[kThreads / 32];
  const int o = blockIdx.x;
  const typename Elem<kDtype>::T* wo = w + (int64_t)o * I * 9;
  float m = 0.0f;
  for (int i = threadIdx.x; i < I * 9; i += blockDim.x)
    m = fmaxf(m, fabsf(Elem<kDtype>::f(wo[i])));
  const float s = scale_of(block_max(m, red));
  if (threadIdx.x == 0) wscale[o] = s;
  int8_t* q = wq + (int64_t)o * 9 * Cp;
  for (int j = threadIdx.x; j < 9 * Cp; j += blockDim.x) {
    const int tap = j / Cp, c = j - tap * Cp;
    q[j] = c < I ? quantize(Elem<kDtype>::f(wo[c * 9 + tap]), s)
                 : (int8_t)0;
  }
}

// ---- (c) the implicit GEMM ----------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;     // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct ConvArgs {
  const int8_t* xq;       // [N, H, W, Cp]
  const int8_t* wq;       // [O, 9 Cp]
  const float* wscale;    // [O]
  const float* xscale;    // [1]
  const float* bias;      // [O] (float32)
  void* out;
  int N, H, W, Cp, O, Ho, Wo, stride;
  int out_kind;           // 0 int32 products, 1 float32, 2 bf16
  int out_nhwc;           // 1: channels-last output
};

__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const ConvArgs p) {
  __shared__ __align__(16) int8_t As[kStages][BM * kRow];
  __shared__ __align__(16) int8_t Bs[kStages][BN * kRow];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int64_t HWo = (int64_t)p.Ho * p.Wo;
  const int64_t M = (int64_t)p.N * HWo;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * p.Cp;
  const int KT = K / BK;
  const int slices = p.Cp / BK;        // K slices a tap

  // this thread's copies: one 16-byte half of row `row` of A and of B
  const int row = tid >> 1, half = tid & 1;
  const int64_t m = m0 + row;
  const bool m_ok = m < M;
  int hi0 = 0, wi0 = 0;
  const int8_t* x_img = p.xq;
  if (m_ok) {
    const int64_t n = m / HWo;
    const int r = (int)(m - n * HWo);
    const int ho = r / p.Wo, wo = r - ho * p.Wo;
    hi0 = ho * p.stride - 1;
    wi0 = wo * p.stride - 1;
    x_img = p.xq + n * p.H * p.W * p.Cp;
  }
  const int o_row = n0 + row;
  const bool o_ok = o_row < p.O;
  const int8_t* w_row = p.wq + (int64_t)(o_ok ? o_row : 0) * K + half * 16;

  auto load = [&](int stage, int kt) {
    const int tap = kt / slices, c0 = (kt - tap * slices) * BK;
    const int ky = tap / 3, kx = tap - ky * 3;
    const int hi = hi0 + ky, wi = wi0 + kx;
    const bool ok = m_ok && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
    const int8_t* src =
        ok ? x_img + ((int64_t)hi * p.W + wi) * p.Cp + c0 + half * 16
           : p.xq;
    cp_async16(&As[stage][row * kRow + half * 16], src, ok);
    cp_async16(&Bs[stage][row * kRow + half * 16],
               o_ok ? w_row + (int64_t)kt * BK : p.wq, o_ok);
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < KT) load(next % kStages, next);
    cp_async_commit();

    const int8_t* A = As[kt % kStages];
    const int8_t* B = Bs[kt % kStages];
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int r0 = warp_m * 64 + mi * 16 + g;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(A + r0 * kRow + t * 4);
      a[mi][1] =
          *reinterpret_cast<const uint32_t*>(A + (r0 + 8) * kRow + t * 4);
      a[mi][2] =
          *reinterpret_cast<const uint32_t*>(A + r0 * kRow + 16 + t * 4);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(A + (r0 + 8) * kRow +
                                                    16 + t * 4);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = warp_n * 32 + ni * 8 + g;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(B + c * kRow + t * 4);
      b[ni][1] =
          *reinterpret_cast<const uint32_t*>(B + c * kRow + 16 + t * 4);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }
  cp_async_wait<0>();

  // epilogue: acc[mi][ni] holds (row g, cols 2t, 2t+1) and (row g + 8,
  // the same cols) of its 16 x 8 tile
  const float xs = *p.xscale;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t mm = m0 + warp_m * 64 + mi * 16 + g + (e >> 1) * 8;
        const int o = n0 + warp_n * 32 + ni * 8 + t * 2 + (e & 1);
        if (mm >= M || o >= p.O) continue;
        int64_t idx;
        if (p.out_nhwc) {
          idx = mm * p.O + o;
        } else {
          const int64_t n = mm / HWo;
          idx = (n * p.O + o) * HWo + (mm - n * HWo);
        }
        const int v = acc[mi][ni][e];
        if (p.out_kind == 0) {
          static_cast<int*>(p.out)[idx] = v;
          continue;
        }
        const float s = __fmul_rn(p.wscale[o], xs);
        const float f = __fadd_rn(__fmul_rn(__int2float_rn(v), s), p.bias[o]);
        if (p.out_kind == 1)
          static_cast<float*>(p.out)[idx] = f;
        else
          static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(f);
      }
    }
  }
}

int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : (blocks < 1 ? 1 : blocks);
}

}  // namespace

extern "C" {

const char* sc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x: n elements (dtype 0 float32, 1 bf16), 16-byte aligned; amax: one
// float32, zeroed by the caller, raised to max |x|.
int sc_int8_absmax(const void* x, int64_t n, int dtype, void* amax,
                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)grid_for(n / 8 + 1);
  if (dtype == 0)
    int8_absmax_kernel<0><<<blocks, kThreads, 0, st>>>(
        (const float*)x, n, (unsigned int*)amax);
  else
    int8_absmax_kernel<1><<<blocks, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, n, (unsigned int*)amax);
  return (int)cudaGetLastError();
}

// x [N, C, H, W] (nhwc 0) or its channels-last memory [N, H, W, C] (nhwc
// 1) -> xq [N, H, W, Cp] int8, xscale [1]; amax from sc_int8_absmax.
int sc_int8_quantize(const void* x, int dtype, int nhwc, int N, int C,
                     int HW, int Cp, const void* amax, void* xq,
                     void* xscale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nhwc) {
    const int64_t P = (int64_t)N * HW;
    const unsigned blocks = (unsigned)grid_for(P * Cp);
    if (dtype == 0)
      quantize_nhwc_kernel<0><<<blocks, kThreads, 0, st>>>(
          (const float*)x, P, C, Cp, (const float*)amax, (int8_t*)xq,
          (float*)xscale);
    else
      quantize_nhwc_kernel<1><<<blocks, kThreads, 0, st>>>(
          (const __nv_bfloat16*)x, P, C, Cp, (const float*)amax,
          (int8_t*)xq, (float*)xscale);
  } else {
    const dim3 grid((HW + 31) / 32, Cp / 32, N), block(32, 8);
    if (dtype == 0)
      quantize_nchw_kernel<0><<<grid, block, 0, st>>>(
          (const float*)x, C, HW, Cp, (const float*)amax, (int8_t*)xq,
          (float*)xscale);
    else
      quantize_nchw_kernel<1><<<grid, block, 0, st>>>(
          (const __nv_bfloat16*)x, C, HW, Cp, (const float*)amax,
          (int8_t*)xq, (float*)xscale);
  }
  return (int)cudaGetLastError();
}

// w [O, I, 3, 3] -> wq [O, 9 Cp] int8, wscale [O].
int sc_int8_weight_quant(const void* w, int dtype, int O, int I, int Cp,
                         void* wq, void* wscale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    weight_quant_kernel<0><<<O, kThreads, 0, st>>>(
        (const float*)w, I, Cp, (int8_t*)wq, (float*)wscale);
  else
    weight_quant_kernel<1><<<O, kThreads, 0, st>>>(
        (const __nv_bfloat16*)w, I, Cp, (int8_t*)wq, (float*)wscale);
  return (int)cudaGetLastError();
}

// The 3x3 convolution, padding 1, stride 1 or 2: out [N, O, Ho, Wo] (or
// its channels-last memory with out_nhwc) of int32 products (out_kind 0),
// or dequantised + bias in float32 (1) or bf16 (2). Cp % 32 == 0.
int sc_int8_conv(const void* xq, const void* wq, const void* wscale,
                 const void* xscale, const void* bias, void* out, int N,
                 int H, int W, int Cp, int O, int stride, int out_kind,
                 int out_nhwc, void* stream) {
  ConvArgs a;
  a.xq = (const int8_t*)xq;
  a.wq = (const int8_t*)wq;
  a.wscale = (const float*)wscale;
  a.xscale = (const float*)xscale;
  a.bias = (const float*)bias;
  a.out = out;
  a.N = N;
  a.H = H;
  a.W = W;
  a.Cp = Cp;
  a.O = O;
  a.stride = stride;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.out_kind = out_kind;
  a.out_nhwc = out_nhwc;
  const int64_t M = (int64_t)N * a.Ho * a.Wo;
  if (M <= 0 || O <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((O + BN - 1) / BN));
  int8_conv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
