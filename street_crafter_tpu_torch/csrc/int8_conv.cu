// W8A8 int8 3x3 convolution for Hopper (sm_90a): kernel Q of the port.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/ops/
// int8_conv.py. Every entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError(). The Hopper
// building blocks (mbarriers, TMA, setmaxnreg, the tensor-map encoder) are
// in hopper.cuh.
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
//       channels-last int8 [N, H, W, Cp] (Cp: C rounded up to 64, zeros in
//       the pad), from NCHW (64 x 64 tiles through shared memory) or from
//       channels-last memory (one thread 8 channels of a pixel, 16-byte
//       loads, an 8-byte store);
//   (d) weight_quant_kernel: one block an output channel, its scale and
//       its weights as [O, 3, 3, Cp] int8 (the GEMM's K order), read and
//       written in whole rows through shared memory;
//   (c) int8_conv_kernel: the implicit GEMM. M = N Ho Wo output pixels, N
//       = O output channels, K = 9 Cp (tap-major, channels inner), both
//       operands K-major (wgmma takes 8-bit operands K-major only).
//       Warp-specialised and persistent, one block an SM: a producer
//       thread TMA-loads each (tap, 64-channel slice) of a tile into a ring
//       of stages with full / empty mbarriers, and two consumer warpgroups
//       run wgmma.m64n160k32.s32.s8.s8 on them from shared memory, int32
//       accumulators in registers. A tile is 128 output pixels, a th x tw
//       rectangle of one image (ops/int8_conv.py::conv_tiles picks it by
//       Wo), by 320 output channels (two products of 160 on each A slice;
//       the UNet's O = 320, 640, 1280 in whole tiles). Its A
//       slice for tap (ky, kx) is one 4-D box of xq at (c0, wo0 s + kx -
//       1, ho0 s + ky - 1, n), elementStrides s along H and W for the
//       stride-2 Downsample; TMA's zero fill outside the tensor is the
//       padding of 1 and the ragged edges. Slices are 64 bytes in the
//       64-byte swizzle. The producer's ring runs across tiles, so it
//       loads the next tile while the consumers run this one's epilogue.
//       The epilogue writes the raw int32 products, or dequantises, adds
//       the bias and writes float32 or bf16: NCHW (the UNet's ResBlock
//       convolutions) through shared memory, a channel's run of pixels at
//       a time in 16-byte stores; channels-last (its Downsample and one
//       Upsample convolution) from the accumulator registers as 16-byte
//       chunks after a quad transpose (a warp store covers 8 rows x 64
//       bytes).
// The quantizing passes divide only near a rounding tie (quantize below).
//
// Bound on this card: at the UNet's shapes, operations (2 N Ho Wo O 9 C
// int8 operations at 1,979 TOPS dense) for the 3x3 convolutions with C >=
// 320; the activation's and output's bytes come second. The nine taps
// re-read each input row through L2 (each (tap, slice) is its own box), so
// L2 traffic is what the tile width buys down: a 128 x 160 tile moves 18
// KB of L2 per 2.6 M operations, a 128 x 320 tile 28 KB per 5.2 M. On the
// H100 the conv reached ~1,050 TOPS with 160-channel tiles and 1,070-1,530
// with 320 at the UNet's level 0-2 shapes; the 9 x 16 level (9 rows in
// 8-row tiles, 4 waves of 400 tiles) ~600. ptxas compiles the block to 168
// registers a thread, so the consumers' 160 accumulators spill ~20 bytes.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 8;

// the conv's tiles
constexpr int BM = 128;        // output pixels a tile (a th x tw rectangle)
constexpr int BN = 160;        // output channels a product (one sub-tile)
constexpr int BK = 64;         // bytes of K a stage: one tap, 64 channels
constexpr uint32_t A_BYTES = BM * BK;               // 8 KB
constexpr uint32_t B_BYTES = BN * BK;               // 10 KB a sub-tile
constexpr int CONV_THREADS = 384;  // a producer warpgroup + two consumers
constexpr int ACC = BN / 2;    // int32 accumulators a sub-tile a thread
// NCHW epilogue: a consumer's 64 rows x BN columns staged as [column][row]
// in 32-bit words, rows of 64 + 4 (the accumulator layout's stores fall in
// distinct banks)
constexpr int LD = 68;
constexpr uint32_t OUT_STAGE = BN * LD * 4;         // 42.5 KB

// A tile has SUBS sub-tiles: 320 output channels, two products on each A
// slice (L2 traffic per operation: 28 KB per 5.2 M; one sub-tile a tile
// would move 18 KB per 2.6 M, and ran 1.28x slower over the UNet's shapes
// on the H100).
constexpr int SUBS = 2;
constexpr int BN_TILE = SUBS * BN;
constexpr int STAGES = 5;
constexpr uint32_t STAGE = A_BYTES + SUBS * B_BYTES;  // a multiple of 512
// dynamic shared memory: the alignment pad, the ring, its barriers, the two
// consumers' staging (231,504 of the 232,448 bytes a block can have)
constexpr int CONV_SMEM = 1024 + STAGES * STAGE + 16 * STAGES + 2 * OUT_STAGE;

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

// clip(rint(v / scale), -127, 127), the quotient correctly rounded (as
// torch's and XLA's division). inv is 1 / scale (__frcp_rn): v * inv lies
// within 2.3e-5 of the rounded quotient for |v / scale| <= 128, so rint
// gives the same integer unless v * inv lies within 1e-3 of a half, where
// the division is taken (a few elements in a thousand). A division for
// every element made the quantize passes of one W8A8 eval 6.95 ms
// against 5.96 on an H100 80GB HBM3 at 700 W (the two builds in turns).
__device__ __forceinline__ int8_t quantize(float v, float scale, float inv) {
  const float y = __fmul_rn(v, inv);
  float r = rintf(y);
  if (fabsf(y - r) > 0.499f) r = rintf(__fdiv_rn(v, scale));
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

// NCHW input: a 64-channel x 64-pixel tile. Each warp reads 64 pixels of
// a channel (lanes on neighbouring pixels); the quantized bytes go to
// shared memory as [pixel][channel] (rows of 68 bytes: the byte stores of
// a warp fall in distinct banks), then each thread writes 4 channels of a
// pixel (a warp: two pixels' 64 bytes). grid (HW / 64, Cp / 64, N).
constexpr int QT = 64;          // pixels and channels a tile
constexpr int QROW = QT + 4;    // bytes a pixel's row of the tile

template <int kDtype>
__global__ void __launch_bounds__(kThreads)
quantize_nchw_kernel(const typename Elem<kDtype>::T* __restrict__ x, int C,
                     int HW, int Cp, const float* __restrict__ amax,
                     int8_t* __restrict__ xq, float* __restrict__ xscale) {
  __shared__ __align__(16) int8_t tile[QT * QROW];
  const float s = scale_of(*amax);
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
      threadIdx.x == 0)
    *xscale = s;
  const float inv = __frcp_rn(s);
  const int n = blockIdx.z, hw0 = blockIdx.x * QT, c0 = blockIdx.y * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int CW = QT / (kThreads / 32);  // channels a warp
  float v[CW][2];  // every load of the thread in flight at once
#pragma unroll
  for (int k = 0; k < CW; ++k) {
    const int c = c0 + warp + k * (kThreads / 32);
    const typename Elem<kDtype>::T* xr = x + ((int64_t)n * C + c) * HW;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int hw = hw0 + lane + 32 * h;
      v[k][h] = c < C && hw < HW ? Elem<kDtype>::f(xr[hw]) : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < CW; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      tile[(lane + 32 * h) * QROW + warp + k * (kThreads / 32)] =
          quantize(v[k][h], s, inv);
  __syncthreads();
  for (int k = threadIdx.x; k < QT * QT / 4; k += kThreads) {
    const int p = k / (QT / 4), w = k % (QT / 4), hw = hw0 + p;
    if (hw < HW)
      *reinterpret_cast<uint32_t*>(xq + ((int64_t)n * HW + hw) * Cp + c0 +
                                   4 * w) =
          *reinterpret_cast<const uint32_t*>(&tile[p * QROW + 4 * w]);
  }
}

// The 8 values at p (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// channels-last input [P, C] (P = N H W pixels) -> [P, Cp]: one thread an
// 8-channel chunk of a pixel, chunks in a grid-stride pass over [P, Cp / 8]
// (neighbouring threads on neighbouring chunks); 16-byte loads where C % 8
// == 0, an 8-byte store. Channels past C are written as zeros.
template <int kDtype>
__global__ void __launch_bounds__(kThreads)
quantize_nhwc_kernel(const typename Elem<kDtype>::T* __restrict__ x,
                     int64_t P, int C, int Cp, const float* __restrict__ amax,
                     int8_t* __restrict__ xq, float* __restrict__ xscale) {
  const float s = scale_of(*amax), inv = __frcp_rn(s);
  if (blockIdx.x == 0 && threadIdx.x == 0) *xscale = s;
  const int chunks = Cp / 8;
  const int64_t total = P * chunks;
  const bool narrow = total <= 0xffffffffll;  // 32-bit division suffices
  const bool vec = C % 8 == 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t p = narrow ? (int64_t)((uint32_t)i / (uint32_t)chunks)
                             : i / chunks;
    const int c = 8 * (int)(i - p * chunks);
    const typename Elem<kDtype>::T* xr = x + p * C;
    float v[8];
    if (vec && c < C) {
      load8(xr + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = c + e < C ? Elem<kDtype>::f(xr[c + e]) : 0.0f;
    }
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e >> 2] |= (uint32_t)(uint8_t)quantize(v[e], s, inv) << (8 * (e & 3));
    *reinterpret_cast<uint2*>(xq + p * Cp + c) = make_uint2(w[0], w[1]);
  }
}

// ---- (d) the weights ----------------------------------------------------

// w [O, I, 3, 3] -> wq [O, 3, 3, Cp] (zeros past I), wscale [O]. One
// block an output channel: max |w[o]| over its I x 9 weights, then chunks
// of 256 input channels through shared memory, read as they lie (9 taps a
// channel) and written tap by tap (256 channels a row).
template <int kDtype>
__global__ void __launch_bounds__(kThreads)
weight_quant_kernel(const typename Elem<kDtype>::T* __restrict__ w, int I,
                    int Cp, int8_t* __restrict__ wq,
                    float* __restrict__ wscale) {
  __shared__ float red[kThreads / 32];
  __shared__ float chunk[kThreads * 9];  // stride 9: no bank conflicts
  const int o = blockIdx.x, tid = threadIdx.x;
  const typename Elem<kDtype>::T* wo = w + (int64_t)o * I * 9;
  float m = 0.0f;
  for (int i = tid; i < I * 9; i += kThreads)
    m = fmaxf(m, fabsf(Elem<kDtype>::f(wo[i])));
  const float s = scale_of(block_max(m, red)), inv = __frcp_rn(s);
  if (tid == 0) wscale[o] = s;
  int8_t* q = wq + (int64_t)o * 9 * Cp;
  for (int c0 = 0; c0 < Cp; c0 += kThreads) {
    const int n = min(kThreads, I - c0);
    __syncthreads();  // the last chunk's reads are done
    for (int i = tid; i < n * 9; i += kThreads)
      chunk[i] = Elem<kDtype>::f(wo[(int64_t)c0 * 9 + i]);
    __syncthreads();
    const int c = c0 + tid;
    if (c < Cp) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        q[tap * Cp + c] =
            c < I ? quantize(chunk[tid * 9 + tap], s, inv) : (int8_t)0;
    }
  }
}

// ---- (c) the implicit GEMM ----------------------------------------------

// wgmma shared-memory descriptor of a K-major tile in TMA's 64-byte
// swizzle: rows of 64 bytes, 512 bytes (eight rows) the stride offset,
// layout type 2 (64B swizzle) in bits 62-63. A k32 step is 32 bytes along
// the row: added to the start address.
__device__ __forceinline__ uint64_t desc64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// d (64 x 160, s32) = A (64 x 32, s8) * B (160 x 32, s8)^T (+ d if
// accumulate), both K-major from shared memory.
__device__ __forceinline__ void wgmma_s8(int (&d)[ACC], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "%80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keeps the compiler from moving accesses of the accumulators across the
// wgmma fence / wait instructions (the hardware writes them asynchronously).
__device__ __forceinline__ void fence_acc(int (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 4 x 4 transpose of 32-bit words across the four lanes of a quad: lane t's
// w[c] becomes lane c's w[t]. In the m64nN accumulator layout lane t of a
// quad holds columns 2 t, 2 t + 1 of each 8-column group of its row; after
// the transpose it holds all 8 columns of one group.
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

struct ConvArgs {
  const float* wscale;    // [O]
  const float* xscale;    // [1]
  const float* bias;      // [O] (float32)
  void* out;
  int Ho, Wo, O, Cp, stride;
  int th, tw, tw_shift;   // the tile's rectangle (th x tw = BM, tw = 2^shift)
  int rows_t, cols_t;     // tiles along Ho and Wo
  int n_tiles;            // tiles along O
  long long tiles;        // all tiles: N rows_t cols_t n_tiles
  int out_kind;           // 0 int32 products, 1 float32, 2 bf16
  int out_nhwc;           // 1: channels-last output
};

// A tile's place: image n, its pixel rectangle's origin (ho0, wo0) and its
// first output channel col0; the column tiles of one rectangle are
// neighbours in the order, so the blocks in flight share A through L2.
struct Tile {
  int n, ho0, wo0, col0;
};

__device__ __forceinline__ Tile tile_at(const ConvArgs& p, long long i) {
  Tile t;
  const long long mt = i / p.n_tiles;
  t.col0 = BN_TILE * (int)(i - mt * p.n_tiles);
  const long long r = mt / p.cols_t;
  t.wo0 = p.tw * (int)(mt - r * p.cols_t);
  t.n = (int)(r / p.rows_t);
  t.ho0 = p.th * (int)(r - (long long)t.n * p.rows_t);
  return t;
}

__device__ __forceinline__ float dequant(int v, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(v), s), b);
}

template <int KIND>
__device__ __forceinline__ uint32_t out_bits(int v, float s, float b) {
  return KIND == 0 ? (uint32_t)v : __float_as_uint(dequant(v, s, b));
}

// Named barrier `id` over the 128 threads of one warpgroup.
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The NCHW epilogue of consumer cw: its 64 rows of the tile through
// `stage` ([column][row] words), then out in chunks of V pixels of one
// channel along an image row (16 bytes where Wo % V == 0: a warp writes
// the channel's run of 32 V pixels, or several runs of tw; else single
// elements).
template <int KIND>
__device__ __forceinline__ void nchw_epilogue(const int (&acc)[ACC],
                                              const ConvArgs& p,
                                              const Tile& t, int col0, int cw,
                                              int tid, float xs,
                                              uint32_t* stage) {
  const int warp = tid / 32, g = (tid % 32) / 4, t4 = tid % 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * t4 + e, col = col0 + c;
      const bool in = KIND != 0 && col < p.O;
      const float s = in ? __fmul_rn(__ldg(p.wscale + col), xs) : 0.0f;
      const float b = in ? __ldg(p.bias + col) : 0.0f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        stage[c * LD + 16 * warp + g + 8 * hf] =
            out_bits<KIND>(acc[4 * j + 2 * hf + e], s, b);
    }
  }
  wg_sync(1 + cw);
  constexpr int V = KIND == 2 ? 8 : 4;
  if (p.Wo % V == 0) {
    for (int q = tid; q < BN * 64 / V; q += 128) {
      const int c = q / (64 / V), r = q % (64 / V) * V, col = col0 + c;
      const int rr = 64 * cw + r;
      const int ho = t.ho0 + (rr >> p.tw_shift);
      const int wo = t.wo0 + (rr & (p.tw - 1));
      if (col >= p.O || ho >= p.Ho || wo >= p.Wo) continue;
      const long long idx =
          (((long long)t.n * p.O + col) * p.Ho + ho) * p.Wo + wo;
      const uint4 a = *reinterpret_cast<const uint4*>(stage + c * LD + r);
      if (KIND == 2) {
        const uint4 b =
            *reinterpret_cast<const uint4*>(stage + c * LD + r + 4);
        const uint4 o = make_uint4(
            pack_bf16(__uint_as_float(a.x), __uint_as_float(a.y)),
            pack_bf16(__uint_as_float(a.z), __uint_as_float(a.w)),
            pack_bf16(__uint_as_float(b.x), __uint_as_float(b.y)),
            pack_bf16(__uint_as_float(b.z), __uint_as_float(b.w)));
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + idx) =
            o;
      } else {
        *reinterpret_cast<uint4*>(static_cast<uint32_t*>(p.out) + idx) = a;
      }
    }
  } else {
    for (int q = tid; q < BN * 64; q += 128) {
      const int c = q / 64, r = q % 64, col = col0 + c, rr = 64 * cw + r;
      const int ho = t.ho0 + (rr >> p.tw_shift);
      const int wo = t.wo0 + (rr & (p.tw - 1));
      if (col >= p.O || ho >= p.Ho || wo >= p.Wo) continue;
      const long long idx =
          (((long long)t.n * p.O + col) * p.Ho + ho) * p.Wo + wo;
      const uint32_t v = stage[c * LD + r];
      if (KIND == 2)
        static_cast<__nv_bfloat16*>(p.out)[idx] =
            __float2bfloat16_rn(__uint_as_float(v));
      else
        static_cast<uint32_t*>(p.out)[idx] = v;
    }
  }
  wg_sync(1 + cw);  // the staging is free for the next tile
}

// The channels-last epilogue of one consumer thread: rows r_lo and r_lo +
// 8 of the tile (pixels of its rectangle), columns col0 + 8 j + 2 t4 (+1),
// j < BN / 8. With O % 8 == 0: 16-byte chunks through quad_transpose (a
// warp store covers 8 rows x 64 bytes); otherwise element by element.
template <int KIND>
__device__ __forceinline__ void nhwc_epilogue(const int (&acc)[ACC],
                                              const ConvArgs& p, const Tile& t,
                                              int col0, int r_lo, int t4,
                                              float xs) {
  long long pix[2];
  bool ok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r_lo + 8 * hf;
    const int ho = t.ho0 + (r >> p.tw_shift);
    const int wo = t.wo0 + (r & (p.tw - 1));
    ok[hf] = ho < p.Ho && wo < p.Wo;
    pix[hf] = ((long long)t.n * p.Ho + ho) * p.Wo + wo;
  }
  if (p.O % 8 == 0) {
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {  // groups 4 q .. 4 q + 3
      float sc[4][2], bi[4][2];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * (4 * q + c) + 2 * t4 + e;
          const bool in = KIND != 0 && col < p.O;
          sc[c][e] = in ? __fmul_rn(__ldg(p.wscale + col), xs) : 0.0f;
          bi[c][e] = in ? __ldg(p.bias + col) : 0.0f;
        }
      const int col = col0 + 8 * (4 * q + t4);  // this lane's chunk
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (KIND == 2) {
          uint32_t w[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = 4 * (4 * q + c) + 2 * hf;
            w[c] = pack_bf16(dequant(acc[i], sc[c][0], bi[c][0]),
                             dequant(acc[i + 1], sc[c][1], bi[c][1]));
          }
          quad_transpose(w, t4);
          if (ok[hf] && col < p.O)
            *reinterpret_cast<uint4*>(
                static_cast<__nv_bfloat16*>(p.out) + pix[hf] * p.O + col) =
                make_uint4(w[0], w[1], w[2], w[3]);
        } else {
          uint32_t ev[4], od[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = 4 * (4 * q + c) + 2 * hf;
            ev[c] = out_bits<KIND>(acc[i], sc[c][0], bi[c][0]);
            od[c] = out_bits<KIND>(acc[i + 1], sc[c][1], bi[c][1]);
          }
          quad_transpose(ev, t4);
          quad_transpose(od, t4);
          if (ok[hf] && col < p.O) {
            uint4* o = reinterpret_cast<uint4*>(
                static_cast<uint32_t*>(p.out) + pix[hf] * p.O + col);
            o[0] = make_uint4(ev[0], od[0], ev[1], od[1]);
            o[1] = make_uint4(ev[2], od[2], ev[3], od[3]);
          }
        }
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + 2 * t4 + e;
      if (col >= p.O) continue;
      const float s = KIND ? __fmul_rn(__ldg(p.wscale + col), xs) : 0.0f;
      const float b = KIND ? __ldg(p.bias + col) : 0.0f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (!ok[hf]) continue;
        const long long idx = pix[hf] * p.O + col;
        const int v = acc[4 * j + 2 * hf + e];
        if (KIND == 0)
          static_cast<int*>(p.out)[idx] = v;
        else if (KIND == 1)
          static_cast<float*>(p.out)[idx] = dequant(v, s, b);
        else
          static_cast<__nv_bfloat16*>(p.out)[idx] =
              __float2bfloat16_rn(dequant(v, s, b));
      }
    }
  }
}

// Persistent: each block walks the tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...; a stage carries one (tap, 64-channel slice) of A (the
// tile's 128 pixels) and of B (its 320 output channels, one box a
// sub-tile; rows past O read as zeros).
__global__ void __launch_bounds__(CONV_THREADS, 1)
int8_conv_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const ConvArgs p) {
  extern __shared__ uint8_t smem[];
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;  // stage: A, B
  const uint32_t full = ring + STAGES * STAGE;
  const uint32_t empty = full + 8 * STAGES;
  uint8_t* const out_stage = smem + (empty + 8 * STAGES - smem_u32(smem));
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int slices = p.Cp / BK;
  const int k_steps = 9 * slices;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
      for (long long i = blockIdx.x; i < p.tiles; i += gridDim.x) {
        const Tile t = tile_at(p, i);
        const int hi0 = t.ho0 * p.stride - 1, wi0 = t.wo0 * p.stride - 1;
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap - 3 * ky;
          for (int sl = 0; sl < slices; ++sl) {
            mbar_wait(empty + 8 * s, phase ^ 1);
            mbar_expect_tx(full + 8 * s, STAGE);
            const uint32_t sa = ring + s * STAGE;
            tma_load(sa, &map_x, full + 8 * s, BK * sl, wi0 + kx,
                     hi0 + ky, t.n);
#pragma unroll
            for (int h = 0; h < SUBS; ++h)
              tma_load_2d(sa + A_BYTES + h * B_BYTES, &map_w, full + 8 * s,
                          tap * p.Cp + BK * sl, t.col0 + BN * h);
            if (++s == STAGES) {
              s = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of each tile
    regs_inc<232>();
    const int cw = wg - 1;
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int r_lo = 64 * cw + 16 * warp + g;
    const float xs = *p.xscale;
    uint32_t* const stage =
        reinterpret_cast<uint32_t*>(out_stage + cw * OUT_STAGE);
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (long long i = blockIdx.x; i < p.tiles; i += gridDim.x) {
      const Tile t = tile_at(p, i);
      int acc[SUBS][ACC];
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(full + 8 * s, phase);
        const uint32_t sa = ring + s * STAGE + cw * 64 * BK;
        const uint32_t sb = ring + s * STAGE + A_BYTES;
#pragma unroll
        for (int h = 0; h < SUBS; ++h) fence_acc(acc[h]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int h = 0; h < SUBS; ++h)
            wgmma_s8(acc[h], desc64(sa + 32 * kk),
                     desc64(sb + h * B_BYTES + 32 * kk), ks + kk > 0);
        wgmma_commit();
#pragma unroll
        for (int h = 0; h < SUBS; ++h) fence_acc(acc[h]);
        wgmma_wait<1>();  // the previous stage's products are done
#pragma unroll
        for (int h = 0; h < SUBS; ++h) fence_acc(acc[h]);
        if (ks > 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < SUBS; ++h) fence_acc(acc[h]);
      mbar_arrive(empty + 8 * prev);
#pragma unroll
      for (int h = 0; h < SUBS; ++h) {
        const int col0 = t.col0 + BN * h;
        switch (p.out_kind * 2 + p.out_nhwc) {
          case 0: nchw_epilogue<0>(acc[h], p, t, col0, cw, tid, xs, stage);
            break;
          case 1: nhwc_epilogue<0>(acc[h], p, t, col0, r_lo, t4, xs); break;
          case 2: nchw_epilogue<1>(acc[h], p, t, col0, cw, tid, xs, stage);
            break;
          case 3: nhwc_epilogue<1>(acc[h], p, t, col0, r_lo, t4, xs); break;
          case 4: nchw_epilogue<2>(acc[h], p, t, col0, cw, tid, xs, stage);
            break;
          default: nhwc_epilogue<2>(acc[h], p, t, col0, r_lo, t4, xs); break;
        }
      }
    }
  }
}

int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > kMaxBlocks ? kMaxBlocks : (blocks < 1 ? 1 : blocks);
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

// The conv's two tensor maps, 64-byte swizzled, zeros outside the tensors:
// xq [N, H, W, Cp] with boxes of 64 channels x tw x th pixels (every
// stride-th pixel along W and H), wq [O, 9 Cp] with boxes of 64 x BN.
int conv_maps(CUtensorMap* mx, CUtensorMap* mw, const void* xq,
              const void* wq, int N, int H, int W, int Cp, int O, int th,
              int tw, int stride) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t xdim[4] = {(cuuint64_t)Cp, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t xstr[3] = {(cuuint64_t)Cp, (cuuint64_t)W * Cp,
                              (cuuint64_t)H * W * Cp};
  const cuuint32_t xbox[4] = {(cuuint32_t)BK, (cuuint32_t)(tw * stride),
                              (cuuint32_t)(th * stride), 1};
  const cuuint32_t xel[4] = {1, (cuuint32_t)stride, (cuuint32_t)stride, 1};
  CUresult r = encode(mx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                      const_cast<void*>(xq), xdim, xstr, xbox, xel,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const cuuint64_t wdim[2] = {(cuuint64_t)9 * Cp, (cuuint64_t)O};
  const cuuint64_t wstr[1] = {(cuuint64_t)9 * Cp};
  const cuuint32_t wbox[2] = {(cuuint32_t)BK, (cuuint32_t)BN};
  const cuuint32_t wel[2] = {1, 1};
  r = encode(mw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wq),
             wdim, wstr, wbox, wel, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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
// 1), 16-byte aligned -> xq [N, H, W, Cp] int8, xscale [1]; amax from
// sc_int8_absmax. Cp % 64 == 0.
int sc_int8_quantize(const void* x, int dtype, int nhwc, int N, int C,
                     int HW, int Cp, const void* amax, void* xq,
                     void* xscale, void* stream) {
  if (Cp % BK) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (nhwc) {
    const int64_t P = (int64_t)N * HW;
    const unsigned blocks = (unsigned)grid_for(P * (Cp / 8));
    if (dtype == 0)
      quantize_nhwc_kernel<0><<<blocks, kThreads, 0, st>>>(
          (const float*)x, P, C, Cp, (const float*)amax, (int8_t*)xq,
          (float*)xscale);
    else
      quantize_nhwc_kernel<1><<<blocks, kThreads, 0, st>>>(
          (const __nv_bfloat16*)x, P, C, Cp, (const float*)amax,
          (int8_t*)xq, (float*)xscale);
  } else {
    const dim3 grid((HW + QT - 1) / QT, Cp / QT, N);
    if (dtype == 0)
      quantize_nchw_kernel<0><<<grid, kThreads, 0, st>>>(
          (const float*)x, C, HW, Cp, (const float*)amax, (int8_t*)xq,
          (float*)xscale);
    else
      quantize_nchw_kernel<1><<<grid, kThreads, 0, st>>>(
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

// The 3x3 convolution, padding 1, stride 1 or 2, of xq [N, H, W, Cp] and
// wq [O, 9 Cp] (16-byte aligned, Cp % 64 == 0): out [N, O, Ho, Wo] (or its
// channels-last memory with out_nhwc) of int32 products (out_kind 0), or
// dequantised + bias in float32 (1) or bf16 (2). Tiles of th x tw output
// pixels (th tw = 128, tw a power of two in [8, 128]) by 320 channels.
int sc_int8_conv(const void* xq, const void* wq, const void* wscale,
                 const void* xscale, const void* bias, void* out, int N,
                 int H, int W, int Cp, int O, int stride, int th, int tw,
                 int out_kind, int out_nhwc, void* stream) {
  if (Cp <= 0 || Cp % BK || (stride != 1 && stride != 2) ||
      th * tw != BM || tw < 8 || tw > 128 || (tw & (tw - 1)) ||
      out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  ConvArgs a;
  a.wscale = (const float*)wscale;
  a.xscale = (const float*)xscale;
  a.bias = (const float*)bias;
  a.out = out;
  a.Ho = (H - 1) / stride + 1;
  a.Wo = (W - 1) / stride + 1;
  a.O = O;
  a.Cp = Cp;
  a.stride = stride;
  a.th = th;
  a.tw = tw;
  a.tw_shift = 0;
  while ((1 << a.tw_shift) < tw) ++a.tw_shift;
  a.rows_t = (a.Ho + th - 1) / th;
  a.cols_t = (a.Wo + tw - 1) / tw;
  a.n_tiles = (O + BN_TILE - 1) / BN_TILE;
  a.tiles = (long long)N * a.rows_t * a.cols_t * a.n_tiles;
  a.out_kind = out_kind;
  a.out_nhwc = out_nhwc;
  if (N <= 0 || H <= 0 || W <= 0 || O <= 0) return (int)cudaSuccess;
  CUtensorMap mx, mw;
  int err = conv_maps(&mx, &mw, xq, wq, N, H, W, Cp, O, th, tw, stride);
  int sms = 0;
  if (!err) err = sm_count(&sms);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      int8_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CONV_SMEM);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = a.tiles < sms ? a.tiles : sms;
  int8_conv_kernel<<<(unsigned)blocks, CONV_THREADS, CONV_SMEM,
                     (cudaStream_t)stream>>>(mx, mw, a);
  return (int)cudaGetLastError();
}

}  // extern "C"
