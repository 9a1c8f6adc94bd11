// The SPMD bridge's kernel for Hopper (sm_90a): out = 2 x, float32.
//
// Plain C interface, loaded with ctypes by street_crafter_tpu_torch/
// parallel/kernel_shard.py. The entry launches on the caller's stream,
// allocates nothing, does not synchronise and returns cudaGetLastError().
//
// Replaces the x2 Pallas kernel of the JAX package's SPMD bridge
// (__graft_entry__.py:301-311 _dryrun_kernel_bridge's kern / impl, and
// tests/test_kernel_shard.py:17-27 _scale_kernel / _impl): one whole-array
// block o = 2 x, run per device through parallel/kernel_shard.py::
// wrap_kernel. Here each rank launches it on its shard of the leading dim
// and torch.distributed gathers the result. Bound on this card: bytes
// (each input element read once, each output written once); the design is
// a grid-stride loop over the elements, 256 threads a block, at most 16
// blocks an SM, neighbouring threads on neighbouring addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;

__global__ void __launch_bounds__(kThreads)
x2_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = 2.0f * x[i];
}

}  // namespace

extern "C" {

const char* sc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out: n float32 each (contiguous).
int sc_x2(const void* x, void* out, int64_t n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  x2_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
