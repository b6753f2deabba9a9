// Fused batched row moments of stacked sketches for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_query.py
// (fused_query_pallas): (N, L, t, w) x (N, L, t, w) int32 counter stacks
// -> (N, L, t) float32, out[n, l, i] = sum_j A[n, l, i, j] * B[n, l, i, j].
// F2 (self-join) is the case A = B.
//
// What bounds it: bytes.  It reads each counter once (4 bytes, or 8 for a
// join's two stacks) for one multiply-add, far below the card's
// operations-per-byte balance.
//
// Design: one warp per (stream, level, depth row), the shared device code
// of moments.cuh (also sketch_moments.cu's): coalesced 4-byte loads,
// 64-bit integer sums, one float32 cast, so the kernel and the plain
// PyTorch version agree bit for bit.
#include <cuda_runtime.h>

#include "moments.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fused_query_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   float* __restrict__ out, int64_t rows, int w) {
  sjpc::row_moments<kWarps>(a, b, out, rows, w);
}

}  // namespace

extern "C" int sjpc_fused_query(const void* a, const void* b, void* out, long long rows, int w,
                                int device, void* stream) {
  cudaSetDevice(device);
  if (rows > 0) {
    const int64_t want = (rows + kWarps - 1) / kWarps;
    const int blocks = static_cast<int>(want < 65535 ? want : 65535);
    fused_query_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        static_cast<float*>(out), rows, w);
  }
  return static_cast<int>(cudaGetLastError());
}
