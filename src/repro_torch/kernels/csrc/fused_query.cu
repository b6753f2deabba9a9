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
// Design: one warp per (stream, level, depth row).  The lanes stride the
// row with coalesced 4-byte loads, accumulate in 64-bit integers (exact:
// no rounding however large the sums), reduce with warp shuffles and cast
// to float32 once.  That equals the JAX f32 reduction while partial sums
// stay below 2^24 and is closer to the int64 oracle above it; the plain
// PyTorch version sums the same way, so the two agree bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fused_query_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   float* __restrict__ out, int64_t rows, int w) {
  const int lane = threadIdx.x & 31;
  for (int64_t row = blockIdx.x * static_cast<int64_t>(kWarps) + (threadIdx.x >> 5);
       row < rows; row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int32_t* ra = a + row * w;
    const int32_t* rb = b + row * w;
    // Unsigned 64-bit sums wrap as int64 sums do, without overflow UB.
    uint64_t acc = 0;
    for (int j = lane; j < w; j += 32) {
      acc += static_cast<uint64_t>(static_cast<int64_t>(ra[j]) * static_cast<int64_t>(rb[j]));
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
    if (lane == 0) out[row] = static_cast<float>(static_cast<int64_t>(acc));
  }
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
