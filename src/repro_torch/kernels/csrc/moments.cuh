// Exact row moments sum_j A[j] * B[j] of int32 counter rows, one warp per
// row, as a device function of fused_query.cu, its one user
// (sketch_moments.cu walks a row with a CTA or a cluster of its own).
//
// The lanes stride the row with coalesced 4-byte loads and accumulate in
// 64-bit integers (exact: no rounding however large the sums), reduce
// with warp shuffles, and the sum is cast to float32 once.  That equals
// the JAX f32 reduction while partial sums stay below 2^24 and is closer
// to the int64 oracle above it; the plain PyTorch versions sum the same
// way, so kernel and plain version agree bit for bit.
#pragma once

#include <cstdint>

namespace sjpc {

// The moment of one w-long row pair; valid in lane 0 of the warp.
__device__ __forceinline__ float warp_row_moment(const int32_t* __restrict__ a,
                                                 const int32_t* __restrict__ b, int w,
                                                 int lane) {
  // Unsigned 64-bit sums wrap as int64 sums do, without overflow UB.
  uint64_t acc = 0;
  for (int j = lane; j < w; j += 32) {
    acc += static_cast<uint64_t>(static_cast<int64_t>(a[j]) * static_cast<int64_t>(b[j]));
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  return static_cast<float>(static_cast<int64_t>(acc));
}

// Every row of a (rows, w) pair of stacks: one warp per row, grid-stride.
template <int kWarps>
__device__ __forceinline__ void row_moments(const int32_t* __restrict__ a,
                                            const int32_t* __restrict__ b,
                                            float* __restrict__ out, int64_t rows, int w) {
  const int lane = threadIdx.x & 31;
  for (int64_t row = blockIdx.x * static_cast<int64_t>(kWarps) + (threadIdx.x >> 5);
       row < rows; row += static_cast<int64_t>(gridDim.x) * kWarps) {
    const float m = warp_row_moment(a + row * w, b + row * w, w, lane);
    if (lane == 0) out[row] = m;
  }
}

}  // namespace sjpc
