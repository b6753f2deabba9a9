// Row moments of one sketch pair, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sketch_moments.py
// (sketch_moments_pallas): (t, w) x (t, w) int32 counters -> (t,) float32,
// out[i] = sum_j A[i, j] * B[i, j]; F2 is the case A = B.  The TPU kernel
// blocks the width over a sequential grid axis with a VMEM accumulator;
// here one warp takes a whole row.
//
// What bounds it: bytes (8 bytes read per multiply-add); at SJPC's sizes
// (t <= 5 rows of w = 1024) the launch itself is the floor.
//
// Design: fused_query.cu with N = L = 1, the shared device code of
// moments.cuh: one warp per row, 64-bit integer sums cast to float32 once,
// bit-equal to the plain PyTorch version and to fused_query's rows.
#include <cuda_runtime.h>

#include "moments.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
sketch_moments_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                      float* __restrict__ out, int t, int w) {
  sjpc::row_moments<kWarps>(a, b, out, t, w);
}

}  // namespace

extern "C" int sjpc_sketch_moments(const void* a, const void* b, void* out, int t, int w,
                                   int device, void* stream) {
  cudaSetDevice(device);
  if (t > 0) {
    const int blocks = (t + kWarps - 1) / kWarps;
    sketch_moments_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        static_cast<float*>(out), t, w);
  }
  return static_cast<int>(cudaGetLastError());
}
