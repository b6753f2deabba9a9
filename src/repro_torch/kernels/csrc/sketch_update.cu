// Unfused Fast-AGMS update of one sketch from flat keys, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sketch_update.py
// (sketch_update_pallas): counters (t, w) int32 and flat keys fp1, fp2
// (N,) with int32 weights -> new counters, counters[row, bucket] +=
// sign * weight per key and depth row.  The TPU kernel builds a one-hot
// (block, w) matrix per row and contracts it on the MXU because a random
// scatter is slow there; on Hopper the scatter is int32 atomicAdds, which
// wrap and commute, so the counters are bit-exact in any order.
//
// What bounds it: bytes at SJPC's widths.  The function reads 12 B per
// key (two uint32 fingerprints, an int32 weight) and does 12*t mulmods
// per key of non-zero weight (two hashes, two halves, three Horner steps
// each, per depth row): at t = 3 that is 36 operations for 12 bytes,
// under the card's operations-per-byte balance.  This kernel reads the
// fingerprints and coefficients as int64 words, twice their bytes in the
// function.  Keys of weight 0 leave before any arithmetic.
//
// Design: fused_ingest.cu's atomic device code (sketch_atomic.cuh) with
// one plane: one thread per key in a grid-stride loop, a shared (t, w)
// tile when it fits in 48 KB (flushed once per CTA, non-zero entries
// only), global atomics for wider planes.
#include <cuda_runtime.h>

#include "field.cuh"
#include "sketch_atomic.cuh"

namespace {

constexpr int kThreads = 512;

template <bool kTile>
__global__ void __launch_bounds__(kThreads)
sketch_update_kernel(int32_t* __restrict__ counters, const int64_t* __restrict__ fp1,
                     const int64_t* __restrict__ fp2, const int32_t* __restrict__ weights,
                     const int64_t* __restrict__ bcoef, const int64_t* __restrict__ scoef,
                     int64_t n, int t, int w) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* coef = smem;
  sjpc::load_coeffs(coef, bcoef, scoef, t);
  uint32_t* plane = reinterpret_cast<uint32_t*>(counters);
  uint32_t* tile = smem + 16 * t;
  if (kTile) sjpc::zero_tile(tile, t * w);
  __syncthreads();

  uint32_t* dst = kTile ? tile : plane;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int32_t weight = weights[i];
    if (weight == 0) continue;
    // Canonical field elements, whatever uint32 word the caller gave.
    const uint32_t a = sjpc::reduce_p31(static_cast<uint32_t>(fp1[i]));
    const uint32_t b = sjpc::reduce_p31(static_cast<uint32_t>(fp2[i]));
    sjpc::sketch_add(dst, coef, t, w, a, b, weight);
  }

  if (kTile) {
    __syncthreads();
    sjpc::flush_tile(plane, tile, t * w);
  }
}

}  // namespace

extern "C" int sjpc_sketch_update(void* counters, const void* fp1, const void* fp2,
                                  const void* weights, const void* bcoef, const void* scoef,
                                  long long n, int t, int w, int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0 && t > 0) {
    const bool use_tile = sjpc::tile_fits(t, w);
    const int blocks = sjpc::atomic_grid(n, kThreads, use_tile, 1, device);
    const size_t smem = sjpc::coeff_bytes(t)
                        + (use_tile ? static_cast<size_t>(t) * w * sizeof(uint32_t) : 0);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto* c = static_cast<int32_t*>(counters);
    const auto* f1 = static_cast<const int64_t*>(fp1);
    const auto* f2 = static_cast<const int64_t*>(fp2);
    const auto* wt = static_cast<const int32_t*>(weights);
    const auto* bc = static_cast<const int64_t*>(bcoef);
    const auto* sc = static_cast<const int64_t*>(scoef);
    if (use_tile) {
      sketch_update_kernel<true><<<blocks, kThreads, smem, s>>>(c, f1, f2, wt, bc, sc, n, t, w);
    } else {
      sketch_update_kernel<false><<<blocks, kThreads, smem, s>>>(c, f1, f2, wt, bc, sc, n, t, w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
