// The atomic Fast-AGMS update of a (t, w) counter plane, as device
// functions shared by fused_ingest.cu (every lattice level's plane) and
// sketch_update.cu (one plane).
//
// Per key and depth row: bucket = cw_hash_pair(fp1, fp2, bucket coeffs)
// & (w-1), sign from the low bit of cw_hash_pair(fp1, fp2, sign coeffs),
// counters[row, bucket] += sign * weight.  Counters are added as uint32
// with atomicAdd, which wraps exactly as int32 adds do, so the order of
// the atomics cannot change a counter: the result is bit-exact in any
// order.  A CTA accumulates into a shared-memory copy of the plane when it
// fits (tile_fits) and flushes only the non-zero entries to global memory
// at the end; wider planes take global atomics directly.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace sjpc {

constexpr int kSmemTileBytes = 48 * 1024;

// Shared bytes of one plane's hash coefficients: bucket [0, 8t) and sign
// [8t, 16t) as uint32 (each group of 4 read as one 16-byte word, so the
// block of coefficients starts 16-byte aligned).
__host__ __device__ constexpr size_t coeff_bytes(int t) { return 16u * t * sizeof(uint32_t); }

// Whether the coefficients and a (t, w) tile fit in 48 KB of shared memory.
inline bool tile_fits(int t, int w) {
  return coeff_bytes(t) + static_cast<size_t>(t) * w * sizeof(uint32_t) <= kSmemTileBytes;
}

// Load one plane's (t, 2, 4) bucket and sign coefficients (uint32 words
// stored as int64 or int32) into coef[0, 16t) as uint32; the CTA must
// __syncthreads() before use.
template <typename Word>
__device__ __forceinline__ void load_coeffs(uint32_t* coef, const Word* bcoef,
                                            const Word* scoef, int t) {
  for (int i = threadIdx.x; i < 8 * t; i += blockDim.x) {
    coef[i] = static_cast<uint32_t>(bcoef[i]);
    coef[8 * t + i] = static_cast<uint32_t>(scoef[i]);
  }
}

__device__ __forceinline__ void zero_tile(uint32_t* tile, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) tile[i] = 0u;
}

// Add one key's signed weight into every row of a (t, w) plane (shared
// tile or global counters); w is a power of two, fp1/fp2 canonical.
__device__ __forceinline__ void sketch_add(uint32_t* plane, const uint32_t* coef, int t, int w,
                                           uint32_t fp1, uint32_t fp2, int32_t weight) {
  const uint32_t wmask = static_cast<uint32_t>(w - 1);
  const uint32_t up = static_cast<uint32_t>(weight);
  const Powers x = powers(fp1), y = powers(fp2);
  for (int row = 0; row < t; ++row) {
    const uint32_t hb = cw_hash_pair(x, y, coef + row * 8);
    const uint32_t hs = cw_hash_pair(x, y, coef + 8 * t + row * 8);
    atomicAdd(plane + row * w + (hb & wmask), (hs & 1u) ? 0u - up : up);
  }
}

// Add the non-zero entries of a CTA's tile into the global plane; the CTA
// must __syncthreads() before.
__device__ __forceinline__ void flush_tile(uint32_t* plane, const uint32_t* tile, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const uint32_t v = tile[i];
    if (v != 0u) atomicAdd(plane + i, v);
  }
}

}  // namespace sjpc
