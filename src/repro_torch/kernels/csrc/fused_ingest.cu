// Fused fingerprint -> multi-level Fast-AGMS ingest for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_ingest.py
// (fused_ingest_pallas, body _kernel): for every lattice level, the masked
// Horner fingerprints of every record under the level's padded
// combinations, then per depth row bucket = cw_hash_pair(fp1, fp2, bcoef)
// & (w-1), sign from scoef, counters[l, row, bucket] += sign * weight.
//
// The TPU kernel turns the scatter into a one-hot matrix product because
// a random scatter is slow there.  Hopper has fast int32 atomics, and
// int32 addition wraps and commutes, so a scatter of atomicAdds gives
// bit-exact counters in any order.  No one-hot product here.
//
// What bounds it: bytes, at SJPC's widths.  The function reads one int32
// weight per (record, level, padded combination) slot -- 320 B per record
// at d=6, s=3 -- beside 24 B of record values (uint32) and a few KB of
// tables and counters.  Its operations, one per mulmod (2*k Horner and
// 12*t hash mulmods per live slot of level k: two hashes, two halves,
// three Horner steps each, per depth row), take about half the time of
// those bytes at the card's INT32 rate.  This kernel reads its records and
// tables as int64 words, twice their bytes in the function.  Slots with
// weight 0 (padded combinations, unsampled ones, masked rows -- about half
// the real slots at r = 0.5) are skipped before any arithmetic.
//
// Design: grid (CTAs per level, L); one thread per (record, combination)
// slot of the CTA's level, in a grid-stride loop, fingerprints and hashes
// in registers.  The atomic update of a level's (t, w) plane is the shared
// device code of sketch_atomic.cuh (also sketch_update.cu's): a shared
// tile when it fits in 48 KB (12 KB at t=3, w=1024), flushed once per CTA;
// global atomics for wider planes (up to w = 2^16 and beyond).
#include <cuda_runtime.h>

#include "field.cuh"
#include "sketch_atomic.cuh"

namespace {

constexpr int kThreads = 512;

template <bool kTile>
__global__ void __launch_bounds__(kThreads)
fused_ingest_kernel(int32_t* __restrict__ counters, const int64_t* __restrict__ values,
                    const int64_t* __restrict__ masks, const int64_t* __restrict__ ids,
                    const int64_t* __restrict__ bases, const int64_t* __restrict__ bcoef,
                    const int64_t* __restrict__ scoef, const int32_t* __restrict__ weights,
                    int64_t B, int L, int m_max, int d, int t, int w) {
  extern __shared__ uint32_t smem[];
  const int l = blockIdx.y;
  uint32_t* coef = smem;
  sjpc::load_coeffs(coef, bcoef + static_cast<int64_t>(l) * t * 8,
                    scoef + static_cast<int64_t>(l) * t * 8, t);
  // Counters are added as uint32 so that overflow wraps as int32 adds do.
  uint32_t* plane = reinterpret_cast<uint32_t*>(counters) + static_cast<int64_t>(l) * t * w;
  uint32_t* tile = smem + 16 * t;
  if (kTile) sjpc::zero_tile(tile, t * w);
  __syncthreads();

  const uint32_t base1 = static_cast<uint32_t>(bases[0]);
  const uint32_t base2 = static_cast<uint32_t>(bases[1]);
  uint32_t* dst = kTile ? tile : plane;
  const int64_t total = B * m_max;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = i / m_max;
    const int m = static_cast<int>(i - b * m_max);
    const int32_t weight = weights[(b * L + l) * m_max + m];
    if (weight == 0) continue;
    const int64_t slot = static_cast<int64_t>(l) * m_max + m;
    uint32_t fp1, fp2;
    sjpc::masked_horner(values + b * d, masks + slot * d, ids[slot], base1, base2, d,
                        &fp1, &fp2);
    sjpc::sketch_add(dst, coef, t, w, fp1, fp2, weight);
  }

  if (kTile) {
    __syncthreads();
    sjpc::flush_tile(plane, tile, t * w);
  }
}

}  // namespace

extern "C" int sjpc_fused_ingest(void* counters, const void* values, const void* masks,
                                 const void* ids, const void* bases, const void* bcoef,
                                 const void* scoef, const void* weights, long long B, int L,
                                 int m_max, int d, int t, int w, int device,
                                 void* stream) {
  cudaSetDevice(device);
  const int64_t total = static_cast<int64_t>(B) * m_max;
  if (total > 0 && L > 0) {
    const bool use_tile = sjpc::tile_fits(t, w);
    const dim3 grid(sjpc::atomic_grid(total, kThreads, use_tile, L, device), L);
    const size_t smem = sjpc::coeff_bytes(t)
                        + (use_tile ? static_cast<size_t>(t) * w * sizeof(uint32_t) : 0);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* v = static_cast<const int64_t*>(values);
    const auto* mk = static_cast<const int64_t*>(masks);
    const auto* id = static_cast<const int64_t*>(ids);
    const auto* bs = static_cast<const int64_t*>(bases);
    const auto* bc = static_cast<const int64_t*>(bcoef);
    const auto* sc = static_cast<const int64_t*>(scoef);
    const auto* wt = static_cast<const int32_t*>(weights);
    auto* c = static_cast<int32_t*>(counters);
    if (use_tile) {
      fused_ingest_kernel<true><<<grid, kThreads, smem, s>>>(c, v, mk, id, bs, bc, sc, wt, B, L,
                                                             m_max, d, t, w);
    } else {
      fused_ingest_kernel<false><<<grid, kThreads, smem, s>>>(c, v, mk, id, bs, bc, sc, wt, B,
                                                              L, m_max, d, t, w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
