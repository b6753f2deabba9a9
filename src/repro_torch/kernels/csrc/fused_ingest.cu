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
// in registers.  When the level's (t, w) counter plane fits in 48 KB of
// shared memory (12 KB at t=3, w=1024) the CTA accumulates into a shared
// tile and flushes its non-zero entries with global atomics at the end;
// wider planes (up to w = 2^16 and beyond) take global atomics directly.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kSmemTileBytes = 48 * 1024;

template <bool kTile>
__global__ void __launch_bounds__(kThreads)
fused_ingest_kernel(int32_t* __restrict__ counters, const int64_t* __restrict__ values,
                    const int64_t* __restrict__ masks, const int64_t* __restrict__ ids,
                    const int64_t* __restrict__ bases, const int64_t* __restrict__ bcoef,
                    const int64_t* __restrict__ scoef, const int32_t* __restrict__ weights,
                    int64_t B, int L, int m_max, int d, int t, int w) {
  extern __shared__ uint32_t smem[];
  const int l = blockIdx.y;
  // Hash coefficients of this level: bucket [0, 8t), sign [8t, 16t).
  uint32_t* coef = smem;
  for (int i = threadIdx.x; i < 8 * t; i += blockDim.x) {
    coef[i] = static_cast<uint32_t>(bcoef[static_cast<int64_t>(l) * t * 8 + i]);
    coef[8 * t + i] = static_cast<uint32_t>(scoef[static_cast<int64_t>(l) * t * 8 + i]);
  }
  // Counters are added as uint32 so that overflow wraps as int32 adds do.
  uint32_t* plane = reinterpret_cast<uint32_t*>(counters) + static_cast<int64_t>(l) * t * w;
  uint32_t* tile = smem + 16 * t;
  if (kTile) {
    for (int i = threadIdx.x; i < t * w; i += blockDim.x) tile[i] = 0u;
  }
  __syncthreads();

  const uint32_t base1 = static_cast<uint32_t>(bases[0]);
  const uint32_t base2 = static_cast<uint32_t>(bases[1]);
  const uint32_t wmask = static_cast<uint32_t>(w - 1);
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
    const uint32_t up = static_cast<uint32_t>(weight);
    for (int row = 0; row < t; ++row) {
      const uint32_t hb = sjpc::cw_hash_pair(fp1, fp2, coef + row * 8);
      const uint32_t hs = sjpc::cw_hash_pair(fp1, fp2, coef + 8 * t + row * 8);
      atomicAdd(dst + row * w + (hb & wmask), (hs & 1u) ? 0u - up : up);
    }
  }

  if (kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < t * w; i += blockDim.x) {
      const uint32_t v = tile[i];
      if (v != 0u) atomicAdd(plane + i, v);
    }
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
    const int64_t want = (total + kThreads - 1) / kThreads;
    const size_t coef_bytes = 16u * t * sizeof(uint32_t);
    const size_t tile_bytes = static_cast<size_t>(t) * w * sizeof(uint32_t);
    const bool use_tile = coef_bytes + tile_bytes <= kSmemTileBytes;
    int sms = 132;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    // A tile CTA flushes t*w counters once, so it should see many slots:
    // about two CTAs per SM across all levels.
    int64_t cap = use_tile ? (2 * sms + L - 1) / L : 65535;
    const int blocks = static_cast<int>(want < cap ? want : cap);
    const dim3 grid(blocks, L);
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
      fused_ingest_kernel<true><<<grid, kThreads, coef_bytes + tile_bytes, s>>>(
          c, v, mk, id, bs, bc, sc, wt, B, L, m_max, d, t, w);
    } else {
      fused_ingest_kernel<false><<<grid, kThreads, coef_bytes, s>>>(
          c, v, mk, id, bs, bc, sc, wt, B, L, m_max, d, t, w);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
