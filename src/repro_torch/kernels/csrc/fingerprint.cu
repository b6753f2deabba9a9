// Batched sub-value fingerprints (masked Horner) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fingerprint.py
// (fingerprint_pallas): (B, d) records x (M, d) combination masks -> two
// (B, M) fingerprints mod 2^31-1.
//
// What bounds it: bytes.  The function does 2 multiplies per included
// column per (record, combination), i.e. 2*k*B*M mulmods for level k,
// against 8 bytes of output per (record, combination) (two uint32); at
// SJPC's widths (d <= ~12) the output write is the larger cost.  This
// kernel writes int64 words, twice those bytes, so it can reach at best
// about half of that bound.
//
// Design: a CTA takes a chunk of up to kMaxChunk combinations (all M of a
// level at SJPC's widths) and walks tiles of records (a persistent loop
// over tiles).  A tile holds about kTileItems (record, combination) items
// and at most kTileRecords records: 64 records at M = 20, 128 at M <= 10.
// The columns go in blocks of 64.  Per (tile, column block), the tile's
// values of the block are read once, coalesced, as their Horner terms
// (v mod p) + 1 into shared memory; each combination's columns of the
// block are there as a 64-bit mask, with its Horner seed (loaded with the
// chunk's first tile, and again per block when d > 64).  Then each thread
// runs items (record r, combination m) of the tile in row-major order,
// stepping by the CTA's width with no division (r += q, m += rem, one
// wrap), and does the Horner steps of the block's set bits (k = popcount
// in all, uniform within a level), reading the terms from shared memory.
// A record of more than 64 columns carries its two fingerprints from one
// block to the next in the output itself, which the same thread wrote.
// Neighbouring threads take neighbouring items, so the int64 outputs,
// whose rows are contiguous, are written coalesced.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColBlock = 64;      // columns per block: a 64-bit mask
constexpr int kMaxChunk = 1024;    // combinations a CTA holds
constexpr int kTileItems = 1280;   // (record, combination) items a tile aims at
constexpr int kTileRecords = 128;  // records per tile at most
constexpr int kMaxTerms = 2048;    // Horner terms of a tile's records per column block
constexpr size_t kMaxSmem =
    kMaxChunk * (sizeof(uint64_t) + sizeof(uint32_t)) + kMaxTerms * sizeof(uint32_t);

// Records in tile t: tile, or the batch's tail.
__device__ __forceinline__ int tile_rows(int64_t B, int64_t t, int tile) {
  const int64_t left = B - t * tile;
  return static_cast<int>(left < tile ? (left > 0 ? left : 0) : tile);
}

__global__ void __launch_bounds__(kThreads)
fingerprint_kernel(const int64_t* __restrict__ values, const int64_t* __restrict__ masks,
                   const int64_t* __restrict__ ids, const int64_t* __restrict__ bases,
                   int64_t* __restrict__ out1, int64_t* __restrict__ out2, int64_t B, int M,
                   int d, int tile, int chunk) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_cols = smem;                               // [chunk]
  uint32_t* s_seed = reinterpret_cast<uint32_t*>(s_cols + chunk);  // [chunk]
  uint32_t* s_term = s_seed + chunk;                               // [tile * 64]
  const int64_t tiles = (B + tile - 1) / tile;
  const int blocks = d > kColBlock ? (d + kColBlock - 1) / kColBlock : 1;
  const uint32_t base1 = static_cast<uint32_t>(bases[0]);
  const uint32_t base2 = static_cast<uint32_t>(bases[1]);
  bool first = true;
  for (int64_t m0 = static_cast<int64_t>(blockIdx.y) * chunk; m0 < M;
       m0 += static_cast<int64_t>(gridDim.y) * chunk) {
    const int mc = static_cast<int>(min(static_cast<int64_t>(chunk), M - m0));
    // kThreads = q * mc + rem: one step of the CTA over the tile's items
    const int q = kThreads / mc, rem = kThreads - q * mc;
    const int r_first = threadIdx.x / mc, m_first = threadIdx.x - r_first * mc;
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int64_t b0 = t * tile;
      const int rows = tile_rows(B, t, tile);
      for (int w = 0; w < blocks; ++w) {
        const int c0 = w * kColBlock, dc = min(kColBlock, d - c0);
        if (!first) __syncthreads();   // the last stage's tables are read
        first = false;
        // Records of at most 64 columns keep the chunk's first masks.  Each
        // combination's mask row by predicated loads, all issued at once.
        if (blocks > 1 || t == blockIdx.x) {
          for (int i = threadIdx.x; i < mc; i += kThreads) {
            const int64_t* row = masks + (m0 + i) * d + c0;
            unsigned long long cols = 0;
#pragma unroll
            for (int c = 0; c < kColBlock; ++c) {
              if (c < dc && row[c] != 0) cols |= 1ull << c;
            }
            s_cols[i] = cols;
            if (t == blockIdx.x && w == 0) {
              s_seed[i] = sjpc::horner_seed(static_cast<uint32_t>(ids[m0 + i]));
            }
          }
        }
        // the tile's values of the block, read once and coalesced
        const int64_t* v = values + b0 * d + c0;
        for (int i = threadIdx.x; i < rows * dc; i += kThreads) {
          const int64_t at = dc == d ? i : static_cast<int64_t>(i / dc) * d + i % dc;
          s_term[i] = sjpc::horner_term(static_cast<uint32_t>(v[at]));
        }
        __syncthreads();
        int64_t* o1 = out1 + b0 * M + m0;
        int64_t* o2 = out2 + b0 * M + m0;
        for (int r = r_first, m = m_first; r < rows;) {
          const uint32_t* term = s_term + r * dc;
          const int64_t o = static_cast<int64_t>(r) * M + m;
          unsigned long long cols = s_cols[m];
          uint32_t f1, f2;
          if (w == 0) {
            f1 = f2 = s_seed[m];
          } else {
            f1 = static_cast<uint32_t>(o1[o]);
            f2 = static_cast<uint32_t>(o2[o]);
          }
          while (cols != 0) {
            const uint32_t x = term[__ffsll(static_cast<long long>(cols)) - 1];
            cols &= cols - 1;
            f1 = sjpc::reduce64_p31(static_cast<uint64_t>(f1) * base1 + x);
            f2 = sjpc::reduce64_p31(static_cast<uint64_t>(f2) * base2 + x);
          }
          o1[o] = f1;
          o2[o] = f2;
          r += q;
          m += rem;
          if (m >= mc) {
            m -= mc;
            ++r;
          }
        }
      }
    }
  }
}

}  // namespace

// values (B, d), masks (M, d), ids (M,), bases (2,) int64; out1, out2 (B,
// M) int64.  Any d: records wider than 64 columns go in column blocks.
extern "C" int sjpc_fingerprint(const void* values, const void* masks, const void* ids,
                                const void* bases, void* out1, void* out2, long long B, int M,
                                int d, int device, void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || M <= 0) return static_cast<int>(cudaGetLastError());
  if (d < 0) return static_cast<int>(cudaErrorInvalidValue);
  // The tiling: a chunk of combinations per CTA column, and records per
  // tile to about kTileItems items, within kMaxTerms terms and the batch.
  const int chunk = M < kMaxChunk ? M : kMaxChunk;
  const int dc = d < kColBlock ? d : kColBlock;
  long long tile = kTileItems / chunk;
  if (tile > kTileRecords) tile = kTileRecords;
  if (dc > 0 && tile > kMaxTerms / dc) tile = kMaxTerms / dc;
  if (tile > B) tile = B;
  if (tile < 1) tile = 1;
  const size_t smem = static_cast<size_t>(chunk) * (sizeof(uint64_t) + sizeof(uint32_t))
                      + static_cast<size_t>(tile) * dc * sizeof(uint32_t);
  // CTAs per SM at the most shared memory a launch takes, asked once
  static int blocks_per_sm = 0;
  if (blocks_per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, fingerprint_kernel, kThreads,
                                                  kMaxSmem);
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long tiles = (B + tile - 1) / tile;
  const int all_chunks = M / chunk + (M % chunk != 0);
  const int chunks = all_chunks < 65535 ? all_chunks : 65535;   // CTA columns loop beyond
  long long cap = static_cast<long long>(sms) * blocks_per_sm / chunks;
  if (cap < 1) cap = 1;
  const dim3 grid(static_cast<unsigned>(tiles < cap ? tiles : cap), chunks);
  fingerprint_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(values), static_cast<const int64_t*>(masks),
      static_cast<const int64_t*>(ids), static_cast<const int64_t*>(bases),
      static_cast<int64_t*>(out1), static_cast<int64_t*>(out2), B, M, d,
      static_cast<int>(tile), chunk);
  return static_cast<int>(cudaGetLastError());
}
