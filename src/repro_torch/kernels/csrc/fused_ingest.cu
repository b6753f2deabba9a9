// Fused fingerprint -> multi-level Fast-AGMS ingest for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_ingest.py
// (fused_ingest_pallas, body _kernel): for every lattice level, the masked
// Horner fingerprints of every record under the level's combinations,
// then per depth row bucket = cw_hash_pair(fp1, fp2, bcoef) & (w-1), sign
// from scoef, counters[l, row, bucket] += sign * weight.
//
// The TPU kernel turns the scatter into a one-hot matrix product because
// a random scatter is slow there.  Hopper has fast int32 atomics, and
// int32 addition wraps and commutes, so a scatter of unsigned atomicAdds
// gives bit-exact counters in any order.  No one-hot product here.
//
// What bounds it: bytes, by the function's own count.  It reads one int32
// weight per (record, level, live combination) slot -- 168 B per record at
// d=6, s=3 (the padded slots carry weight 0 and are not read) -- beside
// 24 B of record values and a few KB of tables and counters; its 2*k
// Horner and 12*t hash mulmods per sampled slot of level k, counted as one
// operation each, take about as long at the card's INT32 rate.  A mulmod
// is several instructions, though (a 32x32->64-bit multiply, folds, a
// compare), and on the card this per-slot work, not the bytes or the
// flush, sets the kernel's time; the design cuts instructions and idle
// lanes.
//
// Design:
//  * A persistent grid of at most two CTAs per SM, each over a contiguous
//    range of records.  One CTA holds every level's (t, w) plane in shared
//    memory (L*t*w*4 = 48 KB at d=6, s=3, t=3, w=1024; opted in up to the
//    card's 227 KB), so a record and its contiguous L*m_max weight row are
//    read once for all levels, and the CTA flushes its non-zero entries
//    once at the end (at B = 65,536 the flush is a few percent of the
//    time: summing a cluster's tiles in distributed shared memory first
//    was slower).  Planes too wide for shared memory take global atomics
//    (sketch_atomic.cuh), as sketch_update.cu does.
//  * Only live work.  The CTA walks each level's true C(d, k)
//    combinations (the slot table in shared memory: level, combination,
//    column bitmask, Horner seed), not the m_max padded ones.  Each warp
//    compacts its live slots (weight != 0; about half at r = 0.5) into a
//    queue in shared memory with __ballot_sync/__popc and runs the Horner
//    and hash arithmetic only on full warps of live slots.
//  * Every field word (records, lattice tables, bases, coefficients) is
//    read as uint32, the function's own width.  The hashes take a key's
//    powers x, x^2, x^3 once and sum each polynomial in 64 bits before one
//    reduction (field.cuh).
#include <cuda_runtime.h>

#include "field.cuh"
#include "sketch_atomic.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;            // live slots a warp holds (< 32 + 32)
constexpr int kMaxLevels = 16;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The live combinations of the padded lattice: level l's slots are
// [offset[l], offset[l + 1]) of the slot table.
struct Levels {
  int count;
  int offset[kMaxLevels + 1];
};

struct Smem {
  uint32_t* coef;        // (L, 16t): bucket then sign coefficients per level
  uint32_t* slot_lm;     // (slots,): level | combination << 8
  uint32_t* slot_cols;   // (slots,): column bitmask
  uint32_t* slot_seed;   // (slots,): Horner seed of the combination id
  uint32_t* queue;       // (kWarps, 3, kQueue): record, slot, weight
  uint32_t* planes;      // (L, t, w) when they fit
};

__host__ __device__ inline size_t words_before_planes(int L, int t, int slots) {
  return static_cast<size_t>(L) * 16 * t + 3 * static_cast<size_t>(slots)
         + static_cast<size_t>(kWarps) * 3 * kQueue;
}

__device__ inline Smem carve(uint32_t* smem, int L, int t, int slots) {
  Smem s;
  s.coef = smem;
  s.slot_lm = s.coef + L * 16 * t;
  s.slot_cols = s.slot_lm + slots;
  s.slot_seed = s.slot_cols + slots;
  s.queue = s.slot_seed + slots;
  s.planes = s.queue + kWarps * 3 * kQueue;
  return s;
}

// One live (record, combination) slot: its fingerprints into every depth
// row of its level's plane.
__device__ __forceinline__ void ingest_slot(const Smem& s, uint32_t* dst,
                                            const int32_t* __restrict__ values, int d, int t,
                                            int w, uint32_t base1, uint32_t base2,
                                            uint32_t b, uint32_t q, int32_t weight) {
  const int l = static_cast<int>(s.slot_lm[q] & 0xFFu);
  uint32_t fp1, fp2;
  sjpc::horner_columns(values + static_cast<int64_t>(b) * d, s.slot_cols[q], s.slot_seed[q],
                       base1, base2, d, &fp1, &fp2);
  sjpc::sketch_add(dst + static_cast<int64_t>(l) * t * w, s.coef + l * 16 * t, t, w, fp1, fp2,
                   weight);
}

template <bool kTile>
__global__ void __launch_bounds__(kThreads)
fused_ingest_kernel(int32_t* __restrict__ counters, const int32_t* __restrict__ values,
                    const int32_t* __restrict__ masks, const int32_t* __restrict__ ids,
                    const int32_t* __restrict__ bases, const int32_t* __restrict__ bcoef,
                    const int32_t* __restrict__ scoef, const int32_t* __restrict__ weights,
                    Levels lv, long long B, int m_max, int d, int t, int w,
                    long long rows_per_cta) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int L = lv.count;
  const int slots = lv.offset[L];
  const Smem s = carve(smem, L, t, slots);
  for (int l = 0; l < L; ++l) {
    sjpc::load_coeffs(s.coef + l * 16 * t, bcoef + static_cast<int64_t>(l) * t * 8,
                      scoef + static_cast<int64_t>(l) * t * 8, t);
  }
  for (int q = threadIdx.x; q < slots; q += blockDim.x) {
    int l = 0;
    while (q >= lv.offset[l + 1]) ++l;
    const int m = q - lv.offset[l];
    const int64_t slot = static_cast<int64_t>(l) * m_max + m;
    uint32_t cols = 0;
    for (int c = 0; c < d; ++c) cols |= (masks[slot * d + c] != 0 ? 1u : 0u) << c;
    s.slot_lm[q] = static_cast<uint32_t>(l) | (static_cast<uint32_t>(m) << 8);
    s.slot_cols[q] = cols;
    s.slot_seed[q] = sjpc::horner_seed(static_cast<uint32_t>(ids[slot]));
  }
  // Counters are added as uint32 so that overflow wraps as int32 adds do.
  uint32_t* global_planes = reinterpret_cast<uint32_t*>(counters);
  const int plane_words = L * t * w;
  if (kTile) sjpc::zero_tile(s.planes, plane_words);
  __syncthreads();

  const uint32_t base1 = static_cast<uint32_t>(bases[0]);
  const uint32_t base2 = static_cast<uint32_t>(bases[1]);
  uint32_t* dst = kTile ? s.planes : global_planes;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* qb = s.queue + warp * 3 * kQueue;
  uint32_t* qs = qb + kQueue;
  uint32_t* qw = qs + kQueue;
  const unsigned lanes_below = (1u << lane) - 1u;

  // the CTA's (record, slot) items, numbered from its first record (the
  // wrapper keeps their count below 2^32)
  const long long first = static_cast<long long>(blockIdx.x) * rows_per_cta;
  const long long last = first + rows_per_cta < B ? first + rows_per_cta : B;
  const uint32_t end = static_cast<uint32_t>(last > first ? (last - first) * slots : 0);
  int queued = 0;   // warp-uniform
  for (uint32_t base = warp * 32; base < end; base += kWarps * 32) {
    const uint32_t i = base + lane;
    int32_t weight = 0;
    uint32_t b = 0, q = 0;
    if (i < end) {
      const uint32_t r = i / static_cast<uint32_t>(slots);
      q = i - r * static_cast<uint32_t>(slots);
      b = static_cast<uint32_t>(first) + r;
      const uint32_t lm = s.slot_lm[q];
      weight = weights[(static_cast<int64_t>(b) * L + (lm & 0xFFu)) * m_max + (lm >> 8)];
    }
    const unsigned live = __ballot_sync(kFull, weight != 0);
    if (weight != 0) {
      const int pos = queued + __popc(live & lanes_below);
      qb[pos] = b;
      qs[pos] = q;
      qw[pos] = static_cast<uint32_t>(weight);
    }
    queued += __popc(live);
    __syncwarp();
    if (queued >= 32) {
      ingest_slot(s, dst, values, d, t, w, base1, base2, qb[lane], qs[lane],
                  static_cast<int32_t>(qw[lane]));
      __syncwarp();
      if (lane + 32 < queued) {
        qb[lane] = qb[lane + 32];
        qs[lane] = qs[lane + 32];
        qw[lane] = qw[lane + 32];
      }
      queued -= 32;
      __syncwarp();
    }
  }
  if (lane < queued) {
    ingest_slot(s, dst, values, d, t, w, base1, base2, qb[lane], qs[lane],
                static_cast<int32_t>(qw[lane]));
  }

  if (kTile) {
    __syncthreads();
    sjpc::flush_tile(global_planes, s.planes, plane_words);
  }
}

}  // namespace

// counters (L, t, w) int32, updated in place; values (B, d), masks
// (L, m_max, d), ids (L, m_max), bases (2,), bcoef/scoef (L, t, 2, 4):
// uint32 words in int32; weights (B, L, m_max) int32.  live (host, L):
// each level's true combination count; its slots m >= live[l] carry
// weight 0.  The grid is ctas CTAs of rows_per_cta records each, with
// rows_per_cta * sum(live) < 2^32 (the wrapper's launch_grid).
extern "C" int sjpc_fused_ingest(void* counters, const void* values, const void* masks,
                                 const void* ids, const void* bases, const void* bcoef,
                                 const void* scoef, const void* weights, const int* live,
                                 long long B, int L, int m_max, int d, int t, int w,
                                 int ctas, long long rows_per_cta, int device, void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  if (L > kMaxLevels || d > 32 || m_max > (1 << 24) || ctas < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Levels lv{};
  lv.count = L;
  for (int l = 0; l < L; ++l) lv.offset[l + 1] = lv.offset[l] + live[l];
  const int slots = lv.offset[L];
  if (static_cast<long long>(ctas) * rows_per_cta < B || rows_per_cta * slots >= (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int optin = 48 * 1024;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const size_t base_bytes = words_before_planes(L, t, slots) * sizeof(uint32_t);
  const size_t plane_bytes = static_cast<size_t>(L) * t * w * sizeof(uint32_t);
  const bool use_tile = base_bytes + plane_bytes <= static_cast<size_t>(optin);
  const size_t smem = base_bytes + (use_tile ? plane_bytes : 0);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const int32_t*>(values);
  const auto* mk = static_cast<const int32_t*>(masks);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* bs = static_cast<const int32_t*>(bases);
  const auto* bc = static_cast<const int32_t*>(bcoef);
  const auto* sc = static_cast<const int32_t*>(scoef);
  const auto* wt = static_cast<const int32_t*>(weights);
  auto* c = static_cast<int32_t*>(counters);
  const dim3 grid(static_cast<unsigned>(ctas));
  if (use_tile) {
    cudaFuncSetAttribute(fused_ingest_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    fused_ingest_kernel<true><<<grid, kThreads, smem, s>>>(c, v, mk, id, bs, bc, sc, wt, lv, B,
                                                           m_max, d, t, w, rows_per_cta);
  } else {
    cudaFuncSetAttribute(fused_ingest_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    fused_ingest_kernel<false><<<grid, kThreads, smem, s>>>(c, v, mk, id, bs, bc, sc, wt, lv, B,
                                                            m_max, d, t, w, rows_per_cta);
  }
  return static_cast<int>(cudaGetLastError());
}
