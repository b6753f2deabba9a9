// SJPC's per-record projection sampling (Algorithm 1, lines 8-12) for
// Hopper: the padded (B, L, m_max) int32 weights of every lattice level.
//
// Replaces src/repro/core/sjpc.py:145 _sample_level_weights, which XLA
// compiles on the accelerator (no Pallas kernel): for level idx (M =
// C(d, k) combinations), lk = fold_in(key, idx), (k_sel, k_round) =
// split(lk); record b's scores are the uniforms of elements b*M + m under
// k_sel; rank_m = #{j : s_j > s_m} + #{j < m : s_j == s_m}; the record
// keeps l_b = lo + [uniform(k_round)[b] < frac] combinations, those of rank
// < l_b, and its weight row is multiplied by row_mask[b].  Levels with
// lo >= M and frac == 0 keep every combination.  Bit for bit the JAX
// draws, so the counters equal the reference's under the same key.
//
// Arithmetic: native uint32 threefry2x32 (threefry.cuh).  Scores are
// compared as the 23-bit integers bits >> 9: uniform's map from them to
// floats is monotone and injective, so ranks and ties are the same.  The
// Bernoulli compares the float32 uniform with frac rounded once to
// float32, as JAX's weak-typed `u < frac` does.  Ties go to the lower
// index through a composite key (score, ~m): rank_m = #{j : c_j > c_m},
// and the kept set is the l_b largest composite keys.
//
// Keys come from the card: the kernel reads the round key's two words, and
// with a `step` pointer it first derives fold_in(key, *step) (the default
// key of SJPCState.step), so no key or step is read on the host.
//
// What bounds it: operations.  B*L*m_max*4 bytes are written (21 MB at B =
// 65,536, d=6, s=3), while each record needs a threefry block of about 72
// int32 operations (20 rounds of add, rotate and xor, 12 key additions)
// per score it ranks and per Bernoulli: 43 at the paper's widths.
//
// Design.  Small levels (M < 32, every level at the paper's widths): one
// thread per record, walking the small levels in turn, so a level's M, lo,
// frac and N are warp-uniform.  At a level it draws the Bernoulli only when
// frac > 0, and the M scores (two at a time) only when 0 < l_b < M (a
// level of one combination never needs its score), so no block is drawn
// that the result does not read.  The composite keys ((bits >> 9) << 5) |
// (31 - m) stay in registers, padded with 0 to N, the power of two at or
// above M, and a bitonic network sorts them in descending order
// (N log2 N (log2 N + 1) / 4 compare-exchanges, no shuffles); the top l_b
// keys' low bits give an M-bit keep mask.  A CTA takes tiles of 256
// records (a persistent grid sized to the SMs' occupancy); the keep masks
// go to shared memory, and the CTA then writes the tile's rows as one
// contiguous block, 16 bytes per thread and 512 per warp store (rows
// written one per thread, 16-byte stores with lanes 320 bytes apart, cost
// more than all the draws).  Zeros beyond M are written too, so the output
// needs no memset.  Each CTA derives every level's keys once, one lane per level.
// Indices are 32-bit when B*L*m_max < 2^31.  Large levels (32 <= M <=
// 1024, d up to 12): one CTA per (record, level) at a time, the composite
// keys in shared memory, rank by M broadcast reads per thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxCombos = 1024;
constexpr int kSmallThreads = 256;

// The levels of one launch, by value in the kernel's parameters.
struct LevelTable {
  int count;
  int level[kMaxLevels];   // level index idx (the fold_in data)
  int num[kMaxLevels];     // M = C(d, k)
  int lo[kMaxLevels];      // floor of the sample size
  float frac[kMaxLevels];  // its fraction, rounded to float32; 0: no Bernoulli
  int ones[kMaxLevels];    // keep every combination
  int width[kMaxLevels];   // small levels: N, the power of two at or above M
};

// (k_sel, k_round) of level idx from the round key (and the step).
__device__ __forceinline__ void level_keys(const long long* key, const int* step, int idx,
                                           sjpc::Key* out) {
  sjpc::Key k{static_cast<uint32_t>(key[0]), static_cast<uint32_t>(key[1])};
  if (step != nullptr) k = sjpc::fold_in(k, static_cast<uint32_t>(*step));
  const sjpc::Key lk = sjpc::fold_in(k, static_cast<uint32_t>(idx));
  out[0] = sjpc::split_first(lk);
  out[1] = sjpc::split_second(lk);
}

// Sorts N keys in descending order: a bitonic network, every index static
// so the keys stay in registers.
template <int N>
__device__ __forceinline__ void sort_descending(uint32_t (&c)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int p = i ^ j;
        if (p > i) {
          const uint32_t hi = c[i] > c[p] ? c[i] : c[p];
          const uint32_t lo = c[i] > c[p] ? c[p] : c[i];
          const bool descending = (i & k) == 0;
          c[i] = descending ? hi : lo;
          c[p] = descending ? lo : hi;
        }
      }
    }
  }
}

// The keep mask (bit m: combination m is kept) of record b at a level of
// M < 32 combinations, N the power of two at or above M.  Index is the
// type of element indices: uint32_t when every b*M + m < 2^31.
template <int N, typename Index>
__device__ __forceinline__ uint32_t keep_mask(sjpc::Key k_sel, sjpc::Key k_round, Index b,
                                              int M, int lo, float frac) {
  int l = lo;
  if (frac > 0.0f) {
    const uint32_t u = sjpc::random_bits(k_round, static_cast<uint64_t>(b));
    l += sjpc::uniform_from_bits(u) < frac ? 1 : 0;
  }
  if (l <= 0) return 0u;
  if (l >= M) return (1u << M) - 1u;
  const Index first = b * static_cast<Index>(M);
  // Scores two at a time, two independent threefry chains for the
  // scheduler to interleave; one more for an odd M.  Padding keys are 0,
  // below every real key, whose low bits 31 - m are >= 1.
  uint32_t c[N];
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    c[j] = 0u;
    c[j + 1] = 0u;
    if (j + 1 < M) {
      const uint32_t b0 = sjpc::random_bits(k_sel, static_cast<uint64_t>(first + j));
      const uint32_t b1 = sjpc::random_bits(k_sel, static_cast<uint64_t>(first + j + 1));
      c[j] = ((b0 >> 9) << 5) | static_cast<uint32_t>(31 - j);
      c[j + 1] = ((b1 >> 9) << 5) | static_cast<uint32_t>(30 - j);
    } else if (j < M) {
      const uint32_t b0 = sjpc::random_bits(k_sel, static_cast<uint64_t>(first + j));
      c[j] = ((b0 >> 9) << 5) | static_cast<uint32_t>(31 - j);
    }
  }
  sort_descending<N>(c);
  uint32_t mask = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < l) mask |= 1u << (31u - (c[i] & 31u));
  }
  return mask;
}

__device__ __forceinline__ int keep_bit(uint32_t mask, int j) {
  return j < 32 ? static_cast<int>((mask >> j) & 1u) : 0;
}

template <typename Index>
__device__ __forceinline__ uint32_t keep_mask_of_width(int N, sjpc::Key k_sel,
                                                       sjpc::Key k_round, Index b, int M,
                                                       int lo, float frac) {
  switch (N) {
    case 1:
    case 2: return keep_mask<2>(k_sel, k_round, b, M, lo, frac);
    case 4: return keep_mask<4>(k_sel, k_round, b, M, lo, frac);
    case 8: return keep_mask<8>(k_sel, k_round, b, M, lo, frac);
    case 16: return keep_mask<16>(k_sel, k_round, b, M, lo, frac);
    default: return keep_mask<32>(k_sel, k_round, b, M, lo, frac);
  }
}

// The keep mask of record b at small level li of tab, under the CTA's keys.
template <typename Index>
__device__ __forceinline__ uint32_t level_mask(const LevelTable& tab,
                                               sjpc::Key (*keys)[2], int li, Index b) {
  const int M = tab.num[li];
  if (tab.ones[li]) return (1u << M) - 1u;
  return keep_mask_of_width(tab.width[li], keys[li][0], keys[li][1], b, M, tab.lo[li],
                            tab.frac[li]);
}

// Each CTA derives the keys of its levels once, one lane per level.
__device__ __forceinline__ void derive_keys(const LevelTable& tab, const long long* key,
                                            const int* step, sjpc::Key (*keys)[2]) {
  if (threadIdx.x < tab.count && tab.ones[threadIdx.x] == 0) {
    level_keys(key, step, tab.level[threadIdx.x], keys[threadIdx.x]);
  }
}

// A CTA's walk over the units (4 ints, or 1 when m_max is no multiple of
// 4) of a tile's rows, row rho = r * nl + li holding record r's row of
// small level li: thread tid starts at unit tid and steps by kSmallThreads
// with no division, (r, li, unit) carried as one mixed-radix count.
struct RowWalk {
  int r, li, j;      // record in the tile, level, unit in the row
  int dr, dli, dj;   // one step: kSmallThreads units
  int nl, units;     // levels, units per row

  __device__ __forceinline__ RowWalk(int nl_, int units_) : nl(nl_), units(units_) {
    const int row = threadIdx.x / units, rows_per_step = kSmallThreads / units;
    j = threadIdx.x - row * units;
    r = row / nl;
    li = row - r * nl;
    dj = kSmallThreads - rows_per_step * units;
    dr = rows_per_step / nl;
    dli = rows_per_step - dr * nl;
  }

  __device__ __forceinline__ void step() {
    j += dj;
    li += dli;
    r += dr;
    if (j >= units) {
      j -= units;
      ++li;
    }
    if (li >= nl) {
      li -= nl;
      ++r;
    }
  }
};

// Writes rows records from b0 of every small level: s_mask[r * nl + li]
// times s_mul[r], 0 beyond M.  With every level small, the tile's rows are
// one contiguous block and a warp writes 512 contiguous bytes per store.
template <typename Index>
__device__ __forceinline__ void write_tile(const LevelTable& tab, const uint32_t* s_mask,
                                           const int* s_mul, int* __restrict__ out, Index b0,
                                           int rows, int L, int m_max, RowWalk walk) {
  const int nl = tab.count;
  if ((m_max & 3) == 0) {
    for (; walk.r < rows; walk.step()) {
      const uint32_t mask = s_mask[walk.r * nl + walk.li];
      const int mul = s_mul[walk.r], j = 4 * walk.j;
      const Index row = (b0 + walk.r) * static_cast<Index>(L) + tab.level[walk.li];
      reinterpret_cast<int4*>(out + row * static_cast<Index>(m_max))[walk.j] =
          make_int4(keep_bit(mask, j) * mul, keep_bit(mask, j + 1) * mul,
                    keep_bit(mask, j + 2) * mul, keep_bit(mask, j + 3) * mul);
    }
  } else {
    for (; walk.r < rows; walk.step()) {
      const uint32_t mask = s_mask[walk.r * nl + walk.li];
      const Index row = (b0 + walk.r) * static_cast<Index>(L) + tab.level[walk.li];
      out[row * static_cast<Index>(m_max) + walk.j] = keep_bit(mask, walk.j) * s_mul[walk.r];
    }
  }
}

// Small levels.  One thread per record: a CTA walks tiles of
// kSmallThreads records, persistent over the batch; each thread draws its
// record's keep mask at every small level in turn (the level warp-uniform
// at each step) into shared memory; then the CTA writes the tile's rows.
template <typename Index>
__global__ void __launch_bounds__(kSmallThreads)
sample_small_kernel(LevelTable tab, const long long* __restrict__ key,
                    const int* __restrict__ step, const int* __restrict__ row_mask,
                    int* __restrict__ out, Index B, int L, int m_max) {
  __shared__ sjpc::Key keys[kMaxLevels][2];
  __shared__ uint32_t s_mask[kSmallThreads * kMaxLevels];
  __shared__ int s_mul[kSmallThreads];
  derive_keys(tab, key, step, keys);
  const int nl = tab.count;
  const RowWalk walk(nl, (m_max & 3) == 0 ? m_max / 4 : m_max);
  for (Index b0 = static_cast<Index>(blockIdx.x) * kSmallThreads; b0 < B;
       b0 += static_cast<Index>(gridDim.x) * kSmallThreads) {
    const int rows = B - b0 < kSmallThreads ? static_cast<int>(B - b0) : kSmallThreads;
    __syncthreads();   // the keys are in; the last tile is written out
    if (threadIdx.x < rows) {
      const Index b = b0 + threadIdx.x;
      s_mul[threadIdx.x] = row_mask != nullptr ? row_mask[b] : 1;
      for (int li = 0; li < nl; ++li) {
        s_mask[threadIdx.x * nl + li] = level_mask(tab, keys, li, b);
      }
    }
    __syncthreads();
    write_tile(tab, s_mask, s_mul, out, b0, rows, L, m_max, walk);
  }
}

__global__ void sample_large_kernel(LevelTable tab, const long long* __restrict__ key,
                                    const int* __restrict__ step,
                                    const int* __restrict__ row_mask, int* __restrict__ out,
                                    long long B, int L, int m_max) {
  __shared__ sjpc::Key keys[2];
  __shared__ unsigned long long comp[kMaxCombos];
  __shared__ int s_l;
  const int li = blockIdx.y;
  const int idx = tab.level[li], M = tab.num[li], lo = tab.lo[li];
  const float frac = tab.frac[li];
  const bool ones = tab.ones[li] != 0;
  if (threadIdx.x == 0 && !ones) level_keys(key, step, idx, keys);
  __syncthreads();
  const sjpc::Key k_sel = keys[0], k_round = keys[1];
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    if (!ones) {
      for (int j = threadIdx.x; j < M; j += blockDim.x) {
        const uint32_t bits = sjpc::random_bits(k_sel, static_cast<uint64_t>(b) * M + j);
        comp[j] = (static_cast<unsigned long long>(bits >> 9) << 32) | (0xFFFFFFFFu - j);
      }
      if (threadIdx.x == 0) {
        const uint32_t u_bits = sjpc::random_bits(k_round, static_cast<uint64_t>(b));
        s_l = lo + ((frac > 0.0f && sjpc::uniform_from_bits(u_bits) < frac) ? 1 : 0);
      }
    }
    __syncthreads();
    const int mul = row_mask != nullptr ? row_mask[b] : 1;
    int* dst = out + (b * L + idx) * m_max;
    for (int j = threadIdx.x; j < m_max; j += blockDim.x) {
      int keep = j < M;
      if (keep && !ones) {
        const unsigned long long c = comp[j];
        int rank = 0;
        for (int k = 0; k < M; ++k) rank += comp[k] > c;
        keep = rank < s_l;
      }
      dst[j] = keep * mul;
    }
    __syncthreads();
  }
}

int sm_count(int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// CTAs of the small kernel resident on one SM, asked once per process.
template <typename Index>
int small_blocks_per_sm() {
  static int blocks = 0;
  if (blocks == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, sample_small_kernel<Index>,
                                                  kSmallThreads, 0);
    if (blocks < 1) blocks = 1;
  }
  return blocks;
}

template <typename Index>
void launch_small(const LevelTable& tab, const long long* key, const int* step,
                  const int* row_mask, int* out, long long B, int L, int m_max, int device,
                  cudaStream_t s) {
  const long long tiles = (B + kSmallThreads - 1) / kSmallThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * small_blocks_per_sm<Index>();
  sample_small_kernel<Index><<<static_cast<unsigned>(tiles < cap ? tiles : cap), kSmallThreads,
                               0, s>>>(tab, key, step, row_mask, out, static_cast<Index>(B), L,
                                       m_max);
}

// Splits the levels between the two kernels' tables (M < 32 small) and
// returns the large kernel's CTA width.
int split_levels(const int* nums, const int* los, const float* fracs, int L, LevelTable* small,
                 LevelTable* large) {
  int large_threads = 32;
  for (int idx = 0; idx < L; ++idx) {
    const int M = nums[idx];
    LevelTable& tab = M < 32 ? *small : *large;
    const int i = tab.count++;
    tab.level[i] = idx;
    tab.num[i] = M;
    tab.lo[i] = los[idx];
    tab.frac[i] = fracs[idx];
    tab.ones[i] = los[idx] >= M && fracs[idx] == 0.0f ? 1 : 0;
    int n = 1;
    while (n < M) n *= 2;
    tab.width[i] = n;
    if (M >= 32) {
      const int threads = (M + 31) / 32 * 32;
      if (threads > large_threads) large_threads = threads;
    }
  }
  return large_threads;
}

}  // namespace

// key: (2,) int64 words on the card; step: an int32 scalar on the card, or
// null; row_mask: (B,) int32, or null; out: (B, L, m_max) int32.  nums,
// los, fracs (host arrays of L): each level's M, lo and float32 frac.
extern "C" int sjpc_sample_weights(const void* key, const void* step, const void* row_mask,
                                   void* out, const int* nums, const int* los,
                                   const float* fracs, long long B, int L, int m_max,
                                   int device, void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || L <= 0) return static_cast<int>(cudaGetLastError());
  if (L > kMaxLevels || m_max > kMaxCombos) return static_cast<int>(cudaErrorInvalidValue);
  LevelTable small{}, large{};
  const int large_threads = split_levels(nums, los, fracs, L, &small, &large);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(key);
  const auto* st = static_cast<const int*>(step);
  const auto* rm = static_cast<const int*>(row_mask);
  auto* o = static_cast<int*>(out);
  if (small.count > 0) {
    if (B * L * m_max < (1LL << 31)) {
      launch_small<uint32_t>(small, k, st, rm, o, B, L, m_max, device, s);
    } else {
      launch_small<uint64_t>(small, k, st, rm, o, B, L, m_max, device, s);
    }
  }
  if (large.count > 0) {
    const long long cap = static_cast<long long>(sm_count(device)) * 16;
    const dim3 grid(static_cast<unsigned>(B < cap ? B : cap), large.count);
    sample_large_kernel<<<grid, large_threads, 0, s>>>(large, k, st, rm, o, B, L, m_max);
  }
  return static_cast<int>(cudaGetLastError());
}
