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
// index through a composite key (score, ~m): rank_m = #{j : c_j > c_m}.
//
// Keys come from the card: the kernel reads the round key's two words, and
// with a `step` pointer it first derives fold_in(key, *step) (the default
// key of SJPCState.step), so no key or step is read on the host.  Every
// CTA derives its level's keys once (four threefry blocks, one thread).
//
// What bounds it: operations.  B*L*m_max*4 bytes are written (21 MB at B =
// 65,536, d=6, s=3), while each record needs sum_l (M_l + 1) threefry
// blocks of about 72 int32 operations (20 rounds of add, rotate and xor,
// 12 key additions) and sum_l M_l^2 comparisons.
//
// Design.  Small levels (M < 32, every level at the paper's widths): one
// segment of W lanes per (record, level), W the power of two above M; lane
// m < M draws score m, lane M draws the Bernoulli uniform, so each lane
// runs one threefry block and no lane branches.  Ranks come from M
// width-W shuffles per lane.  The grid is (CTAs, levels): a warp holds one
// level, so M is warp-uniform.  Lanes write the row's m_max slots (0 beyond
// M), so the output needs no memset.  Large levels (32 <= M <= 1024, d up
// to 12): one CTA per (record, level) at a time, the composite keys in
// shared memory, rank by M broadcast reads per thread.
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxCombos = 1024;
constexpr int kSmallThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The levels of one launch, by value in the kernel's parameters.
struct LevelTable {
  int count;
  int level[kMaxLevels];   // level index idx (the fold_in data)
  int num[kMaxLevels];     // M = C(d, k)
  int lo[kMaxLevels];      // floor of the sample size
  float frac[kMaxLevels];  // its fraction, rounded to float32; 0: no Bernoulli
  int ones[kMaxLevels];    // keep every combination
  int width[kMaxLevels];   // small levels: the segment width W
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

__global__ void __launch_bounds__(kSmallThreads)
sample_small_kernel(LevelTable tab, const long long* __restrict__ key,
                    const int* __restrict__ step, const int* __restrict__ row_mask,
                    int* __restrict__ out, long long B, int L, int m_max) {
  __shared__ sjpc::Key keys[2];
  const int li = blockIdx.y;
  const int idx = tab.level[li], M = tab.num[li], W = tab.width[li], lo = tab.lo[li];
  const float frac = tab.frac[li];
  const bool ones = tab.ones[li] != 0;
  const int m = threadIdx.x & (W - 1);
  const int seg = threadIdx.x / W;
  const int per_cta = blockDim.x / W;
  if (static_cast<long long>(blockIdx.x) * per_cta >= B) return;   // the whole CTA
  if (threadIdx.x == 0 && !ones) level_keys(key, step, idx, keys);
  __syncthreads();
  const sjpc::Key k_sel = keys[0], k_round = keys[1];
  // b0 is the CTA's, so every thread runs the same iterations and the
  // shuffles see full warps
  for (long long b0 = static_cast<long long>(blockIdx.x) * per_cta; b0 < B;
       b0 += static_cast<long long>(gridDim.x) * per_cta) {
    const long long b = b0 + seg;
    int keep;
    if (ones) {
      keep = m < M;
    } else {
      const bool score = m < M;
      const uint32_t bits = sjpc::random_bits(
          score ? k_sel : k_round,
          score ? static_cast<uint64_t>(b) * M + m : static_cast<uint64_t>(b));
      const uint32_t c = ((bits >> 9) << 5) | static_cast<uint32_t>(31 - m);
      int rank = 0;
      for (int j = 0; j < M; ++j) rank += __shfl_sync(kFull, c, j, W) > c;
      const uint32_t u_bits = __shfl_sync(kFull, bits, M, W);
      const int l = lo + ((frac > 0.0f && sjpc::uniform_from_bits(u_bits) < frac) ? 1 : 0);
      keep = score && rank < l;
    }
    if (b < B) {
      const int mul = row_mask != nullptr ? row_mask[b] : 1;
      int* dst = out + (b * L + idx) * m_max;
      for (int j = m; j < m_max; j += W) dst[j] = j == m ? keep * mul : 0;
    }
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

int grid_cap(int device, int per_sm) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms * per_sm;
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
  int large_threads = 32;
  for (int idx = 0; idx < L; ++idx) {
    const int M = nums[idx];
    const bool ones = los[idx] >= M && fracs[idx] == 0.0f;
    LevelTable& tab = M < 32 ? small : large;
    const int i = tab.count++;
    tab.level[i] = idx;
    tab.num[i] = M;
    tab.lo[i] = los[idx];
    tab.frac[i] = fracs[idx];
    tab.ones[i] = ones ? 1 : 0;
    int w = 2;
    while (w < M + 1) w *= 2;
    tab.width[i] = w;
    if (M >= 32) {
      const int threads = (M + 31) / 32 * 32;
      if (threads > large_threads) large_threads = threads;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* k = static_cast<const long long*>(key);
  const auto* st = static_cast<const int*>(step);
  const auto* rm = static_cast<const int*>(row_mask);
  auto* o = static_cast<int*>(out);
  if (small.count > 0) {
    // enough CTAs for the widest level; a narrower level's CTAs hold more
    // records each, and those past the batch leave at once
    int max_width = 2;
    for (int i = 0; i < small.count; ++i) {
      if (small.width[i] > max_width) max_width = small.width[i];
    }
    const long long per_cta = kSmallThreads / max_width;
    const long long want = (B + per_cta - 1) / per_cta;
    const int cap = grid_cap(device, 8);
    const dim3 grid(static_cast<unsigned>(want < cap ? want : cap), small.count);
    sample_small_kernel<<<grid, kSmallThreads, 0, s>>>(small, k, st, rm, o, B, L, m_max);
  }
  if (large.count > 0) {
    const int cap = grid_cap(device, 16);
    const dim3 grid(static_cast<unsigned>(B < cap ? B : cap), large.count);
    sample_large_kernel<<<grid, large_threads, 0, s>>>(large, k, st, rm, o, B, L, m_max);
  }
  return static_cast<int>(cudaGetLastError());
}
