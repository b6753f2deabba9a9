// All-pairs similarity histograms of stacked samples, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_pairs.py
// (fused_pairs_pallas): items (N, R, d) uint32 and valid (N, R) ->
// (N, d+1) int32, out[n, k] = the ordered pairs (a != b, both valid) of
// sample n whose records agree on exactly k columns.  The reservoir
// estimator's query, and its bootstrap replicates stacked on N.
//
// The TPU kernel bins each (block_r, block_r) match tile with a one-hot
// product on the MXU.  Not here: a thread keeps its own histogram.
//
// What bounds it: operations.  The histogram is symmetric (a pair agrees
// on as many columns in either order), so the function needs d compares
// for each of the N*m(m-1)/2 unordered valid pairs (9.5e9 at N = 1,024,
// R = m = 1,755, d = 6) and reads only N*R*(d+1) words.
//
// Design.  A sample's rows fall into chunks of kChunk = 128 slots, and K
// consecutive chunks make an i-tile, T = ceil(R / (K*kChunk)) of them; K =
// 2 i-rows per thread, or 1 for samples of at most two chunks (the
// bootstrap's 256-slot replicates), whose short CTAs gain more from the
// residency fewer registers give, and for d > 12.  CTA (n, y) walks i-tile T-1-y and then
// i-tile y (once when they are the same), so every CTA of a sample meets
// about T+1 chunks: a balanced walk of the triangle.  For one i-tile it
// streams the chunks from the tile's first to the sample's last through
// two shared-memory buffers:
//   - Compaction.  A chunk is staged with its live rows only, in slot
//     order: each warp ballots the chunk's 128 flags (loaded one chunk
//     ahead into registers), so every thread knows its row's place and
//     the chunk's live count with no barrier.  Loop bounds then stop at
//     the live count: the walk loads no flag and takes no branch per pair.
//   - Asynchronous copies.  Chunk c+1 is copied (cp.async, 16, 8 or 4
//     bytes a word group) while chunk c is compared.
//   - Register blocking.  Thread t holds live row t of each of the tile's
//     K chunks in registers (taken from the staged buffer when that chunk
//     comes by), so each staged row read from shared memory (a broadcast:
//     all lanes read the same row) serves K compares.
//   - The triangle as loop bounds.  Row k of a thread meets chunk c of
//     its own tile only if k <= c - tile start; in chunk q = k it starts
//     after itself (j > t).  So chunk q walks [0, t] with rows 0..q-1 and
//     [t+1, live) with rows 0..q; later chunks walk [0, live) with all
//     rows.  Rows past a chunk's live count (holes, the ragged tail) are
//     compared like the others and dropped when their bins are widened.
//     (A round-robin split of the diagonal chunk, which gives every lane
//     the same share, measured no faster at either shape.)
//   - Cheap bins.  A pair's matches are counted as 8 per equal column, the
//     shift of its 8-bit bin in a 64-bit register (bins 8-15 in a second
//     one, bin 16 alone); a bin grows by at most 128 in a chunk, so the
//     fields are widened into 32-bit counts after each chunk, never
//     overflowing.
// What is left per pair is about 18 integer-pipe instructions at d = 6 (a
// compare and a select per column, three adds, the bin's shift and add):
// the kernel runs near the INT32 issue rate, three times its bound's six.
// At the end the CTA reduces its threads' histograms with warp shuffles
// and shared atomics and adds d+1 doubled counts to global memory.  Counts
// are exact int32 (a stream of R = 2,633 has 6.9 M ordered pairs), so the
// order of the atomics changes nothing.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kChunk = 128;     // slots per chunk, and threads per CTA
constexpr int kMaxD = 16;
// i-rows per thread (register blocking, K): 2, or 1 for samples of at most
// kSmallChunks chunks, whose short CTAs gain more from the residency that
// fewer registers give than from sharing each staged row, and for rows of
// more than kMaxBlockedD columns (at d = 14 two rows spill registers).
constexpr int kRows = 2;
constexpr int kSmallChunks = 2;
constexpr int kMaxBlockedD = 12;

// A staged row's stride in words: rows of d = 4c load as 16-byte words,
// other rows as 8-byte words (padded to an even count), d = 1 as one word.
template <int D>
__host__ __device__ constexpr int stride() { return D % 4 == 0 ? D : (D == 1 ? 1 : (D + 1) & ~1); }

__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Copy one row's D words from global to shared memory, asynchronously.
template <int D>
__device__ __forceinline__ void copy_row(uint32_t* dst, const uint32_t* src) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) cp_async(dst + c, src + c, 16);
  } else if constexpr (D % 2 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 2) cp_async(dst + c, src + c, 8);
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) cp_async(dst + c, src + c, 4);
  }
}

// Read one staged row into registers (the padding word of an odd row is
// read and dropped).
template <int D>
__device__ __forceinline__ void load_row(const uint32_t* p, uint32_t (&b)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + c);
      b[c] = v.x; b[c + 1] = v.y; b[c + 2] = v.z; b[c + 3] = v.w;
    }
  } else if constexpr (D == 1) {
    b[0] = p[0];
  } else {
#pragma unroll
    for (int c = 0; c < D; c += 2) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + c);
      b[c] = v.x;
      if (c + 1 < D) b[c + 1] = v.y;
    }
  }
}

// One i-row's packed bins for the pairs of one chunk: 8-bit fields, bin k
// at bit 8k of lo (k < 8) or 8(k-8) of hi (k < 16), bin 16 in top.
template <int D>
struct Bins {
  uint64_t lo = 0, hi = 0;
  uint32_t top = 0;

  // m8 = 8 x the equal columns of one pair.
  __device__ __forceinline__ void add(uint32_t m8) {
    if constexpr (D < 8) {
      lo += 1ull << m8;
    } else {
      const uint64_t one = 1ull << (m8 & 63u);
      lo += m8 < 64u ? one : 0ull;
      hi += (m8 >> 6) == 1u ? one : 0ull;
      if constexpr (D == 16) top += m8 >> 7;
    }
  }

  // Add the fields into hist when the row is live, and clear them.
  __device__ __forceinline__ void widen(uint32_t (&hist)[D + 1], bool live) {
    const uint32_t keep = live ? 0xFFu : 0u;
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      if (k < 8) {
        hist[k] += static_cast<uint32_t>(lo >> (8 * k)) & keep;
      } else if (k < 16) {
        hist[k] += static_cast<uint32_t>(hi >> (8 * (k - 8))) & keep;
      } else {
        hist[k] += live ? top : 0u;
      }
    }
    lo = 0;
    hi = 0;
    top = 0;
  }
};

// Compare staged rows [begin, end) with the thread's first A i-rows.
template <int D, int K, int A>
__device__ __forceinline__ void walk(const uint32_t* buf, int begin, int end,
                                     uint32_t (&a)[K][D], Bins<D> (&bins)[K]) {
#pragma unroll 2
  for (int j = begin; j < end; ++j) {
    uint32_t b[D];
    load_row<D>(buf + j * stride<D>(), b);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      uint32_t m8 = 0;
#pragma unroll
      for (int c = 0; c < D; ++c) m8 += a[k][c] == b[c] ? 8u : 0u;
      bins[k].add(m8);
    }
  }
}

// Chunk q of the thread's own i-tile: rows 0..q-1 meet every staged row,
// row q only those after its own (slot t).
template <int D, int K, int Q>
__device__ __forceinline__ void walk_diagonal(int q, const uint32_t* buf, int live,
                                              uint32_t (&a)[K][D], Bins<D> (&bins)[K]) {
  if (q == Q) {
    const int t = static_cast<int>(threadIdx.x);
    if constexpr (Q > 0) walk<D, K, Q>(buf, 0, min(t + 1, live), a, bins);
    walk<D, K, Q + 1>(buf, t + 1, live, a, bins);
  } else if constexpr (Q + 1 < K) {
    walk_diagonal<D, K, Q + 1>(q, buf, live, a, bins);
  }
}

// The flags of chunk c, four per lane (slots lane, lane+32, ...): every
// warp ballots all 128, so each knows the chunk's compaction.
struct Flags {
  int32_t f[4];
};

__device__ __forceinline__ Flags load_flags(const int32_t* flags, int R, int c) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  Flags out;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int row = c * kChunk + w * 32 + lane;
    out.f[w] = row < R ? flags[row] : 0;
  }
  return out;
}

// Stage chunk c's live rows into buf, in slot order (asynchronously; one
// commit group); returns the chunk's live count.
template <int D>
__device__ __forceinline__ int stage(uint32_t* buf, const uint32_t* sample, const Flags& fl,
                                     int c) {
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  int before = 0, live = 0, mine = 0;
  bool own = false;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, fl.f[w] != 0);
    if (w < warp) before += __popc(ballot);
    if (w == warp) {
      own = (ballot >> lane) & 1u;
      mine = __popc(ballot & ((1u << lane) - 1u));
    }
    live += __popc(ballot);
  }
  if (own) {
    const int64_t row = static_cast<int64_t>(c) * kChunk + threadIdx.x;
    copy_row<D>(buf + (before + mine) * stride<D>(), sample + row * D);
  }
  cp_async_commit();
  return live;
}

template <int D, int K>
__global__ void __launch_bounds__(kChunk)
fused_pairs_kernel(const uint32_t* __restrict__ items, const int32_t* __restrict__ valid,
                   int32_t* __restrict__ out, int R, int n_chunks, int n_tiles) {
  __shared__ __align__(16) uint32_t s_rows[2][kChunk * stride<D>()];
  __shared__ uint32_t s_hist[D + 1];
  const int64_t n = blockIdx.x;
  const int y = static_cast<int>(blockIdx.y);
  const int t = static_cast<int>(threadIdx.x);
  const uint32_t* sample = items + n * R * D;
  const int32_t* flags = valid + n * R;
  if (t <= D) s_hist[t] = 0u;

  uint32_t hist[D + 1];
#pragma unroll
  for (int k = 0; k <= D; ++k) hist[k] = 0u;
  uint32_t a[K][D];
  Bins<D> bins[K];

  const int passes = n_tiles - 1 - y == y ? 1 : 2;
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = (pass == 0 ? n_tiles - 1 - y : y) * K;
    bool live_row[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      live_row[k] = false;
#pragma unroll
      for (int c = 0; c < D; ++c) a[k][c] = 0u;
    }
    Flags fl = load_flags(flags, R, c0);
    __syncthreads();   // the previous pass is done with both buffers
    int live = stage<D>(s_rows[0], sample, fl, c0);
    if (c0 + 1 < n_chunks) fl = load_flags(flags, R, c0 + 1);
    for (int c = c0; c < n_chunks; ++c) {
      const uint32_t* buf = s_rows[(c - c0) & 1];
      int live_next = 0;
      if (c + 1 < n_chunks) {
        live_next = stage<D>(s_rows[(c + 1 - c0) & 1], sample, fl, c + 1);
        if (c + 2 < n_chunks) fl = load_flags(flags, R, c + 2);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int q = c - c0;
      if (q < K) {
        // the tile's own chunk q: take row q (slot t) into registers
        uint32_t row[D];
        load_row<D>(buf + t * stride<D>(), row);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (k == q) {
            live_row[k] = t < live;
#pragma unroll
            for (int col = 0; col < D; ++col) a[k][col] = row[col];
          }
        }
        walk_diagonal<D, K, 0>(q, buf, live, a, bins);
      } else {
        walk<D, K, K>(buf, 0, live, a, bins);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) bins[k].widen(hist, live_row[k]);
      __syncthreads();   // buf is staged again two chunks on
      live = live_next;
    }
  }

  const int lane = t & 31;
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    uint32_t v = hist[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0 && v != 0u) atomicAdd(s_hist + k, v);
  }
  __syncthreads();
  if (t <= D && s_hist[t] != 0u) {
    atomicAdd(reinterpret_cast<uint32_t*>(out) + n * (D + 1) + t, 2u * s_hist[t]);
  }
}

template <int D>
void launch(const uint32_t* items, const int32_t* valid, int32_t* out, long long N, int R,
            cudaStream_t stream) {
  const int n_chunks = (R + kChunk - 1) / kChunk;
  const int rows = n_chunks <= kSmallChunks || D > kMaxBlockedD ? 1 : kRows;
  const int n_tiles = (n_chunks + rows - 1) / rows;
  const dim3 grid(static_cast<unsigned>(N), (n_tiles + 1) / 2);
  if constexpr (D <= kMaxBlockedD) {
    if (rows == kRows) {
      fused_pairs_kernel<D, kRows><<<grid, kChunk, 0, stream>>>(items, valid, out, R, n_chunks,
                                                                n_tiles);
      return;
    }
  }
  fused_pairs_kernel<D, 1><<<grid, kChunk, 0, stream>>>(items, valid, out, R, n_chunks,
                                                        n_tiles);
}

using Launcher = void (*)(const uint32_t*, const int32_t*, int32_t*, long long, int,
                          cudaStream_t);

template <int... Ds>
Launcher pick(int d, std::integer_sequence<int, Ds...>) {
  Launcher table[] = {nullptr, launch<Ds + 1>...};
  return table[d];
}

}  // namespace

// out must hold N * (d + 1) zeros; 1 <= d <= 16, R >= 1; items 16-byte
// aligned.
extern "C" int sjpc_fused_pairs(const void* items, const void* valid, void* out, long long N,
                                int R, int d, int device, void* stream) {
  cudaSetDevice(device);
  if (d < 1 || d > kMaxD || reinterpret_cast<uintptr_t>(items) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N > 0 && R > 0) {
    pick(d, std::make_integer_sequence<int, kMaxD>{})(
        static_cast<const uint32_t*>(items), static_cast<const int32_t*>(valid),
        static_cast<int32_t*>(out), N, R, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
