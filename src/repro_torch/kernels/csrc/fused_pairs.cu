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
// for each of the N*R(R-1)/2 unordered pairs (9.5e9 at N = 1,024,
// R = 1,755, d = 6) and reads only N*R*(d+1) words.
//
// Design: grid (N, R/128).  A CTA of 128 threads holds 128 i-rows, one per
// thread, in registers (d <= 16 words).  It walks the j-tiles of 128 rows
// from its own tile to the last, staged in shared memory as 32-bit words
// (3 KB at d = 6): each unordered pair is met once, by the thread of its
// lower index, and counted twice at the flush.  Every thread reads the same
// staged row at once (a broadcast), counts equal columns, skips invalid j
// and j <= i, and bumps its histogram.  Within a tile a bin grows by at
// most 128, so the bins live as 8-bit fields of 64-bit registers (one
// shift and one add per pair) and are widened into 32-bit counts after
// each tile.  At the end the CTA reduces its threads' histograms with warp
// shuffles and shared atomics and adds d+1 doubled counts to global
// memory.  Counts are exact int32 (a stream of R = 2,633 has 6.9 M ordered
// pairs), so the order of the atomics changes nothing.
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kThreads = 128;   // i-rows per CTA, and j-rows per staged tile
constexpr int kMaxD = 16;

template <int D>
__global__ void __launch_bounds__(kThreads)
fused_pairs_kernel(const uint32_t* __restrict__ items, const int32_t* __restrict__ valid,
                   int32_t* __restrict__ out, int R) {
  __shared__ uint32_t s_items[kThreads * D];
  __shared__ int32_t s_valid[kThreads];
  __shared__ uint32_t s_hist[D + 1];
  const int64_t n = blockIdx.x;
  const int i = blockIdx.y * kThreads + threadIdx.x;
  const uint32_t* sample = items + n * R * D;
  const int32_t* live_slots = valid + n * R;
  const bool live = i < R && live_slots[i] != 0;

  uint32_t row[D];
#pragma unroll
  for (int c = 0; c < D; ++c) row[c] = live ? sample[static_cast<int64_t>(i) * D + c] : 0u;
  uint32_t hist[D + 1];
#pragma unroll
  for (int k = 0; k <= D; ++k) hist[k] = 0u;
  if (threadIdx.x <= D) s_hist[threadIdx.x] = 0u;

  for (int j0 = blockIdx.y * kThreads; j0 < R; j0 += kThreads) {
    const int rows = min(kThreads, R - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * D; e += kThreads) {
      s_items[e] = sample[static_cast<int64_t>(j0) * D + e];
    }
    if (threadIdx.x < rows) s_valid[threadIdx.x] = live_slots[j0 + threadIdx.x];
    __syncthreads();
    if (!live) continue;
    uint64_t lo = 0, hi = 0;   // bins 0-7 and 8-15, 8 bits each
    uint32_t top = 0;          // bin 16
    for (int jj = 0; jj < rows; ++jj) {
      if (s_valid[jj] == 0 || j0 + jj <= i) continue;
      const uint32_t* other = s_items + jj * D;
      int m = 0;
#pragma unroll
      for (int c = 0; c < D; ++c) m += row[c] == other[c] ? 1 : 0;
      if (D < 8) {
        lo += 1ull << (8 * m);
      } else if (m < 8) {
        lo += 1ull << (8 * m);
      } else if (D < 16 || m < 16) {
        hi += 1ull << (8 * (m - 8));
      } else {
        top += 1u;
      }
    }
#pragma unroll
    for (int k = 0; k <= D; ++k) {
      if (k < 8) {
        hist[k] += static_cast<uint32_t>(lo >> (8 * k)) & 0xFFu;
      } else if (k < 16) {
        hist[k] += static_cast<uint32_t>(hi >> (8 * (k - 8))) & 0xFFu;
      } else {
        hist[k] += top;
      }
    }
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k <= D; ++k) {
    uint32_t v = hist[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
    if (lane == 0 && v != 0u) atomicAdd(s_hist + k, v);
  }
  __syncthreads();
  if (threadIdx.x <= D && s_hist[threadIdx.x] != 0u) {
    atomicAdd(reinterpret_cast<uint32_t*>(out) + n * (D + 1) + threadIdx.x,
              2u * s_hist[threadIdx.x]);
  }
}

template <int D>
void launch(const uint32_t* items, const int32_t* valid, int32_t* out, long long N, int R,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(N), (R + kThreads - 1) / kThreads);
  fused_pairs_kernel<D><<<grid, kThreads, 0, stream>>>(items, valid, out, R);
}

using Launcher = void (*)(const uint32_t*, const int32_t*, int32_t*, long long, int,
                          cudaStream_t);

template <int... Ds>
Launcher pick(int d, std::integer_sequence<int, Ds...>) {
  Launcher table[] = {nullptr, launch<Ds + 1>...};
  return table[d];
}

}  // namespace

// out must hold N * (d + 1) zeros; 1 <= d <= 16, R >= 1.
extern "C" int sjpc_fused_pairs(const void* items, const void* valid, void* out, long long N,
                                int R, int d, int device, void* stream) {
  cudaSetDevice(device);
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0 && R > 0) {
    pick(d, std::make_integer_sequence<int, kMaxD>{})(
        static_cast<const uint32_t*>(items), static_cast<const int32_t*>(valid),
        static_cast<int32_t*>(out), N, R, static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(cudaGetLastError());
}
