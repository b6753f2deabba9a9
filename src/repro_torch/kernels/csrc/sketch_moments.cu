// Row moments of one sketch pair, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sketch_moments.py
// (sketch_moments_pallas): (t, w) x (t, w) int32 counters -> (t,) float32,
// out[i] = sum_j A[i, j] * B[i, j]; F2 is the case A = B.  The TPU kernel
// blocks the width over a sequential grid axis with a VMEM accumulator.
//
// What bounds it: bytes (4 bytes read per multiply-add, 8 for a join's two
// sketches).  At SJPC's sizes (t <= 5 rows of w = 1024, 12 KB for F2) the
// bound is a few nanoseconds, so a call costs its launch and the memory
// round trips of its loads; the design keeps those to one.
//
// Design.  A row goes to a whole CTA of up to kThreads threads, or to a
// thread-block cluster of up to kMaxCluster CTAs when one CTA would take
// more than one pass of kVec loads per thread.  Each thread issues all of
// a pass's loads (128-bit int4 through the read-only path when w % 4 == 0
// and both row starts are 16-byte aligned, else 4-byte words) before its
// first product, so a row's reads are in flight together: at (3, 1024)
// three CTAs of 256 threads, one int4 each.  When A and B are one pointer
// (F2, what ops.sketch_moments(c) passes) the row is read once and
// squared.  Products are int64 and sums uint64, which wrap as int64 sums
// do; integer sums are associative, so the warp shuffles, the CTA's
// shared-memory partials and the cluster's partials, read by rank 0
// through distributed shared memory, give the plain version's bits in any
// order.  The sum is cast to float32 once.  No global atomics, no memset,
// one launch.
//
// The C entry is the one place the plan is chosen (plan(): threads per
// CTA, the cluster, vector or scalar loads, F2 or two streams).
// sjpc_sketch_moments_capped is the same launch under another cap on the
// cluster: chip_smoke.py times one CTA per row against the cluster with
// it.  At (3, 65536) the cluster was the faster (PERF.md section 6).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // most threads of a CTA
constexpr int kVec = 8;          // loads a thread has in flight per pass
constexpr int kMaxCluster = 8;   // most CTAs per row (a portable cluster)

struct Plan {
  int threads;   // per CTA, a multiple of 32
  int cluster;   // CTAs per row
  bool vector;   // int4 loads
  bool same;     // A and B one pointer: one load stream
};

Plan plan(const void* a, const void* b, int w, int max_cluster) {
  Plan p;
  p.vector = w % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(b) % 16 == 0;
  p.same = a == b;
  const int64_t units = p.vector ? w / 4 : w;
  const int64_t threads = (units + 31) / 32 * 32;
  p.threads = static_cast<int>(threads < 32 ? 32 : threads < kThreads ? threads : kThreads);
  const int64_t ctas = (units + kThreads * kVec - 1) / (kThreads * kVec);
  p.cluster = static_cast<int>(ctas < 1 ? 1 : ctas < max_cluster ? ctas : max_cluster);
  return p;
}

__device__ __forceinline__ uint64_t product(int32_t x, int32_t y) {
  return static_cast<uint64_t>(static_cast<int64_t>(x) * static_cast<int64_t>(y));
}

__device__ __forceinline__ uint64_t products(int4 x, int4 y) {
  return product(x.x, y.x) + product(x.y, y.y) + product(x.z, y.z) + product(x.w, y.w);
}

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  return v;
}

// This thread's share of one row: units u = g, g + G, g + 2G, ... (G the
// row's threads, g this thread's index among them), kVec per pass, all of
// a pass's loads issued before its products.
template <typename Unit, bool kSame>
__device__ __forceinline__ uint64_t thread_sum(const Unit* __restrict__ a,
                                               const Unit* __restrict__ b, int64_t units,
                                               int64_t g, int64_t stride) {
  uint64_t acc = 0;
  for (int64_t base = g; base < units; base += stride * kVec) {
    Unit x[kVec], y[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t u = base + k * stride;
      x[k] = u < units ? __ldg(a + u) : Unit{};
      if constexpr (!kSame) y[k] = u < units ? __ldg(b + u) : Unit{};
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      Unit yk;
      if constexpr (kSame) {
        yk = x[k];
      } else {
        yk = y[k];
      }
      if constexpr (sizeof(Unit) == 16) {
        acc += products(x[k], yk);
      } else {
        acc += product(x[k], yk);
      }
    }
  }
  return acc;
}

template <bool kVector, bool kSame>
__global__ void __launch_bounds__(kThreads)
sketch_moments_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                      float* __restrict__ out, int w) {
  __shared__ uint64_t warp_sums[kThreads / 32];
  __shared__ uint64_t cta_sum;
  const cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t row = blockIdx.x / ranks;
  const int64_t g = static_cast<int64_t>(rank) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(ranks) * blockDim.x;
  const int32_t* ra = a + row * w;
  const int32_t* rb = b + row * w;
  uint64_t acc;
  if constexpr (kVector) {
    acc = thread_sum<int4, kSame>(reinterpret_cast<const int4*>(ra),
                                  reinterpret_cast<const int4*>(rb), w / 4, g, stride);
  } else {
    acc = thread_sum<int32_t, kSame>(ra, rb, w, g, stride);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0);
    if (ranks == 1 && lane == 0) out[row] = static_cast<float>(static_cast<int64_t>(acc));
    if (lane == 0) cta_sum = acc;
  }
  if (ranks == 1) return;
  // every CTA's partial in its shared memory before rank 0 reads them, and
  // no CTA leaves before rank 0 has
  cluster.sync();
  if (rank == 0 && warp == 0) {
    acc = warp_sum(lane < ranks ? *cluster.map_shared_rank(&cta_sum, lane) : 0);
    if (lane == 0) out[row] = static_cast<float>(static_cast<int64_t>(acc));
  }
  cluster.sync();
}

template <bool kVector, bool kSame>
cudaError_t launch(const Plan& p, const int32_t* a, const int32_t* b, float* out, int t, int w,
                   cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(t) * p.cluster);
  config.blockDim = dim3(p.threads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = p.cluster > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&config, sketch_moments_kernel<kVector, kSame>, a, b, out, w);
}

int run(const void* a, const void* b, void* out, int t, int w, int max_cluster, int device,
        void* stream) {
  cudaSetDevice(device);
  if (t <= 0) return static_cast<int>(cudaGetLastError());
  const Plan p = plan(a, b, w, max_cluster);
  const auto* ia = static_cast<const int32_t*>(a);
  const auto* ib = static_cast<const int32_t*>(b);
  auto* o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.vector) {
    err = p.same ? launch<true, true>(p, ia, ib, o, t, w, s)
                 : launch<true, false>(p, ia, ib, o, t, w, s);
  } else {
    err = p.same ? launch<false, true>(p, ia, ib, o, t, w, s)
                 : launch<false, false>(p, ia, ib, o, t, w, s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// (t, w) int32 rows of a and b -> out (t,) float32; t == 0 launches
// nothing, w == 0 writes zeros.
extern "C" int sjpc_sketch_moments(const void* a, const void* b, void* out, int t, int w,
                                   int device, void* stream) {
  return run(a, b, out, t, w, kMaxCluster, device, stream);
}

// The same launch with at most max_cluster CTAs per row (1 to kMaxCluster).
extern "C" int sjpc_sketch_moments_capped(const void* a, const void* b, void* out, int t,
                                          int w, int max_cluster, int device, void* stream) {
  if (max_cluster < 1 || max_cluster > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(a, b, out, t, w, max_cluster, device, stream);
}
