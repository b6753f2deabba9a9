// Unfused Fast-AGMS update of one sketch from flat keys, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sketch_update.py
// (sketch_update_pallas): counters (t, w) int32 and flat keys fp1, fp2
// (N,) with int32 weights -> new counters, counters[row, bucket] +=
// sign * weight per key and depth row.  The TPU kernel builds a one-hot
// (block, w) matrix per row and contracts it on the MXU because a random
// scatter is slow there; on Hopper the scatter is uint32 atomicAdds, which
// wrap as int32 adds do and commute, so the counters are bit-exact in any
// order.
//
// What bounds it: bytes at SJPC's widths.  The function reads 12 B per
// key (two uint32 fingerprints, an int32 weight) and does 12*t mulmods
// per key of non-zero weight (two hashes, two halves, three Horner steps
// each, per depth row): at t = 3 that is 36 operations for 12 bytes,
// under the card's operations-per-byte balance.  This kernel reads the
// fingerprints and coefficients as int64 words, twice their bytes in the
// function.  At the unfused path's sizes (n = 4,096 x C(d, k) keys, a
// 12 KB plane) the bound is a fraction of a microsecond, so what a call
// costs is its fixed work: the launch, and the chain of dependent memory
// round trips (loads, barriers, the adds into the output).
//
// Design: one cooperative launch, which writes out = counters + the keys'
// sum; the input counters are only read, and no second launch clones
// them.  Each thread issues its first key's loads before anything else
// and keeps the next key's words in flight while a key hashes.  The grid
// copies counters into out; each CTA adds its keys into its own
// shared-memory copy of the plane (when it fits, tile_fits) with shared
// atomics; one grid barrier orders every copy before any add; then each
// CTA adds the non-zero entries of its copy into out with global atomics.
// Wider planes skip the shared copy: after the barrier, keys go into out
// with global atomics.  The grid is one CTA per kThreads keys, at most
// kMaxCtas and what can be resident at once (a cooperative launch needs
// all of it resident).  Keys of weight 0 leave before any arithmetic.
//
// Dev A/B on the H100 (PERF.md section 6): thread-block clusters of 8
// CTAs whose planes were summed through distributed shared memory, their
// G partial planes joined by a ticket counter, were slower than the
// parent's clone and kernel at n >= 24,576, and adding each key into the
// owning CTA's slice with remote atomics slower still; the cooperative
// grid beat both at every level of an unfused round.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"
#include "sketch_atomic.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCtas = 80;

template <bool kTile>
__global__ void __launch_bounds__(kThreads)
sketch_update_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ counters,
                     const int64_t* __restrict__ fp1, const int64_t* __restrict__ fp2,
                     const int32_t* __restrict__ weights, const int64_t* __restrict__ bcoef,
                     const int64_t* __restrict__ scoef, int64_t n, int t, int w) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* coef = smem;
  uint32_t* tile = smem + 16 * t;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  int64_t i = first;
  int32_t weight = 0;
  uint32_t k1 = 0, k2 = 0;
  if (i < n) {
    weight = weights[i];
    k1 = static_cast<uint32_t>(fp1[i]);
    k2 = static_cast<uint32_t>(fp2[i]);
  }
  const int64_t plane = static_cast<int64_t>(t) * w;
  for (int64_t e = first; e < plane; e += step) out[e] = counters[e];
  sjpc::load_coeffs(coef, bcoef, scoef, t);
  if (kTile) {
    sjpc::zero_tile(tile, t * w);
  } else {
    cg::this_grid().sync();   // out holds counters everywhere
  }
  __syncthreads();

  uint32_t* dst = kTile ? tile : out;
  while (i < n) {
    const int64_t next = i + step;
    int32_t next_weight = 0;
    uint32_t n1 = 0, n2 = 0;
    if (next < n) {
      next_weight = weights[next];
      n1 = static_cast<uint32_t>(fp1[next]);
      n2 = static_cast<uint32_t>(fp2[next]);
    }
    if (weight != 0) {
      // Canonical field elements, whatever uint32 word the caller gave.
      sjpc::sketch_add(dst, coef, t, w, sjpc::reduce_p31(k1), sjpc::reduce_p31(k2), weight);
    }
    i = next;
    weight = next_weight;
    k1 = n1;
    k2 = n2;
  }

  if (kTile) {
    cg::this_grid().sync();   // out holds counters everywhere; every tile is complete
    sjpc::flush_tile(out, tile, t * w);
  }
}

template <bool kTile>
int launch(uint32_t* out, const uint32_t* counters, const int64_t* fp1, const int64_t* fp2,
           const int32_t* weights, const int64_t* bcoef, const int64_t* scoef, long long n,
           int t, int w, int device, cudaStream_t stream) {
  const size_t smem = sjpc::coeff_bytes(t) + (kTile ? static_cast<size_t>(t) * w * 4 : 0);
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sketch_update_kernel<kTile>, kThreads, smem);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(per_sm) * sms;
  long long blocks = (n + kThreads - 1) / kThreads;
  blocks = blocks < kMaxCtas ? blocks : kMaxCtas;
  blocks = blocks < resident ? blocks : resident;
  blocks = blocks > 1 ? blocks : 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(blocks));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, sketch_update_kernel<kTile>, out,
                                             counters, fp1, fp2, weights, bcoef, scoef,
                                             static_cast<int64_t>(n), t, w));
}

}  // namespace

// out (t, w) is written whole (it may be uninitialised); counters is only
// read.  w is a power of two; n >= 0, t >= 1.
extern "C" int sjpc_sketch_update(void* out, const void* counters, const void* fp1,
                                  const void* fp2, const void* weights, const void* bcoef,
                                  const void* scoef, long long n, int t, int w, int device,
                                  void* stream) {
  cudaSetDevice(device);
  if (t < 1 || w < 1 || (w & (w - 1)) != 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* o = static_cast<uint32_t*>(out);
  const auto* c = static_cast<const uint32_t*>(counters);
  const auto* f1 = static_cast<const int64_t*>(fp1);
  const auto* f2 = static_cast<const int64_t*>(fp2);
  const auto* wt = static_cast<const int32_t*>(weights);
  const auto* bc = static_cast<const int64_t*>(bcoef);
  const auto* sc = static_cast<const int64_t*>(scoef);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = sjpc::tile_fits(t, w)
                      ? launch<true>(o, c, f1, f2, wt, bc, sc, n, t, w, device, s)
                      : launch<false>(o, c, f1, f2, wt, bc, sc, n, t, w, device, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
