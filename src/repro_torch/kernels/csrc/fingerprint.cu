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
// kernel writes int64 words, twice those bytes.
//
// Design: one thread per (record, combination); the Horner state lives in
// registers for the d static-length steps (the same device function the
// fused ingest kernel inlines).  Neighbouring threads take neighbouring
// combinations of one record, so the output writes coalesce and the
// record's d values are read once per warp from L1.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__global__ void fingerprint_kernel(const int64_t* __restrict__ values,
                                   const int64_t* __restrict__ masks,
                                   const int64_t* __restrict__ ids,
                                   const int64_t* __restrict__ bases,
                                   int64_t* __restrict__ out1, int64_t* __restrict__ out2,
                                   int64_t total, int M, int d) {
  const uint32_t base1 = static_cast<uint32_t>(bases[0]);
  const uint32_t base2 = static_cast<uint32_t>(bases[1]);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t b = i / M;
    const int m = static_cast<int>(i - b * M);
    uint32_t fp1, fp2;
    sjpc::masked_horner(values + b * d, masks + static_cast<int64_t>(m) * d, ids[m],
                        base1, base2, d, &fp1, &fp2);
    out1[i] = fp1;
    out2[i] = fp2;
  }
}

}  // namespace

extern "C" int sjpc_fingerprint(const void* values, const void* masks, const void* ids,
                                const void* bases, void* out1, void* out2,
                                long long B, int M, int d, int device, void* stream) {
  cudaSetDevice(device);
  const int64_t total = static_cast<int64_t>(B) * M;
  if (total > 0) {
    const int threads = 256;
    const int64_t want = (total + threads - 1) / threads;
    const int blocks = static_cast<int>(want < 65535 ? want : 65535);
    fingerprint_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(values), static_cast<const int64_t*>(masks),
        static_cast<const int64_t*>(ids), static_cast<const int64_t*>(bases),
        static_cast<int64_t*>(out1), static_cast<int64_t*>(out2), total, M, d);
  }
  return static_cast<int>(cudaGetLastError());
}
