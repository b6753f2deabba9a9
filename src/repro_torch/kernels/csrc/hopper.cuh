// Hopper building blocks shared by the tensor-core flash-attention kernels
// (flash_attention_tc.cu in bf16, flash_attention_f32.cu in f32 from split
// bf16 operands, flash_attention_bwd.cu in both): mbarriers, TMA loads
// through 4-D tensor maps of the model layout and bulk copies, wgmma
// descriptors and instructions, named barriers, the online softmax on the
// wgmma accumulator fragment, the store of each row's log-sum-exp for the
// backward, and the f32 kernels' split into three bf16 parts (the
// pre-pass over whole tensors and the split of an accumulator fragment
// into A fragments).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one head dimension of bf16 values: rows of hd
// bf16 in swizzle atoms of kSwizzle bytes (kAtomCols columns); a tile of R
// rows is kChunks column blocks of R * kSwizzle bytes each.
template <int HD>
struct Swizzle {
  static constexpr int kSwizzle = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kAtomCols = kSwizzle / 2;
  static constexpr int kChunks = HD / kAtomCols;
  // wgmma descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : (kSwizzle == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle kTmaSwizzle =
      kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-D (hd, heads, seq, batch) tensor map into shared
// memory; completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int head, int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// `bytes` contiguous bytes from global into shared memory (both addresses
// 16-byte aligned, bytes a multiple of 16); completion is reported to
// `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers over the two consumer warpgroups (ids 1 and 2; 0 is
// __syncthreads).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// 2^x (MUFU.EX2; inputs below -126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// The f32 kernels' split: x = x0 + x1 + x2, each part the round-to-nearest
// bf16 of what the parts before it leave (all 24 bits of x).  A product of
// two split operands sums the kTerms partial products whose part indices
// add up to at most 2, smallest first: term t multiplies part term_a(t) of
// the left operand by part term_b(t) of the right one, (0, 2), (1, 1),
// (2, 0), (0, 1), (1, 0), (0, 0).
constexpr int kParts = 3;
constexpr int kTerms = 6;
__host__ __device__ constexpr int term_a(int t) { return t < 3 ? t : (t == 4 ? 1 : 0); }
__host__ __device__ constexpr int term_b(int t) { return t < 3 ? 2 - t : (t == 3 ? 1 : 0); }

// An accumulator fragment x (64 x N, the layout of Rows) as the A
// fragments of a product over its N columns, in NP bf16 parts: register r
// of k-step kk of part j holds part j of x[8kk + 2r] and x[8kk + 2r + 1]
// (the accumulator layout of two 8-column blocks is the A layout of one
// k-step); parts from `keep` on are 0.
template <int NP, int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2],
                                            uint32_t (&parts)[NP][N / 16][4], int keep) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float r0 = x[8 * kk + 2 * r], r1 = x[8 * kk + 2 * r + 1];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(r0, r1);
        parts[j][kk][r] = j < keep ? bf16x2_bits(p) : 0u;
        const float2 f = __bfloat1622float2(p);
        r0 -= f.x;
        r1 -= f.y;
      }
    }
  }
}

template <int NP, int N>
__device__ __forceinline__ void fence_parts(uint32_t (&parts)[NP][N / 16][4]) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) fence_regs(parts[j][kk]);
  }
}

// One tensor for the split pre-pass: n4 groups of four f32 values, and
// its three bf16 parts, part j of group i at parts[j * n4 + i]; parts
// from `keep` on are written as zeros.
struct SplitJob {
  const float4* x;
  uint2* parts;
  long long n4;
  int keep;
};

struct SplitJobs {
  SplitJob job[4];
};

constexpr int kSplitThreads = 256;

// x = x0 + x1 + x2 for every element of the tensor of job blockIdx.y.
__global__ void __launch_bounds__(kSplitThreads) split_kernel(const SplitJobs jobs) {
  const SplitJob job = blockIdx.y == 0   ? jobs.job[0]
                       : blockIdx.y == 1 ? jobs.job[1]
                       : blockIdx.y == 2 ? jobs.job[2]
                                         : jobs.job[3];
  for (long long i = static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x; i < job.n4;
       i += static_cast<long long>(gridDim.x) * kSplitThreads) {
    const float4 x = job.x[i];
    float r[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < kParts; ++j) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
      job.parts[j * job.n4 + i] =
          j < job.keep ? make_uint2(bf16x2_bits(lo), bf16x2_bits(hi)) : make_uint2(0u, 0u);
      const float2 flo = __bfloat1622float2(lo);
      const float2 fhi = __bfloat1622float2(hi);
      r[0] -= flo.x;
      r[1] -= flo.y;
      r[2] -= fhi.x;
      r[3] -= fhi.y;
    }
  }
}

// Launches split_kernel over the first n of `jobs` (at most 8 CTAs an SM).
inline cudaError_t split_all(const SplitJobs& jobs, int n, cudaStream_t stream) {
  long long most = 0;
  for (int i = 0; i < n; ++i) most = jobs.job[i].n4 > most ? jobs.job[i].n4 : most;
  long long blocks = (most + kSplitThreads - 1) / kSplitThreads;
  blocks = blocks < 132 * 8 ? blocks : 132 * 8;
  if (blocks == 0) return cudaSuccess;
  split_kernel<<<dim3(static_cast<unsigned>(blocks), n), kSplitThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// wgmma_ss: d (64 x N) = A (64 x 16) B^T (N x 16), both from shared
// memory, K-major, plus d unless `accumulate` is 0; N is 32, 64 or 128 by
// the size of d.  wgmma_rs: d (64 x N) = A (64 x 16, registers) B (16 x N,
// shared memory, MN-major), plus d unless `accumulate` is 0; N is 16, 32,
// 64 or 128.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// This thread's rows of the 64-row accumulator fragment: qa and qa + 8
// (absolute query positions), and col0, the first of its two columns in
// each 8-column block; qrow0 is the warpgroup's first row.
struct Rows {
  int qrow0, qa, col0;
};

// The online softmax of the rows qa and qa + 8 over one tile of BK scores:
// sc[4j + e] is row (e & 2 ? qa + 8 : qa), key k0 + 8j + col0 + (e & 1).
template <int BK>
struct Softmax {
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f, alpha_a = 0.f, alpha_b = 0.f;

  // Scores -> scaled scores in place, -1e30 where masked; each row's max
  // over the tile (reduced over the row's four threads).
  __device__ __forceinline__ void scale_mask(float (&sc)[BK / 2], const Rows& rows, int k0,
                                             int Skv, float scale, int causal, float& mx_a,
                                             float& mx_b) const {
    const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > rows.qrow0);
    mx_a = kNegInf;
    mx_b = kNegInf;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sc[i] * scale;
      if (need_mask) {
        const int kpos = k0 + (i / 4) * 8 + rows.col0 + (i & 1);
        const int qpos = rows.qa + ((i & 2) ? 8 : 0);
        if (kpos >= Skv || (causal && kpos > qpos)) x = kNegInf;
      }
      sc[i] = x;
      if (i & 2) {
        mx_b = fmaxf(mx_b, x);
      } else {
        mx_a = fmaxf(mx_a, x);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
  }

  // The max sweep of probs_bf16: folds the tile's row maxima into m and
  // forms no probability.  After every tile has been observed, update()
  // finds m unchanged on each tile (the same scores, scaled and masked the
  // same way), so each P is formed at its row's final max.
  __device__ __forceinline__ void observe(float (&sc)[BK / 2], const Rows& rows, int k0, int Skv,
                                          float scale, int causal) {
    float mx_a, mx_b;
    scale_mask(sc, rows, k0, Skv, scale, causal, mx_a, mx_b);
    m_a = fmaxf(m_a, mx_a);
    m_b = fmaxf(m_b, mx_b);
  }

  // Scores -> probabilities in place; updates m and l and keeps the
  // rescale factors of the accumulator.
  __device__ __forceinline__ void update(float (&sc)[BK / 2], const Rows& rows, int k0, int Skv,
                                         float scale, int causal) {
    float mx_a, mx_b;
    scale_mask(sc, rows, k0, Skv, scale, causal, mx_a, mx_b);
    const float mn_a = fmaxf(m_a, mx_a);
    const float mn_b = fmaxf(m_b, mx_b);
    float sum_a = 0.f, sum_b = 0.f;
    const float ml_a = mn_a * kLog2e, ml_b = mn_b * kLog2e;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float mn = (i & 2) ? mn_b : mn_a;
      const float p = mn > kHalfNegInf ? ex2(fmaf(sc[i], kLog2e, -((i & 2) ? ml_b : ml_a))) : 0.f;
      sc[i] = p;
      if (i & 2) {
        sum_b += p;
      } else {
        sum_a += p;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    alpha_a = m_a > kHalfNegInf ? ex2((m_a - mn_a) * kLog2e) : 0.f;
    alpha_b = m_b > kHalfNegInf ? ex2((m_b - mn_b) * kLog2e) : 0.f;
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
  }

  // acc (64 x N fragment, the same row layout) *= alpha of its row.
  template <int N>
  __device__ __forceinline__ void rescale(float (&acc)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] *= (i & 2) ? alpha_b : alpha_a;
  }
};

// The log-sum-exp of the rows qa and qa + 8 after the last tile, into lse
// (B, H, Sq) float32: m + logf(l), +inf for a row that saw no key.  Called
// by one thread of each row's four.
template <int BK>
__device__ __forceinline__ void store_lse(float* lse, const Softmax<BK>& sm, int b, int h, int H,
                                          int Sq, int qa) {
  float* row = lse + (static_cast<size_t>(b) * H + h) * Sq;
  if (qa < Sq) row[qa] = sm.m_a > kHalfNegInf ? sm.m_a + logf(sm.l_a) : INFINITY;
  if (qa + 8 < Sq) row[qa + 8] = sm.m_b > kHalfNegInf ? sm.m_b + logf(sm.l_b) : INFINITY;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which these libraries do not
// link; the CUDA runtime's entry-point query finds it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor in the model layout (batch, seq, heads, hd) as a 4-D map,
// innermost first, read in boxes of (kAtomCols columns, one head, `rows`
// rows, one batch).  A zero-length sequence is mapped as length 1 (no box
// is ever loaded).
template <int HD>
bool make_map(CUtensorMap* map, const void* ptr, int heads, int seq, int batch, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t len = seq > 0 ? seq : 1;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads), len,
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {HD * 2, static_cast<cuuint64_t>(heads) * HD * 2,
                                 len * heads * HD * 2};
  const cuuint32_t box[4] = {Swizzle<HD>::kAtomCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, Swizzle<HD>::kTmaSwizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
