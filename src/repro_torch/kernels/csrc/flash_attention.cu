// Flash attention (forward) in float32, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas and its model-layout wrapper flash_attention)
// for float32 inputs (bfloat16 inputs go to csrc/flash_attention_tc.cu):
// online-softmax attention that never writes a score tile to device
// memory.  q (B, Sq, H, hd) and k, v (B, Skv, KV, hd) in the model's own
// layout, float32; out (B, Sq, H, hd) float32.  Query head
// h reads KV head h / (H / KV): KV heads are indexed, never expanded.
// Causal masking is top-left aligned (query i sees keys 0..i).  The math
// is that of the TPU kernel's body: scores in f32 times 1/sqrt(hd),
// masked scores -1e30, a running max m, normaliser l and accumulator acc;
// p is zeroed where m_new <= -0.5e30 and the rescale alpha where
// m_prev <= -0.5e30, and l is clamped at 1e-30 before the divide.  expf
// and IEEE division keep f32 within 2e-5 of the plain version (no TF32,
// no fast math).
//
// What bounds it: operations.  Causal attention does 4 * hd flops per
// visible (query, key) pair; at the serving shape (B 4, S 10,240, H 16,
// hd 128) that is 1.7 TFLOP against 0.4 GB of q, k, v and out, about 4,000
// flops per byte, far above the H100's f32 ridge (66.9 TFLOP/s over
// 3.35 TB/s = 20).  The f32 contract rules out TF32 tensor cores, so the
// bound is the CUDA cores' f32 FMA rate.
//
// Design (first version, simple and right): one CTA of 256 threads per
// (batch x head, 64-row query tile); the TPU kernel's sequential kv grid
// axis becomes a loop over 64-key tiles inside the CTA, and the tiles
// wholly above the diagonal are never visited.  Q (transposed), K
// (transposed) and V tiles are staged in shared memory as f32; each
// thread owns a 4 x 4 block of the score tile (query rows 4*ty.., keys
// 4*tx..) and a 4 x hd/16 block of the accumulator, so both products are
// register-tiled FMA loops over float4 shared-memory reads.  Row max and
// row sum reduce over the 16 threads of a row with warp shuffles; the
// probabilities go through shared memory (transposed) into the P.V
// product.  Query tiles run heaviest first.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBQ = 64;           // query rows per CTA
constexpr int kBK = 64;           // keys per tile
constexpr int kThreads = 256;     // 16 x 16: ty owns 4 query rows, tx 4 keys
constexpr int kPStride = kBQ + 4; // row stride of the transposed P tile
constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Rows [r0, r0 + kRows) of a row-major (n, row_stride) array, transposed
// into dst[d * kRows + r] as f32; rows at or past n are zero.  Consecutive
// threads take consecutive rows, so the shared-memory writes are free of
// bank conflicts.
template <typename T, int HD, int kRows>
__device__ __forceinline__ void load_transposed(float* dst, const T* src, size_t row_stride,
                                                int r0, int n) {
  for (int e = threadIdx.x; e < kRows * (HD / 4); e += kThreads) {
    const int r = e % kRows;
    const int d = (e / kRows) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = load4(src + static_cast<size_t>(r0 + r) * row_stride + d);
    dst[(d + 0) * kRows + r] = x.x;
    dst[(d + 1) * kRows + r] = x.y;
    dst[(d + 2) * kRows + r] = x.z;
    dst[(d + 3) * kRows + r] = x.w;
  }
}

// Rows [r0, r0 + kBK) as f32 into dst[r * HD + d], row-major; zero past n.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, size_t row_stride, int r0,
                                          int n) {
  for (int e = threadIdx.x; e < kBK * (HD / 4); e += kThreads) {
    const int r = e / (HD / 4);
    const int d = (e % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = load4(src + static_cast<size_t>(r0 + r) * row_stride + d);
    *reinterpret_cast<float4*>(dst + r * HD + d) = x;
  }
}

// Accumulator column c of thread tx: float4 groups 64 apart when a thread
// holds 4 or more columns, else contiguous.
template <int HD>
__device__ __forceinline__ int acc_col(int tx, int c) {
  constexpr int kCols = HD / 16;
  if constexpr (kCols >= 4) {
    return (c / 4) * 64 + tx * 4 + (c % 4);
  } else {
    return tx * kCols + c;
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(HD) * kBQ + HD * kBK + kBK * HD + kBK * kPStride);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int KV, int Sq, int Skv, float scale, int causal) {
  constexpr int kCols = HD / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [HD][kBQ]
  float* ks = qs + HD * kBQ;                    // [HD][kBK]
  float* vs = ks + HD * kBK;                    // [kBK][HD]
  float* ps = vs + kBK * HD;                    // [kBK][kPStride]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const T* qb = q + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * HD;
  const T* vb = v + static_cast<size_t>(b) * Skv * kv_stride + static_cast<size_t>(kvh) * HD;
  T* ob = o + static_cast<size_t>(b) * Sq * q_stride + static_cast<size_t>(h) * HD;

  load_transposed<T, HD, kBQ>(qs, qb, q_stride, q0, Sq);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Skv, q0 + kBQ) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's reads are done; qs is in place
    load_transposed<T, HD, kBK>(ks, kb, kv_stride, k0, Skv);
    load_rows<T, HD>(vs, vb, kv_stride, k0, Skv);
    __syncthreads();

    // S = Q K^T for rows 4*ty + i, keys 4*tx + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(qs + d * kBQ + ty * 4);
      const float4 c4 = *reinterpret_cast<const float4*>(ks + d * kBK + tx * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
    }

    // online softmax, one row at a time over the 16 threads of the row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (kpos >= Skv || (causal && kpos > qpos)) x = kNegInf;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = m_new > kHalfNegInf ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      const float alpha = m[i] > kHalfNegInf ? expf(m[i] - m_new) : 0.f;
      l[i] = l[i] * alpha + row_sum;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    // P, transposed: ps[key][row]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * kPStride + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 a4 = *reinterpret_cast<const float4*>(ps + j * kPStride + ty * 4);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float* vrow = vs + j * HD;
      if constexpr (kCols >= 4) {
#pragma unroll
        for (int c4 = 0; c4 < kCols / 4; ++c4) {
          const float4 w4 = *reinterpret_cast<const float4*>(vrow + c4 * 64 + tx * 4);
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              acc[i][c4 * 4 + cc] = fmaf(a[i], w[cc], acc[i][c4 * 4 + cc]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float w = vrow[tx * kCols + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(a[i], w, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + static_cast<size_t>(qpos) * q_stride;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(orow + acc_col<HD>(tx, c), acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                   int Sq, int Skv, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KV, Sq, Skv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                      int Sq, int Skv, int hd, int causal, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Sq, Skv, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// float32 q, k, v and out.  Returns the launch's CUDA error (0: none).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int H, int KV, int Sq, int Skv, int hd, int causal, int device,
                                   void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch_hd<float>(q, k, v, o, B, H, KV, Sq, Skv, hd, causal, s));
}
