// Flash attention (backward) in float32 on the CUDA cores and in bfloat16
// on the tensor cores (mma.sync).
//
// What it computes.  The gradients of flash attention (forward:
// flash_attention_f32.cu and flash_attention_tc.cu) from the forward's
// output O and each query row's log-sum-exp lse (m + log l of the scaled
// scores, +inf for a row that sees no key), and the cotangent dO:
//   D  = rowsum(dO * O)                              per query row;
//   P  = exp(S * scale - lse), S = Q K^T, 0 where masked;
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D);
//   dQ = dS K * scale,  dK = dS^T Q * scale,
// dK and dV summed over the query heads of each KV group.  q, out, dout
// (B, Sq, H, hd) and k, v (B, Skv, KV, hd) in the model's own layout, all
// float32 or all bfloat16 (the instantiation); dq, dk, dv in that dtype;
// everything in between is float32 (a product of two bf16 values is exact
// in f32).  Query head h reads KV head h / (H / KV): KV heads are indexed,
// never repeated.  Causal masking is top-left aligned (query i sees keys
// 0..i), for any Sq and Skv; without it Sq and Skv are free (the
// encoder-decoder's cross-attention).  probs_bf16 (the model's probs_dtype
// bfloat16, under which the forward rounded P and V before P V) rounds as
// torch autograd rounds through the plain version's .to(bf16).to(f32):
// V as it is read, P where dV reads it, dP, and dV once summed.
//
// JAX counterpart: there is no Pallas backward kernel.  Above
// CHUNKED_THRESHOLD the JAX package trains through chunked_attention
// (src/repro/models/attention.py), and jax.value_and_grad gives XLA's
// gradient of that plain jnp code; this kernel replaces that gradient,
// as the hand-written forward kernels replace the forward.  Its plain
// version is kernels/ref.py flash_attention_bwd_ref.
//
// Design: three launches, no atomics, so two calls on the same inputs give
// the same bits.
//   (a) dot_rows: D, one warp per query row of one head.
//   (b) dkdv: one CTA per (batch, query head, 64-key tile).  K and V stay
//       in shared memory; the CTA walks the query tiles that see the key
//       tile (causal: from the diagonal on), loading Q, dO, lse and D,
//       recomputing S and dP, and adds dV += P^T dO and dK += dS^T Q in
//       registers.  Where query heads share a KV head (GQA), each CTA
//       stores its head's sums in float32 scratch, so that no CTA walks the
//       whole group (one CTA per KV head left the first causal key tile
//       G times the walk of an average one).  The heaviest key tiles (the
//       first, under causal masking) launch first.
//   (c) dq: one CTA per (batch, head, 64-row query tile).  Q, dO, lse and D
//       stay in shared memory; the CTA walks the key tiles the rows see,
//       recomputes S, dP and dS the same way and adds dQ += dS K.  The
//       heaviest query tiles (the last, under causal masking) launch first.
//       Then, under GQA, the CTAs split the (batch, key, KV head) rows of
//       dK and dV and sum each over its group's heads, in head order.
// float32: 256 threads as a 16 x 16 grid; 64-row query tiles; every tile in
// shared memory as f32 rows padded by one float, so that a warp reads
// distinct banks in each of the five products; thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j (S and dP as 4 x 4 register tiles, P
// and dS through shared memory, the gradients as 4 x hd/16 tiles), f32
// FMA throughout.
// bfloat16: four warps of 16 rows each (keys in (b), queries in (c)),
// walking 32-row steps; tiles in shared memory as bf16 rows padded by 8
// (conflict-free 32-bit fragment loads), Q^T, dO^T and K^T beside them for
// the products that take them as B.  S^T and dP^T (b), S and dP (c) are
// mma.sync m16n8k16 accumulators; P and dS are rewritten in those
// registers and become A fragments as they are (the accumulator layout of
// two n-blocks is the A layout of one k-step), split into hi = bf16(x)
// and lo = bf16(x - hi), both multiplied, so they reach the tensor cores
// at about 16 bits (a relative error near 2^-17, far inside a bf16
// gradient's ulp; rounding P and dS to bf16 once would not be the
// function the plain version computes).
// Ragged tiles are zero-filled on load and masked; rows >= Sq and keys
// >= Skv are never stored.
//
// What bounds it: operations.  The function's useful work is 10 * hd flops
// per visible (query, key) pair (five products of 2 * hd): on the CUDA
// cores' f32 FMA rate (66.9 TFLOP/s) in f32 and the 989 TFLOP/s bf16
// tensor-core rate in bf16.  (b) and (c) recompute S and dP, so the f32
// kernel does 14 * hd; the bf16 kernel's hi/lo parts make it 20 * hd on
// the tensor cores.  Both are first designs: the f32 inner loops are
// bound by shared-memory loads (one 32-bit load per two FMAs in the S/dP
// step), and the bf16 one issues mma.sync from fragments it loads itself,
// with no copy in flight while it computes (wgmma and TMA, as in the
// forward, are later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kTile = 64;       // query rows and keys per tile
constexpr int kLdp = kTile + 1; // padded row of a (query, key) tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Shared-memory floats of one CTA: four hd-wide tiles, `pq` (query, key)
// tiles, and lse and D of the query rows.
template <int HD>
constexpr int smem_bytes(int pq) {
  return (4 * kTile * (HD + 1) + pq * kTile * kLdp + 2 * kTile) * 4;
}

// Rows r0 .. r0 + kTile - 1 of head `head` of a (B, S, heads, HD) float32
// tensor into dst[r][d] (row stride HD + 1), zero past S, rounded to bf16
// with `round`.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int b, int S,
                                          int heads, int head, int r0, bool round) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    float x = 0.f;
    if (row < S) x = src[((static_cast<size_t>(b) * S + row) * heads + head) * HD + d];
    dst[r * (HD + 1) + d] = round ? round_bf16(x) : x;
  }
}

// lse and D of the query rows q0 .. q0 + kTile - 1 of (b, h): +inf and 0
// past Sq (no probability there).
__device__ __forceinline__ void load_rows(float* lse_s, float* d_s, const float* __restrict__ lse,
                                          const float* __restrict__ D, size_t bh, int Sq, int q0) {
  if (threadIdx.x < kTile) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < Sq ? lse[bh * Sq + i] : INFINITY;
    d_s[threadIdx.x] = i < Sq ? D[bh * Sq + i] : 0.f;
  }
}

// One (key, column) entry of dK and dV from a CTA's sums over its query
// head: with part == nullptr (the KV head's only query head) stored in the
// output dtype, dK times scale and dV rounded to bf16 with probs_bf16;
// else as float32 partial sums into part, (2, B, Skv, H, HD), which
// sum_groups adds over each group.  kv_idx and h_idx index the entry in
// (B, Skv, KV, HD) and (B, Skv, H, HD); half is B * Skv * H * HD.
template <typename T>
__device__ __forceinline__ void put_dkdv(T* dk, T* dv, float* part, size_t kv_idx, size_t h_idx,
                                         size_t half, float dkv, float dvv, float scale,
                                         int probs_bf16) {
  if (part == nullptr) {
    dk[kv_idx] = from_f32<T>(dkv * scale);
    dv[kv_idx] = from_f32<T>(probs_bf16 ? round_bf16(dvv) : dvv);
  } else {
    part[h_idx] = dkv;
    part[half + h_idx] = dvv;
  }
}

// dK and dV from the partial sums of put_dkdv: each (b, key, KV head) row
// summed over the group's query heads in order (so the same bits every
// call), dK times scale, dV rounded to bf16 with probs_bf16.  The CTAs of
// the dq launch, which runs after the dkdv launch, split the B * Skv * KV
// rows evenly, after their own rows of dQ.
template <typename T, int HD>
__device__ void sum_groups(const float* __restrict__ part, T* __restrict__ dk,
                           T* __restrict__ dv, int H, int KV, int Skv, float scale,
                           int probs_bf16) {
  const int B = gridDim.x / H;
  const int G = H / KV;
  const size_t rows = static_cast<size_t>(B) * Skv * KV;
  const size_t ctas = static_cast<size_t>(gridDim.x) * gridDim.y;
  const size_t cta = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const size_t per = (rows + ctas - 1) / ctas;
  const size_t r0 = cta * per, r1 = r0 + per < rows ? r0 + per : rows;
  const size_t half = static_cast<size_t>(B) * Skv * H * HD;
  for (size_t idx = r0 * HD + threadIdx.x; idx < r1 * HD; idx += blockDim.x) {
    const size_t r = idx / HD;
    const size_t src = ((r / KV) * H + (r % KV) * G) * HD + idx % HD;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < G; ++g) {
      sk += part[src + g * HD];
      sv += part[half + src + g * HD];
    }
    dk[idx] = from_f32<T>(sk * scale);
    dv[idx] = from_f32<T>(probs_bf16 ? round_bf16(sv) : sv);
  }
}

// S = Q K^T and dP = dO V^T for rows ty + 16 a and keys tx + 16 c of the
// tiles, then P and dS of those entries: P = exp(S * scale - lse) where
// query q0 + row sees key k0 + key, else 0; dS = P (dP - D), dP rounded to
// bf16 with probs_bf16.
template <int HD>
__device__ __forceinline__ void probs(float (&p)[4][4], float (&ds)[4][4], const float* qs,
                                      const float* dos, const float* ks, const float* vs,
                                      const float* lse_s, const float* d_s, int q0, int k0,
                                      int Sq, int Skv, float scale, int causal, int probs_bf16) {
  constexpr int kLd = HD + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[4], oa[4], kc[4], vc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qa[a] = qs[(ty + 16 * a) * kLd + d];
      oa[a] = dos[(ty + 16 * a) * kLd + d];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      kc[c] = ks[(tx + 16 * c) * kLd + d];
      vc[c] = vs[(tx + 16 * c) * kLd + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const int i = q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tx + 16 * c;
      const bool seen = i < Sq && j < Skv && !(causal && j > i);
      const float pv = seen ? expf(s[a][c] * scale - lse_s[r]) : 0.f;
      const float dpv = probs_bf16 ? round_bf16(dp[a][c]) : dp[a][c];
      p[a][c] = pv;
      ds[a][c] = pv * (dpv - d_s[r]);
    }
  }
}

// D of every (b, i, h) row: one warp per row, in the model layout's order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_rows_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
                long long rows, int Sq, int H, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const T* po = o + row * hd;
  const T* pd = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f32(po[d]), to_f32(pd[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % H);
    const long long bi = row / H;
    D[(bi / Sq * H + h) * Sq + bi % Sq] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ D, float* __restrict__ dk, float* __restrict__ dv,
            float* __restrict__ part, int H, int KV, int Sq, int Skv, float scale, int causal,
            int probs_bf16) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;  // output columns per thread: tx + 16 c
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kLd;
  float* qs = vs + kTile * kLd;
  float* dos = qs + kTile * kLd;
  float* ps = dos + kTile * kLd;   // P (bf16-rounded with probs_bf16), [query][key]
  float* dss = ps + kTile * kLdp;  // dS, [query][key]
  float* lse_s = dss + kTile * kLdp;
  float* d_s = lse_s + kTile;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int k0 = blockIdx.y * kTile;  // the heaviest causal tiles launch first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<HD>(ks, k, b, Skv, KV, kvh, k0, false);
  load_tile<HD>(vs, v, b, Skv, KV, kvh, k0, probs_bf16 != 0);

  float dk_acc[4][kCols], dv_acc[4][kCols];  // keys ty + 16 a, columns tx + 16 c
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;
  }
  const int first = causal ? k0 / kTile : 0;  // the first query tile that sees key k0
  const int n_q = (Sq + kTile - 1) / kTile;
  for (int t = first; t < n_q; ++t) {
    const int q0 = t * kTile;
    __syncthreads();  // the last step is done with qs, dos, ps and dss
    load_tile<HD>(qs, q, b, Sq, H, h, q0, false);
    load_tile<HD>(dos, dout, b, Sq, H, h, q0, false);
    load_rows(lse_s, d_s, lse, D, static_cast<size_t>(b) * H + h, Sq, q0);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs<HD>(p, ds, qs, dos, ks, vs, lse_s, d_s, q0, k0, Sq, Skv, scale, causal, probs_bf16);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int idx = (ty + 16 * a) * kLdp + tx + 16 * c;
        ps[idx] = probs_bf16 ? round_bf16(p[a][c]) : p[a][c];
        dss[idx] = ds[a][c];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float pa[4], sa[4], oc[kCols], qc[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        pa[a] = ps[i * kLdp + ty + 16 * a];
        sa[a] = dss[i * kLdp + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        oc[c] = dos[i * kLd + tx + 16 * c];
        qc[c] = qs[i * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[a][c] = fmaf(pa[a], oc[c], dv_acc[a][c]);
          dk_acc[a][c] = fmaf(sa[a], qc[c], dk_acc[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= Skv) continue;
    const size_t kv_row = ((static_cast<size_t>(b) * Skv + j) * KV + kvh) * HD;
    const size_t h_row = ((static_cast<size_t>(b) * Skv + j) * H + h) * HD;
    const size_t half = static_cast<size_t>(gridDim.x) * Skv * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      put_dkdv(dk, dv, part, kv_row + tx + 16 * c, h_row + tx + 16 * c, half, dk_acc[a][c],
               dv_acc[a][c], scale, probs_bf16);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ D,
          float* __restrict__ dq, const float* __restrict__ part, float* __restrict__ dk,
          float* __restrict__ dv, int H, int KV, int Sq, int Skv, float scale, int causal,
          int probs_bf16) {
  constexpr int kLd = HD + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * kLd;
  float* ks = dos + kTile * kLd;
  float* vs = ks + kTile * kLd;
  float* dss = vs + kTile * kLd;   // dS, [query][key]
  float* lse_s = dss + kTile * kLdp;
  float* d_s = lse_s + kTile;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest causal tiles first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<HD>(qs, q, b, Sq, H, h, q0, false);
  load_tile<HD>(dos, dout, b, Sq, H, h, q0, false);
  load_rows(lse_s, d_s, lse, D, static_cast<size_t>(b) * H + h, Sq, q0);

  float dq_acc[4][kCols];  // rows ty + 16 a, columns tx + 16 c
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq_acc[a][c] = 0.f;
  }
  const int k_end = causal ? min(Skv, q0 + kTile) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last step is done with ks, vs and dss
    load_tile<HD>(ks, k, b, Skv, KV, kvh, k0, false);
    load_tile<HD>(vs, v, b, Skv, KV, kvh, k0, probs_bf16 != 0);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs<HD>(p, ds, qs, dos, ks, vs, lse_s, d_s, q0, k0, Sq, Skv, scale, causal, probs_bf16);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) dss[(ty + 16 * a) * kLdp + tx + 16 * c] = ds[a][c];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float sa[4], kc[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) sa[a] = dss[(ty + 16 * a) * kLdp + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kc[c] = ks[j * kLd + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) dq_acc[a][c] = fmaf(sa[a], kc[c], dq_acc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
    const size_t row = ((static_cast<size_t>(b) * Sq + i) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[row + tx + 16 * c] = dq_acc[a][c] * scale;
  }
  if (part != nullptr) sum_groups<float, HD>(part, dk, dv, H, KV, Skv, scale, probs_bf16);
}

// ---------------------------------------------------------------------------
// bfloat16 inputs: the same three launches on the tensor cores, with
// mma.sync m16n8k16 (bf16 operands, f32 accumulators) from shared memory.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // four warps of 16 rows each
constexpr int kRows = 64;         // the CTA's own rows: queries (dq) or keys (dkdv)
constexpr int kStep = 32;         // the rows walked per step: keys (dq) or queries (dkdv)
constexpr int kPad = 8;           // bf16 of padding per smem row: conflict-free fragment loads

// d (16 x 8, f32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col).  a[0..3]
// hold (row g, cols 2t, 2t+1), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8);
// b0, b1 (rows 2t, 2t+1 and 2t + 8, 2t + 9; column g); d[0..3] (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// x = hi + lo in bf16 (hi = bf16(x), lo = bf16(x - hi)): about 16 bits of x,
// so P and dS reach the tensor cores at f32-like precision (a relative
// error near 2^-17, far inside a bf16 gradient's ulp).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(x0 - hf.x, x1 - hf.y);
}

// The A fragments of k-step ks (columns 16 ks .. 16 ks + 15) of a 16-row
// accumulator tile acc[n-block][4], in hi and lo parts: the accumulator
// layout of two n-blocks is the A layout of one k-step.  Values that are
// bf16 already have lo = 0.
template <int NB>
__device__ __forceinline__ void a_frags(const float (&acc)[NB][4], int ks, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float* c0 = acc[2 * ks];
  const float* c1 = acc[2 * ks + 1];
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// The A fragment of k-step kk of the 16 rows at `rows` (row stride ld).
__device__ __forceinline__ void a_smem(const bf16* rows, int ld, int kk, uint32_t (&a)[4]) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const bf16* p = rows + g * ld + 16 * kk + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// d[nb] += a b for the 8 columns (B's n) at `cols` + 8 nb of an [n][k]
// tile (row stride ld), k-step kk, nb < NB.
template <int NB>
__device__ __forceinline__ void mma_row(float (&d)[NB][4], const uint32_t (&a)[4],
                                        const bf16* cols, int ld, int kk) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const bf16* p = cols + (8 * nb + g) * ld + 16 * kk + 2 * t;
    mma(d[nb], a, ld32(p), ld32(p + 8));
  }
}

// Rows r0 .. r0 + R - 1 of head `head` of a (B, S, heads, HD) bf16 tensor
// into nat[r][d] (row stride HD + kPad) and, if trans is given, into
// trans[d][r] (row stride R + kPad); zero past S.  16-byte loads.
template <int HD, int R>
__device__ __forceinline__ void load_bf16(bf16* nat, bf16* trans, const bf16* __restrict__ src,
                                          int b, int S, int heads, int head, int r0) {
  constexpr int kChunks = HD / 8;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int row = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < S)
      x = *reinterpret_cast<const uint4*>(
          src + ((static_cast<size_t>(b) * S + row) * heads + head) * HD + c);
    *reinterpret_cast<uint4*>(nat + r * (HD + kPad) + c) = x;
    if (trans != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int j = 0; j < 8; ++j) trans[(c + j) * (R + kPad) + r] = e[j];
    }
  }
}

// Shared-memory bytes of the bf16 kernels: dq holds Q and dO (kRows rows),
// K and V (kStep rows) and K^T; dkdv holds K and V (kRows), Q and dO
// (kStep), Q^T and dO^T; both lse and D of their query rows.
template <int HD>
constexpr int dq_mma_bytes() {
  return (2 * kRows * (HD + kPad) + 2 * kStep * (HD + kPad) + HD * (kStep + kPad)) * 2 +
         2 * kRows * 4;
}
template <int HD>
constexpr int dkdv_mma_bytes() {
  return (2 * kRows * (HD + kPad) + 2 * kStep * (HD + kPad) + 2 * HD * (kStep + kPad)) * 2 +
         2 * kStep * 4;
}

// dK and dV of kRows keys of (b, KV head): each warp owns 16 keys and walks
// the group's heads and the kStep-query chunks that see them, with S^T =
// K Q^T and dP^T = V dO^T as accumulators, P^T and dS^T turned into A
// fragments in registers (hi and lo parts), dV += P^T dO and dK += dS^T Q.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ D,
                bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part, int H,
                int KV, int Sq, int Skv, float scale, int causal, int probs_bf16) {
  constexpr int kLd = HD + kPad, kLdt = kStep + kPad;
  constexpr int kNd = HD / 8;      // n-blocks of hd
  constexpr int kNq = kStep / 8;   // n-blocks of a query chunk
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kRows * kLd;
  bf16* qs = vs + kRows * kLd;
  bf16* dos = qs + kStep * kLd;
  bf16* qts = dos + kStep * kLd;
  bf16* dots = qts + HD * kLdt;
  float* lse_s = reinterpret_cast<float*>(dots + HD * kLdt);
  float* d_s = lse_s + kStep;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const int k0 = blockIdx.y * kRows;  // the heaviest causal tiles launch first
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  load_bf16<HD, kRows>(ks, nullptr, k, b, Skv, KV, kvh, k0);
  load_bf16<HD, kRows>(vs, nullptr, v, b, Skv, KV, kvh, k0);
  const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;

  float dk_acc[kNd][4], dv_acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }
  const int first = causal ? k0 / kStep : 0;  // the first query chunk that sees key k0
  const int n_chunks = (Sq + kStep - 1) / kStep;
  for (int c = first; c < n_chunks; ++c) {
    const int q0 = c * kStep;
    __syncthreads();  // the last step is done with qs, dos, qts, dots
    load_bf16<HD, kStep>(qs, qts, q, b, Sq, H, h, q0);
    load_bf16<HD, kStep>(dos, dots, dout, b, Sq, H, h, q0);
    if (threadIdx.x < kStep) {
      const int i = q0 + threadIdx.x;
      lse_s[threadIdx.x] = i < Sq ? lse[bh * Sq + i] : INFINITY;
      d_s[threadIdx.x] = i < Sq ? D[bh * Sq + i] : 0.f;
    }
    __syncthreads();
    float st[kNq][4], dpt[kNq][4];
#pragma unroll
    for (int n = 0; n < kNq; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      a_smem(ks + 16 * warp * kLd, kLd, kk, a);
      mma_row<kNq>(st, a, qs, kLd, kk);
      a_smem(vs + 16 * warp * kLd, kLd, kk, a);
      mma_row<kNq>(dpt, a, dos, kLd, kk);
    }
    // P^T and dS^T in place of S^T and dP^T: element e of n-block n is
    // key (e < 2 ? key_a : key_b), query q0 + 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < kNq; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const int i = q0 + col, j = e < 2 ? key_a : key_b;
        const bool seen = i < Sq && j < Skv && !(causal && j > i);
        const float p = seen ? expf(st[n][e] * scale - lse_s[col]) : 0.f;
        const float dpv = probs_bf16 ? round_bf16(dpt[n][e]) : dpt[n][e];
        dpt[n][e] = p * (dpv - d_s[col]);
        st[n][e] = probs_bf16 ? round_bf16(p) : p;
      }
    }
#pragma unroll
    for (int ks2 = 0; ks2 < kStep / 16; ++ks2) {
      uint32_t p_hi[4], p_lo[4], s_hi[4], s_lo[4];
      a_frags<kNq>(st, ks2, p_hi, p_lo);
      a_frags<kNq>(dpt, ks2, s_hi, s_lo);
#pragma unroll
      for (int n = 0; n < kNd; ++n) {
        const bf16* pd = dots + (8 * n + g) * kLdt + 16 * ks2 + 2 * t;
        const uint32_t d0 = ld32(pd), d1 = ld32(pd + 8);
        mma(dv_acc[n], p_lo, d0, d1);
        mma(dv_acc[n], p_hi, d0, d1);
        const bf16* pq = qts + (8 * n + g) * kLdt + 16 * ks2 + 2 * t;
        const uint32_t q0w = ld32(pq), q1w = ld32(pq + 8);
        mma(dk_acc[n], s_lo, q0w, q1w);
        mma(dk_acc[n], s_hi, q0w, q1w);
      }
    }
  }
  const size_t half_size = static_cast<size_t>(gridDim.x) * Skv * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? key_b : key_a;
    if (j >= Skv) continue;
    const size_t kv_row = ((static_cast<size_t>(b) * Skv + j) * KV + kvh) * HD;
    const size_t h_row = ((static_cast<size_t>(b) * Skv + j) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        put_dkdv(dk, dv, part, kv_row + d, h_row + d, half_size, dk_acc[n][2 * half + e],
                 dv_acc[n][2 * half + e], scale, probs_bf16);
      }
    }
  }
}

// dQ of kRows queries of (b, head): each warp owns 16 queries and walks the
// kStep-key tiles they see, with S = Q K^T and dP = dO V^T as
// accumulators, dS turned into A fragments (hi and lo), dQ += dS K.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ D, bf16* __restrict__ dq, const float* __restrict__ part,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int Sq, int Skv,
              float scale, int causal, int probs_bf16) {
  constexpr int kLd = HD + kPad, kLdt = kStep + kPad;
  constexpr int kNd = HD / 8;
  constexpr int kNk = kStep / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kRows * kLd;
  bf16* ks = dos + kRows * kLd;
  bf16* vs = ks + kStep * kLd;
  bf16* kts = vs + kStep * kLd;
  float* lse_s = reinterpret_cast<float*>(kts + HD * kLdt);
  float* d_s = lse_s + kRows;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest causal tiles first
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const size_t bh = static_cast<size_t>(b) * H + h;
  load_bf16<HD, kRows>(qs, nullptr, q, b, Sq, H, h, q0);
  load_bf16<HD, kRows>(dos, nullptr, dout, b, Sq, H, h, q0);
  if (threadIdx.x < kRows) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < Sq ? lse[bh * Sq + i] : INFINITY;
    d_s[threadIdx.x] = i < Sq ? D[bh * Sq + i] : 0.f;
  }
  const int ra = 16 * warp + g, rb = ra + 8;  // the thread's rows in the tile
  float dq_acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;
  }
  const int k_end = causal ? min(Skv, q0 + kRows) : Skv;
  for (int k0 = 0; k0 < k_end; k0 += kStep) {
    __syncthreads();  // the last step is done with ks, vs, kts
    load_bf16<HD, kStep>(ks, kts, k, b, Skv, KV, kvh, k0);
    load_bf16<HD, kStep>(vs, nullptr, v, b, Skv, KV, kvh, k0);
    __syncthreads();
    float s[kNk][4], dp[kNk][4];
#pragma unroll
    for (int n = 0; n < kNk; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      a_smem(qs + 16 * warp * kLd, kLd, kk, a);
      mma_row<kNk>(s, a, ks, kLd, kk);
      a_smem(dos + 16 * warp * kLd, kLd, kk, a);
      mma_row<kNk>(dp, a, vs, kLd, kk);
    }
    // dS in place of dP: element e of n-block n is row (e < 2 ? ra : rb),
    // key k0 + 8 n + 2 t + (e & 1)
#pragma unroll
    for (int n = 0; n < kNk; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? ra : rb;
        const int i = q0 + r, j = k0 + 8 * n + 2 * t + (e & 1);
        const bool seen = i < Sq && j < Skv && !(causal && j > i);
        const float p = seen ? expf(s[n][e] * scale - lse_s[r]) : 0.f;
        const float dpv = probs_bf16 ? round_bf16(dp[n][e]) : dp[n][e];
        dp[n][e] = p * (dpv - d_s[r]);
      }
    }
#pragma unroll
    for (int ks2 = 0; ks2 < kStep / 16; ++ks2) {
      uint32_t s_hi[4], s_lo[4];
      a_frags<kNk>(dp, ks2, s_hi, s_lo);
#pragma unroll
      for (int n = 0; n < kNd; ++n) {
        const bf16* pk = kts + (8 * n + g) * kLdt + 16 * ks2 + 2 * t;
        const uint32_t b0 = ld32(pk), b1 = ld32(pk + 8);
        mma(dq_acc[n], s_lo, b0, b1);
        mma(dq_acc[n], s_hi, b0, b1);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + (half ? rb : ra);
    if (i >= Sq) continue;
    const size_t row = ((static_cast<size_t>(b) * Sq + i) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < kNd; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dq + row + 8 * n + 2 * t) = __floats2bfloat162_rn(
          dq_acc[n][2 * half] * scale, dq_acc[n][2 * half + 1] * scale);
  }
  if (part != nullptr) sum_groups<bf16, HD>(part, dk, dv, H, KV, Skv, scale, probs_bf16);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* D, void* dq, void* dk, void* dv, float* part, int B,
                   int H, int KV, int Sq, int Skv, int causal, int probs_bf16,
                   cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fd = static_cast<float*>(D);
  const long long rows = static_cast<long long>(B) * Sq * H;
  if (rows > 0) {
    const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    dot_rows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(o), tdo, fd, rows, Sq, H, HD);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int kv_smem = dkdv_mma_bytes<HD>();
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
    if (err != cudaSuccess) return err;
    dkdv_mma_kernel<HD><<<dim3(B * H, (Skv + kRows - 1) / kRows), kMmaThreads, kv_smem,
                          stream>>>(tq, tk, tv, tdo, flse, fd, static_cast<T*>(dk),
                                    static_cast<T*>(dv), part, H, KV, Sq, Skv, scale, causal,
                                    probs_bf16);
    err = cudaGetLastError();
    if (err != cudaSuccess || Sq == 0) return err;
    constexpr int q_smem = dq_mma_bytes<HD>();
    err = cudaFuncSetAttribute(dq_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_smem);
    if (err != cudaSuccess) return err;
    dq_mma_kernel<HD><<<dim3(B * H, (Sq + kRows - 1) / kRows), kMmaThreads, q_smem, stream>>>(
        tq, tk, tv, tdo, flse, fd, static_cast<T*>(dq), part, static_cast<T*>(dk),
        static_cast<T*>(dv), H, KV, Sq, Skv, scale, causal, probs_bf16);
    return cudaGetLastError();
  } else {
    constexpr int kv_smem = smem_bytes<HD>(2);
    cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
    if (err != cudaSuccess) return err;
    dkdv_kernel<HD><<<dim3(B * H, (Skv + kTile - 1) / kTile), kThreads, kv_smem, stream>>>(
        tq, tk, tv, tdo, flse, fd, static_cast<T*>(dk), static_cast<T*>(dv), part, H, KV, Sq,
        Skv, scale, causal, probs_bf16);
    err = cudaGetLastError();
    if (err != cudaSuccess || Sq == 0) return err;
    constexpr int q_smem = smem_bytes<HD>(1);
    err = cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_smem);
    if (err != cudaSuccess) return err;
    dq_kernel<HD><<<dim3(B * H, (Sq + kTile - 1) / kTile), kThreads, q_smem, stream>>>(
        tq, tk, tv, tdo, flse, fd, static_cast<T*>(dq), part, static_cast<T*>(dk),
        static_cast<T*>(dv), H, KV, Sq, Skv, scale, causal, probs_bf16);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
                      float* part, int B, int H, int KV, int Sq, int Skv, int causal,
                      int probs_bf16, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, lse, D, dq, dk, dv, part, B, H, KV, Sq, Skv, causal,
                           probs_bf16, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, D, dq, dk, dv, part, B, H, KV, Sq, Skv, causal,
                           probs_bf16, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, part, B, H, KV, Sq, Skv, causal,
                           probs_bf16, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, D, dq, dk, dv, part, B, H, KV, Sq, Skv,
                            causal, probs_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out, dout (B, Sq, H, hd) and k, v (B, Skv, KV, hd), float32 (bf16 0)
// or bfloat16 (bf16 1); lse (B, H, Sq) float32 from the forward; D (B, H,
// Sq) float32 scratch; part float32 scratch of 2 * B * Skv * H * hd when
// H > KV and Sq > 0 (the per-head partial sums of dK and dV), else
// nullptr; dq, dk, dv in the inputs' dtype and shapes.  Returns the
// launches' CUDA error (0: none).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* D, void* part,
                                   void* dq, void* dk, void* dv, int B, int H, int KV, int Sq,
                                   int Skv, int hd, int causal, int probs_bf16, int bf16,
                                   int device, void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || H <= 0 || Skv <= 0 || Sq < 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((part == nullptr) != (H == KV || Sq == 0)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fpart = static_cast<float*>(part);
  const cudaError_t err =
      bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, D, dq, dk, dv, fpart, B, H, KV,
                                      Sq, Skv, causal, probs_bf16, s)
           : launch_hd<float>(hd, q, k, v, o, dout, lse, D, dq, dk, dv, fpart, B, H, KV, Sq, Skv,
                              causal, probs_bf16, s);
  return static_cast<int>(err);
}
