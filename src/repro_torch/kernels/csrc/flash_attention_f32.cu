// Flash attention (forward) in float32 on Hopper's tensor cores, at f32
// precision from split bf16 operands.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas and its model-layout wrapper flash_attention)
// for float32 inputs; bfloat16 inputs go to csrc/flash_attention_tc.cu,
// whose design this kernel shares.  q (B, Sq, H, hd) and k, v (B, Skv,
// KV, hd) float32 in the model's own layout, out (B, Sq, H, hd) float32.
// Query head h reads KV head h / (H / KV): KV heads are indexed, never
// expanded.  Causal masking is top-left aligned (query i sees keys 0..i).
//
// The scheme (bf16 x 3).  A pre-pass splits every f32 element of q, k and
// v into three bf16 parts, x = x0 + x1 + x2 with x0 = bf16(x), x1 =
// bf16(x - x0), x2 = bf16(x - x0 - x1), each rounded to nearest.  Both
// remainders are exact in f32, and x2 holds the last at most 8 significant
// bits of x exactly, so the three parts carry all 24 bits of x (bf16 has
// f32's exponent range).  A product of two bf16 values is exact in f32.
// Each matrix product sums, into one f32 accumulator on the tensor cores,
// the six partial products whose part indices add up to at most 2,
// smallest first:
//   S   = Q0 K2 + Q1 K1 + Q2 K0 + Q0 K1 + Q1 K0 + Q0 K0,
// and, after the softmax splits each probability the same way in
// registers (p = p0 + p1 + p2),
//   O_t = P0 V2 + P1 V1 + P2 V0 + P0 V1 + P1 V0 + P0 V0
// for each key tile t, in an accumulator of its own.
//
// Error analysis.  Each part is at most 2^-9 of the one before it, so the
// three dropped products (indices adding up to 3 or 4) are below 2^-27 of
// |x| |y|, under f32's own rounding (2^-24).  What is left is the
// rounding of the sums.  The small products go in first, so they add up
// at their own scale before Q0 K0 (or P0 V0) joins them.  O_t starts from
// zero in every tile and joins the running output in one f32 FMA with the
// rescale, acc = acc * alpha + O_t, so the long running sum never passes
// through the tensor cores' adder.  The softmax is that of
// flash_attention_tc.cu: exp as ex2.approx of fma(s, log2 e, -m log2 e)
// (relative error near 2^-22), masked scores -1e30, p = 0 where m_new <=
// -5e29 and alpha = 0 where m_prev <= -5e29; out = acc / max(l, 1e-30) by
// IEEE division; the scale 1/sqrt(hd) rounded from double.  On request
// (lse != nullptr) each row's log-sum-exp goes out as in
// flash_attention_tc.cu, for the backward.  probs_bf16 (the model's
// probs_dtype bfloat16) rounds P and V to bf16 once before P V, as the
// plain version does: the pre-pass writes V's parts 1 and 2 as zeros and
// the softmax P's, so every partial product but P0 V0 is exactly 0; and
// as in flash_attention_tc.cu a first sweep over the K tiles finds each
// row's max, so that P is rounded at its row's final max.  The CPU
// emulation of the scheme in tests/test_torch_attention.py (_f32_scheme:
// the same parts, dropped products, tiles and order) stays within 8.4e-7
// of the Pallas kernel on its four cases, against the 2e-5 gate; the same
// arithmetic on operands rounded to bf16 once is 3.4e-3 to 1.2e-2 from it.
//
// What bounds it: operations.  The function's useful work is 4 * hd flops
// per visible (query, key) pair (1.7 TFLOP at the serving shape: B 4, S
// 10,240, H 16 over 2 KV heads, hd 128, causal); on the CUDA cores'
// f32 FMA rate that is 25.7 ms.  The split does it as 6 bf16 products
// per matrix product, 24 * hd tensor-core flops per pair, which at the
// 989 TFLOP/s bf16 rate is 10.4 ms: that is this kernel's floor.  The
// pre-pass moves 10 bytes per element of q, k and v (read f32, write three
// bf16 parts), about 0.3 ms at that shape.
//
// Design: flash_attention_tc.cu's, on parts.  The pre-pass writes each
// split tensor as (3, B, S, heads, hd) bf16, read through a 4-D tensor map
// (hd, heads, seq, 3 B) whose batch coordinate is part * B + b.  One CTA of
// three warpgroups takes 128 query rows of one (batch, head).  Warpgroup 0
// is the producer: one thread issues TMA loads of the three parts of the
// Q tile (once) and of each kBK-key K and V tile into two-stage rings,
// tracked by mbarriers, and gives its registers away (setmaxnreg 24).
// Three parts of 128 query rows take 96 KB of shared memory at hd 128, so
// there a key tile is 32 keys (K and V parts 48 KB per stage, 193 KB in
// all); at hd 64 and below it is 64 keys.  Warpgroups 1 and 2 are
// consumers of 64 rows each (setmaxnreg 240): S by wgmma with both
// operands from shared memory (K-major), the softmax on the accumulator
// registers, P's parts as register A fragments (the accumulator layout of
// S is the A-fragment layout of P V) against V's parts in MN-major layout
// (wgmma's transpose bit).  Each consumer issues S(t) together with
// O(t-1) = P(t-1) V(t-1) and runs the softmax of tile t while they are in
// flight; the two consumers take turns to issue (named barriers).  TMA
// zero-fills rows past the end, keys >= Skv are masked and rows >= Sq are
// not stored; causal CTAs never load tiles above the diagonal; the
// heaviest query tiles launch first.
#include "hopper.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBQ = 128;          // query rows per CTA: two consumer warpgroups of 64
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // producer warpgroup + two consumers
// kParts bf16 parts of every operand and kTerms partial products per
// matrix product (term_a, term_b): hopper.cuh.

// The tiles of one head dimension, each in kParts bf16 parts in the
// swizzle layout of Swizzle<HD>: Q (kBQ rows) and the K and V tiles (kBK
// rows each).
template <int HD>
struct Tile : Swizzle<HD> {
  static constexpr int kBK = HD == 128 ? 32 : 64;  // keys per tile
  static constexpr int kQPart = kBQ * HD * 2;
  static constexpr int kKVPart = kBK * HD * 2;
  static constexpr int kQBytes = kParts * kQPart;
  static constexpr int kKVBytes = kParts * kKVPart;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // 1024 bytes of slack to align the base for the swizzle, then the tiles
  // and the barriers (Q, then full K, full V, empty K and empty V per stage)
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 4 * kStages);
};

// Issues S (64 x kBK) = the six partial products of Q K^T for the
// warpgroup's 64 rows of the Q tile at q_rows and the K tile at k_tile
// (part 0 of each): hd / 16 steps of 16 columns per product.
template <int HD>
__device__ __forceinline__ void scores(float (&sc)[Tile<HD>::kBK / 2], uint32_t q_rows,
                                       uint32_t k_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int chunk = kk * 16 / T::kAtomCols;
      const uint32_t off = (kk * 16 % T::kAtomCols) * 2;
      const uint64_t da = smem_desc(q_rows + term_a(t) * T::kQPart + chunk * kBQ * T::kSwizzle + off,
                                    16, 8 * T::kSwizzle, T::kLayout);
      const uint64_t db = smem_desc(
          k_tile + term_b(t) * T::kKVPart + chunk * T::kBK * T::kSwizzle + off, 16,
          8 * T::kSwizzle, T::kLayout);
      wgmma_ss(sc, da, db, t > 0 || kk > 0);
    }
  }
}

// Issues o (64 x HD) = the six partial products of P V for the V tile at
// v_tile (part 0, MN-major), from zero: kBK / 16 steps of 16 keys per
// product.
template <int HD>
__device__ __forceinline__ void values(float (&o)[HD / 2],
                                       uint32_t (&p)[kParts][Tile<HD>::kBK / 16][4],
                                       uint32_t v_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {
#pragma unroll
    for (int kk = 0; kk < T::kBK / 16; ++kk) {
      const uint64_t dv = smem_desc(v_tile + term_b(t) * T::kKVPart + kk * 16 * T::kSwizzle,
                                    T::kBK * T::kSwizzle, 8 * T::kSwizzle, T::kLayout);
      wgmma_rs(o, p[term_a(t)][kk], dv, t > 0 || kk > 0);
    }
  }
}

// acc = acc * alpha + o, alpha of each accumulator row (one f32 FMA).
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N], const float (&o)[N], float alpha_a,
                                           float alpha_b) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = fmaf(acc[i], (i & 2) ? alpha_b : alpha_a, o[i]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, float* __restrict__ o,
                 float* __restrict__ lse, int B, int H, int KV, int Sq, int Skv, float scale,
                 int causal, int probs_bf16) {
  using T = Tile<HD>;
  constexpr int kBK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t k_tiles = base + T::kQBytes;
  const uint32_t v_tiles = k_tiles + kStages * T::kKVBytes;
  const uint32_t bar_q = base + T::kBarOffset;
  const uint32_t full_k = bar_q + 8;                  // per stage: K tile landed
  const uint32_t full_v = full_k + 8 * kStages;       // V tile landed
  const uint32_t empty_k = full_v + 8 * kStages;      // both consumers done with the K tile
  const uint32_t empty_v = empty_k + 8 * kStages;     // ... with the V tile

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest causal tiles first
  const int k_end = causal ? min(Skv, q0 + kBQ) : Skv;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2 * 128);  // every consumer thread arrives
      mbar_init(empty_v + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the two rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
      for (int j = 0; j < kParts; ++j) {
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(q_tile + j * T::kQPart + c * kBQ * T::kSwizzle, &qmap, bar_q,
                   c * T::kAtomCols, h, q0, j * B + b);
      }
      // With probs_bf16 the K ring first carries every K tile once for the
      // consumers' max sweep (K load c is tile c), then the tiles again
      // beside V (K load n_pre + t is tile t).
      const int n_pre = probs_bf16 ? n_tiles : 0;
      for (int c = 0; c < n_pre + n_tiles; ++c) {
        const int ks = c % kStages;
        const int kt = c < n_pre ? c : c - n_pre;
        mbar_wait(empty_k + 8 * ks, ((c / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full_k + 8 * ks, T::kKVBytes);
#pragma unroll
        for (int j = 0; j < kParts; ++j) {
#pragma unroll
          for (int c2 = 0; c2 < T::kChunks; ++c2)
            tma_load(k_tiles + ks * T::kKVBytes + j * T::kKVPart + c2 * kBK * T::kSwizzle, &kmap,
                     full_k + 8 * ks, c2 * T::kAtomCols, kvh, kt * kBK, j * B + b);
        }
        if (c < n_pre) continue;
        const int t = c - n_pre;
        const int s = t % kStages;
        mbar_wait(empty_v + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full_v + 8 * s, T::kKVBytes);
#pragma unroll
        for (int j = 0; j < kParts; ++j) {
#pragma unroll
          for (int c2 = 0; c2 < T::kChunks; ++c2)
            tma_load(v_tiles + s * T::kKVBytes + j * T::kKVPart + c2 * kBK * T::kSwizzle, &vmap,
                     full_v + 8 * s, c2 * T::kAtomCols, kvh, t * kBK, j * B + b);
        }
      }
    }
  } else {
    // consumer warpgroups: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    Rows rows;
    rows.qrow0 = q0 + wg * 64;
    rows.qa = rows.qrow0 + warp * 16 + lane / 4;
    rows.col0 = 2 * (lane % 4);
    const uint32_t q_rows = q_tile + wg * 64 * T::kSwizzle;

    float acc[HD / 2];   // the running output
    float ot[HD / 2];    // O of one key tile
    float sc[kBK / 2];
    // P of the last softmax as A fragments, in three parts (hopper.cuh's
    // split_frags; parts 1 and 2 are 0 with probs_bf16)
    uint32_t p[kParts][kBK / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      acc[i] = 0.f;
      ot[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    Softmax<kBK> sm;

    // The two consumers take turns to issue their products (named barrier
    // 1 + wg is this one's turn, 2 - wg the other's), so that one's softmax
    // runs while the other's products keep the tensor cores busy.
    // Consumer 0 goes first.  Step 0 issues S(0); step t in 1..n-1 issues
    // S(t) and O(t-1) = P(t-1) V(t-1), and runs the softmax of tile t while
    // they are in flight; step n issues O(n-1).  acc takes O(t-1) with the
    // rescale of tile t-1: acc = acc * alpha(t-1) + O(t-1).
    mbar_wait(bar_q, 0);
    // probs_bf16: a first sweep over the K tiles finds each row's max (both
    // consumers at once, no turns), so that the main sweep forms every P,
    // and rounds it to bf16, at its row's final max, as the plain version
    // does over one key chunk.  The main sweep's K loads follow on the
    // ring: load n_pre + t is tile t.
    const int n_pre = probs_bf16 ? n_tiles : 0;
    for (int t = 0; t < n_pre; ++t) {
      const int s = t % kStages;
      mbar_wait(full_k + 8 * s, (t / kStages) & 1);
      wgmma_fence();
      scores<HD>(sc, q_rows, k_tiles + s * T::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k + 8 * s);
      sm.observe(sc, rows, t * kBK, Skv, scale, causal);
    }
    if (n_tiles > 0) {
      const int ks = n_pre % kStages;
      if (wg == 0) named_arrive(1);
      named_sync(1 + wg);
      mbar_wait(full_k + 8 * ks, (n_pre / kStages) & 1);
      wgmma_fence();
      scores<HD>(sc, q_rows, k_tiles + ks * T::kKVBytes);
      wgmma_commit();
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k + 8 * ks);
      sm.update(sc, rows, 0, Skv, scale, causal);  // alpha(0) is 0: acc starts from O(0)
      split_frags<kParts, kBK>(sc, p, probs_bf16 ? 1 : kParts);
    }
    for (int t = 1; t < n_tiles; ++t) {
      const int ks = (n_pre + t) % kStages;
      const int sp = (t - 1) % kStages;
      named_sync(1 + wg);
      mbar_wait(full_k + 8 * ks, ((n_pre + t) / kStages) & 1);
      mbar_wait(full_v + 8 * sp, ((t - 1) / kStages) & 1);
      wgmma_fence();
      scores<HD>(sc, q_rows, k_tiles + ks * T::kKVBytes);
      wgmma_commit();
      values<HD>(ot, p, v_tiles + sp * T::kKVBytes);
      wgmma_commit();
      named_arrive(2 - wg);
      const float alpha_a = sm.alpha_a, alpha_b = sm.alpha_b;  // of tile t - 1
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(empty_k + 8 * ks);
      sm.update(sc, rows, t * kBK, Skv, scale, causal);
      wgmma_wait<0>();
      fence_regs(ot);
      fence_parts<kParts, kBK>(p);
      mbar_arrive(empty_v + 8 * sp);
      accumulate(acc, ot, alpha_a, alpha_b);
      split_frags<kParts, kBK>(sc, p, probs_bf16 ? 1 : kParts);
    }
    if (n_tiles > 0) {
      const int sp = (n_tiles - 1) % kStages;
      named_sync(1 + wg);
      mbar_wait(full_v + 8 * sp, ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      values<HD>(ot, p, v_tiles + sp * T::kKVBytes);
      wgmma_commit();
      if (wg == 0) named_arrive(2);  // consumer 1's last turn hands over nothing
      wgmma_wait<0>();
      fence_regs(ot);
      fence_parts<kParts, kBK>(p);
      mbar_arrive(empty_v + 8 * sp);
      accumulate(acc, ot, sm.alpha_a, sm.alpha_b);
    }

    const int qa = rows.qa;
    const int qb = qa + 8;
    const int col0 = rows.col0;
    const float den_a = fmaxf(sm.l_a, 1e-30f);
    const float den_b = fmaxf(sm.l_b, 1e-30f);
    const size_t row_stride = static_cast<size_t>(H) * HD;
    float* ob = o + static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + col0;
      if (qa < Sq)
        *reinterpret_cast<float2*>(ob + qa * row_stride + col) =
            make_float2(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
      if (qb < Sq)
        *reinterpret_cast<float2*>(ob + qb * row_stride + col) =
            make_float2(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
    if (lse != nullptr && col0 == 0) store_lse(lse, sm, b, h, H, Sq, qa);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* qs, void* ks, void* vs,
                   void* o, float* lse, int B, int H, int KV, int Sq, int Skv, int causal,
                   int probs_bf16, cudaStream_t stream) {
  using T = Tile<HD>;
  const long long nq4 = static_cast<long long>(B) * Sq * H * HD / 4;
  const long long nkv4 = static_cast<long long>(B) * Skv * KV * HD / 4;
  SplitJobs jobs = {};
  jobs.job[0] = {static_cast<const float4*>(q), static_cast<uint2*>(qs), nq4, kParts};
  jobs.job[1] = {static_cast<const float4*>(k), static_cast<uint2*>(ks), nkv4, kParts};
  jobs.job[2] = {static_cast<const float4*>(v), static_cast<uint2*>(vs), nkv4,
                 probs_bf16 ? 1 : kParts};
  cudaError_t err = split_all(jobs, 3, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<HD>(&qmap, qs, H, Sq, kParts * B, kBQ) ||
      !make_map<HD>(&kmap, ks, KV, Skv, kParts * B, T::kBK) ||
      !make_map<HD>(&vmap, vs, KV, Skv, kParts * B, T::kBK))
    return cudaErrorInvalidValue;
  constexpr int smem = T::kSmemBytes;
  err = cudaFuncSetAttribute(flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  flash_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<float*>(o), lse, B, H, KV, Sq, Skv, scale, causal,
      probs_bf16);
  return cudaGetLastError();
}

}  // namespace

// float32 q, k, v and out; qs, ks and vs are bf16 scratch of three times
// q's, k's and v's element counts, for their parts; lse (B, H, Sq)
// float32 or nullptr.  Returns the launches' CUDA error (0: none).
extern "C" int flash_attention_f32_fwd(const void* q, const void* k, const void* v, void* qs,
                                       void* ks, void* vs, void* o, void* lse, int B, int H,
                                       int KV, int Sq, int Skv, int hd, int causal,
                                       int probs_bf16, int device, void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0 || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      err = launch<16>(q, k, v, qs, ks, vs, o, static_cast<float*>(lse), B, H, KV, Sq, Skv,
                        causal, probs_bf16, s);
      break;
    case 32:
      err = launch<32>(q, k, v, qs, ks, vs, o, static_cast<float*>(lse), B, H, KV, Sq, Skv,
                        causal, probs_bf16, s);
      break;
    case 64:
      err = launch<64>(q, k, v, qs, ks, vs, o, static_cast<float*>(lse), B, H, KV, Sq, Skv,
                        causal, probs_bf16, s);
      break;
    case 128:
      err = launch<128>(q, k, v, qs, ks, vs, o, static_cast<float*>(lse), B, H, KV, Sq, Skv,
                        causal, probs_bf16, s);
      break;
    default: break;
  }
  return static_cast<int>(err);
}
