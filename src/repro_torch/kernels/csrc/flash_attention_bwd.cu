// Flash attention (backward) on Hopper's tensor cores: wgmma on tiles that
// TMA brings into mbarrier-tracked rings, in bfloat16 and in float32 from
// operands split into three bf16 parts.
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
// V as it is read, P where dV reads it, dP, and dV once summed.  P is
// ex2.approx of (s * scale - lse) * log2 e, computed with one FMA first.
//
// JAX counterpart: there is no Pallas backward kernel.  Above
// CHUNKED_THRESHOLD the JAX package trains through chunked_attention
// (src/repro/models/attention.py), and jax.value_and_grad gives XLA's
// gradient of that plain jnp code; this kernel replaces that gradient,
// as the hand-written forward kernels replace the forward.  Its plain
// version is kernels/ref.py flash_attention_bwd_ref.
//
// The numeric schemes.  bf16: q, k, v, dO are bf16; S and dP come from
// one bf16 product each; P and dS are split in registers into hi =
// bf16(x) and lo = bf16(x - hi) and both parts are multiplied (about 16
// bits, a relative error near 2^-17, far inside a bf16 gradient's ulp;
// rounding P and dS to bf16 once would not be the function the plain
// version computes); under probs_bf16 P's lo part is 0 and its products
// are skipped.  f32: a pre-pass splits q, k, v and dO into three bf16
// parts each (hopper.cuh's split_kernel; V's parts 1 and 2 are written as
// zeros under probs_bf16), P and dS are split into three parts in
// registers, and every product sums the six partial products whose part
// indices add up to at most 2, smallest first, as flash_attention_f32.cu
// does (the dropped products are below 2^-27 of |x| |y|).  The tensor
// cores' f32 adder truncates: left in the accumulator over a 10,240-token
// walk (3,840 accumulating wgmma steps), dK and dV came out biased toward
// zero by 5.3e-5 of their mean, 7e-5 of their max from the plain version
// (PERF.md, on the H100).  So in f32 the long sums over tiles (dK, dV, dQ)
// leave the accumulator every kFlushRows queries (keys): each thread adds
// its accumulator into an f32 running sum in global memory (dq, dk, dv
// themselves, or the GQA scratch) with round-to-nearest adds and zeroes
// it, so at most 96 steps pass through the tensor cores' adder, and no
// registers go to a second accumulator.  The CPU emulation of the scheme
// (tests/test_torch_flash_grad.py, the adder rounding toward zero) stays
// inside the card's f32 gate, and two parts would not.  bf16 keeps the
// sums in the accumulator: its outputs are rounded to bf16.
//
// Design: three launches (four in f32), no atomics, so two calls on the
// same inputs give the same bits.
//   (a) rows: lse and D = rowsum(dO * O) of every query row, one warp a
//       row, into f32 rows of (batch, head) padded to a multiple of 128
//       queries (lse +inf and D 0 past Sq, so padded rows have P = 0),
//       which the other launches read by bulk copy.  In f32 the split
//       pre-pass runs first.
//   (b) dK/dV: one CTA takes kKeys keys of one (batch, query head): one
//       producer warpgroup (setmaxnreg 24; one thread issues every copy)
//       and two consumer warpgroups.  K and V arrive once by TMA through
//       4-D tensor maps of the model layout (hd, heads, seq, batch; in f32
//       the batch coordinate is part * B + b).  A ring of kStages holds the
//       query tiles of kStep rows that see the key tile (causal: from the
//       diagonal on): Q, dO, lse and D, tracked by full and empty
//       mbarriers.  S^T = K Q^T and dP^T = V dO^T by wgmma from shared
//       memory, both operands K-major as the model layout stores them; P^T
//       and dS^T are formed on the accumulator registers and become
//       register A fragments (the accumulator layout of two 8-column
//       blocks is the A layout of one k-step), in parts; dV += P^T dO and
//       dK += dS^T Q by wgmma with the dO and Q tiles as MN-major B
//       (wgmma's transpose bit).  Where query heads share a KV head (GQA),
//       each CTA stores its head's sums in float32 scratch, so that no CTA
//       walks the whole group (one CTA per KV head would leave the first
//       causal key tile G times the walk of an average one).  The heaviest
//       key tiles (the first, under causal masking) launch first.
//   (c) dQ: one CTA takes kRows query rows of one (batch, head): Q, dO,
//       lse and D once, a ring of the K and V tiles of kStep keys that the
//       rows see; S = Q K^T and dP = dO V^T by wgmma from shared memory, dS
//       split into A fragments, dQ += dS K with K as MN-major B.  The
//       heaviest query tiles (the last, under causal masking) launch
//       first.  Then, under GQA, the consumer threads of all CTAs split the
//       (batch, key, KV head) rows of dK and dV and sum each over its
//       group's heads, in head order.
// The consumers.  bf16, and f32 below hd 128: each of the two takes 64 of
// the CTA's keys (rows).  bf16 issues S and dP of tile t together with the
// gradient products of tile t-1 and forms P and dS of tile t while the
// latter are in flight; the consumers take turns to issue (named
// barriers), as the forward kernels do.  f32 finishes each tile within
// its step (S and dP, P and dS, the gradient products; then the stage is
// free, so the two-stage rings load tile t+1 during all of step t): three
// parts of P and dS beside both accumulators and S and dP left no room
// for the bf16 overlap at hd 128 (255 registers and 4 KB of spills, 31 ms
// for dK/dV alone), and S and dP are zeroed just before their products, so
// that their registers are free between steps.  At hd 128 an f32 CTA has
// room for 64 keys (rows) only, and its two consumers share them: in (b)
// by roles (kRoles), one computing S^T, P^T and dV and handing P^T through
// shared memory (named barriers 1-4) to the other, which computes dP^T,
// dS^T and dK; in (c) by columns (kCols), each computing S, dP and dS of
// all 64 rows and half of dQ's columns.  Either way one consumer's
// elementwise work runs beside the other's products.  TMA zero-fills rows
// and keys past the end; keys >= Skv are masked, and rows >= Sq and keys
// >= Skv are never stored.
//
// Tiles and shared memory at hd 128 (a tile of R rows is R * 256 bytes per
// bf16 part).  bf16 (b): 128 keys, K and V 64 KB; a ring of 4 stages of 32
// query rows, Q and dO 16 KB a stage; 129 KB in all.  bf16 (c): 128 rows,
// Q and dO 64 KB; 3 stages of 64 keys, K and V 32 KB a stage; 161 KB.  f32
// (b): three parts of K and V at 128 keys would take 192 KB, so 64 keys,
// K and V 96 KB; 2 stages of 32 query rows, Q and dO 48 KB a stage; P^T
// handed over in 2 x 8 KB; 209 KB.  f32 (c): 64 rows, Q and dO 96 KB; 2
// stages of 32 keys, K and V 48 KB a stage; 193 KB.  Below hd 128 f32 (b)
// takes 32-row query tiles in 4 stages and (c) 64-key tiles in 2.  The
// register budget sets the ring tiles: a bf16 consumer holds dK and dV (hd
// floats), S and dP of one tile and the parts of P and dS of the previous
// one.
//
// What bounds it: operations.  The function's useful work is 10 * hd flops
// per visible (query, key) pair (five products of 2 * hd), at the 989
// TFLOP/s bf16 tensor-core rate.  (b) and (c) recompute S and dP, and P and
// dS go in two parts, so the bf16 kernel does 20 * hd on the tensor cores,
// twice the bound; the f32 kernel does six bf16 products for each of its
// seven products, 84 * hd (108 * hd at hd 128, where (c) forms S and dP
// twice), plus the pre-pass (10 bytes an element of q, k, v and dO).  The
// design keeps the tensor cores fed from shared memory that TMA fills
// ahead of them and runs the elementwise work beside products in flight.
#include "hopper.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;          // (b), (c): a producer and two consumer warpgroups
constexpr int kConsumerThreads = 256;  // the two consumers
constexpr int kRowThreads = 256;       // the rows launch: one warp a query row
constexpr int kRowPad = 128;           // lse and D rows are padded to a multiple of this
// f32: the rows (queries in dK/dV, keys in dQ) between two flushes of a
// gradient accumulator into its running sum
constexpr int kFlushRows = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x0 and x1 into p[0] and p[1] in the output dtype.
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// f32 running sums.  Row r (0 or 1) of a thread's accumulator fragment is
// the pairs acc[4j + 2r], acc[4j + 2r + 1] (j < HD / 8), whose running
// sums sit at p + 8j.  Both functions go through a row in groups of eight
// pairs: the group's loads in flight together (one memory round trip),
// then its adds and stores; the memory clobber keeps the compiler from
// gathering more loads at once, which would take another accumulator's
// worth of registers.  Adds are CUDA-core f32, round to nearest.
template <int HD>
constexpr int kSumGroup = HD / 8 < 8 ? HD / 8 : 8;

// The running sums plus the row: stored on the first flush, added after.
template <int HD>
__device__ __forceinline__ void flush_row(float* p, const float (&acc)[HD / 2], int r,
                                          bool first) {
  constexpr int kG = kSumGroup<HD>;
#pragma unroll
  for (int j0 = 0; j0 < HD / 8; j0 += kG) {
    float2 run[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j)
      run[j] = first ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(p + 8 * (j0 + j));
#pragma unroll
    for (int j = 0; j < kG; ++j)
      *reinterpret_cast<float2*>(p + 8 * (j0 + j)) = make_float2(
          run[j].x + acc[4 * (j0 + j) + 2 * r], run[j].y + acc[4 * (j0 + j) + 2 * r + 1]);
    asm volatile("" ::: "memory");
  }
}

// The row plus its running sums, in place (the last tiles' part).
template <int HD>
__device__ __forceinline__ void add_row(const float* p, float (&acc)[HD / 2], int r) {
  constexpr int kG = kSumGroup<HD>;
#pragma unroll
  for (int j0 = 0; j0 < HD / 8; j0 += kG) {
    float2 run[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) run[j] = *reinterpret_cast<const float2*>(p + 8 * (j0 + j));
#pragma unroll
    for (int j = 0; j < kG; ++j) {
      acc[4 * (j0 + j) + 2 * r] += run[j].x;
      acc[4 * (j0 + j) + 2 * r + 1] += run[j].y;
    }
    asm volatile("" ::: "memory");
  }
}

// The numeric scheme of an instantiation: kIn bf16 parts of every input
// tile (1: bf16 inputs; 3: the f32 split), kFrag parts of P and dS as A
// fragments.  A product of two input tiles (S, dP) sums kSsTerms partial
// products, a product of fragments and an input tile (dV, dK, dQ)
// kRsTerms, smallest first: part ss_a/rs_a of the left operand times part
// ss_b/rs_b of the right one.  bf16: S = Q K^T once; dV = P_lo^T dO +
// P_hi^T dO.  f32: hopper.cuh's six terms.
template <bool kF32>
struct Scheme {
  static constexpr int kIn = kF32 ? kParts : 1;
  static constexpr int kFrag = kF32 ? kParts : 2;
  static constexpr int kSsTerms = kF32 ? kTerms : 1;
  static constexpr int kRsTerms = kF32 ? kTerms : 2;
  __host__ __device__ static constexpr int ss_a(int t) { return kF32 ? term_a(t) : 0; }
  __host__ __device__ static constexpr int ss_b(int t) { return kF32 ? term_b(t) : 0; }
  __host__ __device__ static constexpr int rs_a(int t) { return kF32 ? term_a(t) : 1 - t; }
  __host__ __device__ static constexpr int rs_b(int t) { return kF32 ? term_b(t) : 0; }
};

// The dK/dV launch: two consumer warpgroups of 64 keys (kKeys keys a CTA;
// kRoles: both on the same keys), query tiles of kStep rows in a ring of
// kStages.  Shared memory: K and V (kIn parts of kKeys rows each), the
// ring's Q and dO tiles (kIn parts of kStep rows each), the ring's lse and
// D, the P^T hand-over (kRoles), then the barriers (K/V, then full and
// empty per stage).
template <bool kF32, int HD>
struct KvCfg : Swizzle<HD>, Scheme<kF32> {
  using S = Scheme<kF32>;
  // f32 at hd 128: three parts of K and V at 128 keys would take 192 KB,
  // so a CTA takes 64 keys, and its two consumers split the roles (dV; dK)
  static constexpr bool kRoles = kF32 && HD == 128;
  static constexpr int kKeys = kRoles ? 64 : 128;
  static constexpr int kStep = kF32 || HD == 128 ? 32 : 64;
  static constexpr int kStages = kF32 && HD == 128 ? 2 : 4;
  static constexpr int kFlush = kF32 ? kFlushRows / kStep : 0;  // tiles between flushes
  static constexpr int kTilePart = kKeys * HD * 2;  // one part of the K or V tile
  static constexpr int kStepPart = kStep * HD * 2;  // one part of a Q or dO tile
  static constexpr int kFixedBytes = 2 * S::kIn * kTilePart;
  static constexpr int kStageBytes = 2 * S::kIn * kStepPart;
  static constexpr int kRowsOffset = kFixedBytes + kStages * kStageBytes;
  static constexpr int kRowBytes = 2 * kStep * 4;  // lse and D of one stage
  // kRoles: P^T of a tile, handed from the dV consumer to the dK one, twice
  static constexpr int kPOffset = kRowsOffset + kStages * kRowBytes;
  static constexpr int kPBytes = kRoles ? 2 * 64 * kStep * 4 : 0;
  static constexpr int kBarOffset = kPOffset + kPBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

// The dQ launch: two consumer warpgroups of 64 query rows (kRows a CTA;
// kCols: both on the same rows, kOut columns of dQ each), key tiles of
// kStep keys in a ring of kStages.  Shared memory: Q and dO (kIn parts of
// kRows rows each), the ring's K and V tiles (kIn parts of kStep keys
// each), lse and D of the rows, then the barriers (Q, then full and empty
// per stage).
template <bool kF32, int HD>
struct QCfg : Swizzle<HD>, Scheme<kF32> {
  using S = Scheme<kF32>;
  // f32 at hd 128: three parts of Q and dO at 128 rows would take 192 KB,
  // so a CTA takes 64 rows, and each of its two consumers computes S, dP
  // and dS of all of them and half of dQ's columns
  static constexpr bool kCols = kF32 && HD == 128;
  static constexpr int kRows = kCols ? 64 : 128;
  static constexpr int kOut = kCols ? HD / 2 : HD;  // dQ columns a consumer computes
  static constexpr int kStep = kF32 && HD == 128 ? 32 : 64;
  static constexpr int kStages = kF32 ? 2 : 3;
  static constexpr int kFlush = kF32 ? kFlushRows / kStep : 0;  // tiles between flushes
  static constexpr int kTilePart = kRows * HD * 2;  // one part of the Q or dO tile
  static constexpr int kStepPart = kStep * HD * 2;  // one part of a K or V tile
  static constexpr int kFixedBytes = 2 * S::kIn * kTilePart;
  static constexpr int kStageBytes = 2 * S::kIn * kStepPart;
  static constexpr int kRowsOffset = kFixedBytes + kStages * kStageBytes;
  static constexpr int kRowBytes = 2 * kRows * 4;  // lse and D of the rows
  static constexpr int kBarOffset = kRowsOffset + kRowBytes;
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 2 * kStages);
};

static_assert(KvCfg<true, 128>::kSmemBytes <= 232448 && QCfg<true, 128>::kSmemBytes <= 232448 &&
                  KvCfg<true, 64>::kSmemBytes <= 232448 && QCfg<true, 64>::kSmemBytes <= 232448 &&
                  KvCfg<false, 128>::kSmemBytes <= 232448 &&
                  QCfg<false, 128>::kSmemBytes <= 232448,
              "a CTA's shared memory exceeds 227 KB");

// acc (64 x N) = the sum of C's ss terms of A B^T: A the 64 rows at a (kIn
// parts a_part apart, column chunks a_chunk apart), B the N rows at bm
// (parts b_part apart, chunks N * kSwizzle apart), both K-major over HD.
// Terms whose left part is above 0 are skipped with drop_a, whose right
// part is with drop_b (those parts are 0).
template <class C, int HD, int N>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2], uint32_t a, int a_chunk,
                                           int a_part, uint32_t bm, int b_part, bool drop_a,
                                           bool drop_b) {
  // f32: a and bm opaque here, so that the 48 descriptors of a CTA-fixed
  // operand are formed at their use, not hoisted out of the walk into 96
  // registers
  if constexpr (C::kIn > 1) asm volatile("" : "+r"(a), "+r"(bm));
  int accumulate = 0;
#pragma unroll
  for (int t = 0; t < C::kSsTerms; ++t) {
    const int pa = C::ss_a(t), pb = C::ss_b(t);
    if ((drop_a && pa > 0) || (drop_b && pb > 0)) continue;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int chunk = kk * 16 / C::kAtomCols;
      const uint32_t off = (kk * 16 % C::kAtomCols) * 2;
      const uint64_t da = smem_desc(a + pa * a_part + chunk * a_chunk + off, 16,
                                    8 * C::kSwizzle, C::kLayout);
      const uint64_t db = smem_desc(bm + pb * b_part + chunk * N * C::kSwizzle + off, 16,
                                    8 * C::kSwizzle, C::kLayout);
      wgmma_ss(acc, da, db, accumulate);
      accumulate = 1;
    }
  }
}

// acc (64 x NOUT) += the sum of C's rs terms of F B: F the register A
// fragments (kFrag parts, N / 16 k-steps of 16 columns), B the N x NOUT
// tile at bm (parts b_part apart), MN-major.  Terms whose fragment part is
// above 0 are skipped with drop_a (those parts are 0).
template <class C, int NOUT, int N>
__device__ __forceinline__ void rs_product(float (&acc)[NOUT / 2],
                                           uint32_t (&f)[C::kFrag][N / 16][4], uint32_t bm,
                                           int b_part, bool drop_a) {
  if constexpr (C::kIn > 1) asm volatile("" : "+r"(bm));
#pragma unroll
  for (int t = 0; t < C::kRsTerms; ++t) {
    const int pa = C::rs_a(t), pb = C::rs_b(t);
    if (drop_a && pa > 0) continue;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint64_t db = smem_desc(bm + pb * b_part + kk * 16 * C::kSwizzle, N * C::kSwizzle,
                                    8 * C::kSwizzle, C::kLayout);
      wgmma_rs(acc, f[pa][kk], db);
    }
  }
}

// P^T and (kDs) dS^T of one tile in place of S^T and dP^T (64 keys x N
// queries):
// st[4j + e] is key key_a (+8 where e & 2), query q0 + 8j + col0 + (e & 1);
// lse_s and d_s hold the tile's N queries.
template <int N, bool kDs>
__device__ __forceinline__ void probs_t(float (&st)[N / 2], float (&dpt)[N / 2],
                                        const float* lse_s, const float* d_s, int key_a, int q0,
                                        int col0, bool mask, int Skv, int causal, float scale,
                                        int probs_bf16) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
    const float2 d = *reinterpret_cast<const float2*>(d_s + 8 * j + col0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float x = fmaf(st[i], scale, -((e & 1) ? l.y : l.x));
      if (mask) {
        const int key = key_a + ((e & 2) ? 8 : 0);
        const int query = q0 + 8 * j + col0 + (e & 1);
        if (key >= Skv || (causal && key > query)) x = -INFINITY;
      }
      const float p = ex2(x * kLog2e);
      if constexpr (kDs) {
        const float dp = probs_bf16 ? round_bf16(dpt[i]) : dpt[i];
        dpt[i] = p * (dp - ((e & 1) ? d.y : d.x));
      }
      st[i] = p;
    }
  }
}

// dS of one tile in place of dP (64 rows x N keys): s[4j + e] is row qa
// (+8 where e & 2, with lse and D of *_b), key k0 + 8j + col0 + (e & 1).
template <int N>
__device__ __forceinline__ void probs(const float (&s)[N / 2], float (&dp)[N / 2], float lse_a,
                                      float lse_b, float d_a, float d_b, int qa, int k0,
                                      int col0, bool mask, int Skv, int causal, float scale,
                                      int probs_bf16) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float x = fmaf(s[i], scale, -((e & 2) ? lse_b : lse_a));
      if (mask) {
        const int row = qa + ((e & 2) ? 8 : 0);
        const int key = k0 + 8 * j + col0 + (e & 1);
        if (key >= Skv || (causal && key > row)) x = -INFINITY;
      }
      const float p = ex2(x * kLog2e);
      const float dpv = probs_bf16 ? round_bf16(dp[i]) : dp[i];
      dp[i] = p * (dpv - ((e & 2) ? d_b : d_a));
    }
  }
}

// lse and D of every (batch, head, query) slot into rows, (2, B * H,
// sq_pad) float32: one warp a slot; D = rowsum(dO * O) of the model-layout
// row; slots past Sq take lse +inf and D 0.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
            float* __restrict__ rows, long long slots, int Sq, int sq_pad, int H, int hd) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * (kRowThreads / 32) + threadIdx.x / 32;
  if (slot >= slots) return;
  const int lane = threadIdx.x % 32;
  const long long bh = slot / sq_pad;
  const int i = static_cast<int>(slot % sq_pad);
  if (i >= Sq) {
    if (lane == 0) {
      rows[slot] = INFINITY;
      rows[slots + slot] = 0.f;
    }
    return;
  }
  const long long row = ((bh / H * Sq + i) * H + bh % H) * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f32(o[row + d]), to_f32(dout[row + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    rows[slot] = lse[bh * Sq + i];
    rows[slots + slot] = acc;
  }
}

// dK and dV of kKeys keys of (b, query head h); with part != nullptr (GQA)
// the head's float32 sums go to part, (2, B, Skv, H, HD), for sum_groups.
template <bool kF32, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
            const float* __restrict__ rows, std::conditional_t<kF32, float, bf16>* __restrict__ dk,
            std::conditional_t<kF32, float, bf16>* __restrict__ dv, float* __restrict__ part,
            int B, int H, int KV, int Sq, int Skv, int sq_pad, float scale, int causal,
            int probs_bf16) {
  using C = KvCfg<kF32, HD>;
  constexpr int kStep = C::kStep;
  constexpr int kStages = C::kStages;
  constexpr int kFrag = C::kFrag;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_tile = base;
  const uint32_t v_tile = base + C::kIn * C::kTilePart;
  const uint32_t ring = base + C::kFixedBytes;      // stage s: Q parts, then dO parts
  const uint32_t row_vals = base + C::kRowsOffset;  // stage s: lse, then D
  const uint32_t bar_kv = base + C::kBarOffset;
  const uint32_t full = bar_kv + 8;
  const uint32_t empty = full + 8 * kStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int k0 = blockIdx.y * C::kKeys;  // the heaviest causal tiles (the first keys) first
  const int first = causal ? k0 / kStep : 0;  // the first query tile that sees key k0
  const int n_tiles = max(0, (Sq + kStep - 1) / kStep - first);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, C::kFixedBytes);
#pragma unroll
      for (int j = 0; j < C::kIn; ++j) {
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const uint32_t off = j * C::kTilePart + c * C::kKeys * C::kSwizzle;
          tma_load(k_tile + off, &kmap, bar_kv, c * C::kAtomCols, kvh, k0, j * B + b);
          tma_load(v_tile + off, &vmap, bar_kv, c * C::kAtomCols, kvh, k0, j * B + b);
        }
      }
      const float* lse_row = rows + (static_cast<size_t>(b) * H + h) * sq_pad;
      const float* d_row = lse_row + static_cast<size_t>(B) * H * sq_pad;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int q0 = (first + t) * kStep;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full + 8 * s, C::kStageBytes + C::kRowBytes);
        const uint32_t st = ring + s * C::kStageBytes;
#pragma unroll
        for (int j = 0; j < C::kIn; ++j) {
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            const uint32_t off = j * C::kStepPart + c * kStep * C::kSwizzle;
            tma_load(st + off, &qmap, full + 8 * s, c * C::kAtomCols, h, q0, j * B + b);
            tma_load(st + C::kIn * C::kStepPart + off, &omap, full + 8 * s, c * C::kAtomCols, h,
                     q0, j * B + b);
          }
        }
        const uint32_t rv = row_vals + s * C::kRowBytes;
        bulk_load(rv, lse_row + q0, kStep * 4, full + 8 * s);
        bulk_load(rv + kStep * 4, d_row + q0, kStep * 4, full + 8 * s);
      }
    }
  } else {
    // consumer warpgroups: 64 keys each, or (kRoles) both on the same 64
    // keys, consumer 0 computing dV and consumer 1 dK
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int kw0 = k0 + (C::kRoles ? 0 : wg * 64);
    const int key_a = kw0 + warp * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t k_rows = k_tile + (kw0 - k0) * C::kSwizzle;
    const uint32_t v_rows = v_tile + (kw0 - k0) * C::kSwizzle;
    const float* row_f = reinterpret_cast<const float*>(smem_raw + (row_vals - raw));
    const bool drop = probs_bf16 != 0;

    float dk_acc[HD / 2], dv_acc[HD / 2];
    float st[kStep / 2], dpt[kStep / 2];
    // P^T and dS^T as A fragments, in parts
    uint32_t pf[kFrag][kStep / 16][4], sf[kFrag][kStep / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kStep / 2; ++i) st[i] = dpt[i] = 0.f;

    // S^T = K Q^T into st, dP^T = V dO^T into dpt, of the tile in stage s
    auto issue_s = [&](int s) {
      ss_product<C, HD, kStep>(st, k_rows, C::kKeys * C::kSwizzle, C::kTilePart,
                               ring + s * C::kStageBytes, C::kStepPart, false, false);
    };
    auto issue_dp = [&](int s) {
      ss_product<C, HD, kStep>(dpt, v_rows, C::kKeys * C::kSwizzle, C::kTilePart,
                               ring + s * C::kStageBytes + C::kIn * C::kStepPart, C::kStepPart,
                               drop, false);
    };
    // dV += P^T dO and dK += dS^T Q of the tile in stage s
    auto issue_dv = [&](int s) {
      rs_product<C, HD, kStep>(dv_acc, pf, ring + s * C::kStageBytes + C::kIn * C::kStepPart,
                               C::kStepPart, drop);
    };
    auto issue_dk = [&](int s) {
      rs_product<C, HD, kStep>(dk_acc, sf, ring + s * C::kStageBytes, C::kStepPart, false);
    };
    // P^T (and, with ds, dS^T) of tile t (stage s) in place of S^T and dP^T
    auto form = [&](int t, int s, auto ds) {
      const int q0 = (first + t) * kStep;
      const bool mask = kw0 + 64 > Skv || (causal && kw0 + 63 > q0);
      const float* rv = row_f + s * 2 * kStep;
      probs_t<kStep, decltype(ds)::value>(st, dpt, rv, rv + kStep, key_a, q0, col0, mask, Skv,
                                          causal, scale, probs_bf16);
    };
    auto split_p = [&]() { split_frags<kFrag, kStep>(st, pf, drop ? 1 : kFrag); };
    auto split_ds = [&]() { split_frags<kFrag, kStep>(dpt, sf, kFrag); };
    // Without roles the consumers take turns to issue (named barrier 1 + wg
    // is this one's turn, 2 - wg the other's); consumer 0 goes first.
    auto turn = [&]() {
      if constexpr (!C::kRoles) named_sync(1 + wg);
    };
    auto pass = [&]() {
      if constexpr (!C::kRoles) named_arrive(2 - wg);
    };
    // f32: the running sums of this thread's dK and dV entries, in the
    // GQA scratch or (one query head a KV head) in dk and dv themselves
    const size_t half = static_cast<size_t>(B) * Skv * H * HD;
    auto sum_at = [&](int r, bool v_sum) -> float* {
      const int key = key_a + 8 * r;
      if (part != nullptr)
        return part + (v_sum ? half : 0) + ((static_cast<size_t>(b) * Skv + key) * H + h) * HD;
      float* out = reinterpret_cast<float*>(v_sum ? dv : dk);
      return out + ((static_cast<size_t>(b) * Skv + key) * KV + kvh) * HD;
    };
    // adds dK (with_k) and dV (with_v) of the tiles so far into the running
    // sums and zeroes them
    auto flush = [&](bool first_flush, bool with_k, bool with_v) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key_a + 8 * r >= Skv) continue;
        if (with_k) flush_row<HD>(sum_at(r, false) + col0, dk_acc, r, first_flush);
        if (with_v) flush_row<HD>(sum_at(r, true) + col0, dv_acc, r, first_flush);
      }
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        if (with_k) dk_acc[i] = 0.f;
        if (with_v) dv_acc[i] = 0.f;
      }
    };
    // stores dK (with_k) and dV (with_v): dK times scale, dV rounded with
    // probs_bf16, or the raw sums into part; f32 adds the running sums
    auto finish = [&](bool with_k, bool with_v) {
      if constexpr (kF32) {
        if (n_tiles > C::kFlush) {  // the running sums of the flushes
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (key_a + 8 * r >= Skv) continue;
            if (with_k) add_row<HD>(sum_at(r, false) + col0, dk_acc, r);
            if (with_v) add_row<HD>(sum_at(r, true) + col0, dv_acc, r);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key_a + 8 * r;
        if (key >= Skv) continue;
        const size_t kv_row = ((static_cast<size_t>(b) * Skv + key) * KV + kvh) * HD;
        const size_t h_row = ((static_cast<size_t>(b) * Skv + key) * H + h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = 8 * j + col0;
          const float k0v = dk_acc[4 * j + 2 * r], k1v = dk_acc[4 * j + 2 * r + 1];
          const float v0v = dv_acc[4 * j + 2 * r], v1v = dv_acc[4 * j + 2 * r + 1];
          if (part == nullptr) {
            if (with_k) store2(dk + kv_row + col, k0v * scale, k1v * scale);
            if (with_v)
              store2(dv + kv_row + col, probs_bf16 ? round_bf16(v0v) : v0v,
                     probs_bf16 ? round_bf16(v1v) : v1v);
          } else {
            if (with_k) store2(part + h_row + col, k0v, k1v);
            if (with_v) store2(part + half + h_row + col, v0v, v1v);
          }
        }
      }
    };
    // kRoles: the dV consumer hands P^T of tile t to the dK consumer in
    // p_buf[t % 2] (element i of consumer thread T at i * 128 + T), behind
    // named barrier 1 + t % 2 (P^T there) and 3 + t % 2 (read, free again).
    float* p_buf = reinterpret_cast<float*>(smem_raw + (base + C::kPOffset - raw)) +
                   threadIdx.x % 128;
    // dS^T of tile t (stage s) in place of dP^T, from P^T in p (kRoles)
    auto form_ds = [&](int s, const float* p) {
      const float* d_s = row_f + s * 2 * kStep + kStep;
#pragma unroll
      for (int j = 0; j < kStep / 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(d_s + 8 * j + col0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float dp = probs_bf16 ? round_bf16(dpt[i]) : dpt[i];
          st[i] = p[i * 128];
          dpt[i] = st[i] * (dp - ((e & 1) ? d.y : d.x));
        }
      }
    };
    // f32: each step finishes its tile (S^T, and dP^T; P^T, and dS^T; dV,
    // and dK) and frees its stage, so the two-stage ring loads tile t+1
    // during all of step t, and no fragment outlives its step.  Role
    // kDV computes S^T, P^T and dV; kDK dP^T, dS^T (from kDV's P^T) and dK;
    // kBoth all of them.
    constexpr int kDV = 0, kDK = 1, kBoth = 2;
    auto walk_f32 = [&](auto role) {
      constexpr int R = decltype(role)::value;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        turn();
        mbar_wait(full + 8 * s, (t / kStages) & 1);
#pragma unroll
        for (int i = 0; i < kStep / 2; ++i) {  // ends their live range between steps
          if constexpr (R != kDK) st[i] = 0.f;
          if constexpr (R != kDV) dpt[i] = 0.f;
        }
        wgmma_fence();
        if constexpr (R != kDK) issue_s(s);
        if constexpr (R != kDV) issue_dp(s);
        wgmma_commit();
        if (!(wg == 1 && t == n_tiles - 1)) pass();  // the last turn hands over nothing
        wgmma_wait<0>();
        if constexpr (R != kDK) fence_regs(st);
        if constexpr (R != kDV) fence_regs(dpt);
        if constexpr (R == kDK) {
          named_sync(1 + t % 2);
          form_ds(s, p_buf + (t % 2) * 64 * kStep);
          if (t + 2 < n_tiles) named_arrive(3 + t % 2);
        } else {
          form(t, s, std::integral_constant<bool, R == kBoth>());
        }
        if constexpr (R == kDV) {
          if (t >= 2) named_sync(3 + t % 2);
          float* p = p_buf + (t % 2) * 64 * kStep;
#pragma unroll
          for (int i = 0; i < kStep / 2; ++i) p[i * 128] = st[i];
          named_arrive(1 + t % 2);
        }
        if constexpr (R != kDK) {
          split_p();
          wgmma_fence();
          issue_dv(s);
          wgmma_commit();
        }
        if constexpr (R != kDV) {
          split_ds();
          wgmma_fence();
          issue_dk(s);
          wgmma_commit();
        }
        wgmma_wait<0>();
        if constexpr (R != kDK) {
          fence_regs(dv_acc);
          fence_parts<kFrag, kStep>(pf);
        }
        if constexpr (R != kDV) {
          fence_regs(dk_acc);
          fence_parts<kFrag, kStep>(sf);
        }
        mbar_arrive(empty + 8 * s);
        if ((t + 1) % C::kFlush == 0 && t + 1 < n_tiles)
          flush(t + 1 == C::kFlush, R != kDV, R != kDK);
      }
      finish(R != kDV, R != kDK);
    };

    mbar_wait(bar_kv, 0);
    if constexpr (!C::kRoles) {
      if (n_tiles > 0 && wg == 0) named_arrive(1);
    }
    if constexpr (C::kRoles) {
      if (wg == 0) {
        walk_f32(std::integral_constant<int, kDV>());
      } else {
        walk_f32(std::integral_constant<int, kDK>());
      }
    } else if constexpr (kF32) {
      walk_f32(std::integral_constant<int, kBoth>());
    } else {
      // bf16: step 0 issues S^T(0) and dP^T(0); step t in 1..n-1 issues
      // those of tile t and the gradient products of tile t-1, and forms P^T
      // and dS^T of tile t while the latter are in flight; step n issues
      // those of tile n-1.
      auto split = [&]() {
        split_p();
        split_ds();
      };
      if (n_tiles > 0) {
        turn();
        mbar_wait(full, 0);
        wgmma_fence();
        issue_s(0);
        issue_dp(0);
        wgmma_commit();
        pass();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        form(0, 0, std::true_type());
        split();
      }
      for (int t = 1; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int sp = (t - 1) % kStages;
        turn();
        mbar_wait(full + 8 * s, (t / kStages) & 1);
        wgmma_fence();
        issue_s(s);
        issue_dp(s);
        wgmma_commit();
        issue_dv(sp);
        issue_dk(sp);
        wgmma_commit();
        pass();
        wgmma_wait<1>();
        fence_regs(st);
        fence_regs(dpt);
        form(t, s, std::true_type());
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_parts<kFrag, kStep>(pf);
        fence_parts<kFrag, kStep>(sf);
        mbar_arrive(empty + 8 * sp);
        split();
      }
      if (n_tiles > 0) {
        const int sp = (n_tiles - 1) % kStages;
        turn();
        wgmma_fence();
        issue_dv(sp);
        issue_dk(sp);
        wgmma_commit();
        if (wg == 0) named_arrive(2);  // consumer 1's last turn hands over nothing
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_parts<kFrag, kStep>(pf);
        fence_parts<kFrag, kStep>(sf);
        mbar_arrive(empty + 8 * sp);
      }
      finish(true, true);
    }
  }
}

// dK and dV from the partial sums of dkdv_kernel: each (b, key, KV head)
// row summed over the group's query heads in order (so the same bits every
// call), dK times scale, dV rounded to bf16 with probs_bf16.  The
// consumer threads (tid of n) of the dq launch's CTAs, which run after the
// dK/dV launch, split the B * Skv * KV rows evenly, after their own rows of
// dQ.
template <typename T, int HD>
__device__ void sum_groups(const float* __restrict__ part, T* __restrict__ dk,
                           T* __restrict__ dv, int B, int H, int KV, int Skv, float scale,
                           int probs_bf16, int tid, int n) {
  const int G = H / KV;
  const size_t rows = static_cast<size_t>(B) * Skv * KV;
  const size_t ctas = static_cast<size_t>(gridDim.x) * gridDim.y;
  const size_t cta = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const size_t per = (rows + ctas - 1) / ctas;
  const size_t r0 = cta * per < rows ? cta * per : rows;
  const size_t r1 = r0 + per < rows ? r0 + per : rows;
  const size_t half = static_cast<size_t>(B) * Skv * H * HD;
  for (size_t idx = r0 * HD + tid; idx < r1 * HD; idx += n) {
    const size_t r = idx / HD;
    const size_t src = ((r / KV) * H + (r % KV) * G) * HD + idx % HD;
    float sk = 0.f, sv = 0.f;
    for (int g = 0; g < G; ++g) {
      sk += part[src + g * HD];
      sv += part[half + src + g * HD];
    }
    const float dvv = probs_bf16 ? round_bf16(sv) : sv;
    if constexpr (std::is_same<T, float>::value) {
      dk[idx] = sk * scale;
      dv[idx] = dvv;
    } else {
      dk[idx] = __float2bfloat16_rn(sk * scale);
      dv[idx] = __float2bfloat16_rn(dvv);
    }
  }
}

// dQ of kRows query rows of (b, head h); then, with part != nullptr, this
// CTA's share of sum_groups.
template <bool kF32, int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
          const float* __restrict__ rows, std::conditional_t<kF32, float, bf16>* __restrict__ dq,
          const float* __restrict__ part, std::conditional_t<kF32, float, bf16>* __restrict__ dk,
          std::conditional_t<kF32, float, bf16>* __restrict__ dv, int B, int H, int KV, int Sq,
          int Skv, int sq_pad, float scale, int causal, int probs_bf16) {
  using C = QCfg<kF32, HD>;
  constexpr int kStep = C::kStep;
  constexpr int kStages = C::kStages;
  constexpr int kFrag = C::kFrag;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t o_tile = base + C::kIn * C::kTilePart;
  const uint32_t ring = base + C::kFixedBytes;      // stage s: K parts, then V parts
  const uint32_t row_vals = base + C::kRowsOffset;  // lse, then D of the rows
  const uint32_t bar_q = base + C::kBarOffset;
  const uint32_t full = bar_q + 8;
  const uint32_t empty = full + 8 * kStages;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;  // heaviest causal tiles first
  const int k_end = causal ? min(Skv, q0 + C::kRows) : Skv;
  const int n_tiles = (k_end + kStep - 1) / kStep;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kFixedBytes + C::kRowBytes);
#pragma unroll
      for (int j = 0; j < C::kIn; ++j) {
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const uint32_t off = j * C::kTilePart + c * C::kRows * C::kSwizzle;
          tma_load(q_tile + off, &qmap, bar_q, c * C::kAtomCols, h, q0, j * B + b);
          tma_load(o_tile + off, &omap, bar_q, c * C::kAtomCols, h, q0, j * B + b);
        }
      }
      const float* lse_row = rows + (static_cast<size_t>(b) * H + h) * sq_pad + q0;
      bulk_load(row_vals, lse_row, C::kRows * 4, bar_q);
      bulk_load(row_vals + C::kRows * 4, lse_row + static_cast<size_t>(B) * H * sq_pad,
                C::kRows * 4, bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty + 8 * s, ((t / kStages) & 1) ^ 1);  // the first round passes
        mbar_expect_tx(full + 8 * s, C::kStageBytes);
        const uint32_t st = ring + s * C::kStageBytes;
#pragma unroll
        for (int j = 0; j < C::kIn; ++j) {
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            const uint32_t off = j * C::kStepPart + c * kStep * C::kSwizzle;
            tma_load(st + off, &kmap, full + 8 * s, c * C::kAtomCols, kvh, t * kStep, j * B + b);
            tma_load(st + C::kIn * C::kStepPart + off, &vmap, full + 8 * s, c * C::kAtomCols,
                     kvh, t * kStep, j * B + b);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    constexpr int kOut = C::kOut;
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = C::kCols ? 0 : wg * 64;  // the consumer's first row in the tile
    const int qw0 = q0 + row0;
    const int ra = row0 + warp * 16 + lane / 4;  // the thread's rows in the tile: ra, ra + 8
    const int qa = q0 + ra;
    const int col0 = 2 * (lane % 4);  // the thread's first column in an 8-column block
    const int out0 = col0 + (C::kCols ? wg * kOut : 0);  // ... of dQ
    const uint32_t q_rows = q_tile + row0 * C::kSwizzle;
    const uint32_t o_rows = o_tile + row0 * C::kSwizzle;
    // kCols: the consumer's columns of K, one 64-column chunk of the tile
    const uint32_t k_cols = C::kCols ? wg * kStep * C::kSwizzle : 0;
    const bool drop = probs_bf16 != 0;

    float dq_acc[kOut / 2];
    float s_acc[kStep / 2], dp[kStep / 2];
    uint32_t sf[kFrag][kStep / 16][4];  // dS of the last tile as A fragments, in parts
#pragma unroll
    for (int i = 0; i < kOut / 2; ++i) dq_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kStep / 2; ++i) s_acc[i] = dp[i] = 0.f;

    // S (into s_acc) and dP (into dp) of the key tile in stage s
    auto issue_scores = [&](int s) {
      const uint32_t ks = ring + s * C::kStageBytes;
      ss_product<C, HD, kStep>(s_acc, q_rows, C::kRows * C::kSwizzle, C::kTilePart, ks,
                               C::kStepPart, false, false);
      ss_product<C, HD, kStep>(dp, o_rows, C::kRows * C::kSwizzle, C::kTilePart,
                               ks + C::kIn * C::kStepPart, C::kStepPart, false, drop);
    };
    // dQ += dS K of the key tile in stage s
    auto issue_grads = [&](int s) {
      rs_product<C, kOut, kStep>(dq_acc, sf, ring + s * C::kStageBytes + k_cols, C::kStepPart,
                                 false);
    };
    // Without kCols the consumers take turns to issue, as dkdv_kernel's.
    auto turn = [&]() {
      if constexpr (!C::kCols) named_sync(1 + wg);
    };
    auto pass = [&]() {
      if constexpr (!C::kCols) named_arrive(2 - wg);
    };
    // f32: the running sum of this thread's dQ entries, in dq itself
    const size_t row_stride = static_cast<size_t>(H) * HD;
    auto* qb = dq + static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * HD;
    // adds dQ of the tiles so far into the running sum and zeroes it
    auto flush = [&](bool first) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = qa + 8 * r;
        if (i >= Sq) continue;
        flush_row<kOut>(reinterpret_cast<float*>(qb) + i * row_stride + out0, dq_acc, r, first);
      }
#pragma unroll
      for (int i = 0; i < kOut / 2; ++i) dq_acc[i] = 0.f;
    };

    mbar_wait(bar_q, 0);
    const float* row_f = reinterpret_cast<const float*>(smem_raw + (row_vals - raw));
    const float lse_a = row_f[ra], lse_b = row_f[ra + 8];
    const float d_a = row_f[C::kRows + ra], d_b = row_f[C::kRows + ra + 8];
    // dS of key tile t in place of dP
    auto form_probs = [&](int t) {
      const int k0 = t * kStep;
      const bool mask = k0 + kStep > Skv || (causal && k0 + kStep - 1 > qw0);
      probs<kStep>(s_acc, dp, lse_a, lse_b, d_a, d_b, qa, k0, col0, mask, Skv, causal, scale,
                   probs_bf16);
    };
    // The same turns and steps as dkdv_kernel's, over key tiles.
    if constexpr (!C::kCols) {
      if (n_tiles > 0 && wg == 0) named_arrive(1);
    }
    if constexpr (kF32) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        turn();
        mbar_wait(full + 8 * s, (t / kStages) & 1);
#pragma unroll
        for (int i = 0; i < kStep / 2; ++i) s_acc[i] = dp[i] = 0.f;  // ends their live range
        wgmma_fence();
        issue_scores(s);
        wgmma_commit();
        if (!(wg == 1 && t == n_tiles - 1)) pass();  // the last turn hands over nothing
        wgmma_wait<0>();
        fence_regs(s_acc);
        fence_regs(dp);
        form_probs(t);
        split_frags<kFrag, kStep>(dp, sf, kFrag);
        wgmma_fence();
        issue_grads(s);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_parts<kFrag, kStep>(sf);
        mbar_arrive(empty + 8 * s);
        if ((t + 1) % C::kFlush == 0 && t + 1 < n_tiles) flush(t + 1 == C::kFlush);
      }
    } else {
      if (n_tiles > 0) {
        turn();
        mbar_wait(full, 0);
        wgmma_fence();
        issue_scores(0);
        wgmma_commit();
        pass();
        wgmma_wait<0>();
        fence_regs(s_acc);
        fence_regs(dp);
        form_probs(0);
        split_frags<kFrag, kStep>(dp, sf, kFrag);
      }
      for (int t = 1; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int sp = (t - 1) % kStages;
        turn();
        mbar_wait(full + 8 * s, (t / kStages) & 1);
        wgmma_fence();
        issue_scores(s);
        wgmma_commit();
        issue_grads(sp);
        wgmma_commit();
        pass();
        wgmma_wait<1>();
        fence_regs(s_acc);
        fence_regs(dp);
        form_probs(t);
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_parts<kFrag, kStep>(sf);
        mbar_arrive(empty + 8 * sp);
        split_frags<kFrag, kStep>(dp, sf, kFrag);
      }
      if (n_tiles > 0) {
        const int sp = (n_tiles - 1) % kStages;
        turn();
        wgmma_fence();
        issue_grads(sp);
        wgmma_commit();
        if (wg == 0) named_arrive(2);  // consumer 1's last turn hands over nothing
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_parts<kFrag, kStep>(sf);
        mbar_arrive(empty + 8 * sp);
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = qa + 8 * r;
      if (i >= Sq) continue;
      if constexpr (kF32) {
        if (n_tiles > C::kFlush)  // the running sum of the flushes
          add_row<kOut>(reinterpret_cast<const float*>(qb) + i * row_stride + out0, dq_acc, r);
      }
#pragma unroll
      for (int j = 0; j < kOut / 8; ++j)
        store2(qb + i * row_stride + 8 * j + out0, dq_acc[4 * j + 2 * r] * scale,
               dq_acc[4 * j + 2 * r + 1] * scale);
    }
    if (part != nullptr)
      sum_groups<std::conditional_t<kF32, float, bf16>, HD>(
          part, dk, dv, B, H, KV, Skv, scale, probs_bf16, threadIdx.x - 128, kConsumerThreads);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, float* rows, void* qs, void* ks, void* vs, void* os, void* dq,
                   void* dk, void* dv, float* part, int B, int H, int KV, int Sq, int Skv,
                   int causal, int probs_bf16, cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  using KC = KvCfg<kF32, HD>;
  using QC = QCfg<kF32, HD>;
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  const int sq_pad = (Sq + kRowPad - 1) / kRowPad * kRowPad;
  const long long slots = static_cast<long long>(B) * H * sq_pad;
  cudaError_t err;
  if (slots > 0) {
    const long long blocks = (slots + kRowThreads / 32 - 1) / (kRowThreads / 32);
    rows_kernel<T><<<static_cast<unsigned>(blocks), kRowThreads, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<const float*>(lse),
        rows, slots, Sq, sq_pad, H, HD);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // the bf16 tensors the tensor maps read: the inputs, or their parts
  const void *qa = q, *ka = k, *va = v, *oa = dout;
  int nb = B;
  if constexpr (kF32) {
    const long long nq4 = static_cast<long long>(B) * Sq * H * HD / 4;
    const long long nkv4 = static_cast<long long>(B) * Skv * KV * HD / 4;
    SplitJobs jobs = {};
    jobs.job[0] = {static_cast<const float4*>(q), static_cast<uint2*>(qs), nq4, kParts};
    jobs.job[1] = {static_cast<const float4*>(k), static_cast<uint2*>(ks), nkv4, kParts};
    jobs.job[2] = {static_cast<const float4*>(v), static_cast<uint2*>(vs), nkv4,
                   probs_bf16 ? 1 : kParts};
    jobs.job[3] = {static_cast<const float4*>(dout), static_cast<uint2*>(os), nq4, kParts};
    err = split_all(jobs, 4, stream);
    if (err != cudaSuccess) return err;
    qa = qs;
    ka = ks;
    va = vs;
    oa = os;
    nb = kParts * B;
  }
  using Out = std::conditional_t<kF32, float, bf16>;
  CUtensorMap qmap, kmap, vmap, omap;
  if (!make_map<HD>(&qmap, qa, H, Sq, nb, KC::kStep) ||
      !make_map<HD>(&omap, oa, H, Sq, nb, KC::kStep) ||
      !make_map<HD>(&kmap, ka, KV, Skv, nb, KC::kKeys) ||
      !make_map<HD>(&vmap, va, KV, Skv, nb, KC::kKeys))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(dkdv_kernel<kF32, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KC::kSmemBytes);
  if (err != cudaSuccess) return err;
  dkdv_kernel<kF32, HD><<<dim3(B * H, (Skv + KC::kKeys - 1) / KC::kKeys), kThreads,
                          KC::kSmemBytes, stream>>>(
      qmap, kmap, vmap, omap, rows, static_cast<Out*>(dk), static_cast<Out*>(dv), part, B, H, KV,
      Sq, Skv, sq_pad, scale, causal, probs_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess || Sq == 0) return err;
  if (!make_map<HD>(&qmap, qa, H, Sq, nb, QC::kRows) ||
      !make_map<HD>(&omap, oa, H, Sq, nb, QC::kRows) ||
      !make_map<HD>(&kmap, ka, KV, Skv, nb, QC::kStep) ||
      !make_map<HD>(&vmap, va, KV, Skv, nb, QC::kStep))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(dq_kernel<kF32, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QC::kSmemBytes);
  if (err != cudaSuccess) return err;
  dq_kernel<kF32, HD><<<dim3(B * H, (Sq + QC::kRows - 1) / QC::kRows), kThreads,
                        QC::kSmemBytes, stream>>>(
      qmap, kmap, vmap, omap, rows, static_cast<Out*>(dq), part, static_cast<Out*>(dk),
      static_cast<Out*>(dv), B, H, KV, Sq, Skv, sq_pad, scale, causal, probs_bf16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, float* rows, void* qs, void* ks,
                      void* vs, void* os, void* dq, void* dk, void* dv, float* part, int B, int H,
                      int KV, int Sq, int Skv, int causal, int probs_bf16, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, lse, rows, qs, ks, vs, os, dq, dk, dv, part, B, H,
                           KV, Sq, Skv, causal, probs_bf16, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, rows, qs, ks, vs, os, dq, dk, dv, part, B, H,
                           KV, Sq, Skv, causal, probs_bf16, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, rows, qs, ks, vs, os, dq, dk, dv, part, B, H,
                           KV, Sq, Skv, causal, probs_bf16, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, rows, qs, ks, vs, os, dq, dk, dv, part, B, H,
                            KV, Sq, Skv, causal, probs_bf16, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out, dout (B, Sq, H, hd) and k, v (B, Skv, KV, hd), float32 (bf16 0)
// or bfloat16 (bf16 1), 16-byte aligned; lse (B, H, Sq) float32 from the
// forward; rows float32 scratch of 2 * B * H * sq_pad (Sq rounded up to a
// multiple of 128); in float32, qs, ks, vs, os bf16 scratch of three times
// q's, k's, v's and dout's element counts (their parts), else nullptr;
// part float32 scratch of 2 * B * Skv * H * hd when H > KV and Sq > 0 (the
// per-head partial sums of dK and dV), else nullptr; dq, dk, dv in the
// inputs' dtype and shapes.  Returns the launches' CUDA error (0: none).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* rows, void* qs,
                                   void* ks, void* vs, void* os, void* part, void* dq, void* dk,
                                   void* dv, int B, int H, int KV, int Sq, int Skv, int hd,
                                   int causal, int probs_bf16, int bf16, int device,
                                   void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || H <= 0 || Skv <= 0 || Sq < 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((part == nullptr) != (H == KV || Sq == 0)) return static_cast<int>(cudaErrorInvalidValue);
  if ((qs == nullptr) != (bf16 != 0) || (ks == nullptr) != (bf16 != 0) ||
      (vs == nullptr) != (bf16 != 0) || (os == nullptr) != (bf16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* frows = static_cast<float*>(rows);
  float* fpart = static_cast<float*>(part);
  const cudaError_t err =
      bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, frows, qs, ks, vs, os, dq, dk,
                                      dv, fpart, B, H, KV, Sq, Skv, causal, probs_bf16, s)
           : launch_hd<float>(hd, q, k, v, o, dout, lse, frows, qs, ks, vs, os, dq, dk, dv,
                              fpart, B, H, KV, Sq, Skv, causal, probs_bf16, s);
  return static_cast<int>(err);
}
