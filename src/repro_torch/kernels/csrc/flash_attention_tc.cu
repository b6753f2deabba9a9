// Flash attention (forward) in bf16 on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention_pallas and its model-layout wrapper flash_attention)
// for bfloat16 inputs; float32 inputs go to csrc/flash_attention_f32.cu,
// the same design on split operands.  q (B, Sq, H, hd) and k, v (B, Skv,
// KV, hd) in the model's own layout, out (B, Sq, H, hd) bf16.  Query
// head h reads KV head h / (H / KV): KV heads are indexed, never
// expanded.  Causal masking is top-left aligned (query i sees keys 0..i).
//
// What it computes is the TPU kernel's function, which casts q, k and v to
// f32 and keeps the probabilities in f32:
//   * scores S = Q K^T on bf16 tensor cores with f32 accumulation: a
//     product of two bf16 values is exact in f32, so only the summation
//     order differs from the f32 path; then times 1/sqrt(hd) (rounded from
//     double), masked scores -1e30;
//   * the online softmax in f32 on the accumulator fragment: running max
//     m, normaliser l; p = 0 where m_new <= -5e29, alpha = 0 where
//     m_prev <= -5e29; exp(x - m) as ex2.approx of fma(x, log2 e,
//     -m log2 e) (relative error near 2^-22 at the row's top, far inside
//     the bf16 output's ulp; libm's expf, which the f32 kernel keeps, made
//     this schedule spill);
//   * P V with f32-precision probabilities: each p is split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi), and P_hi V and P_lo V go
//     into the same f32 accumulator (p_hi + p_lo keeps about 16 bits of p,
//     a relative error near 2^-17; rounding P to bf16 once, as SDPA does,
//     would compute another function);
//   * out = acc / max(l, 1e-30) by IEEE division, rounded to bf16;
//   * on request (lse != nullptr, for the backward in
//     flash_attention_bwd.cu) each row's log-sum-exp m + logf(l) in f32,
//     +inf for a row that saw no key (m <= -5e29), so that the backward's
//     exp(s - lse) is exactly 0 there; with nullptr nothing more is stored;
//   * with probs_bf16 (the model's probs_dtype bfloat16) p_lo is 0: P is
//     rounded to bf16 once before P V, at its row's final max, as the
//     plain version rounds it over one key chunk: a first sweep over the
//     K tiles finds each row's max, and the main sweep's maxima never move.
//     Rounding at each 128-key tile's running max instead would move about
//     30 % of the bf16 outputs of a (2, 200, 1000, 8/1, 16) case one ulp
//     from the plain version's (the CPU emulation in
//     tests/test_torch_flash_grad.py), and D = rowsum(dO * out) carries
//     each into the backward's gradients.
//
// What bounds it: operations.  4 * hd flops per visible (query, key) pair
// at the 989 TFLOP/s bf16 tensor-core rate; the hi/lo split makes the
// kernel do 6 * hd, so its own floor is 1.5x that bound (probs_bf16 forms
// S twice: 8 * hd).
//
// Design.  One CTA of three warpgroups takes 128 query rows of one
// (batch, head).  Warpgroup 0 is the producer: one thread issues TMA loads
// of the Q tile (once) and of each 128-key K and V tile into two-stage
// rings in shared memory, tracked by mbarriers (full: the TMA bytes
// landed; empty: both consumers are done with the tile), and gives its
// registers away (setmaxnreg 24).  Warpgroups 1 and 2 are consumers of 64
// rows each (setmaxnreg 240): wgmma m64n128k16 computes S with A = Q and
// B = the K tile from shared memory, both K-major as the model layout
// stores them; the softmax runs on the accumulator registers (row max and
// sum over the four threads of a row); P_hi and P_lo go to wgmma as
// register A fragments (the accumulator layout of S is the A-fragment
// layout of P V), B = the V tile in MN-major layout with wgmma's transpose
// bit; the 64 x hd f32 output accumulator stays in registers, and the
// epilogue divides and stores bf16 in the model layout.  Each consumer
// issues S(t) together with P(t-1) V(t-1) and runs the softmax of tile t
// while that product is in flight; the two consumers take turns to issue
// (named barriers), so one's softmax overlaps the other's products.  TMA
// reads the model layout in place through 4-D tensor maps (hd, heads, seq,
// batch) with one head per box; it zero-fills rows past the end, keys >=
// Skv are masked and rows >= Sq are not stored.  Rows of hd bf16 go
// through the 128-, 64- or 32-byte swizzle (hd 128 as two 64-column
// atoms), the same in the tensor maps and the wgmma descriptors.  Causal
// CTAs never load tiles above the diagonal and mask only the tiles that
// cross it; the heaviest query tiles launch first.  The mbarrier, TMA,
// wgmma and softmax building blocks are in hopper.cuh.
#include "hopper.cuh"

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBQ = 128;          // query rows per CTA: two consumer warpgroups of 64
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 2;        // K/V ring depth
constexpr int kThreads = 384;     // producer warpgroup + two consumers

// The tiles of one head dimension: Q (kBQ rows) and the K and V tiles
// (kBK rows each) in bf16, in the swizzle layout of Swizzle<HD>.
template <int HD>
struct Tile : Swizzle<HD> {
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kKVBytes = kBK * HD * 2;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // 1024 bytes of slack to align the base for the swizzle, then the tiles
  // and the barriers (Q, then full K, full V, empty K and empty V per stage)
  static constexpr int kSmemBytes = 1024 + kBarOffset + 8 * (1 + 4 * kStages);
};

// Issues S (64 x kBK) = Q K^T for the warpgroup's 64 rows of the Q tile
// at q_rows and the K tile at k_tile: hd / 16 steps of 16 columns.
template <int HD>
__device__ __forceinline__ void scores(float (&sc)[kBK / 2], uint32_t q_rows, uint32_t k_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int chunk = kk * 16 / T::kAtomCols;
    const uint32_t off = (kk * 16 % T::kAtomCols) * 2;
    const uint64_t da = smem_desc(q_rows + chunk * kBQ * T::kSwizzle + off, 16, 8 * T::kSwizzle,
                                  T::kLayout);
    const uint64_t db = smem_desc(k_tile + chunk * kBK * T::kSwizzle + off, 16, 8 * T::kSwizzle,
                                  T::kLayout);
    wgmma_ss(sc, da, db, kk > 0);
  }
}

// Issues acc += P_hi V + P_lo V for the V tile at v_tile (MN-major):
// kBK / 16 steps of 16 keys.
template <int HD>
__device__ __forceinline__ void values(float (&acc)[HD / 2], uint32_t (&p)[2][kBK / 16][4],
                                       uint32_t v_tile) {
  using T = Tile<HD>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv = smem_desc(v_tile + kk * 16 * T::kSwizzle, kBK * T::kSwizzle,
                                  8 * T::kSwizzle, T::kLayout);
    wgmma_rs(acc, p[0][kk], dv);
    wgmma_rs(acc, p[1][kk], dv);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int H, int KV, int Sq, int Skv, float scale, int causal,
                int probs_bf16) {
  using T = Tile<HD>;
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
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(q_tile + c * kBQ * T::kSwizzle, &qmap, bar_q, c * T::kAtomCols, h, q0, b);
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
        for (int c2 = 0; c2 < T::kChunks; ++c2)
          tma_load(k_tiles + ks * T::kKVBytes + c2 * kBK * T::kSwizzle, &kmap, full_k + 8 * ks,
                   c2 * T::kAtomCols, kvh, kt * kBK, b);
        if (c < n_pre) continue;
        const int t = c - n_pre;
        const int s = t % kStages;
        mbar_wait(empty_v + 8 * s, ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full_v + 8 * s, T::kKVBytes);
#pragma unroll
        for (int c2 = 0; c2 < T::kChunks; ++c2)
          tma_load(v_tiles + s * T::kKVBytes + c2 * kBK * T::kSwizzle, &vmap, full_v + 8 * s,
                   c2 * T::kAtomCols, kvh, t * kBK, b);
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

    float acc[HD / 2];
    float sc[kBK / 2];
    // P of the last softmax as A fragments: p[0] = bf16(p) and p[1] =
    // bf16(p - p[0]), or 0 with probs_bf16 (hopper.cuh's split_frags)
    uint32_t p[2][kBK / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) sc[i] = 0.f;
    Softmax<kBK> sm;

    // The two consumers take turns to issue their products (named barrier
    // 1 + wg is this one's turn, 2 - wg the other's), so that one's softmax
    // runs while the other's products keep the tensor cores busy.
    // Consumer 0 goes first.  Step 0 issues S(0); step t in 1..n-1 issues
    // S(t) and acc += P(t-1) V(t-1), and runs the softmax of tile t while
    // that P V product is in flight; step n issues P(n-1) V(n-1).
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
      sm.update(sc, rows, 0, Skv, scale, causal);  // acc is still 0: nothing to rescale
      split_frags<2, kBK>(sc, p, probs_bf16 ? 1 : 2);
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
      values<HD>(acc, p, v_tiles + sp * T::kKVBytes);
      wgmma_commit();
      named_arrive(2 - wg);
      wgmma_wait<1>();
      fence_regs(sc);
      mbar_arrive(empty_k + 8 * ks);
      sm.update(sc, rows, t * kBK, Skv, scale, causal);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_parts<2, kBK>(p);
      mbar_arrive(empty_v + 8 * sp);
      sm.rescale(acc);
      split_frags<2, kBK>(sc, p, probs_bf16 ? 1 : 2);
    }
    if (n_tiles > 0) {
      const int sp = (n_tiles - 1) % kStages;
      named_sync(1 + wg);
      mbar_wait(full_v + 8 * sp, ((n_tiles - 1) / kStages) & 1);
      wgmma_fence();
      values<HD>(acc, p, v_tiles + sp * T::kKVBytes);
      wgmma_commit();
      if (wg == 0) named_arrive(2);  // consumer 1's last turn hands over nothing
      wgmma_wait<0>();
      fence_regs(acc);
      fence_parts<2, kBK>(p);
      mbar_arrive(empty_v + 8 * sp);
    }

    const int qa = rows.qa;
    const int qb = qa + 8;
    const int col0 = rows.col0;
    const float den_a = fmaxf(sm.l_a, 1e-30f);
    const float den_b = fmaxf(sm.l_b, 1e-30f);
    const size_t row_stride = static_cast<size_t>(H) * HD;
    __nv_bfloat16* ob = o + static_cast<size_t>(b) * Sq * row_stride + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + col0;
      if (qa < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + qa * row_stride + col) =
            __floats2bfloat162_rn(acc[4 * j] / den_a, acc[4 * j + 1] / den_a);
      if (qb < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + qb * row_stride + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / den_b, acc[4 * j + 3] / den_b);
    }
    if (lse != nullptr && col0 == 0) store_lse(lse, sm, b, h, H, Sq, qa);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                   int KV, int Sq, int Skv, int causal, int probs_bf16, cudaStream_t stream) {
  constexpr int smem = Tile<HD>::kSmemBytes;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<HD>(&qmap, q, H, Sq, B, kBQ) || !make_map<HD>(&kmap, k, KV, Skv, B, kBK) ||
      !make_map<HD>(&vmap, v, KV, Skv, B, kBK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  flash_tc_kernel<HD><<<grid, kThreads, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lse, H, KV, Sq, Skv, scale, causal,
      probs_bf16);
  return cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v and out; lse (B, H, Sq) float32 or nullptr.  Returns
// the launch's CUDA error (0: none).
extern "C" int flash_attention_tc_fwd(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int KV, int Sq, int Skv, int hd,
                                      int causal, int probs_bf16, int device, void* stream) {
  cudaSetDevice(device);
  if (B <= 0 || H <= 0 || Sq <= 0) return static_cast<int>(cudaGetLastError());
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      err = launch<16>(q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Skv, causal,
                        probs_bf16, s);
      break;
    case 32:
      err = launch<32>(q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Skv, causal,
                        probs_bf16, s);
      break;
    case 64:
      err = launch<64>(q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Skv, causal,
                        probs_bf16, s);
      break;
    case 128:
      err = launch<128>(q, k, v, o, static_cast<float*>(lse), B, H, KV, Sq, Skv, causal,
                        probs_bf16, s);
      break;
    default: break;
  }
  return static_cast<int>(err);
}
