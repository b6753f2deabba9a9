// GF(2^31 - 1) arithmetic, the Carter-Wegman pair hash and the masked
// Horner fingerprint, as device functions shared by the SJPC kernels.
//
// Field elements are uint32 in [0, p).  A product of two canonical
// elements is one 32x32->64-bit multiply (mul.wide.u32); x = hi*2^31 + lo
// reduces as hi + lo (2^31 = 1 mod p), then one fold and one conditional
// subtract.  Sums of such products are kept in 64 bits and reduced once
// (reduce64_p31): a hash is the polynomial in x, x^2, x^3, a Horner step
// f * base + v.  The results equal the 16-bit-limb arithmetic of the JAX
// package's core/hashing.py and the int64 plain versions of this package.
//
// Host-side tensors carry uint32 data as int64 (see core/hashing.py); the
// kernels read those words, or uint32 words stored in int32 tensors (the
// 32-bit form fused_ingest.cu reads), and narrow them to uint32.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sjpc {

constexpr uint32_t P31 = 0x7FFFFFFFu;

__device__ __forceinline__ uint32_t fold_p31(uint32_t x) {
  return (x & P31) + (x >> 31);
}

// Full reduction of any uint32 into [0, p).
__device__ __forceinline__ uint32_t reduce_p31(uint32_t x) {
  x = fold_p31(fold_p31(x));
  return x >= P31 ? x - P31 : x;
}

// (a * b) mod p for canonical a, b.
__device__ __forceinline__ uint32_t mulmod_p31(uint32_t a, uint32_t b) {
  const uint64_t x = static_cast<uint64_t>(a) * b;            // < 2^62
  uint32_t r = static_cast<uint32_t>(x & P31) + static_cast<uint32_t>(x >> 31);  // < 2^32
  r = fold_p31(r);                                             // <= p + 1
  return r >= P31 ? r - P31 : r;
}

// (a + b) mod p for canonical a, b.
__device__ __forceinline__ uint32_t addmod_p31(uint32_t a, uint32_t b) {
  const uint32_t r = fold_p31(a + b);
  return r >= P31 ? r - P31 : r;
}

// The canonical residue of any uint64: two folds (2^31 = 1 mod p) leave
// less than 2^31 + 5, then one conditional subtract.
__device__ __forceinline__ uint32_t reduce64_p31(uint64_t x) {
  x = (x & P31) + (x >> 31);                                          // < 2^33 + 2^31
  const uint32_t r = static_cast<uint32_t>((x & P31) + (x >> 31));    // < 2^31 + 5
  return r >= P31 ? r - P31 : r;
}

// x, x^2 and x^3 mod p of a canonical x: every degree-3 hash of x reads
// them, so a key's powers are taken once for all its hashes.
struct Powers {
  uint32_t x1, x2, x3;
};

__device__ __forceinline__ Powers powers(uint32_t x) {
  const uint32_t x2 = mulmod_p31(x, x);
  return Powers{x, x2, mulmod_p31(x2, x)};
}

// The degree-3 Carter-Wegman polynomial c0 + c1 x + c2 x^2 + c3 x^3 of
// canonical coefficients, unreduced: three products below 2^62 and c0
// stay below 2^64.  Equal mod p to Horner's ((c3 x + c2) x + c1) x + c0.
__device__ __forceinline__ uint64_t cw_poly(const Powers& x, uint4 c) {
  return static_cast<uint64_t>(c.y) * x.x1 + static_cast<uint64_t>(c.z) * x.x2
         + static_cast<uint64_t>(c.w) * x.x3 + c.x;
}

// 4-universal hash of the pair (x, y), (cw(x) + cw(y)) mod p, from both
// keys' powers; c holds 2 x 4 canonical coefficients, 16-byte aligned.
// Each polynomial folds once (< 2^34), so the sum reduces in one step.
__device__ __forceinline__ uint32_t cw_hash_pair(const Powers& x, const Powers& y,
                                                 const uint32_t* c) {
  const uint64_t a = cw_poly(x, *reinterpret_cast<const uint4*>(c));
  const uint64_t b = cw_poly(y, *reinterpret_cast<const uint4*>(c + 4));
  return reduce64_p31((a & P31) + (a >> 31) + (b & P31) + (b >> 31));
}

// The masked Horner seed of a combination id: (id mod p) + 1; and the
// Horner term of a column value: (v mod p) + 1.
__device__ __forceinline__ uint32_t horner_seed(uint32_t id) {
  return addmod_p31(reduce_p31(id), 1u);
}

__device__ __forceinline__ uint32_t horner_term(uint32_t v) {
  return addmod_p31(reduce_p31(v), 1u);
}

// Masked Horner fingerprints of one record under one combination given as
// a column bitmask (d <= 32) and its seed: fp <- fp * base + term(v) for
// every column whose bit is set.  values is the record's d-long row of
// uint32 words (int64 or int32).
template <typename Word>
__device__ __forceinline__ void horner_columns(const Word* values, uint32_t cols,
                                               uint32_t seed, uint32_t base1, uint32_t base2,
                                               int d, uint32_t* fp1, uint32_t* fp2) {
  uint32_t f1 = seed, f2 = seed;
  for (int col = 0; col < d; ++col) {
    if ((cols >> col) & 1u) {
      const uint32_t v = horner_term(static_cast<uint32_t>(values[col]));
      f1 = reduce64_p31(static_cast<uint64_t>(f1) * base1 + v);
      f2 = reduce64_p31(static_cast<uint64_t>(f2) * base2 + v);
    }
  }
  *fp1 = f1;
  *fp2 = f2;
}

}  // namespace sjpc
