// GF(2^31 - 1) arithmetic, the Carter-Wegman pair hash and the masked
// Horner fingerprint, as device functions shared by the SJPC kernels.
//
// Field elements are uint32 in [0, p).  A product of two canonical
// elements is one 32x32->64-bit multiply (mul.wide.u32); x = hi*2^31 + lo
// reduces as hi + lo (2^31 = 1 mod p), then one fold and one conditional
// subtract.  The results equal the 16-bit-limb arithmetic of the JAX
// package's core/hashing.py and the int64 plain versions of this package.
//
// Host-side tensors carry uint32 data as int64 (see core/hashing.py); the
// kernels read those words and narrow them to uint32.
#pragma once

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

// Degree-3 Carter-Wegman hash; c[0..3] are the coefficients.
__device__ __forceinline__ uint32_t cw_hash(uint32_t x, const uint32_t* c) {
  uint32_t h = c[3];
  h = addmod_p31(mulmod_p31(h, x), c[2]);
  h = addmod_p31(mulmod_p31(h, x), c[1]);
  return addmod_p31(mulmod_p31(h, x), c[0]);
}

// 4-universal hash of the pair (x, y); c holds 2 x 4 coefficients.
__device__ __forceinline__ uint32_t cw_hash_pair(uint32_t x, uint32_t y, const uint32_t* c) {
  return addmod_p31(cw_hash(x, c), cw_hash(y, c + 4));
}

// Masked Horner fingerprints of one record under one combination:
// seed (id mod p) + 1, then fp <- fp * base + (v mod p) + 1 for every
// column whose mask entry is non-zero.  values and mask are d-long rows.
__device__ __forceinline__ void masked_horner(const int64_t* values, const int64_t* mask,
                                              int64_t id, uint32_t base1, uint32_t base2,
                                              int d, uint32_t* fp1, uint32_t* fp2) {
  const uint32_t seed = addmod_p31(reduce_p31(static_cast<uint32_t>(id)), 1u);
  uint32_t f1 = seed, f2 = seed;
  for (int col = 0; col < d; ++col) {
    if (mask[col] != 0) {
      const uint32_t v = addmod_p31(reduce_p31(static_cast<uint32_t>(values[col])), 1u);
      f1 = addmod_p31(mulmod_p31(f1, base1), v);
      f2 = addmod_p31(mulmod_p31(f2, base2), v);
    }
  }
  *fp1 = f1;
  *fp2 = f2;
}

}  // namespace sjpc
