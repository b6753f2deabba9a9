// jax.random's threefry2x32 stream (jax_threefry_partitionable=True) in
// native uint32 arithmetic, as device functions.
//
// The same block cipher and key derivations as the port's core/prng.py,
// which replays them bit for bit on int64 tensors:
//   * threefry2x32: 20 rounds, rotations (13,15,26,6) and (17,29,16,24),
//     ks2 = k0 ^ k1 ^ 0x1BD11BDA, key injection after every 4 rounds with
//     + round + 1 on the second word;
//   * fold_in(key, data) = threefry2x32(key, (0, data));
//   * split(key) = (threefry2x32(key, (0, 0)), threefry2x32(key, (0, 1)));
//   * the bits of element n of a draw = x0 ^ x1 of threefry2x32(key,
//     (n >> 32, n & 0xFFFFFFFF));
//   * uniform: float((bits >> 9) | 0x3F800000) - 1.
#pragma once

#include <cstdint>

namespace sjpc {

struct Key {
  uint32_t k0, k1;
};

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Four rounds: x0 += x1, x1 = rotl(x1, r) ^ x0.
__host__ __device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1, int r0, int r1,
                                                 int r2, int r3) {
  x0 += x1; x1 = rotl32(x1, r0) ^ x0;
  x0 += x1; x1 = rotl32(x1, r1) ^ x0;
  x0 += x1; x1 = rotl32(x1, r2) ^ x0;
  x0 += x1; x1 = rotl32(x1, r3) ^ x0;
}

// threefry2x32 of the counter words (x0, x1) under key k.
__host__ __device__ __forceinline__ Key threefry2x32(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += k.k0;
  x1 += k.k1;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k.k1;
  x1 += k2 + 1u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k2;
  x1 += k.k0 + 2u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k.k0;
  x1 += k.k1 + 3u;
  rounds4(x0, x1, 17, 29, 16, 24);
  x0 += k.k1;
  x1 += k2 + 4u;
  rounds4(x0, x1, 13, 15, 26, 6);
  x0 += k2;
  x1 += k.k0 + 5u;
  return Key{x0, x1};
}

__host__ __device__ __forceinline__ Key fold_in(Key k, uint32_t data) {
  return threefry2x32(k, 0u, data);
}

// The two keys of split(k): (the first, the second).
__host__ __device__ __forceinline__ Key split_first(Key k) { return threefry2x32(k, 0u, 0u); }
__host__ __device__ __forceinline__ Key split_second(Key k) { return threefry2x32(k, 0u, 1u); }

// The 32 random bits of element n of a draw under key k.
__host__ __device__ __forceinline__ uint32_t random_bits(Key k, uint64_t n) {
  const Key y = threefry2x32(k, static_cast<uint32_t>(n >> 32), static_cast<uint32_t>(n));
  return y.k0 ^ y.k1;
}

// jax.random.uniform's float32 in [0, 1) from 32 random bits.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace sjpc
