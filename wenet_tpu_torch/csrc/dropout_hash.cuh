// Counter-based attention-weight dropout, shared by the rel-pos attention
// kernels (forward K1, backward K2 and K3).
//
// Replaces `_dropout_mult` (wenet_tpu/ops/flash_attention.py), bit for bit:
// a murmur3 fmix32 hash over (seed, b*h, global query row, global key
// column) in uint32 arithmetic.  The mask is a pure function of absolute
// positions, so the three kernels regenerate the same mask whatever their
// tiling, and the (T1, T2) mask never exists in device memory.  The host
// computes the threshold in double, min(int(rate * 2^32), 2^32 - 1), and
// the keep multiplier float32(1 / (1 - rate)), exactly as the JAX package.
#pragma once

#include <stdint.h>

struct DropoutParams {
  uint32_t seed;  // per-call seed
  uint32_t thr;   // keep where hash >= thr (flash_tiles.cuh: keep_bits)
  float scale;    // keep multiplier 1 / (1 - rate)
};

__device__ __forceinline__ uint32_t dropout_hash(uint32_t seed, uint32_t bh,
                                                 uint32_t qi, uint32_t ki) {
  uint32_t u = (qi * 0x9E3779B1u) ^ (ki * 0x85EBCA77u);
  u += seed + bh * 0x27D4EB2Fu;
  u ^= u >> 16;  // fmix32 finalizer
  u *= 0x85EBCA6Bu;
  u ^= u >> 13;
  u *= 0xC2B2AE35u;
  u ^= u >> 16;
  return u;
}
