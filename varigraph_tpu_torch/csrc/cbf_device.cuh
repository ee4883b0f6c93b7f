// Device functions of the counting Bloom filter (csrc/cbf.cu): the filter
// position of a k-mer encoding.  The sketch of a genome row (RowSketch) and
// hash64 are in csrc/kmer_device.cuh.
//
//   position  p(key, s) = murmur3_x64_128(key, seeds[s] & 0xffffffff) & (m - 1)
//             when m is a power of two, else that hash % m
//
// murmur3 is h1 + h2 of MurmurHash3_x64_128 over the key's 8 little-endian
// bytes (reference src/counting_bloom_filter.cpp:90-98).  Keys are the uint64
// k-mer encodings hash64(canonical) << 8 | k, which the torch side carries as
// int64 bit patterns; all arithmetic here is unsigned 64-bit, so multiplies
// wrap, shifts are logical and the modulo is unsigned.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "kmer_device.cuh"

namespace vgcbf {

using vgk::u64;

__device__ __forceinline__ u64 rotl64(u64 x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ u64 fmix64(u64 h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

__device__ __forceinline__ u64 murmur3_u64key(u64 key, u64 seed32) {
  u64 k1 = key * 0x87c37b91114253d5ULL;
  k1 = rotl64(k1, 31);
  k1 *= 0x4cf5ad432745937fULL;
  u64 h1 = (seed32 ^ k1) ^ 8ULL;
  u64 h2 = seed32 ^ 8ULL;
  h1 += h2;
  h2 += h1;
  h1 = fmix64(h1);
  h2 = fmix64(h2);
  h1 += h2;
  h2 += h1;
  return h1 + h2;
}

// The filter position of `key` under one seed: a mask for a power-of-two
// m (mmask = m - 1), an unsigned 64-bit modulo otherwise (mmask = 0).
__device__ __forceinline__ u64 position(u64 key, u64 seed, u64 m, u64 mmask) {
  const u64 h = murmur3_u64key(key, seed & 0xffffffffULL);
  return mmask ? (h & mmask) : (h % m);
}

}  // namespace vgcbf
