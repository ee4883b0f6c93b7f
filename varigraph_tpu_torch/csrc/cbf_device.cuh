// Device functions of the counting Bloom filter (csrc/cbf.cu): the filter
// position of a k-mer encoding, and the sketch of one genome row.
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

namespace vgcbf {

typedef unsigned long long u64;

// The genome is cut into rows of kGenomeCols bases that overlap by k - 1
// (ops/cbf.genome_rows): row r covers the bases
// [r * step, r * step + kGenomeCols), step = kGenomeCols - (k - 1), and
// bases past the chromosome's end are ambiguous.
constexpr int kGenomeCols = 160;

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

// Invertible integer finalizer (reference include/hash64.hpp:5-14).
__device__ __forceinline__ u64 hash64(u64 key, u64 mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// The sketch of one genome row of a chromosome's base codes (0..3, 4 =
// ambiguous), in the reference's sequential form (ops/kmer.sketch_codes,
// reference src/kmer.cpp:20-52), that can stop after any base and go on.
// Both registers start at 0 at the row's first base.  An ambiguous base
// leaves both registers as they are and resets the run counter; a
// palindromic window (forward == reverse) neither advances nor resets it; a
// window emits once the counter reaches k.  The row ends at the
// chromosome's end: the padding past it is ambiguous and never emits.
struct RowSketch {
  u64 fwd, rev;
  long i, end;  // the next base, and the end of the row
  int run;

  // Row `row`; a row that is not `valid` has no bases.
  __device__ __forceinline__ RowSketch(long n, long row, int k, bool valid)
      : fwd(0), rev(0), run(0) {
    i = row * (long)(kGenomeCols - (k - 1));
    end = !valid ? i : (i + kGenomeCols < n ? i + kGenomeCols : n);
  }

  // Sketches the next `bases` bases and calls emit(value) for every window
  // that emits, value = hash64(canonical) << 8 | k.
  template <class Emit>
  __device__ __forceinline__ void advance(const unsigned char* __restrict__ codes,
                                          int k, int bases, Emit&& emit) {
    const u64 kmask = (1ull << (2 * k)) - 1;
    const int top = 2 * (k - 1);
    const long stop = i + bases < end ? i + bases : end;
    for (; i < stop; ++i) {
      const unsigned c = __ldg(codes + i);
      if (c > 3u) {
        run = 0;
        continue;
      }
      fwd = ((fwd << 2) | c) & kmask;
      rev = (rev >> 2) | ((u64)(3u ^ c) << top);
      if (fwd == rev) continue;
      if (++run >= k) emit((hash64(fwd < rev ? fwd : rev, kmask) << 8) | (u64)k);
    }
  }
};

// Sketches the whole of row `row` (see RowSketch).
template <class Emit>
__device__ __forceinline__ void sketch_row(const unsigned char* __restrict__ codes,
                                           long n, long row, int k, Emit&& emit) {
  RowSketch s(n, row, k, true);
  s.advance(codes, k, kGenomeCols, emit);
}

}  // namespace vgcbf
