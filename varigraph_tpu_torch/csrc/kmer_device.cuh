// Device functions shared by the port's k-mer kernels (csrc/join.cu,
// csrc/cbf.cu, csrc/sketch.cu): the k-mer encoding, the sketch of a run of
// base codes with the reference's rule for ambiguous bases, and the lookup of
// a value in a sorted table through its key directory, one value or a batch,
// behind an optional occupancy bitmap.
//
// Values are the uint64 k-mer encodings hash64(canonical) << 8 | k, which the
// torch side carries as int64 bit patterns.  All arithmetic and every
// comparison here is unsigned 64-bit, so encodings with bit 63 set (k = 28)
// order correctly.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vgk {

typedef unsigned long long u64;

// The genome is cut into rows of kGenomeCols bases that overlap by k - 1
// (ops/cbf.genome_rows): row r covers the bases
// [r * step, r * step + kGenomeCols), step = kGenomeCols - (k - 1), and
// bases past the chromosome's end are ambiguous.
constexpr int kGenomeCols = 160;

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

// One base c (0..3) into both rolling registers: forward
// ((x << 2) | c) & kmask, reverse (x >> 2) | (3^c) << top, top = 2(k-1).
__device__ __forceinline__ void roll(u64& fwd, u64& rev, unsigned c, u64 kmask,
                                     int top) {
  fwd = ((fwd << 2) | c) & kmask;
  rev = (rev >> 2) | ((u64)(3u ^ c) << top);
}

// The sketch of a run of base codes (0..3, 4 = ambiguous) in the reference's
// sequential form (ops/kmer.sketch_codes, reference src/kmer.cpp:20-52), that
// can stop after any base and go on.  An ambiguous base leaves both
// registers as they are and resets the run counter; a palindromic window
// (forward == reverse) neither advances nor resets it; a window emits once
// the counter reaches k.
struct RowSketch {
  u64 fwd, rev;
  long i, end;  // the next base, and the end of the run
  int run;

  // Row `row` of a chromosome of n bases (see kGenomeCols): both registers
  // start at 0 at the row's first base, and the row ends at the
  // chromosome's end (the padding past it is ambiguous and never emits).
  // A row that is not `valid` has no bases.
  __device__ __forceinline__ RowSketch(long n, long row, int k, bool valid)
      : fwd(0), rev(0), run(0) {
    i = row * (long)(kGenomeCols - (k - 1));
    end = !valid ? i : (i + kGenomeCols < n ? i + kGenomeCols : n);
  }

  // The bases [begin, end_) with the registers and the run counter as the
  // bases before them left them.
  __device__ __forceinline__ RowSketch(long begin, long end_, u64 fwd_,
                                       u64 rev_, int run_)
      : fwd(fwd_), rev(rev_), i(begin), end(end_), run(run_) {}

  // Sketches base i (i < end) and moves on; true, with its value in v,
  // when its window emits.
  __device__ __forceinline__ bool step(const unsigned char* __restrict__ codes,
                                       int k, u64 kmask, int top, u64& v) {
    const unsigned c = __ldg(codes + i++);
    if (c > 3u) {
      run = 0;
      return false;
    }
    roll(fwd, rev, c, kmask, top);
    if (fwd == rev) return false;
    if (++run < k) return false;
    v = (hash64(fwd < rev ? fwd : rev, kmask) << 8) | (u64)k;
    return true;
  }

  // Sketches the next `bases` bases and calls emit(value) for every window
  // that emits.
  template <class Emit>
  __device__ __forceinline__ void advance(const unsigned char* __restrict__ codes,
                                          int k, int bases, Emit&& emit) {
    const u64 kmask = (1ull << (2 * k)) - 1;
    const int top = 2 * (k - 1);
    const long stop = i + bases < end ? i + bases : end;
    u64 v;
    while (i < stop)
      if (step(codes, k, kmask, top, v)) emit(v);
  }
};

// Sketches the whole of row `row` (see RowSketch).
template <class Emit>
__device__ __forceinline__ void sketch_row(const unsigned char* __restrict__ codes,
                                           long n, long row, int k, Emit&& emit) {
  RowSketch s(n, row, k, true);
  s.advance(codes, k, kGenomeCols, emit);
}

// The key directory (ops/table.key_directory): dir, int32 [2^bits + 1],
// holds at dir[p] the lower bound in keys of p << s, with s = max(0, bit
// length of keys[m-1] - bits), and dir[2^bits] = m.  The keys are the output
// of an invertible mixer, so their top bits spread evenly; the directory is
// sized for ~4 keys a bucket (one 32-byte sector), at most 2^22 buckets
// (16 MB, so it stays in L2).  A value's bucket is v >> s, two neighbouring
// loads from the directory, and the search is a branch-free lower bound of
// ~2 steps inside the bucket instead of log2(m) steps over the whole table.
// A skewed or empty bucket stays exact, only slower; a value whose bucket
// lies past the directory is above every key.

// The bucket shift s of the directory; m >= 1.
__device__ __forceinline__ int bucket_shift(const u64* __restrict__ keys,
                                            long m, int bits) {
  const int len = 64 - __clzll((long long)__ldg(keys + m - 1));
  return len > bits ? len - bits : 0;
}

// The keys' occupancy bitmap (csrc/sketch.cu vg_key_bitmap): 2^bbits bits,
// bit q set where a key's top bits below the largest key's highest are q,
// bshift = bucket_shift(keys, m, bbits).  False when v is no key; true
// when it may be one, which only the search settles.
__device__ __forceinline__ bool bitmap_test(const unsigned* __restrict__ bitmap,
                                            int bbits, int bshift, u64 v) {
  const u64 q = v >> bshift;
  return !(q >> bbits) && ((__ldg(bitmap + (q >> 5)) >> (q & 31)) & 1u);
}

// idx[j] = the index of v[j] in keys (unique, sorted as unsigned values) or
// -1, for each j with look[j]; -1 for the others.  The B searches advance
// together, each step's loads issued for the whole batch before any is
// used: the directory pairs, then the lower-bound steps while any bucket
// holds more than one candidate, then keys[i] and keys[i + 1] at once.
template <int B>
__device__ __forceinline__ void find_keys(const u64* __restrict__ keys,
                                          const int* __restrict__ dir, int bits,
                                          int shift, const u64 (&v)[B],
                                          const bool (&look)[B], int (&idx)[B]) {
  int lo[B], hi[B], n[B];
#pragma unroll
  for (int j = 0; j < B; ++j) {
    lo[j] = hi[j] = 0;
    const u64 p = v[j] >> shift;
    if (look[j] && !(p >> bits)) {  // else above every key
      lo[j] = __ldg(dir + p);
      hi[j] = __ldg(dir + p + 1);
    }
  }
  bool more = false;
#pragma unroll
  for (int j = 0; j < B; ++j) {
    n[j] = hi[j] - lo[j];
    more |= n[j] > 1;
  }
  // the lower bound of v[j] stays in [lo[j], lo[j] + n[j]]
  while (more) {
    more = false;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (n[j] > 1) {
        const int half = n[j] >> 1;
        if (__ldg(keys + lo[j] + half) < v[j]) lo[j] += half;
        n[j] -= half;
        more |= n[j] > 1;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < B; ++j) {
    idx[j] = -1;
    if (n[j] > 0) {
      const int i = lo[j];
      const u64 x0 = __ldg(keys + i);
      const u64 x1 = i + 1 < hi[j] ? __ldg(keys + i + 1) : 0;
      if (x0 == v[j])
        idx[j] = i;
      else if (x0 < v[j] && i + 1 < hi[j] && x1 == v[j])
        idx[j] = i + 1;
    }
  }
}

// Index of v in keys (unique, sorted as unsigned values), or -1.
__device__ __forceinline__ long find_key(const u64* __restrict__ keys,
                                         const int* __restrict__ dir, int bits,
                                         int shift, u64 v) {
  const u64 one[1] = {v};
  const bool look[1] = {true};
  int idx[1];
  find_keys<1>(keys, dir, bits, shift, one, look, idx);
  return idx[0];
}

}  // namespace vgk
