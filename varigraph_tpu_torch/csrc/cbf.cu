// Counting Bloom filter for Hopper (sm_90a): saturating add and min-count,
// over one shard of a filter of m cells.
//
//   position  p(key, s) = murmur3_x64_128(key, seeds[s] & 0xffffffff) & (m - 1)
//                         when m is a power of two, else that hash % m
//   shard     the cells [lo, lo + m_local) of the filter, stored from byte 0
//             of `filter`; the single-device filter is lo = 0, m_local = m
//   add       for every key j with mask[j] and every seed s whose position p
//             falls in the shard:
//               filter[p - lo] = min(filter[p - lo] + 1, 255)
//   count     out[j] = min over the seeds whose position falls in the shard of
//             filter[p - lo], and 255 when none does; the minimum of the
//             shards' outputs is the count of the whole filter
//
// murmur3 is h1 + h2 of MurmurHash3_x64_128 over the key's 8 little-endian
// bytes (reference src/counting_bloom_filter.cpp:90-98).  Keys are the uint64
// k-mer encodings, which the torch side carries as int64 bit patterns; all
// arithmetic here is unsigned 64-bit, so multiplies wrap, shifts are logical
// and the modulo is unsigned.
//
// Replaces, on the TPU side, the XLA device functions of
// varigraph_tpu/ops/cbf.py: _positions (a vmap of Murmur3 over the seeds),
// _add (a dense uint32 histogram of all m cells -- 4 GiB at m = 2^30 -- then a
// clamp and a full-filter combine) and _count (a gather and a min); and, for
// the position-range-sharded filter, the shard_map bodies of
// varigraph_tpu/parallel/mesh.py make_cbf_add_sharded (an in-range mask and a
// per-shard histogram) and make_cbf_count_sharded (255 out of range, then a
// pmin across devices, which the wrapper does as an elementwise min).
//
// What bounds it on an H100: add is kh random one-byte read-modify-writes
// per key.  At m = 2^25 (32 MiB) the filter stays in the 50 MB L2; at
// m = 2^30 (1 GiB) nearly every update misses to HBM, and the atomics'
// random 32-byte sectors, not the ~30 integer operations of Murmur3, set the
// pace.  count is kh random byte loads per key.  A shard computes every
// key's positions and touches only its own; the hashing is repeated on each
// shard, the memory traffic is not.
//
// What the design does about it: one thread per (key, seed) for add and one
// per key for count, so many independent memory operations are in flight.
// The saturating add is an atomicCAS loop on the aligned 32-bit word that
// holds the byte; it stops at 255, so a byte never carries into its
// neighbour.  Saturating +1 steps commute, so the filter is bit-exact
// whatever the order of the atomics.  The word is addressed from the shard's
// own base, which is 4-byte aligned, and a shard whose m_local is not a
// multiple of 4 is allocated up to the next multiple (the wrapper checks),
// so the last word never leaves the allocation; its padding bytes are never
// incremented, because no position maps to them.  No histogram and no
// scratch memory: the kernels allocate nothing and write only the filter or
// the output.  Contention on hot counters (a poly-A k-mer repeated across
// the genome) serialises its CAS retries; that costs time only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

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

// grid (ceil(n / blockDim.x), kh): blockIdx.y is the seed
__global__ void cbf_add_kernel(unsigned char* __restrict__ filter, u64 m,
                               u64 mmask, u64 lo, u64 m_local,
                               const u64* __restrict__ keys,
                               const unsigned char* __restrict__ mask, long n,
                               const u64* __restrict__ seeds) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || !mask[j]) return;
  // unsigned: a position below lo wraps above m_local
  const u64 local = position(__ldg(keys + j), __ldg(seeds + blockIdx.y), m,
                             mmask) - lo;
  if (local >= m_local) return;
  unsigned int* word = reinterpret_cast<unsigned int*>(filter + (local & ~3ULL));
  const unsigned int shift = (unsigned int)(local & 3ULL) * 8u;
  unsigned int old = *word;
  while (((old >> shift) & 0xffu) != 0xffu) {
    const unsigned int assumed = old;
    old = atomicCAS(word, assumed, assumed + (1u << shift));
    if (old == assumed) break;
  }
}

__global__ void cbf_count_kernel(unsigned char* __restrict__ out,
                                 const unsigned char* __restrict__ filter,
                                 u64 m, u64 mmask, u64 lo, u64 m_local,
                                 const u64* __restrict__ keys, long n,
                                 const u64* __restrict__ seeds, int kh) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const u64 key = __ldg(keys + j);
  unsigned int c = 255u;
  for (int s = 0; s < kh; ++s) {
    const u64 local = position(key, __ldg(seeds + s), m, mmask) - lo;
    if (local < m_local) {
      const unsigned int v = __ldg(filter + local);
      c = v < c ? v : c;
    }
  }
  out[j] = (unsigned char)c;
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() as an int (0 = the
// launch was accepted).  The wrapper checks the rest: m >= 1, 0 <= lo,
// lo + m_local <= m, `filter` 4-byte aligned with room for
// ceil(m_local / 4) words.  n == 0 or kh == 0 launches nothing.  The grid's
// x dimension is ceil(n / 256), computed in 64 bits (n < 2^31 * 256).
static u64 mask_of(long m) {
  return (m & (m - 1)) == 0 ? (u64)(m - 1) : 0ULL;
}

extern "C" int vg_cbf_add(void* filter, long m, long lo, long m_local,
                          const void* keys, const void* mask, long n,
                          const void* seeds, int kh, void* stream) {
  if (n == 0 || kh == 0 || m_local == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)kh);
  cbf_add_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (unsigned char*)filter, (u64)m, mask_of(m), (u64)lo, (u64)m_local,
      (const u64*)keys, (const unsigned char*)mask, n, (const u64*)seeds);
  return (int)cudaGetLastError();
}

extern "C" int vg_cbf_count(void* out, const void* filter, long m, long lo,
                            long m_local, const void* keys, long n,
                            const void* seeds, int kh, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cbf_count_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (unsigned char*)out, (const unsigned char*)filter, (u64)m, mask_of(m),
      (u64)lo, (u64)m_local, (const u64*)keys, n, (const u64*)seeds, kh);
  return (int)cudaGetLastError();
}
