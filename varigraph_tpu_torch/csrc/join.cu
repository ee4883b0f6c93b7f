// Read k-mer counting for Hopper (sm_90a): two entries over one sorted table.
//
//   vg_count_join    cov[i] += #{ j : mask[j] && queries[j] == keys[i] }
//   vg_count_packed  cov[i] += #{ windows of the packed reads whose canonical
//                                k-mer encodes to keys[i] }
//
// keys are unique and sorted as unsigned 64-bit values; queries and keys are
// the uint64 k-mer encodings hash64(canonical) << 8 | k, which the torch side
// carries as int64 bit patterns.  All arithmetic and every comparison here is
// unsigned 64-bit, so encodings with bit 63 set (k = 28) order correctly.
//
// The key directory.  Both entries find a key through dir, int32 [2^bits + 1]
// (ops/table.key_directory), with find_key of csrc/kmer_device.cuh: a
// value's bucket is two neighbouring loads from the directory, and the search
// is a branch-free lower bound of ~2 steps inside the bucket instead of
// log2(m) steps over the whole table.
//
// Replaces, on the TPU side:
//   * vg_count_join: the Pallas banded merge-join
//     varigraph_tpu/ops/join_pallas.py (_band_kernel, launched by _band_counts
//     inside count_merge_banded), which the JAX package uses for tables of up
//     to 2M keys, and the XLA two-sort joins count_merge and count_merge_super
//     (varigraph_tpu/ops/table.py) that it uses beside and above it.  All have
//     this contract, so one kernel serves every table size.  No main path of
//     the port launches it: construct's exact genome count sketches and looks
//     up its genome rows in one kernel (vg_count_codes, csrc/sketch.cu).
//   * vg_count_packed: the same join fused with the XLA sketch that feeds it,
//     sketch_codes and unpack_2bit (varigraph_tpu/ops/kmer.py:79,143), on the
//     read path.  It takes the packed batch as it arrives from the host, uint8
//     [B, L/4 + 2] (2-bit bases, base i in bits 2(i mod 4) of byte i/4, then
//     the row's length as a little-endian u16), and never writes the values.
//
// What bounds each entry on an H100, and what the design does about it:
//   * vg_count_join reads 9 bytes a query (the value and its mask) and, per
//     masked-in query, one directory sector, one key sector and, on a hit, a
//     4-byte atomic: by the card's peak rates it is bound by bytes.  What
//     sets its pace in practice is the number of loads a lookup makes, each
//     lane to an address of its own: the L1 serves such a load one lane at a
//     time.  A whole-table binary search makes ~17 of them (the first few
//     shared by the warp's lanes, the deep ones missing to HBM at tens of
//     millions of keys); the directory leaves ~6 (two directory entries, ~2
//     search steps, the final compare), the key sector the only one that
//     may miss to HBM.  Many warps in flight hide the latency; masked-out
//     queries load nothing more.
//   * vg_count_packed reads 0.25 bytes a base instead of the 9 bytes a window
//     that the sketch would write and the join read back, so against a table
//     in L2 it is bound by integer operations: per base the two rolling
//     registers, per window the 23-operation hash64 finalizer, in 64-bit
//     arithmetic.  Against a large table it is bound, like the join, by one
//     random key sector per window and a cov sector per hit.  In practice
//     its pace, too, is set by the lookups' per-lane loads.  One warp takes
//     one read, and each lane a run of ceil(length / 32) consecutive
//     positions: it rebuilds both registers from the k-1 bases before its
//     run (an older base leaves both registers before the run's first window
//     is formed), then rolls them along the run.  So 32 lanes work on a
//     150-base read, where one thread per read would leave 16,384 threads to
//     a 132-SM card, and the lanes of a warp read the same few cache lines.
//
// Semantics reproduced (ops/kmer.sketch_codes, varigraph_tpu/ops/sketch_ref):
// forward register ((x << 2) | c) & mask, reverse register
// (x >> 2) | (3^c) << 2(k-1); a window with forward == reverse is skipped and
// does not advance the run counter; a window emits once the counter reaches
// k.  The packed feed cuts reads at every non-ACGT base, so within a row's
// length every code is a base (positions at or past it never emit) and the
// counter is never reset.  Then the counter needs no scan: the k-1 windows
// before position k-1 are incomplete and never palindromes (the reverse
// register's top base is 3^c, the forward register's is still 0), so the
// counter is k-1 at position k-2 and every later window that is not a
// palindrome emits, whatever palindromic tract, (AT)n or other, came
// before.  A window emits exactly when it is complete and not a palindrome.
//
// Integer atomics make both results exact whatever the order, including a
// poly-A read that repeats one k-mer thousands of times in a batch.  No
// scratch memory: the kernels allocate nothing and write only cov.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kmer_device.cuh"

namespace {

using vgk::bucket_shift;
using vgk::find_key;
using vgk::hash64;
using vgk::roll;
using vgk::u64;

// threads per block; blocks are capped at 64 per SM of an H100 (132 SMs) and
// walk the rest in a grid-stride loop
constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132L * 64;

__device__ __forceinline__ unsigned base_at(const unsigned char* __restrict__ row,
                                            int i) {
  return (__ldg(row + (i >> 2)) >> ((i & 3) << 1)) & 3u;
}

__global__ void count_join_kernel(int* __restrict__ cov,
                                  const u64* __restrict__ keys, long m,
                                  const int* __restrict__ dir, int bits,
                                  const u64* __restrict__ queries,
                                  const unsigned char* __restrict__ mask,
                                  long nq) {
  const int shift = bucket_shift(keys, m, bits);
  const long stride = (long)gridDim.x * blockDim.x;
  for (long j = (long)blockIdx.x * blockDim.x + threadIdx.x; j < nq;
       j += stride) {
    if (!mask[j]) continue;
    const long i = find_key(keys, dir, bits, shift, queries[j]);
    if (i >= 0) atomicAdd(cov + i, 1);
  }
}

__global__ void count_packed_kernel(int* __restrict__ cov,
                                    const u64* __restrict__ keys, long m,
                                    const int* __restrict__ dir, int bits,
                                    const unsigned char* __restrict__ packed,
                                    long nrows, long row_bytes, int k) {
  const int lane = threadIdx.x & 31;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  const int shift = bucket_shift(keys, m, bits);
  const u64 kmask = (1ull << (2 * k)) - 1;
  const int top = 2 * (k - 1);
  const int width = (int)(row_bytes - 2) * 4;  // bases a row can hold
  for (long r = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < nrows;
       r += nwarps) {
    const unsigned char* row = packed + r * row_bytes;
    const int len = min((int)__ldg(row + row_bytes - 2) |
                            ((int)__ldg(row + row_bytes - 1) << 8),
                        width);
    if (len < k) continue;  // no window of the row is complete
    const int per = (len + 31) >> 5;
    const int s = lane * per;  // this lane's positions are [s, e)
    const int e = min(s + per, len);
    if (s >= e) continue;
    u64 fwd = 0, rev = 0;
    for (int i = max(0, s - (k - 1)); i < s; ++i)
      roll(fwd, rev, base_at(row, i), kmask, top);
    for (int i = s; i < e; ++i) {
      roll(fwd, rev, base_at(row, i), kmask, top);
      if (i < k - 1 || fwd == rev) continue;  // incomplete, or a palindrome
      const u64 v = (hash64(fwd < rev ? fwd : rev, kmask) << 8) | (u64)k;
      const long idx = find_key(keys, dir, bits, shift, v);
      if (idx >= 0) atomicAdd(cov + idx, 1);
    }
  }
}

long grid_for(long threads_needed) {
  long blocks = (threads_needed + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = the launch was accepted).  m == 0, nq == 0 or nrows == 0 launches
// nothing.  dir holds 2^bits + 1 int32 entries, 1 <= bits <= 62, m < 2^31.

extern "C" int vg_count_join(void* cov, const void* keys, long m,
                             const void* dir, int bits, const void* queries,
                             const void* mask, long nq, void* stream) {
  if (m == 0 || nq == 0) return 0;
  count_join_kernel<<<(unsigned)grid_for(nq), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (int*)cov, (const u64*)keys, m, (const int*)dir, bits,
      (const u64*)queries, (const unsigned char*)mask, nq);
  return (int)cudaGetLastError();
}

// packed: uint8 [nrows, row_bytes], row_bytes = L/4 + 2; 1 <= k <= 28.
extern "C" int vg_count_packed(void* cov, const void* keys, long m,
                               const void* dir, int bits, const void* packed,
                               long nrows, long row_bytes, int k,
                               void* stream) {
  if (m == 0 || nrows == 0) return 0;
  count_packed_kernel<<<(unsigned)grid_for(nrows * 32), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (int*)cov, (const u64*)keys, m, (const int*)dir, bits,
      (const unsigned char*)packed, nrows, row_bytes, k);
  return (int)cudaGetLastError();
}
