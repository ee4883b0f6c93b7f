// Read k-mer counting join for Hopper (sm_90a).
//
//   cov[i] += #{ j : mask[j] && queries[j] == keys[i] }
//
// keys are unique and sorted as unsigned 64-bit values; queries and keys are
// the uint64 k-mer encodings (hash64 << 8 | k), which the torch side carries
// as int64 bit patterns.  Comparisons here are unsigned, so encodings with
// bit 63 set (k = 28) order correctly.
//
// Replaces, on the TPU side: the Pallas banded merge-join
// varigraph_tpu/ops/join_pallas.py (_band_kernel, launched by _band_counts
// inside count_merge_banded), which the JAX package uses for tables of up to
// 2M keys, and the two-sort count_merge_super (varigraph_tpu/ops/table.py)
// that it uses for larger tables.  Both have this contract, so one kernel
// serves every table size.
//
// What bounds it on an H100: each query does a binary search of ~log2(M)
// dependent 8-byte loads, then at most one 4-byte atomic.  The work is
// latency of dependent loads, not bandwidth or arithmetic.  At the 103,721-key
// test graph the 830 KB key array stays in the 50 MB L2, so each step is an
// L2 hit; at a 24M-key table (192 MB) it does not, and the deep levels of
// every search miss to HBM, which sets the pace.
//
// What the design does about it: one thread per query and many warps in
// flight hide the load latency by parallelism (a grid-stride loop over a grid
// sized to the card).  Masked-out queries return before any load.  Integer
// atomics make the result exact whatever the order, including a poly-A read
// that repeats one k-mer thousands of times in a batch -- the case that
// pushes the TPU kernel off its band onto its fallback.  No scratch memory:
// the kernel allocates nothing and writes only cov.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void count_join_kernel(int* __restrict__ cov,
                                  const unsigned long long* __restrict__ keys,
                                  long m,
                                  const unsigned long long* __restrict__ queries,
                                  const unsigned char* __restrict__ mask,
                                  long nq) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long j = (long)blockIdx.x * blockDim.x + threadIdx.x; j < nq;
       j += stride) {
    if (!mask[j]) continue;
    const unsigned long long v = queries[j];
    long lo = 0, hi = m;  // lower bound of v in keys[0, m)
    while (lo < hi) {
      const long mid = (lo + hi) >> 1;
      if (__ldg(keys + mid) < v) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < m && __ldg(keys + lo) == v) atomicAdd(cov + lo, 1);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted).  m == 0 or nq == 0 launches nothing.
extern "C" int vg_count_join(void* cov, const void* keys, long m,
                             const void* queries, const void* mask, long nq,
                             void* stream) {
  if (m == 0 || nq == 0) return 0;
  const int threads = 256;
  long blocks = (nq + threads - 1) / threads;
  const long max_blocks = 132L * 32;  // 32 blocks of 256 per SM of an H100
  if (blocks > max_blocks) blocks = max_blocks;
  count_join_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int*)cov, (const unsigned long long*)keys, m,
      (const unsigned long long*)queries, (const unsigned char*)mask, nq);
  return (int)cudaGetLastError();
}
