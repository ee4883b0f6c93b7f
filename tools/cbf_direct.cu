// The direct fused apply of construct's genome count, kept for the
// comparison in tools/cbf_ab.py: the package's cbf_add_codes
// (varigraph_tpu_torch/csrc/cbf.cu) stages its updates in shared memory, and
// this kernel makes them straight in device memory.
//
// One thread a genome row sketches it in registers (the same sketch_row) and,
// for every emitted window and every seed whose position p falls in the
// shard, makes the saturating +1 of filter[p - lo] with atomicCAS on the
// 32-bit word that holds the byte: no load first, the first CAS guesses that
// the word is 0 and a miss retries with the value it returns.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libcbfdirect.so tools/cbf_direct.cu

#include <cuda_runtime.h>

#include "../varigraph_tpu_torch/csrc/cbf_device.cuh"

namespace {

using vgcbf::u64;

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132L * 64;

__global__ void __launch_bounds__(kThreads)
    direct_add_codes(unsigned char* __restrict__ filter, u64 m, u64 mmask,
                     u64 lo, u64 m_local, const unsigned char* __restrict__ codes,
                     long n, long row0, long nrows, int k,
                     const u64* __restrict__ seeds, int kh) {
  __shared__ u64 s_seeds[16];
  if (threadIdx.x < kh) s_seeds[threadIdx.x] = __ldg(seeds + threadIdx.x);
  __syncthreads();
  const long stride = (long)gridDim.x * blockDim.x;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < nrows;
       r += stride) {
    vgk::sketch_row(codes, n, row0 + r, k, [&](u64 v) {
      for (int s = 0; s < kh; ++s) {
        const u64 local = vgcbf::position(v, s_seeds[s], m, mmask) - lo;
        if (local >= m_local) continue;
        unsigned* word = reinterpret_cast<unsigned*>(filter + (local & ~3ULL));
        const unsigned shift = (unsigned)(local & 3ULL) * 8u;
        unsigned old = atomicCAS(word, 0u, 1u << shift);
        while (old != 0u && ((old >> shift) & 0xffu) != 0xffu) {
          const unsigned assumed = old;
          old = atomicCAS(word, assumed, assumed + (1u << shift));
          if (old == assumed) break;
        }
      }
    });
  }
}

}  // namespace

extern "C" int vg_cbf_direct_add_codes(void* filter, long m, long lo,
                                       long m_local, const void* codes,
                                       long n, long row0, long nrows, int k,
                                       const void* seeds, int kh,
                                       void* stream) {
  if (nrows == 0 || m_local == 0) return 0;
  if (kh < 1 || kh > 16) return (int)cudaErrorInvalidValue;
  long blocks = (nrows + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  const u64 mmask = (m & (m - 1)) == 0 ? (u64)(m - 1) : 0ULL;
  direct_add_codes<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (unsigned char*)filter, (u64)m, mmask, (u64)lo, (u64)m_local,
      (const unsigned char*)codes, n, row0, nrows, k, (const u64*)seeds, kh);
  return (int)cudaGetLastError();
}
