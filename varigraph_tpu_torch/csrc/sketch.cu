// Construct's genome and context sketches for Hopper (sm_90a).
//
//   vg_count_codes     cov[i] += #{ windows of the genome rows [row0, row0 +
//                      nrows) of a chromosome's base codes whose canonical
//                      k-mer encodes to keys[i] }
//   vg_context_counts  counts[c] = #{ windows of context c that emit }
//   vg_context_values  those windows' values, context c's from out[starts[c]]
//
// Codes are 0..3 (bases) and 4 (ambiguous); values are the uint64 encodings
// hash64(canonical) << 8 | k (csrc/kmer_device.cuh), unsigned throughout, so
// k = 28 values with bit 63 set order and look up correctly.
//
// Replaces, on the TPU side, the XLA sketch_codes (varigraph_tpu/ops/kmer.py:79)
// on construct's two paths that still ran it as step-by-step torch operations:
//   * vg_count_codes: _count_codes_stack (varigraph_tpu/ops/exact_count.py:44),
//     the sketch of a stack of genome rows and the join of every emitted
//     window against the sorted candidate keys (count_merge_super), which is
//     construct's exact genome count above 2^31 filter cells (every genome
//     above ~224 Mb on one card).  The rows are those of ops/cbf.genome_rows
//     (the JAX segment_genome_batches), cut arithmetically from one copy of
//     the chromosome, as vg_cbf_add_codes (csrc/cbf.cu) cuts them.
//   * vg_context_counts / vg_context_values: sketch_codes as _sketch_contexts
//     (varigraph_tpu/index/build.py:162) uses it on the distinct haplotype
//     contexts of construct and of the graph.bin load, which the JAX package
//     pads to power-of-two length buckets.  Here the contexts arrive as one
//     concatenated code buffer with int64 offsets, unpadded; the wrapper
//     (ops/sketch_cuda.sketch_contexts) scans the counts into write offsets
//     and, after the values pass, sorts and deduplicates each context's values
//     with torch calls.
//
// What bounds each on an H100, and what the design does about it.
//   * count_codes reads one byte a base and, per emitted window, hashes it
//     (hash64, 64-bit integer operations) and looks it up: a directory
//     sector, a key sector and, on a hit, a 4-byte atomic.  By the card's
//     peak rates it is bound by the bytes those lookups touch against a
//     large table and by the integer operations against one in L2.  Like
//     vg_count_packed (csrc/join.cu), its pace is set in practice by the
//     lookups' per-lane loads; many warps in flight hide their latency.  One
//     thread sketches one 160-base row in registers (RowSketch, the
//     reference's sequential form with its rule for ambiguous bases), so the
//     sketch's values and mask are never written: the old path wrote 9 bytes
//     a window and read them back.  A row restarts both registers and the
//     run counter at its first base, as the JAX rows do.  Integer atomics
//     make the counts exact whatever the order, a poly-A run included; the
//     255 cap is the caller's, after the count.
//   * the context sketch reads one byte a base and writes 8 bytes an emitted
//     window: bound by those bytes, and by the registers' and the hash's
//     integer operations.  A context may be of any length: a structural
//     variant makes one tens of kb to Mb long, while most are ~k to ~130
//     bases.  One warp takes one context, each lane a run of
//     per = min(32, ceil(len / 32)) consecutive positions of a tile of
//     32 * per, tile after tile.  A lane cannot start its run from zeroed
//     registers (an ambiguous base leaves the registers as they were, so
//     its window may reach back past any number of ambiguous bases), nor
//     from a zeroed run counter (a palindrome neither advances nor resets
//     it).  So the lanes compose the two associative scans of the JAX
//     sketch_codes (varigraph_tpu/ops/kmer.py:102-132) with warp shuffles:
//       1. each lane folds its run into the registers' element (m, vf, vr),
//          a shuffle scan gives each lane the registers before its run;
//       2. each lane rolls its run from those registers and folds the run
//          counter's element (reset, count), a shuffle scan gives each lane
//          the counter before its run;
//       3. each lane sketches its run from that state, one base a step in
//          every lane, and a ballot gives each emitted value its slot.
//     Each scan's total is carried from tile to tile.  So a 1 Mb context
//     keeps a whole warp busy, where one thread a context would leave it to
//     one lane, and a short context takes one tile.  The values pass writes
//     a context's values in an order fixed by the lanes and the steps, so the
//     output is deterministic before the sort.
//
// The kernels allocate nothing: the wrapper passes counts and out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kmer_device.cuh"

namespace {

using vgk::bucket_shift;
using vgk::find_key;
using vgk::roll;
using vgk::u64;

// threads per block; blocks are capped at 64 per SM of an H100 (132 SMs) and
// walk the rest in a grid-stride loop
constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132L * 64;
constexpr int kMaxPer = 32;  // positions a lane takes in a context's tile
constexpr unsigned kFull = 0xffffffffu;

long grid_for(long threads_needed) {
  const long blocks = (threads_needed + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

__global__ void __launch_bounds__(kThreads)
    count_codes_kernel(int* __restrict__ cov, const u64* __restrict__ keys,
                       long m, const int* __restrict__ dir, int bits,
                       const unsigned char* __restrict__ codes, long n,
                       long row0, long nrows, int k) {
  const int shift = bucket_shift(keys, m, bits);
  const long stride = (long)gridDim.x * blockDim.x;
  for (long r = (long)blockIdx.x * blockDim.x + threadIdx.x; r < nrows;
       r += stride) {
    vgk::sketch_row(codes, n, row0 + r, k, [&](u64 v) {
      const long i = find_key(keys, dir, bits, shift, v);
      if (i >= 0) atomicAdd(cov + i, 1);
    });
  }
}

// The registers' element of a run of bases: m, its bases (at most k), and
// vf, vr, the registers that the run alone leaves (both 0 before it).  An
// ambiguous base is the identity (0, 0, 0).  combine(a, b) is the element of
// a followed by b.
struct Regs {
  u64 vf, vr;
  int m;
};

__device__ __forceinline__ Regs combine(const Regs& a, const Regs& b, int k,
                                        u64 kmask) {
  const int sh = 2 * b.m;
  return Regs{((a.vf << sh) | b.vf) & kmask, (a.vr >> sh) | b.vr,
              min(a.m + b.m, k)};
}

__device__ __forceinline__ Regs shfl_up(const Regs& x, int d) {
  return Regs{__shfl_up_sync(kFull, x.vf, d), __shfl_up_sync(kFull, x.vr, d),
              __shfl_up_sync(kFull, x.m, d)};
}

__device__ __forceinline__ Regs shfl(const Regs& x, int lane) {
  return Regs{__shfl_sync(kFull, x.vf, lane), __shfl_sync(kFull, x.vr, lane),
              __shfl_sync(kFull, x.m, lane)};
}

// The run counter's element of a run of bases: f, whether it holds an
// ambiguous base, and s, its non-palindromic bases after the last ambiguous
// one (after its start when it has none).
struct Seg {
  int f, s;
};

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  return Seg{a.f | b.f, b.f ? b.s : a.s + b.s};
}

__device__ __forceinline__ Seg shfl_up(const Seg& x, int d) {
  return Seg{__shfl_up_sync(kFull, x.f, d), __shfl_up_sync(kFull, x.s, d)};
}

__device__ __forceinline__ Seg shfl(const Seg& x, int lane) {
  return Seg{__shfl_sync(kFull, x.f, lane), __shfl_sync(kFull, x.s, lane)};
}

// The warp's exclusive prefix of each lane's element after `carry` (the
// elements of the tiles before), and `carry` moved past the whole warp.
template <class T, class Combine>
__device__ __forceinline__ T warp_prefix(T x, T& carry, int lane,
                                         Combine&& op) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up(x, d);
    if (lane >= d) x = op(y, x);
  }
  T before = shfl_up(x, 1);
  const T pre = lane ? op(carry, before) : carry;
  carry = op(carry, shfl(x, 31));
  return pre;
}

// One warp a context (see above).  With kWrite, context c's values go to
// out[starts[c]...]; without, counts[c] is the number it emits.
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
    context_kernel(const unsigned char* __restrict__ codes,
                   const long long* __restrict__ offsets, long nctx, int k,
                   long long* __restrict__ counts,
                   const long long* __restrict__ starts,
                   u64* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  const u64 kmask = (1ull << (2 * k)) - 1;
  const int top = 2 * (k - 1);
  const auto regs_op = [&](const Regs& a, const Regs& b) {
    return combine(a, b, k, kmask);
  };
  const auto seg_op = [](const Seg& a, const Seg& b) { return combine(a, b); };
  for (long c = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < nctx;
       c += nwarps) {
    const long b = (long)__ldg(offsets + c), e = (long)__ldg(offsets + c + 1);
    long cursor = kWrite ? (long)__ldg(starts + c) : 0;
    // fewer than k bases never emit
    const int per = e - b < k ? 0 : (int)min((long)kMaxPer, (e - b + 31) >> 5);
    Regs regs_carry{0, 0, 0};
    Seg run_carry{0, 0};
    for (long t0 = b; per && t0 < e; t0 += 32L * per) {
      const long s = min(t0 + (long)lane * per, e);
      const long se = min(s + per, e);
      // 1. the registers before this lane's run
      Regs x{0, 0, 0};
      for (long i = s; i < se; ++i) {
        const unsigned ch = __ldg(codes + i);
        if (ch > 3u) continue;
        roll(x.vf, x.vr, ch, kmask, top);
        x.m = min(x.m + 1, k);
      }
      const Regs pre = warp_prefix(x, regs_carry, lane, regs_op);
      // 2. the run counter before this lane's run
      Seg g{0, 0};
      u64 fwd = pre.vf, rev = pre.vr;
      for (long i = s; i < se; ++i) {
        const unsigned ch = __ldg(codes + i);
        if (ch > 3u) {
          g = Seg{1, 0};
          continue;
        }
        roll(fwd, rev, ch, kmask, top);
        g.s += fwd != rev;
      }
      const Seg run = warp_prefix(g, run_carry, lane, seg_op);
      // 3. the sketch of this lane's run, one base a step in every lane
      vgk::RowSketch sk(s, se, pre.vf, pre.vr, run.s);
      for (int j = 0; j < per; ++j) {
        u64 v = 0;
        const bool emits = sk.i < sk.end && sk.step(codes, k, kmask, top, v);
        const unsigned ballot = __ballot_sync(kFull, emits);
        if (kWrite && emits) out[cursor + __popc(ballot & below)] = v;
        cursor += __popc(ballot);
      }
    }
    if (!kWrite && lane == 0) counts[c] = cursor;
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = the launch was accepted); one with nothing to do launches nothing.
// The wrappers (ops/sketch_cuda.py) check the rest.

// cov: int32 [m]; keys: uint64 [m], unique and sorted; dir: int32
// [2^bits + 1], 1 <= bits <= 62, m < 2^31; codes: uint8 [n_codes], a
// chromosome's base codes; rows [row0, row0 + nrows) of its segmentation;
// 1 <= k <= 28.
extern "C" int vg_count_codes(void* cov, const void* keys, long m,
                              const void* dir, int bits, const void* codes,
                              long n_codes, long row0, long nrows, int k,
                              void* stream) {
  if (m == 0 || nrows == 0) return 0;
  if (k < 1 || k > 28) return (int)cudaErrorInvalidValue;
  count_codes_kernel<<<(unsigned)grid_for(nrows), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (int*)cov, (const u64*)keys, m, (const int*)dir, bits,
      (const unsigned char*)codes, n_codes, row0, nrows, k);
  return (int)cudaGetLastError();
}

// codes: uint8, the contexts one after another; offsets: int64 [nctx + 1],
// non-decreasing, context c is codes[offsets[c], offsets[c + 1]);
// counts: int64 [nctx]; 1 <= k <= 28.
extern "C" int vg_context_counts(const void* codes, const void* offsets,
                                 long nctx, int k, void* counts, void* stream) {
  if (nctx == 0) return 0;
  if (k < 1 || k > 28) return (int)cudaErrorInvalidValue;
  context_kernel<false><<<(unsigned)grid_for(nctx * 32), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const unsigned char*)codes, (const long long*)offsets, nctx, k,
      (long long*)counts, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// starts: int64 [nctx], context c's first slot in out (the exclusive scan of
// vg_context_counts' counts); out: uint64 [the counts' sum].
extern "C" int vg_context_values(const void* codes, const void* offsets,
                                 long nctx, int k, const void* starts,
                                 void* out, void* stream) {
  if (nctx == 0) return 0;
  if (k < 1 || k > 28) return (int)cudaErrorInvalidValue;
  context_kernel<true><<<(unsigned)grid_for(nctx * 32), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const unsigned char*)codes, (const long long*)offsets, nctx, k,
      nullptr, (const long long*)starts, (u64*)out);
  return (int)cudaGetLastError();
}
