// Construct's genome and context sketches for Hopper (sm_90a).
//
//   vg_key_bitmap       the keys' occupancy bitmap: bit v >> s set for each
//                       key v (s as key_directory's shift, for bbits bits)
//   vg_count_codes      cov[i] += #{ windows of the genome rows [row0, row0 +
//                       nrows) of a chromosome's base codes whose canonical
//                       k-mer encodes to keys[i] }
//   vg_context_short    each context of at most kCtxTile windows: its unique
//                       values in unsigned order at out[offsets[c]...],
//                       their number at counts[c]; -1 for a longer context,
//                       counted in status[1]; status[0] set on bad offsets
//   vg_context_counts   the long route, for the contexts listed in ids:
//                       counts[j] = #{ windows of context ids[j] that emit }
//   vg_context_values   those windows' values, context ids[j]'s from
//                       out[starts[j]]
//   vg_context_compact  the CSR: context c's counts[c] values moved from
//                       out[offsets[c]] to values[starts[c]]
//
// Codes are 0..3 (bases) and 4 (ambiguous); values are the uint64 encodings
// hash64(canonical) << 8 | k (csrc/kmer_device.cuh), unsigned throughout, so
// k = 28 values with bit 63 set order, sort and look up correctly.
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
//   * the context kernels: sketch_codes as _sketch_contexts
//     (varigraph_tpu/index/build.py:162) uses it on the distinct haplotype
//     contexts of construct and of the graph.bin load, with the per-context
//     np.unique behind it.  Here the contexts arrive as one concatenated code
//     buffer with int64 offsets, unpadded.
//
// What bounds each on an H100, and what the design does about it.
//   * count_codes reads one byte a base and, per emitted window, hashes it
//     (hash64, 64-bit integer operations) and looks it up: a directory
//     sector, ~2 key sectors and, on a hit, a 4-byte atomic.  Against a
//     table in L2 its floor is the integer operations; in practice the
//     lookups' sectors set its pace (timed alone on a 50 Mb chromosome, a
//     thread a row sketching from device memory with one lookup in flight,
//     the lookups take ~90% of the time, the row sketch ~10%; PERF.md §6).
//     So:
//       - a window first tests its bit in the keys' occupancy bitmap (at
//         most 2^27 bits, 16 MB, built once a table by vg_key_bitmap: the
//         top bits below the largest key's highest, as the directory cuts
//         them, 2^5 bits a key or more); a clear bit is a miss, one sector
//         in L2, and a set bit goes on to the search, so counts stay
//         exact.  Most windows of a genome hit no candidate;
//       - a CTA stages the contiguous span of its 256 rows (rows overlap by
//         k - 1 bases) in shared memory with 16-byte loads, and a thread
//         sketches its row from there, where byte loads from device
//         memory, 134 bytes apart across a warp, would each reach a sector
//         of their own;
//       - a thread sketches kBatch positions of its row, then looks their
//         values up together: all directory loads first, then each search
//         step's key loads, then the final compares, so kBatch independent
//         lookups are in flight, not one.
//     A row restarts both registers and the run counter at its first base,
//     as the JAX rows do.  Integer atomics make the counts exact whatever
//     the order, a poly-A run included; the 255 cap is the caller's.
//   * the context sketch reads one byte a base and writes 8 bytes an
//     emitted window: bound by those bytes and by the registers' and the
//     hash's integer operations.  A context may be of any length (a
//     structural variant makes one tens of kb to Mb long), but almost all
//     are ~k to ~130 bases, emitting fewer than 3 values a lane.  One warp
//     takes one context.  A context of at most kCtxTile windows (the short
//     route, one launch for all of them) is copied into the warp's shared
//     memory, sketched from there into the warp's value tile, sorted there
//     as unsigned u64 by a bitonic network, stripped of adjacent
//     duplicates and written at out[offsets[c]...]: a context of len bases
//     emits at most len - k + 1 values, so its slot range needs no count
//     pass.  A compaction then moves each context's values to its CSR
//     place.  A longer context takes the long route, chosen by length: the
//     count and values passes over the same warp scans, then the wrapper's
//     torch sort of those contexts' values alone.
//     Within a warp the lanes take runs of per = min(32, ceil(len / 32))
//     consecutive positions of a tile of 32 * per.  A lane cannot start its
//     run from zeroed registers (an ambiguous base leaves the registers as
//     they were, so its window may reach back past any number of ambiguous
//     bases), nor from a zeroed run counter (a palindrome neither advances
//     nor resets it).  So the lanes compose the two associative scans of
//     the JAX sketch_codes (varigraph_tpu/ops/kmer.py:102-132) with warp
//     shuffles:
//       1. each lane folds its run into the registers' element (m, vf, vr),
//          a shuffle scan gives each lane the registers before its run;
//       2. each lane rolls its run from those registers and folds the run
//          counter's element (reset, count), a shuffle scan gives each lane
//          the counter before its run;
//       3. each lane sketches its run from that state, one base a step in
//          every lane, and a ballot gives each emitted value its slot.
//     A short context is one tile; on the long route each scan's total is
//     carried from tile to tile.
//
// The kernels allocate nothing: the wrappers pass every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "kmer_device.cuh"

namespace {

using vgk::bitmap_test;
using vgk::bucket_shift;
using vgk::find_keys;
using vgk::hash64;
using vgk::kGenomeCols;
using vgk::roll;
using vgk::u64;

// threads per block; blocks are capped at 64 per SM of an H100 (132 SMs) and
// walk the rest in a grid-stride loop
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long kMaxBlocks = 132L * 64;
constexpr int kMaxPer = 32;  // positions a lane takes in a context's tile
constexpr unsigned kFull = 0xffffffffu;
// count_codes: a CTA's rows (one a thread), the lookups a thread keeps in
// flight, and the staged span: 255 steps and a row, at most 16 bytes of
// alignment before it
constexpr int kBatch = 8;
constexpr int kStage = (kThreads - 1) * kGenomeCols + kGenomeCols + 16;
// the short context route: windows a warp's tile holds (a power of two),
// and the bases of its longest context, k - 1 more (k <= 28)
constexpr int kCtxTile = 512;
constexpr int kCtxBases = kCtxTile + 32;

long grid_for(long threads_needed) {
  const long blocks = (threads_needed + kThreads - 1) / kThreads;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

// ---------------------------------------------------------------- count_codes

// Looks up the values v[j] with em[j] set and adds one to cov at each found
// key: the bitmap's tests, their loads issued together, then
// vgk::find_keys over the values whose bit is set.
template <int B>
__device__ __forceinline__ void count_batch(int* __restrict__ cov,
                                            const u64* __restrict__ keys,
                                            const int* __restrict__ dir,
                                            int bits, int shift,
                                            const unsigned* __restrict__ bitmap,
                                            int bbits, int bshift,
                                            const u64 (&v)[B],
                                            const bool (&em)[B]) {
  bool look[B];
#pragma unroll
  for (int j = 0; j < B; ++j)
    look[j] = em[j] && bitmap_test(bitmap, bbits, bshift, v[j]);
  int idx[B];
  find_keys<B>(keys, dir, bits, shift, v, look, idx);
#pragma unroll
  for (int j = 0; j < B; ++j)
    if (idx[j] >= 0) atomicAdd(cov + idx[j], 1);
}

// One CTA stages its rows' span, then a thread sketches a row kBatch
// positions at a time and counts each batch's values (see above).
__global__ void __launch_bounds__(kThreads)
    count_codes_kernel(int* __restrict__ cov, const u64* __restrict__ keys,
                       long m, const int* __restrict__ dir, int bits,
                       const unsigned* __restrict__ bitmap, int bbits,
                       const unsigned char* __restrict__ codes, long n,
                       long row0, long nrows, int k) {
  __shared__ __align__(16) unsigned char stage[kStage];
  const long step = kGenomeCols - (k - 1);
  const long first = row0 + (long)blockIdx.x * kThreads;  // the CTA's first row
  const long rows = min((long)kThreads, row0 + nrows - first);
  // codes[a, b) in the frame of the 16-byte-aligned address below codes:
  // stage[x - a0] holds frame[x] for x in [a, b)
  const int mis = (int)((uintptr_t)codes & 15);
  const unsigned char* frame = codes - mis;
  const long a = first * step + mis;
  const long b = min(n, (first + rows - 1) * step + kGenomeCols) + mis;
  const long a0 = a & ~15L;
  for (long q = threadIdx.x; q < (b - a0 + 15) >> 4; q += kThreads) {
    const long x = a0 + 16 * q;
    if (x >= a && x + 16 <= b) {
      *reinterpret_cast<uint4*>(stage + 16 * q) =
          __ldg(reinterpret_cast<const uint4*>(frame + x));
    } else {
      for (int j = 0; j < 16; ++j)
        if (x + j >= a && x + j < b) stage[16 * q + j] = frame[x + j];
    }
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;
  const long g = (first + threadIdx.x) * step;  // the row's first base
  const int len = (int)min((long)kGenomeCols, n - g);
  const unsigned char* s = stage + (g + mis - a0);
  const int shift = bucket_shift(keys, m, bits);
  const int bshift = bucket_shift(keys, m, bbits);
  const u64 kmask = (1ull << (2 * k)) - 1;
  const int top = 2 * (k - 1);
  u64 fwd = 0, rev = 0;
  int run = 0;
  for (int p0 = 0; p0 < len; p0 += kBatch) {
    u64 v[kBatch];
    bool em[kBatch];
    bool any = false;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      em[j] = false;
      v[j] = 0;
      if (p0 + j < len) {
        const unsigned c = s[p0 + j];
        if (c > 3u) {
          run = 0;
        } else {
          roll(fwd, rev, c, kmask, top);
          // a palindrome neither advances nor resets the run counter
          if (fwd != rev && ++run >= k) {
            em[j] = true;
            v[j] = (hash64(fwd < rev ? fwd : rev, kmask) << 8) | (u64)k;
          }
        }
      }
      any |= em[j];
    }
    if (any)
      count_batch<kBatch>(cov, keys, dir, bits, shift, bitmap, bbits, bshift,
                          v, em);
  }
}

// One thread a key: its bit in the occupancy bitmap (see above); the words
// start zeroed.
__global__ void __launch_bounds__(kThreads)
    key_bitmap_kernel(const u64* __restrict__ keys, long m, int bbits,
                      unsigned* __restrict__ words) {
  const int bshift = bucket_shift(keys, m, bbits);
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    const u64 q = __ldg(keys + i) >> bshift;
    atomicOr(words + (q >> 5), 1u << (q & 31));
  }
}

// ------------------------------------------------------------- context sketch

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

// The three steps above on the tile of positions [t0, min(t0 + 32 per, e)):
// ld(i) is the code at position i; put(slot, v) takes each emitted value,
// its slot counted on from `cursor`.  Returns the cursor past the tile.
template <class Load, class Put>
__device__ __forceinline__ long sketch_tile(Load&& ld, long t0, long e,
                                            int per, int k, int lane,
                                            Regs& regs_carry, Seg& run_carry,
                                            long cursor, Put&& put) {
  const u64 kmask = (1ull << (2 * k)) - 1;
  const int top = 2 * (k - 1);
  const unsigned below = (1u << lane) - 1u;
  const long s = min(t0 + (long)lane * per, e);
  const long se = min(s + per, e);
  // 1. the registers before this lane's run
  Regs x{0, 0, 0};
  for (long i = s; i < se; ++i) {
    const unsigned ch = ld(i);
    if (ch > 3u) continue;
    roll(x.vf, x.vr, ch, kmask, top);
    x.m = min(x.m + 1, k);
  }
  const Regs pre = warp_prefix(
      x, regs_carry, lane,
      [&](const Regs& p, const Regs& q) { return combine(p, q, k, kmask); });
  // 2. the run counter before this lane's run
  Seg g{0, 0};
  u64 fwd = pre.vf, rev = pre.vr;
  for (long i = s; i < se; ++i) {
    const unsigned ch = ld(i);
    if (ch > 3u) {
      g = Seg{1, 0};
      continue;
    }
    roll(fwd, rev, ch, kmask, top);
    g.s += fwd != rev;
  }
  const Seg before = warp_prefix(
      g, run_carry, lane, [](const Seg& p, const Seg& q) { return combine(p, q); });
  // 3. the sketch of this lane's run, one base a step in every lane
  fwd = pre.vf;
  rev = pre.vr;
  int run = before.s;
  for (int j = 0; j < per; ++j) {
    const long i = s + j;
    bool emits = false;
    u64 v = 0;
    if (i < se) {
      const unsigned ch = ld(i);
      if (ch > 3u) {
        run = 0;
      } else {
        roll(fwd, rev, ch, kmask, top);
        if (fwd != rev && ++run >= k) {
          emits = true;
          v = (hash64(fwd < rev ? fwd : rev, kmask) << 8) | (u64)k;
        }
      }
    }
    const unsigned ballot = __ballot_sync(kFull, emits);
    if (emits) put(cursor + __popc(ballot & below), v);
    cursor += __popc(ballot);
  }
  return cursor;
}

// The short route: one warp a context of at most kCtxTile windows, its
// codes and values in the warp's shared memory (see above).  Checks the
// offsets on the way: status[0] = 1 where offsets[0] != 0 or a context
// ends before it starts or past the codes (that context is skipped); a
// longer context gets counts[c] = -1 and one in status[1].
__global__ void __launch_bounds__(kThreads)
    context_short_kernel(const unsigned char* __restrict__ codes, long n_codes,
                         const long long* __restrict__ offsets, long nctx,
                         int k, long long* __restrict__ counts,
                         u64* __restrict__ out, int* __restrict__ status) {
  __shared__ u64 tiles[kWarps][kCtxTile];
  __shared__ unsigned char bases[kWarps][kCtxBases];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  u64* tile = tiles[threadIdx.x >> 5];
  unsigned char* cb = bases[threadIdx.x >> 5];
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  for (long c = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < nctx;
       c += nwarps) {
    const long b = (long)__ldg(offsets + c), e = (long)__ldg(offsets + c + 1);
    if ((c == 0 && b != 0) || b < 0 || e < b || e > n_codes) {
      if (lane == 0) {
        status[0] = 1;
        counts[c] = 0;
      }
      continue;
    }
    const int len = (int)min(e - b, (long)kCtxBases);
    // fewer than k bases never emit; more than the tile's take the long route
    if (e - b - k + 1 > kCtxTile) {
      if (lane == 0) {
        counts[c] = -1;
        atomicAdd(status + 1, 1);
      }
      continue;
    }
    if (len < k) {
      if (lane == 0) counts[c] = 0;
      continue;
    }
    for (int i = lane; i < len; i += 32) cb[i] = __ldg(codes + b + i);
    __syncwarp();
    Regs regs_carry{0, 0, 0};
    Seg run_carry{0, 0};
    const int n = (int)sketch_tile(
        [&](long i) { return (unsigned)cb[i]; }, 0, len, (len + 31) >> 5, k,
        lane, regs_carry, run_carry, 0, [&](long slot, u64 v) { tile[slot] = v; });
    // the bitonic network over the next power of two, padded with ~0
    int p2 = 1;
    while (p2 < n) p2 <<= 1;
    for (int i = n + lane; i < p2; i += 32) tile[i] = ~0ull;
    __syncwarp();
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride; stride >>= 1) {
        for (int q = lane; q < p2 >> 1; q += 32) {
          const int lo = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
          const u64 x = tile[lo], y = tile[lo + stride];
          if ((x > y) == !(lo & size)) {
            tile[lo] = y;
            tile[lo + stride] = x;
          }
        }
        __syncwarp();
      }
    }
    // adjacent duplicates dropped, the uniques written at out[b...]
    long unique = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const bool keep = i < n && (i == 0 || tile[i] != tile[i - 1]);
      const unsigned ballot = __ballot_sync(kFull, keep);
      if (keep) out[b + unique + __popc(ballot & below)] = tile[i];
      unique += __popc(ballot);
    }
    if (lane == 0) counts[c] = unique;
    __syncwarp();
  }
}

// The long route: one warp a context of ids, tile after tile.  With kWrite,
// context ids[j]'s values go to out[starts[j]...]; without, counts[j] is the
// number it emits.
template <bool kWrite>
__global__ void __launch_bounds__(kThreads)
    context_kernel(const unsigned char* __restrict__ codes,
                   const long long* __restrict__ offsets,
                   const long long* __restrict__ ids, long nids, int k,
                   long long* __restrict__ counts,
                   const long long* __restrict__ starts,
                   u64* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  for (long j = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; j < nids;
       j += nwarps) {
    const long c = (long)__ldg(ids + j);
    const long b = (long)__ldg(offsets + c), e = (long)__ldg(offsets + c + 1);
    long cursor = kWrite ? (long)__ldg(starts + j) : 0;
    // fewer than k bases never emit
    const int per = e - b < k ? 0 : (int)min((long)kMaxPer, (e - b + 31) >> 5);
    Regs regs_carry{0, 0, 0};
    Seg run_carry{0, 0};
    for (long t0 = b; per && t0 < e; t0 += 32L * per) {
      cursor = sketch_tile(
          [&](long i) { return (unsigned)__ldg(codes + i); }, t0, e, per, k,
          lane, regs_carry, run_carry, cursor, [&](long slot, u64 v) {
            if (kWrite) out[slot] = v;
          });
    }
    if (!kWrite && lane == 0) counts[j] = cursor;
  }
}

// One warp a context: counts c's values from out[offsets[c]] to
// values[starts[c]], counts c = starts[c + 1] - starts[c].
__global__ void __launch_bounds__(kThreads)
    context_compact_kernel(const u64* __restrict__ out,
                           const long long* __restrict__ offsets,
                           const long long* __restrict__ starts, long nctx,
                           u64* __restrict__ values) {
  const int lane = threadIdx.x & 31;
  const long nwarps = ((long)gridDim.x * blockDim.x) >> 5;
  for (long c = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < nctx;
       c += nwarps) {
    const long src = (long)__ldg(offsets + c), dst = (long)__ldg(starts + c);
    const long n = (long)__ldg(starts + c + 1) - dst;
    for (long i = lane; i < n; i += 32) values[dst + i] = __ldg(out + src + i);
  }
}

}  // namespace

// Each entry launches on `stream` and returns cudaGetLastError() as an int
// (0 = the launch was accepted); one with nothing to do launches nothing.
// The wrappers (ops/sketch_cuda.py) check the rest.

// cov: int32 [m]; keys: uint64 [m], unique and sorted; dir: int32
// [2^bits + 1], 1 <= bits <= 62, m < 2^31; bitmap: uint32 [2^bbits / 32],
// the keys' vg_key_bitmap; codes: uint8 [n_codes], a chromosome's base
// codes; rows [row0, row0 + nrows) of its segmentation; 1 <= k <= 28.
extern "C" int vg_count_codes(void* cov, const void* keys, long m,
                              const void* dir, int bits, const void* bitmap,
                              int bbits, const void* codes, long n_codes,
                              long row0, long nrows, int k, void* stream) {
  if (m == 0 || nrows == 0) return 0;
  if (k < 1 || k > 28 || bbits < 5 || bbits > 62)
    return (int)cudaErrorInvalidValue;
  count_codes_kernel<<<(unsigned)((nrows + kThreads - 1) / kThreads), kThreads,
                       0, (cudaStream_t)stream>>>(
      (int*)cov, (const u64*)keys, m, (const int*)dir, bits,
      (const unsigned*)bitmap, bbits, (const unsigned char*)codes, n_codes,
      row0, nrows, k);
  return (int)cudaGetLastError();
}

// keys: uint64 [m], unique and sorted, m >= 1; words: uint32
// [2^bbits / 32], zeroed; 5 <= bbits <= 62.
extern "C" int vg_key_bitmap(const void* keys, long m, int bbits, void* words,
                             void* stream) {
  if (m == 0) return 0;
  if (bbits < 5 || bbits > 62) return (int)cudaErrorInvalidValue;
  key_bitmap_kernel<<<(unsigned)grid_for(m), kThreads, 0,
                      (cudaStream_t)stream>>>((const u64*)keys, m, bbits,
                                              (unsigned*)words);
  return (int)cudaGetLastError();
}

// codes: uint8 [n_codes], the contexts one after another; offsets: int64
// [nctx + 1], context c is codes[offsets[c], offsets[c + 1]) (checked, see
// context_short_kernel); counts: int64 [nctx]; out: uint64 [n_codes];
// status: int32 [2], zeroed; tile must be kCtxTile (the wrapper's
// CONTEXT_TILE); 1 <= k <= 28.
extern "C" int vg_context_short(const void* codes, long n_codes,
                                const void* offsets, long nctx, int k,
                                int tile, void* counts, void* out,
                                void* status, void* stream) {
  if (tile != kCtxTile || k < 1 || k > 28) return (int)cudaErrorInvalidValue;
  if (nctx == 0) return 0;
  context_short_kernel<<<(unsigned)grid_for(nctx * 32), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const unsigned char*)codes, n_codes, (const long long*)offsets, nctx,
      k, (long long*)counts, (u64*)out, (int*)status);
  return (int)cudaGetLastError();
}

// ids: int64 [nids], contexts (as above); counts: int64 [nids].
extern "C" int vg_context_counts(const void* codes, const void* offsets,
                                 const void* ids, long nids, int k,
                                 void* counts, void* stream) {
  if (nids == 0) return 0;
  if (k < 1 || k > 28) return (int)cudaErrorInvalidValue;
  context_kernel<false><<<(unsigned)grid_for(nids * 32), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const unsigned char*)codes, (const long long*)offsets,
      (const long long*)ids, nids, k, (long long*)counts, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// starts: int64 [nids], context ids[j]'s first slot in out (the exclusive
// scan of vg_context_counts' counts); out: uint64 [the counts' sum].
extern "C" int vg_context_values(const void* codes, const void* offsets,
                                 const void* ids, long nids, int k,
                                 const void* starts, void* out, void* stream) {
  if (nids == 0) return 0;
  if (k < 1 || k > 28) return (int)cudaErrorInvalidValue;
  context_kernel<true><<<(unsigned)grid_for(nids * 32), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const unsigned char*)codes, (const long long*)offsets,
      (const long long*)ids, nids, k, nullptr, (const long long*)starts,
      (u64*)out);
  return (int)cudaGetLastError();
}

// out: uint64 as vg_context_short left it; starts: int64 [nctx + 1], the
// scan of the unique counts; values: uint64 [starts[nctx]].
extern "C" int vg_context_compact(const void* out, const void* offsets,
                                  const void* starts, long nctx, void* values,
                                  void* stream) {
  if (nctx == 0) return 0;
  context_compact_kernel<<<(unsigned)grid_for(nctx * 32), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const u64*)out, (const long long*)offsets, (const long long*)starts,
      nctx, (u64*)values);
  return (int)cudaGetLastError();
}
