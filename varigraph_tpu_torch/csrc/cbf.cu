// Counting Bloom filter for Hopper (sm_90a): saturating adds and the
// min-count, over one shard of a filter of m cells.
//
//   shard      the cells [lo, lo + m_local) of the filter, stored from byte 0
//              of `filter`; the single-device filter is lo = 0, m_local = m
//   add        for every key j with mask[j] and every seed s whose position p
//   (vg_cbf_add)   (csrc/cbf_device.cuh) falls in the shard:
//                filter[p - lo] = min(filter[p - lo] + 1, 255)
//   add_codes  the same add over every k-mer that the genome rows of a
//   (vg_cbf_add_codes)  chromosome's base codes emit: rows [row0, row0 + nrows)
//                of the segmentation of ops/cbf.genome_rows,
//                each sketched from scratch (RowSketch, csrc/kmer_device.cuh)
//   count      out[j] = min over the seeds whose position falls in the shard of
//   (vg_cbf_count)  filter[p - lo], and 255 when none does; the minimum of the
//                shards' outputs is the count of the whole filter
//
// Replaces, on the TPU side, the XLA device functions of
// varigraph_tpu/ops/cbf.py: _positions (a vmap of Murmur3 over the seeds),
// _add (a dense uint32 histogram of all m cells, then a clamp and a
// full-filter combine) and _count (a gather and a min); the shard_map bodies
// of varigraph_tpu/parallel/mesh.py make_cbf_add_sharded and
// make_cbf_count_sharded; and, for construct's genome count
// (varigraph_tpu/index/build.py make_genome_cbf), the XLA sketch_codes
// (varigraph_tpu/ops/kmer.py:79) that feeds the add.
//
// What bounds it on an H100.  add_codes reads one byte a base and, per
// emitted window, runs kh Murmur3 hashes (~72 int32 operations each): it is
// bound by those operations.  Its kh updates a window are random one-byte
// read-modify-writes: made one at a time in device memory, each is a random
// 32-byte transaction through L2 (and at m = 2^30, 1 GiB, a miss to HBM), and
// those, not the hashing, would set the pace.  count is kh random byte loads
// a key.
//
// What the design does about it.
//   * add and add_codes stage their updates and apply them in shared memory.
//     The shard is cut into at most 2^15 regions of 2^region_bits cells
//     (2^15 cells up to m_local = 2^30), and the regions into at most 128
//     buckets of consecutive regions.  Five passes on the stream:
//       1. count: the items (rows or keys) are sketched and hashed, and each
//          block counts the positions a region in shared memory, then adds
//          its counts to the global ones;
//       2. scan: one block turns the counts into each region's offset (the
//          regions' entries are contiguous, in region order, so a bucket's
//          are too), the cursors of passes 3 and 4, and the tiles of pass 4;
//       3. bucket: the items are sketched and hashed again, a few bases of
//          every row of a block at a time; the block stages up to 6,144
//          positions in shared memory, sorts them by bucket there, takes a
//          run of each bucket's entries with one global atomicAdd a bucket,
//          and writes each run whole (offsets within the bucket, 4 bytes);
//       4. partition: a block takes a tile of one bucket's entries, sorts it
//          by region in shared memory the same way, and writes each region's
//          run whole (offsets within the region);
//       5. apply: one block a region loads the region's filter bytes into
//          shared memory (32 KB at a time), applies its entries as saturating
//          +1 steps on the shared words (atomicCAS on the 32-bit word, stopping
//          at 255, so a byte never carries into its neighbour), and writes the
//          bytes back; a region with no entries is left alone.
//     So every write of an entry is part of a run that a warp writes in
//     whole sectors, and the filter moves through device memory once a call,
//     in whole sectors, instead of a random transaction an update.  Hashing
//     twice costs less than keeping 8 bytes a position.  Saturating +1 steps
//     commute, so the filter is bit-exact whatever the order.  Hot counters
//     (poly-A, satellite repeats) contend only in shared memory, and stop
//     costing once they reach 255.  A call pays off with many updates a
//     region, so the wrapper hands the kernel a chromosome, up to 2^28
//     positions a call, not a batch.
//   * add_codes never writes the sketch's values or mask: a thread sketches
//     one 160-base row in registers (the reference's sequential form, with
//     its rule for ambiguous bases), in each of passes 1 and 3.
//   * count issues all kh loads at once: kh is a template parameter (1..16),
//     every position is computed and every load issued before the min.
//
// The shard's word addressing: a region starts at a multiple of 2^15 cells
// from the shard's base, which is 4-byte aligned, and a shard whose m_local is
// not a multiple of 4 is allocated up to the next multiple (the wrapper
// checks), so the last word never leaves the allocation; its padding bytes are
// read and written back unchanged, because no position maps to them.  The
// kernels allocate nothing: the wrapper passes the counters and the two
// entries buffers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cbf_device.cuh"

namespace {

using vgcbf::position;
using vgcbf::u64;

constexpr int kMaxSeeds = 16;         // kh = round(m ln2 / n) is 7..13
constexpr int kRegionBitsMin = 15;    // cells a region, at least 2^15
constexpr int kMaxRegionsLog2 = 15;   // a count pass histogram of 128 KB
constexpr int kMaxBucketsLog2 = 7;    // at most 128 buckets, < kHole
constexpr int kWindowBits = 15;       // cells the apply holds at a time: 32 KB
constexpr int kCountThreads = 1024;   // pass 1
constexpr int kSortThreads = 256;     // passes 3 and 4: eight warps
constexpr int kStepPositions = 24;    // positions a thread stages a step
constexpr int kTile = kSortThreads * kStepPositions;  // 6,144 entries
constexpr int kApplyThreads = 256;
constexpr int kLookupThreads = 256;   // count
constexpr unsigned char kHole = 0xff;  // a staged slot outside the shard

struct Shard {
  u64 m, mmask, lo, m_local;
};

struct Plan {
  int region_bits;  // cells a region: 2^region_bits
  long regions;
  int bucket_shift;  // regions a bucket: 2^bucket_shift (at most 256)
  int buckets;
  int sms;
};

Plan make_plan(long m_local) {
  Plan p;
  const u64 top = (u64)(m_local - 1);
  const int bits = top ? 64 - __builtin_clzll(top) : 0;
  p.region_bits = std::max(kRegionBitsMin, bits - kMaxRegionsLog2);
  p.regions = (long)(((u64)m_local + (1ull << p.region_bits) - 1) >> p.region_bits);
  const int rbits = p.regions > 1 ? 64 - __builtin_clzll((u64)(p.regions - 1)) : 0;
  p.bucket_shift = std::max(0, rbits - kMaxBucketsLog2);
  p.buckets = (int)((p.regions + (1L << p.bucket_shift) - 1) >> p.bucket_shift);
  int dev = 0;
  cudaGetDevice(&dev);
  p.sms = 0;
  cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  return p;
}

u64 mask_of(long m) { return (m & (m - 1)) == 0 ? (u64)(m - 1) : 0ULL; }

// Scratch counters, in 32-bit words: the regions' offsets (counts before
// pass 2) [regions + 1], the partition cursors [regions], the bucket cursors
// [buckets], the tiles of pass 4 [buckets + 1].
struct Counters {
  unsigned *offs, *cur_region, *cur_bucket, *tiles;
  Counters(unsigned* w, const Plan& p)
      : offs(w),
        cur_region(w + p.regions + 1),
        cur_bucket(w + 2 * p.regions + 1),
        tiles(w + 2 * p.regions + 1 + p.buckets) {}
  static long words(const Plan& p) { return 2 * p.regions + 2 * p.buckets + 2; }
};

// One item is one genome row, sketched a few bases a step.
struct RowSource {
  const unsigned char* codes;
  long n, row0;
  int k;
  typedef vgk::RowSketch State;
  __device__ __forceinline__ int steps(int bases) const {
    return (vgk::kGenomeCols + bases - 1) / bases;
  }
  __device__ __forceinline__ State begin(long item, bool valid) const {
    return State(n, row0 + item, k, valid);
  }
  template <class Emit>
  __device__ __forceinline__ void advance(State& s, int bases, Emit&& emit) const {
    s.advance(codes, k, bases, emit);
  }
};

// One item is one key, emitted where its mask is set, in one step.
struct KeySource {
  const u64* keys;
  const unsigned char* mask;
  struct State {
    long j;
    bool valid;
  };
  __device__ __forceinline__ int steps(int) const { return 1; }
  __device__ __forceinline__ State begin(long item, bool valid) const {
    return State{item, valid};
  }
  template <class Emit>
  __device__ __forceinline__ void advance(State& s, int, Emit&& emit) const {
    if (s.valid && mask[s.j]) emit(__ldg(keys + s.j));
    s.valid = false;
  }
};

__device__ __forceinline__ void load_seeds(u64* s_seeds, const u64* seeds,
                                           int kh) {
  if (threadIdx.x < kh) s_seeds[threadIdx.x] = __ldg(seeds + threadIdx.x);
  __syncthreads();
}

// Pass 1.  Shared memory: one counter a region.
template <class Src>
__global__ void __launch_bounds__(kCountThreads)
    stage_count(Src src, long items, Shard f, const u64* __restrict__ seeds,
                int kh, int region_bits, long regions,
                unsigned* __restrict__ counts) {
  extern __shared__ unsigned s_hist[];
  __shared__ u64 s_seeds[kMaxSeeds];
  for (long r = threadIdx.x; r < regions; r += blockDim.x) s_hist[r] = 0u;
  load_seeds(s_seeds, seeds, kh);
  const long stride = (long)gridDim.x * blockDim.x;
  for (long it = (long)blockIdx.x * blockDim.x + threadIdx.x; it < items;
       it += stride) {
    auto st = src.begin(it, true);
    src.advance(st, vgk::kGenomeCols, [&](u64 v) {
      for (int s = 0; s < kh; ++s) {
        // unsigned: a position below lo wraps above m_local
        const u64 local = position(v, s_seeds[s], f.m, f.mmask) - f.lo;
        if (local < f.m_local) atomicAdd(s_hist + (local >> region_bits), 1u);
      }
    });
  }
  __syncthreads();
  for (long r = threadIdx.x; r < regions; r += blockDim.x)
    if (s_hist[r]) atomicAdd(counts + r, s_hist[r]);
}

// Pass 2: one block.  The regions' counts become their exclusive offsets, in
// place, the total at offs[regions]; the cursors start at the offsets; and
// bucket c gets tiles [tiles[c], tiles[c + 1]) of pass 4, kTile entries each.
__global__ void __launch_bounds__(1024)
    stage_scan(Counters c, long regions, int bucket_shift, int buckets) {
  __shared__ unsigned part[1024];
  unsigned* offs = c.offs;
  const long per = (regions + blockDim.x - 1) / blockDim.x;
  const long b = min(regions, (long)threadIdx.x * per);
  const long e = min(regions, b + per);
  unsigned s = 0;
  for (long i = b; i < e; ++i) s += offs[i];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const unsigned t = threadIdx.x >= off ? part[threadIdx.x - off] : 0u;
    __syncthreads();
    part[threadIdx.x] += t;
    __syncthreads();
  }
  unsigned run = part[threadIdx.x] - s;
  for (long i = b; i < e; ++i) {
    const unsigned v = offs[i];
    offs[i] = run;
    c.cur_region[i] = run;
    run += v;
  }
  if (threadIdx.x == blockDim.x - 1) offs[regions] = part[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
    for (int k = 0; k < buckets; ++k) {
      const unsigned first = offs[(long)k << bucket_shift];
      const unsigned last = offs[min(regions, (long)(k + 1) << bucket_shift)];
      c.cur_bucket[k] = first;
      c.tiles[k] = t;
      t += (last - first + kTile - 1) / kTile;
    }
    c.tiles[buckets] = t;
  }
}

// The shared memory of passes 3 and 4: a tile of entries staged with their
// keys (a bucket or a region of the bucket, < 256), sorted by key into a
// second copy, and written out run by run.
struct SortTile {
  unsigned staged[kTile];
  unsigned sorted[kTile];
  unsigned char staged_key[kTile];
  unsigned char sorted_key[kTile];
  unsigned count[256];  // entries a key; then each entry's rank in its key
  unsigned first[256];  // the key's first slot in `sorted`
  unsigned dest[256];   // the key's run in the output
  unsigned warp_sum[kSortThreads / 32];
  unsigned n;           // slots staged
  unsigned tiles[(1 << kMaxBucketsLog2) + 1];
  u64 seeds[kMaxSeeds];
};

// Sorts the n staged slots by key (with kHoles, slots with key kHole are
// skipped), reserves each key's run at cursors[key] and writes the runs to
// out; leaves the tile empty.  Every thread of the block calls it; count[]
// holds the entries a key.
template <bool kHoles>
__device__ __forceinline__ void flush_tile(SortTile& s, unsigned n, int keys,
                                           unsigned* __restrict__ cursors,
                                           unsigned* __restrict__ out) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  __syncthreads();
  // exclusive scan of count[0, keys): one key a thread
  const unsigned v = t < keys ? s.count[t] : 0u;
  unsigned x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s.warp_sum[warp] = x;
  __syncthreads();
  unsigned before = 0, total = 0;
  for (int w = 0; w < kSortThreads / 32; ++w) {
    before += w < warp ? s.warp_sum[w] : 0u;
    total += s.warp_sum[w];
  }
  if (t < keys) {
    s.first[t] = before + x - v;
    s.dest[t] = v ? atomicAdd(cursors + t, v) : 0u;
    s.count[t] = 0u;
  }
  __syncthreads();
  for (unsigned j = t; j < n; j += kSortThreads) {
    const unsigned key = s.staged_key[j];
    if (kHoles && key == kHole) continue;
    const unsigned at = s.first[key] + atomicAdd(s.count + key, 1u);
    s.sorted[at] = s.staged[j];
    s.sorted_key[at] = (unsigned char)key;
  }
  __syncthreads();
  for (unsigned j = t; j < total; j += kSortThreads) {
    const unsigned key = s.sorted_key[j];
    out[s.dest[key] + (j - s.first[key])] = s.sorted[j];
  }
  __syncthreads();
  if (t < keys) s.count[t] = 0u;
  if (t == 0) s.n = 0u;
  __syncthreads();
}

// Pass 3.  Every thread takes an item (a row or a key) and, a step at a
// time, stages its positions in the shard with their buckets: at most
// kStepPositions a thread a step (bases a step = kStepPositions / kh, each
// emitting at most one window), so a step fills at most one tile.
template <class Src>
__global__ void __launch_bounds__(kSortThreads)
    stage_bucket(Src src, long items, Shard f, const u64* __restrict__ seeds,
                 int kh, int bucket_bits, int buckets, Counters c,
                 unsigned* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  SortTile& s = *reinterpret_cast<SortTile*>(smem);
  for (int k = threadIdx.x; k < 256; k += blockDim.x) s.count[k] = 0u;
  if (threadIdx.x == 0) s.n = 0u;
  load_seeds(s.seeds, seeds, kh);
  const int bases = max(1, kStepPositions / kh);
  const int steps = src.steps(bases);
  const u64 bmask = (1ull << bucket_bits) - 1;
  const unsigned lanes_below = (1u << (threadIdx.x & 31)) - 1u;
  for (long first = (long)blockIdx.x * blockDim.x; first < items;
       first += (long)gridDim.x * blockDim.x) {
    const long it = first + threadIdx.x;
    auto st = src.begin(it, it < items);
    for (int step = 0; step < steps; ++step) {
      src.advance(st, bases, [&](u64 v) {
        // kh slots for each window, taken once for the warp's lanes here
        const unsigned active = __activemask();
        const int leader = __ffs(active) - 1;
        unsigned slot = 0;
        if ((int)(threadIdx.x & 31) == leader)
          slot = atomicAdd(&s.n, (unsigned)(__popc(active) * kh));
        slot = __shfl_sync(active, slot, leader) +
               (unsigned)(__popc(active & lanes_below) * kh);
        for (int q = 0; q < kh; ++q) {
          const u64 local = position(v, s.seeds[q], f.m, f.mmask) - f.lo;
          if (local < f.m_local) {
            const unsigned b = (unsigned)(local >> bucket_bits);
            s.staged[slot + q] = (unsigned)(local & bmask);
            s.staged_key[slot + q] = (unsigned char)b;
            atomicAdd(s.count + b, 1u);
          } else {
            s.staged_key[slot + q] = kHole;
          }
        }
      });
      __syncthreads();
      flush_tile<true>(s, s.n, buckets, c.cur_bucket, out);
    }
  }
}

// Pass 4.  A block takes tile t of bucket b (tiles[b] <= t < tiles[b + 1]):
// entries offs[first region of b] + (t - tiles[b]) * kTile onward, at most
// kTile of them and not past the bucket.
__global__ void __launch_bounds__(kSortThreads)
    stage_partition(const unsigned* __restrict__ in, Counters c, long regions,
                    int region_bits, int bucket_shift, int buckets,
                    unsigned* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  SortTile& s = *reinterpret_cast<SortTile*>(smem);
  for (int k = threadIdx.x; k < 256; k += blockDim.x) s.count[k] = 0u;
  for (int k = threadIdx.x; k <= buckets; k += blockDim.x) s.tiles[k] = c.tiles[k];
  __syncthreads();
  const unsigned ntiles = s.tiles[buckets];
  const unsigned rmask = (1u << region_bits) - 1u;
  for (unsigned t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int lo = 0, hi = buckets;  // the bucket b with tiles[b] <= t < tiles[b + 1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s.tiles[mid] <= t) lo = mid; else hi = mid;
    }
    const long r0 = (long)lo << bucket_shift;
    const long r1 = min(regions, (long)(lo + 1) << bucket_shift);
    const unsigned first = c.offs[r0] + (t - s.tiles[lo]) * kTile;
    const unsigned n = min(first + kTile, c.offs[r1]) - first;
    for (unsigned j = threadIdx.x; j < n; j += kSortThreads) {
      const unsigned v = in[first + j];
      const unsigned key = v >> region_bits;
      s.staged[j] = v & rmask;
      s.staged_key[j] = (unsigned char)key;
      atomicAdd(s.count + key, 1u);
    }
    flush_tile<false>(s, n, (int)(r1 - r0), c.cur_region + r0, out);
  }
}

// filter byte `cell` of the shared words = min(byte + 1, 255)
__device__ __forceinline__ void saturating_inc(unsigned* words, unsigned cell) {
  unsigned* w = words + (cell >> 2);
  const unsigned shift = (cell & 3u) * 8u;
  unsigned old = *w;
  while (((old >> shift) & 0xffu) != 0xffu) {
    const unsigned assumed = old;
    old = atomicCAS(w, assumed, assumed + (1u << shift));
    if (old == assumed) break;
  }
}

// Pass 5: one block a region.
__global__ void __launch_bounds__(kApplyThreads)
    stage_apply(unsigned char* __restrict__ filter, u64 m_local,
                int region_bits, const unsigned* __restrict__ offs,
                const unsigned* __restrict__ entries) {
  __shared__ unsigned s_words[(1 << kWindowBits) / 4];
  const long r = blockIdx.x;
  const unsigned b = offs[r], e = offs[r + 1];
  if (b == e) return;
  const u64 base = (u64)r << region_bits;
  const u64 cells = min(1ull << region_bits, m_local - base);
  for (u64 w0 = 0; w0 < cells; w0 += 1ull << kWindowBits) {
    const unsigned wcells = (unsigned)min(1ull << kWindowBits, cells - w0);
    const unsigned words = (wcells + 3u) / 4u;
    unsigned* g = reinterpret_cast<unsigned*>(filter + base + w0);
    for (unsigned i = threadIdx.x; i < words; i += blockDim.x) s_words[i] = g[i];
    __syncthreads();
    for (unsigned j = b + threadIdx.x; j < e; j += blockDim.x) {
      const u64 o = (u64)__ldg(entries + j) - w0;  // wraps when below w0
      if (o < wcells) saturating_inc(s_words, (unsigned)o);
    }
    __syncthreads();
    for (unsigned i = threadIdx.x; i < words; i += blockDim.x) g[i] = s_words[i];
    __syncthreads();
  }
}

#define VG_LAUNCH_CHECK()                        \
  do {                                           \
    const int rc_ = (int)cudaGetLastError();     \
    if (rc_) return rc_;                         \
  } while (0)

// entries: two buffers of `capacity` words, capacity >= the positions.
template <class Src>
int stage_add(const Src& src, long items, void* filter, long m, long lo,
              long m_local, const void* seeds, int kh, void* counters,
              void* entries, long capacity, cudaStream_t stream) {
  const Plan p = make_plan(m_local);
  const Shard f{(u64)m, mask_of(m), (u64)lo, (u64)m_local};
  const Counters c((unsigned*)counters, p);
  unsigned* first = (unsigned*)entries;
  unsigned* second = first + capacity;
  const int hist = (int)(p.regions * sizeof(unsigned));
  const int tile = (int)sizeof(SortTile);
  cudaFuncSetAttribute(stage_count<Src>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, hist);
  cudaFuncSetAttribute(stage_bucket<Src>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, tile);
  cudaFuncSetAttribute(stage_partition,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, tile);
  int rc = (int)cudaMemsetAsync(c.offs, 0, p.regions * sizeof(unsigned), stream);
  if (rc) return rc;
  stage_count<Src><<<p.sms, kCountThreads, hist, stream>>>(
      src, items, f, (const u64*)seeds, kh, p.region_bits, p.regions, c.offs);
  VG_LAUNCH_CHECK();
  stage_scan<<<1, 1024, 0, stream>>>(c, p.regions, p.bucket_shift, p.buckets);
  VG_LAUNCH_CHECK();
  // three tiles fit an SM's shared memory
  const long blocks = std::min((items + kSortThreads - 1) / kSortThreads,
                               3L * p.sms);
  stage_bucket<Src><<<(unsigned)blocks, kSortThreads, tile, stream>>>(
      src, items, f, (const u64*)seeds, kh, p.region_bits + p.bucket_shift,
      p.buckets, c, first);
  VG_LAUNCH_CHECK();
  stage_partition<<<3 * p.sms, kSortThreads, tile, stream>>>(
      first, c, p.regions, p.region_bits, p.bucket_shift, p.buckets, second);
  VG_LAUNCH_CHECK();
  stage_apply<<<(unsigned)p.regions, kApplyThreads, 0, stream>>>(
      (unsigned char*)filter, (u64)m_local, p.region_bits, c.offs, second);
  VG_LAUNCH_CHECK();
  return 0;
}

template <int KH>
__global__ void __launch_bounds__(kLookupThreads)
    count_kernel(unsigned char* __restrict__ out,
                 const unsigned char* __restrict__ filter, Shard f,
                 const u64* __restrict__ keys, long n,
                 const u64* __restrict__ seeds) {
  __shared__ u64 s_seeds[KH];
  if (threadIdx.x < KH) s_seeds[threadIdx.x] = __ldg(seeds + threadIdx.x);
  __syncthreads();
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const u64 key = __ldg(keys + j);
  u64 local[KH];
#pragma unroll
  for (int s = 0; s < KH; ++s)
    local[s] = position(key, s_seeds[s], f.m, f.mmask) - f.lo;
  unsigned v[KH];
#pragma unroll
  for (int s = 0; s < KH; ++s)
    v[s] = local[s] < f.m_local ? (unsigned)__ldg(filter + local[s]) : 255u;
  unsigned c = 255u;
#pragma unroll
  for (int s = 0; s < KH; ++s) c = v[s] < c ? v[s] : c;
  out[j] = (unsigned char)c;
}

typedef void (*CountKernel)(unsigned char*, const unsigned char*, Shard,
                            const u64*, long, const u64*);

const CountKernel kCountKernels[kMaxSeeds + 1] = {
    nullptr,           count_kernel<1>,  count_kernel<2>,  count_kernel<3>,
    count_kernel<4>,   count_kernel<5>,  count_kernel<6>,  count_kernel<7>,
    count_kernel<8>,   count_kernel<9>,  count_kernel<10>, count_kernel<11>,
    count_kernel<12>,  count_kernel<13>, count_kernel<14>, count_kernel<15>,
    count_kernel<16>};

}  // namespace

// Every entry launches on `stream` (on the current device) and returns
// cudaGetLastError() as an int (0 = every launch was accepted).  The wrapper
// (ops/cbf_cuda.py) checks the rest: m >= 1, 0 <= lo, lo + m_local <= m,
// m_local <= 2^39, `filter` 4-byte aligned with room for ceil(m_local / 4)
// words, 1 <= kh <= 16, 1 <= k <= 28, and scratch of the sizes below.  An
// entry with nothing to do launches nothing.

// Words of the counters scratch that vg_cbf_add and vg_cbf_add_codes need
// for a shard of m_local cells.
extern "C" long vg_cbf_counter_words(long m_local) {
  return Counters::words(make_plan(m_local));
}

// counters: int32 [vg_cbf_counter_words]; entries: int32 [2 * capacity],
// capacity >= n * kh.
extern "C" int vg_cbf_add(void* filter, long m, long lo, long m_local,
                          const void* keys, const void* mask, long n,
                          const void* seeds, int kh, void* counters,
                          void* entries, long capacity, void* stream) {
  if (n == 0 || m_local == 0) return 0;
  if (kh < 1 || kh > kMaxSeeds) return (int)cudaErrorInvalidValue;
  return stage_add(KeySource{(const u64*)keys, (const unsigned char*)mask}, n,
                   filter, m, lo, m_local, seeds, kh, counters, entries,
                   capacity, (cudaStream_t)stream);
}

// codes: uint8 [n_codes], a chromosome's base codes; rows [row0, row0 +
// nrows) of its segmentation; counters as above; entries: int32
// [2 * capacity], capacity >= nrows * (160 - k + 1) * kh.
extern "C" int vg_cbf_add_codes(void* filter, long m, long lo, long m_local,
                                const void* codes, long n_codes, long row0,
                                long nrows, int k, const void* seeds, int kh,
                                void* counters, void* entries, long capacity,
                                void* stream) {
  if (nrows == 0 || m_local == 0) return 0;
  if (kh < 1 || kh > kMaxSeeds || k < 1 || k > 28) {
    return (int)cudaErrorInvalidValue;
  }
  return stage_add(RowSource{(const unsigned char*)codes, n_codes, row0, k},
                   nrows, filter, m, lo, m_local, seeds, kh, counters, entries,
                   capacity, (cudaStream_t)stream);
}

extern "C" int vg_cbf_count(void* out, const void* filter, long m, long lo,
                            long m_local, const void* keys, long n,
                            const void* seeds, int kh, void* stream) {
  if (n == 0) return 0;
  if (kh < 1 || kh > kMaxSeeds) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kLookupThreads - 1) / kLookupThreads);
  const Shard f{(u64)m, mask_of(m), (u64)lo, (u64)m_local};
  kCountKernels[kh]<<<blocks, kLookupThreads, 0, (cudaStream_t)stream>>>(
      (unsigned char*)out, (const unsigned char*)filter, f, (const u64*)keys,
      n, (const u64*)seeds);
  return (int)cudaGetLastError();
}
