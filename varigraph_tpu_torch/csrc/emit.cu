// Emissions of the genotyping HMM for Hopper (sm_90a).
//
//   vg_emissions  logE[g, n, s] for every window g, node n and state s
//
// Replaces, on the TPU side, the jitted XLA body of
// varigraph_tpu/genotype/engine_jax.py:70-160 (_emissions_body), vmapped over
// windows as _emissions_group (:174).  The port's plain version is
// genotype/engine_torch._emissions_body (~40 torch operations over
// [rows, K, U] and [rows, K, S] tensors, two of them einsums), reached through
// ops/emit.emissions_plain.
//
// What it computes, per node row (g, n), k-mer k (c, f, flag, kmask, the
// used-hap words bits_k and local_k) and valid state s (the used-hap slots
// u_{s,0..P-1}; a homozygous state repeats a slot):
//   htmp_k = bits_k | ((flag_k && lower <= c_k <= upper) ? gt0 : 0)
//   need   = OR of htmp_k over the k with c_k < lower, f_k >= 2, kmask_k
//   dec_k  = (c_k <= lower && f_k >= 2) ? htmp_k & need & ~local_k : 0
//   h(k, s) = sum_p bit(htmp_k, u_{s,p}) - sum_p bit(dec_k, u_{s,p})
//   logE[g, n, s] = sum_k (kmask_k ? term(k, h(k, s)) : 0),  -inf if s masked
// with term the Poisson (h > 0) or geometric (h = 0) log-probability of the
// rescaled count cc (find_most_likely_depth).  The plain version forms h by
// two contractions of unpacked bits against the [U, S] state-count matrix;
// the kernel needs neither:
//   * dec_k is a subset of htmp_k, so h(k, s) = sum_p bit(eff_k, u_{s,p}) with
//     eff_k = htmp_k & ~dec_k = htmp_k & ~(need & ~local_k): one word a k-mer
//     and word of haplotypes, and the clamp at 0 never binds;
//   * a valid k-mer's term depends only on (c, h) when h >= 1 (the cap
//     floor(ave * h) when the effective frequency fe != 1, cc = c when
//     fe == 1) and on (c, fe) when h = 0.  So each CTA builds once, in shared
//     memory, a launch-wide table of 256 x (2P + 1) terms: for each c, the
//     P + 1 terms of fe == 1 and the P terms h >= 1 of fe != 1; a row then
//     computes one term a valid k-mer (h = 0, fe != 1: a division) and
//     copies the other P from the table.  Every entry is the plain version's
//     float32 operations in its order (cap, c_div_f, zero_out, cc, log_geo,
//     log_poi, lgammaf(cc + 1)), so a term has the same bits wherever it is
//     computed.
//
// Layout.  A warp takes a node row, with no CTA barrier in a row's work: a
// persistent grid, each CTA a contiguous range of rows that its warps take
// one at a time from a shared counter (rows differ in their valid k-mers,
// so a fixed stride left the last warps of a grid far behind).  Lane l holds
// k-mers 4l..4l+3 (K <= 128): c, f, flag and kmask as one 32-bit word each
// and, at one or two hap words, bits and local as 16-byte loads; the next
// row's inputs are loaded into registers before the current row's sum, so
// they arrive while it runs.  need is a __reduce_or_sync of the triggering
// words, the row's last valid k-mer a __reduce_max_sync; each lane writes
// its k-mers' records (the P + 1 terms, then eff: 16 bytes at P = 2, one
// word) into the warp's slice of shared memory; __syncwarp.  Then a lane
// takes up to four states (two at P > 4) at a time, s = lane + 32 j (the
// last pass of a row only as many as are left), their slots as bit masks in
// registers (a valid state's slot outside 0..32W - 1 fails a device assert),
// and walks the k-mers: one broadcast read of a record serves all its
// states and each slot's bit is a mask test; at P <= 2 a select tree picks
// the term in registers, above it h indexes the record.  A state's sum
// keeps the order of this kernel's first design (a CTA a row, a thread a
// state): four partial sums over k = j (mod 4), each in ascending k,
// joined as (a0 + a1) + (a2 + a3).  The kernel is templated on
// P and on the hap words (1, 2, or any W: the slots' words then read from
// the record in shared memory); the launch configuration (the shared-memory
// attribute, the SM count, the occupancy) is found once for each instance
// and device.  One route for every S: a row's work grows with S, and the
// engine's groups hold thousands of rows.
//
// Determinism.  A state's sum is taken by one lane in a fixed order, and
// every term is the same float32 operations on the same inputs, so a value's
// bits depend only on its row's inputs and its window's states: not on the
// launch, the grid or the batch position; they equal the first design's.
// They agree with the plain version (torch's reduction order over K) to
// float32 rounding, not bit for bit.  IEEE division, logf and lgammaf, and no
// contraction into FMA (this source is compiled with -fmad=false,
// ops/emit_cuda.py): each product and sum rounds as the plain version's
// separate torch operations do.
//
// What bounds it on an H100.  Each input is read once (c, f, flag, kmask: 4
// bytes a k-mer; bits and local: 8 W bytes; gt0: U bytes a row; the states)
// and logE written once: at phase 14's 100 Mb group (G = 100, N = 543,
// S = 120, W = 1) ~110 MB, ~0.03 ms.  The state loop is 2P + 1 integer and
// float operations a (row, valid k-mer, valid state) triple: operations bound
// it (chip_smoke.py computes both from the run's inputs).  Here a triple at
// P = 2 is two mask tests, three selects and one add.

#include <assert.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxP = 8;
constexpr int kMaxK = 128;          // a row's k-mers: 32 lanes x 4
constexpr int kCodes = 256;         // c is a saturated u8
constexpr int kMaxDevices = 64;

struct Args {
  const uint8_t* c;        // [G, N, K] coverage (saturated u8)
  const uint8_t* f;        // [G, N, K] graph frequency
  const uint8_t* flag;     // [G, N, K] ref flag (bool)
  const uint8_t* kmask;    // [G, N, K] valid k-mer (bool)
  const uint32_t* bits;    // [G, N, K, W] global hap bits of the used haps
  const uint32_t* local;   // [G, N, K, W] node-local hap bits
  const uint8_t* gt0;      // [G, N, U] the hap's GT at the node is 0 (bool)
  const int* state_u;      // [G, S, P] used-hap slots of each state
  const uint8_t* smask;    // [G, S] valid state (bool)
  float* out;              // [G, N, S]
  long rows;               // G * N
  long N;
  int S, K, W;
  int wide;                // K == 128 and aligned: word and 16-byte loads
  float ave, lower, upper, log_p, log_q, log_prior;
};

// info word of a k-mer: c (bits 0-7), the effective frequency (8-15), kmask
// (16), the verification rule (17)
constexpr uint32_t kValid = 1u << 16;
constexpr uint32_t kVerify = 1u << 17;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
// words of a k-mer's record: the terms over h = 0..P, then eff, padded to 16 B
__host__ __device__ constexpr int record_words(int P, int W) { return round4(P + 1 + W); }
// the term picked by a select tree in registers up to this P, above it read
// from the record at h (at P = 4 the tree's ten selects cost more)
constexpr int kTreeMaxP = 2;
// warps of a CTA (fewer when a row's records are large); states a lane sums
// in one pass over a row's k-mers.  Both chosen on an H100 at phase 16's
// shapes (tools/emit_ab.py)
__host__ __device__ constexpr int cta_warps(int P) { return P <= 2 ? 8 : 4; }
__host__ __device__ constexpr int lane_states(int P) { return P <= 4 ? 4 : 2; }
// words of a state's slot masks: one a hap word at KW = 1, 2; one at any W
__host__ __device__ constexpr int mask_words(int KW) { return KW > 0 ? KW : 1; }

size_t table_bytes(int P) { return 4 * static_cast<size_t>(kCodes) * (2 * P + 1); }
size_t warp_bytes(int P, int W) {
  return 4 * static_cast<size_t>(kMaxK) * record_words(P, W);
}

// term(k, h): the plain version's float32 operations, in its order
// (genotype.cpp:713-718, 1030-1039, 1095-1120, 1136-1158); meanh = ave * h,
// logmeanh = logf(max(meanh, 1e-30)), read only for h >= 1
__device__ __forceinline__ float emission_term(uint32_t info, int h, float meanh,
                                               float logmeanh, const Args& a) {
  if (!(info & kValid)) return 0.0f;
  const float cB = static_cast<float>(info & 0xffu);
  const int fe = static_cast<int>((info >> 8) & 0xffu);
  const float ff = static_cast<float>(fe);
  float cc;
  if (fe == 1) {
    cc = cB;
  } else if (h == 0) {
    const float c_div_f = floorf(cB / ff);
    cc = (cB > a.ave && ff > cB / a.upper) ? 0.0f : c_div_f;
  } else {
    cc = cB > meanh ? floorf(meanh) : cB;   // cap = floor(ave * h)
  }
  if (h == 0) return (a.log_prior + cc * a.log_q) + (1.0f - cc) * a.log_p;
  return (-meanh + cc * logmeanh) - lgammaf(cc + 1.0f);
}

// term[sum_p b[p]] from the P + 1 terms in registers, by a select tree:
// level p picks between neighbours by b[p], P (P + 1) / 2 selects
template <int P>
__device__ __forceinline__ float pick(const float (&t)[P + 1], const bool (&b)[P]) {
  float v[P + 1];
#pragma unroll
  for (int i = 0; i <= P; ++i) v[i] = t[i];
#pragma unroll
  for (int p = P - 1; p >= 0; --p) {
#pragma unroll
    for (int i = 0; i <= p; ++i) v[i] = b[p] ? v[i + 1] : v[i];
  }
  return v[0];
}

// a row's inputs as a lane holds them: its 4 k-mers' bytes of c, f, flag and
// kmask, and at KW >= 1 hap words their bits and local words and its gt0 flag
// of each word (bit w)
template <int KW>
struct RowIn {
  static constexpr int kWords = KW > 0 ? KW : 1;
  uint32_t c, f, flag, kmask;
  uint32_t bits[4 * kWords], local[4 * kWords];
  uint32_t gt0;
};

template <int KW>
__device__ __forceinline__ void load_row(RowIn<KW>& in, const Args& a, long r, int lane) {
  const int U = 32 * a.W;
  if (a.wide) {
    const long o = r * kMaxK + 4 * lane;
    in.c = __ldg(reinterpret_cast<const uint32_t*>(a.c + o));
    in.f = __ldg(reinterpret_cast<const uint32_t*>(a.f + o));
    in.flag = __ldg(reinterpret_cast<const uint32_t*>(a.flag + o));
    in.kmask = __ldg(reinterpret_cast<const uint32_t*>(a.kmask + o));
    if (KW > 0) {
      const uint4* b = reinterpret_cast<const uint4*>(a.bits + o * KW);
      const uint4* l = reinterpret_cast<const uint4*>(a.local + o * KW);
#pragma unroll
      for (int i = 0; i < KW; ++i) {
        const uint4 x = __ldg(b + i), y = __ldg(l + i);
        in.bits[4 * i] = x.x; in.bits[4 * i + 1] = x.y;
        in.bits[4 * i + 2] = x.z; in.bits[4 * i + 3] = x.w;
        in.local[4 * i] = y.x; in.local[4 * i + 1] = y.y;
        in.local[4 * i + 2] = y.z; in.local[4 * i + 3] = y.w;
      }
    }
  } else {
    in.c = in.f = in.flag = in.kmask = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 4 * lane + q;
      const long i = r * a.K + k;
      const bool in_k = k < a.K;
      in.c |= (in_k ? static_cast<uint32_t>(a.c[i]) : 0u) << (8 * q);
      in.f |= (in_k ? static_cast<uint32_t>(a.f[i]) : 0u) << (8 * q);
      in.flag |= (in_k ? static_cast<uint32_t>(a.flag[i]) : 0u) << (8 * q);
      in.kmask |= (in_k ? static_cast<uint32_t>(a.kmask[i]) : 0u) << (8 * q);
      if (KW > 0) {
#pragma unroll
        for (int w = 0; w < KW; ++w) {
          in.bits[q * KW + w] = in_k ? a.bits[i * KW + w] : 0u;
          in.local[q * KW + w] = in_k ? a.local[i * KW + w] : 0u;
        }
      }
    }
  }
  in.gt0 = 0u;
  if (KW > 0) {
#pragma unroll
    for (int w = 0; w < KW; ++w)
      in.gt0 |= (a.gt0[r * U + 32 * w + lane] != 0 ? 1u : 0u) << w;
  }
}

// one k-mer's terms added into acc[j] of each of the lane's states: the
// slot bits by mask (m[j][p][w], the word w of slot p; at any W the slot's
// word off[j][p] read from the record), the term picked in registers by a
// select tree (P <= kTreeMaxP) or read from the record at h
template <int P, int KW, int NJ>
__device__ __forceinline__ void add_kmer(const float* rec,
                                         const uint32_t (&m)[NJ][P][mask_words(KW)],
                                         const int (&off)[NJ][P], float (&acc)[NJ]) {
  if constexpr (KW == 0) {
    const uint32_t* eff = reinterpret_cast<const uint32_t*>(rec + P + 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int h = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) h += (eff[off[j][p]] & m[j][p][0]) != 0u;
      acc[j] += rec[h];
    }
  } else if constexpr (P <= kTreeMaxP) {
    constexpr int R = record_words(P, KW);
    float v[R];
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(rec)[i];
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
    }
    float t[P + 1];
#pragma unroll
    for (int h = 0; h <= P; ++h) t[h] = v[h];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      bool b[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        uint32_t x = 0u;
#pragma unroll
        for (int w = 0; w < KW; ++w) x |= __float_as_uint(v[P + 1 + w]) & m[j][p][w];
        b[p] = x != 0u;
      }
      acc[j] += pick<P>(t, b);
    }
  } else {
    uint32_t e[KW];
#pragma unroll
    for (int w = 0; w < KW; ++w) e[w] = __float_as_uint(rec[P + 1 + w]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int h = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        uint32_t x = 0u;
#pragma unroll
        for (int w = 0; w < KW; ++w) x |= e[w] & m[j][p][w];
        h += x != 0u;
      }
      acc[j] += rec[h];
    }
  }
}

// the lane's NJ states s = s0 + lane + 32 j of row r (window g): their
// slots as masks, the sum over the row's kn k-mers, the output; the last
// pass of a row takes only the states left, NJ = nj of them (as a template
// parameter, so a pass computes no state past S)
template <int P, int KW, int NJ>
__device__ __forceinline__ void sum_pass(int nj, const Args& a, const float* rec, int R,
                                         int kn, long r, long g, int s0, int lane) {
  if constexpr (NJ > 1) {
    if (nj < NJ) {
      sum_pass<P, KW, NJ - 1>(nj, a, rec, R, kn, r, g, s0, lane);
      return;
    }
  }
  const int U = 32 * a.W;
  uint32_t m[NJ][P][mask_words(KW)];
  int off[NJ][P];
  bool live[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int s = s0 + 32 * j + lane;
    live[j] = s < a.S && a.smask[g * a.S + s] != 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int u = live[j] ? __ldg(a.state_u + (g * a.S + s) * P + p) : 0;
      const bool bad = u < 0 || u >= U;
      assert(!bad && "a valid state's slot is outside 0..32 W - 1");
      const uint32_t bit = bad ? 0u : 1u << (u & 31);
      off[j][p] = bad ? 0 : u >> 5;
#pragma unroll
      for (int w = 0; w < mask_words(KW); ++w)
        m[j][p][w] = KW == 0 || off[j][p] == w ? bit : 0u;
    }
  }
  // four partial sums, of the k-mers k = i (mod 4) in ascending k, joined
  // as (a0 + a1) + (a2 + a3)
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  int k = 0;
  for (; k + 4 <= kn; k += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      add_kmer<P, KW, NJ>(rec + static_cast<size_t>(k + i) * R, m, off, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (k + i < kn) add_kmer<P, KW, NJ>(rec + static_cast<size_t>(k + i) * R, m, off, acc[i]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int s = s0 + 32 * j + lane;
    if (s < a.S)
      a.out[r * a.S + s] =
          live[j] ? (acc[0][j] + acc[1][j]) + (acc[2][j] + acc[3][j]) : -INFINITY;
  }
}

template <int P, int KW>
__global__ void __launch_bounds__(32 * cta_warps(P)) emissions_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LS = lane_states(P);
  constexpr int kT = 2 * P + 1;
  const int W = KW > 0 ? KW : a.W, U = 32 * a.W;
  const int R = record_words(P, W);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned full = 0xffffffffu;

  // the launch-wide term table: for each c, fe == 1 at h = 0..P, then
  // fe != 1 at h = 1..P
  float* tab = smem;
  for (int i = threadIdx.x; i < kCodes * kT; i += blockDim.x) {
    const int c = i / kT, j = i - c * kT;
    const bool one = j <= P;
    const int h = one ? j : j - P;
    const float m = a.ave * static_cast<float>(h);
    tab[i] = emission_term(static_cast<uint32_t>(c) | ((one ? 1u : 2u) << 8) | kValid,
                           h, m, logf(fmaxf(m, 1e-30f)), a);
  }
  float* rec = tab + kCodes * kT + static_cast<size_t>(warp) * kMaxK * R;
  __shared__ int taken;   // rows of the CTA handed out
  if (threadIdx.x == 0) taken = warps;
  __syncthreads();

  // the CTA's rows [lo, hi), handed to its warps one at a time
  const long lo = a.rows * blockIdx.x / gridDim.x;
  const long hi = a.rows * (blockIdx.x + 1) / gridDim.x;
  long r = lo + warp;
  auto next_row = [&]() {
    int i = 0;
    if (lane == 0) i = atomicAdd(&taken, 1);
    return lo + __shfl_sync(full, i, 0);
  };
  RowIn<KW> cur;
  if (r < hi) load_row<KW>(cur, a, r, lane);
  while (r < hi) {
    // the lane's k-mers: info, htmp, the trigger into need, the decrement
    uint32_t info[4];
    bool ci[4], trig[4];
    int kmine = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t c = (cur.c >> (8 * q)) & 0xffu, f = (cur.f >> (8 * q)) & 0xffu;
      const bool flag = ((cur.flag >> (8 * q)) & 0xffu) != 0u;
      const bool valid = ((cur.kmask >> (8 * q)) & 0xffu) != 0u;
      const float cf = static_cast<float>(c);
      ci[q] = flag && cf >= a.lower && cf <= a.upper;
      trig[q] = cf < a.lower && f >= 2 && valid;
      const bool verify = cf <= a.lower && f >= 2;
      const uint32_t fe = (flag && f == 1) ? 2u : f;
      info[q] = c | (fe << 8) | (valid ? kValid : 0u) | (verify ? kVerify : 0u);
      if (valid) kmine = 4 * lane + q + 1;
    }
    const int kn = __reduce_max_sync(full, kmine);
    float* mine = rec + static_cast<size_t>(4 * lane) * R;   // the lane's 4 records
    if (KW > 0) {
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const uint32_t g0 = __ballot_sync(full, (cur.gt0 >> w) & 1u);
        uint32_t h[4], v = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          h[q] = cur.bits[q * KW + w] | (ci[q] ? g0 : 0u);
          if (trig[q]) v |= h[q];
        }
        const uint32_t need = __reduce_or_sync(full, v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (info[q] & kVerify) h[q] &= ~(need & ~cur.local[q * KW + w]);
          mine[q * R + P + 1 + w] = __uint_as_float(h[q]);
        }
      }
    } else {
      for (int w = 0; w < W; ++w) {
        const uint32_t g0 = __ballot_sync(full, a.gt0[r * U + 32 * w + lane] != 0);
        uint32_t h[4], v = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = 4 * lane + q;
          h[q] = (k < a.K ? a.bits[(r * a.K + k) * W + w] : 0u) | (ci[q] ? g0 : 0u);
          if (trig[q]) v |= h[q];
        }
        const uint32_t need = __reduce_or_sync(full, v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (info[q] & kVerify)   // f >= 2, so k < K
            h[q] &= ~(need & ~a.local[(r * a.K + 4 * lane + q) * W + w]);
          mine[q * R + P + 1 + w] = __uint_as_float(h[q]);
        }
      }
    }
    // the terms: one computed a valid k-mer (h = 0 at fe != 1), the rest
    // from the table
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* t = mine + q * R;
      if (info[q] & kValid) {
        const uint32_t c = info[q] & 0xffu;
        const bool one = ((info[q] >> 8) & 0xffu) == 1u;
        const float* tc = tab + c * kT + (one ? 0 : P);
        t[0] = one ? tc[0] : emission_term(info[q], 0, 0.0f, 0.0f, a);
#pragma unroll
        for (int h = 1; h <= P; ++h) t[h] = tc[h];
      } else {
#pragma unroll
        for (int h = 0; h <= P; ++h) t[h] = 0.0f;
      }
    }

    // the next row's inputs, in flight during this row's sum
    const long rn = next_row();
    RowIn<KW> nxt;
    if (rn < hi) load_row<KW>(nxt, a, rn, lane);
    __syncwarp();

    const long g = r / a.N;
    for (int s0 = 0; s0 < a.S; s0 += 32 * LS)
      sum_pass<P, KW, LS>((a.S - s0 + 31) / 32, a, rec, R, kn, r, g, s0, lane);
    __syncwarp();   // every lane's reads of the records are done
    cur = nxt;
    r = rn;
  }
}

// the launch configuration of one kernel instance on one device, found once
struct Config {
  int sms = 0, max_smem = 0;   // 0: not found yet
  int W = 0, warps = 0, grid = 0;
  size_t smem = 0;
};

template <int P, int KW>
int launch(const Args& a, cudaStream_t stream) {
  static std::mutex mu;
  static Config cfg[kMaxDevices];
  auto kernel = emissions_kernel<P, KW>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  Config c;
  {
    std::lock_guard<std::mutex> lock(mu);
    Config& e = cfg[dev];
    if (e.sms == 0) {
      int sms = 0, max_smem = 0;
      cudaFuncAttributes fa;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
              cudaSuccess ||
          (err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                        dev)) != cudaSuccess ||
          (err = cudaFuncGetAttributes(&fa, kernel)) != cudaSuccess)
        return static_cast<int>(err);
      max_smem -= static_cast<int>(fa.sharedSizeBytes);   // the dynamic part's room
      if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      max_smem)) != cudaSuccess)
        return static_cast<int>(err);
      e.sms = sms;
      e.max_smem = max_smem;
    }
    // the occupancy at this W (fixed at KW >= 1)
    if (e.W != a.W) {
      if (table_bytes(P) >= static_cast<size_t>(e.max_smem))
        return static_cast<int>(cudaErrorInvalidConfiguration);
      const size_t per_warp = warp_bytes(P, a.W);
      const size_t room = static_cast<size_t>(e.max_smem) - table_bytes(P);
      const int warps = static_cast<int>(
          room / per_warp < cta_warps(P) ? room / per_warp : cta_warps(P));
      if (warps < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      const size_t smem = table_bytes(P) + warps * per_warp;
      int per_sm = 0;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps,
                                                               smem)) != cudaSuccess)
        return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      e.W = a.W;
      e.warps = warps;
      e.smem = smem;
      e.grid = e.sms * per_sm;
    }
    c = e;
  }
  const long ctas = (a.rows + c.warps - 1) / c.warps;
  const long grid = ctas < c.grid ? ctas : c.grid;
  kernel<<<static_cast<unsigned>(grid), 32 * c.warps, c.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(const Args& a, cudaStream_t stream) {
  switch (a.W) {
    case 1: return launch<P, 1>(a, stream);
    case 2: return launch<P, 2>(a, stream);
    default: return launch<P, 0>(a, stream);
  }
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// c, f, flag, kmask: uint8/bool [G, N, K], K <= 128; bits, local: uint32
// words [G, N, K, W]; gt0: bool [G, N, 32 W]; state_u: int32 [G, S, P], each
// valid state's slots in 0..32 W - 1 (else a device assert fails); smask:
// bool [G, S]; out: float32 [G, N, S]; 1 <= P <= 8, W >= 1.  Launches on
// `stream` and returns cudaGetLastError() as an int (0 = the launch was
// accepted).
extern "C" int vg_emissions(const void* c, const void* f, const void* flag,
                            const void* kmask, const void* bits,
                            const void* local, const void* gt0,
                            const void* state_u, const void* smask, void* out,
                            long G, long N, int S, int K, int W, int P,
                            float ave, float lower, float upper, float log_p,
                            float log_q, float log_prior, void* stream) {
  if (G == 0 || N == 0 || S == 0) return 0;
  if (P < 1 || P > kMaxP || W < 1 || K < 0 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wide = K == kMaxK && aligned(c, 4) && aligned(f, 4) && aligned(flag, 4) &&
                   aligned(kmask, 4) && aligned(bits, 16) && aligned(local, 16);
  Args a{static_cast<const uint8_t*>(c),     static_cast<const uint8_t*>(f),
         static_cast<const uint8_t*>(flag),  static_cast<const uint8_t*>(kmask),
         static_cast<const uint32_t*>(bits), static_cast<const uint32_t*>(local),
         static_cast<const uint8_t*>(gt0),   static_cast<const int*>(state_u),
         static_cast<const uint8_t*>(smask), static_cast<float*>(out),
         G * N, N, S, K, W, wide, ave, lower, upper, log_p, log_q, log_prior};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 1: return launch_p<1>(a, st);
    case 2: return launch_p<2>(a, st);
    case 3: return launch_p<3>(a, st);
    case 4: return launch_p<4>(a, st);
    case 5: return launch_p<5>(a, st);
    case 6: return launch_p<6>(a, st);
    case 7: return launch_p<7>(a, st);
    default: return launch_p<8>(a, st);
  }
}
