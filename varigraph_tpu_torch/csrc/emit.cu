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
//   * with h fixed, the term depends only on the k-mer, and h <= P, so a
//     node's terms are a table term[k][0..P] of (P + 1) * K entries, computed
//     once a node with the plain version's float32 operations in its order:
//     cap, c_div_f, zero_out, cc, log_geo, log_poi; lgamma(cc + 1) from a
//     table of lgammaf(i + 1), i = 0..255 (cc is an integer in 0..255 unless
//     f = 0 makes it inf or NaN, which go to lgammaf itself), and
//     logf(max(ave * h, 1e-30)) from a table over h.
//   * a state's sum is then a bit test per slot and a table read per k-mer.
//
// Layout.  A CTA walks node rows r = blockIdx.x, + gridDim.x, ... (the grid
// fills the SMs once; the lgamma and mean tables are built once a CTA).  For
// a row: a warp per word ballots the U gt0 flags; a thread per k-mer forms
// htmp and ORs the triggering words into need (shared atomics: OR does not
// depend on their order); a barrier; the decrement into eff, and the term
// table over (k, h) pairs below the row's last valid k-mer; a barrier; a
// thread per state (strided) reads its slots (state_u, read through L1; a
// masked state's row is never read) and sums term[k][h(k, s)] over the k-mers
// as four partial sums (k = j mod 4, each in ascending k, joined as
// (a0 + a1) + (a2 + a3)): about half the rounding of one running sum, and
// four independent adds in flight.  A row's shared state is K * (W + P + 2)
// words.  P is a template parameter (the slots in registers), and so is
// whether the haplotypes fit one word (U = 32: one broadcast load a k-mer).
//
// Determinism.  A state's sum is taken by one thread in a fixed order, and
// every term is the same float32 operations on the same inputs, so a value's
// bits depend only on its row's inputs and its window's states: not on the
// launch, the grid or the batch position.  It agrees with the plain version
// (torch's reduction order over K) to float32 rounding, not bit for bit.
// IEEE division, logf and lgammaf, and no contraction into FMA (this source
// is compiled with -fmad=false, ops/emit_cuda.py): each product and sum
// rounds as the plain version's separate torch operations do.
//
// What bounds it on an H100.  Each input is read once (c, f, flag, kmask: 4
// bytes a k-mer; bits and local: 8 W bytes; gt0: U bytes a row; the states)
// and logE written once: at the 100 Mb group (G = 100, N = 543, S = 120,
// W = 1) ~110 MB, ~0.03 ms.  The state loop is 2P + 1 integer and float
// operations a (row, valid k-mer, valid state): ~834M triples there, ~0.25 ms
// at the int32 rate, so operations bound it (chip_smoke.py computes both from
// the run's inputs).  The table makes the per-triple work independent of the
// transcendental functions; a row's setup (P + 1 terms a k-mer, three
// barriers) is shared by its S states.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLgamma = 256;        // lgammaf(i + 1) for the integer cc 0..255
constexpr int kMaxP = 8;
constexpr int kSmallThreads = 128;  // a CTA at S <= 128, else kThreads
constexpr int kThreads = 256;

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
  float ave, lower, upper, log_p, log_q, log_prior;
};

// shared words of a CTA: the lgamma table, mean and log-mean over h, gt0 and
// need words, the row's last valid k-mer, per k-mer info, eff, the terms
constexpr size_t shared_words(int K, int W, int P) {
  return kLgamma + 2 * (P + 1) + 2 * static_cast<size_t>(W) + 1 + K +
         static_cast<size_t>(K) * W + static_cast<size_t>(K) * (P + 1);
}

// info word of a k-mer: c (bits 0-7), the effective frequency (8-15), kmask
// (16), the verification rule (17)
constexpr uint32_t kValid = 1u << 16;
constexpr uint32_t kVerify = 1u << 17;

// term(k, h): the plain version's float32 operations, in its order
// (genotype.cpp:713-718, 1030-1039, 1095-1120, 1136-1158)
__device__ __forceinline__ float emission_term(uint32_t info, int h,
                                               const float* meanv,
                                               const float* logmean,
                                               const float* lg, const Args& a) {
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
    cc = cB > meanv[h] ? floorf(meanv[h]) : cB;   // cap = floor(ave * h)
  }
  if (h == 0) return (a.log_prior + cc * a.log_q) + (1.0f - cc) * a.log_p;
  const float lgc = (cc >= 0.0f && cc < static_cast<float>(kLgamma))
                        ? lg[static_cast<int>(cc)]
                        : lgammaf(cc + 1.0f);
  return (-meanv[h] + cc * logmean[h]) - lgc;
}

template <int P, bool kOneWord>
__global__ void __launch_bounds__(kThreads) emissions_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  const int K = a.K, W = a.W, U = 32 * a.W;
  float* lg = reinterpret_cast<float*>(smem);
  float* meanv = lg + kLgamma;                                   // [P + 1]
  float* logmean = meanv + (P + 1);                              // [P + 1]
  uint32_t* gt0w = reinterpret_cast<uint32_t*>(logmean + (P + 1));  // [W]
  uint32_t* need = gt0w + W;                                     // [W]
  int* kend = reinterpret_cast<int*>(need + W);                  // [1]
  uint32_t* kinfo = reinterpret_cast<uint32_t*>(kend + 1);       // [K]
  uint32_t* eff = kinfo + K;                                     // [K, W]
  float* term = reinterpret_cast<float*>(eff + static_cast<size_t>(K) * W);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int i = tid; i < kLgamma; i += blockDim.x)
    lg[i] = lgammaf(static_cast<float>(i) + 1.0f);
  if (tid <= P) {
    const float m = a.ave * static_cast<float>(tid);
    meanv[tid] = m;
    logmean[tid] = logf(fmaxf(m, 1e-30f));
  }

  for (long r = blockIdx.x; r < a.rows; r += gridDim.x) {
    const long g = r / a.N;
    __syncthreads();   // the previous row's readers are done (and the tables)
    for (int w = warp; w < W; w += nwarps) {
      const uint32_t word =
          __ballot_sync(0xffffffffu, a.gt0[r * U + w * 32 + lane] != 0);
      if (lane == 0) {
        gt0w[w] = word;
        need[w] = 0u;
      }
    }
    if (tid == 0) *kend = 0;
    __syncthreads();

    // htmp per k-mer, the triggering words into need
    for (int k = tid; k < K; k += blockDim.x) {
      const long i = r * K + k;
      const int c = a.c[i], f = a.f[i];
      const bool flag = a.flag[i] != 0, valid = a.kmask[i] != 0;
      const float cf = static_cast<float>(c);
      const bool ci = flag && cf >= a.lower && cf <= a.upper;
      const bool trigger = cf < a.lower && f >= 2 && valid;
      const bool verify = cf <= a.lower && f >= 2;
      const int fe = (flag && f == 1) ? 2 : f;
      kinfo[k] = static_cast<uint32_t>(c) | (static_cast<uint32_t>(fe) << 8) |
                 (valid ? kValid : 0u) | (verify ? kVerify : 0u);
      for (int w = 0; w < W; ++w) {
        const uint32_t h = a.bits[i * W + w] | (ci ? gt0w[w] : 0u);
        eff[k * W + w] = h;
        if (trigger && h) atomicOr(&need[w], h);
      }
      if (valid) atomicMax(kend, k + 1);
    }
    __syncthreads();

    // the verification decrement, and the term table
    for (int k = tid; k < K; k += blockDim.x) {
      if (!(kinfo[k] & kVerify)) continue;
      const long i = r * K + k;
      for (int w = 0; w < W; ++w)
        eff[k * W + w] &= ~(need[w] & ~a.local[i * W + w]);
    }
    const int kn = *kend;
    for (int j = tid; j < kn * (P + 1); j += blockDim.x) {
      const int k = j / (P + 1);
      term[j] = emission_term(kinfo[k], j - k * (P + 1), meanv, logmean, lg, a);
    }
    __syncthreads();

    // a thread per state: four partial sums, of the k-mers k = j (mod 4) in
    // ascending k, joined as (a0 + a1) + (a2 + a3)
    for (int s = tid; s < a.S; s += blockDim.x) {
      const long gs = g * a.S + s;
      float acc = -INFINITY;
      if (a.smask[gs]) {
        int off[P];
        uint32_t sh[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int u = __ldg(a.state_u + gs * P + p);
          off[p] = u >> 5;
          sh[p] = static_cast<uint32_t>(u & 31);
        }
        // term[k][h(k, s)]
        auto term_of = [&](int k) {
          int h = 0;
          if (kOneWord) {
            const uint32_t e = eff[k];
#pragma unroll
            for (int p = 0; p < P; ++p) h += (e >> sh[p]) & 1u;
          } else {
            const uint32_t* e = eff + k * W;
#pragma unroll
            for (int p = 0; p < P; ++p) h += (e[off[p]] >> sh[p]) & 1u;
          }
          return term[k * (P + 1) + h];
        };
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        int k = 0;
        for (; k + 4 <= kn; k += 4) {
          a0 += term_of(k);
          a1 += term_of(k + 1);
          a2 += term_of(k + 2);
          a3 += term_of(k + 3);
        }
        if (k < kn) a0 += term_of(k);
        if (k + 1 < kn) a1 += term_of(k + 1);
        if (k + 2 < kn) a2 += term_of(k + 2);
        acc = (a0 + a1) + (a2 + a3);
      }
      a.out[r * a.S + s] = acc;
    }
  }
}

template <int P, bool kOneWord>
int launch(const Args& a, cudaStream_t stream) {
  const int threads = a.S <= kSmallThreads ? kSmallThreads : kThreads;
  const size_t smem = 4 * shared_words(a.K, a.W, P);
  auto kernel = emissions_kernel<P, kOneWord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long grid = a.rows < static_cast<long>(sms) * per_sm
                        ? a.rows
                        : static_cast<long>(sms) * per_sm;
  kernel<<<static_cast<unsigned>(grid), threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_p(const Args& a, cudaStream_t stream) {
  return a.W == 1 ? launch<P, true>(a, stream) : launch<P, false>(a, stream);
}

}  // namespace

// c, f, flag, kmask: uint8/bool [G, N, K]; bits, local: uint32 words
// [G, N, K, W]; gt0: bool [G, N, 32 W]; state_u: int32 [G, S, P], each valid
// state's slots in 0..32 W - 1; smask: bool [G, S]; out: float32 [G, N, S];
// 1 <= P <= 8, W >= 1.  Launches on `stream` and returns cudaGetLastError()
// as an int (0 = the launch was accepted).
extern "C" int vg_emissions(const void* c, const void* f, const void* flag,
                            const void* kmask, const void* bits,
                            const void* local, const void* gt0,
                            const void* state_u, const void* smask, void* out,
                            long G, long N, int S, int K, int W, int P,
                            float ave, float lower, float upper, float log_p,
                            float log_q, float log_prior, void* stream) {
  if (G == 0 || N == 0 || S == 0) return 0;
  if (P < 1 || P > kMaxP || W < 1 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint8_t*>(c),     static_cast<const uint8_t*>(f),
         static_cast<const uint8_t*>(flag),  static_cast<const uint8_t*>(kmask),
         static_cast<const uint32_t*>(bits), static_cast<const uint32_t*>(local),
         static_cast<const uint8_t*>(gt0),   static_cast<const int*>(state_u),
         static_cast<const uint8_t*>(smask), static_cast<float*>(out),
         G * N, N, S, K, W, ave, lower, upper, log_p, log_q, log_prior};
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
