// Posterior of the genotyping HMM for Hopper (sm_90a).
//
//   vg_posterior  each real node's record numbers from its alpha and beta
//
// Replaces no TPU or XLA kernel: the JAX engine's posterior is host numpy
// (varigraph_tpu/genotype/engine_jax.py:788), and so was the port's until
// this kernel.  It was added because that host pass was the largest block of
// a sample's time: alpha and beta, [G, N, S] float32, were copied to the
// host after the forward/backward and reduced there in float64 numpy, while
// the card idled.  Here the reduction runs on the card where alpha and beta
// already are, and only 16 + 8 P bytes a node come back.  The plain version
// is ops/post.posterior_plain (posterior_window_np, a window at a time).
//
// What it computes, per node row (g, n) with kind == 1, over the window's
// valid states s (the used-hap slots u_{s,0..P-1}) and the row's k-mers:
//   den     = sum_s alpha_s * beta_s in float64 (each product is exact)
//   post_s  = alpha_s * beta_s / den, or 0 where den == 0
//   key_s   = the GT values of u_{s,0..P-1} at this node, sorted ascending
//             and packed in 8-bit fields, the first in the highest
//   fallback: a GT above 9 among the states' haps (the host then groups
//             by strings, as std::map<string> does, from the row's alpha
//             and beta, which it copies back)
//   else    the key of the largest sum of post (the smallest key of equal
//             sums), its state of the strictly largest post (the smallest
//             s of equal ones; none when that post is 0), and that state's
//             NAK_p (valid k-mers whose bit u_{s,p} is set) and CAK_p (the
//             sum of their c);
//   uk      = min(#{valid k-mers with f <= 1}, 255).
// Every float64 sum is taken in the plain version's order, so the outputs
// equal its bits: den is numpy's pairwise sum (a block of up to 128 values
// as 8 strided partial sums joined as ((r0 + r1) + (r2 + r3)) + ((r4 + r5)
// + (r6 + r7)), then the block's tail in order; a longer row as its two
// halves, cut at a multiple of 8), and a key's sum is the difference of a
// running sum (numpy's cumsum) carried over the states in ascending key,
// then ascending s, before and after the key's states.  The printed GQ
// reads 1 - GPP, so an ulp of GPP near 1 shows in the VCF.
//
// Bound: bytes.  A node reads 8 S bytes of alpha and beta and its k-mer
// rows (K (3 + 4 W) bytes): ~45 MB for a sample of 23k nodes at S = 120,
// K = 128, ~16 us at 3.35 TB/s.
//
// Layout.  A warp takes a node row; its lanes take the states s = lane +
// 32 j.  Nothing is staged: a key is recomputed where it is needed from the
// window's state slots and the row's GT bytes (P loads that the L1 holds,
// and a sorting network in registers), and post_s from alpha and beta, so
// the kernel holds nothing that grows with S or with the number of keys and
// takes any S.  den: lanes 0-7 take a block's 8 partial sums, three
// shuffles join them, and a small stack walks numpy's halving.  The
// distinct keys are walked in ascending order, one pass over the states a
// key: the pass that adds the current key's post to the running sum (the
// lanes holding one, a __ballot_sync of them taken in lane order and each
// post shuffled to every lane) also finds the next larger key (a warp min),
// so a node of D keys takes D + 2 passes (a biallelic diploid node has at
// most 3 keys).  Every lane holds the same sums, and each sum's order is
// fixed by the row alone: a node's outputs are the same from run to run and
// wherever its window sits in the group.  Templated on P (1..8).

#include <assert.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 8;
constexpr int kWarps = 8;                 // warps (node rows) a CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoWinner = -1, kFallback = -2;
// no key: above every key of a node whose GT values are at most 9
constexpr uint64_t kNone = ~0ull;

struct Args {
  const float* alpha;     // [G, N, S]
  const float* beta;      // [G, N, S]
  const int* kind;        // [G, N]
  const uint8_t* gt;      // [G, N, U]
  const int* state_u;     // [G, S, P]
  const uint8_t* smask;   // [G, S]
  const uint8_t* c;       // [G, N, K]
  const uint8_t* f;       // [G, N, K]
  const uint8_t* kmask;   // [G, N, K]
  const uint32_t* bits;   // [G, N, K, W]
  int* out;               // [G, N, 4 + 2P]
  long rows_total;        // G * N
  long N;
  int S, K, W, U;
};

__device__ __forceinline__ double ab(const float* al, const float* be, int s) {
  return static_cast<double>(al[s]) * static_cast<double>(be[s]);
}

// numpy's pairwise_sum of one block of m <= 128 products from o; every lane
// gets the sum
__device__ double block_sum(const float* al, const float* be, int o, int m, int lane) {
  if (m < 8) {
    double r = 0.0;
    for (int i = 0; i < m; ++i) r += ab(al, be, o + i);
    return r;
  }
  const int m8 = m - m % 8;
  double r = 0.0;
  if (lane < 8) {
    r = ab(al, be, o + lane);
    for (int i = lane + 8; i < m8; i += 8) r += ab(al, be, o + i);
  }
  r += __shfl_down_sync(kFull, r, 1);     // lanes 0, 2, 4, 6: r0+r1, r2+r3, ...
  r += __shfl_down_sync(kFull, r, 2);     // lanes 0, 4
  r += __shfl_down_sync(kFull, r, 4);     // lane 0
  double res = __shfl_sync(kFull, r, 0);
  for (int i = m8; i < m; ++i) res += ab(al, be, o + i);
  return res;
}

// numpy's pairwise_sum of the products 0..n-1: a block up to 128, else the
// sum of the two halves, cut at n / 2 rounded down to a multiple of 8
__device__ double pairwise_sum(const float* al, const float* be, int n, int lane) {
  constexpr int kDepth = 32;
  int off[kDepth], len[kDepth], stage[kDepth];
  double left[kDepth];
  int sp = 0;
  off[0] = 0;
  len[0] = n;
  stage[0] = 0;
  double ret = 0.0;
  while (sp >= 0) {
    const int m = len[sp];
    if (m <= 128) {
      ret = block_sum(al, be, off[sp], m, lane);
      --sp;
      continue;
    }
    const int h = m / 2 - (m / 2) % 8;
    if (stage[sp] == 0) {                 // the first half
      stage[sp] = 1;
      off[sp + 1] = off[sp];
      len[sp + 1] = h;
      stage[++sp] = 0;
    } else if (stage[sp] == 1) {          // the second half
      left[sp] = ret;
      stage[sp] = 2;
      off[sp + 1] = off[sp] + h;
      len[sp + 1] = m - h;
      stage[++sp] = 0;
    } else {
      ret = left[sp] + ret;
      --sp;
    }
  }
  return ret;
}

__device__ __forceinline__ uint64_t warp_min(uint64_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// state s's genotype key at this node; gmax takes the largest GT value seen
template <int P>
__device__ __forceinline__ uint64_t state_key(const int* su, const uint8_t* g_row,
                                              int U, int& gmax) {
  int v[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int u = su[p];
    assert(u >= 0 && u < U && "a valid state's slot is outside 0..32 W - 1");
    v[p] = g_row[u];
    gmax = max(gmax, v[p]);
  }
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j + 1 < P - i; ++j) {
      const int lo = min(v[j], v[j + 1]), hi = max(v[j], v[j + 1]);
      v[j] = lo;
      v[j + 1] = hi;
    }
  uint64_t key = 0;
#pragma unroll
  for (int p = 0; p < P; ++p) key = key << 8 | static_cast<uint64_t>(v[p]);
  return key;
}

template <int P>
__global__ void __launch_bounds__(32 * kWarps) posterior_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long r = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= a.rows_total) return;          // the whole warp
  constexpr int R = 4 + 2 * P;
  int* o = a.out + r * R;
  if (a.kind[r] != 1) {
    if (lane < R) o[lane] = lane == 2 ? kNoWinner : 0;
    return;
  }
  const int S = a.S;
  const long g = r / a.N;
  const float* al = a.alpha + r * S;
  const float* be = a.beta + r * S;
  const int* su = a.state_u + g * S * P;
  const uint8_t* sm = a.smask + g * S;
  const uint8_t* gr = a.gt + r * a.U;
  const long rk = r * a.K;

  // the valid states are the first nv; the largest GT, the smallest key
  int nv = 0;
  for (int s0 = 0; s0 < S; s0 += 32)
    nv += __popc(__ballot_sync(kFull, s0 + lane < S && sm[s0 + lane]));
  int gmax = 0;
  uint64_t cur = kNone;
  for (int s = lane; s < nv; s += 32) {
    const uint64_t k = state_key<P>(su + s * P, gr, a.U, gmax);
    cur = k < cur ? k : cur;
  }
  gmax = __reduce_max_sync(kFull, gmax);
  cur = warp_min(cur);

  int uk = 0;
  for (int k = lane; k < a.K; k += 32) uk += a.kmask[rk + k] && a.f[rk + k] <= 1;
  uk = min(__reduce_add_sync(kFull, uk), 255);

  if (gmax > 9) {                          // the host's string path
    if (lane < R) o[lane] = lane == 2 ? kFallback : lane == 3 ? uk : 0;
    return;
  }
  const double den = pairwise_sum(al, be, nv, lane);
  auto post = [&](int s) { return den != 0.0 ? ab(al, be, s) / den : 0.0; };

  // the keys in ascending order: carry the running sum over the current
  // key's states in s order, find the next key
  double run = 0.0, best = -INFINITY;
  uint64_t best_key = kNone;
  while (cur != kNone) {
    const double before = run;
    uint64_t next = kNone;
    for (int s0 = 0; s0 < nv; s0 += 32) {
      const int s = s0 + lane;
      double p = 0.0;
      bool in = false;
      if (s < nv) {
        const uint64_t k = state_key<P>(su + s * P, gr, a.U, gmax);
        if (k == cur) {
          in = true;
          p = post(s);
        } else if (k > cur && k < next) {
          next = k;
        }
      }
      for (unsigned m = __ballot_sync(kFull, in); m; m &= m - 1)
        run += __shfl_sync(kFull, p, __ffs(m) - 1);
    }
    const double total = run - before;
    if (total > best) {                    // strict: the smaller key keeps a tie
      best = total;
      best_key = cur;
    }
    cur = warp_min(next);
  }

  // the winner key's first state of the strictly largest post
  double bp = 0.0;
  int bs = kNoWinner;
  for (int s = lane; s < nv; s += 32) {
    if (state_key<P>(su + s * P, gr, a.U, gmax) != best_key) continue;
    const double p = post(s);
    if (p > bp) {
      bp = p;
      bs = s;
    }
  }
#pragma unroll
  for (int o2 = 16; o2 > 0; o2 >>= 1) {
    const double op = __shfl_xor_sync(kFull, bp, o2);
    const int os = __shfl_xor_sync(kFull, bs, o2);
    if (op > bp || (op == bp && os < bs)) {
      bp = op;
      bs = os;
    }
  }

  // NAK and CAK of the winner's haps, in state order
  int nak[P], cak[P], slot[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    nak[p] = cak[p] = 0;
    slot[p] = bs >= 0 ? su[bs * P + p] : 0;
  }
  if (bs >= 0) {
    for (int k = lane; k < a.K; k += 32) {
      if (!a.kmask[rk + k]) continue;
      const uint32_t* w = a.bits + (rk + k) * a.W;
      const int cc = a.c[rk + k];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int bit = (w[slot[p] >> 5] >> (slot[p] & 31)) & 1;
        nak[p] += bit;
        cak[p] += bit * cc;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    nak[p] = __reduce_add_sync(kFull, nak[p]);
    cak[p] = __reduce_add_sync(kFull, cak[p]);
  }
  if (lane == 0) {
    o[0] = __double2loint(best);
    o[1] = __double2hiint(best);
    o[2] = bs;
    o[3] = uk;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      o[4 + p] = nak[p];
      o[4 + P + p] = cak[p];
    }
  }
}

template <int P>
int launch_p(const Args& a, cudaStream_t st) {
  const long blocks = (a.rows_total + kWarps - 1) / kWarps;
  posterior_kernel<P><<<static_cast<unsigned>(blocks), 32 * kWarps, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// alpha, beta float32 [G, N, S]; kind int32 [G, N]; gt uint8 [G, N, 32 W];
// state_u int32 [G, S, P] (a valid state's slots in 0..32 W - 1, else a
// device assert fails); smask, kmask bool; c, f uint8 [G, N, K]; bits
// uint32 [G, N, K, W]; out int32 [G, N, 4 + 2P].
// Returns the launch's CUDA error, 0 on success.
extern "C" int vg_posterior(const void* alpha, const void* beta, const void* kind,
                            const void* gt, const void* state_u, const void* smask,
                            const void* c, const void* f, const void* kmask,
                            const void* bits, void* out, long G, long N,
                            int S, int K, int W, int P, void* stream) {
  if (G == 0 || N == 0) return 0;
  if (P < 1 || P > kMaxP || W < 1 || K < 0 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(alpha),   static_cast<const float*>(beta),
         static_cast<const int*>(kind),      static_cast<const uint8_t*>(gt),
         static_cast<const int*>(state_u),   static_cast<const uint8_t*>(smask),
         static_cast<const uint8_t*>(c),     static_cast<const uint8_t*>(f),
         static_cast<const uint8_t*>(kmask), static_cast<const uint32_t*>(bits),
         static_cast<int*>(out),             G * N,
         N, S, K, W, 32 * W};
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
