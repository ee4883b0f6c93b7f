// Forward/backward scan of the genotyping HMM for Hopper (sm_90a).
//
//   vg_forward_backward  alpha[w, i, :] and beta[w, i, :] of every window w
//
// Replaces, on the TPU side, the lax.scan over nodes, vmapped over windows,
// of varigraph_tpu/genotype/engine_jax.py:192-264 (_forward_backward).  The
// port's plain version is genotype/engine_torch._scan, a Python loop that
// issues ~15 torch operations a node.
//
// What it computes, per window w and direction d (d = 0: forward over
// i = 0..N-1 with log_rec_f/log_norec_f into alpha; d = 1: backward over
// i = N-1..0 with log_rec_b/log_norec_b into beta), from a zero row and a
// fresh chain:
//   kind 1 (real):  mx = the max of logE[w, i, j] over the valid states j
//                   e[j] = valid[j] ? exp(logE[w, i, j] - mx) : 0
//                   flow[j] = sum_s row[s] * t[ov[s, j]]               (rec)
//                           = (sum_s row[s]) * exp(valid ? log_w[j] : 0) (fre)
//                   t[c] = exp(c * lnr + (P - c) * lr), where a product
//                          whose factor c or P - c is 0 is 0 (so at rec = 0,
//                          lr = -inf: t[P] = norec^P, every other t[c] = 0),
//                          and t[c] = 0 for a class above P
//                   raw = fresh ? e : flow * e;  tot = sum_j raw[j]
//                   row = tot > 0 ? raw / tot : uniform  (valid / #valid)
//                   the output row is row; the chain is no longer fresh
//   kind 0 (pad):   row kept, output row 0
//   kind 2 (reset): row kept, output row 0, the chain fresh again
// Padded states (valid false) come out 0 and enter neither tot nor the
// uniform row.
//
// The flow from the nonzero overlap classes.  Class-0 entries all weigh t[0],
// so with R = sum_s row[s] and acc_c[j] = sum over s with ov[s, j] = c of
// row[s]:  flow[j] = t[0] * R + sum_{c >= 1} (t[c] - t[0]) * acc_c[j].  Every
// t[c] - t[0] is >= 0 (norec >= rec), so the form does not cancel.  The
// engine's states are pairs of haplotypes and most of their overlap is class
// 0 (at S = 120, 3,270 of 14,400 entries are not), so a state sums only its
// column's nonzero entries.  The wrapper (ops/fb_cuda.fb_layout) lists them
// per column, grouped by class, each group padded to the window's longest
// (the pad index S reads a zero); a column that holds a class above P lists
// its class-0 entries instead of taking t[0] * R, and leaves the classes
// above P out, so they weigh exactly 0.  A list word holds two uint16 state
// indices (slot-major, so a warp's words are consecutive).  Every path sums
// a column word by word in list order, acc = (row[s0] + row[s1]) / tot and
// flow += (t[c] - t[0]) * acc, with no contraction, so the path a launch
// takes does not change a bit of the result.
//
// Layout.  Grid (W, 2): one CTA for each window and direction, so the
// forward and the backward chains of a window run side by side; the node
// loop runs inside the CTA.  The row is kept unnormalized in a double
// buffer, so R of the normalized row is tot / tot = 1 and the gather of step
// i + 1 scales by 1 / tot; the write of step i and the reads of step i + 1
// need no second barrier.  The max of logE of the next step does not depend
// on the chain: it is formed in step i and reduced with step i's tot, so a
// real step takes one barrier (two after a pad or reset step).
//   fb_kernel (S <= 1024): thread j owns state j and keeps its per-step
//     values in registers; logE comes into a shared ring 8 steps at a time
//     with cp.async, each thread copying and reading only its own state, so
//     the ring needs no barrier.  Up to S = 512 and 32 words a column, a
//     thread keeps its column's words in registers as byte offsets, and the
//     weight of every word for every step of a 256-step tile is computed when
//     the tile is staged: a step's gather is then 2 shared loads a word and
//     one 16-byte weight load for 4 words, with no branch (fb_kernel<16 or
//     32>).  Else (fb_kernel<0>) the lists sit in shared memory while they
//     fit beside the per-state arrays, or are read from device memory, a
//     class at a time with class weights published a step ahead.
//   fb_wide_kernel (S > 1024): thread tid owns the states j = tid (mod
//     1024) and keeps nothing a state in registers: the raw row is the
//     shared row buffer, logE is read from device memory where it is used.
//     12 shared bytes a state (two rows and the uniform row), so a launch
//     takes up to ~18,800 states on an H100 (vg_fb_max_states).
//
// Determinism.  The max and the sums are block reductions in a fixed order
// (a warp butterfly, then the warps' partials in warp order, or above 8
// warps a second butterfly), with no atomics, and flow[j] is summed by one
// thread in a fixed order.  A window's rows depend only on its own inputs
// and S, bit for bit, whatever W is and wherever the window sits in the
// batch.  They agree with the plain version (which sums per overlap class
// through a matrix product) to float32 rounding, not bit for bit.  expf,
// IEEE division, no fast math.
//
// What bounds it on an H100.  Each direction reads logE once and writes one
// [N, S] row block: 4 * W*N*S*4 bytes in all; the rec flow is 2 operations an
// overlap entry that is not class 0, a step (chip_smoke.py computes both:
// bytes bound it at S = 120 and 465).  In practice the chain is serial and a
// step's instructions pace it: at S = 120 all 512 CTAs of a 256-window group
// are resident (4 an SM) and the SM issues ~16 warps' steps at once; a step
// is a barrier, two 5-level shuffle reductions, an exp, a reciprocal and the
// gather.  At S = 465 two CTAs share an SM and the gathers' shared loads
// take the larger part of a step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;        // steps of kind/lr/lnr staged at once
constexpr int kClasses = 256;     // weights cover every uint8 overlap class
constexpr int kMaxThreads = 1024;
constexpr int kChunk = 8;         // steps of logE a cp.async group brings
constexpr int kRegWords = 32;     // list words a thread may hold in registers
constexpr int kRegThreads = 512;  // the most threads of a CTA that does
constexpr long kMaxStates = 32767;  // state indices are int16 in the lists

// shared bytes both kernels carve first: the two steps' class weights (and
// t[0]), five reduction buffers of 32 floats, the class offsets, the staged
// kind/lr/lnr (one step past the tile), the zero pads of the two rows and of
// the uniform row
constexpr int kCommonBytes =
    4 * (2 * (kClasses + 1) + 5 * 32 + (kClasses + 1) + 3 * (kTile + 1) + 3);
// per-state shared bytes of both: two rows and the uniform row
constexpr int kRowBytes = 4 * 3;
// fb_kernel's more: its logE ring of two chunks
constexpr int kRingBytes = 4 * 2 * kChunk;
// the register-list kernel's tile of weights (a weight for every word and
// t[0], for every step of the tile) and the words' classes
constexpr int tile_weight_bytes(int words) {
  return 4 * ((kTile + 1) * (words + 1) + kRegWords);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// t[c] = exp(c * lnr + (P - c) * lr), a factor of 0 giving 0; the products
// are rounded apart (no contraction), so every call site gives the same bits
__device__ __forceinline__ float class_weight(int c, int P, float lr, float lnr) {
  const float a = c == 0 ? 0.f : __fmul_rn(static_cast<float>(c), lnr);
  const float b = P - c == 0 ? 0.f : __fmul_rn(static_cast<float>(P - c), lr);
  return expf(a + b);
}

// one list word into the flow: acc = (row[s0] + row[s1]) / tot, f += w * acc
// (and all += acc), in this order in every path
__device__ __forceinline__ void add_word(float r0, float r1, float w, float inv,
                                         float& f, float& all) {
  const float acc = __fmul_rn(r0 + r1, inv);
  all += acc;
  f = fmaf(w, acc, f);
}

// sum_k w_k * (row[s_k0] + row[s_k1]) * inv over a register list's words
// (into f), and with kAll the unweighted sum too (into all).  The words past
// the column's own carry weight 0 and read 0, so they leave f and all as
// they are, and the sums equal gather_list's.
template <int kWords, bool kAll>
__device__ __forceinline__ void gather_words(const char* sb, const float4* ww,
                                             const uint32_t* off, float inv,
                                             float& f, float& all) {
  float none = 0.f;
#pragma unroll
  for (int k4 = 0; k4 < kWords / 4; ++k4) {
    const float4 w4 = ww[k4];
    const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * k4 + u;
      add_word(*reinterpret_cast<const float*>(sb + off[2 * k]),
               *reinterpret_cast<const float*>(sb + off[2 * k + 1]), wk[u], inv,
               f, kAll ? all : none);
    }
  }
}

// the flow sums of column j from its list (p: the column's first word,
// words S apart), class by class with the class weights d[c]
__device__ __forceinline__ void gather_list(const uint32_t* p, int S,
                                            const int* goff, int P,
                                            const float* src, const float* d,
                                            float inv, float& f, float& all) {
  for (int c = 0; c <= P; ++c) {
    const int k1 = goff[c + 1] >> 1;
    const float dc = d[c];
    for (int k = goff[c] >> 1; k < k1; ++k) {
      const uint32_t v = p[static_cast<size_t>(k) * S];
      add_word(src[v & 0xffffu], src[v >> 16], dc, inv, f, all);
    }
  }
}

// the class weights of one step into d: d[c] = t[c] - t[0], t[0] last
__device__ __forceinline__ void publish(float* d, int P, float lr, float lnr,
                                        int tid, int nt) {
  for (int c = tid; c <= P; c += nt) {
    const float t0 = class_weight(0, P, lr, lnr);
    d[c] = class_weight(c, P, lr, lnr) - t0;
    if (c == 0) d[kClasses] = t0;
  }
}

// the shared arrays both kernels use, carved from p
struct Common {
  float* wbuf;     // [2][kClasses + 1], the list path's class weights
  float* red_tot;  // [2][32]
  float* red_mx;   // [2][32]
  float* red_x;    // [32], the max after a pad or reset step
  int* goff;       // [kClasses + 1]
  int* kind;       // [kTile + 1]
  float* lr;       // [kTile + 1]
  float* lnr;      // [kTile + 1]
  float* rows;     // [2][S + 1], raw rows
  float* uni;      // [S + 1]
  float* end;      // what follows
};

__device__ __forceinline__ Common carve(float* p, int S) {
  Common s;
  s.wbuf = p;
  s.red_tot = s.wbuf + 2 * (kClasses + 1);
  s.red_mx = s.red_tot + 2 * 32;
  s.red_x = s.red_mx + 2 * 32;
  s.goff = reinterpret_cast<int*>(s.red_x + 32);
  s.kind = s.goff + kClasses + 1;
  s.lr = reinterpret_cast<float*>(s.kind + kTile + 1);
  s.lnr = s.lr + kTile + 1;
  s.rows = s.lnr + kTile + 1;
  s.uni = s.rows + 2 * (S + 1);
  s.end = s.uni + S + 1;
  return s;
}

// kind/lr/lnr of steps n .. n + kTile (node order of the direction)
__device__ __forceinline__ void stage_tile(const Common& s, const int32_t* kind_w,
                                           const float* lr_w, const float* lnr_w,
                                           int n, int N, bool back, int tid,
                                           int nt) {
  for (int k = tid; k <= kTile && n + k < N; k += nt) {
    const int ii = back ? N - 1 - (n + k) : n + k;
    s.kind[k] = kind_w[ii];
    s.lr[k] = lr_w[ii];
    s.lnr[k] = lnr_w[ii];
  }
}

// the block's sum of tsum and max of nm into every thread (one barrier)
__device__ __forceinline__ void reduce_step(const Common& s, int cur, float tsum,
                                           float nm, int lane, int warp,
                                           int nwarps, float& tot, float& nmx) {
  tsum = warp_sum(tsum);
  nm = warp_max(nm);
  if (lane == 0) {
    s.red_tot[cur * 32 + warp] = tsum;
    s.red_mx[cur * 32 + warp] = nm;
  }
  __syncthreads();
  if (nwarps <= 8) {  // the warps' partials in warp order
    tot = s.red_tot[cur * 32];
    nmx = s.red_mx[cur * 32];
    for (int k = 1; k < nwarps; ++k) {
      tot += s.red_tot[cur * 32 + k];
      nmx = fmaxf(nmx, s.red_mx[cur * 32 + k]);
    }
  } else {  // lane k takes warp k's; a butterfly gives every lane the same
    tot = warp_sum(lane < nwarps ? s.red_tot[cur * 32 + lane] : 0.f);
    nmx = warp_max(lane < nwarps ? s.red_mx[cur * 32 + lane] : -INFINITY);
  }
}

// the block's max of mm into every thread (one barrier)
__device__ __forceinline__ float reduce_max(const Common& s, float mm, int lane,
                                            int warp, int nwarps) {
  mm = warp_max(mm);
  if (lane == 0) s.red_x[warp] = mm;
  __syncthreads();
  float mx = s.red_x[0];
  for (int k = 1; k < nwarps; ++k) mx = fmaxf(mx, s.red_x[k]);
  return mx;
}

// One state a thread (j = tid, S <= 1024).  kWords > 0: the lists sit in
// registers (at most kWords words a column, at most kRegThreads threads) and
// every word has its own weight; all kWords words are summed, with no
// branch, so that the gathers of a step issue back to back (a pad word reads
// 0 and weighs 0).  kWords == 0: they are read from shared or device memory
// (``lists_shared``) a class at a time.  The 16-word kernel may take up to
// 128 registers (4 CTAs of 128 threads an SM at S = 120); the 32-word one at
// most 64, so that 2 CTAs of 480 threads share an SM at S = 465.
template <int kWords>
__global__ void __launch_bounds__(kWords > 0 ? kRegThreads : kMaxThreads,
                                  kWords == kRegWords ? 2 : 1)
fb_kernel(const float* __restrict__ logE, const int32_t* __restrict__ kind,
          const float* __restrict__ lrf, const float* __restrict__ lnrf,
          const float* __restrict__ lrb, const float* __restrict__ lnrb,
          const uint32_t* __restrict__ lists, const int32_t* __restrict__ goff,
          const uint8_t* __restrict__ full, const float* __restrict__ log_w,
          const uint8_t* __restrict__ smask, float* __restrict__ alpha_out,
          float* __restrict__ beta_out, int N, int S, int P, int pairs,
          int lists_shared, int fre) {
  constexpr bool kRegs = kWords > 0;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wtile = reinterpret_cast<float*>(smem);  // [kTile + 1][kWords]
  float* wt0 = wtile + (kTile + 1) * kWords;      // [kTile + 1] (kRegs)
  int* wcls_s = reinterpret_cast<int*>(wt0 + (kRegs ? kTile + 1 : 0));
  const Common sh = carve(reinterpret_cast<float*>(wcls_s + (kRegs ? kRegWords : 0)), S);
  float* ring = sh.end;                           // [2 * kChunk][S]
  uint32_t* lists_s = reinterpret_cast<uint32_t*>(ring + 2 * kChunk * S);

  const int w = blockIdx.x;
  const bool back = blockIdx.y == 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const bool in = tid < S;
  const size_t ws = static_cast<size_t>(w) * S;
  const float* le_w = logE + static_cast<size_t>(w) * N * S;
  float* out = (back ? beta_out : alpha_out) + static_cast<size_t>(w) * N * S;
  const int32_t* kind_w = kind + static_cast<size_t>(w) * N;
  const float* lr_w = (back ? lrb : lrf) + static_cast<size_t>(w) * N;
  const float* lnr_w = (back ? lnrb : lnrf) + static_cast<size_t>(w) * N;
  const uint32_t* lists_w = lists + static_cast<size_t>(w) * pairs * S;
  const uint32_t* lst = lists_shared ? lists_s : lists_w;
  auto node = [&](int n) { return back ? N - 1 - n : n; };
  // logE of chunk c (steps c*kChunk ..) into its half of the ring, one group
  const long row_step = back ? -static_cast<long>(S) : S;
  auto fetch = [&](int c) {
    float* dst = ring + (c & 1) * kChunk * S + tid;
    const int st0 = c * kChunk;
    const int steps = N - st0 < kChunk ? N - st0 : kChunk;
    const float* src = le_w + static_cast<long>(node(st0)) * S + tid;
    for (int k = 0; in && k < steps; ++k, src += row_step, dst += S)
      cp_async4(dst, src);
    cp_async_commit();
  };
  fetch(0);

  // the state's constants: whether it is valid (its uniform value > 0), its
  // fre weight, whether its column lists class 0
  const bool v = in && smask[ws + tid] != 0;
  const float ewj = expf(v ? log_w[ws + tid] : 0.f);
  const bool fj = in && !fre && full[ws + tid] != 0;
  if (in) {
    sh.rows[tid] = 0.f;
    sh.rows[S + 1 + tid] = 0.f;
  }
  if (tid == 0) {
    sh.rows[S] = 0.f;
    sh.rows[2 * S + 1] = 0.f;
    sh.uni[S] = 0.f;
  }
  if (!fre) {
    for (int c = tid; c <= P + 1; c += nt) sh.goff[c] = goff[static_cast<size_t>(w) * (P + 2) + c];
    if (!kRegs && lists_shared) {
      for (size_t q = tid; q < static_cast<size_t>(pairs) * S; q += nt) lists_s[q] = lists_w[q];
    }
  }
  const float cnt = warp_sum(v ? 1.f : 0.f);
  if (lane == 0) sh.red_tot[32 + warp] = cnt;
  __syncthreads();
  float nvalid = 0.f;
  for (int q = 0; q < nwarps; ++q) nvalid += sh.red_tot[32 + q];
  const float uj = v ? 1.f / nvalid : 0.f;
  if (in) sh.uni[tid] = uj;
  const float us = warp_sum(uj);
  if (lane == 0) sh.red_mx[32 + warp] = us;
  // goff is visible after this barrier; whether any column of the window
  // lists class 0 (then the gather also sums the listed entries unweighted)
  const bool any_full = __syncthreads_or(fj) != 0;
  float usum = 0.f;  // the uniform row's sum, its R
  for (int q = 0; q < nwarps; ++q) usum += sh.red_mx[32 + q];
  // (the next writes of red_tot[1], red_mx[1] come after the tile's barriers)
  const int nwords = fre ? 0 : sh.goff[P + 1] >> 1;
  // (kRegs) the byte offsets of the two states of each list word
  uint32_t off[kRegs ? 2 * kWords : 1];
  if (kRegs) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const uint32_t x = k < nwords && in
                             ? lists_w[static_cast<size_t>(k) * S + tid]
                             : static_cast<uint32_t>(S) | (static_cast<uint32_t>(S) << 16);
      off[2 * k] = (x & 0xffffu) * 4u;
      off[2 * k + 1] = (x >> 16) * 4u;
    }
    // the class of each word (-1: a pad word, weight 0)
    if (tid < kWords) {
      int c = -1;
      for (int q = 0; q <= P && tid < nwords; ++q)
        if (sh.goff[q] <= 2 * tid && 2 * tid < sh.goff[q + 1]) c = q;
      wcls_s[tid] = c;
    }
  }
  cp_async_wait_all();  // chunk 0

  bool fresh = true;   // the same in every thread of the block
  bool ahead = false;  // this step's max and weights were formed last step
  int r = 0;           // real steps taken
  int knd_next = 0;
  float mx = -INFINITY;
  bool ok = false;     // the last real step's tot > 0
  float inv = 1.f;     // and then 1 / tot
  float le = -INFINITY;  // this step's logE, read a step ahead
  bool le_ready = false;
  float* out_next = out + static_cast<long>(node(0)) * S;
  for (int n = 0; n < N; ++n) {
    float* out_i = out_next;
    out_next += row_step;
    const int q = n % kTile;
    if (q == 0) {
      __syncthreads();  // every thread is done with the previous tile
      stage_tile(sh, kind_w, lr_w, lnr_w, n, N, back, tid, nt);
      __syncthreads();
      if constexpr (kRegs) {  // the tile's word weights, off the steps' path
        for (int e = tid; !fre && e < (kTile + 1) * kWords; e += nt) {
          const int k = e % kWords, rr = e / kWords;
          if (n + rr >= N) break;
          const float t0 = class_weight(0, P, sh.lr[rr], sh.lnr[rr]);
          const int c = wcls_s[k];
          wtile[e] = c < 0 ? 0.f : class_weight(c, P, sh.lr[rr], sh.lnr[rr]) - t0;
          if (k == 0) wt0[rr] = t0;
        }
        __syncthreads();
      }
      knd_next = sh.kind[0];
    }
    const int knd = knd_next;
    const bool has_next = n + 1 < N;
    if (has_next) knd_next = sh.kind[q + 1];
    // logE: chunk c + 1 is fetched as chunk c begins and waited for at
    // chunk c's last step, whose next-step max reads it
    if (n % kChunk == 0) fetch(n / kChunk + 1);
    if (n % kChunk == kChunk - 1) cp_async_wait_all();
    if (!le_ready) le = in ? ring[(n % (2 * kChunk)) * S + tid] : -INFINITY;
    le_ready = false;
    if (knd != 1) {
      if (in) out_i[tid] = 0.f;
      if (knd == 2) fresh = true;
      ahead = false;
      continue;
    }
    const int cur = r & 1;
    if (!ahead) {  // after a pad or reset step: this step's max and weights
      if (!fre && !kRegs) publish(sh.wbuf + cur * (kClasses + 1), P, sh.lr[q], sh.lnr[q], tid, nt);
      mx = reduce_max(sh, uj > 0.f ? le : -INFINITY, lane, warp, nwarps);
    }
    // the next step's logE, max and weights, published with this step's tot
    float lx = -INFINITY;
    if (has_next) {
      if (in) lx = ring[((n + 1) % (2 * kChunk)) * S + tid];
      if (!fre && !kRegs)
        publish(sh.wbuf + (cur ^ 1) * (kClasses + 1), P, sh.lr[q + 1], sh.lnr[q + 1], tid, nt);
    }

    const float* src = ok ? sh.rows + (cur ^ 1) * (S + 1) : sh.uni;
    const float rn = ok ? 1.f : usum;  // R of the normalized row
    const float* wb = sh.wbuf + cur * (kClasses + 1);
    const float t0 = kRegs ? wt0[q] : wb[kClasses];
    const float e = uj > 0.f ? expf(le - mx) : 0.f;
    float x;
    if (fresh) {
      x = e;
    } else if (fre) {
      x = (rn * ewj) * e;
    } else {
      // each class sum is scaled to the normalized row before it meets a
      // weight, which may be far below 1 (rec^P): so may the raw row
      float f = 0.f, all = 0.f;
      if constexpr (kRegs) {
        const char* sb = reinterpret_cast<const char*>(src);
        const float4* ww = reinterpret_cast<const float4*>(wtile + q * kWords);
        if (any_full)
          gather_words<kWords, true>(sb, ww, off, inv, f, all);
        else
          gather_words<kWords, false>(sb, ww, off, inv, f, all);
      } else if (in) {
        gather_list(lst + tid, S, sh.goff, P, src, wb, inv, f, all);
      }
      x = __fmul_rn(fmaf(t0, fj ? all : rn, f), e);
    }
    if (in) sh.rows[cur * (S + 1) + tid] = x;
    float tot, nmx;
    reduce_step(sh, cur, x, uj > 0.f ? lx : -INFINITY, lane, warp, nwarps, tot, nmx);
    mx = nmx;
    ahead = has_next;
    if (has_next) {
      le = lx;
      le_ready = true;
    }
    ok = tot > 0.f;
    inv = ok ? 1.f / tot : 1.f;
    if (in) out_i[tid] = ok ? x * inv : uj;
    fresh = false;
    ++r;
  }
  cp_async_wait_all();
}

// Any number of states a thread (j = tid + m * blockDim, S > 1024): the raw
// row is kept only in the shared row buffer, logE, the fre weights and the
// columns' full flags are read from device memory where they are used, and
// the lists from shared memory while they fit, else from device memory.  The
// same steps as fb_kernel<0>, in the same order.
__global__ void __launch_bounds__(kMaxThreads)
fb_wide_kernel(const float* __restrict__ logE, const int32_t* __restrict__ kind,
               const float* __restrict__ lrf, const float* __restrict__ lnrf,
               const float* __restrict__ lrb, const float* __restrict__ lnrb,
               const uint32_t* __restrict__ lists, const int32_t* __restrict__ goff,
               const uint8_t* __restrict__ full, const float* __restrict__ log_w,
               const uint8_t* __restrict__ smask, float* __restrict__ alpha_out,
               float* __restrict__ beta_out, int N, int S, int P, int pairs,
               int lists_shared, int fre) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Common sh = carve(reinterpret_cast<float*>(smem), S);
  uint32_t* lists_s = reinterpret_cast<uint32_t*>(sh.end);

  const int w = blockIdx.x;
  const bool back = blockIdx.y == 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t ws = static_cast<size_t>(w) * S;
  const float* le_w = logE + static_cast<size_t>(w) * N * S;
  float* out = (back ? beta_out : alpha_out) + static_cast<size_t>(w) * N * S;
  const int32_t* kind_w = kind + static_cast<size_t>(w) * N;
  const float* lr_w = (back ? lrb : lrf) + static_cast<size_t>(w) * N;
  const float* lnr_w = (back ? lnrb : lnrf) + static_cast<size_t>(w) * N;
  const uint32_t* lists_w = lists + static_cast<size_t>(w) * pairs * S;
  const uint32_t* lst = lists_shared ? lists_s : lists_w;
  auto row_of = [&](int n) { return static_cast<long>(back ? N - 1 - n : n) * S; };

  float cnt = 0.f;
  for (int j = tid; j < S; j += nt) {
    cnt += smask[ws + j] != 0 ? 1.f : 0.f;
    sh.rows[j] = 0.f;
    sh.rows[S + 1 + j] = 0.f;
  }
  if (tid == 0) {
    sh.rows[S] = 0.f;
    sh.rows[2 * S + 1] = 0.f;
    sh.uni[S] = 0.f;
  }
  if (!fre) {
    for (int c = tid; c <= P + 1; c += nt) sh.goff[c] = goff[static_cast<size_t>(w) * (P + 2) + c];
    if (lists_shared) {
      for (size_t q = tid; q < static_cast<size_t>(pairs) * S; q += nt) lists_s[q] = lists_w[q];
    }
  }
  cnt = warp_sum(cnt);
  if (lane == 0) sh.red_tot[32 + warp] = cnt;
  __syncthreads();
  float nvalid = 0.f;
  for (int q = 0; q < nwarps; ++q) nvalid += sh.red_tot[32 + q];
  float us = 0.f;
  for (int j = tid; j < S; j += nt) {
    const float u = smask[ws + j] != 0 ? 1.f / nvalid : 0.f;
    sh.uni[j] = u;
    us += u;
  }
  us = warp_sum(us);
  if (lane == 0) sh.red_mx[32 + warp] = us;
  __syncthreads();  // goff, the lists and the uniform row are visible
  float usum = 0.f;
  for (int q = 0; q < nwarps; ++q) usum += sh.red_mx[32 + q];

  bool fresh = true;
  bool ahead = false;
  int r = 0;
  int knd_next = 0;
  float mx = -INFINITY;
  bool ok = false;
  float inv = 1.f;
  for (int n = 0; n < N; ++n) {
    float* out_i = out + row_of(n);
    const float* le_n = le_w + row_of(n);
    const int q = n % kTile;
    if (q == 0) {
      __syncthreads();
      stage_tile(sh, kind_w, lr_w, lnr_w, n, N, back, tid, nt);
      __syncthreads();
      knd_next = sh.kind[0];
    }
    const int knd = knd_next;
    const bool has_next = n + 1 < N;
    if (has_next) knd_next = sh.kind[q + 1];
    if (knd != 1) {
      for (int j = tid; j < S; j += nt) out_i[j] = 0.f;
      if (knd == 2) fresh = true;
      ahead = false;
      continue;
    }
    const int cur = r & 1;
    if (!ahead) {
      if (!fre) publish(sh.wbuf + cur * (kClasses + 1), P, sh.lr[q], sh.lnr[q], tid, nt);
      float mm = -INFINITY;
      for (int j = tid; j < S; j += nt)
        if (sh.uni[j] > 0.f) mm = fmaxf(mm, le_n[j]);
      mx = reduce_max(sh, mm, lane, warp, nwarps);
    }
    float nm = -INFINITY;
    if (has_next) {
      const float* le_x = le_w + row_of(n + 1);
      for (int j = tid; j < S; j += nt)
        if (sh.uni[j] > 0.f) nm = fmaxf(nm, le_x[j]);
      if (!fre)
        publish(sh.wbuf + (cur ^ 1) * (kClasses + 1), P, sh.lr[q + 1], sh.lnr[q + 1], tid, nt);
    }

    const float* src = ok ? sh.rows + (cur ^ 1) * (S + 1) : sh.uni;
    const float rn = ok ? 1.f : usum;
    const float* wb = sh.wbuf + cur * (kClasses + 1);
    const float t0 = wb[kClasses];
    float* dst = sh.rows + cur * (S + 1);
    float tsum = 0.f;
    for (int j = tid; j < S; j += nt) {
      const float uj = sh.uni[j];
      const float e = uj > 0.f ? expf(le_n[j] - mx) : 0.f;
      float x;
      if (fresh) {
        x = e;
      } else if (fre) {
        x = (rn * expf(uj > 0.f ? log_w[ws + j] : 0.f)) * e;
      } else {
        float f = 0.f, all = 0.f;
        gather_list(lst + j, S, sh.goff, P, src, wb, inv, f, all);
        x = __fmul_rn(fmaf(t0, full[ws + j] != 0 ? all : rn, f), e);
      }
      dst[j] = x;
      tsum += x;
    }
    float tot, nmx;
    reduce_step(sh, cur, tsum, nm, lane, warp, nwarps, tot, nmx);
    mx = nmx;
    ahead = has_next;
    ok = tot > 0.f;
    inv = ok ? 1.f / tot : 1.f;
    for (int j = tid; j < S; j += nt) out_i[j] = ok ? dst[j] * inv : sh.uni[j];
    fresh = false;
    ++r;
  }
}

int device_shared_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

// fb_kernel's shared bytes before the lists
size_t base_bytes(long S) {
  return kCommonBytes + static_cast<size_t>(kRowBytes + kRingBytes) * (S + 1);
}

// fb_wide_kernel's
size_t wide_bytes(long S) {
  return kCommonBytes + static_cast<size_t>(kRowBytes) * S;
}

// the list words a thread of fb_kernel holds in registers (16 or 32), or 0
int register_words(long S, long pairs, int optin) {
  if (S > kRegThreads || pairs == 0) return 0;  // (no lists in fre mode)
  const int words = pairs <= 16 ? 16 : pairs <= kRegWords ? kRegWords : 0;
  return words > 0 && base_bytes(S) + tile_weight_bytes(words) <=
                          static_cast<size_t>(optin) ? words : 0;
}

}  // namespace

// The most states a launch takes on the current device: fb_wide_kernel's
// per-state arrays must fit in a block's shared memory (the lists move to
// device memory first), and a state index must fit in int16.  -1 when the
// device cannot be queried.
extern "C" long vg_fb_max_states() {
  const int optin = device_shared_limit();
  if (optin < 0) return -1;
  const long s = (optin - kCommonBytes) / kRowBytes;
  return s < kMaxStates ? s : kMaxStates;
}

// logE f32 [W, N, S]; kind int32 [W, N]; lrf, lnrf, lrb, lnrb f32 [W, N];
// lists uint32 [W, pairs, S] (two uint16 state indices a word, pad index S),
// goff int32 [W, P + 2] (each class's first slot; even), full uint8 [W, S]
// (1: the column lists class 0 and leaves out classes above P), all three
// unread when fre != 0; log_w f32 [W, S]; smask bool (one byte) [W, S];
// alpha, beta f32 [W, N, S], every element written; 0 <= P <= 255;
// fre != 0 for the 'fre' transition.  Launches on ``stream``; returns the
// CUDA error of the launch (0 on success).
extern "C" int vg_forward_backward(const float* logE, const int32_t* kind,
                                   const float* lrf, const float* lnrf,
                                   const float* lrb, const float* lnrb,
                                   const uint32_t* lists, const int32_t* goff,
                                   const uint8_t* full, const float* log_w,
                                   const uint8_t* smask, float* alpha,
                                   float* beta, long W, long N, long S, int P,
                                   long pairs, int fre, void* stream) {
  if (W <= 0 || N <= 0 || S <= 0) return 0;
  const int optin = device_shared_limit();
  if (optin < 0) return static_cast<int>(cudaGetLastError());
  if (fre) pairs = 0;
  const size_t limit = static_cast<size_t>(optin);
  // one state a thread while S fits a block and its ring fits beside it
  const bool one = S <= kMaxThreads && base_bytes(S) <= limit;
  const int words = one ? register_words(S, pairs, optin) : 0;
  const size_t base = one ? base_bytes(S) : wide_bytes(S);
  const size_t with_lists = base + static_cast<size_t>(pairs) * S * 4;
  const bool shared = words == 0 && with_lists <= limit;
  const size_t bytes = words > 0 ? base + tile_weight_bytes(words) : shared ? with_lists : base;
  if (bytes > limit || W > 0x7fffffffL || N > 0x7fffffffL || S > kMaxStates ||
      pairs > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  decltype(&fb_wide_kernel) kern = !one ? fb_wide_kernel
                                   : words == 16 ? fb_kernel<16>
                                   : words == kRegWords ? fb_kernel<kRegWords>
                                                        : fb_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = static_cast<int>(
      S >= kMaxThreads ? kMaxThreads : ((S + 31) / 32) * 32);
  kern<<<dim3(static_cast<unsigned>(W), 2), threads, bytes,
         static_cast<cudaStream_t>(stream)>>>(
      logE, kind, lrf, lnrf, lrb, lnrb, lists, goff, full, log_w, smask, alpha,
      beta, static_cast<int>(N), static_cast<int>(S), P,
      static_cast<int>(pairs), shared ? 1 : 0, fre);
  return static_cast<int>(cudaGetLastError());
}
