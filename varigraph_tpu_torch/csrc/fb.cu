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
// Layout.  Grid (W, 2): one CTA for each window and direction, so the
// forward and the backward chains of a window run side by side.  The node
// loop runs inside the CTA; thread tid owns the states j = tid (mod
// blockDim), blockDim = S rounded up to a warp, at most 1024, so any S up to
// the shared-memory limit works.  The row, the step's raw values, the
// uniform row and the fre weights sit in shared memory, as does the uint8
// overlap matrix [S, S] while it fits beside them (S <= ~469 on an H100);
// above that the matrix is read from device memory (L1/L2).  kind, lr and lnr
// are staged kTile steps at a time; each thread prefetches its first
// state's logE one step ahead.  Pad and reset steps take no barrier.
//
// Determinism.  The max and the sums are block reductions in a fixed order
// (a warp butterfly, then the warps' partials in warp order), with no
// atomics, and flow[j] is summed by one thread in a fixed order.  A window's
// rows depend only on its own inputs and S, bit for bit, whatever W is and
// wherever the window sits in the batch.  They agree with the plain version
// (which sums per overlap class through a matrix product) to float32
// rounding, not bit for bit.  expf, IEEE division, no fast math.
//
// What bounds it on an H100.  Each direction reads logE once and writes one
// [N, S] row block: 4 * W*N*S*4 bytes in all; the rec flow is S^2 FMAs a
// step, 2 * W*N*2S^2 float32 operations in all, which bound it at S = 120
// (chip_smoke.py computes both).  In practice the chain is serial: a step
// costs two barriers, two block reductions and S FMAs a thread (four
// accumulators), and every CTA of a 256-window group is resident at once.
// The flow's inner loop makes three shared-memory loads for each FMA (the
// row, the overlap byte, the class weight), and an SM issues one such
// warp-wide load a cycle: at S = 120 that, not the FMAs, sets the pace.  On
// an H100 80GB HBM3 (700 W) the group W = 256, N = 8,192 takes ~30 ms in
// rec mode and ~8.3 ms in fre mode (no S^2 flow) against a 1.8 ms bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;       // steps of kind/lr/lnr staged at once
constexpr int kClasses = 256;    // t[] covers every uint8 overlap value
constexpr int kMaxThreads = 1024;

// shared bytes before the per-state arrays: t, three reduction buffers of
// 32 floats, the staged kind/lr/lnr
constexpr int kFixedBytes = 4 * kClasses + 3 * 32 * 4 + 3 * kTile * 4;
// per-state shared floats: the row, raw/logE, uniform, fre weight
constexpr int kPerState = 4 * 4;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <bool kOvShared>
__global__ void __launch_bounds__(kMaxThreads)
fb_kernel(const float* __restrict__ logE, const int32_t* __restrict__ kind,
          const float* __restrict__ lrf, const float* __restrict__ lnrf,
          const float* __restrict__ lrb, const float* __restrict__ lnrb,
          const uint8_t* __restrict__ ov, const float* __restrict__ log_w,
          const uint8_t* __restrict__ smask, float* __restrict__ alpha_out,
          float* __restrict__ beta_out, int N, int S, int P, int fre) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* t_s = reinterpret_cast<float*>(smem);
  float* red_max = t_s + kClasses;
  float* red_a = red_max + 32;
  float* red_tot = red_a + 32;
  int* kind_s = reinterpret_cast<int*>(red_tot + 32);
  float* lr_s = reinterpret_cast<float*>(kind_s + kTile);
  float* lnr_s = lr_s + kTile;
  float* row_s = lnr_s + kTile;
  float* work_s = row_s + S;
  float* uni_s = work_s + S;
  float* ew_s = uni_s + S;
  uint8_t* ov_s = reinterpret_cast<uint8_t*>(ew_s + S);

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
  const uint8_t* ov_w = ov + ws * S;
  const uint8_t* ovp = kOvShared ? ov_s : ov_w;

  for (int c = tid; c < kClasses; c += nt) t_s[c] = 0.f;
  float cnt = 0.f;
  for (int j = tid; j < S; j += nt) {
    const bool v = smask[ws + j] != 0;
    cnt += v ? 1.f : 0.f;
    row_s[j] = 0.f;
    ew_s[j] = expf(v ? log_w[ws + j] : 0.f);
  }
  if (kOvShared) {
    for (int q = tid; q < S * S; q += nt) ov_s[q] = ov_w[q];
  }
  cnt = warp_sum(cnt);
  if (lane == 0) red_tot[warp] = cnt;
  __syncthreads();
  float nvalid = 0.f;
  for (int q = 0; q < nwarps; ++q) nvalid += red_tot[q];
  for (int j = tid; j < S; j += nt)
    uni_s[j] = smask[ws + j] != 0 ? 1.f / nvalid : 0.f;

  bool fresh = true;  // the same in every thread of the block
  const int dir = back ? -1 : 1;
  float pf = tid < S ? le_w[static_cast<size_t>(back ? N - 1 : 0) * S + tid] : 0.f;
  for (int n = 0; n < N; ++n) {
    const int i = back ? N - 1 - n : n;
    const int q = n % kTile;
    if (q == 0) {
      __syncthreads();  // every thread is done with the previous tile
      for (int r = tid; r < kTile && n + r < N; r += nt) {
        const int ii = back ? N - 1 - (n + r) : n + r;
        kind_s[r] = kind_w[ii];
        lr_s[r] = lr_w[ii];
        lnr_s[r] = lnr_w[ii];
      }
      __syncthreads();
    }
    const int knd = kind_s[q];
    const float le0 = pf;
    if (n + 1 < N && tid < S) pf = le_w[static_cast<size_t>(i + dir) * S + tid];
    float* out_i = out + static_cast<size_t>(i) * S;
    if (knd != 1) {
      for (int j = tid; j < S; j += nt) out_i[j] = 0.f;
      if (knd == 2) fresh = true;
      continue;
    }

    if (!fre && !fresh) {
      const float lr = lr_s[q], lnr = lnr_s[q];
      for (int c = tid; c <= P; c += nt) {
        const float a = c == 0 ? 0.f : static_cast<float>(c) * lnr;
        const float b = P - c == 0 ? 0.f : static_cast<float>(P - c) * lr;
        t_s[c] = expf(a + b);
      }
    }
    // the max of logE over the valid states; the row's sum (fre)
    float mx = -INFINITY, asum = 0.f;
    for (int j = tid; j < S; j += nt) {
      const float le = j == tid ? le0 : le_w[static_cast<size_t>(i) * S + j];
      work_s[j] = le;
      if (uni_s[j] > 0.f) mx = fmaxf(mx, le);
      asum += row_s[j];
    }
    mx = warp_max(mx);
    asum = warp_sum(asum);
    if (lane == 0) {
      red_max[warp] = mx;
      red_a[warp] = asum;
    }
    __syncthreads();
    mx = red_max[0];
    asum = red_a[0];
    for (int r = 1; r < nwarps; ++r) {
      mx = fmaxf(mx, red_max[r]);
      asum += red_a[r];
    }

    float tot = 0.f;
    for (int j = tid; j < S; j += nt) {
      const float e = uni_s[j] > 0.f ? expf(work_s[j] - mx) : 0.f;
      float raw;
      if (fresh) {
        raw = e;
      } else if (fre) {
        raw = (asum * ew_s[j]) * e;
      } else {
        const uint8_t* col = ovp + j;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int s = 0;
        for (; s + 4 <= S; s += 4) {
          a0 = fmaf(row_s[s], t_s[col[static_cast<size_t>(s) * S]], a0);
          a1 = fmaf(row_s[s + 1], t_s[col[static_cast<size_t>(s + 1) * S]], a1);
          a2 = fmaf(row_s[s + 2], t_s[col[static_cast<size_t>(s + 2) * S]], a2);
          a3 = fmaf(row_s[s + 3], t_s[col[static_cast<size_t>(s + 3) * S]], a3);
        }
        for (; s < S; ++s)
          a0 = fmaf(row_s[s], t_s[col[static_cast<size_t>(s) * S]], a0);
        raw = ((a0 + a1) + (a2 + a3)) * e;
      }
      work_s[j] = raw;
      tot += raw;
    }
    tot = warp_sum(tot);
    if (lane == 0) red_tot[warp] = tot;
    __syncthreads();
    tot = red_tot[0];
    for (int r = 1; r < nwarps; ++r) tot += red_tot[r];

    for (int j = tid; j < S; j += nt) {
      const float v = tot > 0.f ? work_s[j] / tot : uni_s[j];
      row_s[j] = v;
      out_i[j] = v;
    }
    fresh = false;
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

}  // namespace

// The most states a launch takes on the current device: the per-state
// arrays must fit in a block's shared memory (the overlap matrix moves to
// device memory first).  -1 when the device cannot be queried.
extern "C" long vg_fb_max_states() {
  const int optin = device_shared_limit();
  return optin < 0 ? -1 : (optin - kFixedBytes) / kPerState;
}

// logE f32 [W, N, S]; kind int32 [W, N]; lrf, lnrf, lrb, lnrb f32 [W, N];
// ov uint8 [W, S, S]; log_w f32 [W, S]; smask bool (one byte) [W, S];
// alpha, beta f32 [W, N, S], every element written; 0 <= P <= 255;
// fre != 0 for the 'fre' transition.  Launches on ``stream``; returns the
// CUDA error of the launch (0 on success).
extern "C" int vg_forward_backward(const float* logE, const int32_t* kind,
                                   const float* lrf, const float* lnrf,
                                   const float* lrb, const float* lnrb,
                                   const uint8_t* ov, const float* log_w,
                                   const uint8_t* smask, float* alpha,
                                   float* beta, long W, long N, long S, int P,
                                   int fre, void* stream) {
  if (W <= 0 || N <= 0 || S <= 0) return 0;
  const int optin = device_shared_limit();
  if (optin < 0) return static_cast<int>(cudaGetLastError());
  const size_t base = kFixedBytes + static_cast<size_t>(kPerState) * S;
  const size_t with_ov = base + static_cast<size_t>(S) * S;
  const bool ov_shared = with_ov <= static_cast<size_t>(optin);
  const size_t bytes = ov_shared ? with_ov : base;
  if (bytes > static_cast<size_t>(optin) || W > 0x7fffffffL || N > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ov_shared ? fb_kernel<true> : fb_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = static_cast<int>(
      S >= kMaxThreads ? kMaxThreads : ((S + 31) / 32) * 32);
  kern<<<dim3(static_cast<unsigned>(W), 2), threads, bytes,
         static_cast<cudaStream_t>(stream)>>>(
      logE, kind, lrf, lnrf, lrb, lnrb, ov, log_w, smask, alpha, beta,
      static_cast<int>(N), static_cast<int>(S), P, fre);
  return static_cast<int>(cudaGetLastError());
}
