// The genotyping window prep's per-k-mer pass for Hopper (sm_90a).
//
//   vg_hap_mass     each haplotype's k-mer mass over a window's variant nodes
//   vg_gather_rows  each scored node's kept k-mer rows, in the emissions'
//                   and the posterior's input layout
//
// Replace no TPU or XLA kernel: the JAX engine's window prep is host numpy
// (varigraph_tpu/genotype/engine_jax.py:297, _WindowPrep, and its
// hapselect.window_hap_counts),
// and so was the port's until these kernels.  They were added because that
// host pass was the largest block of a sample's time: each window's ~330,000
// k-mer rows were unpacked to one byte a haplotype twice (once for the
// selection's mass, as [rows, nhap] uint64 products, once for the gather),
// scattered into [nodes, 128, U] byte matrices and packed back into the words
// the emissions read, all while the card idled.  Here the rows are read from
// device copies of the k-mer table (cov, freq, hap words, ref flag) and of
// the graph's CSR (off, idx, lp: every chromosome's in one), and only the
// mass's nhap sums and, after the posterior, each node's kind come back.
// The plain versions are ops/prep.hap_mass_plain and gather_rows_plain.
//
// What they compute.  A row r of node v (off[v] <= r < off[v + 1]) is the
// table entry t = idx[r] with c = min(cov[t], 255), f = freq[t], the hap
// words hapbits[t, 0..Wt-1] and the node-local bits lp[r, 0..nb-1] (hap h at
// bit h % 8 of byte h / 8).
//   hap_mass:    out[g, h] = sum of c over the rows of window g's nodes with
//                c > 1 and f == 1 whose word bit h is set (genotype.cpp:
//                536-572).  Exact integer sums, in any order.
//   gather_rows: a row of node (g, n) is kept when its hap words meet the
//                window's top-haplotype mask; the kept rows, in CSR order,
//                fill slots 0.. of the node's K slots (c, f, flag =
//                refflag[t], kmask = 1, and bit j of word j / 32 of bits and
//                local = hap used[g, j]'s bit, used[g, j] < 0 none), the
//                rest read 0; kind = 1, or 2 where nothing is kept, 0 for a
//                pad row (node < 0).  The order is the host's, so the
//                emissions' float32 sums over k-mers see the same order.
//
// Bound: bytes.  The gather writes K (4 + 8 Ww) bytes a node row, ~36 MB for
// the benchmark cells' group (4 windows of 5,854 nodes, K = 128), and reads
// each row's index, local bytes and table entry: ~11 us at 3.35 TB/s for
// the writes alone.  The mass reads the same rows and writes nhap sums.
//
// Layout.  A warp takes a node: its lanes take 32 rows at a time.
//   hap_mass: a lane holds its row's c (0 where the row does not count);
//   for each hap word, a loop over the counting rows (a ballot) shuffles
//   each row's word and c to every lane, and lane l adds c where bit l is
//   set: the 32 x 32 bit transpose without a byte matrix.  A lane's sum for
//   a chunk goes to the CTA's per-hap sums in shared memory (32 Wt u64),
//   added to out by one atomic a hap a CTA at the end.  grid (x, G).
//   gather_rows: a lane tests its row against the top mask (Wt words); a
//   ballot and a prefix count give each kept row its slot, in order.  Each
//   used-hap word is then a ballot a kept row: lane l tests hap used[32 jw +
//   l] in the row's words and local bytes (a few sectors that the L1
//   holds), and the row's own lane keeps the ballots and writes them.  The
//   slots past the kept rows are zeroed in the same pass, so the outputs
//   need no memset.  Any Wt, Ww and K <= 128; nothing is templated.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps (nodes) a CTA
constexpr int kNodesPerWarp = 4;          // hap_mass: nodes a warp, on average
constexpr unsigned kFull = 0xffffffffu;

struct MassArgs {
  const int64_t* nodes;       // [G, Nn], -1 after a window's nodes
  const int64_t* off;         // [nodes + 1]
  const int32_t* idx;         // [R]
  const int32_t* cov;         // [M]
  const uint8_t* freq;        // [M]
  const uint32_t* hapbits;    // [M, Wt]
  unsigned long long* out;    // [G, nhap]
  long Nn;
  int Wt, nhap;
};

__global__ void __launch_bounds__(32 * kWarps) hap_mass_kernel(MassArgs a) {
  extern __shared__ unsigned long long mass[];   // [32 Wt]
  const int g = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int H = 32 * a.Wt;
  for (int h = threadIdx.x; h < H; h += blockDim.x) mass[h] = 0;
  __syncthreads();
  const int64_t* nodes = a.nodes + g * a.Nn;
  const long step = static_cast<long>(gridDim.x) * kWarps;
  for (long i = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5); i < a.Nn;
       i += step) {
    const int64_t node = nodes[i];
    if (node < 0) break;                  // the window's pad: no node after it
    const int64_t lo = a.off[node], hi = a.off[node + 1];
    for (int64_t base = lo; base < hi; base += 32) {
      const int64_t r = base + lane;
      int64_t t = 0;
      uint32_t c = 0;
      if (r < hi) {
        t = a.idx[r];
        const int cv = min(a.cov[t], 255);
        if (cv > 1 && a.freq[t] == 1) c = static_cast<uint32_t>(cv);
      }
      const unsigned counting = __ballot_sync(kFull, c != 0);
      if (!counting) continue;
      for (int w = 0; w < a.Wt; ++w) {
        const uint32_t word = c ? a.hapbits[t * a.Wt + w] : 0u;
        uint32_t sum = 0;                 // at most 32 x 255
        for (unsigned m = counting; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          const uint32_t ws = __shfl_sync(kFull, word, src);
          const uint32_t cs = __shfl_sync(kFull, c, src);
          sum += ((ws >> lane) & 1u) * cs;
        }
        if (sum) atomicAdd(&mass[w * 32 + lane], static_cast<unsigned long long>(sum));
      }
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < a.nhap; h += blockDim.x)
    if (mass[h]) atomicAdd(a.out + static_cast<long>(g) * a.nhap + h, mass[h]);
}

struct GatherArgs {
  const int64_t* nodes;       // [G, N], -1 for a pad row
  const uint32_t* top;        // [G, Wt]
  const int32_t* used;        // [G, 32 Ww]
  const int64_t* off;         // [nodes + 1]
  const int32_t* idx;         // [R]
  const uint8_t* lp;          // [R, nb]
  const int32_t* cov;         // [M]
  const uint8_t* freq;        // [M]
  const uint32_t* hapbits;    // [M, Wt]
  const uint8_t* refflag;     // [M]
  uint8_t* c;                 // [G, N, K]
  uint8_t* f;
  uint8_t* flag;
  uint8_t* kmask;
  uint32_t* bits;             // [G, N, K, Ww]
  uint32_t* local;
  int32_t* kind;              // [G, N]
  long rows_total;            // G * N
  long N;
  int K, Wt, Ww, nb;
};

__global__ void __launch_bounds__(32 * kWarps) gather_rows_kernel(GatherArgs a) {
  const int lane = threadIdx.x & 31;
  const long step = static_cast<long>(gridDim.x) * kWarps;
  for (long row = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < a.rows_total; row += step) {
    const long g = row / a.N;
    const int64_t node = a.nodes[row];
    const uint32_t* top = a.top + g * a.Wt;
    const int32_t* used = a.used + g * 32 * a.Ww;
    uint8_t* c = a.c + row * a.K;
    uint8_t* f = a.f + row * a.K;
    uint8_t* flag = a.flag + row * a.K;
    uint8_t* kmask = a.kmask + row * a.K;
    uint32_t* bits = a.bits + row * a.K * a.Ww;
    uint32_t* local = a.local + row * a.K * a.Ww;
    int kept = 0;                         // the same in every lane
    if (node >= 0) {
      const int64_t lo = a.off[node], hi = a.off[node + 1];
      for (int64_t base = lo; base < hi && kept < a.K; base += 32) {
        const int64_t r = base + lane;
        int64_t t = 0;
        bool keep = false;
        if (r < hi) {
          t = a.idx[r];
          const uint32_t* hw = a.hapbits + t * a.Wt;
          for (int w = 0; w < a.Wt && !keep; ++w) keep = (hw[w] & top[w]) != 0;
        }
        const unsigned m = __ballot_sync(kFull, keep);
        const int pos = kept + __popc(m & ((1u << lane) - 1u));
        const bool write = keep && pos < a.K;
        if (write) {
          c[pos] = static_cast<uint8_t>(min(a.cov[t], 255));
          f[pos] = a.freq[t];
          flag[pos] = a.refflag[t] != 0;
          kmask[pos] = 1;
        }
        for (int jw = 0; jw < a.Ww; ++jw) {
          const int u = used[jw * 32 + lane];
          uint32_t mine_b = 0, mine_l = 0;
          for (unsigned rest = m; rest; rest &= rest - 1) {
            const int src = __ffs(rest) - 1;
            const int64_t ts = __shfl_sync(kFull, t, src);
            const int64_t rs = __shfl_sync(kFull, r, src);
            bool b = false, l = false;
            if (u >= 0) {
              b = (a.hapbits[ts * a.Wt + (u >> 5)] >> (u & 31)) & 1u;
              l = (a.lp[rs * a.nb + (u >> 3)] >> (u & 7)) & 1u;
            }
            const uint32_t wb = __ballot_sync(kFull, b);
            const uint32_t wl = __ballot_sync(kFull, l);
            if (lane == src) {
              mine_b = wb;
              mine_l = wl;
            }
          }
          if (write) {
            bits[static_cast<long>(pos) * a.Ww + jw] = mine_b;
            local[static_cast<long>(pos) * a.Ww + jw] = mine_l;
          }
        }
        kept += __popc(m);
      }
      kept = min(kept, a.K);
    }
    for (int s = kept + lane; s < a.K; s += 32) {
      c[s] = 0;
      f[s] = 0;
      flag[s] = 0;
      kmask[s] = 0;
    }
    const long words = static_cast<long>(a.K) * a.Ww;
    for (long s = static_cast<long>(kept) * a.Ww + lane; s < words; s += 32) {
      bits[s] = 0;
      local[s] = 0;
    }
    if (lane == 0) a.kind[row] = node < 0 ? 0 : (kept ? 1 : 2);
  }
}

}  // namespace

// nodes int64 [G, Nn] (a window's node ids into off, then -1); off int64
// [nodes + 1]; idx int32 [R]; cov int32 [M]; freq uint8 [M]; hapbits uint32
// [M, Wt]; out int64 [G, nhap], zeroed by the caller (nhap <= 32 Wt, and
// 32 Wt * 8 bytes of shared memory <= 48 KB).  Returns the launch's CUDA
// error, 0 on success.
extern "C" int vg_hap_mass(const void* nodes, const void* off, const void* idx,
                           const void* cov, const void* freq, const void* hapbits,
                           void* out, long G, long Nn, int Wt, int nhap, void* stream) {
  if (G == 0 || Nn == 0) return 0;
  if (Wt < 1 || nhap < 0 || nhap > 32 * Wt || 32L * Wt * 8 > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  MassArgs a{static_cast<const int64_t*>(nodes), static_cast<const int64_t*>(off),
             static_cast<const int32_t*>(idx),   static_cast<const int32_t*>(cov),
             static_cast<const uint8_t*>(freq),  static_cast<const uint32_t*>(hapbits),
             static_cast<unsigned long long*>(out), Nn, Wt, nhap};
  const long per_cta = static_cast<long>(kWarps) * kNodesPerWarp;
  const dim3 grid(static_cast<unsigned>((Nn + per_cta - 1) / per_cta),
                  static_cast<unsigned>(G));
  hap_mass_kernel<<<grid, 32 * kWarps, 32 * Wt * sizeof(unsigned long long),
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// nodes int64 [G, N] (a window's node ids into off, then -1); top uint32
// [G, Wt]; used int32 [G, 32 Ww]; off, idx, cov, freq, hapbits as above; lp
// uint8 [R, nb]; refflag bool [M]; c, f, flag, kmask uint8 [G, N, K]
// (K <= 128); bits, local uint32 [G, N, K, Ww]; kind int32 [G, N].  Returns
// the launch's CUDA error, 0 on success.
extern "C" int vg_gather_rows(const void* nodes, const void* top, const void* used,
                              const void* off, const void* idx, const void* lp,
                              const void* cov, const void* freq, const void* hapbits,
                              const void* refflag, void* c, void* f, void* flag,
                              void* kmask, void* bits, void* local, void* kind, long G,
                              long N, int K, int Wt, int Ww, int nb, void* stream) {
  if (G == 0 || N == 0) return 0;
  if (K < 1 || K > 128 || Wt < 1 || Ww < 1 || nb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GatherArgs a{static_cast<const int64_t*>(nodes), static_cast<const uint32_t*>(top),
               static_cast<const int32_t*>(used),  static_cast<const int64_t*>(off),
               static_cast<const int32_t*>(idx),   static_cast<const uint8_t*>(lp),
               static_cast<const int32_t*>(cov),   static_cast<const uint8_t*>(freq),
               static_cast<const uint32_t*>(hapbits), static_cast<const uint8_t*>(refflag),
               static_cast<uint8_t*>(c),           static_cast<uint8_t*>(f),
               static_cast<uint8_t*>(flag),        static_cast<uint8_t*>(kmask),
               static_cast<uint32_t*>(bits),       static_cast<uint32_t*>(local),
               static_cast<int32_t*>(kind),        G * N,
               N, K, Wt, Ww, nb};
  const long blocks = (G * N + kWarps - 1) / kWarps;
  gather_rows_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
