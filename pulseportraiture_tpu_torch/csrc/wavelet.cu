// K8: the wavelet smoothing search of smart_smooth, in three tiers.
//
// Replaces the fused device function of the JAX reference
// pulseportraiture_tpu/ops/wavelet.py:177 _smart_smooth_grid: for each
// profile (row) x of nbin bins (nbin even, nh = nbin/2 + 1 harmonics), L
// levels and nfact threshold factors, the candidate of level l and factor
// f is iswt(cA_l, threshold(cD_j, lambda_f) for j < l) of the profile's
// undecimated Daubechies transform; its pseudo-S/N counts when its reduced
// chi2 against x passes chi2 - 1 <= tol; each level keeps its first best
// factor, a later level replaces the best only when strictly better, and
// the row is zeroed unless the best S/N is > 0 and its chi2 passes.  With
// H_i = H(2^i w), G_i = G(2^i w) the level-i responses and the host's
// float64 tables (ops/wavelet.py search_tables):
//
//   X        = rFFT(x)                                   cuFFT
//   C_j      = A_j X, A_j = conj(G_j) prod_{i<j} conj(H_i)   pp_wavelet_analysis
//   cD_j     = irFFT(C_j)                                 cuFFT
//   sigma    = median |cD_0| / 0.6745, lambda_f = f_f sigma sqrt(2 ln nbin),
//   errs     = get_noise_PS(x) from X                     pp_wavelet_sigma
//   T_{j,f}  = threshold(cD_j, lambda_f), same_{j,f} = (T_{j,f} == T_{j,f-1})
//   S_{l,f}  = P_l X + sum_{j<l} Q_j rFFT(T_{j,f})
//              (P_l = prod_{i<l} |H_i|^2 / 2^l, Q_j = G_j prod_{i<j} H_i /
//              2^(j+1): iswt's recursion unrolled)
//
// Tier 1, the set-up: the first four lines, per chunk of rows.
//
// Tier 2, the scan (pp_wavelet_scan): one block a (row, factor), its
// candidates of every level kept in shared memory: per level the
// thresholded details, their real FFT by the scan's own transforms
// (below), the running sum of Q_j D_j, and the candidate's S
// read into its pseudo-S/N (power above harmonic 0 over the top quarter's
// noise), its chi2 (Parseval on X - S: no inverse transform), its noise and
// signal power; the repeat flags same_{j,f}.  Then the certifying select
// (pp_wavelet_certify), one block a row: the route's S/N, chi2 and noise of
// a candidate lie within bounds of the scan's, drawn from a worst-case
// bound on floating-point FFT error (_kernels.CERT_MARGIN), and the block
// checks the FFT library's transforms of the row against its own; where
// the candidate of the greatest lower bound beats every other's upper
// bound, the row's choice stands and the block makes its smooth (irFFT(S)
// by the scan's transforms); else the row is uncertain.
//
// Tier 3, the route, as the reference reads the S/N: each candidate's
// smoothed profile sm = irFFT(S) and its rFFT S' through cuFFT
// (pp_wavelet_threshold, cuFFT, pp_wavelet_synthesis, cuFFT both ways),
// the S/N from S' and the chi2 from sm (pp_wavelet_search), the choice
// (pp_wavelet_select) — over the uncertain rows, gathered, and over every
// row of a width the scan does not take.  The
// winners of smooth rows are so smooth that their top-quarter power lies
// at the round trip's rounding floor: only the round trip's own bits decide
// between two such candidates, and the route hands cuFFT the bits of
// _kernels.smooth_search_plain (every element step rounded in its order,
// no fused multiply-add; cuFFT gives a row the same bits in any batch).
// Candidates whose thresholded coefficients equal
// the factor before's at every level (same) are the same candidate: the
// choice skips them, so an exact tie goes to the first factor.
//
// The scan's transforms: a real FFT of nbin points is the complex FFT of
// its nbin / 2 (even, odd) pairs by Stockham autosort passes (one radix-2
// pass first where log2(nbin / 2) is odd, then radix-4), each butterfly's
// inputs from shared memory times their twiddles (each pass's own table,
// ops/wavelet.py scan_twiddles, read coalesced), its DFT in registers and its outputs to the other of two
// shared buffers; then the split into nbin / 2 + 1 harmonics.  Every
// product and sum is rounded, no fused multiply-add, in the order of
// _kernels._fft_scan / _rfft_scan / _irfft_scan: the scan and its plain
// version differ only in the order of their sums.
//
// What bounds it on an H100: operations.  The function needs, per row, the
// L nfact real transforms of its thresholded arrays (2.5 nbin log2 nbin
// FP64 operations each) and ~24 operations per harmonic per candidate to
// form and read its spectrum: 0.40 ms at [512, 2048] (L 11, nfact 30)
// against 34 TFLOP/s, against 0.0025 ms to read the rows and write the
// result.  The scan does just that work, on chip: one transform per
// candidate, no candidate through device memory; the route's three
// transforms and five trips through device memory per candidate remain
// only for the uncertain rows.
//
// Other stages: elementwise ones one thread an element (coalesced along
// harmonics or bins); the median by a bitonic sort of |cD_0|'s bit patterns
// (non-negative doubles order as their bits; NaN last, as torch.sort) in
// shared memory, one block a row; the route's threshold one block a (row,
// level), factors in turn, flags of difference in shared memory; its
// per-candidate sums one warp a candidate, xor-shuffle trees; its choice
// one warp a row, a reduction over the grid.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fft_block.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
constexpr int kSortThreads = 512;
constexpr int kStats = 5;  // the scan's statistics of a candidate

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// hard: |c| < lam ? 0 : c;  soft: sign(c) max(|c| - lam, 0)
__device__ __forceinline__ double threshold(double c, double lam, int soft) {
  if (!soft) return fabs(c) < lam ? 0.0 : c;
  double m = __dsub_rn(fabs(c), lam);
  m = m > 0.0 ? m : (isnan(m) ? m : 0.0);
  const double s = c > 0.0 ? 1.0 : (c < 0.0 ? -1.0 : (isnan(c) ? c : 0.0));
  return __dmul_rn(s, m);
}

// C[r, j, k] = A[j, k] X[r, k]
__global__ void __launch_bounds__(kThreads)
wavelet_analysis_kernel(const double2* __restrict__ X, const double2* __restrict__ A,
                        int64_t rows, int L, int nh, double2* __restrict__ C) {
  const int64_t n = rows * L * (int64_t)nh;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const int k = (int)(i % nh);
    const int64_t rj = i / nh;
    const int j = (int)(rj % L);
    const int64_t r = rj / L;
    const double2 a = __ldg(A + (int64_t)j * nh + k);
    const double2 x = __ldg(X + r * nh + k);
    double2 c;
    c.x = __dsub_rn(__dmul_rn(a.x, x.x), __dmul_rn(a.y, x.y));
    c.y = __dadd_rn(__dmul_rn(a.x, x.y), __dmul_rn(a.y, x.x));
    C[i] = c;
  }
}

// One block a row: errs from X's top quarter, sigma from the median of
// |cD_0|, lam[r, f] = (facts[f] sigma) lam_scale.
__global__ void __launch_bounds__(kSortThreads)
wavelet_sigma_kernel(const double2* __restrict__ X, const double* __restrict__ cD,
                     const double* __restrict__ facts, int L, int nbin, int nh, int kc,
                     int npow2, int nfact, double lam_scale, double* __restrict__ lam,
                     double* __restrict__ errs) {
  extern __shared__ unsigned long long keys[];  // npow2 keys, then kWarps partials
  double* part = reinterpret_cast<double*>(keys + npow2);
  const int64_t r = blockIdx.x;
  const double* c0 = cD + r * (int64_t)L * nbin;  // level 0 of row r
  for (int i = threadIdx.x; i < npow2; i += kSortThreads)
    keys[i] = i < nbin ? (unsigned long long)__double_as_longlong(fabs(__ldg(c0 + i)))
                       : 0xffffffffffffffffull;
  // the top-quarter power of the row's spectrum (get_noise_PS)
  double p = 0.0;
  const double2* f = X + r * nh;
  for (int k = kc + threadIdx.x; k < nh; k += kSortThreads) {
    const double2 v = __ldg(f + k);
    p = __dadd_rn(p, __dadd_rn(__dmul_rn(v.x, v.x), __dmul_rn(v.y, v.y)));
  }
  p = warp_sum(p);
  if (threadIdx.x % kLanes == 0) part[threadIdx.x / kLanes] = p;
  __syncthreads();
  for (int k = 2; k <= npow2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < npow2; i += kSortThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const double med = __dmul_rn(__dadd_rn(__longlong_as_double((long long)keys[nbin / 2 - 1]),
                                         __longlong_as_double((long long)keys[nbin / 2])),
                               0.5);
  const double sigma = __ddiv_rn(med, 0.6745);
  for (int i = threadIdx.x; i < nfact; i += kSortThreads)
    lam[r * nfact + i] = __dmul_rn(__dmul_rn(__ldg(facts + i), sigma), lam_scale);
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kSortThreads / kLanes; ++w) s = __dadd_rn(s, part[w]);
    errs[r] = __dsqrt_rn(__ddiv_rn(__ddiv_rn(s, (double)nbin), (double)(nh - kc)));
  }
}

// One block a (row, level): T[r, j, f, :] = threshold(cD[r, j, :], lam[r, f])
// for every factor; same[r, j, f] = 1 where T[r, j, f] equals T[r, j, f-1]
// element for element (0 for f = 0).
__global__ void __launch_bounds__(kThreads)
wavelet_threshold_kernel(const double* __restrict__ cD, const double* __restrict__ lam,
                         int L, int nfact, int nbin, int soft, double* __restrict__ T,
                         int* __restrict__ same) {
  extern __shared__ int diff[];  // nfact flags
  const int64_t rj = blockIdx.x;
  const int64_t r = rj / L;
  for (int f = threadIdx.x; f < nfact; f += kThreads) diff[f] = 0;
  __syncthreads();
  const double* c = cD + rj * nbin;
  const double* lr = lam + r * nfact;
  double* t = T + rj * (int64_t)nfact * nbin;
  for (int f = 0; f < nfact; ++f) {
    const double lf = __ldg(lr + f);
    const double lp = f > 0 ? __ldg(lr + f - 1) : lf;
    bool differs = false;
    for (int b = threadIdx.x; b < nbin; b += kThreads) {
      const double v = __ldg(c + b);
      const double tf = threshold(v, lf, soft);
      t[(int64_t)f * nbin + b] = tf;
      if (f > 0 && !(tf == threshold(v, lp, soft))) differs = true;
    }
    if (differs) diff[f] = 1;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < nfact; f += kThreads)
    same[rj * nfact + f] = (f > 0 && diff[f] == 0) ? 1 : 0;
}

// In place: D[r, j, f, k] <- S_{j+1, f, k} = P[j, k] X[r, k] + sum_{i<=j} Q[i, k]
// D[r, i, f, k], one thread an (r, f, k), the levels in turn.
__global__ void __launch_bounds__(kThreads)
wavelet_synthesis_kernel(const double2* __restrict__ X, const double* __restrict__ P,
                         const double2* __restrict__ Q, int64_t rows, int L, int nfact,
                         int nh, double2* __restrict__ D) {
  const int64_t n = rows * nfact * (int64_t)nh;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const int k = (int)(i % nh);
    const int64_t rf = i / nh;
    const int f = (int)(rf % nfact);
    const int64_t r = rf / nfact;
    const double2 x = __ldg(X + r * nh + k);
    double2* d = D + ((r * L) * nfact + f) * (int64_t)nh + k;
    const int64_t stride = (int64_t)nfact * nh;  // one level
    double ar = 0.0, ai = 0.0;
    for (int j = 0; j < L; ++j) {
      const double2 v = d[j * stride];
      const double2 q = __ldg(Q + (int64_t)j * nh + k);
      const double p = __ldg(P + (int64_t)j * nh + k);
      ar = j == 0 ? __dsub_rn(__dmul_rn(q.x, v.x), __dmul_rn(q.y, v.y))
                  : __dadd_rn(ar, __dsub_rn(__dmul_rn(q.x, v.x), __dmul_rn(q.y, v.y)));
      ai = j == 0 ? __dadd_rn(__dmul_rn(q.x, v.y), __dmul_rn(q.y, v.x))
                  : __dadd_rn(ai, __dadd_rn(__dmul_rn(q.x, v.y), __dmul_rn(q.y, v.x)));
      double2 s;
      s.x = __dadd_rn(__dmul_rn(p, x.x), ar);
      s.y = __dadd_rn(__dmul_rn(p, x.y), ai);
      d[j * stride] = s;
    }
  }
}

// One warp a candidate c = (r L + l) nfact + f: from its smoothed profile
// sm [nbin] and that profile's rFFT S2 [nh], the pseudo-S/N (gated by chi2)
// and the chi2 against the row x.
__global__ void __launch_bounds__(kThreads)
wavelet_search_kernel(const double* __restrict__ x, const double* __restrict__ sm,
                      const double2* __restrict__ S2, const double* __restrict__ errs,
                      int64_t rows, int L, int nfact, int nbin, int nh, int kc, double tol,
                      double* __restrict__ snr, double* __restrict__ chi2) {
  const int64_t c = (int64_t)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (c >= rows * L * nfact) return;  // a whole warp
  const int q = threadIdx.x % kLanes;
  const int64_t r = c / ((int64_t)L * nfact);
  const double2* s = S2 + c * nh;
  double sig = 0.0, top = 0.0;
  for (int k = q; k < nh; k += kLanes) {
    const double2 v = __ldg(s + k);
    const double pk = __dadd_rn(__dmul_rn(v.x, v.x), __dmul_rn(v.y, v.y));
    if (k >= 1) sig = __dadd_rn(sig, pk);
    if (k >= kc) top = __dadd_rn(top, pk);
  }
  const double e = __ldg(errs + r);
  const double se = e > 0.0 ? e : 1.0;
  const double* xr = x + r * nbin;
  const double* m = sm + c * nbin;
  double r2 = 0.0;
  for (int b = q; b < nbin; b += kLanes) {
    const double d = __ddiv_rn(__dsub_rn(__ldg(xr + b), __ldg(m + b)), se);
    r2 = __dadd_rn(r2, __dmul_rn(d, d));
  }
  sig = warp_sum(sig);
  top = warp_sum(top);
  r2 = warp_sum(r2);
  if (q != 0) return;
  const double noise = __dmul_rn(
      __dsqrt_rn(__ddiv_rn(__ddiv_rn(top, (double)nbin), (double)(nh - kc))),
      __dsqrt_rn(0.5 * nbin));
  double v = noise > 0.0 ? __ddiv_rn(sig, noise) : (sig > 0.0 ? INFINITY : 0.0);
  const double x2 = __ddiv_rn(r2, (double)nbin);
  if (!(__dsub_rn(x2, 1.0) <= tol)) v = 0.0;
  snr[c] = v;
  chi2[c] = x2;
}

// The choice over a row's [L, nfact] grid: the first maximum, in (level,
// factor) order, of the S/N v of the candidates that are not a repeat of
// the factor before at every level up to theirs (same), NaN anywhere among
// them zeroing the row.  That is the route's walk (per level the first best
// factor, NaN the greatest as torch.argmax; a level replaces the best only
// when strictly greater; the best NaN-propagating as torch.maximum, so a
// NaN ends in no choice) as one reduction: each lane takes candidates q,
// q + 32, ..., then the warp keeps the greater, the lower index on a tie.
__device__ __forceinline__ bool repeats(const int* __restrict__ same, int64_t r, int L,
                                        int nfact, int l, int f) {
  bool dup = f > 0;
  for (int j = 0; dup && j <= l; ++j) dup = __ldg(same + (r * L + j) * nfact + f) != 0;
  return dup;
}

__device__ __forceinline__ void keep_first_max(double& v, int& i, double vo, int io) {
  if (io >= 0 && (i < 0 || vo > v || (vo == v && io < i))) {
    v = vo;
    i = io;
  }
}

// One warp a row: the choice (the grid's first maximum of snr, see above),
// its lanes over the candidates in turn and a shuffle tree, then the warp
// writes the winner's smoothed profile, or zeros, and the choice (level,
// factor), or (0, -1), the winner kept when its S/N is > 0 and its chi2
// passes.
__global__ void __launch_bounds__(kThreads)
wavelet_select_kernel(const double* __restrict__ sm, const double* __restrict__ snr,
                      const double* __restrict__ chi2, const int* __restrict__ same,
                      int64_t rows, int L, int nfact, int nbin, double tol,
                      double* __restrict__ out, int64_t* __restrict__ choice) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (r >= rows) return;  // a whole warp
  const int q = threadIdx.x % kLanes;
  const int nc = L * nfact;
  double best = 0.0;
  int win = -1;
  bool has_nan = false;
  for (int c = q; c < nc; c += kLanes) {
    if (repeats(same, r, L, nfact, c / nfact, c % nfact)) continue;
    const double v = __ldg(snr + r * nc + c);
    if (isnan(v)) has_nan = true;
    else keep_first_max(best, win, v, c);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const double vo = __shfl_xor_sync(0xffffffffu, best, off);
    const int io = __shfl_xor_sync(0xffffffffu, win, off);
    keep_first_max(best, win, vo, io);
  }
  has_nan = __any_sync(0xffffffffu, has_nan);
  const int64_t wi = r * nc + (win < 0 ? 0 : win);
  if (has_nan || win < 0 || !(best > 0.0) || !(__dsub_rn(__ldg(chi2 + wi), 1.0) <= tol))
    win = -1;
  if (q == 0) {
    choice[2 * r] = win < 0 ? 0 : win / nfact + 1;
    choice[2 * r + 1] = win < 0 ? -1 : win % nfact;
  }
  double* o = out + r * nbin;
  const double* s = sm + wi * (int64_t)nbin;
  for (int b = q; b < nbin; b += kLanes) o[b] = win < 0 ? 0.0 : __ldg(s + b);
}

// ---------------------------------------------------------------------------
// The scan and the certifying select, their transforms (see the header).

// Level j of a candidate: T = threshold(cD_j, lf) into the time buffer a (as
// doubles; `differs` set where it is not threshold(cD_j, lp)), its real FFT,
// and acc[k] (+)= Q_j D_k for the harmonics k of this thread.  With kRead,
// the candidate of level j + 1, S = P_j X + acc, read into v += (its power
// above harmonic 0, its top quarter's power from harmonic kc, the
// residual |X - S|^2 weighted as Parseval's sum, |T|^2), harmonics 0 and n
// real; without, the block synchronised after.  The row's cD_j is read four
// loads a thread ahead.  Returns __syncthreads_or(differs).
template <bool kRead>
__device__ int level_step(const double* __restrict__ cj, double lf, double lp, int check,
                          int soft, int j, int n, int nbin, const double2* __restrict__ Qj,
                          const double* __restrict__ Pj, const double2* __restrict__ xr,
                          int kc, const double2* __restrict__ tw, double2* a, double2* b,
                          double2* acc, double (&v)[4]) {
  constexpr int kAhead = 4;
  double* t = reinterpret_cast<double*>(a);
  bool differs = false;
  for (int i0 = threadIdx.x; i0 < nbin; i0 += kAhead * kThreads) {
    double c[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = i0 + u * kThreads;
      c[u] = i < nbin ? __ldg(cj + i) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = i0 + u * kThreads;
      if (i < nbin) {
        const double tf = threshold(c[u], lf, soft);
        t[i] = tf;
        if constexpr (kRead) v[3] = __dadd_rn(v[3], __dmul_rn(tf, tf));
        if (check && !(tf == threshold(c[u], lp, soft))) differs = true;
      }
    }
  }
  const int any = __syncthreads_or(differs);
  const double2* z = fft_block<kThreads>(a, b, n, nbin, tw);
#pragma unroll 2
  for (int k = threadIdx.x; k <= n; k += kThreads) {
    const double2 q = __ldg(Qj + k);
    double2 xv = make_double2(0.0, 0.0);
    double p = 0.0;
    if constexpr (kRead) {
      xv = __ldg(xr + k);
      p = __ldg(Pj + k);
    }
    const double2 d = split(z, k, n, tw);
    const double tr = __dsub_rn(__dmul_rn(q.x, d.x), __dmul_rn(q.y, d.y));
    const double ti = __dadd_rn(__dmul_rn(q.x, d.y), __dmul_rn(q.y, d.x));
    const double2 s = j == 0 ? make_double2(tr, ti)
                             : make_double2(__dadd_rn(acc[k].x, tr), __dadd_rn(acc[k].y, ti));
    acc[k] = s;
    if constexpr (kRead) {
      const bool edge = k == 0 || k == n;
      const double sr = __dadd_rn(__dmul_rn(p, xv.x), s.x);
      const double si = edge ? 0.0 : __dadd_rn(__dmul_rn(p, xv.y), s.y);
      const double pw = __dadd_rn(__dmul_rn(sr, sr), __dmul_rn(si, si));
      if (k >= 1) v[0] = __dadd_rn(v[0], pw);
      if (k >= kc) v[1] = __dadd_rn(v[1], pw);
      const double rr = __dsub_rn(xv.x, sr), ri = __dsub_rn(edge ? 0.0 : xv.y, si);
      const double rp = __dadd_rn(__dmul_rn(rr, rr), __dmul_rn(ri, ri));
      v[2] = __dadd_rn(v[2], edge ? rp : __dmul_rn(rp, 2.0));
    }
  }
  if constexpr (!kRead) __syncthreads();  // z is the next level's time buffer
  return any;
}

// Sums of the block's threads, nv values each, in red [kWarps * nv]: thread 0
// gets the totals (the warps' partials added in warp order).
template <int NV>
__device__ __forceinline__ void block_sums(double (&v)[NV], double* red) {
#pragma unroll
  for (int i = 0; i < NV; ++i) v[i] = warp_sum(v[i]);
  if (threadIdx.x % kLanes == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) red[(threadIdx.x / kLanes) * NV + i] = v[i];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      double s = red[i];
      for (int w = 1; w < kWarps; ++w) s = __dadd_rn(s, red[w * NV + i]);
      v[i] = s;
    }
}

// The shared memory of a scan or certifying block: two transform buffers
// and the running sum, then the reductions' partials.
size_t scan_smem(int nbin) {
  return (size_t)(nbin + nbin / 2 + 1) * 16 + (size_t)kWarps * 4 * 8;
}

// One block a (row r, factor f): for each level l + 1 (l = 0..L-1) its
// candidate's spectrum S = P_l X + sum_{j<=l} Q_j rFFT(T_j) (the running sum
// in shared memory), read as the route reads the round trip's (harmonics 0
// and nbin / 2 real): the pseudo-S/N from its power above harmonic 0 and its
// top quarter's noise, the chi2 against x from |X - S|^2 (Parseval: no
// inverse transform), stats [r, l, f] = (snr, chi2, noise, sig, the norm
// sum_{j<=l} max|Q_j| |T_j| of its details, qmax [L] = max_k |Q_j[k]|);
// same [r, l, f] = T_l equal to the factor before's at every bin.
__global__ void __launch_bounds__(kThreads)
wavelet_scan_kernel(const double2* __restrict__ X, const double* __restrict__ cD,
                    const double* __restrict__ lam, const double* __restrict__ errs,
                    const double* __restrict__ P, const double2* __restrict__ Q,
                    const double2* __restrict__ tw, const double* __restrict__ qmax, int L,
                    int nfact, int nbin, int kc, int soft, double* __restrict__ stats,
                    int* __restrict__ same) {
  extern __shared__ double2 smem[];
  const int n = nbin >> 1, nh = n + 1;
  double2* a = smem;
  double2* b = smem + n;
  double2* acc = smem + 2 * n;
  double* red = reinterpret_cast<double*>(acc + nh);
  const int64_t r = blockIdx.x / nfact;
  const int f = blockIdx.x % nfact;
  const double lf = __ldg(lam + r * nfact + f);
  const double lp = f > 0 ? __ldg(lam + r * nfact + f - 1) : lf;
  const double e = __ldg(errs + r);
  const double se = e > 0.0 ? e : 1.0;
  const double2* xr = X + r * nh;
  double tnorm = 0.0;  // thread 0's sum_{j<=l} max|Q_j| |T_j|
  for (int j = 0; j < L; ++j) {
    double v[4] = {0.0, 0.0, 0.0, 0.0};  // sig, top, residual, |T|^2
    const int any = level_step<true>(cD + (r * L + j) * (int64_t)nbin, lf, lp, f > 0, soft, j,
                                     n, nbin, Q + (int64_t)j * nh, P + (int64_t)j * nh, xr, kc,
                                     tw, a, b, acc, v);
    // block_sums synchronises: z is read before the next level writes a
    block_sums<4>(v, red);
    if (threadIdx.x == 0) {
      const int64_t c = (r * L + j) * nfact + f;
      const double noise =
          __dsqrt_rn(__ddiv_rn(__ddiv_rn(v[1], (double)nbin), (double)(nh - kc)));
      const double nr = __dmul_rn(noise, __dsqrt_rn(0.5 * nbin));
      const double snr = nr > 0.0 ? __ddiv_rn(v[0], nr) : (v[0] > 0.0 ? INFINITY : 0.0);
      const double x2 = __ddiv_rn(
          __ddiv_rn(__ddiv_rn(v[2], (double)nbin), __dmul_rn(se, se)), (double)nbin);
      tnorm = __dadd_rn(tnorm, __dmul_rn(__ldg(qmax + j), __dsqrt_rn(v[3])));
      double* st = stats + c * kStats;
      st[0] = snr;
      st[1] = x2;
      st[2] = noise;
      st[3] = v[0];
      st[4] = tnorm;
      same[c] = (f > 0 && !any) ? 1 : 0;
    }
  }
}

// The route's chi2 of a candidate lies within this of the scan's x2:
// chi2_margin (the two sums' own rounding) plus 2 sqrt(x2) delta +
// delta^2, delta the bound on the gap of the square roots of the two.
__device__ __forceinline__ double chi2_bound(double x2, double delta, double chi2_margin) {
  return __dadd_rn(__dadd_rn(chi2_margin, __dmul_rn(__dmul_rn(2.0, __dsqrt_rn(x2)), delta)),
                   __dmul_rn(delta, delta));
}

// The inverse by the scan's transforms: the n + 1 harmonics S (harmonics 0
// and n taken real) merged into n points scaled by 1 / nbin in a, then the
// FFT of their conjugates (conjugated by the caller: bin 2k is z[k].x, bin
// 2k + 1 is -z[k].y).  Returns the buffer that holds z, synchronised.
__device__ double2* inverse_block(const double2* S, double2* a, double2* b, int n, int nbin,
                                  const double2* __restrict__ tw) {
  const double inv = 1.0 / nbin;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const double2 sa = S[k], sb = S[n - k];
    const double ai = k == 0 ? 0.0 : sa.y, bi = k == 0 ? 0.0 : sb.y;
    const double er = __dmul_rn(__dadd_rn(sa.x, sb.x), inv);
    const double ei = __dmul_rn(__dsub_rn(ai, bi), inv);
    const double o_r = __dmul_rn(__dsub_rn(sa.x, sb.x), inv);
    const double o_i = __dmul_rn(__dadd_rn(ai, bi), inv);
    const double2 w = __ldg(tw + k);
    const double wr = __dadd_rn(__dmul_rn(o_r, w.x), __dmul_rn(o_i, w.y));
    const double wi = __dsub_rn(__dmul_rn(o_i, w.x), __dmul_rn(o_r, w.y));
    a[k] = make_double2(__dsub_rn(er, wi), -__dadd_rn(ei, wr));
  }
  __syncthreads();
  return fft_block<kThreads>(a, b, n, nbin, tw);
}

// The bounds of a candidate of level l + 1 (_kernels._cert_bounds_plain):
// with eps the relative error of a transform (Higham's Theorem 24.2), gam
// that of the synthesis sums, tn = sum_{j<=l} max|Q_j| |T_j| (the scan's),
// An = sqrt(nbin) tn (its details' spectra), pl = max|P_l|, |S| <= Sn =
// sqrt(sig) + pl |X_0| + An, the route's spectrum of the candidate, after
// its round trip, lies within G = G0 + 3 eps (Sn + G0) of the scan's
// (2-norm over the harmonics), G0 = 2 eps An + 2 gam (pl sqrt(nbin) |x| +
// An) before it; so its noise within En = G / sqrt(nbin (nh - kc)) of the
// scan's, the square root of its signal power within G, the square root
// of its chi2 within delta = (sqrt(2) eps |x| + sqrt(2 / nbin) (eps (Sn +
// G0) + G0)) / (errs sqrt(nbin)).  Plain arithmetic: a bound need not
// round as its plain version does.
struct CandBounds {
  double G, En, delta;
};

__device__ __forceinline__ CandBounds cand_bounds(double tn, double sig, double pl,
                                                  double ax0, double nx, double e, int nbin,
                                                  int nh, int kc, double eps, double gam) {
  const double sn = sqrt((double)nbin);
  const double An = sn * tn;
  const double Sn = sqrt(sig) + pl * ax0 + An;
  const double G0 = 2.0 * eps * An + 2.0 * gam * (pl * sn * nx + An);
  CandBounds bd;
  bd.G = G0 + 3.0 * eps * (Sn + G0);
  bd.En = bd.G / sqrt((double)nbin * (double)(nh - kc));
  bd.delta = (sqrt(2.0) * eps * nx + sqrt(2.0 / nbin) * (eps * (Sn + G0) + G0)) /
             ((e > 0.0 ? e : 1.0) * sn);
  return bd;
}

// One block a row: the check of the FFT library on the row's own data
// (the set-up's X = rFFT(x) and cD_0 = irFFT(C_0) within 2 eps of the
// scan's transforms of x and C_0; else the row is uncertain), then the
// certification of the scan's choice and, for a certified row, the choice
// and the winner's smooth (irFFT(P_l X + sum_{j<l} Q_j rFFT(T_j)) by the
// scan's transforms) or zeros; uncertain[r] = 1 (out and choice
// untouched) otherwise.  The route's S/N of a candidate lies within [lo,
// hi] drawn from its bounds (cand_bounds; maxima [2 L]: max_k |Q_j[k]| per
// level, then max_k |P_l[k]| per level); the row stands when the candidate
// of the greatest lower bound of the gated S/N beats every other's upper
// bound by the relative margin, or, zeroed, when no candidate's upper
// bound is above 0; a NaN or infinite statistic or bound leaves it
// uncertain.
__global__ void __launch_bounds__(kThreads)
wavelet_select_certify_kernel(
    const double* __restrict__ x, const double2* __restrict__ X, const double2* __restrict__ C,
    const double* __restrict__ cD, const double* __restrict__ lam,
    const double* __restrict__ errs, const double* __restrict__ P,
    const double2* __restrict__ Q, const double2* __restrict__ tw,
    const double* __restrict__ maxima, const double* __restrict__ stats,
    const int* __restrict__ same, int L, int nfact, int nbin, int kc, int soft, double tol,
    double margin, double chi2_margin, double eps, double gam, double* __restrict__ out,
    int64_t* __restrict__ choice, int* __restrict__ uncertain) {
  extern __shared__ double2 smem[];
  const int n = nbin >> 1, nh = n + 1;
  double2* a = smem;
  double2* b = smem + n;
  double2* acc = smem + 2 * n;
  double* red = reinterpret_cast<double*>(acc + nh);  // kWarps * 4 doubles
  __shared__ double s_sum[4], s_best;
  __shared__ int s_win, s_state, s_bad;
  const int64_t r = blockIdx.x;
  const int nc = L * nfact;
  const double* xr = x + r * nbin;
  const double* cr = cD + r * (int64_t)L * nbin;
  const double2* Xr = X + r * nh;
  // |x|^2 and |X - rFFT(x)|^2 by the scan's transform
  {
    double* t = reinterpret_cast<double*>(a);
    double v[2] = {0.0, 0.0};
    for (int i = threadIdx.x; i < nbin; i += kThreads) {
      const double xv = __ldg(xr + i);
      t[i] = xv;
      v[0] = __dadd_rn(v[0], __dmul_rn(xv, xv));
    }
    __syncthreads();
    const double2* z = fft_block<kThreads>(a, b, n, nbin, tw);
    for (int k = threadIdx.x; k <= n; k += kThreads) {
      const double2 d = split(z, k, n, tw), y = __ldg(Xr + k);
      const double dr = __dsub_rn(d.x, y.x), di = __dsub_rn(d.y, y.y);
      v[1] = __dadd_rn(v[1], __dadd_rn(__dmul_rn(dr, dr), __dmul_rn(di, di)));
    }
    block_sums<2>(v, red);
    if (threadIdx.x == 0) {
      s_sum[0] = v[0];
      s_sum[1] = v[1];
    }
    __syncthreads();
  }
  // |C_0|^2 and |cD_0 - irFFT(C_0)|^2 by the scan's transform
  {
    const double2* c0 = C + r * (int64_t)L * nh;
    double v[2] = {0.0, 0.0};
    for (int k = threadIdx.x; k <= n; k += kThreads) {
      const double2 c = __ldg(c0 + k);
      acc[k] = c;
      v[0] = __dadd_rn(v[0], __dadd_rn(__dmul_rn(c.x, c.x), __dmul_rn(c.y, c.y)));
    }
    __syncthreads();
    const double2* z = inverse_block(acc, a, b, n, nbin, tw);
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const double d0 = __dsub_rn(__ldg(cr + 2 * k), z[k].x);
      const double d1 = __dadd_rn(__ldg(cr + 2 * k + 1), z[k].y);
      v[1] = __dadd_rn(v[1], __dadd_rn(__dmul_rn(d0, d0), __dmul_rn(d1, d1)));
    }
    block_sums<2>(v, red);
    if (threadIdx.x == 0) {
      s_sum[2] = v[0];
      s_sum[3] = v[1];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double sn = __dsqrt_rn((double)nbin);
    const double nx = __dsqrt_rn(s_sum[0]);
    const bool fwd = __dsqrt_rn(s_sum[1]) <= __dmul_rn(__dmul_rn(2.0, eps), __dmul_rn(sn, nx));
    const bool inv = __dsqrt_rn(s_sum[3]) <=
                     __dmul_rn(__dmul_rn(2.0, eps),
                               __dmul_rn(__dsqrt_rn(__ddiv_rn(2.0, (double)nbin)),
                                         __dsqrt_rn(s_sum[2])));
    s_bad = !(fwd && inv && isfinite(nx));
  }
  __syncthreads();
  const double nx = __dsqrt_rn(s_sum[0]);
  const double ax0 = fabs(__ldg(Xr).x);
  const double e = __ldg(errs + r);
  const double cn = __dsqrt_rn(0.5 * nbin);
  const double* st = stats + r * (int64_t)nc * kStats;
  // pass 1: the greatest lower bound (first in grid order), non-finite stats
  double best = 0.0;
  int win = -1;
  bool bad = s_bad != 0;
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    if (repeats(same, r, L, nfact, c / nfact, c % nfact)) continue;
    const double* sc = st + kStats * c;
    const double x2 = __ldg(sc + 1), noise = __ldg(sc + 2), sig = __ldg(sc + 3);
    const CandBounds bd = cand_bounds(__ldg(sc + 4), sig, __ldg(maxima + L + c / nfact), ax0,
                                      nx, e, nbin, nh, kc, eps, gam);
    if (!isfinite(x2) || !isfinite(noise) || !isfinite(sig) || !isfinite(bd.G) ||
        !isfinite(bd.delta)) {
      bad = true;
      continue;
    }
    double lo = 0.0;
    if (__dsub_rn(x2, 1.0) <= __dsub_rn(tol, chi2_bound(x2, bd.delta, chi2_margin))) {
      const double sl = fmax(__dsub_rn(__dsqrt_rn(sig), bd.G), 0.0);
      const double sig_lo = __dmul_rn(sl, sl);
      lo = sig_lo > 0.0 ? __ddiv_rn(sig_lo, __dmul_rn(__dadd_rn(noise, bd.En), cn)) : 0.0;
    }
    keep_first_max(best, win, lo, c);
  }
  // the block's first maximum
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const double vo = __shfl_xor_sync(0xffffffffu, best, off);
    const int io = __shfl_xor_sync(0xffffffffu, win, off);
    keep_first_max(best, win, vo, io);
  }
  if (threadIdx.x % kLanes == 0) {
    red[2 * (threadIdx.x / kLanes)] = best;
    reinterpret_cast<int*>(red)[4 * kWarps + threadIdx.x / kLanes] = win;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w)
      keep_first_max(best, win, red[2 * w], reinterpret_cast<int*>(red)[4 * kWarps + w]);
    s_best = best;
    s_win = win;
  }
  __syncthreads();
  best = s_best;
  win = s_win;
  const bool keep = best > 0.0;
  // pass 2: a rival, another candidate whose upper bound reaches the best
  // lower bound within the margin (kept rows) or is above 0 (rows zeroed),
  // leaves the row uncertain
  bool rival = false;
  for (int c = threadIdx.x; c < nc && !bad && !rival; c += kThreads) {
    if (repeats(same, r, L, nfact, c / nfact, c % nfact) || (keep && c == win)) continue;
    const double* sc = st + kStats * c;
    const double x2 = __ldg(sc + 1), noise = __ldg(sc + 2), sig = __ldg(sc + 3);
    const CandBounds bd = cand_bounds(__ldg(sc + 4), sig, __ldg(maxima + L + c / nfact), ax0,
                                      nx, e, nbin, nh, kc, eps, gam);
    double hi = 0.0;
    if (!(__dsub_rn(x2, 1.0) > __dadd_rn(tol, chi2_bound(x2, bd.delta, chi2_margin)))) {
      const double sh = __dadd_rn(__dsqrt_rn(sig), bd.G);
      const double sig_hi = __dmul_rn(sh, sh);
      const double nlo = __dsub_rn(noise, bd.En);
      hi = sig_hi > 0.0 ? (nlo > 0.0 ? __ddiv_rn(sig_hi, __dmul_rn(nlo, cn)) : INFINITY) : 0.0;
    }
    rival = keep ? __dmul_rn(hi, __dadd_rn(1.0, margin)) >= best : hi > 0.0;
  }
  rival = __syncthreads_or(rival);
  if (threadIdx.x == 0) {
    const bool ok = !bad && !rival;
    uncertain[r] = ok ? 0 : 1;
    if (ok) {
      choice[2 * r] = keep ? win / nfact + 1 : 0;
      choice[2 * r + 1] = keep ? win % nfact : -1;
    }
    s_state = ok ? (keep ? 2 : 1) : 0;
  }
  __syncthreads();
  const int state = s_state;
  double* o = out + r * nbin;
  if (state == 1)
    for (int i = threadIdx.x; i < nbin; i += kThreads) o[i] = 0.0;
  if (state != 2) return;
  // the winner's smooth
  const int l = win / nfact, f = win % nfact;
  const double lf = __ldg(lam + r * nfact + f);
  double unused[4];
  for (int j = 0; j <= l; ++j)
    level_step<false>(cr + (int64_t)j * nbin, lf, lf, 0, soft, j, n, nbin, Q + (int64_t)j * nh,
                      nullptr, nullptr, 0, tw, a, b, acc, unused);
  const double2* xv = X + r * nh;
  for (int k = threadIdx.x; k <= n; k += kThreads) {
    const double p = __ldg(P + (int64_t)l * nh + k);
    const double2 x2 = __ldg(xv + k);
    acc[k] = make_double2(__dadd_rn(__dmul_rn(p, x2.x), acc[k].x),
                          __dadd_rn(__dmul_rn(p, x2.y), acc[k].y));
  }
  __syncthreads();
  const double2* z = inverse_block(acc, a, b, n, nbin, tw);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const double2 v = z[k];
    o[2 * k] = v.x;
    o[2 * k + 1] = -v.y;
  }
}

unsigned grid_of(int64_t n, int per_block) {
  const int64_t g = (n + per_block - 1) / per_block;
  return (unsigned)(g < 1 ? 1 : (g > (1 << 30) ? (1 << 30) : g));
}

}  // namespace

// X [rows, nh] complex128 (the rows' rFFT), A [L, nh] complex128 (the
// analysis table); C [rows, L, nh] complex128.  Each entry launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int pp_wavelet_analysis(const void* X, const void* A, int64_t rows, int L, int nh,
                                   void* C, void* stream) {
  if (rows <= 0) return 0;
  wavelet_analysis_kernel<<<grid_of(rows * L * (int64_t)nh, kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>((const double2*)X, (const double2*)A,
                                                    rows, L, nh, (double2*)C);
  return (int)cudaGetLastError();
}

// cD [rows, L, nbin] f64 (level 0 read), facts [nfact] f64; lam [rows,
// nfact] f64, errs [rows] f64.  npow2: the power of two >= nbin that the
// sort takes (shared memory npow2 * 8 bytes and a few more).
extern "C" int pp_wavelet_sigma(const void* X, const void* cD, const void* facts,
                                int64_t rows, int L, int nbin, int nh, int kc, int npow2,
                                int nfact, double lam_scale, void* lam, void* errs,
                                void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = (size_t)npow2 * 8 + (kSortThreads / kLanes) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wavelet_sigma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wavelet_sigma_kernel<<<(unsigned)rows, kSortThreads, smem, (cudaStream_t)stream>>>(
      (const double2*)X, (const double*)cD, (const double*)facts, L, nbin, nh, kc, npow2,
      nfact, lam_scale, (double*)lam, (double*)errs);
  return (int)cudaGetLastError();
}

// T [rows, L, nfact, nbin] f64, same [rows, L, nfact] int32; soft 0 or 1.
extern "C" int pp_wavelet_threshold(const void* cD, const void* lam, int64_t rows, int L,
                                    int nfact, int nbin, int soft, void* T, void* same,
                                    void* stream) {
  if (rows <= 0) return 0;
  wavelet_threshold_kernel<<<(unsigned)(rows * L), kThreads, (size_t)nfact * 4,
                             (cudaStream_t)stream>>>((const double*)cD, (const double*)lam,
                                                     L, nfact, nbin, soft, (double*)T,
                                                     (int*)same);
  return (int)cudaGetLastError();
}

// P [L, nh] f64, Q [L, nh] complex128; D [rows, L, nfact, nh] complex128,
// in place.
extern "C" int pp_wavelet_synthesis(const void* X, const void* P, const void* Q, int64_t rows,
                                    int L, int nfact, int nh, void* D, void* stream) {
  if (rows <= 0) return 0;
  wavelet_synthesis_kernel<<<grid_of(rows * nfact * (int64_t)nh, kThreads), kThreads, 0,
                             (cudaStream_t)stream>>>((const double2*)X, (const double*)P,
                                                     (const double2*)Q, rows, L, nfact, nh,
                                                     (double2*)D);
  return (int)cudaGetLastError();
}

// x [rows, nbin] f64, sm [rows, L, nfact, nbin] f64, S2 [rows, L, nfact,
// nh] complex128, errs [rows]; snr, chi2 [rows, L, nfact] f64.
extern "C" int pp_wavelet_search(const void* x, const void* sm, const void* S2,
                                 const void* errs, int64_t rows, int L, int nfact, int nbin,
                                 int nh, int kc, double tol, void* snr, void* chi2,
                                 void* stream) {
  if (rows <= 0) return 0;
  wavelet_search_kernel<<<grid_of(rows * L * (int64_t)nfact, kWarps), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const double*)x, (const double*)sm, (const double2*)S2, (const double*)errs, rows, L,
      nfact, nbin, nh, kc, tol, (double*)snr, (double*)chi2);
  return (int)cudaGetLastError();
}

// sm [rows, L, nfact, nbin] f64, snr, chi2 [rows, L, nfact] f64, same
// [rows, L, nfact] int32; out [rows, nbin] f64, choice [rows, 2] int64.
extern "C" int pp_wavelet_select(const void* sm, const void* snr, const void* chi2,
                                 const void* same, int64_t rows, int L, int nfact, int nbin,
                                 double tol, void* out, void* choice, void* stream) {
  if (rows <= 0) return 0;
  wavelet_select_kernel<<<grid_of(rows, kWarps), kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)sm, (const double*)snr, (const double*)chi2, (const int*)same, rows, L,
      nfact, nbin, tol, (double*)out, (int64_t*)choice);
  return (int)cudaGetLastError();
}

// X [rows, nh] complex128 (the rows' rFFT), cD [rows, L, nbin], lam [rows,
// nfact], errs [rows], P [L, nh], Q [L, nh] complex128, tw complex128
// (ops.wavelet.scan_twiddles: [nbin] and the passes' tables), qmax [L]
// f64 (max_k |Q_j[k]|); stats [rows, L, nfact, 5] f64, same [rows, L,
// nfact] int32.  nbin a power of two from 64 to 8192 (shared memory (1.5
// nbin + 1) 16 bytes).
extern "C" int pp_wavelet_scan(const void* X, const void* cD, const void* lam, const void* errs,
                               const void* P, const void* Q, const void* tw, const void* qmax,
                               int64_t rows, int L, int nfact, int nbin, int kc, int soft,
                               void* stats, void* same, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = scan_smem(nbin);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wavelet_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wavelet_scan_kernel<<<(unsigned)(rows * nfact), kThreads, smem, (cudaStream_t)stream>>>(
      (const double2*)X, (const double*)cD, (const double*)lam, (const double*)errs,
      (const double*)P, (const double2*)Q, (const double2*)tw, (const double*)qmax, L, nfact,
      nbin, kc, soft, (double*)stats, (int*)same);
  return (int)cudaGetLastError();
}

// x [rows, nbin], C [rows, L, nh] complex128 (the set-up's A_j X), maxima
// [2 L] f64 (max_k |Q_j[k]|, then max_k |P_l[k]|, per level), the scan's
// inputs and outputs as pp_wavelet_scan's; eps, gam the transforms' and the
// synthesis sums' relative error bounds; out [rows, nbin] f64, choice
// [rows, 2] int64 (written for certified rows), uncertain [rows] int32.
extern "C" int pp_wavelet_certify(const void* x, const void* X, const void* C, const void* cD,
                                  const void* lam, const void* errs, const void* P,
                                  const void* Q, const void* tw, const void* maxima,
                                  const void* stats, const void* same, int64_t rows, int L,
                                  int nfact, int nbin, int kc, int soft, double tol,
                                  double margin, double chi2_margin, double eps, double gam,
                                  void* out, void* choice, void* uncertain, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = scan_smem(nbin);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wavelet_select_certify_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  wavelet_select_certify_kernel<<<(unsigned)rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const double*)x, (const double2*)X, (const double2*)C, (const double*)cD,
      (const double*)lam, (const double*)errs, (const double*)P, (const double2*)Q,
      (const double2*)tw, (const double*)maxima, (const double*)stats, (const int*)same, L,
      nfact, nbin, kc, soft, tol, margin, chi2_margin, eps, gam, (double*)out,
      (int64_t*)choice, (int*)uncertain);
  return (int)cudaGetLastError();
}
