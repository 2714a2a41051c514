// K8: the wavelet smoothing search of smart_smooth, between cuFFT's
// transforms.
//
// Replaces the fused device function of the JAX reference
// pulseportraiture_tpu/ops/wavelet.py:177 _smart_smooth_grid: for each
// profile (row) x of nbin bins (nbin even, nh = nbin/2 + 1 harmonics), L
// levels and nfact threshold factors, the candidate of level l and factor
// f is iswt(cA_l, threshold(cD_j, lambda_f) for j < l) of the profile's
// undecimated Daubechies transform; its pseudo-S/N counts when its reduced
// chi2 against x passes chi2 - 1 <= tol; each level keeps its first best
// factor, a later level replaces the best only when strictly better, and
// the row is zeroed unless the best S/N is > 0 and its chi2 passes.  The
// reference recomputes the transform of the row for every level and the
// full inverse chain for every candidate; here it is one transform and
// tables:
//
//   X        = rFFT(x)                                   cuFFT
//   C_j      = A_j X, A_j = conj(G_j) prod_{i<j} conj(H_i)   pp_wavelet_analysis
//   cD_j     = irFFT(C_j)                                 cuFFT
//   sigma    = median |cD_0| / 0.6745, lambda_f = f_f sigma sqrt(2 ln nbin),
//   errs     = get_noise_PS(x) from X                     pp_wavelet_sigma
//   T_{j,f}  = threshold(cD_j, lambda_f), same_{j,f} = (T_{j,f} == T_{j,f-1})
//                                                         pp_wavelet_threshold
//   D_{j,f}  = rFFT(T_{j,f})                              cuFFT
//   S_{l,f}  = P_l X + sum_{j<l} Q_j D_{j,f}, in place of D_{l-1,f}
//              (P_l = prod_{i<l} |H_i|^2 / 2^l, Q_j = G_j prod_{i<j} H_i /
//              2^(j+1): iswt's recursion unrolled)      pp_wavelet_synthesis
//   sm_{l,f} = irFFT(S_{l,f}), S'_{l,f} = rFFT(sm_{l,f}) cuFFT
//   per candidate: S/N from S', chi2 from sm and x       pp_wavelet_search
//   per row: the choice, the winner's sm copied out      pp_wavelet_select
//
// with H_i = H(2^i w), G_i = G(2^i w) the level-i responses, the tables
// built on the host in float64 (ops/wavelet.py search_tables).  The
// candidates' S/N is read from the rFFT of their smoothed profile, as the
// reference reads it, not from S: the candidates that win are smooth
// enough that their top-quarter power lies at the round trip's rounding
// floor, and the reference ranks them by that floor.  Every element step
// (the products with the tables, the thresholds, the synthesis) is written
// with each product and sum rounded, no fused multiply-add, in the order of
// _kernels.smooth_search_plain: the kernel and its plain version hand
// cuFFT the same bits and differ only in the order of the per-candidate
// sums.  Candidates whose thresholded coefficients equal those of the
// factor before at every level (same_{j,f}) are the same candidate; the
// choice skips them, so an exact tie goes to the first factor whatever
// the sums' order.
//
// What bounds it on an H100: operations.  The function needs, per row, the
// L nfact real transforms of its thresholded arrays (2.5 nbin log2 nbin
// FP64 operations each) and ~24 operations per harmonic per candidate to
// form and read its spectrum: 0.40 ms at [512, 2048] (L 11, nfact 30)
// against 34 TFLOP/s, against 0.0025 ms to read the rows and write the
// result.  This design moves each candidate through device memory five
// times (T, D, S, sm, S': 3 x 5.4 MB per row at 2048 bins) and does three
// transforms per candidate, the price of reading the S/N as the reference
// does; the wrapper takes rows in chunks (_kernels.SMOOTH_CHUNK_BYTES).
//
// Design: elementwise stages one thread an element (coalesced along
// harmonics or bins); the median by a bitonic sort of |cD_0|'s bit
// patterns (non-negative doubles order as their bits; NaN last, as
// torch.sort) in shared memory, one block a row; the threshold one block a
// (row, level), factors in turn, flags of difference in shared memory; the
// per-candidate sums one warp a candidate, xor-shuffle trees; the choice
// one warp a row (lane 0 walks the (level, factor) grid, the warp copies
// the winner).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kLanes;
constexpr int kSortThreads = 512;

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

// One warp a row: lane 0 walks the grid (per level the first maximum over
// the factors that are not a repeat of the one before, NaN the greatest as
// torch.argmax; a level replaces the best only when strictly greater; the
// best S/N NaN-propagating as torch.maximum), then the warp writes the
// winner's smoothed profile, or zeros, and the choice (level, factor), or
// (0, -1).
__global__ void __launch_bounds__(kThreads)
wavelet_select_kernel(const double* __restrict__ sm, const double* __restrict__ snr,
                      const double* __restrict__ chi2, const int* __restrict__ same,
                      int64_t rows, int L, int nfact, int nbin, double tol,
                      double* __restrict__ out, int64_t* __restrict__ choice) {
  const int64_t r = (int64_t)blockIdx.x * kWarps + threadIdx.x / kLanes;
  if (r >= rows) return;  // a whole warp
  const int q = threadIdx.x % kLanes;
  int win = -1;  // candidate index within the row, -1: zeros
  if (q == 0) {
    double best = -INFINITY;
    int bl = -1, bf = 0;
    for (int l = 0; l < L; ++l) {
      int ib = -1;
      double m = 0.0;
      for (int f = 0; f < nfact; ++f) {
        // a repeat of factor f-1 at every level up to l
        bool dup = f > 0;
        for (int j = 0; dup && j <= l; ++j)
          dup = __ldg(same + (r * L + j) * nfact + f) != 0;
        if (dup) continue;
        const double v = __ldg(snr + (r * L + l) * nfact + f);
        if (ib < 0 || (!isnan(m) && (isnan(v) || v > m))) {
          ib = f;
          m = v;
        }
      }
      if (m > best) {
        bl = l;
        bf = ib;
      }
      best = (isnan(best) || isnan(m)) ? NAN : (m > best ? m : best);
    }
    if (bl >= 0 && best > 0.0 &&
        __dsub_rn(__ldg(chi2 + (r * L + bl) * nfact + bf), 1.0) <= tol)
      win = bl * nfact + bf;
    choice[2 * r] = win < 0 ? 0 : bl + 1;
    choice[2 * r + 1] = win < 0 ? -1 : bf;
  }
  win = __shfl_sync(0xffffffffu, win, 0);
  double* o = out + r * nbin;
  const double* s = sm + (r * L * nfact + (win < 0 ? 0 : win)) * (int64_t)nbin;
  for (int b = q; b < nbin; b += kLanes) o[b] = win < 0 ? 0.0 : __ldg(s + b);
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

// out [rows, nbin] f64, choice [rows, 2] int64.
extern "C" int pp_wavelet_select(const void* sm, const void* snr, const void* chi2,
                                 const void* same, int64_t rows, int L, int nfact, int nbin,
                                 double tol, void* out, void* choice, void* stream) {
  if (rows <= 0) return 0;
  wavelet_select_kernel<<<grid_of(rows, kWarps), kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)sm, (const double*)snr, (const double*)chi2, (const int*)same, rows, L,
      nfact, nbin, tol, (double*)out, (int64_t*)choice);
  return (int)cudaGetLastError();
}
