// The shared-memory transforms of K8 (wavelet.cu's scan), K10
// (gauss_ft.cu) and K12 (synth.cu): Stockham autosort passes of a complex
// FFT of n points, radix 4 after one radix-2 pass where log2 n is odd, every
// product and sum rounded in one order (no fused multiply-add), by a block
// of kThreads threads; the split of a real FFT of 2n points from the complex
// FFT of its (even, odd) pairs; and the inverse real FFT: its merge of the
// n + 1 harmonics into n points and the inverse passes.  The twiddles are
// ops.wavelet.scan_twiddles(2 n).

#pragma once

#include <cuda_runtime.h>

namespace {

// One pass: radix R, p points done; wp the pass's twiddles, entry (q - 1) p
// + k for butterfly input q of the butterflies k (mod p), read coalesced.
template <int kThreads, int R>
__device__ __forceinline__ void fft_pass(const double2* __restrict__ src,
                                         double2* __restrict__ dst, int n, int p,
                                         const double2* __restrict__ wp) {
  const int m = n / R;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int k = i & (p - 1);
    double2 u[R];
#pragma unroll
    for (int q = 0; q < R; ++q) u[q] = src[i + q * m];
#pragma unroll
    for (int q = 1; q < R; ++q) {
      const double2 w = __ldg(wp + (q - 1) * p + k);
      const double a = u[q].x, b = u[q].y;
      u[q].x = __dsub_rn(__dmul_rn(a, w.x), __dmul_rn(b, w.y));
      u[q].y = __dadd_rn(__dmul_rn(a, w.y), __dmul_rn(b, w.x));
    }
    const int j = (i - k) * R + k;
    if constexpr (R == 2) {
      dst[j] = make_double2(__dadd_rn(u[0].x, u[1].x), __dadd_rn(u[0].y, u[1].y));
      dst[j + p] = make_double2(__dsub_rn(u[0].x, u[1].x), __dsub_rn(u[0].y, u[1].y));
    } else {
      const double b0r = __dadd_rn(u[0].x, u[2].x), b0i = __dadd_rn(u[0].y, u[2].y);
      const double b1r = __dsub_rn(u[0].x, u[2].x), b1i = __dsub_rn(u[0].y, u[2].y);
      const double b2r = __dadd_rn(u[1].x, u[3].x), b2i = __dadd_rn(u[1].y, u[3].y);
      const double b3r = __dsub_rn(u[1].x, u[3].x), b3i = __dsub_rn(u[1].y, u[3].y);
      dst[j] = make_double2(__dadd_rn(b0r, b2r), __dadd_rn(b0i, b2i));
      dst[j + p] = make_double2(__dadd_rn(b1r, b3i), __dsub_rn(b1i, b3r));
      dst[j + 2 * p] = make_double2(__dsub_rn(b0r, b2r), __dsub_rn(b0i, b2i));
      dst[j + 3 * p] = make_double2(__dsub_rn(b1r, b3i), __dadd_rn(b1i, b3r));
    }
  }
}

// The forward FFT of the n points in a (b the other buffer); the block has
// written a and synchronised.  tw is the scan's table (ops.wavelet
// scan_twiddles: nbin natural entries, then the passes' own).  Returns the
// buffer that holds the result, synchronised.
template <int kThreads>
__device__ double2* fft_block(double2* a, double2* b, int n, int nbin,
                              const double2* __restrict__ tw) {
  const double2* wp = tw + nbin;
  int p = 1;
  if ((31 - __clz(n)) & 1) {
    fft_pass<kThreads, 2>(a, b, n, p, wp);
    __syncthreads();
    double2* t = a;
    a = b;
    b = t;
    wp += p;
    p = 2;
  }
  for (; p < n; p *= 4) {
    fft_pass<kThreads, 4>(a, b, n, p, wp);
    wp += 3 * p;
    __syncthreads();
    double2* t = a;
    a = b;
    b = t;
  }
  return a;
}

// fft_pass over `rows` transforms at once, each of n points, stored n apart
// in src and dst: the same butterflies in the same order of operations,
// each butterfly's twiddles loaded once for all the rows it takes (where
// the block has more threads than a row has butterflies, kThreads / m
// groups of threads each take every kThreads / m-th row).
template <int kThreads, int R>
__device__ __forceinline__ void fft_pass_rows(const double2* __restrict__ src,
                                              double2* __restrict__ dst, int n, int p,
                                              const double2* __restrict__ wp, int rows) {
  const int m = n / R, groups = kThreads > m ? kThreads / m : 1, tpg = kThreads / groups;
  for (int i = threadIdx.x % tpg; i < m; i += tpg) {
    const int k = i & (p - 1), j = (i - k) * R + k;
    double2 w[R];
#pragma unroll
    for (int q = 1; q < R; ++q) w[q] = __ldg(wp + (q - 1) * p + k);
    for (int r = threadIdx.x / tpg; r < rows; r += groups) {
      const double2* s = src + r * n;
      double2* d = dst + r * n;
      double2 u[R];
#pragma unroll
      for (int q = 0; q < R; ++q) u[q] = s[i + q * m];
#pragma unroll
      for (int q = 1; q < R; ++q) {
        const double a = u[q].x, b = u[q].y;
        u[q].x = __dsub_rn(__dmul_rn(a, w[q].x), __dmul_rn(b, w[q].y));
        u[q].y = __dadd_rn(__dmul_rn(a, w[q].y), __dmul_rn(b, w[q].x));
      }
      if constexpr (R == 2) {
        d[j] = make_double2(__dadd_rn(u[0].x, u[1].x), __dadd_rn(u[0].y, u[1].y));
        d[j + p] = make_double2(__dsub_rn(u[0].x, u[1].x), __dsub_rn(u[0].y, u[1].y));
      } else {
        const double b0r = __dadd_rn(u[0].x, u[2].x), b0i = __dadd_rn(u[0].y, u[2].y);
        const double b1r = __dsub_rn(u[0].x, u[2].x), b1i = __dsub_rn(u[0].y, u[2].y);
        const double b2r = __dadd_rn(u[1].x, u[3].x), b2i = __dadd_rn(u[1].y, u[3].y);
        const double b3r = __dsub_rn(u[1].x, u[3].x), b3i = __dsub_rn(u[1].y, u[3].y);
        d[j] = make_double2(__dadd_rn(b0r, b2r), __dadd_rn(b0i, b2i));
        d[j + p] = make_double2(__dadd_rn(b1r, b3i), __dsub_rn(b1i, b3r));
        d[j + 2 * p] = make_double2(__dsub_rn(b0r, b2r), __dsub_rn(b0i, b2i));
        d[j + 3 * p] = make_double2(__dsub_rn(b1r, b3i), __dadd_rn(b1i, b3r));
      }
    }
  }
}

// One radix-4 butterfly as fft_pass forms it: u[1..3] times the twiddles
// w[1..3], then the four outputs (to dst[j + q p] in fft_pass) into y.
__device__ __forceinline__ void radix4_rows(double2 (&u)[4], const double2* w, double2* y) {
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    const double a = u[q].x, b = u[q].y;
    u[q].x = __dsub_rn(__dmul_rn(a, w[q].x), __dmul_rn(b, w[q].y));
    u[q].y = __dadd_rn(__dmul_rn(a, w[q].y), __dmul_rn(b, w[q].x));
  }
  const double b0r = __dadd_rn(u[0].x, u[2].x), b0i = __dadd_rn(u[0].y, u[2].y);
  const double b1r = __dsub_rn(u[0].x, u[2].x), b1i = __dsub_rn(u[0].y, u[2].y);
  const double b2r = __dadd_rn(u[1].x, u[3].x), b2i = __dadd_rn(u[1].y, u[3].y);
  const double b3r = __dsub_rn(u[1].x, u[3].x), b3i = __dsub_rn(u[1].y, u[3].y);
  y[0] = make_double2(__dadd_rn(b0r, b2r), __dadd_rn(b0i, b2i));
  y[1] = make_double2(__dadd_rn(b1r, b3i), __dsub_rn(b1i, b3r));
  y[2] = make_double2(__dsub_rn(b0r, b2r), __dsub_rn(b0i, b2i));
  y[3] = make_double2(__dsub_rn(b1r, b3i), __dadd_rn(b1i, b3r));
}

// Two radix-4 passes at once (p points done, then 4 p; 16 p <= n), over
// `rows` transforms n apart: group g < n / 16 (k = g mod p) holds in
// registers the four first-pass butterflies g + q' n / 16, whose outputs q
// are the inputs q' of the second-pass butterflies 4 (g - k) + q p + k, so
// each value crosses shared memory once for two passes.  The same
// butterflies, twiddles and order of operations as two fft_pass_rows.
template <int kThreads>
__device__ __forceinline__ void fft_pass16_rows(const double2* __restrict__ src,
                                                double2* __restrict__ dst, int n, int p,
                                                const double2* __restrict__ wp, int rows) {
  const int m = n / 4, m4 = n / 16;
  const int groups = kThreads > m4 ? kThreads / m4 : 1, tpg = kThreads / groups;
  for (int g = threadIdx.x % tpg; g < m4; g += tpg) {
    const int k = g & (p - 1), out = (g - k) * 16 + k;
    double2 wa[4];
#pragma unroll
    for (int q = 1; q < 4; ++q) wa[q] = __ldg(wp + (q - 1) * p + k);
    for (int r = threadIdx.x / tpg; r < rows; r += groups) {
      const double2* s = src + r * n;
      double2* d = dst + r * n;
      double2 y[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        double2 u[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) u[q] = s[g + a * m4 + q * m];
        radix4_rows(u, wa, y[a]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        double2 wb[4], u[4], z[4];
#pragma unroll
        for (int a = 1; a < 4; ++a) wb[a] = __ldg(wp + 3 * p + (a - 1) * 4 * p + q * p + k);
#pragma unroll
        for (int a = 0; a < 4; ++a) u[a] = y[a][q];
        radix4_rows(u, wb, z);
#pragma unroll
        for (int c = 0; c < 4; ++c) d[out + q * p + c * 4 * p] = z[c];
      }
    }
  }
}

// fft_block over `rows` transforms at once (row r at a + r n, its other
// buffer b + r n): one barrier a pass for all of them, and each pair of
// radix-4 passes that fits (16 p <= n) done as one (fft_pass16_rows).
// Returns the buffer whose rows hold the results, synchronised.
template <int kThreads>
__device__ double2* fft_block_rows(double2* a, double2* b, int n, int nbin,
                                   const double2* __restrict__ tw, int rows) {
  const double2* wp = tw + nbin;
  int p = 1;
  if ((31 - __clz(n)) & 1) {
    fft_pass_rows<kThreads, 2>(a, b, n, p, wp, rows);
    __syncthreads();
    double2* t = a;
    a = b;
    b = t;
    wp += p;
    p = 2;
  }
  while (p < n) {
    if (16 * p <= n) {
      fft_pass16_rows<kThreads>(a, b, n, p, wp, rows);
      wp += 15 * p;
      p *= 16;
    } else {
      fft_pass_rows<kThreads, 4>(a, b, n, p, wp, rows);
      wp += 3 * p;
      p *= 4;
    }
    __syncthreads();
    double2* t = a;
    a = b;
    b = t;
  }
  return a;
}

// Harmonic k (0..n) of the real FFT whose (even, odd) pairs' complex FFT is z.
__device__ __forceinline__ double2 split(const double2* z, int k, int n,
                                         const double2* __restrict__ tw) {
  const double2 pz = z[k == n ? 0 : k], mz = z[k == 0 ? 0 : n - k];
  const double er = __dmul_rn(__dadd_rn(pz.x, mz.x), 0.5);
  const double ei = __dmul_rn(__dsub_rn(pz.y, mz.y), 0.5);
  const double orr = __dmul_rn(__dsub_rn(pz.x, mz.x), 0.5);
  const double oi = __dmul_rn(__dadd_rn(pz.y, mz.y), 0.5);
  const double2 w = __ldg(tw + k);
  return make_double2(__dadd_rn(er, __dadd_rn(__dmul_rn(w.x, oi), __dmul_rn(w.y, orr))),
                      __dadd_rn(ei, __dsub_rn(__dmul_rn(w.y, oi), __dmul_rn(w.x, orr))));
}

// split with harmonic k's twiddle w = tw[k] given (loaded once for several
// rows): the same arithmetic.
__device__ __forceinline__ double2 split_w(const double2* z, int k, int n, double2 w) {
  const double2 pz = z[k == n ? 0 : k], mz = z[k == 0 ? 0 : n - k];
  const double er = __dmul_rn(__dadd_rn(pz.x, mz.x), 0.5);
  const double ei = __dmul_rn(__dsub_rn(pz.y, mz.y), 0.5);
  const double orr = __dmul_rn(__dsub_rn(pz.x, mz.x), 0.5);
  const double oi = __dmul_rn(__dadd_rn(pz.y, mz.y), 0.5);
  return make_double2(__dadd_rn(er, __dadd_rn(__dmul_rn(w.x, oi), __dmul_rn(w.y, orr))),
                      __dadd_rn(ei, __dsub_rn(__dmul_rn(w.y, oi), __dmul_rn(w.x, orr))));
}

// The inverse of split (K8's inverse_block, _kernels._irfft_scan): point k
// (0..n-1) of the conjugated half-size sequence whose inverse transform's
// (even, odd) pairs are the 2n real points of the inverse real FFT, from
// harmonics sa = S_k and sb = S_{n-k} (S_n for k = 0) of n + 1, scaled by
// inv = 1 / 2n; the imaginary parts of harmonics 0 and n are dropped, as
// irFFT drops them.  w = tw[k].
__device__ __forceinline__ double2 merge_w(double2 sa, double2 sb, int k, double inv,
                                           double2 w) {
  const double ai = k == 0 ? 0.0 : sa.y, bi = k == 0 ? 0.0 : sb.y;
  const double er = __dmul_rn(__dadd_rn(sa.x, sb.x), inv);
  const double ei = __dmul_rn(__dsub_rn(ai, bi), inv);
  const double o_r = __dmul_rn(__dsub_rn(sa.x, sb.x), inv);
  const double o_i = __dmul_rn(__dadd_rn(ai, bi), inv);
  const double wr = __dadd_rn(__dmul_rn(o_r, w.x), __dmul_rn(o_i, w.y));
  const double wi = __dsub_rn(__dmul_rn(o_i, w.x), __dmul_rn(o_r, w.y));
  return make_double2(__dsub_rn(er, wi), -__dadd_rn(ei, wr));
}

}  // namespace
