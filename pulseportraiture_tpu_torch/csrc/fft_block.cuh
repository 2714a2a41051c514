// The shared-memory transforms of K8 (wavelet.cu's scan) and K10
// (gauss_ft.cu): Stockham autosort passes of a complex FFT of n points,
// radix 4 after one radix-2 pass where log2 n is odd, every product and sum
// rounded in one order (no fused multiply-add), by a block of kThreads
// threads; and the split of a real FFT of 2n points from the complex FFT of
// its (even, odd) pairs.  The twiddles are ops.wavelet.scan_twiddles(2 n).

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

}  // namespace
