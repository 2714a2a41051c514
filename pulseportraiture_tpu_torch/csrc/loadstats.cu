// K6: the load's per-profile noise and S/N, one pass over each profile and
// its spectrum.
//
// Replaces the load-time statistics of the JAX reference,
// pulseportraiture_tpu/io/archive.py:121-131 and :148-150, which run
// pulseportraiture_tpu/ops/noise.py's get_noise_PS and get_SNR on the
// host (its ``host_stats_device``): each an rFFT of the whole cube and a
// few passes over it.  The rFFT stays with cuFFT (torch.fft.rfft, in
// chunks of subints); this kernel reads each row and its spectrum once.
//
// For each (subint, pol, channel) row x of nbin bins and its spectrum X of
// nharm = nbin / 2 + 1 harmonics:
//
//   noise = sqrt((sum_{k >= kc} |X_k|^2 / nbin) / (nharm - kc))
//           kc = int(0.75 nharm); |X|^2 = re*re + im*im, each product
//           rounded (the reference's real(X conj(X))): get_noise_PS;
//   SNR   = mask * (sum x / (noise sqrt(Weq))) / fudge, Weq = sum x /
//           max x, Weq <= 0 giving mask 0 and Weq 1: get_SNR, whose own
//           noise is this noise (its noise_method is "PS").
//
// A NaN in the row or its spectrum gives NaN, as in the reference.
//
// What bounds it on an H100: bytes.  It reads each row (8 B a bin) and its
// spectrum (16 B a harmonic) once and writes two doubles a row: 2.15 GB at
// the pptoas archive's 65,536 rows of 2048 bins, >= 0.64 ms at 3.35 TB/s,
// against ~3 FP64 operations a harmonic and 2 a bin.
//
// Design: one warp per row, eight rows a block.  Lane q reads bins q + 32j
// and harmonics q + 32j (neighbouring lanes on neighbouring addresses) and
// keeps partial sums in order of j; xor-shuffle trees join them, so the
// result depends on nothing but the row (not on the chunk it came in).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kLanes * kRowsPerBlock;

// NaN-propagating max, as torch.max
__device__ __forceinline__ double nan_max(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
load_stats_kernel(const double* __restrict__ x, const double2* __restrict__ X, int64_t rows,
                  int nbin, int nharm, int kc, double fudge, double* __restrict__ noise,
                  double* __restrict__ snr) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  if (row >= rows) return;  // a whole warp: no shuffle loses a lane
  const int q = threadIdx.x % kLanes;
  const double2* f = X + row * (int64_t)nharm;
  double p = 0.0;
  for (int k = kc + q; k < nharm; k += kLanes) {
    const double2 v = __ldg(f + k);
    p = __dadd_rn(p, __dadd_rn(__dmul_rn(v.x, v.x), __dmul_rn(v.y, v.y)));
  }
  double s = 0.0, m = -INFINITY;
  if (snr != nullptr) {
    const double* r = x + row * (int64_t)nbin;
    for (int b = q; b < nbin; b += kLanes) {
      const double v = __ldg(r + b);
      s = __dadd_rn(s, v);
      m = nan_max(m, v);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    p = __dadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off));
    s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (q != 0) return;
  const double sigma = __dsqrt_rn(__ddiv_rn(__ddiv_rn(p, (double)nbin),
                                            (double)(nharm - kc)));
  noise[row] = sigma;
  if (snr == nullptr) return;
  double weq = __ddiv_rn(s, m);
  const double mask = weq <= 0.0 ? 0.0 : 1.0;
  if (weq <= 0.0) weq = 1.0;
  const double v = __ddiv_rn(s, __dmul_rn(sigma, __dsqrt_rn(weq)));
  snr[row] = __ddiv_rn(__dmul_rn(v, mask), fudge);
}

}  // namespace

// x [rows, nbin] f64 (read only when snr is given), X [rows, nharm]
// complex128 (interleaved f64) its rFFT; kc the first harmonic of the
// noise mean; noise [rows] f64, snr [rows] f64 or null (no S/N).
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int pp_load_stats(const void* x, const void* X, int64_t rows, int nbin,
                             int nharm, int kc, double fudge, void* noise, void* snr,
                             void* stream) {
  if (rows <= 0) return 0;
  const unsigned grid = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  load_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)x, (const double2*)X, rows, nbin, nharm, kc, fudge, (double*)noise,
      (double*)snr);
  return (int)cudaGetLastError();
}
