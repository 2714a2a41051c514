// K1: per-channel moments of the wideband portrait objective.
//
// Replaces the scattering-free branch of the JAX reference's
// pulseportraiture_tpu/fit/portrait.py:118 _moments (:159-189), the
// function every Newton iteration of fit/portrait.py:657 _solve evaluates
// (through :339 portrait_grad_hess), plus once each in get_nu_zeros and
// _hess_with_scales.  For every (subint, channel) row it returns
//
//   C  =  sum_k Re(z_k)              * inv_err2
//   T1 = -sum_k 2 pi k Im(z_k)       * inv_err2
//   T2 = -sum_k (2 pi k)^2 Re(z_k)   * inv_err2
//
// with z_k = cross_k * exp(2 pi i frac_k), frac_k = s*k - floor(s*k): the
// phase shift s of the row times the harmonic index, reduced mod 1 in f64
// with floor (the reference's floor-mod, never fmod) before the trig.
//
// What bounds it on an H100: bytes.  One launch reads the whole truncated
// cross-spectrum once (N x nchan x K complex128 = 1.05 GB at N=1000,
// nchan=512, K=128, >= 0.31 ms at 3.35 TB/s), while its FP64 work
// (~18 operations per element incl. sincospi) needs ~0.035 ms at the
// data-sheet 34 TFLOP/s.
//
// Design: one warp per row; the 32 lanes stride over k, each loading one
// 16-byte complex value per step, so a warp reads 512 contiguous bytes
// per instruction; a shuffle reduction finishes the row.  No
// [N, nchan, K] temporary (phasor or product) ever reaches device memory
// -- the sums are formed in registers.  An optional lane list lets the
// batched solver evaluate only its still-active subints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr double kTwoPi = 6.283185307179586;  // 2.0 * pi, as in the reference

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
moments_kernel(const double2* __restrict__ cross, const double* __restrict__ shifts,
               const double* __restrict__ inv_err2, const int64_t* __restrict__ lanes,
               int64_t nrows, int nchan, int K, double* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= nrows) return;  // whole warp leaves together
  const int64_t i = row / nchan;
  const int64_t c = row - i * nchan;
  const int64_t src = (lanes ? lanes[i] : i) * nchan + c;
  const double2* x = cross + src * (int64_t)K;
  const double s = shifts[row];

  double acc_c = 0.0, acc_t1 = 0.0, acc_t2 = 0.0;
#pragma unroll 4
  for (int k = lane; k < K; k += 32) {
    const double kd = (double)k;
    const double sk = s * kd;
    const double frac = sk - floor(sk);
    double sn, cs;
    sincospi(2.0 * frac, &sn, &cs);
    const double2 v = __ldg(x + k);
    const double re = v.x * cs - v.y * sn;
    const double im = v.x * sn + v.y * cs;
    const double tpk = kTwoPi * kd;
    acc_c += re;
    acc_t1 += tpk * im;
    acc_t2 += (tpk * tpk) * re;
  }
  acc_c = warp_sum(acc_c);
  acc_t1 = warp_sum(acc_t1);
  acc_t2 = warp_sum(acc_t2);
  if (lane == 0) {
    const double w = inv_err2[src];
    out[row * 3 + 0] = acc_c * w;
    out[row * 3 + 1] = -acc_t1 * w;
    out[row * 3 + 2] = -acc_t2 * w;
  }
}

}  // namespace

// cross [B, nchan, K] complex128 (interleaved f64), inv_err2 [B, nchan];
// shifts [n, nchan] and out [n, nchan, 3] are indexed by the compact row
// i < n, whose source subint is lanes[i] (or i when lanes is null).
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int pp_moments(const void* cross, const void* shifts, const void* inv_err2,
                          const void* lanes, int64_t n, int nchan, int K, void* out,
                          void* stream) {
  const int64_t nrows = n * (int64_t)nchan;
  if (nrows <= 0) return 0;
  const int64_t blocks = (nrows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  moments_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const double2*)cross, (const double*)shifts, (const double*)inv_err2,
      (const int64_t*)lanes, nrows, nchan, K, (double*)out);
  return (int)cudaGetLastError();
}
