// K7: the rotation phasor, in place on cuFFT's output.
//
// Replaces the phasor product between an rFFT and its inverse in the JAX
// reference: pulseportraiture_tpu/ops/fourier.py:210 apply_phasor (which
// rotate_data, rotate_portrait_full and add_DM_nu call, and with them the
// dedispersion of an archive, the load's work copy and the pptoas guess).
//
// The phasor of a row with shift s at harmonic k is computed as
// ops/fourier.py phasor does (phasor.cuh's rotated, which K12 shares): f =
// (s k) floor-mod 1 in float64 (fmod, and 1 added to a negative remainder,
// as torch.remainder), the angle 2 pi f, then cos and sin; out_rk = X_rk *
// phasor(s_r, k), the complex product in rounded real operations (no fused
// multiply-add).
//
// What bounds it on an H100: bytes.  It reads and writes the spectrum
// once: 2.15 GB at 65,536 rows of 1025 harmonics, >= 0.64 ms at
// 3.35 TB/s.  Each harmonic takes a sincos (~20 FP64 operations) and 6
// more.
//
// Design: elementwise, one thread an element (16-byte loads and stores,
// neighbouring threads on neighbouring harmonics).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phasor.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rotate_kernel(const double2* X, const double* __restrict__ shifts,
              double2* out /* may be X */, int64_t n, int nharm, double two_pi) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int64_t r = i / nharm;
  out[i] = rotated(X[i], shifts[r], (int)(i - r * nharm), two_pi);
}

}  // namespace

// X [rows, nharm] complex128 (interleaved f64), shifts [rows] f64 [rot];
// out [rows, nharm] complex128 (X itself allowed); two_pi = 2 pi sign.
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int pp_rotate(const void* X, const void* shifts, int64_t rows, int nharm,
                         double two_pi, void* out, void* stream) {
  const int64_t n = rows * (int64_t)nharm;
  if (n <= 0) return 0;
  rotate_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>((const double2*)X, (const double*)shifts,
                                          (double2*)out, n, nharm, two_pi);
  return (int)cudaGetLastError();
}
