// K2: batched FFTFIT -- phase of each profile against its template.
//
// Replaces the JAX reference's pulseportraiture_tpu/fit/phase_shift.py:64
// _fit_phase_shift_core and its objective :40 phase_shift_objective, up to
// the scale/error formulas (which the caller evaluates from the three
// outputs).  Per profile b, from the cross-spectrum x_k = d_k conj(m_k)
// (all nharm harmonics) and inv_err2[b]:
//
//   grid:   Cgrid[g] = -sum_k Re(x_k exp(2 pi i ((v_g k) mod 1))),
//           v_g = lo + (hi - lo) g / Ns; phase0 = v at the FIRST argmin
//   Newton: newton_iter safeguarded steps  phase += clip(-dC/d2C, +-cell)
//           (no step where d2C <= 0), cell = (hi - lo) / Ns
//   wrap:   phase = (phase + 0.5) mod 1 - 0.5
//   out:    phase, C = -sum Re(z) * inv_err2, d2C = 4 pi^2 sum k^2 Re(z) *
//           inv_err2 at the final phase, z_k = x_k exp(2 pi i (phase k mod 1)).
//
// What bounds it on an H100: operations.  The grid phasors do not depend
// on the profile, so the least work is the grid stage as one float64
// product [N, nharm] x [nharm, Ns] with a shared table (4 N nharm Ns =
// 4.1e8 operations at N=1000, Ns=100, nharm=1025: 6.1 us on the FP64
// tensor cores at 67 TFLOP/s) plus ~18 FP64 operations per harmonic for
// each Newton step and the final objective (3.8 us at 34 TFLOP/s); the
// whole input is only 16 MB (4.9 us at 3.35 TB/s).  This simple design
// recomputes the grid phasors for every profile instead (1.0e8 sincospi
// on the FP64 pipes), so it runs far above that bound; a shared phasor
// table is the way down.
//
// Design: one block per profile.  The profile's cross-spectrum is staged
// once in shared memory (nharm x 16 B = 16 KB at nbin=2048); the warps
// split the grid points, lanes stride over k and a shuffle reduction
// closes each grid point, so no [N, Ns] or [Ns, nharm] array ever exists
// in device memory.  The Newton steps and the final objective are block
// reductions over the staged spectrum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 2.0 * kPi;             // 2.0 * pi, as in the reference
constexpr double kFourPi2 = 4.0 * (kPi * kPi);   // 4.0 * pi ** 2, as in the reference

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums (a, b) over the block; the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(double& a, double& b, double* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the previous call
  if (l == 0) {
    red[w] = a;
    red[kWarps + w] = b;
  }
  __syncthreads();
  if (w == 0) {
    a = l < kWarps ? red[l] : 0.0;
    b = l < kWarps ? red[kWarps + l] : 0.0;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// z_k = x_k exp(2 pi i (phase k mod 1)): returns (Re z, Im z).
__device__ __forceinline__ double2 rotate(double2 x, double phase, int k) {
  const double pk = phase * (double)k;
  const double frac = pk - floor(pk);
  double sn, cs;
  sincospi(2.0 * frac, &sn, &cs);
  return make_double2(x.x * cs - x.y * sn, x.x * sn + x.y * cs);
}

__global__ void __launch_bounds__(kThreads)
fftfit_kernel(const double2* __restrict__ cross, const double* __restrict__ inv_err2,
              int nharm, double lo, double hi, int Ns, int newton_iter,
              double* __restrict__ phase_out, double* __restrict__ C_out,
              double* __restrict__ d2C_out) {
  extern __shared__ double2 smem[];
  double2* xs = smem;                        // [nharm]
  double* cgrid = (double*)(xs + nharm);     // [Ns]
  __shared__ double red[2 * kWarps];
  __shared__ double s_phase;

  const int64_t b = blockIdx.x;
  const double2* x = cross + b * (int64_t)nharm;
  for (int k = threadIdx.x; k < nharm; k += kThreads) xs[k] = x[k];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < Ns; g += kWarps) {
    const double v = lo + ((hi - lo) * (double)g) / Ns;
    double acc = 0.0;
    for (int k = lane; k < nharm; k += 32) acc += rotate(xs[k], v, k).x;
    acc = warp_sum(acc);
    if (lane == 0) cgrid[g] = -acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // first minimum, NaN-propagating like an argmin
    int best = 0;
    double bv = cgrid[0];
    for (int g = 1; g < Ns; ++g) {
      const double c = cgrid[g];
      if (c < bv || (c != c && bv == bv)) {
        bv = c;
        best = g;
      }
    }
    s_phase = lo + ((hi - lo) * (double)best) / Ns;
  }
  __syncthreads();

  const double w = inv_err2[b];
  const double cell = (hi - lo) / Ns;
  for (int it = 0; it < newton_iter; ++it) {
    const double phase = s_phase;
    double s1 = 0.0, s2 = 0.0;
    for (int k = threadIdx.x; k < nharm; k += kThreads) {
      const double2 z = rotate(xs[k], phase, k);
      const double kd = (double)k;
      s1 += kd * z.y;
      s2 += (kd * kd) * z.x;
    }
    block_sum2(s1, s2, red);
    if (threadIdx.x == 0) {
      const double dC = (kTwoPi * s1) * w;
      const double d2C = (kFourPi2 * s2) * w;
      double step = d2C > 0.0 ? -dC / d2C : 0.0;
      step = step < -cell ? -cell : (step > cell ? cell : step);  // NaN passes
      s_phase = phase + step;
    }
    __syncthreads();
  }

  double phase = s_phase + 0.5;
  phase = (phase - floor(phase)) - 0.5;
  double s0 = 0.0, s2 = 0.0;
  for (int k = threadIdx.x; k < nharm; k += kThreads) {
    const double2 z = rotate(xs[k], phase, k);
    const double kd = (double)k;
    s0 += z.x;
    s2 += (kd * kd) * z.x;
  }
  block_sum2(s0, s2, red);
  if (threadIdx.x == 0) {
    phase_out[b] = phase;
    C_out[b] = -s0 * w;
    d2C_out[b] = (kFourPi2 * s2) * w;
  }
}

}  // namespace

// cross [n, nharm] complex128 (interleaved f64), inv_err2 [n]; outputs
// phase, C, d2C [n] f64.  Launches on `stream`; returns the cudaError_t
// of the launch (a shared-memory request above the card's limit is
// refused here, not silently).
extern "C" int pp_fftfit(const void* cross, const void* inv_err2, int64_t n, int nharm,
                         double lo, double hi, int Ns, int newton_iter, void* phase_out,
                         void* C_out, void* d2C_out, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = (size_t)nharm * sizeof(double2) + (size_t)Ns * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fftfit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fftfit_kernel<<<(unsigned)n, kThreads, smem, (cudaStream_t)stream>>>(
      (const double2*)cross, (const double*)inv_err2, nharm, lo, hi, Ns, newton_iter,
      (double*)phase_out, (double*)C_out, (double*)d2C_out);
  return (int)cudaGetLastError();
}
