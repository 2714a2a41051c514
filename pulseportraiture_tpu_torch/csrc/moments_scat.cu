// K3: per-channel scattering moments of the wideband portrait objective.
//
// Replaces the scattering branch of the JAX reference's
// pulseportraiture_tpu/fit/portrait.py:118 _moments (:191-323), which every
// Newton iteration of a scattering fit (fit_flags with tau or alpha, or a
// fixed nonzero tau) evaluates through :339 portrait_grad_hess, plus once
// each in get_nu_zeros and _hess_with_scales.  With the scattering kernel
// B_k = 1 / (1 + i x_k), x_k = 2 pi k tau_n, of the row's channel time
// tau_n, and the phasor p_k = exp(2 pi i frac_k), frac_k = s*k - floor(s*k)
// (floor-mod in f64 before the trig, as K1), each (subint, channel) row
// gets nine harmonic sums, each times inv_err2:
//
//   C  =  sum Re(z)                 z  = cross conj(B) p
//   S  =  sum |B|^2 |m|^2
//   T1 = -sum 2 pi k Im(z)
//   T2 = -sum (2 pi k)^2 Re(z)
//   Q0 =  sum Re(z1)                z1 = cross conj(dB) p,  dB = dB/dtau_n
//   Q1 = -sum 2 pi k Im(z1)                              = -i 2 pi k B^2
//   W2 =  sum Re(cross conj(d2B) p)     d2B = d2B/dtau_n^2 = -2 (2 pi k)^2 B^3
//   S1 =  sum 2 Re(B conj(dB)) |m|^2
//   S2 =  sum 2 (|dB|^2 + Re(B conj(d2B))) |m|^2
//
// the harmonic reductions of the reference's real-pair branch (:191-268).
// The (tau, alpha) chain rule -- d tau_n / d(tau, alpha) and its second
// derivatives -- multiplies these per row outside the kernel, in torch.
//
// What bounds it on an H100: bytes, with FP64 close behind.  One launch
// reads the truncated cross-spectrum once (N x nchan x K complex128 =
// 1.05 GB at N=1000, nchan=512, K=128: >= 0.31 ms at 3.35 TB/s); |m|^2 is
// shared by the batch (one [nchan, K] row set, L2-resident) or per subint
// (8 more bytes per element).  Its FP64 work is ~81 operations per element
// (sincospi counted as 2, the one division as 1): ~5.3 GFLOP at that shape,
// ~0.16 ms at the data-sheet 34 TFLOP/s.
//
// Design, as K1: one warp per row; the 32 lanes stride over k, each
// loading one 16-byte complex value per step (a warp reads 512 contiguous
// bytes per instruction); nine register accumulators and a shuffle
// reduction per sum.  The phasor is applied to cross once (u = cross p),
// so z, z1 and the W2 term are u times conj(B), conj(dB), conj(d2B); B
// takes one division per element.  No [N, nchan, K] temporary reaches
// device memory.  An optional lane list lets the batched solver evaluate
// only its still-active subints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kSums = 9;
constexpr double kTwoPi = 6.283185307179586;  // 2.0 * pi, as in the reference

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
moments_scat_kernel(const double2* __restrict__ cross, const double* __restrict__ abs_m2,
                    int64_t m_bstride, const double* __restrict__ shifts,
                    const double* __restrict__ taus, const double* __restrict__ inv_err2,
                    const int64_t* __restrict__ lanes, int64_t nrows, int nchan, int K,
                    double* __restrict__ out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= nrows) return;  // whole warp leaves together
  const int64_t i = row / nchan;
  const int64_t c = row - i * nchan;
  const int64_t b = lanes ? lanes[i] : i;
  const int64_t src = b * nchan + c;
  const double2* x = cross + src * (int64_t)K;
  const double* am = abs_m2 + b * m_bstride + c * (int64_t)K;
  const double s = shifts[row];
  const double tau = taus[row];

  double aC = 0.0, aS = 0.0, aT1 = 0.0, aT2 = 0.0, aQ0 = 0.0, aQ1 = 0.0,
         aW2 = 0.0, aS1 = 0.0, aS2 = 0.0;
#pragma unroll 2
  for (int k = lane; k < K; k += 32) {
    const double kd = (double)k;
    const double sk = s * kd;
    const double frac = sk - floor(sk);
    double sn, cs;
    sincospi(2.0 * frac, &sn, &cs);
    const double2 v = __ldg(x + k);
    const double m = __ldg(am + k);
    // u = cross * phasor
    const double ur = v.x * cs - v.y * sn;
    const double ui = v.x * sn + v.y * cs;
    // B = 1 / (1 + i x) = (1 - i x) / (1 + x^2)
    const double tpk = kTwoPi * kd;
    const double xx = tpk * tau;
    const double br = 1.0 / (1.0 + xx * xx);
    const double bi = -xx * br;
    // z = u conj(B)
    const double zr = ur * br + ui * bi;
    const double zi = ui * br - ur * bi;
    aC += zr;
    aT1 += tpk * zi;
    aT2 += (tpk * tpk) * zr;
    // dB = -i tpk B^2
    const double b2r = br * br - bi * bi;
    const double b2i = 2.0 * br * bi;
    const double dbr = tpk * b2i;
    const double dbi = -tpk * b2r;
    const double z1r = ur * dbr + ui * dbi;
    const double z1i = ui * dbr - ur * dbi;
    aQ0 += z1r;
    aQ1 += tpk * z1i;
    // d2B = -2 tpk^2 B^3
    const double b3r = b2r * br - b2i * bi;
    const double b3i = b2r * bi + b2i * br;
    const double f2 = -2.0 * (tpk * tpk);
    const double d2br = f2 * b3r;
    const double d2bi = f2 * b3i;
    aW2 += ur * d2br + ui * d2bi;
    aS += (br * br + bi * bi) * m;
    aS1 += 2.0 * (br * dbr + bi * dbi) * m;
    aS2 += 2.0 * ((dbr * dbr + dbi * dbi) + (br * d2br + bi * d2bi)) * m;
  }
  aC = warp_sum(aC);
  aS = warp_sum(aS);
  aT1 = warp_sum(aT1);
  aT2 = warp_sum(aT2);
  aQ0 = warp_sum(aQ0);
  aQ1 = warp_sum(aQ1);
  aW2 = warp_sum(aW2);
  aS1 = warp_sum(aS1);
  aS2 = warp_sum(aS2);
  if (lane == 0) {
    const double w = inv_err2[src];
    double* o = out + row * kSums;
    o[0] = aC * w;
    o[1] = aS * w;
    o[2] = -aT1 * w;
    o[3] = -aT2 * w;
    o[4] = aQ0 * w;
    o[5] = -aQ1 * w;
    o[6] = aW2 * w;
    o[7] = aS1 * w;
    o[8] = aS2 * w;
  }
}

}  // namespace

// cross [B, nchan, K] complex128 (interleaved f64); abs_m2 [B or 1, nchan, K]
// f64 whose batch stride (in elements) is m_bstride (0 when one set of rows
// is shared by the batch); inv_err2 [B, nchan]; shifts, taus [n, nchan] and
// out [n, nchan, 9] are indexed by the compact row i < n, whose source subint
// is lanes[i] (or i when lanes is null).  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int pp_moments_scat(const void* cross, const void* abs_m2, int64_t m_bstride,
                               const void* shifts, const void* taus, const void* inv_err2,
                               const void* lanes, int64_t n, int nchan, int K, void* out,
                               void* stream) {
  const int64_t nrows = n * (int64_t)nchan;
  if (nrows <= 0) return 0;
  const int64_t blocks = (nrows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  moments_scat_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const double2*)cross, (const double*)abs_m2, m_bstride, (const double*)shifts,
      (const double*)taus, (const double*)inv_err2, (const int64_t*)lanes, nrows, nchan, K,
      (double*)out);
  return (int)cudaGetLastError();
}
