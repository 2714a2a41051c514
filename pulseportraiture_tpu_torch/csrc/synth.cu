// K12: the synthetic-data writer, one inverse transform a row (in shared
// memory, or cuFFT's at the widths that do not fit it).
//
// Replaces the per-subint synthesis of the JAX reference,
// pulseportraiture_tpu/pipelines/synth.py:50 make_fake_portrait and :102
// make_fake_dataset (with ops/fourier.py:237 rotate_data,
// ops/scattering.py:98 scattering_portrait_FT and pipelines/synth.py:23
// add_scintillation there): the model rotated by (-phase, -DM), scattered,
// scintillated, scaled, with white noise, weighted.  The port's torch
// version made separate passes over the whole block (cuFFT, K7, an inverse; another
// transform, the scattering product and an inverse; then one pass each for
// the scintillation, the scales, the noise and the weights).
//
// For each (subint b, channel c) row of nbin bins, from the model's
// spectrum M [nchan, nharm] (cuFFT, once a call), its shift s_bc (the
// rotation of rotate_data), the scattering spectrum T [nchan, nharm] (or
// none), the scintillation pattern p [B, nchan] (or none), the scales,
// sigma and the weights [nchan] (sigma and weights or none):
//
//   H_k = M_ck phasor(s_bc, k), its imaginary parts at k = 0 and nbin / 2
//         dropped where T follows (as irfft drops them after the rotation),
//         then times T_ck: the complex products in rounded real operations
//         (phasor.cuh, K7's);
//   x   = the inverse real FFT of H (fft_block.cuh's merge and passes, K8's
//         transforms; cuFFT's c2r on the cufft path), the imaginary parts
//         at 0 and nbin / 2 dropped;
//   out = ((x p_bc) scale_c + sigma_c n) w_c, each product and sum rounded
//         in pipelines/synth.py's order, in place over n: the noise the
//         caller drew into the output with its generator beforehand, so
//         the draws are the plain version's bit for bit.  The kernel draws
//         nothing itself.
//
// What bounds it on an H100: bytes.  It reads the noise and writes the
// output, 16 B a bin: 2 x 8.39 GB at [1000, 512, 2048], >= 5.0 ms at
// 3.35 TB/s.  M and T (8.4 MB each at 512 x 1025) stay in L2.  The FP64
// work, a sincos a harmonic and the transform's ~5 nbin log2 nbin / 2
// operations, is ~2 ms there.
//
// Design, two paths (_kernels.synth_path picks one from nbin).  "onchip",
// nbin a power of two from 64 to 8192: one block of 256 threads a row.  A
// thread forms harmonics k and n - k together (n = nbin / 2) and merges
// them into points k and n - k of the half-size sequence in shared memory
// (two buffers of n complex doubles: 128 KB at 8192 bins, the widest), the
// passes run in place between the two buffers, and each thread writes two
// neighbouring bins a point with one 16-byte load of the noise and one
// store.  "cufft", every other width: synth_harmonics_kernel writes H of
// every row to device memory (a thread a harmonic), cuFFT's c2r inverse
// (torch.fft.irfft) takes it to x, and synth_rows_staged_kernel applies the
// same epilogue to x in place over the noise (a thread a bin).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fft_block.cuh"
#include "phasor.cuh"

namespace {

constexpr int kThreads = 256;

// H_k of a row: M_k times the phasor, projected where T follows (the
// imaginary parts at k = 0 and k = nyq, nbin / 2 for an even nbin, else -1),
// times T_k
__device__ __forceinline__ double2 harmonic(const double2* __restrict__ m,
                                            const double2* __restrict__ t, double s, int k,
                                            int nyq, double two_pi) {
  double2 h = rotated(__ldg(m + k), s, k, two_pi);
  if (t != nullptr) {
    if (k == 0 || k == nyq) h.y = 0.0;
    const double2 v = __ldg(t + k);
    h = make_double2(__dsub_rn(__dmul_rn(h.x, v.x), __dmul_rn(h.y, v.y)),
                     __dadd_rn(__dmul_rn(h.x, v.y), __dmul_rn(h.y, v.x)));
  }
  return h;
}

// the epilogue of a row's bin: ((x p) scale + sigma n) w, each product and
// sum rounded; a null pattern, sigma or weights stands for none (n is then
// unread where sigma is null)
__device__ __forceinline__ double finish(double x, const double* __restrict__ pattern, double pc,
                                         double sc, const double* __restrict__ sigma, double sg,
                                         double e, const double* __restrict__ weights, double wc) {
  if (pattern != nullptr) x = __dmul_rn(x, pc);
  x = __dmul_rn(x, sc);
  if (sigma != nullptr) x = __dadd_rn(x, __dmul_rn(sg, e));
  if (weights != nullptr) x = __dmul_rn(x, wc);
  return x;
}

__global__ void __launch_bounds__(kThreads)
synth_rows_onchip_kernel(const double2* __restrict__ M, const double* __restrict__ shifts,
                         const double2* __restrict__ T, const double* __restrict__ pattern,
                         const double* __restrict__ scales, const double* __restrict__ sigma,
                         const double* __restrict__ weights, const double2* __restrict__ tw,
                         int nchan, int nbin, double two_pi, double* __restrict__ out) {
  extern __shared__ double2 buf[];
  const int n = nbin / 2;
  double2* a = buf;
  double2* b = buf + n;
  const int64_t row = blockIdx.x;
  const int c = (int)(row % nchan);
  const double s = shifts[row];
  const double2* m = M + (int64_t)c * (n + 1);
  const double2* t = T == nullptr ? nullptr : T + (int64_t)c * (n + 1);
  const double inv = 1.0 / nbin;
  for (int k = threadIdx.x; k <= n / 2; k += kThreads) {
    const int j = n - k;
    const double2 hk = harmonic(m, t, s, k, n, two_pi);
    const double2 hj = harmonic(m, t, s, j, n, two_pi);
    a[k] = merge_w(hk, hj, k, inv, __ldg(tw + k));
    if (j != k && j < n) a[j] = merge_w(hj, hk, j, inv, __ldg(tw + j));
  }
  __syncthreads();
  // the inverse FFT of the conjugated points merge_w wrote is the conjugate
  // of their forward FFT: K8's forward passes
  const double2* z = fft_block<kThreads>(a, b, n, nbin, tw);
  const double pc = pattern == nullptr ? 1.0 : pattern[row];
  const double sc = scales[c], sg = sigma == nullptr ? 0.0 : sigma[c];
  const double wc = weights == nullptr ? 1.0 : weights[c];
  double2* o = (double2*)(out + row * (int64_t)nbin);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const double2 e = sigma == nullptr ? make_double2(0.0, 0.0) : o[j];
    o[j] = make_double2(finish(z[j].x, pattern, pc, sc, sigma, sg, e.x, weights, wc),
                        finish(-z[j].y, pattern, pc, sc, sigma, sg, e.y, weights, wc));
  }
}

// the cufft path's first kernel: H [rows, nharm] of every row, a thread a
// harmonic
__global__ void __launch_bounds__(kThreads)
synth_harmonics_kernel(const double2* __restrict__ M, const double* __restrict__ shifts,
                       const double2* __restrict__ T, int64_t total, int nchan, int nharm,
                       int nyq, double two_pi, double2* __restrict__ H) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t row = i / nharm;
    const int k = (int)(i - row * nharm);
    const int64_t c = row % nchan;
    H[i] = harmonic(M + c * nharm, T == nullptr ? nullptr : T + c * nharm, shifts[row], k, nyq,
                    two_pi);
  }
}

// the cufft path's epilogue: out = finish(x) in place over the noise, a
// thread a bin
__global__ void __launch_bounds__(kThreads)
synth_rows_staged_kernel(const double* __restrict__ x, const double* __restrict__ pattern,
                         const double* __restrict__ scales, const double* __restrict__ sigma,
                         const double* __restrict__ weights, int64_t total, int nchan, int nbin,
                         double* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t row = i / nbin;
    const int c = (int)(row % nchan);
    out[i] = finish(x[i], pattern, pattern == nullptr ? 1.0 : pattern[row], scales[c], sigma,
                    sigma == nullptr ? 0.0 : sigma[c], sigma == nullptr ? 0.0 : out[i], weights,
                    weights == nullptr ? 1.0 : weights[c]);
  }
}

// blocks of a grid-stride launch over `total` items
unsigned stride_blocks(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return (unsigned)(want < 132 * 64 ? want : 132 * 64);
}

}  // namespace

// M [nchan, nbin / 2 + 1] complex128 (interleaved f64) the model's rFFT;
// shifts [rows] f64 [rot] (row = subint * nchan + channel); T [nchan,
// nbin / 2 + 1] complex128 or null; pattern [rows] f64 or null; scales
// [nchan] f64; sigma [nchan] f64 or null (then out is only written);
// weights [nchan] f64 or null; tw ops.wavelet.scan_twiddles(nbin); out
// [rows, nbin] f64 holding the noise where sigma is given; two_pi = 2 pi
// sign.  The onchip path: nbin a power of two from 64 to 8192.  Launches on
// `stream`; returns the cudaError_t of the launch.
extern "C" int pp_synth_rows(const void* M, const void* shifts, const void* T,
                             const void* pattern, const void* scales, const void* sigma,
                             const void* weights, const void* tw, int64_t rows, int nchan,
                             int nbin, double two_pi, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (nbin < 64 || nbin > 8192 || (nbin & (nbin - 1)) || nchan < 1 || rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nbin * sizeof(double2);  // two buffers of nbin / 2
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        synth_rows_onchip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  synth_rows_onchip_kernel<<<(unsigned)rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const double2*)M, (const double*)shifts, (const double2*)T, (const double*)pattern,
      (const double*)scales, (const double*)sigma, (const double*)weights,
      (const double2*)tw, nchan, nbin, two_pi, (double*)out);
  return (int)cudaGetLastError();
}

// The cufft path.  pp_synth_harmonics: H [rows, nbin / 2 + 1] complex128
// of M, shifts and T (or null) as above, any nbin >= 1.  pp_synth_finish:
// out [rows, nbin] f64 from x [rows, nbin] f64 (cuFFT's inverse of H) and
// pattern, scales, sigma and weights as above, in place over the noise
// where sigma is given.  Each launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int pp_synth_harmonics(const void* M, const void* shifts, const void* T, int64_t rows,
                                  int nchan, int nbin, double two_pi, void* H, void* stream) {
  if (rows <= 0) return 0;
  if (nbin < 1 || nchan < 1) return (int)cudaErrorInvalidValue;
  const int nharm = nbin / 2 + 1;
  const int64_t total = rows * nharm;
  synth_harmonics_kernel<<<stride_blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const double2*)M, (const double*)shifts, (const double2*)T, total, nchan, nharm,
      nbin % 2 == 0 ? nbin / 2 : -1, two_pi, (double2*)H);
  return (int)cudaGetLastError();
}

extern "C" int pp_synth_finish(const void* x, const void* pattern, const void* scales,
                               const void* sigma, const void* weights, int64_t rows, int nchan,
                               int nbin, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (nbin < 1 || nchan < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = rows * nbin;
  synth_rows_staged_kernel<<<stride_blocks(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)x, (const double*)pattern, (const double*)scales, (const double*)sigma,
      (const double*)weights, total, nchan, nbin, (double*)out);
  return (int)cudaGetLastError();
}
