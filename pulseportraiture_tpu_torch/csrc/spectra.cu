// K4: the fit's spectra set-up, the one pass over cuFFT's output.
//
// Replaces the consumers of the rFFT in the JAX reference's complex128
// path, pulseportraiture_tpu/fit/portrait.py:915-924 (harmonic 0 of data
// and model times F0_fact; Sd = sum |dFFT|^2 inv_err2 over every harmonic;
// the truncation to kmax; cross = dFFT conj(mFFT) and |mFFT|^2), and,
// where the fit measures its own noise, pulseportraiture_tpu/ops/noise.py:39
// get_noise_PS (frac 4) and the 1 / sigma_FT^2 weights built from it
// (:833, :1269 there).  XLA fuses those consumers into the FFT's program on
// the TPU; in eager PyTorch each was a full pass over the [rows, nharm]
// complex128 spectra (abs, square, times the weights, the sum, the slice
// product) and the noise estimate took a second rFFT of the whole cube.
// The rFFT itself stays with cuFFT (torch.fft.rfft): its callbacks are not
// reachable from PyTorch, so this kernel is a second pass that reads its
// output once.
//
// For every (subint, channel) row, over the row's nharm = nbin/2 + 1
// harmonics d_k (and the row's model m_k, shared by the batch or its
// own), with d_0 and m_0 times F0_fact (the unscaled d_0 for the noise):
//
//   cross_k = d_k conj(m_k)                 k < kmax   [rows, kmax]
//   |m_k|^2                                  k < kmax   (when asked)
//   sd      = inv_err2 * sum_k |d_k|^2       all k      [rows]
//
// with |d|^2 = re*re + im*im (the reference's real(x conj(x))), |m|^2 =
// sqrt(re*re + im*im)^2 (its abs(m) ** 2) and the complex product in real
// operations, each product and sum rounded, no
// fused multiply-add: the element arithmetic of _kernels.spectra_plain
// bit for bit, so the kernel and its plain version differ only in the
// order of the sums.  Two epilogues share that loop:
//
//   A  pp_spectra        inv_err2 given per row;
//   B  pp_spectra_noise  also sums |d_k|^2 over k >= kc = int(0.75 nharm)
//      of the unscaled spectrum and writes noise = sqrt((sum / nbin) /
//      (nharm - kc)) (get_noise_PS), inv_err2 = (noise sqrt(nbin/2))^-2
//      where the row's weight is > 0, else 0, and sd with that inv_err2.
//
// What bounds it on an H100: bytes.  A launch reads the rows' spectra once
// (64 x 512 x 1025 complex128 = 537 MB for a chunk of 64 subints of 512
// channels at nbin 2048) and writes the truncated cross once (67 MB at
// kmax 128): >= 0.180 ms at 3.35 TB/s, against ~3 FP64 operations a
// harmonic (and ~6 more below kmax).
//
// Design:
// * One warp per row, four rows per block.  Lane q takes the harmonics
//   q + 32j, four at a time (four 16-byte loads in flight a lane,
//   neighbouring lanes on neighbouring harmonics), and sums them in order
//   of j; a five-level xor-shuffle tree joins the 32 partial sums.  The
//   order depends on nothing but the row: not on the chunk, the row count
//   or a mesh's shard, so a chunked or sharded fit sees the same bits.
// * The model's kmax harmonics of a row are read only below kmax (a
//   shared model stays in L2); the cross and |m|^2 stores are coalesced.
// * Any kmax <= nharm, odd nbin, one channel a subint and rows shorter
//   than a warp are masked lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kRowsPerBlock = 4;
constexpr int kThreads = kLanes * kRowsPerBlock;
constexpr int kUnroll = 4;  // harmonics a lane loads together

struct SpecArgs {
  const double2* dfft;   // [nrows, nharm]
  const double2* mfft;   // [nchan, nharm] shared, or [nrows, nharm]
  int m_per_row;         // 1: the row's own model; 0: shared over subints
  int64_t nrows;         // r * nchan
  int nchan;
  int nharm;
  int kmax;
  double f0;             // F0_fact, applied to harmonic 0
  double2* cross;        // [nrows, kmax]
  double* sd;            // [nrows]
  double* absm2;         // [nrows, kmax] or null
};

// |x|^2 as the reference's real(x conj(x)): two rounded products, one sum.
__device__ __forceinline__ double power(double2 v) {
  return __dadd_rn(__dmul_rn(v.x, v.x), __dmul_rn(v.y, v.y));
}

// The harmonic loop of row `row`, lane q: writes cross (and |m|^2) below
// kmax, and returns the lane's partial sums of |d_k|^2 (d_0 scaled) in
// acc[0] and, for the noise, of the unscaled |d_k|^2 over k >= kc in
// acc[1] (kc = nharm: none).
__device__ __forceinline__ void row_loop(const SpecArgs& a, int64_t row, int q, int kc,
                                         double (&acc)[2]) {
  const double2* d = a.dfft + row * (int64_t)a.nharm;
  const int64_t mrow = a.m_per_row ? row : row % a.nchan;
  const double2* m = a.mfft + mrow * (int64_t)a.nharm;
  double2* x = a.cross + row * (int64_t)a.kmax;
  double* am = a.absm2 ? a.absm2 + row * (int64_t)a.kmax : nullptr;
  for (int k0 = 0; k0 < a.nharm; k0 += kLanes * kUnroll) {
    double2 v[kUnroll], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + q + kLanes * u;
      v[u] = k < a.nharm ? __ldg(d + k) : make_double2(0.0, 0.0);
      w[u] = k < a.kmax ? __ldg(m + k) : make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + q + kLanes * u;
      if (k >= a.nharm) continue;
      const double p = power(v[u]);
      if (k >= kc) acc[1] += p;
      if (k == 0) {
        v[u] = make_double2(v[u].x * a.f0, v[u].y * a.f0);
        w[u] = make_double2(w[u].x * a.f0, w[u].y * a.f0);
        acc[0] += power(v[u]);
      } else {
        acc[0] += p;
      }
      if (k < a.kmax) {
        // d conj(m), each product and sum rounded (no fused multiply-add)
        x[k] = make_double2(
            __dadd_rn(__dmul_rn(v[u].x, w[u].x), __dmul_rn(v[u].y, w[u].y)),
            __dsub_rn(__dmul_rn(v[u].y, w[u].x), __dmul_rn(v[u].x, w[u].y)));
        if (am) {  // the reference's abs(m) ** 2: the modulus, then its square
          const double h = __dsqrt_rn(power(w[u]));
          am[k] = __dmul_rn(h, h);
        }
      }
    }
  }
}

// Both lanes' sums joined over the warp; every lane ends with the same bits.
__device__ __forceinline__ void warp_sums(double (&acc)[2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
  }
}

__global__ void __launch_bounds__(kThreads)
spectra_kernel(SpecArgs a, const double* __restrict__ inv_err2) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  if (row >= a.nrows) return;  // a whole warp: no shuffle loses a lane
  const int q = threadIdx.x % kLanes;
  const double w = inv_err2[row];
  double acc[2] = {0.0, 0.0};
  row_loop(a, row, q, a.nharm, acc);
  warp_sums(acc);
  if (q == 0) a.sd[row] = acc[0] * w;
}

__global__ void __launch_bounds__(kThreads)
spectra_noise_kernel(SpecArgs a, const double* __restrict__ weights, int nbin, int kc,
                     double ft_scale, double* __restrict__ noise,
                     double* __restrict__ inv_err2) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanes;
  if (row >= a.nrows) return;
  const int q = threadIdx.x % kLanes;
  const double wt = weights[row];
  double acc[2] = {0.0, 0.0};
  row_loop(a, row, q, kc, acc);
  warp_sums(acc);
  if (q != 0) return;
  // get_noise_PS: the mean of |d_k|^2 / nbin over k >= kc
  const double sigma = sqrt((acc[1] / (double)nbin) / (double)(a.nharm - kc));
  const double e = sigma * ft_scale;  // sigma_FT = sigma sqrt(nbin / 2)
  const double w = wt > 0.0 ? 1.0 / (e * e) : 0.0;
  noise[row] = sigma;
  inv_err2[row] = w;
  a.sd[row] = acc[0] * w;
}

SpecArgs spec_args(const void* dfft, const void* mfft, int m_per_row, int64_t nrows,
                   int nchan, int nharm, int kmax, double f0, void* cross, void* sd,
                   void* absm2) {
  return SpecArgs{(const double2*)dfft, (const double2*)mfft, m_per_row, nrows,
                  nchan, nharm, kmax, f0, (double2*)cross, (double*)sd,
                  (double*)absm2};
}

unsigned blocks_for(int64_t nrows) {
  return (unsigned)((nrows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

// dfft [nrows, nharm] complex128 (interleaved f64), nrows = r * nchan rows
// in (subint, channel) order; mfft [nchan, nharm] (m_per_row 0) or
// [nrows, nharm] (1); inv_err2, sd [nrows] f64; cross [nrows, kmax]
// complex128; absm2 [nrows, kmax] f64 or null.  Launches on `stream`;
// returns the cudaError_t of the launch.
extern "C" int pp_spectra(const void* dfft, const void* mfft, int m_per_row,
                          const void* inv_err2, int64_t nrows, int nchan, int nharm,
                          int kmax, double f0, void* cross, void* sd, void* absm2,
                          void* stream) {
  if (nrows <= 0) return 0;
  const SpecArgs a = spec_args(dfft, mfft, m_per_row, nrows, nchan, nharm, kmax, f0,
                               cross, sd, absm2);
  spectra_kernel<<<blocks_for(nrows), kThreads, 0, (cudaStream_t)stream>>>(
      a, (const double*)inv_err2);
  return (int)cudaGetLastError();
}

// As pp_spectra, with the rows' weights [nrows] in place of inv_err2, and
// noise and inv_err2 [nrows] written: nbin the profiles' length, kc the
// first harmonic of the noise mean, ft_scale = sqrt(nbin / 2).
extern "C" int pp_spectra_noise(const void* dfft, const void* mfft, int m_per_row,
                                const void* weights, int64_t nrows, int nchan,
                                int nharm, int kmax, double f0, int nbin, int kc,
                                double ft_scale, void* cross, void* sd, void* noise,
                                void* inv_err2, void* absm2, void* stream) {
  if (nrows <= 0) return 0;
  const SpecArgs a = spec_args(dfft, mfft, m_per_row, nrows, nchan, nharm, kmax, f0,
                               cross, sd, absm2);
  spectra_noise_kernel<<<blocks_for(nrows), kThreads, 0, (cudaStream_t)stream>>>(
      a, (const double*)weights, nbin, kc, ft_scale, (double*)noise, (double*)inv_err2);
  return (int)cudaGetLastError();
}
