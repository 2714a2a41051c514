// K5: the archive's decode and baseline removal, one pass per profile.
//
// Replaces the load's first two passes over the cube in the JAX reference:
// the DATA column's expansion, pulseportraiture_tpu/io/psrfits.py:451-458
// (raw int16 times DAT_SCL plus DAT_OFFS, in float64 on the host), and
// Archive.remove_baseline, :248 there (each profile less the least mean
// over the nbin circular windows of nwin = max(1, int(0.125 nbin)) bins,
// taken on the host as an rFFT convolution with a boxcar).
//
// For each (subint, pol, channel) row of nbin bins:
//
//   decode     x_b = raw_b * scl + offs, the product and then the sum
//              rounded, no fused multiply-add: numpy's arithmetic, bit for
//              bit (scl and offs are the file's float32 values in float64,
//              exactly);
//   baseline   out_b = x_b - (ref + min_j S_j / nwin), where ref = x_0 and
//              S_j = sum_{i<nwin} (x_{(j+i) mod nbin} - ref) is the window
//              sum of the row less its reference, from a prefix sum P:
//              S_j = P_{j+nwin} - P_j, wrapped as (P_nbin - P_j) +
//              P_{j+nwin-nbin}.
//
// Error of the window sums.  The reference is taken off before the prefix
// sum, so every term is bounded by the row's spread R = max x - min x and
// not by DAT_OFFS.  A prefix is a carry over nbin / 256 tiles plus a scan
// of depth 8 inside a tile, so |P_j - exact| <= (nbin / 256 + 8) eps nbin R
// roughly; S_j's error is at most twice that, and the window mean's
// (divided by nwin = nbin / 8) at most 16 (nbin / 256 + 8) eps R: 2.8e-14
// R at nbin 2048.  The plain version's FFT convolution errs by about
// log2(nbin) eps max |x|, offset included.
//
// One kernel, two C entry points, three modes: pp_unpack decodes;
// pp_unpack with nwin > 0 also removes the baseline in the same launch
// (the load's main path: nothing lies between the two); pp_baseline
// removes the baseline of float64 rows (after a state conversion or a
// rotation).
//
// What bounds it on an H100: bytes.  At the pptoas archive's 65,536 rows
// of 2048 bins a decode with its baseline reads 0.27 GB of int16 and
// writes 1.07 GB of float64: >= 0.40 ms at 3.35 TB/s.  The window sums
// cost ~4 FP64 operations a bin.
//
// Design: one block of 256 threads per row, grid-striding over rows.  The
// row and its prefix sums (2 nbin + 1 doubles, 32 KB at nbin 2048) live in
// shared memory; loads and stores are coalesced (neighbouring threads,
// neighbouring bins).  The prefix sum runs in tiles of 256 bins: a shuffle
// scan in each warp, the eight warp totals scanned by one warp, a carry
// from tile to tile.  Rows longer than shared memory holds (nbin above
// kMaxSharedBins) keep the same arrays in a global scratch buffer, one
// slice per block: no nbin is refused.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the longest row whose arrays (2 nbin + 1 doubles) fit the shared memory
// a block may ask for (227 KB); above it the arrays live in scratch
constexpr int kMaxSharedBins = 14000;

struct UnpackArgs {
  const int16_t* raw;  // [rows, nbin] or null (baseline of x_in)
  const double* scl;   // [rows]
  const double* offs;  // [rows]
  const double* x_in;  // [rows, nbin] when raw is null
  double* out;         // [rows, nbin] (may be x_in)
  double* scratch;     // [gridDim.x, 2 nbin + 1] when the row is long
  int64_t rows;
  int nbin;
  int nwin;            // 0: no baseline
};

// Inclusive scan of one value per thread over the block; `tot` (kWarps
// doubles of shared memory) ends holding the warp totals' scan, so
// tot[kWarps - 1] is the block's total.  Ends with the block in step.
__device__ __forceinline__ double block_scan(double v, double* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = __dadd_rn(v, n);
  }
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double t = lane < kWarps ? tot[lane] : 0.0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t = __dadd_rn(t, n);
    }
    if (lane < kWarps) tot[lane] = t;
  }
  __syncthreads();
  return warp > 0 ? __dadd_rn(v, tot[warp - 1]) : v;
}

// The block's least value, NaN if any thread holds a NaN; every thread
// gets it.  `red` is kWarps + 1 doubles of shared memory.
__device__ __forceinline__ double block_min(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double n = __shfl_xor_sync(0xffffffffu, v, o);
    v = (isnan(n) || n < v) ? n : v;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double m = red[0];
    for (int w = 1; w < kWarps; ++w) m = (isnan(red[w]) || red[w] < m) ? red[w] : m;
    red[kWarps] = m;
  }
  __syncthreads();
  return red[kWarps];
}

// The rows of one launch; smem the dynamic shared memory (2 nbin + 1
// doubles when the row fits), tot kWarps + 1 doubles of shared memory.
__device__ __forceinline__ void unpack_rows(const UnpackArgs& a, double* smem, double* tot) {
  const int nbin = a.nbin;
  const bool in_shared = nbin <= kMaxSharedBins;
  double* xs = in_shared ? smem : a.scratch + (int64_t)blockIdx.x * (2 * (int64_t)nbin + 1);
  double* ps = xs + nbin;  // P_0 .. P_nbin
  for (int64_t row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const int64_t base = row * (int64_t)nbin;
    if (a.raw != nullptr) {
      const double s = a.scl[row], o = a.offs[row];
      for (int i = threadIdx.x; i < nbin; i += kThreads) {
        const double x = __dadd_rn(__dmul_rn((double)a.raw[base + i], s), o);
        if (a.nwin > 0) xs[i] = x; else a.out[base + i] = x;
      }
    } else {
      for (int i = threadIdx.x; i < nbin; i += kThreads) xs[i] = a.x_in[base + i];
    }
    if (a.nwin <= 0) continue;  // decode only: written above
    __syncthreads();
    const double ref = xs[0];
    double carry = 0.0;
    for (int t0 = 0; t0 < nbin; t0 += kThreads) {
      const int i = t0 + threadIdx.x;
      const double y = i < nbin ? __dsub_rn(xs[i], ref) : 0.0;
      const double incl = block_scan(y, tot);
      if (i < nbin) ps[i + 1] = __dadd_rn(carry, incl);
      carry = __dadd_rn(carry, tot[kWarps - 1]);
      __syncthreads();  // tot is rewritten by the next tile's scan
    }
    if (threadIdx.x == 0) ps[0] = 0.0;
    __syncthreads();
    double mn = INFINITY;
    for (int j = threadIdx.x; j < nbin; j += kThreads) {
      const int e = j + a.nwin;
      const double s = e <= nbin ? __dsub_rn(ps[e], ps[j])
                                 : __dadd_rn(__dsub_rn(ps[nbin], ps[j]), ps[e - nbin]);
      mn = (isnan(s) || s < mn) ? s : mn;
    }
    mn = block_min(mn, tot);
    const double level = __dadd_rn(ref, __ddiv_rn(mn, (double)a.nwin));
    for (int i = threadIdx.x; i < nbin; i += kThreads)
      a.out[base + i] = __dsub_rn(xs[i], level);
    __syncthreads();  // xs, ps and tot are the next row's
  }
}

// the decode (with the baseline when nwin > 0): pp_unpack
__global__ void __launch_bounds__(kThreads) unpack_kernel(UnpackArgs a) {
  extern __shared__ double smem[];
  __shared__ double tot[kWarps + 1];
  unpack_rows(a, smem, tot);
}

// the baseline of float64 rows: pp_baseline
__global__ void __launch_bounds__(kThreads) baseline_kernel(UnpackArgs a) {
  extern __shared__ double smem[];
  __shared__ double tot[kWarps + 1];
  unpack_rows(a, smem, tot);
}

size_t smem_bytes(int nbin) {
  return nbin <= kMaxSharedBins ? (2 * (size_t)nbin + 1) * sizeof(double) : 0;
}

int launch(void (*kernel)(UnpackArgs), const UnpackArgs& a, unsigned grid,
           cudaStream_t stream) {
  const size_t smem = a.nwin > 0 ? smem_bytes(a.nbin) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// one block a row, at most 2^20 blocks (grid-striding past them)
unsigned grid_for(int64_t rows) {
  return (unsigned)(rows < (int64_t)1 << 20 ? rows : (int64_t)1 << 20);
}

}  // namespace

// raw [rows, nbin] int16, scl and offs [rows] f64, out [rows, nbin] f64;
// nwin > 0 also removes the baseline (windows of nwin bins).  scratch:
// blocks * (2 nbin + 1) doubles when nbin > kMaxSharedBins, else null, and
// then `blocks` is the grid.  Returns the cudaError_t of the launch.
extern "C" int pp_unpack(const void* raw, const void* scl, const void* offs, int64_t rows,
                         int nbin, int nwin, void* out, void* scratch, int blocks,
                         void* stream) {
  if (rows <= 0 || nbin <= 0) return 0;
  const UnpackArgs a{(const int16_t*)raw, (const double*)scl, (const double*)offs,
                     nullptr, (double*)out, (double*)scratch, rows, nbin, nwin};
  const unsigned grid = (nwin > 0 && nbin > kMaxSharedBins) ? (unsigned)blocks
                                                            : grid_for(rows);
  return launch(unpack_kernel, a, grid, (cudaStream_t)stream);
}

// x [rows, nbin] f64 less each row's baseline (windows of nwin >= 1 bins)
// into out (x itself allowed); scratch and blocks as pp_unpack's.
extern "C" int pp_baseline(const void* x, int64_t rows, int nbin, int nwin, void* out,
                           void* scratch, int blocks, void* stream) {
  if (rows <= 0 || nbin <= 0) return 0;
  const UnpackArgs a{nullptr, nullptr, nullptr, (const double*)x, (double*)out,
                     (double*)scratch, rows, nbin, nwin < 1 ? 1 : nwin};
  const unsigned grid = nbin > kMaxSharedBins ? (unsigned)blocks : grid_for(rows);
  return launch(baseline_kernel, a, grid, (cudaStream_t)stream);
}
