// K1: the scattering-free fit's per-(subint, channel) harmonic sums, and
// from them the row's objective, gradient and Hessian terms.
//
// Replaces the scattering-free branch of the JAX reference's
// pulseportraiture_tpu/fit/portrait.py:118 _moments (:159-189) AND the
// per-channel algebra of :339 portrait_grad_hess (:339-373, with dS = d2S
// = 0), which XLA fuses into one program there and every Newton iteration
// of a (phi, DM) or (phi, DM, GM) fit evaluates.  For every row one
// harmonic loop forms three sums, each times inv_err2:
//
//   C  =  sum_k Re(z_k)
//   T1 = -sum_k 2 pi k Im(z_k)
//   T2 = -sum_k (2 pi k)^2 Re(z_k)
//
// with z_k = cross_k * exp(2 pi i frac_k), frac_k = s*k - floor(s*k): the
// phase shift s of the row times the harmonic index, reduced mod 1 in f64
// with floor (the reference's floor-mod, never fmod) before the trig.  Two
// epilogues share that loop:
//
//   A  pp_moments     writes the three sums [n, nchan, 3];
//   B  pp_moments_gh  forms, in registers, the per-channel terms of
//      portrait_grad_hess from the sums, the row's S and its d shift /
//      d(phi, DM, GM) pd[3], in the order of operations of
//      _kernels.moments_grad_hess_plain: ok = S > 0, f = -C^2/S, g_p =
//      -2 C dC_p / S with dC_p = T1 pd_p, H_pr = -2 (C^2/S) (d2C_pr / C +
//      dC_p dC_r / C^2) with d2C_pr = T2 pd_p pd_r, zero where not ok,
//      each division exact; writing [n, 10, nchan] (f, g[3], the 3x3
//      Hessian's upper triangle), channels last so that the channel sum
//      after it runs along the contiguous axis.  That sum is the fit's
//      (f, g, H): no [n, 3, 3, nchan] temporary and no torch pass stands
//      between the harmonic loop and it.
//
// What bounds it on an H100: bytes.  One launch reads the truncated
// cross-spectrum once (N x nchan x K complex128 = 1.05 GB at N=1000,
// nchan=512, K=128: >= 0.31 ms at 3.35 TB/s); its FP64 work per harmonic
// (a sincospi, the complex product, three accumulations) is 21 DFMA, 9
// DMUL and 3 DADD in the SASS (54 FLOP: 0.10 ms at 34 TFLOP/s).  At a few
// hundred rows the launch and the memory's latency set the time.
//
// Design:
// * Sixteen lanes per row, two rows per warp.  Lane q of a row takes the
//   harmonics q + 16j and sums them in order of j; a four-level
//   xor-shuffle tree joins the sixteen partial sums, so every lane holds
//   the row's sums.  K not a multiple of 16, K < 16 and one channel per
//   subint are masked lanes.
// * Loads issued ahead of the arithmetic: each lane keeps the next
//   kChunk harmonics' cross values in flight (a register double buffer)
//   while it works on the current ones.
// * Blocks of one warp (two rows), whatever the row count: 256 blocks
//   for the 512 rows of one subint, so a single subint still spreads
//   over all 132 SMs, and as many resident warps as the 71 (A) and 79
//   (B) registers a thread allow at a large batch (blocks of 2 and 4
//   warps timed the same as one and blocks of 8 up to 11% slower, on an
//   NVIDIA H100 80GB HBM3 at 700 W).  One geometry also keeps each row's
//   order of sums the same at every batch size, which the sharded fit's
//   bit-equality with the unsharded one needs.
// * Epilogue B runs on ten of a row's sixteen lanes, one column each
//   (the lanes already hold the sums): no shared memory, one path for
//   every column and three divisions a lane (grad_hess_column).
// No [N, nchan, K] temporary reaches device memory.  An optional lane
// list lets the batched solver evaluate only its still-active subints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerRow = 16;
constexpr int kThreads = 32;  // one warp a block
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;
// 24 resident blocks (768 threads) an SM: a register cap of 85 a
// thread, above the 71 and 79 the kernels take, so it forces no spill
constexpr int kMinBlocks = 24;
constexpr int kChunk = 4;  // harmonics per lane whose loads go out together
constexpr int kGradHess = 10;
constexpr double kTwoPi = 6.283185307179586;  // 2.0 * pi, as in the reference

struct MomArgs {
  const double2* cross;     // [B, nchan, K]
  const double* shifts;     // [n, nchan]
  const double* inv_err2;   // [B, nchan]
  const int64_t* lanes;     // [n] or null
  int64_t nrows;            // n * nchan
  int nchan;
  int K;
};

// One harmonic's contribution to the three sums: the element arithmetic
// of moments_plain (the reference's order of operations).
__device__ __forceinline__ void add_harmonic(double2 v, double s, double kd,
                                             double (&acc)[3]) {
  const double sk = __dmul_rn(s, kd);  // the reference's fl(s k), never fused
  double sn, cs;
  sincospi(2.0 * (sk - floor(sk)), &sn, &cs);
  const double re = v.x * cs - v.y * sn;
  const double im = v.x * sn + v.y * cs;
  const double tpk = kTwoPi * kd;
  acc[0] += re;
  acc[1] += tpk * im;
  acc[2] += (tpk * tpk) * re;
}

// The harmonic loop of one row, lane q of its sixteen: harmonics q + 16j,
// in order of j, the next chunk's loads in flight during this chunk's
// arithmetic.
__device__ __forceinline__ void harmonic_loop(const double2* __restrict__ x, double s, int q,
                                              int K, double (&acc)[3]) {
  const int J = (K - q + kLanesPerRow - 1) / kLanesPerRow;  // this lane's harmonics
  double2 v[kChunk], vn[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int k = q + kLanesPerRow * u;
    v[u] = k < K ? __ldg(x + k) : make_double2(0.0, 0.0);
  }
  for (int j0 = 0; j0 < J; j0 += kChunk) {
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = q + kLanesPerRow * (j0 + kChunk + u);
      vn[u] = k < K ? __ldg(x + k) : make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int j = j0 + u;
      if (j < J) add_harmonic(v[u], s, (double)(q + kLanesPerRow * j), acc);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) v[u] = vn[u];
  }
}

// A thread's row and the row's source in the batch.
struct Row {
  int64_t row, i, c, src;
  bool live;
};

__device__ __forceinline__ Row row_of(const MomArgs& a) {
  Row r;
  r.row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  r.live = r.row < a.nrows;
  r.i = r.live ? r.row / a.nchan : 0;
  r.c = r.live ? r.row - r.i * a.nchan : 0;
  r.src = (a.lanes && r.live ? a.lanes[r.i] : r.i) * a.nchan + r.c;
  return r;
}

// The row's three sums reduced over its sixteen lanes (every lane of the
// warp takes part in the shuffles, and every lane of a row ends with the
// same bits), times inv_err2 with the reference's signs.  inv_err2 is
// loaded before the harmonic loop, so no warp ends on a dependent load.
__device__ __forceinline__ void row_sums(const MomArgs& a, const Row& r, double (&sums)[3]) {
  const int q = threadIdx.x & (kLanesPerRow - 1);
  double acc[3] = {0.0, 0.0, 0.0};
  double w = 0.0;
  if (r.live) {
    w = a.inv_err2[r.src];
    harmonic_loop(a.cross + r.src * (int64_t)a.K, a.shifts[r.row], q, a.K, acc);
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) {
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
  }
  sums[0] = acc[0] * w;   // C
  sums[1] = -acc[1] * w;  // T1
  sums[2] = -acc[2] * w;  // T2
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
moments_kernel(MomArgs a, double* __restrict__ out) {
  const Row r = row_of(a);
  double s[3];
  row_sums(a, r, s);
  const int q = threadIdx.x & (kLanesPerRow - 1);
  if (r.live && q < 3) out[r.row * 3 + q] = q == 0 ? s[0] : (q == 1 ? s[1] : s[2]);
}

// -- epilogue B ---------------------------------------------------------------

// Column t of a row (moments_grad_hess_plain's order of operations): f
// (t = 0), g_p (t = 1 + p), H_pr for (p, r) the t-4'th of (0,0), (0,1),
// (0,2), (1,1), (1,2), (2,2).  Every column is a * (x / d + y / e) with
// its own factors (f = -1 * (C^2/S + 0/1), g_p = -1 * (2 C dC_p / S +
// 0/1), H_pr = lead * (d2C_pr / C + dC_p dC_r / C^2); x + 0 = x and -1 * x
// = -x exactly), so the lanes of a warp take one path: two divisions
// each and the lead's one, not the five of three divergent branches.
__device__ __forceinline__ double grad_hess_column(int t, double C0, double T1, double T2,
                                                   double S0, const double (&pd)[3]) {
  const bool ok = S0 > 0.0;
  const double S = ok ? S0 : 1.0;
  const double C = ok ? C0 : 0.0;
  const double safe_C = C != 0.0 ? C : 1.0;
  const int p = t < 4 ? (t == 0 ? 0 : t - 1) : (t < 7 ? 0 : (t < 9 ? 1 : 2));
  const int r = t < 7 ? (t < 4 ? p : t - 4) : (t < 9 ? t - 6 : 2);
  const double pp = p == 0 ? pd[0] : (p == 1 ? pd[1] : pd[2]);
  const double pr = r == 0 ? pd[0] : (r == 1 ? pd[1] : pd[2]);
  const double dCp = T1 * pp, dCr = T1 * pr;
  const double lead = -2.0 * (C * C / S);
  double a, x, d, y, e;
  if (t == 0) {
    a = -1.0, x = C * C, d = S, y = 0.0, e = 1.0;
  } else if (t < 4) {
    a = -1.0, x = 2.0 * C * dCp, d = S, y = 0.0, e = 1.0;
  } else {
    a = lead, x = T2 * pp * pr, d = safe_C, y = dCp * dCr, e = safe_C * safe_C;
  }
  return ok ? a * (x / d + y / e) : 0.0;
}

// The harmonic loop as moments_kernel, the row's S and pd loaded before
// it; then lanes 0..9 of each row form and write one column each.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
moments_grad_hess_kernel(MomArgs a, const double* __restrict__ pd,
                         const double* __restrict__ S, double* __restrict__ out) {
  const Row r = row_of(a);
  const int q = threadIdx.x & (kLanesPerRow - 1);
  double pdv[3] = {0.0, 0.0, 0.0}, Sv = 0.0;
  if (r.live && q < kGradHess) {
    const double* pdr = pd + r.i * 3 * (int64_t)a.nchan + r.c;
    pdv[0] = pdr[0];
    pdv[1] = pdr[a.nchan];
    pdv[2] = pdr[2 * (int64_t)a.nchan];
    Sv = S[r.src];
  }
  double s[3];
  row_sums(a, r, s);
  if (!r.live || q >= kGradHess) return;
  out[(r.i * kGradHess + q) * (int64_t)a.nchan + r.c] =
      grad_hess_column(q, s[0], s[1], s[2], Sv, pdv);
}

// An empty kernel with K1's launch geometry: the launch floor K1 is
// measured against.
__global__ void moments_floor_kernel() {}

unsigned blocks_for(int64_t nrows) {
  return (unsigned)((nrows + kRowsPerBlock - 1) / kRowsPerBlock);
}

MomArgs mom_args(const void* cross, const void* shifts, const void* inv_err2,
                 const void* lanes, int64_t n, int nchan, int K) {
  return MomArgs{(const double2*)cross, (const double*)shifts, (const double*)inv_err2,
                 (const int64_t*)lanes, n * (int64_t)nchan, nchan, K};
}

}  // namespace

// cross [B, nchan, K] complex128 (interleaved f64), inv_err2 [B, nchan];
// shifts [n, nchan] and out [n, nchan, 3] are indexed by the compact row
// i < n, whose source subint is lanes[i] (or i when lanes is null).
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int pp_moments(const void* cross, const void* shifts, const void* inv_err2,
                          const void* lanes, int64_t n, int nchan, int K, void* out,
                          void* stream) {
  const MomArgs a = mom_args(cross, shifts, inv_err2, lanes, n, nchan, K);
  if (a.nrows <= 0) return 0;
  moments_kernel<<<blocks_for(a.nrows), kThreads, 0, (cudaStream_t)stream>>>(
      a, (double*)out);
  return (int)cudaGetLastError();
}

// As pp_moments, with out [n, 10, nchan] (f, g[3], the Hessian's upper
// triangle row by row), pd [n, 3, nchan] the rows' d shift / d(phi, DM,
// GM) and S [B, nchan] indexed as inv_err2.
extern "C" int pp_moments_gh(const void* cross, const void* shifts, const void* inv_err2,
                             const void* lanes, const void* pd, const void* S, int64_t n,
                             int nchan, int K, void* out, void* stream) {
  const MomArgs a = mom_args(cross, shifts, inv_err2, lanes, n, nchan, K);
  if (a.nrows <= 0) return 0;
  moments_grad_hess_kernel<<<blocks_for(a.nrows), kThreads, 0, (cudaStream_t)stream>>>(
      a, (const double*)pd, (const double*)S, (double*)out);
  return (int)cudaGetLastError();
}

// The empty kernel at pp_moments' geometry for n x nchan rows.
extern "C" int pp_moments_floor(int64_t n, int nchan, void* stream) {
  const int64_t nrows = n * (int64_t)nchan;
  if (nrows <= 0) return 0;
  moments_floor_kernel<<<blocks_for(nrows), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
