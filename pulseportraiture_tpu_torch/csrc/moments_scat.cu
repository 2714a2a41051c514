// K3: the scattering fit's per-(subint, channel) harmonic sums, and from
// them the row's objective, gradient and Hessian terms.
//
// Replaces the scattering branch of the JAX reference's
// pulseportraiture_tpu/fit/portrait.py:118 _moments (:191-323) AND the
// per-channel algebra of :339 portrait_grad_hess (:339-373), which XLA
// fuses into one program there and every Newton iteration of a
// scattering fit (fit_flags with tau or alpha, or a fixed nonzero tau)
// evaluates.  With the scattering kernel B_k = 1 / (1 + i x_k), x_k =
// 2 pi k tau_n, of the row's channel time tau_n, and the phasor p_k =
// exp(2 pi i frac_k), frac_k = s*k - floor(s*k) (floor-mod in f64 before
// the trig, as K1), one harmonic loop forms nine sums, each times
// inv_err2:
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
// (the harmonic reductions of the reference's real-pair branch,
// :191-268).  Two epilogues share that loop:
//
//   A  pp_moments_scat     writes the nine sums [n, nchan, 9];
//   B  pp_moments_scat_gh  applies, in registers, the (tau, alpha) chain
//      rule (d tau_n / d(tau or log10 tau, alpha) and its second
//      derivatives, ops/scattering.py:39-63), forms dC, dS [5] and d2C,
//      d2S [5, 5] as the reference's _moments does, and the per-channel
//      terms of portrait_grad_hess (the ok = S > 0 mask, -C^2/S, the
//      gradient's and the Hessian's summands, in its order of
//      operations, dividing by C and S through their reciprocals),
//      writing [n, 21, nchan]: f, g[5] and the Hessian's 15 entries on
//      and above the diagonal, channels last so that the channel sum
//      after it runs along the contiguous axis.  That sum is the fit's
//      (f, g, H): no [n, 5, 5, nchan] temporary and no torch pass stands
//      between the harmonic loop and it.
//
// What bounds it on an H100: the bytes of the truncated cross-spectrum,
// read once (N x nchan x K complex128 = 1.05 GB at N=1000, nchan=512,
// K=128: >= 0.31 ms at 3.35 TB/s).  The reference's arithmetic per
// harmonic, as the SASS (cuobjdump -sass) of a loop taking a sincospi at
// every harmonic shows it (the one-warp-per-row design before this one):
// 43 DFMA, 29 DMUL, 8 DADD (123 FLOP: 0.24 ms at 34 TFLOP/s, so bytes
// bound it), plus 3 FRND and a DSETP -- but 84 of the FP64 pipe's issue
// slots and 156-180 instructions in all, a sincospi's range reduction and
// a division's among them, so issue runs about as long as the bytes take.
//
// Design:
// * Eight lanes per row, four rows per warp.  Lane q of a row takes the
//   harmonics q + 8j, so a row's eight lanes read 128 contiguous bytes of
//   the cross-spectrum per load; the reduction is three xor-shuffle
//   levels shared by the warp's four rows (the earlier design, one warp
//   per row, took five levels per row).  K not a multiple of 8, K < 8 and
//   one channel per subint are masked lanes.
// * Loads issued ahead of the arithmetic: each lane keeps the next
//   kChunk harmonics' cross and |m|^2 values in flight (a register
//   double buffer) while it works on the current ones, and the launch
//   bounds ask for two blocks of 256 threads per SM (<= 128 registers)
//   so that enough warps are resident to cover the memory's latency.
// * A phasor recurrence that keeps the reference's rounding (see
//   harmonic_loop): one sincospi per lane every kAnchor harmonics, and
//   between them 31 DFMA, 28 DMUL, 7 DADD and 85 instructions per
//   harmonic in all.
// * The phasor is applied to cross once (u = cross p), so z, z1 and the
//   W2 term are u times conj(B), conj(dB), conj(d2B); B takes one
//   division per harmonic.
// * Epilogue B's ~300 operations per row would cost as much as the loop
//   on one lane per row: the block's rows pass through shared memory,
//   and each warp forms an eighth of the 21 columns for all 32 rows,
//   dividing only for 1/C and 1/S (0.655 ms at [1000, 512, 128] with the
//   plain version's 90 divisions per row, 0.550 ms without them, on an
//   NVIDIA H100 80GB HBM3 at 700 W).
// No [N, nchan, K] temporary reaches device memory.  An optional lane
// list lets the batched solver evaluate only its still-active subints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesPerRow = 8;
constexpr int kRowsPerWarp = 32 / kLanesPerRow;
constexpr int kWarpsPerBlock = 8;
constexpr int kRowsPerBlock = kRowsPerWarp * kWarpsPerBlock;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMinBlocks = 2;
constexpr int kChunk = 4;     // harmonics per lane whose loads go out together
constexpr int kAnchor = 16;   // an exact phasor every kAnchor steps of a lane
constexpr int kSums = 9;
constexpr int kGradHess = 21;
constexpr double kTwoPi = 6.283185307179586;  // 2.0 * pi, as in the reference
constexpr double kLn10 = 2.302585092994046;   // math.log(10.0)

struct ScatArgs {
  const double2* cross;     // [B, nchan, K]
  const double* abs_m2;     // [B or 1, nchan, K]
  int64_t m_bstride;        // abs_m2's batch stride in elements (0: shared)
  const double* shifts;     // [n, nchan]
  const double* taus;       // [n, nchan]
  const double* inv_err2;   // [B, nchan]
  const int64_t* lanes;     // [n] or null
  int64_t nrows;            // n * nchan
  int nchan;
  int K;
};

// One harmonic's contribution to the nine sums: the element arithmetic
// of moments_scat_plain (the reference's order of operations), with the
// phasor (cs, sn) given.
__device__ __forceinline__ void add_harmonic(double2 v, double m, double cs, double sn,
                                             double kd, double tau, double (&acc)[kSums]) {
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
  acc[0] += zr;
  acc[2] += tpk * zi;
  acc[3] += (tpk * tpk) * zr;
  // dB = -i tpk B^2
  const double b2r = br * br - bi * bi;
  const double b2i = 2.0 * br * bi;
  const double dbr = tpk * b2i;
  const double dbi = -tpk * b2r;
  const double z1r = ur * dbr + ui * dbi;
  const double z1i = ui * dbr - ur * dbi;
  acc[4] += z1r;
  acc[5] += tpk * z1i;
  // d2B = -2 tpk^2 B^3
  const double b3r = b2r * br - b2i * bi;
  const double b3i = b2r * bi + b2i * br;
  const double f2 = -2.0 * (tpk * tpk);
  const double d2br = f2 * b3r;
  const double d2bi = f2 * b3i;
  acc[6] += ur * d2br + ui * d2bi;
  acc[1] += (br * br + bi * bi) * m;
  acc[7] += 2.0 * (br * dbr + bi * dbi) * m;
  acc[8] += 2.0 * ((dbr * dbr + dbi * dbi) + (br * d2br + bi * d2bi)) * m;
}

// The harmonic loop of one row, lane q of its eight: harmonics q + 8j.
// The phasor is exact (sincospi of the reference's reduced phase) every
// kAnchor steps; between, it steps by exp(2 pi i 8s), whose angle 8s is
// exact, and each stepped phasor is corrected back to the reference's
// rounded phase fl(s k): with e_k = fma(s, k, -fl(s k)) the exact rounding
// error, it is multiplied by (1, 2 pi (e_anchor - e_k)) (the second-order
// term is below 1e-19 for |s k| < 1e6).  Without that correction the
// phase would be the exact s k, up to ~1e-10 of a sum away from the
// reference's at |s k| ~ 1e5.
__device__ __forceinline__ void harmonic_loop(const double2* __restrict__ x,
                                              const double* __restrict__ am, double s,
                                              double tau, int q, int K, double (&acc)[kSums]) {
  const int J = (K - q + kLanesPerRow - 1) / kLanesPerRow;  // this lane's harmonics
  double wr, wi, pr = 1.0, pi = 0.0, ea = 0.0;
  {
    const double s8 = __dmul_rn(8.0, s);  // exact
    sincospi(2.0 * (s8 - floor(s8)), &wi, &wr);
  }
  double2 v[kChunk], vn[kChunk];
  double m[kChunk], mn[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int k = q + kLanesPerRow * u;
    v[u] = k < K ? __ldg(x + k) : make_double2(0.0, 0.0);
    m[u] = k < K ? __ldg(am + k) : 0.0;
  }
  for (int j0 = 0; j0 < J; j0 += kChunk) {
    // the next chunk's loads go out before this chunk's arithmetic
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int k = q + kLanesPerRow * (j0 + kChunk + u);
      vn[u] = k < K ? __ldg(x + k) : make_double2(0.0, 0.0);
      mn[u] = k < K ? __ldg(am + k) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int j = j0 + u;
      if (j < J) {
        const double kd = (double)(q + kLanesPerRow * j);
        const double sk = __dmul_rn(s, kd);  // the reference's fl(s k), never fused
        double cs, sn;
        if (j % kAnchor == 0) {
          sincospi(2.0 * (sk - floor(sk)), &sn, &cs);
          pr = cs;
          pi = sn;
          ea = fma(s, kd, -sk);
        } else {
          const double t = pr * wr - pi * wi;
          pi = pr * wi + pi * wr;
          pr = t;
          const double d = kTwoPi * (ea - fma(s, kd, -sk));
          cs = pr - pi * d;
          sn = pi + pr * d;
        }
        add_harmonic(v[u], m[u], cs, sn, kd, tau, acc);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      v[u] = vn[u];
      m[u] = mn[u];
    }
  }
}

// The row of this thread, its nine sums reduced over the row's eight
// lanes (every lane of the warp takes part in the shuffles), and the
// sums times inv_err2 with the reference's signs (MOMENTS_SCAT_SUMS
// order).  Returns true on the one lane that holds the row's sums.
__device__ __forceinline__ bool row_sums(const ScatArgs& a, int64_t& row,
                                         double (&sums)[kSums]) {
  const int lane = threadIdx.x & 31;
  const int q = lane & (kLanesPerRow - 1);
  row = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5) * kRowsPerWarp +
        lane / kLanesPerRow;
  const bool live = row < a.nrows;
  double acc[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) acc[t] = 0.0;
  int64_t src = 0;
  if (live) {
    const int64_t i = row / a.nchan;
    const int64_t c = row - i * a.nchan;
    const int64_t b = a.lanes ? a.lanes[i] : i;
    src = b * a.nchan + c;
    harmonic_loop(a.cross + src * (int64_t)a.K, a.abs_m2 + b * a.m_bstride + c * (int64_t)a.K,
                  a.shifts[row], a.taus[row], q, a.K, acc);
  }
#pragma unroll
  for (int t = 0; t < kSums; ++t) {
#pragma unroll
    for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
      acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], off);
  }
  if (!live || q != 0) return false;
  const double w = a.inv_err2[src];
  sums[0] = acc[0] * w;   // C
  sums[1] = acc[1] * w;   // S
  sums[2] = -acc[2] * w;  // T1
  sums[3] = -acc[3] * w;  // T2
  sums[4] = acc[4] * w;   // Q0
  sums[5] = -acc[5] * w;  // Q1
  sums[6] = acc[6] * w;   // W2
  sums[7] = acc[7] * w;   // S1
  sums[8] = acc[8] * w;   // S2
  return true;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
moments_scat_kernel(ScatArgs a, double* __restrict__ out) {
  int64_t row;
  double s[kSums];
  if (!row_sums(a, row, s)) return;
  double* o = out + row * kSums;
#pragma unroll
  for (int t = 0; t < kSums; ++t) o[t] = s[t];
}

// -- epilogue B ---------------------------------------------------------------

struct ChainArgs {
  const double* pd;   // [n, 3, nchan]: d shift / d(phi, DM, GM)
  const double* lnf;  // [n, nchan]: ln(freq / nu_tau)
  const double* tau;  // [n]: the row's tau (linear)
  int log10_tau;
};

// Columns t of one row (moments_scat_grad_hess_plain) with t % kWarpsPerBlock
// == part, from its nine sums: f (t = 0), g (1..5), the Hessian's upper
// triangle row by row (6..20); column t goes to o[t * stride].  Every part
// forms the chain rule, dC and dS.  The terms are the plain version's, in
// its order, with each division by C, S, C^2, S^2 or C S taken as a
// product with 1/C and 1/S: about an ulp per term from the plain version
// (its ~90 correctly rounded divisions per row cost a fifth of the kernel).
__device__ __forceinline__ void grad_hess_row(const double (&s)[kSums], double taus,
                                              const double (&pd)[3], double lnf, double tau,
                                              bool log10_tau, int part,
                                              double* __restrict__ o, int64_t stride) {
  const double C0 = s[0], S0 = s[1], T1 = s[2], T2 = s[3], Q0 = s[4], Q1 = s[5],
               W2 = s[6], S1 = s[7], S2 = s[8];
  // d taus / d(tau or log10 tau, alpha) and the second derivatives
  double td[2], t2d[2][2];
  td[0] = log10_tau ? kLn10 * taus : (tau != 0.0 ? taus / tau : 0.0);
  td[1] = lnf * taus;
  t2d[0][0] = log10_tau ? kLn10 * td[0] : 0.0;
  t2d[0][1] = log10_tau ? kLn10 * td[1] : (tau != 0.0 ? td[1] / tau : 0.0);
  t2d[1][0] = t2d[0][1];
  t2d[1][1] = lnf * td[1];
  // dC, dS [5] (the reference's _moments)
  double dC[5], dS[5];
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    dC[p] = T1 * pd[p];
    dS[p] = 0.0;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    dC[3 + a] = td[a] * Q0;
    dS[3 + a] = td[a] * S1;
  }
  // portrait_grad_hess's per-channel terms
  const bool ok = S0 > 0.0;
  const double rS = 1.0 / (ok ? S0 : 1.0);
  const double C = ok ? C0 : 0.0;
  const double rC = 1.0 / (C != 0.0 ? C : 1.0);
  const double CC = C * C, rSS = rS * rS, rCC = rC * rC, rCS = rC * rS;
  if (part == 0) o[0] = -(ok ? CC * rS : 0.0);
#pragma unroll
  for (int p = 0; p < 5; ++p)
    if ((1 + p) % kWarpsPerBlock == part)
      o[(1 + p) * stride] = -(ok ? 2.0 * C * dC[p] * rS - CC * dS[p] * rSS : 0.0);
  const double lead = -2.0 * (CC * rS);
  int t = 6;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
#pragma unroll
    for (int r = p; r < 5; ++r, ++t) {
      if (t % kWarpsPerBlock != part) continue;
      double d2C, d2S = 0.0;
      if (r < 3) {
        d2C = T2 * pd[p] * pd[r];
      } else if (p < 3) {
        d2C = pd[p] * (td[r - 3] * Q1);
      } else {
        const double tdd = td[p - 3] * td[r - 3];
        d2C = tdd * W2 + t2d[p - 3][r - 3] * Q0;
        d2S = tdd * S2 + t2d[p - 3][r - 3] * S1;
      }
      const double in = d2C * rC - 0.5 * d2S * rS + dC[p] * dC[r] * rCC +
                        dS[p] * dS[r] * rSS - (dC[p] * dS[r] + dS[p] * dC[r]) * rCS;
      o[t * stride] = ok ? lead * in : 0.0;
    }
  }
}

// The harmonic loop as moments_scat_kernel; then the block's 32 rows'
// sums go through shared memory so that each warp takes every row, one
// row per lane, and forms its share of the 21 columns: the epilogue runs
// on all lanes, its columns split eight ways.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
moments_scat_grad_hess_kernel(ScatArgs a, ChainArgs ch, double* __restrict__ out) {
  static_assert(kRowsPerBlock == 32, "one row per lane in the epilogue");
  __shared__ double block_sums[kRowsPerBlock][kSums];
  int64_t row;
  double s[kSums];
  if (row_sums(a, row, s)) {
    const int r = (int)(row - (int64_t)blockIdx.x * kRowsPerBlock);
#pragma unroll
    for (int t = 0; t < kSums; ++t) block_sums[r][t] = s[t];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  row = (int64_t)blockIdx.x * kRowsPerBlock + lane;
  if (row >= a.nrows) return;
#pragma unroll
  for (int t = 0; t < kSums; ++t) s[t] = block_sums[lane][t];
  const int64_t i = row / a.nchan;
  const int64_t c = row - i * a.nchan;
  const double* pdr = ch.pd + i * 3 * (int64_t)a.nchan + c;
  const double pd[3] = {pdr[0], pdr[a.nchan], pdr[2 * (int64_t)a.nchan]};
  grad_hess_row(s, a.taus[row], pd, ch.lnf[row], ch.tau[i], ch.log10_tau != 0,
                threadIdx.x >> 5, out + i * kGradHess * (int64_t)a.nchan + c, a.nchan);
}

ScatArgs scat_args(const void* cross, const void* abs_m2, int64_t m_bstride, const void* shifts,
                   const void* taus, const void* inv_err2, const void* lanes, int64_t n,
                   int nchan, int K) {
  return ScatArgs{(const double2*)cross, (const double*)abs_m2, m_bstride,
                  (const double*)shifts, (const double*)taus, (const double*)inv_err2,
                  (const int64_t*)lanes, n * (int64_t)nchan, nchan, K};
}

unsigned blocks_for(int64_t nrows) {
  return (unsigned)((nrows + kRowsPerBlock - 1) / kRowsPerBlock);
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
  const ScatArgs a = scat_args(cross, abs_m2, m_bstride, shifts, taus, inv_err2, lanes, n,
                               nchan, K);
  if (a.nrows <= 0) return 0;
  moments_scat_kernel<<<blocks_for(a.nrows), kThreads, 0, (cudaStream_t)stream>>>(
      a, (double*)out);
  return (int)cudaGetLastError();
}

// As pp_moments_scat, with out [n, 21, nchan] (f, g[5], the Hessian's upper
// triangle row by row) and the chain rule's inputs: pd [n, 3, nchan], lnf
// [n, nchan] = ln(freq / nu_tau), tau [n] the rows' linear tau, log10_tau
// whether the fit's tau parameter is log10(tau).
extern "C" int pp_moments_scat_gh(const void* cross, const void* abs_m2, int64_t m_bstride,
                                  const void* shifts, const void* taus, const void* inv_err2,
                                  const void* lanes, const void* pd, const void* lnf,
                                  const void* tau, int log10_tau, int64_t n, int nchan, int K,
                                  void* out, void* stream) {
  const ScatArgs a = scat_args(cross, abs_m2, m_bstride, shifts, taus, inv_err2, lanes, n,
                               nchan, K);
  if (a.nrows <= 0) return 0;
  const ChainArgs ch{(const double*)pd, (const double*)lnf, (const double*)tau, log10_tau};
  moments_scat_grad_hess_kernel<<<blocks_for(a.nrows), kThreads, 0, (cudaStream_t)stream>>>(
      a, ch, (double*)out);
  return (int)cudaGetLastError();
}
