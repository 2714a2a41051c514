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
//           (lowest index on a tie; the first NaN wins over any number)
//   Newton: newton_iter safeguarded steps  phase += clip(-dC/d2C, +-cell)
//           (no step where d2C <= 0), cell = (hi - lo) / Ns
//   wrap:   phase = (phase + 0.5) mod 1 - 0.5
//   out:    phase, C = -sum Re(z) * inv_err2, d2C = 4 pi^2 sum k^2 Re(z) *
//           inv_err2 at the final phase, z_k = x_k exp(2 pi i (phase k mod 1)).
//
// What bounds it on an H100: operations.  The grid phasors do not depend
// on the profile, so the grid stage is one real float64 product
// [N, 2 nharm] x [2 nharm, Ns] against a table all profiles share (4 N
// nharm Ns = 4.1e8 operations at N=1000, Ns=100, nharm=1025: 6.1 us on the
// FP64 tensor cores at 67 TFLOP/s); each Newton step and the final
// objective add ~18 FP64 operations per harmonic (3.8 us at 34 TFLOP/s);
// the input is 16 MB (4.9 us at 3.35 TB/s).  In practice (PERF.md) the
// grid stage is held by feeding the tensor cores (the latency of the tile
// loads, most of all when few profiles leave each block only a short K
// slice) and by the padding of Ns = 100 to 128 columns, a fifth of its
// tensor-core work; the Newton stage by the FP64 pipes and the latency of
// each step's table, sums and division.
//
// Design, three kernels:
//
//   table   T [Kp, Nsp] f64, row 2k = cos theta_gk, row 2k+1 = -sin
//           theta_gk, theta_gk = 2 pi frac(v_g k) by sincospi, zero in the
//           padding (Kp = 2 nharm rounded up to kBK, Nsp = Ns rounded up
//           to kNsAlign).  Built once per (nharm, lo, hi, Ns) into a buffer
//           the caller allocates and caches.
//   grid    the product on the FP64 tensor cores with mma.sync m16n8k8
//           .f64 (m8n8k4 reaches only half their rate on the H100), from
//           tiles staged by cp.async through a kStages-deep ring; cross
//           [N, nharm] complex128 is read in place as a real [N, 2 nharm]
//           matrix.  Many profiles: 128 x 128 block tiles (8 warps of
//           32 x 64), whose first minima per row and 32-column group come
//           straight from the accumulators.  Few profiles: 64 x 64 tiles
//           with K split over a cluster of 2-8 blocks, so that every SM
//           works; the blocks sum their slices in rank order through
//           distributed shared memory.  Either way one (value, index)
//           partial per row and column group is written: the [N, Ns] grid
//           never reaches device memory.
//   newton  W = 4, 2 or 1 warps per profile (fewer as N grows): merges the
//           partials by the same first-minimum rule, stages the spectrum
//           in shared memory by cp.async, and runs the Newton steps and the
//           final objective with warp sums.  The phasor of harmonic
//           k = 32 W j + l is the two-level product e(32 W j) e(l) of
//           sincospi(2 frac(phase m)) values, e(l) itself e(8 (l / 8))
//           e(l % 8): 4 W + 8 + nharm / (32 W) sincospi per step instead of
//           one per harmonic, and the same results as the plain version's
//           per-harmonic trig to the f64 floor (chip_smoke.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 2.0 * kPi;             // 2.0 * pi, as in the reference
constexpr double kFourPi2 = 4.0 * (kPi * kPi);   // 4.0 * pi ** 2, as in the reference

constexpr int kBK = 32;       // K (doubles) per pipeline stage
constexpr int kStages = 3;    // cp.async ring depth
constexpr int kAStride = kBK + 4;  // shared-memory row strides (doubles) that
constexpr int kBPad = 4;           // spread a fragment load over all banks
constexpr int kColGroup = 32;      // columns per argmin partial
constexpr int kNsAlign = 128;      // Ns is padded to a multiple of this
constexpr int kNewtonWarps = 4;  // warps per Newton block
constexpr int kNewtonThreads = 32 * kNewtonWarps;

// ---- argmin: the first minimum; a NaN beats every number ----------------

// true if (va, ia) comes before (vb, ib) under jnp.argmin's rule
__device__ __forceinline__ bool first_min_before(double va, int ia, double vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na != nb) return na;
  if (!na && va != vb) return va < vb;
  return ia < ib;
}

__device__ __forceinline__ void first_min_merge(double& v, int& i, double ov, int oi) {
  if (first_min_before(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// ---- table --------------------------------------------------------------

__global__ void fftfit_table_kernel(double* __restrict__ T, int nharm, int Kp, int Ns,
                                    int Nsp, double lo, double hi) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)(Kp / 2) * Nsp) return;
  const int k = (int)(idx / Nsp), g = (int)(idx % Nsp);
  double sn = 0.0, cs = 0.0;
  if (k < nharm && g < Ns) {
    const double v = lo + ((hi - lo) * (double)g) / Ns;
    const double pk = v * (double)k;
    const double frac = pk - floor(pk);
    sincospi(2.0 * frac, &sn, &cs);
  }
  T[(int64_t)(2 * k) * Nsp + g] = cs;
  T[(int64_t)(2 * k + 1) * Nsp + g] = -sn;
}

// ---- grid + argmin on the FP64 tensor cores ------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a b for one 16x8x8 tile (g = lane / 4, t = lane % 4):
//   a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];  b = B[t][g], B[t+4][g];
//   d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
// (m8n8k4 runs at half the FP64 tensor rate on the H100; the 16x8x8 and
// 16x8x16 shapes reach the full rate.)
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// A block computes a BM x BN output tile (BM = 32 WR, BN = 8 NJ WC) from K
// chunks of kBK through a kStages-deep cp.async ring: WR x WC warps own
// 32 x 8 NJ each; the CK blocks of a cluster split K between them.
template <int WR, int WC, int NJ, int CK>
struct Grid {
  static constexpr int kThreads = 32 * WR * WC;
  static constexpr int BM = 32 * WR, BN = 8 * NJ * WC;
  static constexpr int kBStride = BN + kBPad, kTStride = BN + kBPad;
  static constexpr int kAStage = BM * kAStride, kBStage = kBK * kBStride;
  static constexpr size_t kPipe = (size_t)kStages * (kAStage + kBStage);
  static constexpr size_t kEpi = CK > 1 ? (size_t)BM * kTStride : 0;  // the tile, row-major
  static constexpr size_t kSmem = (kPipe > kEpi ? kPipe : kEpi) * sizeof(double);
  static_assert(NJ % 4 == 0 && BM % CK == 0, "whole column groups and row shares");
};

// first_min over the lanes of groups of L consecutive lanes (L a power of 2)
template <int L>
__device__ __forceinline__ void first_min_lanes(double& v, int& i) {
#pragma unroll
  for (int off = 1; off < L; off <<= 1)
    first_min_merge(v, i, __shfl_xor_sync(0xffffffffu, v, off),
                    __shfl_xor_sync(0xffffffffu, i, off));
}

template <int WR, int WC, int NJ, int CK>
__global__ void __launch_bounds__(Grid<WR, WC, NJ, CK>::kThreads, 1)
fftfit_grid_kernel(const double* __restrict__ A, const double* __restrict__ T, int64_t n,
                   int K, int Nsp, int Ns, double* __restrict__ pval, int* __restrict__ pidx) {
  using G = Grid<WR, WC, NJ, CK>;
  extern __shared__ __align__(16) double sm[];
  const int ncol = Nsp / G::BN, ngroups = Nsp / kColGroup;
  const int tile = blockIdx.x / CK, kr = blockIdx.x % CK;  // kr: rank in the cluster
  const int64_t row0 = (int64_t)(tile / ncol) * G::BM;
  const int col0 = (tile % ncol) * G::BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % WR, wc = warp / WR;
  const int nk = (K + kBK - 1) / kBK;
  const int kc0 = (int)((int64_t)kr * nk / CK), nloc = (int)((int64_t)(kr + 1) * nk / CK) - kc0;

  auto load = [&](int stage, int kc) {
    double* As = sm + stage * (G::kAStage + G::kBStage);
    double* Bs = As + G::kAStage;
    for (int c = tid; c < G::BM * (kBK / 2); c += G::kThreads) {
      const int r = c / (kBK / 2), q = c % (kBK / 2);
      const int64_t row = row0 + r;
      const int kk = kc * kBK + 2 * q;
      const bool ok = row < n && kk < K;
      cp_async16(As + r * kAStride + 2 * q, ok ? A + row * K + kk : A, ok ? 16 : 0);
    }
    for (int c = tid; c < kBK * (G::BN / 2); c += G::kThreads) {
      const int r = c / (G::BN / 2), q = c % (G::BN / 2);
      cp_async16(Bs + r * G::kBStride + 2 * q, T + (int64_t)(kc * kBK + r) * Nsp + col0 + 2 * q,
                 16);
    }
  };

  double acc[2][NJ][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nloc) load(s, kc0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < nloc; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = i + kStages - 1;
    if (nxt < nloc) load(nxt % kStages, kc0 + nxt);
    cp_async_commit();
    const double* As = sm + (i % kStages) * (G::kAStage + G::kBStage);
    const double* Bs = As + G::kAStage;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 8) {
      const int kk = ks + t;
      double a[2][4], b[NJ][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const double* ar = As + (wr * 32 + mi * 16 + g) * kAStride + kk;
        a[mi][0] = ar[0];
        a[mi][1] = ar[8 * kAStride];
        a[mi][2] = ar[4];
        a[mi][3] = ar[8 * kAStride + 4];
      }
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const double* bc = Bs + kk * G::kBStride + wc * 8 * NJ + nj * 8 + g;
        b[nj][0] = bc[0];
        b[nj][1] = bc[4 * G::kBStride];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj) mma_f64(acc[mi][nj], a[mi], b[nj]);
    }
  }
  cp_async_wait<0>();

  // First minimum of Cgrid = -acc per row and column group of 32.  The
  // [N, Ns] grid never leaves the chip.
  if constexpr (CK == 1) {
    // straight from the accumulators: this lane holds, for rows g and g + 8
    // of each 16-row slab, columns 2t, 2t + 1 of each 8-column tile
    const int cw = col0 + wc * 8 * NJ;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < NJ / 4; ++q) {
          double bv = INFINITY;
          int bi = 0x7fffffff;  // "no column": loses to every real column
#pragma unroll
          for (int nj = 4 * q; nj < 4 * q + 4; ++nj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = cw + nj * 8 + 2 * t + e;
              if (col < Ns) first_min_merge(bv, bi, -acc[mi][nj][2 * h + e], col);
            }
          first_min_lanes<4>(bv, bi);
          const int64_t row = row0 + wr * 32 + mi * 16 + h * 8 + g;
          if (t == 0 && row < n) {
            pval[row * ngroups + cw / kColGroup + q] = bv;
            pidx[row * ngroups + cw / kColGroup + q] = bi;
          }
        }
  } else {
    // the tile, row-major in shared memory; the cluster's blocks sum their K
    // slices in rank order (distributed shared memory), each for BM / CK rows
    __syncthreads();  // the pipeline's buffers become the tile
    double* tile_s = sm;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tile_s[(wr * 32 + mi * 16 + g + 8 * (q >> 1)) * G::kTStride + wc * 8 * NJ + nj * 8 +
                 2 * t + (q & 1)] = acc[mi][nj][q];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const double* parts[CK];
#pragma unroll
    for (int r = 0; r < CK; ++r) parts[r] = cluster.map_shared_rank(tile_s, r);
    constexpr int kPer = G::BN / 32;           // consecutive columns per lane
    constexpr int kLanes = kColGroup / kPer;   // lanes per column group
    constexpr int kRows = G::BM / CK;
    for (int rr = warp; rr < kRows; rr += G::kThreads / 32) {
      const int r = kr * kRows + rr;
      double bv = INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int c = kPer * lane + u;
        double v = parts[0][r * G::kTStride + c];
#pragma unroll
        for (int s = 1; s < CK; ++s) v += parts[s][r * G::kTStride + c];
        if (col0 + c < Ns) first_min_merge(bv, bi, -v, col0 + c);
      }
      first_min_lanes<kLanes>(bv, bi);
      const int64_t row = row0 + r;
      if (lane % kLanes == 0 && row < n) {
        pval[row * ngroups + col0 / kColGroup + lane / kLanes] = bv;
        pidx[row * ngroups + col0 / kColGroup + lane / kLanes] = bi;
      }
    }
    cluster.sync();  // keep every block's tile alive until it has been read
  }
}

// ---- Newton polish + final objective ------------------------------------

// exp(2 pi i (p mod 1)) as (cos, sin)
__device__ __forceinline__ double2 phasor(double p) {
  const double frac = p - floor(p);
  double sn, cs;
  sincospi(2.0 * frac, &sn, &cs);
  return make_double2(cs, sn);
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Sum over the warp, the same value in every lane (lane 0's order).
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// Two-level phasors: lane l of the profile's 32 W lanes takes, for its
// harmonics k = l + 32 W j, exp(2 pi i (phase k mod 1)) = base_j own_l with
// base_j = e(32 W j) and own_l = e(8 (l / 8)) e(l % 8), e(m) = exp(2 pi i
// (phase m mod 1)).  The profile's warps fill
// tab = [e(0), e(8), .., e(32 W - 8) | e(0), .., e(7) | base_0, ..]
// (4 W + 8 + nbase sincospi per phase instead of nharm) and each lane
// returns its own_l.
template <int W>
struct Profile {
  static constexpr int kLanes = 32 * W;
  static constexpr int kTab0 = 4 * W + 8;  // where base_j starts in tab
  static constexpr int kPerBlock = kNewtonWarps / W;
  static __device__ __host__ __forceinline__ int nbase(int nharm) {
    return (nharm + kLanes - 1) / kLanes;
  }
  static __device__ __host__ __forceinline__ size_t words(int nharm) {  // double2 per profile
    return (size_t)nharm + kTab0 + nbase(nharm);
  }
  // barrier of the profile's W warps (named barrier 1 + slot)
  static __device__ __forceinline__ void sync(int slot) {
    if (W == 1)
      __syncwarp();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + slot), "r"(kLanes));
  }
};

template <int W>
__device__ __forceinline__ double2 phasor_table(double phase, double2* tab, int nbase, int l,
                                                int slot) {
  using P = Profile<W>;
  for (int i = l; i < P::kTab0 + nbase; i += P::kLanes) {
    const int m = i < 4 * W ? 8 * i : (i < P::kTab0 ? i - 4 * W : P::kLanes * (i - P::kTab0));
    tab[i] = phasor(phase * (double)m);
  }
  P::sync(slot);
  return cmul(tab[l >> 3], tab[4 * W + (l & 7)]);
}

// Lane l's part of sum_k k^p x_k exp(2 pi i (phase k mod 1)) for p = p1 (1
// or 0) and 2, as complex sums S1, S2 still to be multiplied by the returned
// phasor own_l.
template <int W>
__device__ __forceinline__ double2 lane_sums(const double2* xs, int nharm, double phase,
                                             double2* tab, int nbase, int l, int slot, bool p1,
                                             double2& S1, double2& S2) {
  constexpr int L = Profile<W>::kLanes;
  const double2 own = phasor_table<W>(phase, tab, nbase, l, slot);
  S1 = S2 = make_double2(0.0, 0.0);
  double kd = (double)l;
#pragma unroll 4
  for (int j = 0, k = l; k < nharm; ++j, k += L, kd += (double)L) {
    const double2 w = cmul(xs[k], tab[Profile<W>::kTab0 + j]);
    const double k1 = p1 ? kd : 1.0, k2 = kd * kd;
    S1.x += k1 * w.x;
    S1.y += k1 * w.y;
    S2.x += k2 * w.x;
    S2.y += k2 * w.y;
  }
  return own;
}

// (a, b) summed over the profile's W warps, the same in every lane (warp
// order); red[2 W] is alternated by the caller, so one barrier suffices.
template <int W>
__device__ __forceinline__ void profile_sum2(double& a, double& b, double* red, int wl,
                                             int slot) {
  a = warp_sum(a);
  b = warp_sum(b);
  if (W == 1) return;
  if ((threadIdx.x & 31) == 0) {
    red[wl] = a;
    red[W + wl] = b;
  }
  Profile<W>::sync(slot);
  a = red[0];
  b = red[W];
#pragma unroll
  for (int i = 1; i < W; ++i) {
    a += red[i];
    b += red[W + i];
  }
}

// W warps per profile, kNewtonWarps / W profiles per block; the profile's
// spectrum is staged in shared memory and its warps wait only on each
// other.  After each phase's table the profile's warps meet once more
// in the sums, which also orders the next table's writes after this
// phase's reads.
template <int W>
__global__ void __launch_bounds__(kNewtonThreads)
fftfit_newton_kernel(const double2* __restrict__ cross, const double* __restrict__ inv_err2,
                     const double* __restrict__ pval, const int* __restrict__ pidx, int64_t n,
                     int ngroups, int nharm, double lo, double hi, int Ns, int newton_iter,
                     double* __restrict__ phase_out, double* __restrict__ C_out,
                     double* __restrict__ d2C_out) {
  using P = Profile<W>;
  extern __shared__ __align__(16) double2 smem2[];
  __shared__ double red[P::kPerBlock][2][2 * W];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / W, wl = warp % W, l = wl * 32 + lane;
  const int64_t b = (int64_t)blockIdx.x * P::kPerBlock + slot;
  if (b >= n) return;  // the profile's warps all leave
  const int nbase = P::nbase(nharm);
  double2* xs = smem2 + slot * P::words(nharm);  // [nharm]
  double2* tab = xs + nharm;                     // [kTab0 + nbase]

  const double2* x = cross + b * (int64_t)nharm;
  for (int k = l; k < nharm; k += P::kLanes) cp_async16(xs + k, x + k, 16);
  cp_async_commit();
  // merge the grid's per-group first minima (every lane ends with the same)
  double bv = INFINITY;
  int bi = 0x7fffffff;
  for (int q = lane; q < ngroups; q += 32)
    first_min_merge(bv, bi, pval[b * ngroups + q], pidx[b * ngroups + q]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first_min_merge(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
                    __shfl_xor_sync(0xffffffffu, bi, off));
  double phase = lo + ((hi - lo) * (double)bi) / Ns;
  const double w = inv_err2[b];
  const double cell = (hi - lo) / Ns;
  cp_async_wait<0>();
  P::sync(slot);

  double2 S1, S2;
  for (int it = 0; it < newton_iter; ++it) {
    const double2 own = lane_sums<W>(xs, nharm, phase, tab, nbase, l, slot, true, S1, S2);
    double s1 = own.x * S1.y + own.y * S1.x;  // Im(own S1)
    double s2 = own.x * S2.x - own.y * S2.y;  // Re(own S2)
    profile_sum2<W>(s1, s2, red[slot][it & 1], wl, slot);
    if (W == 1) __syncwarp();  // this phase's table has been read
    const double dC = (kTwoPi * s1) * w;
    const double d2C = (kFourPi2 * s2) * w;
    double step = d2C > 0.0 ? -dC / d2C : 0.0;
    step = step < -cell ? -cell : (step > cell ? cell : step);  // NaN passes
    phase = phase + step;
  }

  phase = phase + 0.5;
  phase = (phase - floor(phase)) - 0.5;
  const double2 own = lane_sums<W>(xs, nharm, phase, tab, nbase, l, slot, false, S1, S2);
  double s0 = own.x * S1.x - own.y * S1.y;  // Re(own S1)
  double s2 = own.x * S2.x - own.y * S2.y;
  profile_sum2<W>(s0, s2, red[slot][newton_iter & 1], wl, slot);
  if (l == 0) {
    phase_out[b] = phase;
    C_out[b] = -s0 * w;
    d2C_out[b] = (kFourPi2 * s2) * w;
  }
}

template <typename F>
cudaError_t set_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int WR, int WC, int NJ, int CK>
cudaError_t launch_grid(const double* A, const double* T, int64_t n, int K, int Nsp, int Ns,
                        double* pval, int* pidx, cudaStream_t stream) {
  using G = Grid<WR, WC, NJ, CK>;
  const cudaError_t e = set_smem(fftfit_grid_kernel<WR, WC, NJ, CK>, G::kSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((n + G::BM - 1) / G::BM) * (Nsp / G::BN) * CK));
  cfg.blockDim = dim3(G::kThreads);
  cfg.dynamicSmemBytes = G::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CK;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fftfit_grid_kernel<WR, WC, NJ, CK>, A, T, n, K, Nsp,
                            Ns, pval, pidx);
}

template <int W>
cudaError_t launch_newton(const double2* cross, const double* inv_err2, const double* pval,
                          const int* pidx, int64_t n, int nharm, int ngroups, double lo,
                          double hi, int Ns, int newton_iter, double* phase, double* C,
                          double* d2C, cudaStream_t stream) {
  using P = Profile<W>;
  const size_t smem = (size_t)P::kPerBlock * P::words(nharm) * sizeof(double2);
  const cudaError_t e = set_smem(fftfit_newton_kernel<W>, smem);
  if (e != cudaSuccess) return e;
  fftfit_newton_kernel<W>
      <<<(unsigned)((n + P::kPerBlock - 1) / P::kPerBlock), kNewtonThreads, smem, stream>>>(
          cross, inv_err2, pval, pidx, n, ngroups, nharm, lo, hi, Ns, newton_iter, phase, C,
          d2C);
  return cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Padded table sizes (the wrapper computes the same): rows Kp, columns Nsp.
void fftfit_sizes(int nharm, int Ns, int* Kp, int* Nsp) {
  *Kp = (2 * nharm + kBK - 1) / kBK * kBK;
  *Nsp = (Ns + kNsAlign - 1) / kNsAlign * kNsAlign;
}

}  // namespace

// Fills table [Kp, Nsp] f64: Kp = 2 nharm rounded up to 32, Nsp = Ns
// rounded up to 128.  Returns the launch's cudaError_t.
extern "C" int pp_fftfit_table(void* table, int nharm, int Ns, double lo, double hi,
                               void* stream) {
  int Kp, Nsp;
  fftfit_sizes(nharm, Ns, &Kp, &Nsp);
  const int64_t total = (int64_t)(Kp / 2) * Nsp;
  fftfit_table_kernel<<<(unsigned)((total + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (double*)table, nharm, Kp, Ns, Nsp, lo, hi);
  return (int)cudaGetLastError();
}

// cross [n, nharm] complex128 (interleaved f64), inv_err2 [n], table from
// pp_fftfit_table; scratch pval [n, Nsp/32] f64 and pidx [n, Nsp/32] int32;
// outputs phase, C, d2C [n] f64.  stages: 1 = grid (fills the scratch),
// 2 = Newton (reads it), 3 = both.  Launches on `stream`;
// returns the first cudaError_t (a refused launch is reported, not lost).
extern "C" int pp_fftfit(const void* cross, const void* inv_err2, const void* table, int64_t n,
                         int nharm, double lo, double hi, int Ns, int newton_iter, int stages,
                         void* pval, void* pidx, void* phase_out, void* C_out,
                         void* d2C_out, void* stream) {
  if (n <= 0) return 0;
  int Kp, Nsp;
  fftfit_sizes(nharm, Ns, &Kp, &Nsp);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (stages & 1) {
    const int sms = sm_count();
    // 128 x 128 block tiles (4 x 2 warps of 32 x 64) once they fill most
    // SMs: the bigger the tile, the fewer bytes it reads from L2 per
    // product.  Else 64 x 64 tiles (2 x 2 warps of 32 x 32, two blocks fit
    // an SM) with K split over a cluster of 2 to 8 blocks, to give every SM
    // about two blocks (clusters of 8 at one block per SM do not all fit).
    const int64_t big = ((n + 127) / 128) * (Nsp / 128);
    const int64_t small = ((n + 63) / 64) * (Nsp / 64);
    using Launch = cudaError_t (*)(const double*, const double*, int64_t, int, int, int,
                                   double*, int*, cudaStream_t);
    const Launch launch =
        big >= 3 * (int64_t)sms / 4 ? launch_grid<4, 2, 8, 1>
        : small >= 2 * sms          ? launch_grid<2, 2, 4, 1>
        : small * 2 >= 2 * sms      ? launch_grid<2, 2, 4, 2>
        : small * 4 >= 2 * sms      ? launch_grid<2, 2, 4, 4>
                                    : launch_grid<2, 2, 4, 8>;
    e = launch((const double*)cross, (const double*)table, n, 2 * nharm, Nsp, Ns,
               (double*)pval, (int*)pidx, s);
    if (e != cudaSuccess) return (int)e;
  }
  if (stages & 2) {
    // more warps per profile while few profiles leave the card idle; one
    // warp per profile (the least work around the sums) once they fill it
    using Launch = cudaError_t (*)(const double2*, const double*, const double*, const int*,
                                   int64_t, int, int, double, double, int, int, double*, double*,
                                   double*, cudaStream_t);
    const int64_t sms = sm_count();
    const int W = n <= 4 * sms ? 4 : n <= 16 * sms ? 2 : 1;
    const Launch launch = W == 4 ? launch_newton<4> : W == 2 ? launch_newton<2> : launch_newton<1>;
    e = launch((const double2*)cross, (const double*)inv_err2, (const double*)pval,
               (const int*)pidx, n, nharm, Nsp / kColGroup, lo, hi, Ns, newton_iter,
               (double*)phase_out, (double*)C_out, (double*)d2C_out, s);
  }
  return (int)e;
}
