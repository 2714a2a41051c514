// K9: the Gaussian portrait fit's sum of squares, gradient and normal
// matrix, in one pass over the portrait, with no Jacobian formed.
//
// Replaces, on ppgauss's unscattered and unjoined fit (tau frozen at 0, no
// join groups), the forward-mode Jacobian of the JAX reference's
// Levenberg-Marquardt loop, pulseportraiture_tpu/fit/lm.py:60
// ``jac = jax.jacfwd(res)``, and the products it feeds: J.T @ r and J.T @ J
// in normal_step (:67-79) and in the covariance (:129-139).  The residual is
// pulseportraiture_tpu/fit/gauss.py:124-131, whose model is
// ops/profiles.py:141 gen_gaussian_portrait on its tau = 0 branch with the
// evolution laws :108 power_law_evolution and :119 linear_evolution.
//
// A lane's parameters (a row of params [B, P], P = 2 + 6 ngauss + 1): dc,
// tau, (loc0, dloc, wid0, dwid, amp0, damp) per component, the scattering
// index.  At channel nu each component's loc, wid and amp evolve by their
// model-code digit: 0 the power law v = exp(log(nu / nu_ref) s + log p0),
// dv/dp0 = (1 / p0) v, dv/ds = log(nu / nu_ref) v; 1 the linear law
// v = (nu - nu_ref) s + p0, dv/dp0 = 1, dv/ds = nu - nu_ref.  At bin centre t:
//
//   x = t - (loc mod 1), moved into [-0.5, 0.5] (the reference's two wheres)
//   sigma = wid / FWHM, z = clip(x (1 / sigma), +-20), e = exp(-z^2 / 2)
//   m = dc + sum_c amp e
//   dm/ddc = 1, dm/damp = e, dm/dloc = amp e z / sigma, dm/dwid = amp e z^2 / wid
//
// the loc and wid derivatives 0 where |x / sigma| >= 20 (the clip's); a
// component with wid <= 0 gives e = 0 and loc and wid derivatives 0 whatever
// their chain factors (the reference's where selects a zero there).
// r = (data - m) / err and J = -(dm/dtheta) / err; the tau and
// scattering-index columns are 0.  A power law's p0 = 0 (an amplitude at its
// 0 bound) makes forward-mode's tangent of the evolved value 0 (0 / 0) = NaN
// along every parameter, so the reference's J is NaN in every column at the
// channels that value reaches (through amp always, through loc and wid where
// the component is live): such a channel adds NaN to every term of g and JtJ
// here too.
//
// Outputs per lane: f = sum r^2 (gauss_sse, epilogue A), and f, g = J^T r
// and JtJ = J^T J (gauss_normal, epilogue B).
//
// Design.  At channel nu every column of J is a chain factor a_p(nu) (1 for
// dc) times one of Q = 1 + 3 ngauss basis rows of the bin: w, e w,
// (amp e z / sigma) w and (amp e z^2 / wid) w per component, w = 1 / err.
// With r appended as row Q, the channel's (Q + 1) x (Q + 1) Gram matrix
// G = V^T V, V the [nbin, Q + 1] matrix of those rows, holds everything:
// JtJ_pq = sum_nu a_p a_q G_{q(p) q(q)}, g_p = -sum_nu a_p G_{q(p) Q},
// f = sum_nu G_QQ: a batched SYRK with K = nbin per (lane, channel).  Where
// the errors are one value a channel (errs read through a stride of 0 along
// the bins, as ppgauss gives them) w is 1 in the bins and the channel's Gram
// is scaled by 1 / err^2 once; 1 / sigma is formed once per component.
//   The mma layout (more than kWarpNgauss components): the Gram's rows in
// blocks of kPanelRows (64) rows, its upper triangle in panels (I, J), I <= J
// (one panel, all of G, up to 20 components), each panel in pairs of
// 16 x 8 tiles (16 rows by 16 columns: one a fragment, two b) summed on
// the FP64 tensor cores (mma.sync m16n8k8 .f64, accumulators in registers)
// from rounds of 32 bins staged in shared memory, row by row.  A bin's
// basis values are formed by the lanes of its warp, which split its
// components (each bin's exp and model formed once a panel; the model's
// partial sums joined by a fixed shuffle tree).  Own bins (3-10
// components, a Gram of one or three pairs): a block of four warps per
// (lane, channel group), each warp forming four bins a lane side by side
// into a slice of its own and summing its own rounds into every pair (no
// block barrier in the loop), the warps' partial pairs then added in warp
// order.  Beyond: a block of eight warps, which share each chunk of 32
// bins (one barrier a chunk, two chunks staged) and deal the panel's pairs
// out, at most two a warp.  The thread that holds an entry of G applies
// the chain rule to it and writes (or, for the group's later channels,
// adds) its terms to the group's row of per-lane sums: JtJ's upper
// triangle over the 6 ngauss + 1 live parameters, g, f and the channels'
// poison.  Beyond one panel (21 components and more) each panel is a pass
// over the bins of its own: a component's exp is formed once per panel
// holding its rows, and the model (every exp) once per panel holding r, so
// each exp is formed 2-3 times a bin at 21-41 components.  Forming it once
// needs every pair's accumulators live through one pass: at 41 components
// 36 pairs, five a warp, 40 doubles a lane against the 16 of two pairs,
// which fits at one block an SM instead of two (not tried here); past
// about 60 components the registers run out, the whole [nbin, q1] basis
// does not fit a block's shared memory, and accumulators kept there would
// be loaded and stored every k-step.
//   The warp layout (1-2 components, a Gram too small for 16 x 8 tiles): a
// block of four warps per (lane, channel), each thread's bins summed into
// the Gram's 15 or 36 entries in registers, a fixed shuffle tree per entry
// and the warps in order; the chain rule as above.
//   Epilogue A: a block of four warps per (lane, channel), r^2 summed as in
// the warp layout.
//   One launch per call and epilogue.  Every block writes its row to
// scratch; the rows are then summed over the channels by a tree of fixed
// shape (fan-in ``fan``): the last block to finish a node, found by a
// counter of the call's own (an atomic on the counter only, never on a
// sum), sums the node's children in child order; the root's sums are the
// outputs.  Each counter is set back to 0 by the block that found itself
// last, so two calls in a row and CUDA-graph replays start from 0.  The
// same inputs give the same bits whatever the order the blocks run in.
//
// errs [nchan, nbin] is read through its strides (errs_row, errs_bin).
//
// What bounds it on an H100: at one lane and one component, bytes: data
// read once, 8.4 MB at [512, 2048] (errs a value a channel), 0.0025 ms at
// 3.35 TB/s, against ~39 FP64 operations a bin (the exp ~20) at 34
// TFLOP/s; a launch's own floor of a few microseconds alone takes half of
// that bound.  More components or lanes make it operations: the exp and
// basis grow as ngauss, the Gram as (3 ngauss + 2)^2 / 2 multiply-adds a
// bin on the FP64 tensor cores (67 TFLOP/s), every lane reading the same
// data.  At 19 components a 64-row panel's pairs carry 64 x 72 / 2 entries
// for the 59 x 60 / 2 the Gram needs.  What holds it on an H100 (PERF.md
// row K9): each block's chains of dependent FP64 operations (a bin's exp
// and basis values, then the shuffles, the chain rule and the tree), which
// a block's few warps do not hide; a block alone on an SM takes nearly as
// long as four sharing it, so the time follows the bins a block walks, not
// the card's FP64 or tensor rate.
//
// Limits: the mma layout keeps ten doubles and an int a component and two
// chunks of at most 2 kPanelRows rows of 36 doubles in shared memory:
// kMaxNgauss = 1888 components on an H100 (232,448 bytes a block; the
// wrapper raises beyond, and fit.gauss takes jacfwd there); epilogue A
// kSseMaxNgauss = 6456.  Lanes ride on the grid's y dimension (<= 65535).
// The rows of sums take (6 ngauss + 1)^2 / 2 doubles a lane and channel
// group; channels are grouped a block so that a lane's rows stay within
// kRowBudget.  geometry() alone sizes a launch: pp_gauss_sizes hands it to
// the wrapper, which allocates from it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "gauss_common.cuh"

namespace {

constexpr int kWarpNgauss = 2;      // the warp layout up to this many components
constexpr int kSmallThreads = 128;  // warp layout and epilogue A: four warps a block
constexpr int kMmaThreads = 256;    // mma layout: eight warps a block
constexpr int kMmaWarps = kMmaThreads / 32;

// a thread's bins j0 + u T (u < 4): bin centre, data and error (1 where the
// errors are per channel); x = d = 0 past nbin
struct Bins4 {
  double x[4], d[4], e[4];
};

__device__ __forceinline__ void load4(Bins4& v, int j0, int T, int nbin,
                                      const double* __restrict__ bins,
                                      const double* __restrict__ drow,
                                      const double* __restrict__ erw, int ebin) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = j0 + u * T;
    v.x[u] = v.d[u] = 0.0;
    v.e[u] = 1.0;
    if (j < nbin) {
      v.x[u] = __ldg(bins + j);
      v.d[u] = __ldg(drow + j);
      if (ebin) v.e[u] = __ldg(erw + (int64_t)j * ebin);
    }
  }
}

// -- the rows of sums and their channel tree ----------------------------------

// a row of per-lane sums over the L = 6 ngauss + 1 live parameters (dc, then
// six a component): JtJ's upper triangle, g (before its sign), f, poison
__host__ __device__ __forceinline__ int64_t row_width(int ng) {
  const int L = 6 * ng + 1;
  return (int64_t)L * (L + 1) / 2 + L + 2;
}

// basis row q's first live parameter p and the chain factors of p and, for
// a component's row (the function's value), p + 1 (row 0: dc, alone;
// then e, loc, wid per component)
__device__ __forceinline__ bool row_params(int q, const double* chain, int* p, double* c0,
                                           double* c1) {
  if (q == 0) {
    *p = 0;
    *c0 = 1.0;
    *c1 = 0.0;
    return false;
  }
  const int c = (q - 1) / 3, k = (q - 1) % 3;
  const int base = k == 0 ? 4 : (k == 1 ? 0 : 2);  // amp, loc, wid
  *p = 1 + 6 * c + base;
  *c0 = chain[6 * c + base];
  *c1 = chain[6 * c + base + 1];
  return true;
}

// the chain rule on the channel's Gram entry G = G_ij (i <= j < q1): its
// terms into (add) or onto (!add) the row of sums
__device__ __forceinline__ void emit(int i, int j, double G, int q1, int L,
                                     const double* chain, double* row, bool add) {
  const int64_t nU = (int64_t)L * (L + 1) / 2;
  if (i == q1 - 1) {
    put(row + nU + L, G, add);
    return;
  }
  int pa;
  double a0, a1;
  const bool two_a = row_params(i, chain, &pa, &a0, &a1);
  if (j == q1 - 1) {
    put(row + nU + pa, __dmul_rn(a0, G), add);
    if (two_a) put(row + nU + pa + 1, __dmul_rn(a1, G), add);
    return;
  }
  int pb;
  double b0, b1;
  const bool two_b = row_params(j, chain, &pb, &b0, &b1);
  auto term = [&](int p, double cp, int q, double cq) {
    const int lo = min(p, q), hi = max(p, q);
    put(row + upper_off(lo, L) + (hi - lo), __dmul_rn(__dmul_rn(cp, cq), G), add);
  };
  term(pa, a0, pb, b0);
  if (two_b) term(pa, a0, pb + 1, b1);
  if (two_a) {
    if (i != j) term(pa + 1, a1, pb, b0);
    if (two_b) term(pa + 1, a1, pb + 1, b1);
  }
}

// the root of epilogue B: the channels' poison first, then f, g and JtJ
// (both triangles; the tau and scattering-index rows and columns the
// poison alone)
__device__ void root_normal(const double* child, int nc, int ng, int64_t W, double* part,
                            double* pt, double* __restrict__ f, double* __restrict__ g,
                            double* __restrict__ JtJ) {
  const int L = 6 * ng + 1, P = 6 * ng + 3;
  const int64_t nU = (int64_t)L * (L + 1) / 2;
  if (threadIdx.x == 0) {
    double p = 0.0;
    for (int k = 0; k < nc; ++k) p = __dadd_rn(p, __ldcg(child + k * W + W - 1));
    *pt = p;
  }
  __syncthreads();
  const double ptot = *pt;
  auto pidx = [](int p) { return p == 0 ? 0 : p + 1; };
  node_sum(child, nc, W, W - 1, part, [&](int64_t o, double v) {
    if (o < nU) {
      int p, q;
      upper_pq(o, L, &p, &q);
      const int a = pidx(p), b = pidx(q);
      const double val = __dadd_rn(v, ptot);
      JtJ[(int64_t)a * P + b] = val;
      JtJ[(int64_t)b * P + a] = val;
    } else if (o < nU + L) {
      g[pidx((int)(o - nU))] = __dsub_rn(0.0, __dadd_rn(v, ptot));
    } else {
      *f = v;
    }
  });
  for (int k = threadIdx.x; k < P; k += blockDim.x) {
    JtJ[P + k] = JtJ[(int64_t)k * P + 1] = ptot;
    JtJ[(int64_t)(P - 1) * P + k] = JtJ[(int64_t)k * P + P - 1] = ptot;
  }
  if (threadIdx.x == 0) g[1] = g[P - 1] = __dsub_rn(0.0, ptot);
}

// -- the warp layout: 1-2 components ------------------------------------------

template <int NG>
__global__ void __launch_bounds__(kSmallThreads, 4)
gauss_normal_warp_kernel(const double* __restrict__ params, const double* __restrict__ data,
                         const double* __restrict__ errs, int64_t erow, int ebin,
                         const double* __restrict__ bins, const double* __restrict__ freqs,
                         int nchan, int nbin, double nu_ref, double fwhm, Laws laws, Tree tr,
                         int64_t nrows, int ncnt, double* __restrict__ scratch,
                         int* __restrict__ counters, double* __restrict__ f,
                         double* __restrict__ g, double* __restrict__ JtJ) {
  constexpr int Q1 = 3 * NG + 2, NE = Q1 * (Q1 + 1) / 2, L = 6 * NG + 1, P = 6 * NG + 3;
  constexpr int kW = kSmallThreads / 32;
  __shared__ double cmean[NG], cisig[NG], camp[NG], ciwid[NG], cchain[6 * NG];
  __shared__ int clive[NG];
  __shared__ double wsum[kW][NE];
  __shared__ double part[kSmallThreads];
  __shared__ double pt;
  __shared__ int last;
  const int ch = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int64_t W = row_width(NG);
  const double* prm = params + (int64_t)b * P;
  const Comp s{cmean, cisig, camp, ciwid, cchain, clive};
  const double* drow = data + (int64_t)ch * nbin;
  const double* erw = errs + (int64_t)ch * erow;
  // the first four of the thread's bins load while the components evolve;
  // each later four while the four before them are summed
  Bins4 cur;
  load4(cur, t, kSmallThreads, nbin, bins, drow, erw, ebin);
  if (t < NG) setup_component(prm, t, freqs[ch], nu_ref, fwhm, laws, s);
  __syncthreads();

  const double dc = prm[0];
  double acc[NE];
#pragma unroll
  for (int k = 0; k < NE; ++k) acc[k] = 0.0;
  for (int j0 = t; j0 < nbin; j0 += 4 * kSmallThreads) {
    Bins4 nxt;
    load4(nxt, j0 + 4 * kSmallThreads, kSmallThreads, nbin, bins, drow, erw, ebin);
    // SB bins' basis values side by side, then their Gram terms in bin order
    constexpr int SB = NG == 1 ? 4 : 2;
#pragma unroll
    for (int u0 = 0; u0 < 4; u0 += SB) {
      double v[SB][Q1];
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        const double xb = cur.x[u0 + u], er = cur.e[u0 + u];
        const double w8 = ebin ? __ddiv_rn(1.0, er) : 1.0;
        double m = 0.0;
        v[u][0] = w8;
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          const double e = component<true>(xb, c, s, w8, v[u] + 2 + 3 * c, v[u] + 3 + 3 * c);
          m = __dadd_rn(m, __dmul_rn(s.amp[c], e));  // a dead component adds amp * 0
          v[u][1 + 3 * c] = __dmul_rn(e, w8);
        }
        double r = __dsub_rn(cur.d[u0 + u], __dadd_rn(dc, m));
        if (ebin) r = __ddiv_rn(r, er);
        v[u][Q1 - 1] = r;
      }
#pragma unroll
      for (int u = 0; u < SB; ++u) {
        if (j0 + (u0 + u) * kSmallThreads >= nbin) break;
        int k = 0;
#pragma unroll
        for (int a = 0; a < Q1; ++a)
#pragma unroll
          for (int c = a; c < Q1; ++c, ++k) acc[k] = fma(v[u][a], v[u][c], acc[k]);
      }
    }
    cur = nxt;
  }
#pragma unroll
  for (int k = 0; k < NE; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] = __dadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NE; ++k) wsum[w][k] = acc[k];
  }
  __syncthreads();

  double* rows = scratch + (int64_t)b * nrows * W;
  double* row = rows + (int64_t)ch * W;
  double sc = 1.0;
  if (!ebin) {
    const double ie = __ddiv_rn(1.0, erw[0]);
    sc = __dmul_rn(ie, ie);
  }
  for (int k = t; k < NE; k += kSmallThreads) {
    double G = wsum[0][k];
    for (int u = 1; u < kW; ++u) G = __dadd_rn(G, wsum[u][k]);
    int i = 0, rem = k;
    while (rem >= Q1 - i) {
      rem -= Q1 - i;
      ++i;
    }
    emit(i, i + rem, __dmul_rn(G, sc), Q1, L, cchain, row, false);
  }
  if (t == 0) row[W - 1] = channel_poison(clive, NG);
  climb(rows, counters + (int64_t)b * ncnt, ch, tr, W, part, &last,
        [&](const double* child, int nc) {
          root_normal(child, nc, NG, W, part, &pt, f + b, g + (int64_t)b * P,
                      JtJ + (int64_t)b * P * P);
        });
}

// -- the mma layout: three components and more --------------------------------

// the Gram's rows padded to whole 16-row tiles
__host__ __device__ constexpr int padded_rows(int ng) { return (3 * ng + 2 + 15) / 16 * 16; }
// own bins (3-10 components, a Gram of one or three 16 x 16 tile pairs):
// each warp of a four-warp block sums its own rounds of 32 bins into every
// pair; beyond, an eight-warp block's warps share chunks of 32 bins and the
// pairs are dealt out
__host__ __device__ constexpr bool own_bins(int ng) { return padded_rows(ng) <= 32; }
constexpr int kChunkBins = 32;                // bins a round or a chunk stages
constexpr int kStageStride = kChunkBins + 4;  // a staged row [doubles]: 4 mod 16, no bank conflicts
constexpr int kOwnWarps = 4;

template <bool kOwn>
struct MmaShape {
  static constexpr int kWarps = kOwn ? kOwnWarps : kMmaWarps;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSlots = kOwn ? 4 : 8;  // lanes splitting a bin's components
};

// the doubles staged: a slice of every row a warp (and room for the warps'
// partial pairs) with own bins, else two chunks of all rows of a one-panel
// Gram or of two row blocks
__host__ __device__ constexpr int staged_doubles(int ng) {
  return own_bins(ng) ? (kOwnWarps * padded_rows(ng) * kStageStride > kOwnWarps * 32 * 8
                             ? kOwnWarps * padded_rows(ng) * kStageStride
                             : kOwnWarps * 32 * 8)
                      : 2 * (padded_rows(ng) <= kPanelRows ? padded_rows(ng) : 2 * kPanelRows) *
                            kStageStride;
}

// the mma layout's shared memory: ten doubles a component (its evolved
// values and chain factors), the staged bins, four doubles, an int a
// component and four more
constexpr int64_t mma_smem(int ng) {
  return 8 * (10 * (int64_t)ng + staged_doubles(ng) + 4) + 4 * ((int64_t)ng + 4);
}

// the most components each epilogue takes: the mma layout's shared memory
// grows by 84 bytes a component once its panels are two full row blocks
constexpr int kMaxNgauss = 1888;
static_assert(mma_smem(kMaxNgauss) <= kSmemMax && mma_smem(kMaxNgauss + 1) > kSmemMax,
              "kMaxNgauss: the most components a block's shared memory holds");

// kPairs: the tile pairs a warp holds (own bins: every pair of the Gram,
// one at 3-4 components, three at 5-10; shared: at most two of a panel's)
template <bool kOwn, int kPairs>
__global__ void __launch_bounds__(MmaShape<kOwn>::kThreads, kOwn ? 4 : 2)
gauss_normal_mma_kernel(const double* __restrict__ params, const double* __restrict__ data,
                        const double* __restrict__ errs, int64_t erow, int ebin,
                        const double* __restrict__ bins, const double* __restrict__ freqs,
                        int ng, int nchan, int nbin, double nu_ref, double fwhm, Laws laws,
                        int cpb, Tree tr, int64_t nrows, int ncnt,
                        double* __restrict__ scratch, int* __restrict__ counters,
                        double* __restrict__ f, double* __restrict__ g,
                        double* __restrict__ JtJ) {
  using Shape = MmaShape<kOwn>;
  constexpr int kWarps = Shape::kWarps, kThreads = Shape::kThreads;
  constexpr int CS = Shape::kSlots, ST = kStageStride;
  constexpr int NB = kOwn ? 4 : 1;  // bins a lane forms at once
  constexpr int R = kPanelRows;
  extern __shared__ double smem[];
  const int q1 = 3 * ng + 2, q1s = padded_rows(ng), L = 6 * ng + 1, P = 6 * ng + 3;
  const int64_t W = row_width(ng);
  const int smax = q1s <= R ? q1s : 2 * R;
  Comp s;
  s.mean = smem;
  s.isig = s.mean + ng;
  s.amp = s.isig + ng;
  s.iwid = s.amp + ng;
  s.chain = s.iwid + ng;
  double* buf = s.chain + 6 * ng;  // the staged bins
  double* scal = buf + staged_doubles(ng);
  s.live = (int*)(scal + 4);
  int* iflag = s.live + ng;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y, leaf = blockIdx.x;
  const int ch0 = leaf * cpb, ch1 = min(nchan, ch0 + cpb);
  const double* prm = params + (int64_t)b * P;
  double* rows = scratch + (int64_t)b * nrows * W;
  double* row = rows + (int64_t)leaf * W;
  const int nblk = (q1s + R - 1) / R;
  // own bins: this lane's bins jj + 8u (u < 4) of each of its warp's
  // rounds, in the warp's slice; shared: bin jb of each chunk
  const int jj = lane / CS, cs = lane % CS, jb = warp * (32 / CS) + jj;
  const int tg = kOwn ? 0 : warp, ngrp = kOwn ? 1 : kWarps;
  double* wbuf = kOwn ? buf + warp * q1s * ST : buf;
  const double dc = prm[0];

  for (int ch = ch0; ch < ch1; ++ch) {
    const bool add = ch != ch0;
    __syncthreads();  // the previous channel's readers are done
    for (int c = t; c < ng; c += kThreads) setup_component(prm, c, freqs[ch], nu_ref, fwhm, laws, s);
    __syncthreads();
    if (t == 0) put(row + W - 1, channel_poison(s.live, ng), add);
    const double* drow = data + (int64_t)ch * nbin;
    const double* erw = errs + (int64_t)ch * erow;
    double sc = 1.0;
    if (!ebin) {
      const double ie = __ddiv_rn(1.0, erw[0]);
      sc = __dmul_rn(ie, ie);
    }

    for (int I = 0; I < nblk; ++I)
      for (int J = I; J < nblk; ++J) {
        const int rI = I * R, nI = min(R, q1s - rI), rJ = J * R, nJ = min(R, q1s - rJ);
        const bool diag = I == J, last = J == nblk - 1;
        const int nm = nI / 16, np = nJ / 16;
        int npair = 0;
        for (int mi = 0; mi < nm; ++mi) npair += diag ? np - mi : np;
        auto slot = [&](int q) {
          if (q >= rI && q < rI + nI) return q - rI;
          if (!diag && q >= rJ && q < rJ + nJ) return nI + q - rJ;
          return -1;
        };
        // this warp's pairs of 16 x 8 tiles (16 rows, 16 columns: one a
        // fragment, two b) tg, tg + ngrp, ...: the shared-memory offsets of
        // their fragments' rows and their first rows and columns in G
        const int npw = npair > tg ? min(kPairs, (npair - tg + ngrp - 1) / ngrp) : 0;
        int aoff[kPairs], boff[kPairs], ti[kPairs], tj[kPairs];
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          int mi = 0, rem = tg + u * ngrp;
          if (rem >= npair) {
            rem = 0;
          } else if (diag) {
            while (rem >= np - mi) {
              rem -= np - mi;
              ++mi;
            }
            rem += mi;
          } else {
            mi = rem / np;
            rem %= np;
          }
          aoff[u] = (16 * mi + gq) * ST + tq;
          boff[u] = ((diag ? 0 : nI) + 16 * rem + gq) * ST + tq;
          ti[u] = rI + 16 * mi + gq;
          tj[u] = rJ + 16 * rem + 2 * tq;
        }
        double acc[kPairs][2][4];
#pragma unroll
        for (int u = 0; u < kPairs; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][h][e] = 0.0;
        // the padding rows (the last block's, after r) stay zero
        if (last) {
          const int npad = q1s - q1, nstage = kOwn ? kWarps : 2;
          const int per = kOwn ? q1s * ST : smax * ST;
          for (int e = t; e < nstage * npad * ST; e += kThreads) {
            const int part = e / (npad * ST), rem = e % (npad * ST);
            buf[part * per + slot(q1 + rem / ST) * ST + rem % ST] = 0.0;
          }
          if (kOwn) __syncthreads();
        }
        // the components this panel forms: all of them (the model) where
        // it holds r, else those with rows in blocks I and J
        int ca0 = 0, ca1 = ng, cb0 = 0, cb1 = 0;
        if (!last) {
          ca0 = max(0, (rI - 1) / 3);
          ca1 = min(ng, (rI + nI + 1) / 3);
          if (!diag) {
            cb0 = max(0, (rJ - 1) / 3);
            cb1 = min(ng, (rJ + nJ + 1) / 3);
          }
        }
        const int na = ca1 - ca0, ncomp = na + cb1 - cb0;
        // NB bins' basis values into columns col[] of staged rows S (this
        // lane's share of their components, the bins' chains side by side;
        // r and row 0 by slot 0)
        auto form = [&](double* S, const int (&col)[NB], const bool (&have)[NB],
                        const double (&xb)[NB], const double (&d)[NB], const double (&er)[NB]) {
          double w8[NB], pm[NB];
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            w8[u] = ebin ? __ddiv_rn(1.0, er[u]) : 1.0;
            pm[u] = 0.0;
          }
#pragma unroll 2
          for (int k = cs; k < ncomp; k += CS) {
            const int c = k < na ? ca0 + k : cb0 + k - na;
            const int s1 = slot(1 + 3 * c), s2 = slot(2 + 3 * c), s3 = slot(3 + 3 * c);
            const double amp = s.amp[c];
#pragma unroll
            for (int u = 0; u < NB; ++u) {
              double vl, vw;
              const double e = component<true>(xb[u], c, s, w8[u], &vl, &vw);
              pm[u] = __dadd_rn(pm[u], __dmul_rn(amp, e));  // a dead component adds amp * 0
              if (s1 >= 0) S[s1 * ST + col[u]] = have[u] ? __dmul_rn(e, w8[u]) : 0.0;
              if (s2 >= 0) S[s2 * ST + col[u]] = have[u] ? vl : 0.0;
              if (s3 >= 0) S[s3 * ST + col[u]] = have[u] ? vw : 0.0;
            }
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            if (last) {
#pragma unroll
              for (int off = 1; off < CS; off <<= 1)
                pm[u] = __dadd_rn(pm[u], __shfl_xor_sync(0xffffffffu, pm[u], off));
            }
            if (cs == 0) {
              if (I == 0) S[col[u]] = have[u] ? w8[u] : 0.0;
              if (last) {
                double r = __dsub_rn(d[u], __dadd_rn(dc, pm[u]));
                if (ebin) r = __ddiv_rn(r, er[u]);
                S[slot(q1 - 1) * ST + col[u]] = have[u] ? r : 0.0;
              }
            }
          }
        };
        // the 32 staged bins of S (four k-steps) into this warp's pairs
        auto sum_pairs = [&](const double* S) {
#pragma unroll
          for (int ks = 0; ks < kChunkBins / 8; ++ks)
#pragma unroll
            for (int u = 0; u < kPairs; ++u) {
              if (u < npw) {
                const double* A = S + aoff[u] + 8 * ks;
                const double* Bt = S + boff[u] + 8 * ks;
                const double a[4] = {A[0], A[8 * ST], A[4], A[8 * ST + 4]};
                const double b0[2] = {Bt[0], Bt[4]};
                const double b1[2] = {Bt[8 * ST], Bt[8 * ST + 4]};
                mma_f64(acc[u][0], a, b0);
                mma_f64(acc[u][1], a, b1);
              }
            }
        };
        const int nround = (nbin + kChunkBins - 1) / kChunkBins;
        if (kOwn) {
          // this warp's rounds warp, warp + 4, ...: four bins a lane, the
          // next round's data loading while this one is summed
          double dn[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = warp * kChunkBins + jj + 8 * u;
            dn[u] = j < nbin ? __ldg(drow + j) : 0.0;
          }
          for (int rd = warp; rd < nround; rd += kWarps) {
            double dc4[NB];
#pragma unroll
            for (int u = 0; u < NB; ++u) {
              dc4[u] = dn[u];
              const int j = (rd + kWarps) * kChunkBins + jj + 8 * u;
              dn[u] = j < nbin ? __ldg(drow + j) : 0.0;
            }
            int col[NB];
            bool have[NB];
            double xb[NB], er[NB];
#pragma unroll
            for (int u = 0; u < NB; ++u) {
              const int j = rd * kChunkBins + jj + 8 * u;
              col[u] = jj + 8 * u;
              have[u] = j < nbin;
              xb[u] = have[u] ? __ldg(bins + j) : 0.0;
              er[u] = (have[u] && ebin) ? __ldg(erw + (int64_t)j * ebin) : 1.0;
            }
            form(wbuf, col, have, xb, dc4, er);
            __syncwarp();
            sum_pairs(wbuf);
            __syncwarp();
          }
        } else {
          // chunks of 32 bins, bin jb of each by this lane, the next
          // chunk's loading while this one is formed
          double nx = 0.0, nd = 0.0, ne = 1.0;
          if (jb < nbin) {
            nx = __ldg(bins + jb);
            nd = __ldg(drow + jb);
            if (ebin) ne = __ldg(erw + (int64_t)jb * ebin);
          }
          for (int kc = 0; kc < nround; ++kc) {
            double* B = buf + (kc & 1) * smax * ST;
            const bool have = kc * kChunkBins + jb < nbin;
            const double xb = nx, d = nd, er = ne;
            const int jn = (kc + 1) * kChunkBins + jb;
            if (jn < nbin) {
              nx = __ldg(bins + jn);
              nd = __ldg(drow + jn);
              if (ebin) ne = __ldg(erw + (int64_t)jn * ebin);
            }
            const int col[NB] = {jb};
            const bool hv[NB] = {have};
            const double x1[NB] = {xb}, d1[NB] = {d}, e1[NB] = {er};
            form(B, col, hv, x1, d1, e1);
            __syncthreads();
            sum_pairs(B);
          }
        }
        __syncthreads();  // the staged bins are read before they are written again
        // the Gram entries this warp holds (own bins: every warp's partial
        // pairs, added in warp order by warp u % 4 for pair u) into the row
        auto emit_pair = [&](int u, const double (&v)[2][4]) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = ti[u] + (e >= 2 ? 8 : 0), j = tj[u] + 8 * h + (e & 1);
              if (i <= j && j < q1)
                emit(i, j, __dmul_rn(v[h][e], sc), q1, L, s.chain, row, add);
            }
        };
        if (kOwn) {
#pragma unroll
          for (int u = 0; u < kPairs; ++u) {
            if (u < npw) {
#pragma unroll
              for (int e = 0; e < 8; ++e) buf[(warp * 32 + lane) * 8 + e] = acc[u][e / 4][e % 4];
              __syncthreads();
              if (warp == u % kWarps) {
                double v[2][4];
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  double x = buf[lane * 8 + e];
                  for (int w = 1; w < kWarps; ++w) x = __dadd_rn(x, buf[(w * 32 + lane) * 8 + e]);
                  v[e / 4][e % 4] = x;
                }
                emit_pair(u, v);
              }
              __syncthreads();
            }
          }
        } else {
#pragma unroll
          for (int u = 0; u < kPairs; ++u)
            if (u < npw) emit_pair(u, acc[u]);
        }
      }
  }
  climb(rows, counters + (int64_t)b * ncnt, leaf, tr, W, buf, iflag,
        [&](const double* child, int nc) {
          root_normal(child, nc, ng, W, buf, scal, f + b, g + (int64_t)b * P,
                      JtJ + (int64_t)b * P * P);
        });
}

// -- epilogue A ---------------------------------------------------------------

__global__ void __launch_bounds__(kSmallThreads)
gauss_sse_kernel(const double* __restrict__ params, const double* __restrict__ data,
                 const double* __restrict__ errs, int64_t erow, int ebin,
                 const double* __restrict__ bins, const double* __restrict__ freqs, int ng,
                 int nchan, int nbin, double nu_ref, double fwhm, Laws laws, Tree tr,
                 int64_t nrows, int ncnt, double* __restrict__ scratch,
                 int* __restrict__ counters, double* __restrict__ f) {
  extern __shared__ double smem[];
  __shared__ double wpart[kSmallThreads / 32];
  __shared__ double part[kSmallThreads];
  __shared__ int last;
  const int ch = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t & 31;
  const int P = 6 * ng + 3;
  Comp s;
  s.mean = smem;
  s.isig = s.mean + ng;
  s.amp = s.isig + ng;
  s.iwid = s.amp + ng;
  s.chain = nullptr;
  s.live = (int*)(s.iwid + ng);
  const double* prm = params + (int64_t)b * P;
  const double* drow = data + (int64_t)ch * nbin;
  const double* erw = errs + (int64_t)ch * erow;
  // the first four of the thread's bins load while the components evolve;
  // each later four while the four before them are summed
  Bins4 cur;
  load4(cur, t, kSmallThreads, nbin, bins, drow, erw, ebin);
  for (int c = t; c < ng; c += kSmallThreads)
    setup_component(prm, c, freqs[ch], nu_ref, fwhm, laws, s);
  __syncthreads();
  const double dc = prm[0];
  double ss = 0.0;
  for (int j0 = t; j0 < nbin; j0 += 4 * kSmallThreads) {
    Bins4 nxt;
    load4(nxt, j0 + 4 * kSmallThreads, kSmallThreads, nbin, bins, drow, erw, ebin);
    // the four bins' models side by side, then their r^2 in bin order
    double m[4] = {0.0, 0.0, 0.0, 0.0};
    for (int c = 0; c < ng; ++c) {
      const double amp = s.amp[c];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        m[u] = __dadd_rn(m[u], __dmul_rn(amp, component<false>(cur.x[u], c, s, 1.0, nullptr,
                                                                nullptr)));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j0 + u * kSmallThreads >= nbin) break;
      double r = __dsub_rn(cur.d[u], __dadd_rn(dc, m[u]));
      if (ebin) r = __ddiv_rn(r, cur.e[u]);
      ss = __dadd_rn(ss, __dmul_rn(r, r));
    }
    cur = nxt;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __dadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (lane == 0) wpart[t >> 5] = ss;
  __syncthreads();
  double* rows = scratch + (int64_t)b * nrows;
  if (t == 0) {
    double v = wpart[0];
    for (int u = 1; u < kSmallThreads / 32; ++u) v = __dadd_rn(v, wpart[u]);
    if (!ebin) {
      const double ie = __ddiv_rn(1.0, erw[0]);
      v = __dmul_rn(v, __dmul_rn(ie, ie));
    }
    rows[ch] = v;
  }
  climb(rows, counters + (int64_t)b * ncnt, ch, tr, 1, part, &last,
        [&](const double* child, int nc) {
          node_sum(child, nc, 1, 1, part, [&](int64_t, double v) { f[b] = v; });
        });
}

// epilogue A's shared memory: four doubles and an int a component
constexpr int64_t sse_smem(int ng) { return 36 * (int64_t)ng; }
constexpr int kSseMaxNgauss = 6456;
static_assert(sse_smem(kSseMaxNgauss) <= kSmemMax && sse_smem(kSseMaxNgauss + 1) > kSmemMax,
              "kSseMaxNgauss: the most components a block's shared memory holds");

// a launch's geometry, from the components, the channels and the epilogue
// (normal: B): the doubles in a row of sums, the channels a block, the
// channel tree, a lane's scratch rows and counters, and the dynamic shared
// memory a block takes.  pp_gauss_sizes gives it to the wrapper, which
// allocates scratch and counters from it.
struct Geometry {
  int64_t width, rows, smem;
  int cpb, counters;
  Tree tr;
};

Geometry geometry(int ng, int nchan, bool normal) {
  Geometry gm;
  gm.width = normal ? row_width(ng) : 1;
  gm.cpb = 1;
  if (normal && ng > kWarpNgauss) {
    const int64_t bytes = (int64_t)nchan * 8 * gm.width;
    gm.cpb = (int)((bytes + kRowBudget - 1) / kRowBudget);
  }
  const int nleaf = (nchan + gm.cpb - 1) / gm.cpb;
  const int64_t wide = kFanDoubles / gm.width;
  gm.tr = Tree{nleaf, (int)std::max<int64_t>(kFan, std::min<int64_t>(nleaf, wide))};
  tree_sizes(gm.tr, &gm.rows, &gm.counters);
  gm.smem = !normal ? sse_smem(ng) : (ng <= kWarpNgauss ? 0 : mma_smem(ng));
  return gm;
}

}  // namespace

// The geometry of a launch at ngauss components and nchan channels, for
// epilogue B (normal != 0) or A, into sizes[6] (int64): the doubles in a row
// of sums, a lane's scratch rows and counters, the channels a block, the
// channel tree's fan-in and the dynamic shared memory a block takes.  The
// wrapper allocates scratch [B, rows, width] f64 and counters [B, counters]
// int32 from it.  Returns cudaErrorInvalidValue past the epilogue's
// component limit (kMaxNgauss, kSseMaxNgauss).
extern "C" int pp_gauss_sizes(int ngauss, int nchan, int normal, void* sizes) {
  if (ngauss < 1 || nchan < 1 || ngauss > (normal ? kMaxNgauss : kSseMaxNgauss))
    return (int)cudaErrorInvalidValue;
  const Geometry gm = geometry(ngauss, nchan, normal != 0);
  int64_t* out = (int64_t*)sizes;
  out[0] = gm.width;
  out[1] = gm.rows;
  out[2] = gm.counters;
  out[3] = gm.cpb;
  out[4] = gm.tr.fan;
  out[5] = gm.smem;
  return 0;
}

// params [B, 6 ngauss + 3], data [nchan, nbin], errs [nchan, nbin] through
// its strides (errs_row, errs_bin: 0 for per-channel errors broadcast over
// the bins, else 1), bins [nbin] (bin centres), freqs [nchan], all f64;
// nu_ref; fwhm = 2 sqrt(2 ln 2); the model-code digits of loc, wid and amp
// (0 power law, 1 linear); scratch and counters as pp_gauss_sizes gives
// them (the counters zero before the first call; every call leaves them
// zero); f [B], g [B, P], JtJ [B, P, P] f64 out.  One launch on `stream`;
// returns the first cudaError_t.
extern "C" int pp_gauss_normal(const void* params, const void* data, const void* errs,
                               int64_t errs_row, int errs_bin, const void* bins,
                               const void* freqs, int B, int ngauss, int nchan, int nbin,
                               double nu_ref, double fwhm, int law_loc, int law_wid,
                               int law_amp, void* scratch, void* counters, void* f, void* g,
                               void* JtJ, void* stream) {
  if (B <= 0 || nchan <= 0 || nbin <= 0) return 0;
  if (ngauss < 1 || ngauss > kMaxNgauss || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Laws laws{law_loc, law_wid, law_amp};
  const Geometry gm = geometry(ngauss, nchan, true);
  const double *pp = (const double*)params, *dd = (const double*)data, *ee = (const double*)errs;
  const double *bb = (const double*)bins, *ff = (const double*)freqs;
  double *sc = (double*)scratch, *fo = (double*)f, *go = (double*)g, *jo = (double*)JtJ;
  int* cn = (int*)counters;
  if (ngauss <= kWarpNgauss) {
    const dim3 grid(nchan, B);
    if (ngauss == 1)
      gauss_normal_warp_kernel<1><<<grid, kSmallThreads, 0, st>>>(
          pp, dd, ee, errs_row, errs_bin, bb, ff, nchan, nbin, nu_ref, fwhm, laws, gm.tr,
          gm.rows, gm.counters, sc, cn, fo, go, jo);
    else
      gauss_normal_warp_kernel<2><<<grid, kSmallThreads, 0, st>>>(
          pp, dd, ee, errs_row, errs_bin, bb, ff, nchan, nbin, nu_ref, fwhm, laws, gm.tr,
          gm.rows, gm.counters, sc, cn, fo, go, jo);
    return (int)cudaGetLastError();
  }
  const dim3 grid(gm.tr.nleaf, B);
  // one instantiation per (own bins, pairs a warp holds)
  auto run = [&](auto kernel, int threads) {
    cudaError_t err = set_smem((const void*)kernel, gm.smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, gm.smem, st>>>(pp, dd, ee, errs_row, errs_bin, bb, ff, ngauss, nchan,
                                           nbin, nu_ref, fwhm, laws, gm.cpb, gm.tr, gm.rows,
                                           gm.counters, sc, cn, fo, go, jo);
    return cudaSuccess;
  };
  cudaError_t err;
  if (!own_bins(ngauss))
    err = run(gauss_normal_mma_kernel<false, 2>, MmaShape<false>::kThreads);
  else if (padded_rows(ngauss) == 16)
    err = run(gauss_normal_mma_kernel<true, 1>, MmaShape<true>::kThreads);
  else
    err = run(gauss_normal_mma_kernel<true, 3>, MmaShape<true>::kThreads);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the same arguments without g and JtJ (epilogue A: a leaf a channel, rows
// of one double); one launch.
extern "C" int pp_gauss_sse(const void* params, const void* data, const void* errs,
                            int64_t errs_row, int errs_bin, const void* bins,
                            const void* freqs, int B, int ngauss, int nchan, int nbin,
                            double nu_ref, double fwhm, int law_loc, int law_wid, int law_amp,
                            void* scratch, void* counters, void* f, void* stream) {
  if (B <= 0 || nchan <= 0 || nbin <= 0) return 0;
  if (ngauss < 1 || ngauss > kSseMaxNgauss || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Geometry gm = geometry(ngauss, nchan, false);
  cudaError_t err = set_smem((const void*)gauss_sse_kernel, gm.smem);
  if (err != cudaSuccess) return (int)err;
  const Laws laws{law_loc, law_wid, law_amp};
  gauss_sse_kernel<<<dim3(nchan, B), kSmallThreads, gm.smem, st>>>(
      (const double*)params, (const double*)data, (const double*)errs, errs_row, errs_bin,
      (const double*)bins, (const double*)freqs, ngauss, nchan, nbin, nu_ref, fwhm, laws, gm.tr,
      gm.rows, gm.counters, (double*)scratch, (int*)counters, (double*)f);
  return (int)cudaGetLastError();
}
