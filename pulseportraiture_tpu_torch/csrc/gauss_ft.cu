// K10: the scattered and joined Gaussian portrait fit's sum of squares,
// gradient and normal matrix, from the spectra of the Jacobian's columns, with
// no Jacobian formed.
//
// Replaces, on ppgauss's fits with tau nonzero or fitted (--fitscat,
// --fitalpha, --tau) and on its joined fits (-j), the forward-mode Jacobian
// of the JAX reference's Levenberg-Marquardt loop,
// pulseportraiture_tpu/fit/lm.py:60 ``jac = jax.jacfwd(res)``, and the
// products it feeds: J.T @ r and J.T @ J in normal_step (:67-79) and in the
// covariance (:129-139).  The residual is pulseportraiture_tpu/fit/gauss.py:
// 124-131, whose model is ops/profiles.py:141 gen_gaussian_portrait: the
// unscattered portrait G (gauss.cu's header), then, where tau != 0,
// irfft(S rfft(G)) with S_c(k) = 1 / (1 + 2 pi i k tau_c) and
// tau_c = (tau / nbin) (nu_c / nu_ref)^alpha (:190-196), then for each join
// group irfft(R rfft(.)) in that group's channels with
// R_c(k) = exp(2 pi i frac(shift_c k)), shift_c = phi_j + Dconst DM_j / P
// (nu_c^-2 - nu_ref^-2) (:198-203, ops/fourier.py:188 phasor, :237
// rotate_data).
//
// Arithmetic.  A lane's parameters (a row of params [B, P], P = 6 ngauss + 3
// + 2 njoin): dc, tau, (loc0, dloc, wid0, dwid, amp0, damp) per component,
// the scattering index alpha, then (phi, DM) per join group.  At channel c
// every column of J is a chain factor times one of these rows, each known on
// the harmonic grid k = 0 .. N/2 (N = nbin) from the rFFTs B^ of the
// component basis rows (e, amp e z / sigma, amp e z^2 / wid, as gauss.cu
// forms them) and G^ of G:
//   dc     N delta_k0                    chain 1
//   basis  R S B^                        gauss.cu's six chain factors a component
//   tau    R (-2 pi i k S^2) G^          d tau_c / d tau, d tau_c / d alpha
//   join   2 pi i k R S G^               1, Dconst / P (nu_c^-2 - nu_ref^-2)
//   r      D^ - R S G^                   D^ = rfft(data), formed once a fit
// irfft drops the imaginary part at k = 0 and at k = N/2 after each stage, so
// each product is projected to its real part there, stage by stage: at N/2 a
// basis row is Re R Re S B^, the tau row Re R Re(dS) G^ and the join row
// -2 pi k Im R Re S G^.  S = 1 where tau == 0: the reference's where selects
// the unscattered model, so the tau and alpha columns, their chain factors
// and the tau row are exactly 0 there; R = 1 outside every join group, whose
// channels have no join column (the join row is 0).  Each spectrum is packed
// half-complex into N reals (Re at k = 0 .. N/2, Im at k = 1 .. N/2 - 1, the
// interior times sqrt 2, all over sqrt N), so the real Gram of two packed rows
// is the bin domain's dot product (Parseval).  With the errors one value a
// channel (ppgauss's), the channel's Gram of these q1 = 3 ngauss + 4 rows,
// times 1 / err^2, holds everything, as in gauss.cu: JtJ_pq = sum_c a_p a_q
// G_{q(p) q(q)}, g_p = -sum_c a_p G_{q(p) r}, f = sum_c G_rr.  A power law's
// p0 = 0 poisons a channel as in gauss.cu (forward-mode's NaN tangent goes
// through the transforms to every bin), so every g and JtJ entry is NaN.
//
// Design.  Epilogue B is one launch where a channel's stored rows (3 ngauss
// basis rows, tau, join and r, packed; the dc row is implicit) fit the
// shared memory of a thread-block cluster of at most kMaxCluster blocks
// with at most kMaxBatches transform batches a block (the path rule,
// onchip): gauss_ft_gram_cluster_kernel, a cluster a (channel, lane), no
// row through device memory.  Each block owns a share of the harmonics
// and holds every row's packed reals there.  The blocks share the basis
// rows, transform them in batches (K8's Stockham radix-4 passes,
// fft_block.cuh, a batch's rows behind one barrier a pass, pairs of passes
// done in registers) from one pass over a component's exps, and write each
// raw harmonic to the block that owns it (distributed shared memory).
// Each block then finishes its harmonics: the factors S, dS and R once,
// the portrait's spectrum G^ from the e rows by linearity (dc N delta_k0 +
// sum_c amp_c e^_c, so G is never formed in the bins or transformed), the
// tau, join and residual rows, each basis row times R S, the packing
// weights.  Its Gram runs on all eight warps (16 x 16 tile pairs on the
// FP64 tensor cores, mma.sync m16n8k8, the reals split among the warps
// where the pairs are fewer than eight); each entry is summed over the
// splits in order, then over the ranks in order, and put through the
// chain rule into the channel's row of per-lane sums over all P
// parameters; then K9's channel tree of last-block counters (reset by the
// kernel; no atomics on sums: the same inputs give the same bits).
// Elsewhere (from 5 components at 2048 bins, 3 at 4096, 1 at 8192)
// epilogue B is two launches: gauss_ft_rows_kernel, a block of 256
// threads per (channel, lane, part): part 0 forms G in the bins,
// transforms it in shared memory and from G^ writes the tau, join and
// residual rows; part 1 + c forms component c's three basis rows one after
// another, transforms each and multiplies it by the channel's R S, tabled
// once a block; every row goes packed into a staging tensor [B, nchan, 3
// ngauss + 3, N] in device memory; gauss_ft_gram_kernel is K9's mma layout
// on the staged rows: eight warps share chunks of 32 packed reals of every
// row (two chunks staged, the next one's loads in flight), 64-row panels
// beyond 20 components, the dc row made in the block, the chain rule per
// Gram entry into the row of sums (zeroed by the block, then added to by
// each of its channels), and the channel tree.  Epilogue A
// (gauss_ft_sse_kernel) is one launch: a block per (channel, lane) forms
// G, transforms it, and sums the packed residual's squares by a fixed
// tree; then the channel tree.
//
// What bounds it on an H100 (see the smoke's gauss_ft_bound_ms): operations
// at every size.  A lane's channel takes 3 ngauss + 1 real transforms of N
// points (~2.5 N log2 N FP64 operations each, with the split), the basis
// rows' exps and values (~35 a bin and component, as K9), and the Gram's
// (q1 + 1) q1 / 2 multiply-adds a packed real on the FP64 tensor cores; the
// bytes are the data spectrum read once and the outputs (the staged rows are
// the design's, not the function's).  On the staged path its rows cost
// their traffic twice over; on either, the transforms' passes each a
// block barrier.
//
// Limits: nbin a power of two from kMinBins to kMaxBins (the transforms' two
// buffers and table in a block's shared memory); kMaxNgauss components (the
// Gram's staging and ten doubles and an int a component in shared memory, as
// K9's kMaxNgauss; the rows kernel's part 0 keeps five a component).  The
// wrapper raises beyond either, and fit.gauss keeps jacfwd there.  Lanes
// ride on the grid's y dimension (<= 65535), the parts on z, a cluster's
// blocks on x beside the channels.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "fft_block.cuh"
#include "gauss_common.cuh"

namespace {

constexpr int kThreads = 256;  // every kernel: eight warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBins = 64;
constexpr int kMaxBins = 8192;
constexpr int kChunk = 32;         // packed reals a chunk stages
constexpr int kStageStride = 36;   // a staged row [doubles]: 4 mod 16, no bank conflicts
constexpr double kTwoPi = 6.283185307179586;

// a lane's scattering and join rotation at one channel: tau_c (scat: tau !=
// 0) and its chain factors, the join group (grp >= 0), its shift and the
// DM's chain factor
struct Chan {
  double taus, dtau, dalpha, shift, disp;
  int grp;
  bool scat;
};

__device__ Chan chan_setup(const double* __restrict__ prm, int ng, int nbin, double nu,
                           double nu_ref, int grp, double dcp) {
  Chan c;
  const double tau = prm[1], alpha = prm[2 + 6 * ng];
  c.scat = tau != 0.0;
  c.taus = c.dtau = c.dalpha = 0.0;
  if (c.scat) {
    const double ratio = nu / nu_ref, pw = pow(ratio, alpha);
    c.taus = __dmul_rn(__ddiv_rn(tau, (double)nbin), pw);
    c.dtau = __ddiv_rn(pw, (double)nbin);
    c.dalpha = __dmul_rn(c.taus, log(ratio));
  }
  c.grp = grp;
  c.shift = c.disp = 0.0;
  if (grp >= 0) {
    const double fterm = __dsub_rn(__ddiv_rn(1.0, __dmul_rn(nu, nu)),
                                   __ddiv_rn(1.0, __dmul_rn(nu_ref, nu_ref)));
    const double* jp = prm + 3 + 6 * ng + 2 * grp;
    c.disp = __dmul_rn(dcp, fterm);
    c.shift = __dadd_rn(jp[0], __dmul_rn(__dmul_rn(dcp, jp[1]), fterm));
  }
  return c;
}

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(__dsub_rn(__dmul_rn(a.x, b.x), __dmul_rn(a.y, b.y)),
                      __dadd_rn(__dmul_rn(a.x, b.y), __dmul_rn(a.y, b.x)));
}

// harmonic k's scattering factor S (1 unscattered), its tau derivative
// dS = -2 pi i k S^2 (0 unscattered) and the rotation R (1 outside a group)
__device__ __forceinline__ void factors(const Chan& c, int k, double2* S, double2* dS,
                                        double2* R) {
  *S = make_double2(1.0, 0.0);
  *dS = make_double2(0.0, 0.0);
  *R = make_double2(1.0, 0.0);
  const double a = __dmul_rn(kTwoPi, (double)k);
  if (c.scat) {
    const double x = __dmul_rn(a, c.taus), den = __dadd_rn(1.0, __dmul_rn(x, x));
    *S = make_double2(__ddiv_rn(1.0, den), __ddiv_rn(-x, den));
    const double2 s2 = cmul(*S, *S);
    *dS = make_double2(__dmul_rn(a, s2.y), -__dmul_rn(a, s2.x));
  }
  if (c.grp >= 0) {
    double fr = fmod(__dmul_rn(c.shift, (double)k), 1.0);
    if (fr < 0.0) fr = __dadd_rn(fr, 1.0);
    double sn, cs;
    sincos(__dmul_rn(kTwoPi, fr), &sn, &cs);
    *R = make_double2(cs, sn);
  }
}

// harmonic k of a packed row: Re into k, Im into n + k (0 < k < n), times
// the Parseval weights (w0 at k = 0 and n, w1 between)
__device__ __forceinline__ void put_packed(double* __restrict__ row, int k, int n, double2 v,
                                           double w0, double w1) {
  if (k == 0 || k == n) {
    row[k] = __dmul_rn(v.x, w0);
  } else {
    row[k] = __dmul_rn(v.x, w1);
    row[n + k] = __dmul_rn(v.y, w1);
  }
}

// G = dc + sum_c amp_c e_c at every bin, into t (as doubles); s holds every
// component (live, mean, isig, amp)
__device__ void form_G(double* __restrict__ t, const double* __restrict__ bins, int nbin,
                       double dc, const Comp& s, int ng) {
  for (int j = threadIdx.x; j < nbin; j += kThreads) {
    const double xb = __ldg(bins + j);
    double m = 0.0;
    for (int c = 0; c < ng; ++c)
      m = __dadd_rn(m, __dmul_rn(s.amp[c], component<false>(xb, c, s, 1.0, nullptr, nullptr)));
    t[j] = __dadd_rn(dc, m);
  }
}

// the model's spectrum at harmonic k from G^_k = X: M = R S X, projected
// stage by stage at k = n; also Y = S X (projected) for the join row
__device__ __forceinline__ double2 model_harmonic(double2 X, int k, int n, double2 S,
                                                  double2 R, double2* Y) {
  if (k == n) {
    *Y = make_double2(__dmul_rn(S.x, X.x), 0.0);
    return make_double2(__dmul_rn(R.x, Y->x), 0.0);
  }
  *Y = cmul(S, X);
  return cmul(R, *Y);
}

// -- epilogue B, launch 1: the packed rows ------------------------------------

// the rows kernel's shared memory: the transform's two buffers, then part
// 0's five values a component or a part's table of R S and its component
constexpr int64_t rows_smem(int ng, int nbin) {
  return 16 * (int64_t)nbin + (16 * ((int64_t)nbin / 2 + 1) + 40 > 40 * (int64_t)ng
                                   ? 16 * ((int64_t)nbin / 2 + 1) + 40
                                   : 40 * (int64_t)ng);
}

__global__ void __launch_bounds__(kThreads)
gauss_ft_rows_kernel(const double* __restrict__ params, const double* __restrict__ dspec,
                     const double* __restrict__ bins, const double* __restrict__ freqs,
                     const int* __restrict__ groups, const double2* __restrict__ tw, int ng,
                     int P, int nchan, int nbin, double nu_ref, double fwhm, double dcp,
                     Laws laws, double* __restrict__ rows) {
  extern __shared__ double smem[];
  const int ch = blockIdx.x, b = blockIdx.y, part = blockIdx.z, t = threadIdx.x;
  const int n = nbin / 2, qs = 3 * ng + 3;
  const double w0 = sqrt(__ddiv_rn(1.0, (double)nbin)), w1 = sqrt(__ddiv_rn(2.0, (double)nbin));
  double2* A = reinterpret_cast<double2*>(smem);
  double2* Bf = A + n;
  const double* prm = params + (int64_t)b * P;
  const double nu = freqs[ch];
  const Chan cc = chan_setup(prm, ng, nbin, nu, nu_ref, groups[ch], dcp);
  double* out = rows + ((int64_t)b * nchan + ch) * qs * nbin;

  if (part == 0) {
    // G, its transform, and the tau, join and residual rows
    double* base = smem + 2 * (int64_t)nbin;
    const Comp s{base, base + ng, base + 2 * ng, base + 3 * ng, nullptr, (int*)(base + 4 * ng)};
    for (int c = t; c < ng; c += kThreads) setup_component(prm, c, nu, nu_ref, fwhm, laws, s);
    __syncthreads();
    form_G(reinterpret_cast<double*>(A), bins, nbin, prm[0], s, ng);
    __syncthreads();
    const double2* z = fft_block<kThreads>(A, Bf, n, nbin, tw);
    const double* drow = dspec + (int64_t)ch * nbin;
    double* trow = out + (int64_t)(3 * ng) * nbin;
    double* jrow = trow + nbin;
    double* rrow = jrow + nbin;
    for (int k = t; k <= n; k += kThreads) {
      const double2 X = split(z, k, n, tw);
      double2 S, dS, R, Y;
      factors(cc, k, &S, &dS, &R);
      const double2 M = model_harmonic(X, k, n, S, R, &Y);
      const double a = __dmul_rn(kTwoPi, (double)k);
      double2 T, Jn;
      if (k == n) {
        T = make_double2(__dmul_rn(R.x, __dmul_rn(dS.x, X.x)), 0.0);
        Jn = make_double2(-__dmul_rn(a, __dmul_rn(R.y, Y.x)), 0.0);
      } else {
        T = cmul(R, cmul(dS, X));
        Jn = make_double2(-__dmul_rn(a, M.y), __dmul_rn(a, M.x));
      }
      if (cc.grp < 0) Jn = make_double2(0.0, 0.0);  // no join column here
      put_packed(trow, k, n, T, w0, w1);
      put_packed(jrow, k, n, Jn, w0, w1);
      // r = D - M, packed: the data's row is the work's, packed already
      const double wk = (k == 0 || k == n) ? w0 : w1;
      rrow[k] = __dsub_rn(__ldg(drow + k), __dmul_rn(M.x, wk));
      if (k != 0 && k != n) rrow[n + k] = __dsub_rn(__ldg(drow + n + k), __dmul_rn(M.y, wk));
    }
    return;
  }

  // component c = part - 1: the channel's R S tabled, then its three rows
  const int c = part - 1;
  double2* C = Bf + n;
  double* base = reinterpret_cast<double*>(C + n + 1);
  const Comp s{base, base + 1, base + 2, base + 3, nullptr, (int*)(base + 4)};
  if (t == 0) setup_component(prm + 6 * c, 0, nu, nu_ref, fwhm, laws, s);
  for (int k = t; k <= n; k += kThreads) {
    double2 S, dS, R;
    factors(cc, k, &S, &dS, &R);
    C[k] = k == n ? make_double2(__dmul_rn(R.x, S.x), 0.0) : cmul(R, S);
  }
  __syncthreads();
  for (int kind = 0; kind < 3; ++kind) {
    double* x = reinterpret_cast<double*>(A);
    for (int j = t; j < nbin; j += kThreads) {
      double vl, vw;
      const double e = component<true>(__ldg(bins + j), 0, s, 1.0, &vl, &vw);
      x[j] = kind == 0 ? e : (kind == 1 ? vl : vw);
    }
    __syncthreads();
    const double2* z = fft_block<kThreads>(A, Bf, n, nbin, tw);
    double* row = out + (int64_t)(3 * c + kind) * nbin;
    for (int k = t; k <= n; k += kThreads) {
      const double2 X = split(z, k, n, tw), Ck = C[k];
      put_packed(row, k, n,
                 k == n ? make_double2(__dmul_rn(Ck.x, X.x), 0.0) : cmul(Ck, X), w0, w1);
    }
    __syncthreads();  // z is read before the next row is formed over it
  }
}

// -- epilogue B, launch 2: the Gram, the chain rule, the channel tree ---------

// a row of per-lane sums over all P parameters: JtJ's upper triangle, g
// (before its sign), f, poison
__host__ __device__ __forceinline__ int64_t row_width(int P) {
  return (int64_t)P * (P + 1) / 2 + P + 2;
}

// Gram row q's parameters and chain factors at this channel: at most two,
// their count returned (row 0 dc; then e, loc, wid per component; then the
// tau row, the join row, r)
__device__ __forceinline__ int row_params(int q, int ng, const double* chain, const Chan& cc,
                                          int* p, double* a) {
  if (q == 0) {
    p[0] = 0;
    a[0] = 1.0;
    return 1;
  }
  if (q <= 3 * ng) {
    const int c = (q - 1) / 3, k = (q - 1) % 3;
    const int base = k == 0 ? 4 : (k == 1 ? 0 : 2);  // amp, loc, wid
    p[0] = 2 + 6 * c + base;
    p[1] = p[0] + 1;
    a[0] = chain[6 * c + base];
    a[1] = chain[6 * c + base + 1];
    return 2;
  }
  if (q == 3 * ng + 1) {  // tau and alpha
    p[0] = 1;
    p[1] = 2 + 6 * ng;
    a[0] = cc.dtau;
    a[1] = cc.dalpha;
    return 2;
  }
  if (cc.grp < 0) return 0;  // the join row: the channel's group's (phi, DM)
  p[0] = 3 + 6 * ng + 2 * cc.grp;
  p[1] = p[0] + 1;
  a[0] = 1.0;
  a[1] = cc.disp;
  return 2;
}

// the chain rule on the channel's Gram entry G = G_ij (i <= j < q1), added
// to the row of sums (no other entry of the channel adds to the same sums,
// so with kAdd false, a row zeroed for this channel alone, each sum is
// stored, not read and added to)
template <bool kAdd = true>
__device__ __forceinline__ void emit(int i, int j, double G, int q1, int ng, int P,
                                     const double* chain, const Chan& cc, double* row) {
  const int64_t nU = (int64_t)P * (P + 1) / 2;
  auto add = [&](int64_t o, double v) { row[o] = kAdd ? __dadd_rn(row[o], v) : v; };
  if (i == q1 - 1) {
    add(nU + P, G);
    return;
  }
  int pa[2], pb[2];
  double a[2], bb[2];
  const int na = row_params(i, ng, chain, cc, pa, a);
  if (j == q1 - 1) {
    for (int u = 0; u < na; ++u) add(nU + pa[u], __dmul_rn(a[u], G));
    return;
  }
  const int nb = row_params(j, ng, chain, cc, pb, bb);
  for (int u = 0; u < na; ++u)
    for (int v = 0; v < nb; ++v) {
      if (i == j && v < u) continue;
      const int lo = min(pa[u], pb[v]), hi = max(pa[u], pb[v]);
      add(upper_off(lo, P) + (hi - lo), __dmul_rn(__dmul_rn(a[u], bb[v]), G));
    }
}

// the root: the channels' poison first, then f, g and JtJ (both triangles)
__device__ void root_normal(const double* child, int nc, int P, int64_t W, double* part,
                            double* pt, double* __restrict__ f, double* __restrict__ g,
                            double* __restrict__ JtJ) {
  const int64_t nU = (int64_t)P * (P + 1) / 2;
  if (threadIdx.x == 0) {
    double p = 0.0;
    for (int k = 0; k < nc; ++k) p = __dadd_rn(p, __ldcg(child + k * W + W - 1));
    *pt = p;
  }
  __syncthreads();
  const double ptot = *pt;
  node_sum(child, nc, W, W - 1, part, [&](int64_t o, double v) {
    if (o < nU) {
      int p, q;
      upper_pq(o, P, &p, &q);
      const double val = __dadd_rn(v, ptot);
      JtJ[(int64_t)p * P + q] = val;
      JtJ[(int64_t)q * P + p] = val;
    } else if (o < nU + P) {
      g[o - nU] = __dsub_rn(0.0, __dadd_rn(v, ptot));
    } else {
      *f = v;
    }
  });
}

// the Gram's rows (dc, 3 ngauss basis rows, tau, join, r) padded to whole
// 16-row tiles
__host__ __device__ constexpr int padded_rows(int ng) { return (3 * ng + 4 + 15) / 16 * 16; }

// two chunks of all rows of a one-panel Gram, or of two row blocks
__host__ __device__ constexpr int staged_doubles(int ng) {
  return 2 * (padded_rows(ng) <= kPanelRows ? padded_rows(ng) : 2 * kPanelRows) * kStageStride;
}

// the Gram kernel's shared memory: ten doubles a component (its evolved
// values and chain factors), the staged chunks, four doubles, an int a
// component and four more
constexpr int64_t gram_smem(int ng) {
  return 8 * (10 * (int64_t)ng + staged_doubles(ng) + 4) + 4 * ((int64_t)ng + 4);
}

// epilogue A's shared memory: the transform's buffers and five values a
// component
constexpr int64_t sse_smem(int ng, int nbin) { return 16 * (int64_t)nbin + 40 * (int64_t)ng; }

constexpr int kMaxNgauss = 1888;
static_assert(gram_smem(kMaxNgauss) <= kSmemMax && gram_smem(kMaxNgauss + 1) > kSmemMax,
              "kMaxNgauss: the most components the Gram's shared memory holds");
static_assert(rows_smem(kMaxNgauss, kMaxBins) <= kSmemMax &&
                  sse_smem(kMaxNgauss, kMaxBins) <= kSmemMax,
              "the transforms' kernels take kMaxNgauss components at kMaxBins");

// kPairs: the 16 x 16 tile pairs a warp holds (at most two of a panel's)
template <int kPairs>
__global__ void __launch_bounds__(kThreads, 2)
gauss_ft_gram_kernel(const double* __restrict__ params, const double* __restrict__ rows,
                     const double* __restrict__ errs, int64_t erow,
                     const double* __restrict__ freqs, const int* __restrict__ groups, int ng,
                     int P, int nchan, int nbin, double nu_ref, double fwhm, double dcp,
                     Laws laws, int cpb, Tree tr, int64_t nrows, int ncnt,
                     double* __restrict__ scratch, int* __restrict__ counters,
                     double* __restrict__ f, double* __restrict__ g,
                     double* __restrict__ JtJ) {
  constexpr int ST = kStageStride, R = kPanelRows;
  constexpr int kLoads = 2 * kPanelRows * kChunk / kThreads;  // a thread's loads a chunk
  extern __shared__ double smem[];
  const int q1 = 3 * ng + 4, q1s = padded_rows(ng), qs = 3 * ng + 3;
  const int64_t W = row_width(P);
  const int smax = q1s <= R ? q1s : 2 * R;
  Comp s;
  s.mean = smem;
  s.isig = s.mean + ng;
  s.amp = s.isig + ng;
  s.iwid = s.amp + ng;
  s.chain = s.iwid + ng;
  double* buf = s.chain + 6 * ng;
  double* scal = buf + staged_doubles(ng);
  s.live = (int*)(scal + 4);
  int* iflag = s.live + ng;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y, leaf = blockIdx.x;
  const int ch0 = leaf * cpb, ch1 = min(nchan, ch0 + cpb);
  const double* prm = params + (int64_t)b * P;
  double* rws = scratch + (int64_t)b * nrows * W;
  double* row = rws + (int64_t)leaf * W;
  const int nblk = (q1s + R - 1) / R;
  const double sqrtN = sqrt((double)nbin);
  for (int64_t o = t; o < W; o += kThreads) row[o] = 0.0;

  for (int ch = ch0; ch < ch1; ++ch) {
    __syncthreads();  // the previous channel's readers (and the zeroing) are done
    const double nu = freqs[ch];
    for (int c = t; c < ng; c += kThreads) setup_component(prm, c, nu, nu_ref, fwhm, laws, s);
    __syncthreads();
    if (t == 0) row[W - 1] = __dadd_rn(row[W - 1], channel_poison(s.live, ng));
    const Chan cc = chan_setup(prm, ng, nbin, nu, nu_ref, groups[ch], dcp);
    const double ie = __ddiv_rn(1.0, errs[(int64_t)ch * erow]);
    const double sc = __dmul_rn(ie, ie);
    const double* crow = rows + ((int64_t)b * nchan + ch) * qs * nbin;

    for (int I = 0; I < nblk; ++I)
      for (int J = I; J < nblk; ++J) {
        const int rI = I * R, nI = min(R, q1s - rI), rJ = J * R, nJ = min(R, q1s - rJ);
        const bool diag = I == J;
        const int nst = diag ? nI : nI + nJ;  // rows staged a chunk
        const int nm = nI / 16, np = nJ / 16;
        int npair = 0;
        for (int mi = 0; mi < nm; ++mi) npair += diag ? np - mi : np;
        // this warp's pairs of 16 x 8 tiles (16 rows, 16 columns: one a
        // fragment, two b) warp, warp + 8, ...: the shared-memory offsets of
        // their fragments' rows and their first rows and columns in G
        const int npw = npair > warp ? min(kPairs, (npair - warp + kWarps - 1) / kWarps) : 0;
        int aoff[kPairs], boff[kPairs], ti[kPairs], tj[kPairs];
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          int mi = 0, rem = warp + u * kWarps;
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
        // a thread's values of chunk kc: staged row sl = t / 32 + 8 u, packed
        // real kc * 32 + lane (the dc row made here, the padding zero)
        auto fetch = [&](int kc, double (&v)[kLoads]) {
          const int pos = kc * kChunk + lane;
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int sl = warp + kWarps * u;
            double x = 0.0;
            if (sl < nst) {
              const int q = sl < nI ? rI + sl : rJ + sl - nI;
              if (q == 0)
                x = pos == 0 ? sqrtN : 0.0;
              else if (q < q1)
                x = __ldg(crow + (int64_t)(q - 1) * nbin + pos);
            }
            v[u] = x;
          }
        };
        const int nround = nbin / kChunk;
        double nxt[kLoads];
        fetch(0, nxt);
        for (int kc = 0; kc < nround; ++kc) {
          double* S = buf + (kc & 1) * smax * ST;
#pragma unroll
          for (int u = 0; u < kLoads; ++u) {
            const int sl = warp + kWarps * u;
            if (sl < nst) S[sl * ST + lane] = nxt[u];
          }
          if (kc + 1 < nround) fetch(kc + 1, nxt);
          __syncthreads();
#pragma unroll
          for (int ks = 0; ks < kChunk / 8; ++ks)
#pragma unroll
            for (int u = 0; u < kPairs; ++u) {
              if (u < npw) {
                const double* Ap = S + aoff[u] + 8 * ks;
                const double* Bt = S + boff[u] + 8 * ks;
                const double av[4] = {Ap[0], Ap[8 * ST], Ap[4], Ap[8 * ST + 4]};
                const double b0[2] = {Bt[0], Bt[4]};
                const double b1[2] = {Bt[8 * ST], Bt[8 * ST + 4]};
                mma_f64(acc[u][0], av, b0);
                mma_f64(acc[u][1], av, b1);
              }
            }
        }
        __syncthreads();  // the staged chunks are read before they are written again
#pragma unroll
        for (int u = 0; u < kPairs; ++u) {
          if (u >= npw) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = ti[u] + (e >= 2 ? 8 : 0), j = tj[u] + 8 * h + (e & 1);
              if (i <= j && j < q1)
                emit(i, j, __dmul_rn(acc[u][h][e], sc), q1, ng, P, s.chain, cc, row);
            }
        }
      }
  }
  climb(rws, counters + (int64_t)b * ncnt, leaf, tr, W, buf, iflag,
        [&](const double* child, int nc) {
          root_normal(child, nc, P, W, buf, scal, f + b, g + (int64_t)b * P,
                      JtJ + (int64_t)b * P * P);
        });
}

// -- epilogue B on chip: one launch, a cluster a (channel, lane) --------------

// the on-chip path's largest cluster and most transform batches a block:
// on an H100 the one-launch kernel beat the staged path at clusters of 1
// and 2 blocks with up to 3 batches, and lost at 4 blocks and more (fewer
// clusters in flight: 30 and 15 of 4 and 8 blocks) and at 4 batches and
// more (k10_clusters.py; PERF.md, row K10)
constexpr int kMaxCluster = 2;
constexpr int kMaxBatches = 3;
constexpr int kCThreads = 256;   // the on-chip kernel: eight warps a block
constexpr int kCWarps = kCThreads / 32;

// the Gram's 16 x 16 tile pairs (its upper triangle of tiles), and the
// splits of the packed reals each pair's sum takes so that the pairs fill
// the eight warps
__host__ __device__ constexpr int tile_pairs(int ng) {
  return padded_rows(ng) / 16 * (padded_rows(ng) / 16 + 1) / 2;
}
__host__ __device__ constexpr int gram_splits(int ng) {
  return tile_pairs(ng) >= kCWarps ? 1 : kCWarps / tile_pairs(ng);
}

// a row's stride in a block's slice of nbin / cs packed reals (4 mod 16
// doubles: the mma fragments' loads meet no bank twice)
constexpr int slice_stride(int nbin, int cs) { return (nbin / cs + 15) / 16 * 16 + 4; }

// the basis transforms a block takes: the 3 ngauss basis rows shared by
// the cluster's blocks in order
constexpr int block_transforms(int ng, int cs) { return (3 * ng + cs - 1) / cs; }

// the doubles before the slice: the larger of a transform batch's two
// buffers (T rows) and, after the transforms, the Gram's partial sums
constexpr int64_t onchip_area(int ng, int nbin, int T) {
  const int64_t xform = 2 * (int64_t)T * nbin;
  const int64_t part = (int64_t)gram_splits(ng) * tile_pairs(ng) * 256;
  return xform > part ? xform : part;
}

// the on-chip kernel's shared memory at cluster size cs and T rows a
// transform batch: the area, the block's slice of the stored rows, the
// channel's factors (six doubles), ten doubles and an int a component
static_assert(sizeof(Chan) <= 6 * sizeof(double), "a channel's factors take six doubles");
constexpr int64_t onchip_smem(int ng, int nbin, int cs, int T) {
  return 8 * (onchip_area(ng, nbin, T) + (int64_t)(3 * ng + 3) * slice_stride(nbin, cs) + 6 +
              10 * (int64_t)ng) +
         4 * (int64_t)ng;
}

// the on-chip launch: cluster size cs (0: the staged path), T rows a
// transform batch, tb transforms a block, the Gram's splits and tile pairs,
// the slice's stride, the area's doubles and the shared memory
struct OnChip {
  int cs, T, tb, S, np, Ls;
  int64_t area, smem;
};

// The path rule: the smallest cluster (at most kMaxCluster blocks) whose
// blocks' shared memory holds a channel's stored rows with at most
// kMaxBatches transform batches a block, with the fewest batches there;
// the staged path where none does, and where the Gram's blocks would
// group channels (a leaf row a channel here).
OnChip onchip(int ng, int nbin, int cpb) {
  OnChip oc{};
  if (cpb != 1) return oc;
  for (int cs = 1; cs <= kMaxCluster && cs <= nbin / 8 && !oc.cs; cs *= 2) {
    const int tb = block_transforms(ng, cs);
    for (int nb = 1; nb <= tb && nb <= kMaxBatches; ++nb) {
      const int T = (tb + nb - 1) / nb;
      if (onchip_smem(ng, nbin, cs, T) <= kSmemMax) {
        oc.cs = cs;
        oc.T = T;
        oc.tb = tb;
        break;
      }
    }
  }
  if (oc.cs) {
    oc.S = gram_splits(ng);
    oc.np = tile_pairs(ng);
    oc.Ls = slice_stride(nbin, oc.cs);
    oc.area = onchip_area(ng, nbin, oc.T);
    oc.smem = onchip_smem(ng, nbin, oc.cs, oc.T);
  }
  return oc;
}

// Block `rank` of a cluster of cs per (channel ch, lane b) owns the
// harmonics [rank h, rank h + h), h = n / cs (n = nbin / 2), and block 0
// also n: it holds every stored row (3 ngauss basis rows, tau, join, r)
// over their packed reals, Re k at 2 (k - rank h) and Im k after it (the
// Nyquist harmonic's Re in block 0's second place, where harmonic 0 has
// no Im); the dc row is implicit.  Phases: (1) the components and
// (another warp) the channel's factors, the leaf row zeroed, the first
// transform batch's rows formed; cluster barrier; (2) each block's basis
// rows (the cluster's 3 ngauss in order) transformed in batches of T
// (fft_block_rows: a barrier a pass, or a pair of passes, for the batch)
// from one pass over a component's exps, each raw harmonic written to the
// block that owns it; cluster barrier; (3) each block over its harmonics:
// the factors S, dS and R once; G^ = dc N delta_k0 + sum_c amp_c e^_c (the
// portrait's spectrum from the e rows, components in order); the tau,
// join and residual rows; each basis row times R S; the packing weights;
// (4) the Gram of the block's slice: each item a tile pair and a split of
// the slice's reals on one warp, its sums kept in shared memory; cluster
// barrier; (5) each Gram entry summed over the splits in order then over
// the ranks in order, scaled by 1 / err^2 and put through the chain rule
// into the leaf row (no two entries add to one sum); cluster barrier; then
// rank 0 climbs the channel tree.
__global__ void __launch_bounds__(kCThreads, 1)
gauss_ft_gram_cluster_kernel(const double* __restrict__ params, const double* __restrict__ dspec,
                             const double* __restrict__ errs, int64_t erow,
                             const double* __restrict__ bins, const double* __restrict__ freqs,
                             const int* __restrict__ groups, const double2* __restrict__ tw,
                             int ng, int P, int nbin, double nu_ref, double fwhm, double dcp,
                             Laws laws, OnChip oc, Tree tr, int64_t nrows, int ncnt,
                             double* __restrict__ scratch, int* __restrict__ counters,
                             double* __restrict__ f, double* __restrict__ g,
                             double* __restrict__ JtJ) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) double csm[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = oc.cs, rank = (int)cl.block_rank();
  // a cluster of one block waits at the block's own barrier
  auto csync = [&] {
    if (cs == 1)
      __syncthreads();
    else
      cl.sync();
  };
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, gq = lane >> 2, tq = lane & 3;
  const int ch = blockIdx.x / cs, b = blockIdx.y;
  const int n = nbin / 2, L = nbin / cs, h = n / cs, Ls = oc.Ls, q1 = 3 * ng + 4;
  const int qs = 3 * ng + 3;
  const int64_t W = row_width(P);
  const double w0 = sqrt(__ddiv_rn(1.0, (double)nbin)), w1 = sqrt(__ddiv_rn(2.0, (double)nbin));
  double2* fa = reinterpret_cast<double2*>(csm);
  double2* fb = fa + (int64_t)oc.T * n;
  double* part = csm;
  double* slice = csm + oc.area;
  Chan* chn = reinterpret_cast<Chan*>(slice + (int64_t)qs * Ls);
  double* base = slice + (int64_t)qs * Ls + 6;
  Comp s;
  s.mean = base;
  s.isig = base + ng;
  s.amp = base + 2 * ng;
  s.iwid = base + 3 * ng;
  s.chain = base + 4 * ng;
  s.live = (int*)(base + 10 * ng);

  // (1); the components on the first threads, the channel's factors on
  // the last, so that their latencies overlap
  const double* prm = params + (int64_t)b * P;
  const double nu = freqs[ch], err = errs[(int64_t)ch * erow];
  double* rws = scratch + (int64_t)b * nrows * W;
  double* row = rws + (int64_t)ch * W;
  for (int64_t o = (int64_t)rank * kCThreads + t; o < W; o += (int64_t)cs * kCThreads)
    row[o] = 0.0;
  for (int c = t; c < ng; c += kCThreads) setup_component(prm, c, nu, nu_ref, fwhm, laws, s);
  if (t == kCThreads - 1) *chn = chan_setup(prm, ng, nbin, nu, nu_ref, groups[ch], dcp);
  __syncthreads();
  // this block's basis rows [u0, u1): u = 3 c + kind, component c's row of
  // that kind (e, loc, wid; slice row u), whose three values come from one
  // pass over its exps
  const int u0 = min(3 * ng, rank * oc.tb), u1 = min(3 * ng, u0 + oc.tb);
  auto form = [&](int ub, int nb) {
    double xn = __ldg(bins + t);
#pragma unroll 2
    for (int j = t; j < nbin; j += kCThreads) {
      const double xb = xn;  // the next bin's centre loads while this one is formed
      if (j + kCThreads < nbin) xn = __ldg(bins + j + kCThreads);
      int cp = -1;
      double e = 0.0, vl = 0.0, vw = 0.0;
      for (int r = 0; r < nb; ++r) {
        const int u = ub + r, c = u / 3, kind = u - 3 * c;
        if (c != cp) {
          e = component<true>(xb, c, s, 1.0, &vl, &vw);
          cp = c;
        }
        reinterpret_cast<double*>(fa + (int64_t)r * n)[j] = kind == 0 ? e : (kind == 1 ? vl : vw);
      }
    }
  };
  if (u0 < u1) form(u0, min(oc.T, u1 - u0));
  csync();  // every block runs (its shared memory may be written); the row is zero
  if (rank == 0 && t == 0) row[W - 1] = channel_poison(s.live, ng);
  const Chan cc = *chn;

  // (2): harmonic k of a row goes to its owner's slice, raw
  for (int ub = u0; ub < u1; ub += oc.T) {
    const int nb = min(oc.T, u1 - ub);
    if (ub != u0) {
      form(ub, nb);
      __syncthreads();
    }
    const double2* z = fft_block_rows<kCThreads>(fa, fb, n, nbin, tw, nb);
    for (int k = t; k <= n; k += kCThreads) {
      const double2 wk = __ldg(tw + k);
      const int own = k == n ? 0 : k / h;
      double* dst = cl.map_shared_rank(slice, own) + (k == n ? 1 : 2 * (k - own * h));
      for (int r = 0; r < nb; ++r) {
        const double2 X = split_w(z + (int64_t)r * n, k, n, wk);
        double* d = dst + (int64_t)(ub + r) * Ls;
        if (k == 0 || k == n)
          d[0] = X.x;
        else
          *reinterpret_cast<double2*>(d) = X;
      }
    }
    __syncthreads();  // the buffers are read before the next batch is formed over them
  }
  csync();  // every block's harmonics are whole

  // (3)
  {
    const double dcN = __dmul_rn(prm[0], (double)nbin);
    const double* drow = dspec + (int64_t)ch * nbin;
    const int ni = h + (rank == 0);
    // harmonic i's data spectrum, loaded a harmonic ahead of its use
    auto data = [&](int i, double2* d) {
      const int k = i < h ? rank * h + i : n;
      *d = make_double2(__ldg(drow + k), k == 0 || k == n ? 0.0 : __ldg(drow + n + k));
    };
    double2 dn = make_double2(0.0, 0.0);
    if (t < ni) data(t, &dn);
    for (int i = t; i < ni; i += kCThreads) {
      const int k = i < h ? rank * h + i : n, pos = i < h ? 2 * i : 1;
      const bool edge = k == 0 || k == n;
      const double2 D = dn;
      if (i + kCThreads < ni) data(i + kCThreads, &dn);
      double2 S, dS, R;
      factors(cc, k, &S, &dS, &R);
      const double2 C = k == n ? make_double2(__dmul_rn(R.x, S.x), 0.0) : cmul(R, S);
      const double wk = edge ? w0 : w1;
      auto get = [&](int srow) {
        const double* v = slice + (int64_t)srow * Ls + pos;
        return edge ? make_double2(v[0], 0.0) : make_double2(v[0], v[1]);
      };
      auto put = [&](int srow, double2 v) {
        double* d = slice + (int64_t)srow * Ls + pos;
        d[0] = __dmul_rn(v.x, wk);
        if (!edge) d[1] = __dmul_rn(v.y, wk);
      };
      // G^ from the e rows, components in order
      double2 X = make_double2(k == 0 ? dcN : 0.0, 0.0);
      for (int c = 0; c < ng; ++c) {
        const double2 e = get(3 * c);
        X = make_double2(__dadd_rn(X.x, __dmul_rn(s.amp[c], e.x)),
                         __dadd_rn(X.y, __dmul_rn(s.amp[c], e.y)));
      }
      for (int u = 0; u < 3 * ng; ++u) {  // the basis rows, times R S
        const double2 v = get(u);
        put(u, k == n ? make_double2(__dmul_rn(C.x, v.x), 0.0) : cmul(C, v));
      }
      // G: the tau, join and residual rows (as the rows kernel's part 0)
      double2 Y;
      const double2 M = model_harmonic(X, k, n, S, R, &Y);
      const double a = __dmul_rn(kTwoPi, (double)k);
      double2 T, Jn;
      if (k == n) {
        T = make_double2(__dmul_rn(R.x, __dmul_rn(dS.x, X.x)), 0.0);
        Jn = make_double2(-__dmul_rn(a, __dmul_rn(R.y, Y.x)), 0.0);
      } else {
        T = cmul(R, cmul(dS, X));
        Jn = make_double2(-__dmul_rn(a, M.y), __dmul_rn(a, M.x));
      }
      if (cc.grp < 0) Jn = make_double2(0.0, 0.0);
      put(3 * ng, T);
      put(3 * ng + 1, Jn);
      double* rr = slice + (int64_t)(3 * ng + 2) * Ls + pos;
      rr[0] = __dsub_rn(D.x, __dmul_rn(M.x, wk));
      if (!edge) rr[1] = __dsub_rn(D.y, __dmul_rn(M.y, wk));
    }
  }
  __syncthreads();  // the slice is whole (the transforms' area is free)

  // (4)
  const int nt = padded_rows(ng) / 16, ksteps = L / 8;
  auto tile_pair = [&](int pi, int* mi, int* mj) {
    int a = 0, rem = pi;
    while (rem >= nt - a) {
      rem -= nt - a;
      ++a;
    }
    *mi = a;
    *mj = a + rem;
  };
  for (int it = warp; it < oc.np * oc.S; it += kCWarps) {
    const int pi = it / oc.S, sp = it - pi * oc.S;
    int mi, mj;
    tile_pair(pi, &mi, &mj);
    // fragment rows: Gram row q is slice row q - 1; the dc row (its one
    // nonzero real is added in (5)) and the padding read as 0
    const int qa = 16 * mi + gq, qb = 16 * mj + gq;
    const bool va0 = qa >= 1 && qa < q1, va1 = qa + 8 < q1;
    const bool vb0 = qb >= 1 && qb < q1, vb1 = qb + 8 < q1;
    const bool half = 16 * mj + 8 < q1;  // the pair's columns 8-15 hold a row (warp-uniform)
    const double* pa0 = slice + (int64_t)(va0 ? qa - 1 : 0) * Ls + tq;
    const double* pa1 = slice + (int64_t)(va1 ? qa + 7 : 0) * Ls + tq;
    const double* pb0 = slice + (int64_t)(vb0 ? qb - 1 : 0) * Ls + tq;
    const double* pb1 = slice + (int64_t)(vb1 ? qb + 7 : 0) * Ls + tq;
    const int k0 = sp * ksteps / oc.S * 8, k1 = (sp + 1) * ksteps / oc.S * 8;
    // four chains of sums (steps of 8 reals in turn), added in order at
    // the end
    double acc[4][2][4] = {};
    auto step = [&](int kk, double (&d)[2][4]) {
      const double av[4] = {va0 ? pa0[kk] : 0.0, va1 ? pa1[kk] : 0.0, va0 ? pa0[kk + 4] : 0.0,
                            va1 ? pa1[kk + 4] : 0.0};
      const double b0[2] = {vb0 ? pb0[kk] : 0.0, vb0 ? pb0[kk + 4] : 0.0};
      const double b1[2] = {vb1 ? pb1[kk] : 0.0, vb1 ? pb1[kk + 4] : 0.0};
      mma_f64(d[0], av, b0);
      if (half) mma_f64(d[1], av, b1);  // else all padding: its sums stay 0
    };
    int kk = k0;
    for (; kk + 24 < k1; kk += 32) {
      step(kk, acc[0]);
      step(kk + 8, acc[1]);
      step(kk + 16, acc[2]);
      step(kk + 24, acc[3]);
    }
    if (kk < k1) step(kk, acc[0]);
    if (kk + 8 < k1) step(kk + 8, acc[1]);
    if (kk + 16 < k1) step(kk + 16, acc[2]);
    double* pp = part + (int64_t)it * 256;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pp[(gq + (e >= 2 ? 8 : 0)) * 16 + 8 * hh + 2 * tq + (e & 1)] = __dadd_rn(
            __dadd_rn(acc[0][hh][e], acc[1][hh][e]), __dadd_rn(acc[2][hh][e], acc[3][hh][e]));
  }
  csync();  // every block's partial sums are whole

  // (5): each rank's sums loaded at once, then added in order
  const double ie = __ddiv_rn(1.0, err);
  const double sc = __dmul_rn(ie, ie), sqrtN = sqrt((double)nbin);
  const double* dcs = cl.map_shared_rank(slice, 0);  // packed real 0 of every row
  for (int e = rank * kCThreads + t; e < oc.np * 256; e += cs * kCThreads) {
    const int pi = e >> 8, i = (e >> 4) & 15, j = e & 15;
    int mi, mj;
    tile_pair(pi, &mi, &mj);
    const int I = 16 * mi + i, J = 16 * mj + j;
    if (I > J || J >= q1) continue;
    double G;
    if (I == 0) {
      G = J == 0 ? __dmul_rn(sqrtN, sqrtN) : __dmul_rn(sqrtN, dcs[(int64_t)(J - 1) * Ls]);
    } else {
      const int64_t off = (int64_t)pi * oc.S * 256 + (e & 255);
      double blk[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        blk[r] = r < cs ? cl.map_shared_rank(part, r)[off] : 0.0;
      for (int u = 1; u < oc.S; ++u) {
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < cs) blk[r] = __dadd_rn(blk[r], cl.map_shared_rank(part, r)[off + u * 256]);
      }
      G = blk[0];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < cs) G = __dadd_rn(G, blk[r]);
    }
    emit<false>(I, J, __dmul_rn(G, sc), q1, ng, P, s.chain, cc, row);
  }
  __threadfence();
  csync();  // the leaf row is whole; no block reads another's shared memory after this
  if (rank != 0) return;
  // the partial sums' room (at least five tiles) holds the tree's part,
  // scalar and flag
  climb(rws, counters + (int64_t)b * ncnt, ch, tr, W, part, (int*)(part + kCThreads + 1),
        [&](const double* child, int nc) {
          root_normal(child, nc, P, W, part, part + kCThreads, f + b, g + (int64_t)b * P,
                      JtJ + (int64_t)b * P * P);
        });
}

// -- epilogue A ---------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
gauss_ft_sse_kernel(const double* __restrict__ params, const double* __restrict__ dspec,
                    const double* __restrict__ errs, int64_t erow,
                    const double* __restrict__ bins, const double* __restrict__ freqs,
                    const int* __restrict__ groups, const double2* __restrict__ tw, int ng,
                    int P, int nchan, int nbin, double nu_ref, double fwhm, double dcp,
                    Laws laws, Tree tr, int64_t nrows, int ncnt, double* __restrict__ scratch,
                    int* __restrict__ counters, double* __restrict__ f) {
  extern __shared__ double smem[];
  __shared__ double wpart[kWarps];
  __shared__ double part[kThreads];
  __shared__ int last;
  const int ch = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t & 31;
  const int n = nbin / 2;
  const double w0 = sqrt(__ddiv_rn(1.0, (double)nbin)), w1 = sqrt(__ddiv_rn(2.0, (double)nbin));
  double2* A = reinterpret_cast<double2*>(smem);
  double2* Bf = A + n;
  double* base = smem + 2 * (int64_t)nbin;
  const Comp s{base, base + ng, base + 2 * ng, base + 3 * ng, nullptr, (int*)(base + 4 * ng)};
  const double* prm = params + (int64_t)b * P;
  const double nu = freqs[ch];
  for (int c = t; c < ng; c += kThreads) setup_component(prm, c, nu, nu_ref, fwhm, laws, s);
  const Chan cc = chan_setup(prm, ng, nbin, nu, nu_ref, groups[ch], dcp);
  __syncthreads();
  form_G(reinterpret_cast<double*>(A), bins, nbin, prm[0], s, ng);
  __syncthreads();
  const double2* z = fft_block<kThreads>(A, Bf, n, nbin, tw);
  const double* drow = dspec + (int64_t)ch * nbin;
  double ss = 0.0;
  for (int k = t; k <= n; k += kThreads) {
    double2 S, dS, R, Y;
    factors(cc, k, &S, &dS, &R);
    const double2 M = model_harmonic(split(z, k, n, tw), k, n, S, R, &Y);
    const bool edge = k == 0 || k == n;
    const double rr = __dsub_rn(__ldg(drow + k), __dmul_rn(M.x, edge ? w0 : w1));
    ss = __dadd_rn(ss, __dmul_rn(rr, rr));
    if (!edge) {
      const double ri = __dsub_rn(__ldg(drow + n + k), __dmul_rn(M.y, w1));
      ss = __dadd_rn(ss, __dmul_rn(ri, ri));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss = __dadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  if (lane == 0) wpart[t >> 5] = ss;
  __syncthreads();
  double* rws = scratch + (int64_t)b * nrows;
  if (t == 0) {
    double v = wpart[0];
    for (int u = 1; u < kWarps; ++u) v = __dadd_rn(v, wpart[u]);
    const double ie = __ddiv_rn(1.0, errs[(int64_t)ch * erow]);
    rws[ch] = __dmul_rn(v, __dmul_rn(ie, ie));
  }
  climb(rws, counters + (int64_t)b * ncnt, ch, tr, 1, part, &last,
        [&](const double* child, int nc) {
          node_sum(child, nc, 1, 1, part, [&](int64_t, double v) { f[b] = v; });
        });
}

// a launch's geometry, from the components, join groups, channels, bins and
// the epilogue (normal: B): the doubles in a row of sums, the channels a Gram
// block, the channel tree, a lane's scratch rows and counters, the staged
// rows a (lane, channel), and the dynamic shared memory of each kernel.
// pp_gauss_ft_sizes gives it to the wrapper, which allocates from it.
struct Geometry {
  int64_t width, rows, staged, smem_rows, smem_gram, smem_sse;
  int cpb, counters;
  Tree tr;
  OnChip oc;  // epilogue B's on-chip launch (oc.cs 0: the staged path)
};

bool takes(int ng, int njoin, int nchan, int nbin) {
  return ng >= 1 && ng <= kMaxNgauss && njoin >= 0 && nchan >= 1 && nbin >= kMinBins &&
         nbin <= kMaxBins && (nbin & (nbin - 1)) == 0;
}

Geometry geometry(int ng, int njoin, int nchan, int nbin, bool normal) {
  Geometry gm;
  const int P = 6 * ng + 3 + 2 * njoin;
  gm.width = normal ? row_width(P) : 1;
  gm.cpb = 1;
  if (normal) {
    const int64_t bytes = (int64_t)nchan * 8 * gm.width;
    gm.cpb = (int)((bytes + kRowBudget - 1) / kRowBudget);
  }
  const int nleaf = (nchan + gm.cpb - 1) / gm.cpb;
  const int64_t wide = kFanDoubles / gm.width;
  gm.tr = Tree{nleaf, (int)std::max<int64_t>(kFan, std::min<int64_t>(nleaf, wide))};
  tree_sizes(gm.tr, &gm.rows, &gm.counters);
  gm.oc = normal ? onchip(ng, nbin, gm.cpb) : OnChip{};
  gm.staged = normal && !gm.oc.cs ? 3 * ng + 3 : 0;
  gm.smem_rows = normal ? rows_smem(ng, nbin) : 0;
  gm.smem_gram = normal ? gram_smem(ng) : 0;
  gm.smem_sse = normal ? 0 : sse_smem(ng, nbin);
  return gm;
}

// the on-chip kernel's launch: its shared memory set, the configuration
// filled
cudaError_t onchip_config(const OnChip& oc, int nchan, int B, cudaStream_t st,
                          cudaLaunchConfig_t* cfg, cudaLaunchAttribute* at) {
  const cudaError_t err = set_smem((const void*)gauss_ft_gram_cluster_kernel, oc.smem);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(nchan * oc.cs, B);
  cfg->blockDim = dim3(kCThreads);
  cfg->dynamicSmemBytes = oc.smem;
  cfg->stream = st;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = oc.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg->attrs = at;
  cfg->numAttrs = 1;
  return err;
}

}  // namespace

// The geometry of a launch at ngauss components, njoin join groups, nchan
// channels and nbin bins, for epilogue B (normal != 0) or A, into sizes[12]
// (int64): the doubles in a row of sums, a lane's scratch rows and counters,
// the channels a Gram block, the channel tree's fan-in, the staged rows a
// (lane, channel) (0 on the on-chip path), the dynamic shared memory of the
// rows, Gram and sse kernels, and epilogue B's on-chip launch: its cluster
// size (0: the staged path), rows a transform batch and shared memory.  The
// wrapper allocates scratch [B, rows, width] f64, counters [B, counters]
// int32 and the staged rows [B, nchan, staged, nbin] f64 from it.
// Returns cudaErrorInvalidValue for a problem the kernel does not take
// (kMaxNgauss components; nbin a power of two in [kMinBins, kMaxBins]).
extern "C" int pp_gauss_ft_sizes(int ngauss, int njoin, int nchan, int nbin, int normal,
                                 void* sizes) {
  if (!takes(ngauss, njoin, nchan, nbin)) return (int)cudaErrorInvalidValue;
  const Geometry gm = geometry(ngauss, njoin, nchan, nbin, normal != 0);
  int64_t* out = (int64_t*)sizes;
  out[0] = gm.width;
  out[1] = gm.rows;
  out[2] = gm.counters;
  out[3] = gm.cpb;
  out[4] = gm.tr.fan;
  out[5] = gm.staged;
  out[6] = gm.smem_rows;
  out[7] = gm.smem_gram;
  out[8] = gm.smem_sse;
  out[9] = gm.oc.cs;
  out[10] = gm.oc.T;
  out[11] = gm.oc.smem;
  return 0;
}

// The clusters of epilogue B's on-chip launch the current device holds at
// once (cudaOccupancyMaxActiveClusters), into *clusters; 0 on the staged
// path.
extern "C" int pp_gauss_ft_clusters(int ngauss, int njoin, int nchan, int nbin,
                                    void* clusters) {
  int* out = (int*)clusters;
  *out = 0;
  if (!takes(ngauss, njoin, nchan, nbin)) return (int)cudaErrorInvalidValue;
  const Geometry gm = geometry(ngauss, njoin, nchan, nbin, true);
  if (!gm.oc.cs) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[1];
  cudaError_t err = onchip_config(gm.oc, nchan, 1, 0, &cfg, at);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, gauss_ft_gram_cluster_kernel, &cfg);
}

// params [B, 6 ngauss + 3 + 2 njoin], dspec [nchan, nbin] (the data's rFFT,
// packed as above), errs read at errs + c errs_row (a value a channel), bins
// [nbin] (bin centres), freqs [nchan], all f64; groups [nchan] int32 (the
// channel's join group, -1 outside every group); twiddles
// ops.wavelet.scan_twiddles(nbin) (double2); nu_ref; fwhm = 2 sqrt(2 ln 2);
// dconst_p = Dconst / P; the model-code digits of loc, wid and amp (0 power
// law, 1 linear); staged, scratch and counters as pp_gauss_ft_sizes gives
// them (the counters zero before the first call; every call leaves them
// zero); f [B], g [B, P], JtJ [B, P, P] f64 out.  One launch on `stream`
// where the geometry has an on-chip launch (staged unused), else two (the
// rows, then the Gram); returns the first cudaError_t.
extern "C" int pp_gauss_ft_normal(const void* params, const void* dspec, const void* errs,
                                  int64_t errs_row, const void* bins, const void* freqs,
                                  const void* groups, const void* twiddles, int B, int ngauss,
                                  int njoin, int nchan, int nbin, double nu_ref, double fwhm,
                                  double dconst_p, int law_loc, int law_wid, int law_amp,
                                  void* staged, void* scratch, void* counters, void* f, void* g,
                                  void* JtJ, void* stream) {
  if (B <= 0) return 0;
  if (!takes(ngauss, njoin, nchan, nbin) || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Laws laws{law_loc, law_wid, law_amp};
  const Geometry gm = geometry(ngauss, njoin, nchan, nbin, true);
  const int P = 6 * ngauss + 3 + 2 * njoin;
  const double *pp = (const double*)params, *ds = (const double*)dspec;
  const double *bb = (const double*)bins, *ff = (const double*)freqs;
  const int* gr = (const int*)groups;
  if (gm.oc.cs) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute at[1];
    cudaError_t err = onchip_config(gm.oc, nchan, B, st, &cfg, at);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, gauss_ft_gram_cluster_kernel, pp, ds, (const double*)errs,
                             errs_row, bb, ff, gr, (const double2*)twiddles, ngauss, P, nbin,
                             nu_ref, fwhm, dconst_p, laws, gm.oc, gm.tr, gm.rows, gm.counters,
                             (double*)scratch, (int*)counters, (double*)f, (double*)g,
                             (double*)JtJ);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  double* rw = (double*)staged;
  cudaError_t err = set_smem((const void*)gauss_ft_rows_kernel, gm.smem_rows);
  if (err != cudaSuccess) return (int)err;
  gauss_ft_rows_kernel<<<dim3(nchan, B, ngauss + 1), kThreads, gm.smem_rows, st>>>(
      pp, ds, bb, ff, gr, (const double2*)twiddles, ngauss, P, nchan, nbin, nu_ref, fwhm,
      dconst_p, laws, rw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = set_smem((const void*)gauss_ft_gram_kernel<2>, gm.smem_gram);
  if (err != cudaSuccess) return (int)err;
  gauss_ft_gram_kernel<2><<<dim3(gm.tr.nleaf, B), kThreads, gm.smem_gram, st>>>(
      pp, rw, (const double*)errs, errs_row, ff, gr, ngauss, P, nchan, nbin, nu_ref, fwhm,
      dconst_p, laws, gm.cpb, gm.tr, gm.rows, gm.counters, (double*)scratch, (int*)counters,
      (double*)f, (double*)g, (double*)JtJ);
  return (int)cudaGetLastError();
}

// the same arguments without staged, g and JtJ (epilogue A: a leaf a
// channel, rows of one double); one launch.
extern "C" int pp_gauss_ft_sse(const void* params, const void* dspec, const void* errs,
                               int64_t errs_row, const void* bins, const void* freqs,
                               const void* groups, const void* twiddles, int B, int ngauss,
                               int njoin, int nchan, int nbin, double nu_ref, double fwhm,
                               double dconst_p, int law_loc, int law_wid, int law_amp,
                               void* scratch, void* counters, void* f, void* stream) {
  if (B <= 0) return 0;
  if (!takes(ngauss, njoin, nchan, nbin) || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Geometry gm = geometry(ngauss, njoin, nchan, nbin, false);
  cudaError_t err = set_smem((const void*)gauss_ft_sse_kernel, gm.smem_sse);
  if (err != cudaSuccess) return (int)err;
  const Laws laws{law_loc, law_wid, law_amp};
  gauss_ft_sse_kernel<<<dim3(nchan, B), kThreads, gm.smem_sse, st>>>(
      (const double*)params, (const double*)dspec, (const double*)errs, errs_row,
      (const double*)bins, (const double*)freqs, (const int*)groups, (const double2*)twiddles,
      ngauss, 6 * ngauss + 3 + 2 * njoin, nchan, nbin, nu_ref, fwhm, dconst_p, laws, gm.tr,
      gm.rows, gm.counters, (double*)scratch, (int*)counters, (double*)f);
  return (int)cudaGetLastError();
}
