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
//   sigma = wid / FWHM, z = clip(x / sigma, +-20), e = exp(-z^2 / 2)
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
// dc) times one of Q = 1 + 3 ngauss basis rows of the bin: 1 / err, e / err,
// (amp e z / sigma) / err and (amp e z^2 / wid) / err per component.  With r
// appended as row Q, the channel's (Q + 1) x (Q + 1) Gram matrix
// G = sum_bins v v^T holds everything: JtJ_pq = sum_nu a_p a_q G_{q(p) q(q)},
// g_p = -sum_nu a_p G_{q(p) Q}, f = sum_nu G_QQ.
//   Pass 1 (gauss_normal_kernel): one block a (lane, channel, tile).  Its
// first threads evolve the components (one each) into shared memory and,
// in tile 0, write the chain factors to the channel's scratch row.  Then
// rounds of 256 bins, one a thread: each thread forms v for its bin and
// stages the rows its tile takes in shared memory (the next round's data,
// error and bin centre already loading); warp w sums the round's bins
// 32w .. 32w + 31 for the tile's Gram entries its lanes own (entry k on
// lane k mod 32) into its own row of sums.  At the end the warps' rows are
// added in order, into the scratch row.  A tile is the Gram matrix's
// entries between two blocks of tile_rows rows (a block with itself on the
// diagonal); when every row and sum fits a block's shared memory there is
// one tile, all of G (18 components on an H100), and beyond that blocks of
// 32 rows, each tile recomputing the bin's model for r.  An entry is summed
// in the same order whatever the tiling, so tiling changes no bit.
//   Pass 2 (gauss_chain_kernel): one block a lane.  Each output (JtJ's upper
// triangle, g, f) is a sum over channels, taken in slices when there are
// fewer outputs than threads; the slices are added in order.
//   Epilogue A (gauss_sse_kernel): pass 1 without the basis, each thread's
// r^2 over its bins joined by shuffle trees; gauss_fsum_kernel sums the
// channels.  No atomics anywhere: the same inputs give the same bits.
//
// errs [nchan, nbin] is read through its strides (errs_row, errs_bin), so
// per-channel errors broadcast over the bins (errs_bin = 0, as ppgauss
// gives them) are read as nchan values.
//
// What bounds it on an H100: at one lane and one component, bytes: data
// read once, 8.4 MB at [512, 2048] (errs a value a channel), 0.0025 ms at
// 3.35 TB/s, against ~39 FP64 operations a bin (the exp ~20) at 34
// TFLOP/s and the Gram's 15 entries (2 each) at the FP64 tensor cores' 67,
// 0.0017 ms.  Several lanes (B) or components make it operations: the Gram
// grows as (3 ngauss + 2)^2 / 2 and every lane reads the same data.  The
// Gram sums are plain FP64 FMAs here (not the tensor cores).
//
// Limits: pass 1 of the normal equations keeps the tile's staged rows of
// 257 doubles, a row of its Gram sums per warp and five doubles a component
// in shared memory: tiles of 32 rows hold 756 components on an H100 (the
// wrapper raises beyond); epilogue A holds 5282.  Lanes ride on the grid's y
// dimension and tiles on its z (<= 65535 each).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // pass 1: a (lane, channel) block
constexpr int kWarps = kThreads / 32;
constexpr int kPad = kThreads + 1;     // a staged row's stride [doubles]
constexpr int kChainThreads = 1024;    // pass 2: a lane's block
constexpr int kSumThreads = 256;       // epilogue A's channel sum
constexpr double kZmax = 20.0;

struct Laws {
  int loc, wid, amp;
};

// shared memory of pass 1 (the wrapper's gauss_normal_smem counts the same)
struct Smem {
  double *mean, *sigma, *amp, *isig, *iwid;  // per component
  double *v;                                 // srows x kPad staged rows
  double *acc;                               // kWarps x spairs Gram sums
  int *live;                                 // per component: 1 live, 2 poisoned
  unsigned short *pair;                      // (k << 8) | k' per tile entry
};

// a tile of pass 1: the Gram entries between rows a0 .. a0 + na - 1 and
// b0 .. b0 + nb - 1 (q <= q'; the same block on the diagonal); its staged
// rows are block a's and then, off the diagonal, block b's
struct Tile {
  int a0, na, b0, nb;
  bool diag;
  // row q's staged slot, -1 where the tile does not take it
  __device__ __forceinline__ int slot(int q) const {
    if (q >= a0 && q < a0 + na) return q - a0;
    if (!diag && q >= b0 && q < b0 + nb) return na + q - b0;
    return -1;
  }
  __device__ __forceinline__ int entries() const {
    return diag ? na * (na + 1) / 2 : na * nb;
  }
};

// tile z of the blocks of R rows (their upper triangle, row by row)
__device__ __forceinline__ Tile tile_of(int z, int q1, int R) {
  const int nblk = (q1 + R - 1) / R;
  int i = 0, rem = z;
  while (rem >= nblk - i) {
    rem -= nblk - i;
    ++i;
  }
  Tile tl;
  tl.a0 = i * R;
  tl.na = min(R, q1 - tl.a0);
  tl.b0 = (i + rem) * R;
  tl.nb = min(R, q1 - tl.b0);
  tl.diag = rem == 0;
  return tl;
}

// the staged rows and Gram sums a block of R rows a tile keeps room for:
// all of them in one tile, else two blocks' rows and a block's square
__host__ __device__ __forceinline__ int staged_rows(int q1, int R) {
  return R >= q1 ? q1 : 2 * R;
}
__host__ __device__ __forceinline__ int staged_pairs(int q1, int R) {
  return R >= q1 ? q1 * (q1 + 1) / 2 : R * R;
}

__device__ __forceinline__ Smem carve(double* base, int ng, int srows, int spairs, bool normal) {
  Smem s;
  s.mean = base;
  s.sigma = s.mean + ng;
  s.amp = s.sigma + ng;
  s.isig = s.amp + ng;
  s.iwid = s.isig + ng;
  s.v = s.iwid + ng;
  s.acc = s.v + (normal ? srows * kPad : 0);
  s.live = (int*)(s.acc + (normal ? kWarps * spairs : 0));
  s.pair = (unsigned short*)(s.live + ng);
  return s;
}

// one evolution law at one channel: the value and its derivatives in p0 and
// the slope, rounded as ops/profiles.py's torch operations
__device__ __forceinline__ void evolve(double p0, double s, double logf, double dfreq,
                                       int law, double* v, double* d0, double* d1) {
  if (law == 0) {
    const double val = exp(__dadd_rn(__dmul_rn(logf, s), log(p0)));
    *v = val;
    *d0 = __dmul_rn(__ddiv_rn(1.0, p0), val);
    *d1 = __dmul_rn(logf, val);
  } else {
    *v = __dadd_rn(__dmul_rn(dfreq, s), p0);
    *d0 = 1.0;
    *d1 = dfreq;
  }
}

// a power law's tangent along any parameter but its own two: v (0 / p0),
// 0 unless p0 = 0 (NaN); 0 for the linear law
__device__ __forceinline__ double cross(double p0, double v, int law) {
  return law == 0 ? __dmul_rn(__ddiv_rn(0.0, p0), v) : 0.0;
}

// thread c < ng: component c's evolved values at channel nu into shared
// memory and, when chain is given, its six chain factors (loc0, dloc, wid0,
// dwid, amp0, damp), the loc and wid ones zeroed where wid <= 0.  The
// component is poisoned where forward-mode would carry a NaN tangent of its
// evolved values (a power law's p0 = 0) into every column: through amp
// always, through loc and wid where it is live
__device__ void setup_component(const double* __restrict__ prm, int c, double nu,
                                double nu_ref, double fwhm, Laws laws, const Smem& s,
                                double* chain) {
  const double logf = __dsub_rn(log(nu), log(nu_ref));
  const double dfreq = __dsub_rn(nu, nu_ref);
  const double* q = prm + 2 + 6 * c;
  double loc, wid, amp, a[6];
  evolve(q[0], q[1], logf, dfreq, laws.loc, &loc, a + 0, a + 1);
  evolve(q[2], q[3], logf, dfreq, laws.wid, &wid, a + 2, a + 3);
  evolve(q[4], q[5], logf, dfreq, laws.amp, &amp, a + 4, a + 5);
  double mean = fmod(loc, 1.0);  // torch.remainder(loc, 1.0)
  if (mean != 0.0 && mean < 0.0) mean = __dadd_rn(mean, 1.0);
  const bool live = wid > 0.0;
  const double sigma = live ? __ddiv_rn(wid, fwhm) : 1.0;
  s.mean[c] = mean;
  s.sigma[c] = sigma;
  s.amp[c] = amp;
  s.isig[c] = __ddiv_rn(1.0, sigma);
  s.iwid[c] = live ? __ddiv_rn(1.0, wid) : 0.0;
  const bool poisoned = isnan(cross(q[4], amp, laws.amp)) ||
                        (live && (isnan(cross(q[0], loc, laws.loc)) ||
                                  isnan(cross(q[2], wid, laws.wid))));
  s.live[c] = (int)live | ((int)poisoned << 1);
  if (chain != nullptr) {
    for (int k = 0; k < 6; ++k) chain[6 * c + k] = (k < 4 && !live) ? 0.0 : a[k];
  }
}

// pass 1 for block (channel blockIdx.x, lane blockIdx.y, tile blockIdx.z):
// with kNormal the tile's Gram entries into out, a row of npairs + 6 ng + 1
// doubles, and in tile 0 the channel's chain factors and its poison (0, or
// NaN where a component is poisoned); without, its sum of r^2 into *out
template <bool kNormal>
__device__ __forceinline__ void pass1(const double* __restrict__ params,
                                      const double* __restrict__ data,
                                      const double* __restrict__ errs, int64_t erow,
                                      int ebin, const double* __restrict__ bins,
                                      const double* __restrict__ freqs, int ng, int nchan,
                                      int nbin, double nu_ref, double fwhm, Laws laws, int R,
                                      double* __restrict__ scratch) {
  extern __shared__ double smem[];
  const int ch = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int P = 6 * ng + 3, q1 = 3 * ng + 2, npairs = q1 * (q1 + 1) / 2;
  const Smem s = carve(smem, ng, staged_rows(q1, R), staged_pairs(q1, R), kNormal);
  const Tile tl = tile_of(kNormal ? blockIdx.z : 0, q1, kNormal ? R : q1);
  const int ntp = tl.entries();
  const bool first = blockIdx.z == 0;
  const double* prm = params + (int64_t)b * P;
  double* out = kNormal ? scratch + ((int64_t)b * nchan + ch) * (npairs + 6 * ng + 1)
                        : scratch + (int64_t)b * nchan + ch;
  const double nu = freqs[ch];
  for (int c = t; c < ng; c += kThreads)
    setup_component(prm, c, nu, nu_ref, fwhm, laws, s,
                    kNormal && first ? out + npairs : nullptr);
  if (kNormal) {
    for (int p = t; p < kWarps * ntp; p += kThreads) s.acc[p] = 0.0;
    for (int p = t; p < ntp; p += kThreads) {
      int k = 0, k2;
      if (tl.diag) {
        int rem = p;
        while (rem >= tl.na - k) {
          rem -= tl.na - k;
          ++k;
        }
        k2 = k + rem;
      } else {
        k = p / tl.nb;
        k2 = tl.na + p % tl.nb;
      }
      s.pair[p] = (unsigned short)((k << 8) | k2);
    }
  }
  __syncthreads();
  if (kNormal && first && t == 0) {
    bool poisoned = false;
    for (int c = 0; c < ng; ++c) poisoned |= (s.live[c] & 2) != 0;
    out[npairs + 6 * ng] = poisoned ? __longlong_as_double(0x7ff8000000000000LL) : 0.0;
  }

  const double dc = prm[0];
  const int64_t row = (int64_t)ch * nbin;
  const double* erw = errs + (int64_t)ch * erow;
  const int k0 = tl.slot(0), kr = tl.slot(q1 - 1);
  double nx = 0.0, nd = 0.0, ne = 1.0;  // the next round's bin
  if (t < nbin) {
    nx = __ldg(bins + t);
    nd = __ldg(data + row + t);
    ne = __ldg(erw + (int64_t)t * ebin);
  }
  double ss = 0.0;
  const int w = t >> 5, lane = t & 31;
  for (int c0 = 0; c0 < nbin; c0 += kThreads) {
    const bool have = c0 + t < nbin;
    const double xb = nx, d = nd, er = ne;
    const int jn = c0 + kThreads + t;
    if (jn < nbin) {
      nx = __ldg(bins + jn);
      nd = __ldg(data + row + jn);
      ne = __ldg(erw + (int64_t)jn * ebin);
    }
    const double ie = kNormal ? __ddiv_rn(1.0, er) : 0.0;
    double acc = 0.0;
    for (int c = 0; c < ng; ++c) {
      const int ke = kNormal ? tl.slot(1 + 3 * c) : -1;
      const int kl = kNormal ? tl.slot(2 + 3 * c) : -1;
      const int kw = kNormal ? tl.slot(3 + 3 * c) : -1;
      double e = 0.0, vl = 0.0, vw = 0.0;
      if (s.live[c] & 1) {
        double x = __dsub_rn(xb, s.mean[c]);
        if (x > 0.5) x = __dsub_rn(x, 1.0);
        if (x < -0.5) x = __dadd_rn(x, 1.0);
        const double zr = __ddiv_rn(x, s.sigma[c]);
        const double z = zr < -kZmax ? -kZmax : (zr > kZmax ? kZmax : zr);
        e = exp(__dmul_rn(-0.5, __dmul_rn(z, z)));
        if (kNormal && fabs(zr) < kZmax && (kl >= 0 || kw >= 0)) {
          const double ae = __dmul_rn(__dmul_rn(s.amp[c], e), ie);
          vl = __dmul_rn(__dmul_rn(ae, z), s.isig[c]);
          vw = __dmul_rn(__dmul_rn(__dmul_rn(ae, z), z), s.iwid[c]);
        }
      }
      // a dead component adds amp * 0, as the reference's sum does
      acc = __dadd_rn(acc, __dmul_rn(s.amp[c], e));
      if (kNormal) {
        if (ke >= 0) s.v[ke * kPad + t] = have ? __dmul_rn(e, ie) : 0.0;
        if (kl >= 0) s.v[kl * kPad + t] = have ? vl : 0.0;
        if (kw >= 0) s.v[kw * kPad + t] = have ? vw : 0.0;
      }
    }
    const double r = have ? __ddiv_rn(__dsub_rn(d, __dadd_rn(dc, acc)), er) : 0.0;
    if (kNormal) {
      if (k0 >= 0) s.v[k0 * kPad + t] = have ? ie : 0.0;
      if (kr >= 0) s.v[kr * kPad + t] = r;
      __syncthreads();
      const double* base = s.v + 32 * w;
      for (int p = lane; p < ntp; p += 32) {
        const int qq = s.pair[p];
        const double* u = base + (qq >> 8) * kPad;
        const double* u2 = base + (qq & 255) * kPad;
        double sum = 0.0;
#pragma unroll 8
        for (int k = 0; k < 32; ++k) sum = fma(u[k], u2[k], sum);
        s.acc[w * ntp + p] += sum;
      }
      __syncthreads();
    } else {
      ss = __dadd_rn(ss, __dmul_rn(r, r));
    }
  }

  if (kNormal) {
    for (int p = t; p < ntp; p += kThreads) {
      double sum = 0.0;
      for (int k = 0; k < kWarps; ++k) sum = __dadd_rn(sum, s.acc[k * ntp + p]);
      const int qq = s.pair[p], k = qq >> 8, k2 = qq & 255;
      const int q = tl.a0 + k;
      const int q2 = k2 < tl.na ? tl.a0 + k2 : tl.b0 + k2 - tl.na;
      out[q * q1 - q * (q - 1) / 2 + (q2 - q)] = sum;
    }
  } else {
    __shared__ double part[kWarps];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss = __dadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    if (lane == 0) part[w] = ss;
    __syncthreads();
    if (t == 0) {
      double sum = 0.0;
      for (int k = 0; k < kWarps; ++k) sum = __dadd_rn(sum, part[k]);
      *out = sum;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gauss_normal_kernel(const double* __restrict__ params, const double* __restrict__ data,
                    const double* __restrict__ errs, int64_t erow, int ebin,
                    const double* __restrict__ bins, const double* __restrict__ freqs,
                    int ng, int nchan, int nbin, double nu_ref, double fwhm, Laws laws,
                    int R, double* __restrict__ scratch) {
  pass1<true>(params, data, errs, erow, ebin, bins, freqs, ng, nchan, nbin, nu_ref, fwhm, laws,
              R, scratch);
}

__global__ void __launch_bounds__(kThreads)
gauss_sse_kernel(const double* __restrict__ params, const double* __restrict__ data,
                 const double* __restrict__ errs, int64_t erow, int ebin,
                 const double* __restrict__ bins, const double* __restrict__ freqs, int ng,
                 int nchan, int nbin, double nu_ref, double fwhm, Laws laws,
                 double* __restrict__ scratch) {
  pass1<false>(params, data, errs, erow, ebin, bins, freqs, ng, nchan, nbin, nu_ref, fwhm, laws,
               0, scratch);
}

// parameter p's basis row in pass 1's Gram matrix, -1 for tau and the
// scattering index (their columns are 0)
__device__ __forceinline__ int basis_of(int p, int P) {
  if (p == 0) return 0;
  if (p == 1 || p == P - 1) return -1;
  const int c = (p - 2) / 6, k = (p - 2) % 6;
  return k < 2 ? 2 + 3 * c : (k < 4 ? 3 + 3 * c : 1 + 3 * c);
}

// pass 2, one block a lane: JtJ (both triangles), g and f from the
// channels' scratch rows, each channel's poison added to every g and JtJ
// term (forward-mode's NaN in every column)
__global__ void __launch_bounds__(kChainThreads)
gauss_chain_kernel(const double* __restrict__ scratch, int ng, int nchan,
                   double* __restrict__ f, double* __restrict__ g, double* __restrict__ JtJ) {
  __shared__ double part[kChainThreads];
  const int b = blockIdx.x, t = threadIdx.x;
  const int P = 6 * ng + 3, q1 = 3 * ng + 2, npairs = q1 * (q1 + 1) / 2;
  const int W = npairs + 6 * ng + 1, nupper = P * (P + 1) / 2, nout = nupper + P + 1;
  int nslices = kChainThreads / nout;
  nslices = nslices < 1 ? 1 : (nslices > nchan ? nchan : nslices);
  const double* rows = scratch + (int64_t)b * nchan * W;
  for (int item = t; item < nout * nslices; item += kChainThreads) {
    const int o = item / nslices, sl = item % nslices;
    int pa, pb;  // the output's parameters; pb = -1 for g, -2 for f
    if (o < nupper) {
      int p = 0, rem = o;
      while (rem >= P - p) {
        rem -= P - p;
        ++p;
      }
      pa = p;
      pb = p + rem;
    } else if (o < nupper + P) {
      pa = o - nupper;
      pb = -1;
    } else {
      pa = pb = -2;
    }
    const int qa = pa == -2 ? q1 - 1 : basis_of(pa, P);
    const int qb = pb < 0 ? q1 - 1 : basis_of(pb, P);
    const bool zero = qa < 0 || qb < 0;      // a tau or scattering-index column
    const int lo = qa < qb ? qa : qb, hi = qa < qb ? qb : qa;
    const int idx = zero ? 0 : lo * q1 - lo * (lo - 1) / 2 + (hi - lo);
    const int ka = pa > 0 ? npairs + pa - 2 : -1;
    const int kb = pb > 0 ? npairs + pb - 2 : -1;
    const int kp = pa == -2 ? -1 : W - 1;    // f takes no poison
    double sum = 0.0;
#pragma unroll 4
    for (int ch = sl; ch < nchan; ch += nslices) {
      const double* r = rows + (int64_t)ch * W;
      const double ca = ka < 0 ? 1.0 : r[ka];
      const double cb = kb < 0 ? 1.0 : r[kb];
      double term = zero ? 0.0 : __dmul_rn(__dmul_rn(ca, cb), r[idx]);
      if (kp >= 0) term = __dadd_rn(term, r[kp]);
      sum = __dadd_rn(sum, term);
    }
    if (nslices > 1) {
      part[item] = sum;  // nout * nslices <= kChainThreads
    } else {
      if (pb >= 0) {
        JtJ[((int64_t)b * P + pa) * P + pb] = sum;
        JtJ[((int64_t)b * P + pb) * P + pa] = sum;
      } else if (pb == -1) {
        g[(int64_t)b * P + pa] = __dsub_rn(0.0, sum);
      } else {
        f[b] = sum;
      }
    }
  }
  if (nslices == 1) return;
  __syncthreads();
  for (int o = t; o < nout; o += kChainThreads) {
    double sum = 0.0;
    for (int k = 0; k < nslices; ++k) sum = __dadd_rn(sum, part[o * nslices + k]);
    if (o < nupper) {
      int p = 0, rem = o;
      while (rem >= P - p) {
        rem -= P - p;
        ++p;
      }
      JtJ[((int64_t)b * P + p) * P + p + rem] = sum;
      JtJ[((int64_t)b * P + p + rem) * P + p] = sum;
    } else if (o < nupper + P) {
      g[(int64_t)b * P + o - nupper] = __dsub_rn(0.0, sum);
    } else {
      f[b] = sum;
    }
  }
}

// epilogue A's channel sum, one block a lane
__global__ void __launch_bounds__(kSumThreads)
gauss_fsum_kernel(const double* __restrict__ part, int nchan, double* __restrict__ f) {
  __shared__ double warp_sum[kSumThreads / 32];
  const int b = blockIdx.x, t = threadIdx.x;
  double s = 0.0;
  for (int ch = t; ch < nchan; ch += kSumThreads)
    s = __dadd_rn(s, part[(int64_t)b * nchan + ch]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if ((t & 31) == 0) warp_sum[t >> 5] = s;
  __syncthreads();
  if (t == 0) {
    double sum = 0.0;
    for (int k = 0; k < kSumThreads / 32; ++k) sum = __dadd_rn(sum, warp_sum[k]);
    f[b] = sum;
  }
}

size_t pass1_smem(int ng, bool normal, int R) {
  const int q1 = 3 * ng + 2, srows = staged_rows(q1, R), spairs = staged_pairs(q1, R);
  size_t doubles = 5 * (size_t)ng;
  if (normal) doubles += (size_t)srows * kPad + (size_t)kWarps * spairs;
  return 8 * doubles + 4 * (size_t)ng + (normal ? 2 * (size_t)spairs : 0);
}

}  // namespace

// params [B, 6 ngauss + 3], data [nchan, nbin], errs [nchan, nbin] through
// its strides (errs_row, errs_bin: 0 for per-channel errors broadcast over
// the bins, else 1), bins [nbin] (bin centres), freqs [nchan], all f64;
// nu_ref; fwhm = 2 sqrt(2 ln 2); the model-code digits of loc, wid and amp
// (0 power law, 1 linear); tile_rows, the Gram rows a tile of pass 1 takes
// (3 ngauss + 2 or more for one tile, else at most 127); scratch
// [B, nchan, npairs + 6 ngauss + 1] f64; f [B], g [B, P], JtJ [B, P, P] f64
// out.
// Launches pass 1 and pass 2 on `stream`; returns the first cudaError_t.
extern "C" int pp_gauss_normal(const void* params, const void* data, const void* errs,
                               int64_t errs_row, int errs_bin, const void* bins,
                               const void* freqs, int B, int ngauss, int nchan, int nbin,
                               double nu_ref, double fwhm, int law_loc, int law_wid,
                               int law_amp, int tile_rows, void* scratch, void* f, void* g,
                               void* JtJ, void* stream) {
  if (B <= 0 || nchan <= 0 || nbin <= 0) return 0;
  const int q1 = 3 * ngauss + 2;
  const int R = tile_rows < q1 ? tile_rows : q1;
  if (R < 1 || staged_rows(q1, R) > 255) return (int)cudaErrorInvalidValue;
  const int nblk = (q1 + R - 1) / R, ntiles = nblk * (nblk + 1) / 2;
  if (ntiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = pass1_smem(ngauss, true, R);
  cudaError_t err = cudaFuncSetAttribute(gauss_normal_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Laws laws{law_loc, law_wid, law_amp};
  gauss_normal_kernel<<<dim3(nchan, B, ntiles), kThreads, smem, st>>>(
      (const double*)params, (const double*)data, (const double*)errs, errs_row, errs_bin,
      (const double*)bins, (const double*)freqs, ngauss, nchan, nbin, nu_ref, fwhm, laws, R,
      (double*)scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gauss_chain_kernel<<<B, kChainThreads, 0, st>>>((const double*)scratch, ngauss, nchan,
                                                   (double*)f, (double*)g, (double*)JtJ);
  return (int)cudaGetLastError();
}

// the same arguments without tile_rows, g and JtJ; scratch [B, nchan] f64.
extern "C" int pp_gauss_sse(const void* params, const void* data, const void* errs,
                            int64_t errs_row, int errs_bin, const void* bins,
                            const void* freqs, int B, int ngauss, int nchan, int nbin,
                            double nu_ref, double fwhm, int law_loc, int law_wid, int law_amp,
                            void* scratch, void* f, void* stream) {
  if (B <= 0 || nchan <= 0 || nbin <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = pass1_smem(ngauss, false, 0);
  cudaError_t err = cudaFuncSetAttribute(gauss_sse_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Laws laws{law_loc, law_wid, law_amp};
  gauss_sse_kernel<<<dim3(nchan, B), kThreads, smem, st>>>(
      (const double*)params, (const double*)data, (const double*)errs, errs_row, errs_bin,
      (const double*)bins, (const double*)freqs, ngauss, nchan, nbin, nu_ref, fwhm, laws,
      (double*)scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gauss_fsum_kernel<<<B, kSumThreads, 0, st>>>((const double*)scratch, nchan, (double*)f);
  return (int)cudaGetLastError();
}
