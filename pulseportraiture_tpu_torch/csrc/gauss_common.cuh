// Pieces shared by K9 (gauss.cu) and K10 (gauss_ft.cu): the Gaussian
// portrait's components at a channel (the evolution laws, the basis values
// of a bin, forward-mode's NaN poison), the rows of per-lane sums' upper
// triangle, the channel tree of last-block counters that sums them in a
// fixed order, one 16x8x8 FP64 tensor-core product, and the H100 limits
// and tree shape both kernels' launches read.  See gauss.cu's header for
// the arithmetic each follows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kZmax = 20.0;
constexpr int kPanelRows = 64;      // the Gram rows in a panel's row block
constexpr int kSmemMax = 232448;    // shared memory a block may take on an H100
// the channel tree's least fan-in, and the doubles a node may read (a wider
// fan where the rows are short); the bytes a lane's rows of sums may take
// before a Gram's blocks group channels
constexpr int kFan = 8;
constexpr int kFanDoubles = 1024;
constexpr int64_t kRowBudget = int64_t(1) << 28;


struct Laws {
  int loc, wid, amp;
};

// the channel tree: nleaf rows a lane, summed fan at a time up to one
struct Tree {
  int nleaf, fan;
};

// a lane's scratch rows (the leaves', then every level's but the root's)
// and counters (every level's nodes)
__host__ __device__ inline void tree_sizes(Tree tr, int64_t* rows, int* counters) {
  int n = tr.nleaf, c = 0;
  int64_t r = tr.nleaf;
  for (;;) {
    n = (n + tr.fan - 1) / tr.fan;
    c += n;
    if (n == 1) break;
    r += n;
  }
  *rows = r;
  *counters = c;
}

// one component's values at one channel, in shared memory
struct Comp {
  double *mean, *isig, *amp, *iwid, *chain;  // chain: six a component, or null
  int* live;                                 // bit 0 live, bit 1 poisoned
};

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

// component c's evolved values at channel nu into shared memory and, when
// s.chain is given, its six chain factors (loc0, dloc, wid0, dwid, amp0,
// damp), the loc and wid ones zeroed where wid <= 0.  The component is
// poisoned where forward-mode would carry a NaN tangent of its evolved
// values (a power law's p0 = 0) into every column: through amp always,
// through loc and wid where it is live
__device__ void setup_component(const double* __restrict__ prm, int c, double nu,
                                double nu_ref, double fwhm, Laws laws, const Comp& s) {
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
  s.amp[c] = amp;
  s.isig[c] = __ddiv_rn(1.0, sigma);
  s.iwid[c] = live ? __ddiv_rn(1.0, wid) : 0.0;
  const bool poisoned = isnan(cross(q[4], amp, laws.amp)) ||
                        (live && (isnan(cross(q[0], loc, laws.loc)) ||
                                  isnan(cross(q[2], wid, laws.wid))));
  s.live[c] = (int)live | ((int)poisoned << 1);
  if (s.chain != nullptr) {
    for (int k = 0; k < 6; ++k) s.chain[6 * c + k] = (k < 4 && !live) ? 0.0 : a[k];
  }
}

// the channel's poison (0, or NaN where a component is poisoned)
__device__ __forceinline__ double channel_poison(const int* live, int ng) {
  bool poisoned = false;
  for (int c = 0; c < ng; ++c) poisoned |= (live[c] & 2) != 0;
  return poisoned ? __longlong_as_double(0x7ff8000000000000LL) : 0.0;
}

// component c at bin centre xb: e, and with kBasis its loc and wid basis
// values (times w); e = 0 for a dead component
template <bool kBasis>
__device__ __forceinline__ double component(double xb, int c, const Comp& s, double w, double* vl,
                                            double* vw) {
  double e = 0.0;
  if (kBasis) *vl = *vw = 0.0;
  if (s.live[c] & 1) {
    double x = __dsub_rn(xb, s.mean[c]);
    if (x > 0.5) x = __dsub_rn(x, 1.0);
    if (x < -0.5) x = __dadd_rn(x, 1.0);
    const double isig = s.isig[c];
    const double zr = __dmul_rn(x, isig);
    const double z = zr < -kZmax ? -kZmax : (zr > kZmax ? kZmax : zr);
    e = exp(__dmul_rn(-0.5, __dmul_rn(z, z)));
    if (kBasis && fabs(zr) < kZmax) {
      const double ae = __dmul_rn(__dmul_rn(s.amp[c], e), w);
      *vl = __dmul_rn(__dmul_rn(ae, z), isig);
      *vw = __dmul_rn(__dmul_rn(__dmul_rn(ae, z), z), s.iwid[c]);
    }
  }
  return e;
}


// offset of row p of an upper triangle over L parameters, stored row by row
__host__ __device__ __forceinline__ int64_t upper_off(int p, int L) {
  return (int64_t)p * L - (int64_t)p * (p - 1) / 2;
}

// (p, q), p <= q, of entry o of that triangle
__device__ __forceinline__ void upper_pq(int64_t o, int L, int* p, int* q) {
  const double a = 2.0 * L + 1.0;
  int pp = (int)floor(0.5 * (a - sqrt(a * a - 8.0 * (double)o)));
  pp = pp < 0 ? 0 : (pp > L - 1 ? L - 1 : pp);
  while (pp + 1 < L && upper_off(pp + 1, L) <= o) ++pp;
  while (pp > 0 && upper_off(pp, L) > o) --pp;
  *p = pp;
  *q = pp + (int)(o - upper_off(pp, L));
}


__device__ __forceinline__ void put(double* p, double v, bool add) {
  *p = add ? __dadd_rn(*p, v) : v;
}


// entries 0 .. count - 1 of nc child rows of stride W (read from L2: other
// blocks wrote them), each summed in child order and handed to out(o, sum);
// part holds blockDim.x doubles.  The loads of eight children (and of four
// outputs a thread) are all in flight before their sums.
template <class Out>
__device__ void node_sum(const double* __restrict__ child, int nc, int64_t W, int64_t count,
                         double* part, Out out) {
  const int T = blockDim.x, t = threadIdx.x;
  if (count >= T || nc == 1) {
    for (int64_t o0 = t; o0 < count; o0 += 4 * (int64_t)T) {
      double s[4] = {0.0, 0.0, 0.0, 0.0};
      for (int k0 = 0; k0 < nc; k0 += 8) {
        double v[4][8];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int64_t o = o0 + (int64_t)u * T;
            v[u][k] = (k0 + k < nc && o < count) ? __ldcg(child + (k0 + k) * W + o) : 0.0;
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (k0 + k < nc) s[u] = __dadd_rn(s[u], v[u][k]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (o0 + (int64_t)u * T < count) out(o0 + (int64_t)u * T, s[u]);
    }
    return;
  }
  const int n = (int)count, nsl = min(T / n, nc);
  if (t < nsl * n) {
    const int o = t % n, sl = t / n;
    double s = 0.0;
    for (int k0 = sl; k0 < nc; k0 += 8 * nsl) {
      double v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = k0 + k * nsl;
        v[k] = c < nc ? __ldcg(child + c * W + o) : 0.0;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k0 + k * nsl < nc) s = __dadd_rn(s, v[k]);
    }
    part[t] = s;
  }
  __syncthreads();
  if (t < n) {
    double s = 0.0;
    for (int sl = 0; sl < nsl; ++sl) s = __dadd_rn(s, part[sl * n + t]);
    out(t, s);
  }
}

// After the block has written its leaf row: while it is the last of its
// node's children to finish, sum the node's children in order (into the
// node's row, or at the root through root(child rows, count)).
template <class Root>
__device__ void climb(double* rows, int* cnt, int leaf, Tree tr, int64_t W, double* part,
                      int* last, Root root) {
  int n = tr.nleaf, idx = leaf, cntoff = 0;
  int64_t rowoff = 0, next = tr.nleaf;
  for (;;) {
    const int m = (n + tr.fan - 1) / tr.fan, parent = idx / tr.fan;
    const int c0 = parent * tr.fan, nc = min(tr.fan, n - c0);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(cnt + cntoff + parent, 1) == nc - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    if (threadIdx.x == 0) cnt[cntoff + parent] = 0;  // the next call starts at 0
    const double* child = rows + (rowoff + c0) * W;
    if (m == 1) {
      root(child, nc);
      return;
    }
    double* out = rows + (next + parent) * W;
    node_sum(child, nc, W, W, part, [&](int64_t o, double v) { out[o] = v; });
    idx = parent;
    n = m;
    rowoff = next;
    next += m;
    cntoff += m;
  }
}


// d += a b for one 16x8x8 tile (gq = lane / 4, tq = lane % 4):
//   a = A[gq][tq], A[gq+8][tq], A[gq][tq+4], A[gq+8][tq+4];  b = B[tq][gq], B[tq+4][gq];
//   d = D[gq][2tq], D[gq][2tq+1], D[gq+8][2tq], D[gq+8][2tq+1].
// (m8n8k4 runs at half the FP64 tensor rate on the H100; m16n8k8 at the full.)
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// a kernel's dynamic shared memory: refused past kSmemMax, opted in past
// the default 48 KB
inline cudaError_t set_smem(const void* kernel, size_t smem) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
