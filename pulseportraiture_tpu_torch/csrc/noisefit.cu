// K11: the "fit" noise estimator, one pass a row over cuFFT's spectrum.
//
// Replaces pulseportraiture_tpu/ops/noise.py:64 find_kc and :108
// get_noise_fit of the JAX reference (a brute fit of b s_a(k) + dc to each
// row's log10 power spectrum over a 20 x 20 x 20 (a, b, dc) grid, as the
// reference's opt.brute; the noise-floor cutoff k_c it gives; the noise from
// the harmonics at and above min(fact k_c, int(0.99 nharm))).  The port's
// torch version (ops/noise.py _argmin_a, kept as _kernels.noise_fit_plain)
// took ~75 small launches and ~1 GB temporaries per 16,384-row block.  The
// rFFT stays with cuFFT (torch.fft.rfft, in chunks of rows); this kernel
// reads each row's spectrum once.
//
// For each row of N harmonics (pows p_k = (re*re + im*im) / nbin from the
// spectrum, or given), in the order of operations of _argmin_a and
// get_noise_fit, each product and sum rounded, no fused multiply-add:
//
//   l_k = log10 p_k; finite = all l_k finite; lmin, lmax; mean = sum l / N
//   b_j  = (lmax - lmin) t_j, dc_j = lmin (1 - t_j) + lmax t_j, t_j = j /
//          (Ns - 1), the last point the stop itself (_linspace_rows)
//   y_k = l_k - mean; Sy = sum y; Syy = sum y^2; Ya_u = sum y_k s_u(k) over
//          the distinct shapes u of the a grid (the table of _kc_grid, equal
//          shapes one row, so that their a tie bit for bit)
//   d = dc - mean; T = (b b) S2_a - (2 b) Ya_a; U = (N d) d - (2 d) Sy;
//   V = ((2 b) d) S1_a; chi2 = ((Syy + T) + U) + V at every (a, b, dc)
//   the argmin, the first flat index (a-major) on ties, NaN first (as
//          torch.argmin); a = a_0 for a row that is not finite
//   k_c = kc_table[a]; k_crit = min(fact k_c, cap); noise = sqrt(sum of p_k
//          over k >= k_crit / their count)
//
// Sums run in a fixed order: lane q of the row's warp takes k = q + 32j in
// order of j, a five-level xor-shuffle tree joins the lanes; no atomics.  So
// a row's result depends on nothing but the row, and the kernel differs from
// its plain version only in the order of its sums.
//
// What bounds it on an H100: bytes.  The spectrum is read once: 131,072 rows
// of 1025 complex128 harmonics is 2.15 GB, >= 0.64 ms at 3.35 TB/s.  The FP64
// work is ~0.5 ms: a log10 twice a harmonic, the Ns dot products over the
// harmonics and 7 operations at each of the Ns^3 grid points.
//
// Design: one warp a row, up to eight rows a block (fewer where a row's
// power does not fit: the host picks the rows a block from N and Ns).
// Where it fits (about 28,900 harmonics at Ns = 20), the row's power is kept
// in shared memory (8 B a harmonic), so the spectrum is read from device
// memory once and the log power re-formed from it in the later passes;
// wider rows re-read the spectrum (or the power) from device memory in each
// pass and re-form the power by the same arithmetic, so both give the same
// bits.  The passes take four harmonics a lane at a time, their loads
// issued together.  The shape accumulators are registers, kAcc at a time:
// the second pass runs once per kAcc distinct shapes (once at Ns <= 20, the
// kFast instantiation below).
// Each row's warp reads the whole shape table (164 KB at N = 1025, from L1
// and L2), which takes about half the kernel's time (k11_parts.py).  The
// grid gives each lane fixed (b, dc) pairs and loops over a, with S1, S2
// and Ya per a in shared memory (read by every lane at once).  Ns is
// bounded only by those tables, 32 Ns bytes for one warp: Ns <= 7264.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxWarps = 8;
constexpr int kAcc = 20;    // shape accumulators a lane holds at once
constexpr int kUnroll = 4;  // harmonics a lane loads at once
// shared memory a block aims at (two blocks an SM); one row's power and
// tables may take up to the card's limit
constexpr size_t kBlockSmem = 110 * 1024;
constexpr size_t kMaxSmem = 232448;

// NaN-propagating min and max, as torch.amin / amax
__device__ __forceinline__ double nan_min(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a < b ? a : b;
}

__device__ __forceinline__ double nan_max(double a, double b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// torch.argmin's order: a NaN before any number, then the smaller value,
// then the smaller flat index
__device__ __forceinline__ bool before(double v, int64_t i, double bv, int64_t bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v < bv || (v == bv && i < bi);
}

// _linspace_rows' point j of Ns from start to stop
__device__ __forceinline__ double lin(double start, double stop, int j, int ns) {
  if (j == ns - 1) return stop;
  const double t = __ddiv_rn((double)j, (double)(ns - 1));
  return __dadd_rn(__dmul_rn(start, __dsub_rn(1.0, t)), __dmul_rn(stop, t));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// harmonic k's power from device memory: |X_k|^2 / nbin of the spectrum, or
// the power given
template <bool kSpectrum>
__device__ __forceinline__ double load_power(const void* __restrict__ src, int64_t at, int nbin) {
  if constexpr (kSpectrum) {
    const double2 x = __ldg((const double2*)src + at);
    return __ddiv_rn(__dadd_rn(__dmul_rn(x.x, x.x), __dmul_rn(x.y, x.y)), (double)nbin);
  } else {
    return __ldg((const double*)src + at);
  }
}

// The kernel, in two instantiations per input kind: kFast, where the row's
// power is kept in shared memory and the distinct shapes fit one pass of
// kAcc accumulators (the default grid at up to ~28,900 harmonics), and the
// general one, which re-reads the power from device memory where it is not
// kept (p null) and runs the second pass once per kAcc shapes.  kFast's
// second pass is the general one's with both choices made at compile time:
// the same arithmetic and bits, and the first design's speed, which the
// general instantiation does not keep (PERF.md, K11).
template <bool kSpectrum, bool kFast>
__global__ void noise_fit_kernel(const void* __restrict__ src, int64_t rows, int n, int nbin,
                                 const double* __restrict__ shapes, int nu,
                                 const int* __restrict__ inverse, const double* __restrict__ S1,
                                 const double* __restrict__ S2,
                                 const int64_t* __restrict__ kc_table, int ns, double fact,
                                 int cap, int onchip, double* __restrict__ noise,
                                 int64_t* __restrict__ kc_out) {
  extern __shared__ double smem[];
  const int warps = blockDim.x / kLanes;
  const int w = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  double* s1 = smem;
  double* s2 = smem + ns;
  double* ya = smem + 2 * ns + (size_t)w * (nu + ns);  // [nu] by shape, then [ns] by a
  double* yaa = ya + nu;
  double* p = kFast || onchip ? smem + 2 * ns + (size_t)warps * (nu + ns) + (size_t)w * n
                              : nullptr;
  for (int a = threadIdx.x; a < ns; a += blockDim.x) {
    s1[a] = S1[a];
    s2[a] = S2[a];
  }
  __syncthreads();
  const int64_t row = (int64_t)blockIdx.x * warps + w;
  if (row >= rows) return;  // a whole warp, after the block's one barrier
  const int64_t base = row * (int64_t)n;
  // the power at k: the row's copy in shared memory, or re-formed
  const auto power = [&](int k) {
    return kFast || p != nullptr ? p[k] : load_power<kSpectrum>(src, base + k, nbin);
  };

  // pass 1: the power (into shared memory where it is kept); finite, lmin,
  // lmax, sum of l.  Lane q's harmonics q + 32j in order of j, kUnroll
  // loads in flight.
  double lsum = 0.0, lmin = INFINITY, lmax = -INFINITY;
  bool fin = true;
  for (int k0 = q; k0 < n; k0 += kUnroll * kLanes) {
    double v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int k = k0 + j * kLanes;
      v[j] = k < n ? load_power<kSpectrum>(src, base + k, nbin) : 0.0;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int k = k0 + j * kLanes;
      if (k < n) {
        if (kFast || p != nullptr) p[k] = v[j];
        const double l = log10(v[j]);
        fin = fin && isfinite(l);
        lsum = __dadd_rn(lsum, l);
        lmin = nan_min(lmin, l);
        lmax = nan_max(lmax, l);
      }
    }
  }
  lsum = warp_sum(lsum);
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    lmin = nan_min(lmin, __shfl_xor_sync(0xffffffffu, lmin, off));
    lmax = nan_max(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
  }
  fin = __all_sync(0xffffffffu, fin);
  const int nn = ns * ns;
  int64_t bi = -1;
  if (fin) {
    const double mean = __ddiv_rn(lsum, (double)n);
    // pass 2, once per kAcc distinct shapes (once for kFast): y, its sums
    // (on the first) and its dot products with the shapes u0 .. u0 + kAcc
    // - 1, kUnroll harmonics a lane at a time
    double sy = 0.0, syy = 0.0;
    for (int u0 = 0; u0 < (kFast ? 1 : nu); u0 += kAcc) {
      double acc[kAcc];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) acc[u] = 0.0;
      for (int k0 = q; k0 < n; k0 += kUnroll * kLanes) {
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int k = k0 + j * kLanes;
          if (k < n) {
            const double y = __dsub_rn(log10(power(k)), mean);
            if (u0 == 0) {
              sy = __dadd_rn(sy, y);
              syy = __dadd_rn(syy, __dmul_rn(y, y));
            }
#pragma unroll
            for (int u = 0; u < kAcc; ++u)
              if (u0 + u < nu)
                acc[u] = __dadd_rn(acc[u],
                                   __dmul_rn(y, __ldg(shapes + (int64_t)(u0 + u) * n + k)));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kAcc; ++u) {
        if (u0 + u < nu) {
          acc[u] = warp_sum(acc[u]);
          if (q == 0) ya[u0 + u] = acc[u];
        }
      }
    }
    sy = warp_sum(sy);
    syy = warp_sum(syy);
    __syncwarp();
    for (int a = q; a < ns; a += kLanes) yaa[a] = ya[inverse[a]];
    __syncwarp();
    // the grid: lane q takes the (b, dc) pairs q + 32i, each over every a
    const double range = __dsub_rn(lmax, lmin);
    double best = INFINITY;
    bi = INT64_MAX;
    for (int pq = q; pq < nn; pq += kLanes) {
      const int jb = pq / ns, jd = pq - jb * ns;
      const double b = lin(0.0, range, jb, ns);
      const double d = __dsub_rn(lin(lmin, lmax, jd, ns), mean);
      const double bb = __dmul_rn(b, b), tb = __dmul_rn(2.0, b);
      const double ud = __dsub_rn(__dmul_rn(__dmul_rn((double)n, d), d),
                                  __dmul_rn(__dmul_rn(2.0, d), sy));
      const double bd = __dmul_rn(tb, d);
      for (int a = 0; a < ns; ++a) {
        const double t = __dsub_rn(__dmul_rn(bb, s2[a]), __dmul_rn(tb, yaa[a]));
        const double chi = __dadd_rn(__dadd_rn(__dadd_rn(syy, t), ud), __dmul_rn(bd, s1[a]));
        const int64_t i = (int64_t)a * nn + pq;
        if (before(chi, i, best, bi)) {
          best = chi;
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const double ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int64_t oi = (int64_t)__shfl_xor_sync(0xffffffffu, (long long)bi, off);
      if (before(ov, oi, best, bi)) {
        best = ov;
        bi = oi;
      }
    }
  }
  const int64_t kc = kc_table[fin ? bi / nn : 0];
  if (noise != nullptr) {
    const double kcrit = fmin(__dmul_rn(fact, (double)kc), (double)cap);
    double s = 0.0;
    int cnt = 0;
    for (int k = q; k < n; k += kLanes) {
      if ((double)k >= kcrit) {
        s = __dadd_rn(s, power(k));
        ++cnt;
      }
    }
    s = warp_sum(s);
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    if (q == 0) noise[row] = __dsqrt_rn(__ddiv_rn(s, (double)cnt));
  }
  if (q == 0) kc_out[row] = kc;
}

// rows a block, whether a row's power is kept on chip, and the block's
// dynamic shared memory, for rows of n harmonics and an a grid of ns points
// with nu distinct shapes (0 rows: the tables do not fit one warp)
int geometry(int n, int ns, int nu, size_t* smem, int* onchip) {
  const size_t fixed = 2 * (size_t)ns * sizeof(double);
  const size_t tables = ((size_t)nu + ns) * sizeof(double);
  const size_t power = (size_t)n * sizeof(double);
  *onchip = fixed + tables + power <= kMaxSmem;
  const size_t per = tables + (*onchip ? power : 0);
  if (fixed + per > kMaxSmem) return 0;
  size_t warps = kBlockSmem > fixed + per ? (kBlockSmem - fixed) / per : 1;
  warps = warps > kMaxWarps ? kMaxWarps : warps;
  *smem = fixed + warps * per;
  return (int)warps;
}

template <bool kSpectrum, bool kFast>
int launch(const void* src, int64_t rows, int n, int nbin, const void* shapes, int nu,
           const void* inverse, const void* S1, const void* S2, const void* kc_table, int ns,
           double fact, int cap, int onchip, void* noise, void* kc_out, int warps, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(noise_fit_kernel<kSpectrum, kFast>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((rows + warps - 1) / warps);
  noise_fit_kernel<kSpectrum, kFast><<<grid, warps * kLanes, smem, stream>>>(
      src, rows, n, nbin, (const double*)shapes, nu, (const int*)inverse, (const double*)S1,
      (const double*)S2, (const int64_t*)kc_table, ns, fact, cap, onchip, (double*)noise,
      (int64_t*)kc_out);
  return (int)cudaGetLastError();
}

}  // namespace

// src [rows, n]: the rows' rFFT, complex128 (interleaved f64; spectrum 1,
// the power |X|^2 / nbin) or their power, f64 (spectrum 0, nbin unused);
// shapes [nu, n] f64 the a grid's distinct shapes, inverse [ns] int32 each
// a's shape, S1 and S2 [ns] f64 each a's sum of its shape and of its
// square, kc_table [ns] int64 each a's cutoff (ops/noise.py _kc_grid);
// fact and cap as get_noise_fit's; noise [rows] f64 (or null: the cutoff
// alone), kc_out [rows] int64.  32 ns bytes at most kMaxSmem (ns <= 7264).
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int pp_noise_fit(const void* src, int spectrum, int64_t rows, int n, int nbin,
                            const void* shapes, int nu, const void* inverse, const void* S1,
                            const void* S2, const void* kc_table, int ns, double fact, int cap,
                            void* noise, void* kc_out, void* stream) {
  if (rows <= 0) return 0;
  if (ns < 1 || nu < 1 || nu > ns || n < 1) return (int)cudaErrorInvalidValue;
  size_t smem;
  int onchip;
  const int warps = geometry(n, ns, nu, &smem, &onchip);
  if (warps == 0) return (int)cudaErrorInvalidValue;
  // the instantiation for the input's kind, and kFast where it applies
  const auto go = [&](auto spec, auto fast) {
    return launch<decltype(spec)::value, decltype(fast)::value>(
        src, rows, n, nbin, shapes, nu, inverse, S1, S2, kc_table, ns, fact, cap, onchip, noise,
        kc_out, warps, smem, (cudaStream_t)stream);
  };
  const std::true_type yes{};
  const std::false_type no{};
  const bool fast = onchip && nu <= kAcc;
  if (spectrum) return fast ? go(yes, yes) : go(yes, no);
  return fast ? go(no, yes) : go(no, no);
}
