// K5: the archive's decode and baseline removal, one warp per profile.
//
// Replaces the load's first two passes over the cube in the JAX reference:
// the DATA column's expansion, pulseportraiture_tpu/io/psrfits.py:451-458
// (raw int16 times DAT_SCL plus DAT_OFFS, in float64 on the host), and
// Archive.remove_baseline, :248 there (each profile less the least mean
// over the nbin circular windows of nwin = max(1, int(0.125 nbin)) bins,
// taken on the host as an rFFT convolution with a boxcar).
//
// Input as stored.  pp_unpack reads the DATA column as the file stores it:
// big-endian int16, the rows packed one after another by the host's one
// copy into the pinned upload buffer (io/archive.py), so the FITS record's
// stride and DATA's offset in it never reach the card.  The kernel swaps
// the two bytes of each value in registers (__byte_perm on each 32-bit
// word).  pp_baseline reads float64 rows (after a state conversion or a
// rotation).
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
// What bounds it on an H100: bytes.  At the pptoas archive's 65,536 rows
// of 2048 bins a decode with its baseline reads 0.27 GB of int16 and
// writes 1.07 GB of float64: >= 0.40 ms at 3.35 TB/s.  The window sums
// cost ~6 FP64 operations a bin.
//
// Design.  A persistent grid (as many blocks as fit on the card at once)
// strides over rows.  The decode alone (nwin = 0) gives each row one warp,
// eight warps a block, and no shared memory: pass C below.  The decode with
// the baseline, and the baseline of float64 rows, give each row one block
// of four warps and three block barriers:
//
//   A  the prefix sum, in stripes where lane l holds consecutive bins: 8
//      of stored int16 (one 16-byte load a lane, the warp's load one
//      contiguous 512 bytes) or 2 of float64 (one double2).  Warp w takes
//      stripes w, w + 4, ..., their loads issued before the first is used;
//      each lane adds its bins serially (x_0 taken off first), one shuffle
//      scan of depth 5 over the 32 lane totals (a warp's stripes side by
//      side) gives each lane its offset, and the prefixes within the
//      stripe go to the row's slice of shared memory (nbin doubles, 16 KB
//      at 2048), at places swizzled so that the lanes' writes and pass B's
//      reads meet at most two to a bank pair, the stripe's total to T.
//      Barrier.  Each thread runs over T in order and adds to its stripes'
//      prefixes the sum of the totals before them.  Barrier;
//   B  the windows: each thread takes every 128th window sum from the
//      slice, four at a time so their reads overlap; the least is taken
//      with __shfl_xor and then over the four warps (a NaN wins, as
//      torch.amin's does).  Barrier;
//   C  the output, in groups of 64 bins where lane l holds bins 2l and
//      2l + 1, warp w taking groups w, w + 4, ...: the row is read again
//      (from L2: it was read a moment ago), decoded, and x - level stored
//      as one double2 a lane, so every warp store writes 512 contiguous
//      bytes.
//
// Why not one warp a row, with no barrier at all: built so first, it held
// one row's 16 KB slice per warp, twelve to fourteen warps an SM, and each
// warp's chain of dependent shuffles, adds and shared reads bound it, not
// the card's bandwidth (0.70 ms for the decode with the baseline at
// [65536, 2048], 1.38 for the float64 baseline, on an H100; scans side by
// side to break the chain took 206 registers and ran slower).  Four warps
// to a row give each warp a quarter of the chain and the SM more rows'
// warps.  And why two bins a lane in pass C: eight consecutive bins a lane,
// as in pass A, would make each of its four double2 stores touch sixteen
// lines (0.91 ms for the decode alone against 0.54 for pass C as it is).
//
// Before pass A each block asks L2 for its next row (prefetch.global.L2),
// so that row's bytes are in flight while this one is scanned.  Rows whose
// nbin is not a multiple of 8, or whose rows are not 16-byte aligned, take
// the same passes with scalar loads and stores.  Rows longer than a
// block's shared memory reaches (nbin above kMaxSharedBins) keep their
// slice in a global scratch buffer, one per block: no nbin is refused.
//
// Error of the window sums.  The reference is taken off before the prefix
// sum, so every term is bounded by the row's spread R = max x - min x and
// not by DAT_OFFS, and every partial sum by nbin R.  A prefix is
// (ex + t) + carry: at most V - 1 serial additions in its lane (V = 8 or
// 2), 5 in the shuffle scan, one carry per stripe before it (ns - 1, ns =
// nbin / (32 V)) and 2 to join them, so |P_j - exact| <= (V + ns + 6) eps
// nbin R; S_j, a difference of two prefixes (three when it wraps), is off
// by at most three times that, and the window mean (divided by nwin =
// nbin / 8) by 24 (V + ns + 6) eps R: 1.2e-13 R at nbin 2048 for the
// stored column (2.1e-13 R for float64 rows) in the worst case, within
// LOAD_TOL (1e-12 of each row's range) of the plain version, whose FFT
// convolution errs by about log2(nbin) eps max |x|, offset included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 64;            // bins of one pass C group: 32 lanes x 2
constexpr int kDecodeWarps = 8;       // warps of a decode-only block (a row each)
constexpr int kScanWarps = 4;         // warps sharing one row in the scan
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kSmemMax = 232448;      // the shared memory a block may ask for (227 KB)
// the longest row whose slice (with its stripe totals) fits a block's
// shared memory; above it the slices live in scratch (the wrapper's
// UNPACK_MAX_SHARED_BINS)
constexpr int kMaxSharedBins = 28000;

struct Args {
  const void* in;      // [rows, nbin]: int16 as stored (big-endian), or float64
  const double* scl;   // [rows] (stored input)
  const double* offs;  // [rows] (stored input)
  double* out;         // [rows, nbin] (may be `in` for float64 input)
  double* scratch;     // [blocks, slice_len(nbin)] when the slices are not in shared memory
  int64_t rows;
  int nbin;
  int nwin;            // 0: decode only
  int warps;           // decode only: the grid's warps, the stride over rows
  int staged;          // scan: the row's input kept in shared memory for pass C
};

// a row's prefix slice, in doubles (16-byte multiples)
__host__ __device__ constexpr int slice_len(int nbin) { return (nbin + 15) & ~15; }

// pass A's bins of one lane in a stripe: eight int16 (one 16-byte word) or
// two float64 (one double2); a stripe is 32 lanes of them
__host__ __device__ constexpr int lane_bins(bool stored) { return stored ? 8 : 2; }

// stripes of a row
__host__ __device__ constexpr int stripes(int nbin, bool stored) {
  return (nbin + 32 * lane_bins(stored) - 1) / (32 * lane_bins(stored));
}

// doubles before the slice in a scan block's shared memory: the stripe
// totals T and the warps' least window sums M, to a 16-byte multiple
__host__ __device__ constexpr int header_len(int nbin, bool stored) {
  return (stripes(nbin, stored) + kScanWarps + 1) & ~1;
}

// doubles of the staged input: the bins pass A loads (whole lanes' worth)
__host__ __device__ constexpr int stage_len(int nbin, bool stored) {
  return stored ? (((nbin + 7) & ~7) * 2 + 15) / 16 * 2 : (nbin + 1) & ~1;
}

// The place of prefix q in a row's slice: the low three bits of its column
// in a row of 16 doubles flipped by the row.  In pass A lane l writes
// prefix 8l + i (int16) or 2l + i (float64) of its stripe for each i:
// without the flip the 32 lanes would meet on two (four) bank pairs, with
// it on sixteen, two lanes each.  A permutation inside each aligned group
// of 8, so every place stays below slice_len.
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 4) & 7); }

// Value `hi` (0: the low half) of a 32-bit word holding two stored int16,
// decoded: its two bytes swapped to native order, then raw * scl + offs
// rounded as numpy does.
__device__ __forceinline__ double decode(uint32_t w, int hi, double s, double o) {
  const uint32_t n = __byte_perm(w, 0u, 0x2301u);
  const int v = hi ? (int)(int16_t)(uint16_t)(n >> 16) : (int)(int16_t)(uint16_t)(n & 0xffffu);
  return __dadd_rn(__dmul_rn((double)v, s), o);
}

// Pass A's bins of one lane in one stripe, as loaded.
template <bool STORED>
struct Stripe;

// int16 as stored: four 32-bit words, each two big-endian values, one
// 16-byte load (eight 2-byte loads where the row is not 16-byte aligned)
template <>
struct Stripe<true> {
  uint32_t w[4];
  __device__ __forceinline__ void zero() { w[0] = w[1] = w[2] = w[3] = 0u; }
  template <bool VEC>
  __device__ __forceinline__ void load(const Args& a, int64_t row, int b) {
    const unsigned short* p =
        static_cast<const unsigned short*>(a.in) + row * (int64_t)a.nbin + b;
    if (VEC) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = b + 2 * k < a.nbin ? (uint32_t)__ldg(p + 2 * k) : 0u;
        const uint32_t hi = b + 2 * k + 1 < a.nbin ? (uint32_t)__ldg(p + 2 * k + 1) : 0u;
        w[k] = lo | (hi << 16);
      }
    }
  }
  __device__ __forceinline__ double x(int i, double s, double o) const {
    return decode(w[i >> 1], i & 1, s, o);
  }
};

// float64: two consecutive values
template <>
struct Stripe<false> {
  double d[2];
  __device__ __forceinline__ void zero() { d[0] = d[1] = 0.0; }
  template <bool VEC>
  __device__ __forceinline__ void load(const Args& a, int64_t row, int b) {
    // plain loads: pp_baseline may write its input in place
    const double* p = static_cast<const double*>(a.in) + row * (int64_t)a.nbin + b;
    if (VEC) {
      const double2 q = *reinterpret_cast<const double2*>(p);
      d[0] = q.x;
      d[1] = q.y;
    } else {
      d[0] = p[0];
      d[1] = b + 1 < a.nbin ? p[1] : 0.0;
    }
  }
  __device__ __forceinline__ double x(int i, double, double) const { return d[i]; }
};

// Pass C's two consecutive bins b, b + 1 of one lane (b = 64 g + 2 lane), so
// that the warp's loads and its double2 stores each cover one contiguous
// run of the row.
template <bool STORED>
struct Pair;

template <>
struct Pair<true> {
  uint32_t w;
  template <bool VEC>
  __device__ __forceinline__ void load(const Args& a, int64_t row, int b) {
    const unsigned short* p =
        static_cast<const unsigned short*>(a.in) + row * (int64_t)a.nbin + b;
    if (VEC) {
      w = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      const uint32_t lo = (uint32_t)__ldg(p);
      const uint32_t hi = b + 1 < a.nbin ? (uint32_t)__ldg(p + 1) : 0u;
      w = lo | (hi << 16);
    }
  }
  __device__ __forceinline__ double x(int i, double s, double o) const {
    return decode(w, i, s, o);
  }
};

template <>
struct Pair<false> : Stripe<false> {};

template <bool VEC>
__device__ __forceinline__ void store2(double* orow, int b, int nbin, double v0, double v1) {
  if (VEC) {
    *reinterpret_cast<double2*>(orow + b) = make_double2(v0, v1);
  } else {
    orow[b] = v0;
    if (b + 1 < nbin) orow[b + 1] = v1;
  }
}

// Ask L2 for row `row` (if there is one): one 128-byte line a thread at a
// time, `nthreads` threads.
template <bool STORED>
__device__ __forceinline__ void prefetch_row(const Args& a, int64_t row, int t, int nthreads) {
  if (row >= a.rows) return;
  const int64_t bytes = (int64_t)a.nbin * (STORED ? 2 : 8);
  const char* p = static_cast<const char*>(a.in) + row * bytes;
  for (int64_t k = (int64_t)t * 128; k < bytes; k += (int64_t)nthreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + k));
}

// Pass C (and the decode alone): the row's groups first, first + step, ...
// decoded, less `level` when `sub`, stored; U groups' loads issued before
// the first is used.
template <bool STORED, bool VEC, int U>
__device__ __forceinline__ void emit_row(const Args& a, int64_t row, int lane, int first,
                                         int step, double s, double o, bool sub, double level) {
  const int nbin = a.nbin, ng = (nbin + kGroup - 1) / kGroup;
  double* orow = a.out + row * (int64_t)nbin;
  for (int g0 = first; g0 < ng; g0 += U * step) {
    Pair<STORED> c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = (g0 + u * step) * kGroup + 2 * lane;
      if (g0 + u * step < ng && b < nbin) c[u].template load<VEC>(a, row, b);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = (g0 + u * step) * kGroup + 2 * lane;
      if (g0 + u * step < ng && b < nbin) {
        const double x0 = c[u].x(0, s, o), x1 = c[u].x(1, s, o);
        store2<VEC>(orow, b, nbin, sub ? __dsub_rn(x0, level) : x0,
                    sub ? __dsub_rn(x1, level) : x1);
      }
    }
  }
}

// Pass C from the row's input kept in shared memory by pass A: this warp
// writes the groups of its own stripes (2l, 2l + 1 of each 64 bins a lane,
// one double2), each read where a lane of this warp put it.
template <bool STORED, bool VEC>
__device__ __forceinline__ void emit_staged(const Args& a, int64_t row, int lane, int warp,
                                            double s, double o, double level,
                                            const void* stage) {
  constexpr int GPS = 32 * lane_bins(STORED) / kGroup;  // groups a stripe: 4 or 1
  const int nbin = a.nbin, ns = stripes(nbin, STORED);
  double* orow = a.out + row * (int64_t)nbin;
  for (int st = warp; st < ns; st += kScanWarps) {
#pragma unroll
    for (int k = 0; k < GPS; ++k) {
      const int b = (st * GPS + k) * kGroup + 2 * lane;
      if (b < nbin) {
        double x0, x1;
        if constexpr (STORED) {
          const uint32_t w = static_cast<const uint32_t*>(stage)[b >> 1];
          x0 = decode(w, 0, s, o);
          x1 = decode(w, 1, s, o);
        } else {
          const double2 v = static_cast<const double2*>(stage)[b >> 1];
          x0 = v.x;
          x1 = v.y;
        }
        store2<VEC>(orow, b, nbin, __dsub_rn(x0, level), __dsub_rn(x1, level));
      }
    }
  }
}

// Pass A, first half: for this warp's stripes (warp, warp + 4, ...), each
// lane's serial sums of its bins less `ref`, one shuffle scan over the 32
// lane totals, the prefixes within the stripe into `slice` (swizzled;
// place q holds the sum through bin q) and the stripe's total into
// T[stripe].  U stripes' loads are issued before the first is used, and
// their scans run side by side.
template <bool STORED, bool VEC>
__device__ __forceinline__ void prefix_in_stripes(const Args& a, int64_t row, int lane,
                                                  int warp, double s, double o, double ref,
                                                  double* slice, double* T, void* stage) {
  constexpr int V = lane_bins(STORED), SW = 32 * V, U = STORED ? 2 : 8;
  const int nbin = a.nbin, ns = stripes(nbin, STORED);
  for (int s0 = warp; s0 < ns; s0 += U * kScanWarps) {
    Stripe<STORED> c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int st = s0 + u * kScanWarps, b = st * SW + lane * V;
      if (st < ns && b < nbin)
        c[u].template load<VEC>(a, row, b);
      else
        c[u].zero();
    }
    if (stage != nullptr) {  // the loaded bins, as stored, for pass C
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int b = (s0 + u * kScanWarps) * SW + lane * V;
        if (s0 + u * kScanWarps < ns && b < nbin) {
          if constexpr (STORED)
            static_cast<uint4*>(stage)[b >> 3] =
                make_uint4(c[u].w[0], c[u].w[1], c[u].w[2], c[u].w[3]);
          else
            static_cast<double2*>(stage)[b >> 1] = make_double2(c[u].d[0], c[u].d[1]);
        }
      }
    }
    double t[U][V], inc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = (s0 + u * kScanWarps) * SW + lane * V;
      double run = 0.0;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const double y = b + i < nbin ? __dsub_rn(c[u].x(i, s, o), ref) : 0.0;
        run = i ? __dadd_rn(run, y) : y;
        t[u][i] = run;
      }
      inc[u] = run;
    }
#pragma unroll
    for (int k = 1; k < 32; k <<= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const double n = __shfl_up_sync(kFull, inc[u], k);
        if (lane >= k) inc[u] = __dadd_rn(inc[u], n);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int st = s0 + u * kScanWarps, b = st * SW + lane * V;
      double ex = __shfl_up_sync(kFull, inc[u], 1);
      ex = lane ? ex : 0.0;
      if (st < ns) {  // the same for every lane of the warp
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (b + i < nbin) slice[swz(b + i)] = __dadd_rn(ex, t[u][i]);
        if (lane == 31) T[st] = inc[u];
      }
    }
  }
}

// Pass A, second half: every thread runs over the stripe totals T in order
// (one order for all, so each carry is one number), adding to the
// prefixes of each of its warp's stripes the sum of the totals before it.
template <bool STORED>
__device__ __forceinline__ void add_carries(int nbin, int lane, int warp, double* slice,
                                            const double* T) {
  constexpr int V = lane_bins(STORED), SW = 32 * V;
  const int ns = stripes(nbin, STORED);
  double acc = T[0];
  for (int st = 1; st < ns; ++st) {
    if ((st - warp) % kScanWarps == 0) {
      const int b = st * SW + lane * V;
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (b + i < nbin) {
          const int q = swz(b + i);
          slice[q] = __dadd_rn(slice[q], acc);
        }
    }
    acc = __dadd_rn(acc, T[st]);
  }
}

// The least of a and b, NaN if either is (torch.amin's rule).
__device__ __forceinline__ double nanmin(double a, double b) {
  return (isnan(b) || b < a) ? b : a;
}

// The decode and baseline (STORED) or the baseline alone of rows, a block
// of four warps to a row: passes A, B and C with three block barriers a
// row.  Dynamic shared memory: T (the stripe totals), M (the warps' least
// window sums), then the slice unless it is in scratch.
template <bool STORED, bool VEC>
__device__ __forceinline__ void scan_rows(const Args& a, double* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nbin = a.nbin, nwin = a.nwin;
  double* T = smem;
  double* M = T + stripes(nbin, STORED);
  double* slice = a.scratch != nullptr ? a.scratch + (int64_t)blockIdx.x * slice_len(nbin)
                                       : smem + header_len(nbin, STORED);
  void* stage = a.staged ? smem + header_len(nbin, STORED) + slice_len(nbin) : nullptr;
  for (int64_t row = blockIdx.x; row < a.rows; row += gridDim.x) {
    prefetch_row<STORED>(a, row + gridDim.x, threadIdx.x, kScanThreads);
    const double s = STORED ? a.scl[row] : 0.0, o = STORED ? a.offs[row] : 0.0;
    double ref;  // x_0, read by every thread before any writes the row
    if constexpr (STORED)
      ref = decode(__ldg(static_cast<const unsigned short*>(a.in) + row * (int64_t)nbin), 0,
                   s, o);
    else
      ref = static_cast<const double*>(a.in)[row * (int64_t)nbin];
    prefix_in_stripes<STORED, VEC>(a, row, lane, warp, s, o, ref, slice, T, stage);
    __syncthreads();
    add_carries<STORED>(nbin, lane, warp, slice, T);
    __syncthreads();
    // pass B: the least window sum, P_j read at place j - 1 (P_0 = 0);
    // four window sums a thread at a time, so their reads overlap
    const double total = slice[swz(nbin - 1)];
    double mn = INFINITY;
    for (int j0 = threadIdx.x; j0 < nbin; j0 += 4 * kScanThreads) {
      double w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k * kScanThreads, e = j + nwin;
        w[k] = INFINITY;
        if (j < nbin) {
          const double pj = j ? slice[swz(j - 1)] : 0.0;
          w[k] = e <= nbin ? __dsub_rn(slice[swz(e - 1)], pj)
                           : __dadd_rn(__dsub_rn(total, pj), slice[swz(e - nbin - 1)]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) mn = nanmin(mn, w[k]);
    }
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) mn = nanmin(mn, __shfl_xor_sync(kFull, mn, k));
    if (lane == 0) M[warp] = mn;
    __syncthreads();
    mn = M[0];
#pragma unroll
    for (int w = 1; w < kScanWarps; ++w) mn = nanmin(mn, M[w]);
    const double level = __dadd_rn(ref, __ddiv_rn(mn, (double)nwin));
    // pass C: from the staged input, or the row read again
    if (stage != nullptr)
      emit_staged<STORED, VEC>(a, row, lane, warp, s, o, level, stage);
    else
      emit_row<STORED, VEC, STORED ? 8 : 4>(a, row, lane, warp, kScanWarps, s, o, true,
                                            level);
    __syncwarp();  // the stage's places are this warp's lanes' next row
  }
}

// the decode alone: one warp a row, pass C
template <bool VEC>
__device__ __forceinline__ void decode_rows(const Args& a) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (gw >= a.warps) return;
  for (int64_t row = gw; row < a.rows; row += a.warps) {
    prefetch_row<true>(a, row + a.warps, lane, 32);
    emit_row<true, VEC, 32>(a, row, lane, 0, 1, a.scl[row], a.offs[row], false, 0.0);
  }
}

// pp_unpack: the decode of the stored column
template <bool VEC>
__global__ void __launch_bounds__(kDecodeWarps * 32) unpack_kernel(Args a) {
  decode_rows<VEC>(a);
}

// pp_unpack with nwin > 0: the decode and baseline of the stored column
// (its name holds unpack_kernel, not baseline_kernel: a trace counts each
// entry point's launches by name)
template <bool VEC>
__global__ void __launch_bounds__(kScanThreads, 8) unpack_kernel_scan(Args a) {
  extern __shared__ double smem[];
  scan_rows<true, VEC>(a, smem);
}

// pp_baseline: the baseline of float64 rows
template <bool VEC>
__global__ void __launch_bounds__(kScanThreads, 6) baseline_kernel(Args a) {
  extern __shared__ double smem[];
  scan_rows<false, VEC>(a, smem);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// As many blocks of `threads` threads with `smem` bytes of dynamic shared
// memory as the card holds at once, and no more than `need`.
template <class Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, int64_t need, int64_t* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  *grid = need < fit ? need : fit;
  return 0;
}

// The decode alone: eight warps a block, a row a warp.
template <class Kernel>
int launch_decode(Kernel kernel, Args a, cudaStream_t stream) {
  int64_t grid;
  const int err = persistent_grid(kernel, kDecodeWarps * 32, 0,
                                  (a.rows + kDecodeWarps - 1) / kDecodeWarps, &grid);
  if (err) return err;
  a.warps = (int)(grid * kDecodeWarps);
  kernel<<<(unsigned)grid, kDecodeWarps * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// A scan: four warps a block, a row a block; the slice in shared memory
// (a persistent grid) or, above kMaxSharedBins, in scratch (one slice a
// block: `scratch_blocks` blocks).
template <class Kernel>
int launch_scan(Kernel kernel, Args a, bool stored, int scratch_blocks, cudaStream_t stream) {
  const bool in_shared = a.nbin <= kMaxSharedBins;
  if (!in_shared && (a.scratch == nullptr || scratch_blocks <= 0))
    return (int)cudaErrorInvalidValue;
  if (in_shared) a.scratch = nullptr;
  size_t smem = ((size_t)header_len(a.nbin, stored) +
                 (in_shared ? (size_t)slice_len(a.nbin) : 0)) * sizeof(double);
  const size_t staged = smem + (size_t)stage_len(a.nbin, stored) * sizeof(double);
  a.staged = in_shared && staged <= (size_t)kSmemMax;
  if (a.staged) smem = staged;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int64_t grid = scratch_blocks;
  if (in_shared) {
    const int e = persistent_grid(kernel, kScanThreads, smem, a.rows, &grid);
    if (e) return e;
  }
  kernel<<<(unsigned)grid, kScanThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// raw [rows, nbin] int16 as stored (big-endian), scl and offs [rows] f64,
// out [rows, nbin] f64; nwin > 0 also removes the baseline (windows of
// nwin bins).  scratch: scratch_blocks * slice_len(nbin) doubles when nbin
// > kMaxSharedBins, else null.  Returns the cudaError_t of the launch.
extern "C" int pp_unpack(const void* raw, const void* scl, const void* offs, int64_t rows,
                         int nbin, int nwin, void* out, void* scratch, int scratch_blocks,
                         void* stream) {
  if (rows <= 0 || nbin <= 0) return 0;
  const Args a{raw, (const double*)scl, (const double*)offs, (double*)out,
               (double*)scratch, rows, nbin, nwin, 0, 0};
  const bool vec = nbin % 8 == 0 && aligned16(raw) && aligned16(out);
  const cudaStream_t st = (cudaStream_t)stream;
  if (nwin <= 0)
    return vec ? launch_decode(unpack_kernel<true>, a, st)
               : launch_decode(unpack_kernel<false>, a, st);
  return vec ? launch_scan(unpack_kernel_scan<true>, a, true, scratch_blocks, st)
             : launch_scan(unpack_kernel_scan<false>, a, true, scratch_blocks, st);
}

// x [rows, nbin] f64 less each row's baseline (windows of nwin >= 1 bins)
// into out (x itself allowed); scratch and scratch_blocks as pp_unpack's.
extern "C" int pp_baseline(const void* x, int64_t rows, int nbin, int nwin, void* out,
                           void* scratch, int scratch_blocks, void* stream) {
  if (rows <= 0 || nbin <= 0) return 0;
  const Args a{x, nullptr, nullptr, (double*)out, (double*)scratch, rows, nbin,
               nwin < 1 ? 1 : nwin, 0, 0};
  const bool vec = nbin % 8 == 0 && aligned16(x) && aligned16(out);
  const cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch_scan(baseline_kernel<true>, a, false, scratch_blocks, st)
             : launch_scan(baseline_kernel<false>, a, false, scratch_blocks, st);
}
