"""The port's hand-written CUDA kernels: build, ctypes binding, wrappers.

Twelve kernels, each a CUDA C++ source under ``csrc/`` compiled for
Hopper (``sm_90a``) by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``:

  K1 ``moments`` (csrc/moments.cu) — the three per-channel harmonic sums
     of the scattering-free branch of pulseportraiture_tpu/fit/portrait.py:118
     ``_moments``; and ``moments_grad_hess``, the same harmonic loop with
     a second epilogue: the per-channel terms of ``portrait_grad_hess``
     (:339-373, dS = d2S = 0) in registers, [n, 10, nchan] (f, gradient,
     the 3x3 Hessian's upper triangle) that one channel sum turns into
     the (phi, DM, GM) fit's (f, g, H).  One library, two entry points,
     each with its own launch count and trace name.
  K3 ``moments_scat`` (csrc/moments_scat.cu) — the nine per-channel
     harmonic sums of the scattering branch of the same ``_moments``
     (:191-323); and ``moments_scat_grad_hess``, the same harmonic loop
     with a second epilogue: the (tau, alpha) chain rule and the
     per-channel terms of ``portrait_grad_hess`` (:339-373) in
     registers, [n, 21, nchan] (f, gradient, the Hessian's upper
     triangle) that one channel sum turns into the fit's (f, g, H).
     Both entry points live in one library; each has its own launch
     count and trace name.
  K2 ``fftfit``  (csrc/fftfit.cu)  — batched FFTFIT grid search + Newton
     polish; replaces pulseportraiture_tpu/fit/phase_shift.py:64
     ``_fit_phase_shift_core``.  Bound by operations: its grid stage is a
     float64 product [N, 2 nharm] x [2 nharm, Ns] against a phasor table
     every profile shares.  So the table is built once per (nharm, lo,
     hi, Ns) by a small kernel and cached here (``fftfit_table``), the
     grid + first-minimum runs on the FP64 tensor cores (``mma.sync``)
     without writing the [N, Ns] grid, and one to four warps per
     profile do the Newton polish.  Two launches per call (one more when
     the table is new); LAUNCHES counts one.
  K4 ``spectra`` (csrc/spectra.cu) — the fit's spectra set-up, one pass
     over cuFFT's rFFT output per chunk: harmonic 0 times F0_fact, the
     truncated cross-spectrum d conj(m) written into the caller's slice
     of one preallocated tensor, each row's data power times inv_err2
     and, for a model per row, its |m|^2; replaces
     pulseportraiture_tpu/fit/portrait.py:915-924.  ``spectra_noise``,
     the same loop with a second epilogue: each row's noise as
     get_noise_PS (pulseportraiture_tpu/ops/noise.py:39) from the
     unscaled spectrum, its 1 / sigma_FT^2 and the data power with it,
     for fits that measure their own noise.  One library, two entry
     points, each with its own launch count and trace name.

  K5 ``unpack`` (csrc/unpack.cu) — the archive's decode of the DATA
     column as the file stores it (big-endian int16, its bytes swapped in
     the kernel), times DAT_SCL plus DAT_OFFS in float64
     (pulseportraiture_tpu/io/psrfits.py:451-458), and in the same launch,
     when asked, the baseline removal of Archive.remove_baseline (:248
     there); ``baseline``, the baseline removal alone, for rows a state
     conversion or a rotation made.
  K6 ``load_stats`` (csrc/loadstats.cu) — the load's per-row noise
     (get_noise_PS) and S/N (get_SNR) from each row and its rFFT, one
     pass (pulseportraiture_tpu/io/archive.py:121-131, :148-150).
  K7 ``rotate`` (csrc/rotate.cu) — the rotation phasor, in place on
     cuFFT's output (pulseportraiture_tpu/ops/fourier.py:210
     apply_phasor, which ops.fourier.apply_phasor sends here for CUDA
     tensors): every rotation of data, the load's dedispersion and its
     work copy's among them.
  K8 ``smooth_search`` (csrc/wavelet.cu) — smart_smooth's wavelet
     smoothing search (pulseportraiture_tpu/ops/wavelet.py:177
     _smart_smooth_grid) in three tiers: the set-up (the analysis
     products between cuFFT's transforms, the median and thresholds); the
     scan (pp_wavelet_scan, one block a (row, factor) over every level,
     its own transforms in shared memory) and its certification with the
     certified rows' choice and smooth (pp_wavelet_certify); the route
     (the candidates' round trips through cuFFT and their gated pseudo-S/N
     and choice) for the rows left uncertain and for widths the scan does
     not take.  LAUNCHES counts each chunk decided (one certifying or
     route select); SMOOTH_ROWS counts the rows by tier.
  K9 ``gauss_normal`` (csrc/gauss.cu) — the normal equations of the
     Gaussian portrait fit's Levenberg-Marquardt loop (the forward-mode
     Jacobian of pulseportraiture_tpu/fit/lm.py:60 and its products J^T r
     and J^T J, for the residual of pulseportraiture_tpu/fit/gauss.py:124
     on the unscattered model of ops/profiles.py:141): f = sum r^2,
     g = J^T r and J^T J per lane from the model's analytic derivatives,
     with no Jacobian formed (the channels' Gram matrices on the FP64
     tensor cores, or in registers at one or two components; the chain
     rule in the block; the channel sum by a tree of last-block-done
     counters, one launch a call); and ``gauss_sse``, f alone, for the
     loop's trial steps.  One library, two entry points, each with its
     own launch count and trace name.
  K10 ``gauss_ft_normal`` (csrc/gauss_ft.cu) — the same normal equations
     for the scattered and the joined Gaussian portrait (tau nonzero or
     fitted, join groups: ops/profiles.py:190-203), from the spectra of the
     Jacobian's columns: each channel's basis rows and its unscattered
     portrait transformed in shared memory (K8's Stockham passes), times
     the scattering and join factors on the harmonic grid, packed
     half-complex so that their Gram is the bins' (Parseval), kept in the
     shared memory of one block or a cluster of two a (channel, lane),
     their Gram on the FP64 tensor cores over every warp, the chain rule
     and K9's channel tree, one launch (where they do not fit so
     (gauss_ft_path), the rows staged in device memory and then K9's
     Gram: two launches, counted as one; GAUSS_FT_PATHS counts the calls
     by path); and ``gauss_ft_sse``, f alone (one launch).  One library, two entry points, each with its own
     launch count and trace name.
  K11 ``noise_fit`` (csrc/noisefit.cu) — the "fit" noise estimator
     (pulseportraiture_tpu/ops/noise.py:64 find_kc, :108 get_noise_fit): per
     row of cuFFT's rFFT (or of a power spectrum), the log power's brute fit
     over the (a, b, dc) grid, its cutoff harmonic and the mean power at
     and above it, one warp a row, the row's power in shared memory where
     it fits (re-read from device memory where it does not).
  K12 ``synth_rows`` (csrc/synth.cu) — the synthetic-data writer
     (pulseportraiture_tpu/pipelines/synth.py:50 make_fake_portrait, :102
     make_fake_dataset): per (subint, channel) row, the model's spectrum
     times K7's phasor and the scattering spectrum, one inverse real
     transform in shared memory (K8's passes), then the scintillation,
     scale, the noise the caller drew into the output and the weight, in
     place (the "onchip" path: a power of two from SYNTH_MIN_BINS to
     SYNTH_MAX_BINS bins); other widths take the "cufft" path, K12's
     harmonics kernel, cuFFT's inverse, then K12's epilogue kernel (counted
     as one launch; SYNTH_PATHS counts the calls by path).

Each wrapper dispatches on its input's device: a CPU tensor takes the
plain PyTorch version beside it (the same name with ``_plain``: e.g.
``moments_plain``, ``spectra_noise_plain``, ``unpack_plain``,
``rotate_plain``), which the CPU tests use and ``chip_smoke.py``
holds the kernels against; a CUDA tensor launches the kernel — building
it at first use — or raises.  Nothing falls back from the card to the plain version.  The
wrapper checks device, dtype, shape and contiguity, checks the launch's
``cudaGetLastError()`` and adds one to ``LAUNCHES[name]`` per launch.

Build: ``build()`` starts one ``nvcc`` per source (``SOURCES``), all at
once, writing ``_build/lib<source>-<hash>.so`` (the hash covers the
source, the headers it includes from ``csrc/`` and the flags, so an
edited source or header never reuses a stale library);
``set_build_dir`` moves that directory (``ppsurvey --compile-cache``),
so several processes or restarts share one set of built libraries.
Each source is published on the obs compile bridge (``obs.monitor``): a
library already built as a cache hit, one it compiles as a cache miss
and a compile event with the nvcc seconds.  No CUDA toolkit is needed to
import this module.

A launch the CUDA runtime refuses raises :class:`KernelLaunchError`, the
narrow error the pipelines' per-archive device-error handling catches.
"""

import collections
import ctypes
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from .config import Dconst, F0_fact
from .obs import monitor
from .ops.fourier import phasor
from .ops.noise import SNR_of_noise, _argmin_a, _kc_grid, noise_PS_of_power
from .ops.profiles import FWHM_FACT
from .ops.scattering import LN10, _nonzero_div
from .ops.stats import median

__all__ = ["KernelLaunchError", "LAUNCHES", "reset_launches", "build",
           "set_build_dir",
           "moments", "moments_plain", "moments_launch_floor",
           "moments_grad_hess",
           "moments_grad_hess_plain", "MOMENTS_GRAD_HESS_COLUMNS",
           "MOMENTS_HESS_UPPER", "moments_scat", "moments_scat_plain",
           "MOMENTS_SCAT_SUMS", "moments_scat_grad_hess",
           "moments_scat_grad_hess_plain", "GRAD_HESS_COLUMNS",
           "HESS_UPPER", "fftfit", "fftfit_plain", "fftfit_table",
           "fftfit_table_plain", "spectra", "spectra_plain",
           "spectra_noise", "spectra_noise_plain", "unpack", "unpack_plain",
           "stored_values",
           "baseline", "baseline_plain", "baseline_window", "load_stats",
           "load_stats_plain", "rotate", "rotate_plain", "smooth_search",
           "smooth_search_plain", "smooth_scan",
           "smooth_scan_plain", "smooth_chunk_rows", "scan_chunk_rows",
           "scannable", "SMOOTH_MAX_BINS", "SMOOTH_ROWS", "gauss_normal",
           "gauss_normal_plain", "gauss_sse", "gauss_sse_plain",
           "gauss_ngauss", "gauss_layout", "gauss_sizes", "GAUSS_SIZES",
           "GaussWork", "GAUSS_MAX_NGAUSS",
           "GAUSS_SSE_MAX_NGAUSS", "GAUSS_WARP_NGAUSS", "gauss_ft_normal",
           "gauss_ft_normal_plain", "gauss_ft_sse", "gauss_ft_sse_plain",
           "gauss_ft_ngauss", "gauss_ft_takes_bins", "gauss_ft_sizes",
           "gauss_ft_path", "gauss_ft_active_clusters", "pack_spectrum",
           "GAUSS_FT_SIZES", "GAUSS_FT_PATHS", "GaussFtWork",
           "GAUSS_FT_MAX_NGAUSS", "GAUSS_FT_MIN_BINS", "GAUSS_FT_MAX_BINS",
           "GAUSS_FT_MAX_CLUSTER", "GAUSS_FT_MAX_BATCHES", "noise_fit",
           "noise_fit_plain", "NOISE_FIT_MAX_NS", "synth_rows",
           "synth_rows_plain", "synth_path", "SYNTH_PATHS",
           "SYNTH_MIN_BINS", "SYNTH_MAX_BINS", "KERNELS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> (source file, C symbol, the JAX function it replaces)
KERNELS = {
    "moments": ("moments.cu", "pp_moments",
                "pulseportraiture_tpu/fit/portrait.py:118"),
    "moments_grad_hess": ("moments.cu", "pp_moments_gh",
                          "pulseportraiture_tpu/fit/portrait.py:339"),
    "fftfit": ("fftfit.cu", "pp_fftfit",
               "pulseportraiture_tpu/fit/phase_shift.py:64"),
    "moments_scat": ("moments_scat.cu", "pp_moments_scat",
                     "pulseportraiture_tpu/fit/portrait.py:191"),
    "moments_scat_grad_hess": ("moments_scat.cu", "pp_moments_scat_gh",
                               "pulseportraiture_tpu/fit/portrait.py:339"),
    "spectra": ("spectra.cu", "pp_spectra",
                "pulseportraiture_tpu/fit/portrait.py:915"),
    "spectra_noise": ("spectra.cu", "pp_spectra_noise",
                      "pulseportraiture_tpu/ops/noise.py:39"),
    "unpack": ("unpack.cu", "pp_unpack",
               "pulseportraiture_tpu/io/psrfits.py:451"),
    "baseline": ("unpack.cu", "pp_baseline",
                 "pulseportraiture_tpu/io/psrfits.py:248"),
    "load_stats": ("loadstats.cu", "pp_load_stats",
                   "pulseportraiture_tpu/io/archive.py:121"),
    "rotate": ("rotate.cu", "pp_rotate",
               "pulseportraiture_tpu/ops/fourier.py:210"),
    "smooth_search": ("wavelet.cu", "pp_wavelet_scan",
                      "pulseportraiture_tpu/ops/wavelet.py:177"),
    "gauss_normal": ("gauss.cu", "pp_gauss_normal",
                     "pulseportraiture_tpu/fit/lm.py:60"),
    "gauss_sse": ("gauss.cu", "pp_gauss_sse",
                  "pulseportraiture_tpu/fit/gauss.py:124"),
    "gauss_ft_normal": ("gauss_ft.cu", "pp_gauss_ft_normal",
                        "pulseportraiture_tpu/fit/lm.py:60"),
    "gauss_ft_sse": ("gauss_ft.cu", "pp_gauss_ft_sse",
                     "pulseportraiture_tpu/ops/profiles.py:190"),
    "noise_fit": ("noisefit.cu", "pp_noise_fit",
                  "pulseportraiture_tpu/ops/noise.py:64"),
    "synth_rows": ("synth.cu", "pp_synth_rows",
                   "pulseportraiture_tpu/pipelines/synth.py:50"),
}
# the sources, one nvcc and one library each
SOURCES = tuple(sorted({src for src, _, _ in KERNELS.values()}))

_VP, _I64, _INT, _DBL = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_double)
# kernel name -> {C symbol: argument types}; each returns a cudaError_t
_SYMBOLS = {
    "moments": {"pp_moments": [_VP, _VP, _VP, _VP, _I64, _INT, _INT, _VP,
                               _VP],
                "pp_moments_floor": [_I64, _INT, _VP]},
    "moments_grad_hess": {"pp_moments_gh": [
        _VP, _VP, _VP, _VP, _VP, _VP, _I64, _INT, _INT, _VP, _VP]},
    "fftfit": {"pp_fftfit": [_VP, _VP, _VP, _I64, _INT, _DBL, _DBL, _INT,
                             _INT, _INT, _VP, _VP, _VP, _VP, _VP, _VP],
               "pp_fftfit_table": [_VP, _INT, _INT, _DBL, _DBL, _VP]},
    "moments_scat": {"pp_moments_scat": [_VP, _VP, _I64, _VP, _VP, _VP, _VP,
                                         _I64, _INT, _INT, _VP, _VP]},
    "moments_scat_grad_hess": {"pp_moments_scat_gh": [
        _VP, _VP, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT, _I64, _INT,
        _INT, _VP, _VP]},
    "spectra": {"pp_spectra": [_VP, _VP, _INT, _VP, _I64, _INT, _INT, _INT,
                               _DBL, _VP, _VP, _VP, _VP]},
    "spectra_noise": {"pp_spectra_noise": [
        _VP, _VP, _INT, _VP, _I64, _INT, _INT, _INT, _DBL, _INT, _INT, _DBL,
        _VP, _VP, _VP, _VP, _VP, _VP]},
    "unpack": {"pp_unpack": [_VP, _VP, _VP, _I64, _INT, _INT, _VP, _VP, _INT,
                             _VP]},
    "baseline": {"pp_baseline": [_VP, _I64, _INT, _INT, _VP, _VP, _INT, _VP]},
    "load_stats": {"pp_load_stats": [_VP, _VP, _I64, _INT, _INT, _INT, _DBL,
                                     _VP, _VP, _VP]},
    "rotate": {"pp_rotate": [_VP, _VP, _I64, _INT, _DBL, _VP, _VP]},
    "smooth_search": {
        "pp_wavelet_analysis": [_VP, _VP, _I64, _INT, _INT, _VP, _VP],
        "pp_wavelet_sigma": [_VP, _VP, _VP, _I64, _INT, _INT, _INT, _INT,
                             _INT, _INT, _DBL, _VP, _VP, _VP],
        "pp_wavelet_threshold": [_VP, _VP, _I64, _INT, _INT, _INT, _INT,
                                 _VP, _VP, _VP],
        "pp_wavelet_synthesis": [_VP, _VP, _VP, _I64, _INT, _INT, _INT, _VP,
                                 _VP],
        "pp_wavelet_search": [_VP, _VP, _VP, _VP, _I64, _INT, _INT, _INT,
                              _INT, _INT, _DBL, _VP, _VP, _VP],
        "pp_wavelet_select": [_VP, _VP, _VP, _VP, _I64, _INT, _INT, _INT,
                              _DBL, _VP, _VP, _VP],
        "pp_wavelet_scan": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64,
                            _INT, _INT, _INT, _INT, _INT, _VP, _VP, _VP],
        "pp_wavelet_certify": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                               _VP, _VP, _VP, _I64, _INT, _INT, _INT, _INT,
                               _INT, _DBL, _DBL, _DBL, _DBL, _DBL, _VP, _VP,
                               _VP, _VP]},
    "gauss_normal": {"pp_gauss_normal": [
        _VP, _VP, _VP, _I64, _INT, _VP, _VP, _INT, _INT, _INT, _INT, _DBL,
        _DBL, _INT, _INT, _INT, _VP, _VP, _VP, _VP, _VP, _VP],
        "pp_gauss_sizes": [_INT, _INT, _INT, _VP]},
    "gauss_sse": {"pp_gauss_sse": [
        _VP, _VP, _VP, _I64, _INT, _VP, _VP, _INT, _INT, _INT, _INT, _DBL,
        _DBL, _INT, _INT, _INT, _VP, _VP, _VP, _VP],
        "pp_gauss_sizes": [_INT, _INT, _INT, _VP]},
    "gauss_ft_normal": {"pp_gauss_ft_normal": [
        _VP, _VP, _VP, _I64, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
        _DBL, _DBL, _DBL, _INT, _INT, _INT, _VP, _VP, _VP, _VP, _VP, _VP,
        _VP],
        "pp_gauss_ft_sizes": [_INT, _INT, _INT, _INT, _INT, _VP],
        "pp_gauss_ft_clusters": [_INT, _INT, _INT, _INT, _VP]},
    "gauss_ft_sse": {"pp_gauss_ft_sse": [
        _VP, _VP, _VP, _I64, _VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT,
        _DBL, _DBL, _DBL, _INT, _INT, _INT, _VP, _VP, _VP, _VP],
        "pp_gauss_ft_sizes": [_INT, _INT, _INT, _INT, _INT, _VP]},
    "noise_fit": {"pp_noise_fit": [_VP, _INT, _I64, _INT, _INT, _VP, _INT,
                                   _VP, _VP, _VP, _VP, _INT, _DBL, _INT, _VP,
                                   _VP, _VP]},
    "synth_rows": {"pp_synth_rows": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                                     _I64, _INT, _INT, _DBL, _VP, _VP],
                   "pp_synth_harmonics": [_VP, _VP, _VP, _I64, _INT, _INT,
                                          _DBL, _VP, _VP],
                   "pp_synth_finish": [_VP, _VP, _VP, _VP, _VP, _I64, _INT,
                                       _INT, _VP, _VP]},
}

# kernel name -> the CUDA function that runs once per counted launch, as
# it is named in a profiler trace (K2's grid stage, its Newton stage
# runs as often; K8's two selects, the route's and the scan's certifying
# one, both wavelet_select*; K9's two layouts, gauss_normal_warp_kernel
# and gauss_normal_mma_kernel; K10's normal equations either
# gauss_ft_gram_cluster_kernel, on chip, or gauss_ft_gram_kernel after
# gauss_ft_rows_kernel, staged: one gauss_ft_gram_* a call; K12's rows
# either synth_rows_onchip_kernel or synth_rows_staged_kernel after
# synth_harmonics_kernel and cuFFT: one synth_rows_* a call)
TRACE_NAMES = {"moments": "moments_kernel",
               "moments_grad_hess": "moments_grad_hess_kernel",
               "fftfit": "fftfit_grid_kernel",
               "moments_scat": "moments_scat_kernel",
               "moments_scat_grad_hess": "moments_scat_grad_hess_kernel",
               "spectra": "spectra_kernel",
               "spectra_noise": "spectra_noise_kernel",
               "unpack": "unpack_kernel",
               "baseline": "baseline_kernel",
               "load_stats": "load_stats_kernel",
               "rotate": "rotate_kernel",
               "smooth_search": "wavelet_select",
               "gauss_normal": "gauss_normal_",
               "gauss_sse": "gauss_sse_kernel",
               "gauss_ft_normal": "gauss_ft_gram_",
               "gauss_ft_sse": "gauss_ft_sse_kernel",
               "noise_fit": "noise_fit_kernel",
               "synth_rows": "synth_rows_"}

LAUNCHES = {name: 0 for name in KERNELS}
BUILD_LOG = {}  # library (source stem) -> nvcc output (register report)
_LIBS = {}
_LOCK = threading.Lock()
# launch counts and the K2 table cache are updated from several threads
# at once by the service's fit workers (service/daemon.py)
_STATE_LOCK = threading.Lock()


class KernelLaunchError(RuntimeError):
    """A hand kernel's launch was refused by the CUDA runtime."""

    def __init__(self, name, code):
        super().__init__("CUDA kernel %s failed to launch: cudaError_t %d"
                         % (name, code))


def reset_launches():
    """Set every launch count, K8's rows by tier (SMOOTH_ROWS) and K10's
    calls by path (GAUSS_FT_PATHS) to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for tier in SMOOTH_ROWS:
        SMOOTH_ROWS[tier] = 0
    for path in GAUSS_FT_PATHS:
        GAUSS_FT_PATHS[path] = 0


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from csrc/ with the CUDA toolkit.")
    return path


def set_build_dir(path):
    """Build the kernels into, and load them from, ``path`` (created
    when missing).  Libraries already loaded stay loaded; returns the
    absolute directory."""
    global BUILD_DIR
    path = os.path.abspath(str(path))
    os.makedirs(path, exist_ok=True)
    with _LOCK:
        BUILD_DIR = path
    return path


def _lib_of(name):
    """The library (its source's stem) that holds kernel ``name``."""
    return os.path.splitext(KERNELS[name][0])[0]


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _source_files(name, seen=None):
    """``name`` (a file under CSRC_DIR) and, depth first, every file of
    CSRC_DIR it includes with quotes, each once."""
    seen = [] if seen is None else seen
    seen.append(name)
    with open(os.path.join(CSRC_DIR, name), "rb") as f:
        text = f.read()
    for inc in _INCLUDE.findall(text):
        inc = os.path.normpath(os.path.join(os.path.dirname(name),
                                            inc.decode()))
        if inc not in seen and os.path.isfile(os.path.join(CSRC_DIR, inc)):
            _source_files(inc, seen)
    return seen


def _lib_path(lib):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _source_files(lib + ".cu"):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (lib, h.hexdigest()[:12]))


def build(names=None):
    """Compile (if needed) and load the named kernels, all by default.

    One nvcc process per source, started together.  Returns the wall
    seconds spent.  Raises RuntimeError with the compiler output when a
    build fails."""
    names = list(KERNELS) if names is None else list(names)
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        libs = sorted({_lib_of(n) for n in todo})
        procs = {}
        for lib in libs:
            path = _lib_path(lib)
            if os.path.exists(path):
                monitor.publish(monitor.CACHE_HIT_EVENT, kernel=lib)
                continue
            monitor.publish(monitor.CACHE_MISS_EVENT, kernel=lib)
            tmp = "%s.%d.tmp" % (path, os.getpid())
            cmd = [_nvcc()] + NVCC_FLAGS + [
                "-o", tmp, os.path.join(CSRC_DIR, lib + ".cu")]
            procs[lib] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path, time.perf_counter())
        failed = []
        for lib, (proc, tmp, path, t_start) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[lib] = out
            if proc.returncode != 0:
                failed.append("%s:\n%s" % (lib, out))
            else:
                os.replace(tmp, path)
                # seconds from this nvcc's start to its end being read
                # (the builds run together, so they overlap)
                monitor.publish(monitor.COMPILE_EVENT,
                                time.perf_counter() - t_start,
                                kernel=lib, source=lib + ".cu")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        loaded = {lib: ctypes.CDLL(_lib_path(lib)) for lib in libs}
        for name in todo:
            fns = {}
            for sym, argtypes in _SYMBOLS[name].items():
                fns[sym] = fn = getattr(loaded[_lib_of(name)], sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBS[name] = fns
    return time.perf_counter() - t0


def _launch(name, device, *args, symbol=None, count=True):
    """Call C entry ``symbol`` (the kernel's own by default) of kernel
    ``name`` on the current stream of ``device``; raise on a refused
    launch; count it in LAUNCHES unless ``count`` is false."""
    if name not in _LIBS:
        build([name])
    fn = _LIBS[name][symbol or KERNELS[name][1]]
    if torch.cuda.current_device() == device.index:
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise KernelLaunchError(name, err)
    if count:
        _count(name)


def _count(name):
    """Add one launch of kernel ``name`` to LAUNCHES (thread-safe)."""
    with _STATE_LOCK:
        LAUNCHES[name] += 1


def _check(t, what, dtype, ndim):
    if not isinstance(t, torch.Tensor):
        raise TypeError("%s must be a tensor" % what)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (what, dtype, t.dtype))
    if t.ndim != ndim:
        raise ValueError("%s must be %d-D, got shape %s"
                         % (what, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % what)


def _same_device(ref, *ts):
    for t in ts:
        if t is not None and t.device != ref.device:
            raise ValueError("all inputs must be on %s, got %s"
                             % (ref.device, t.device))


# -- K1: moments ---------------------------------------------------------

def moments_plain(cross, shifts, inv_err2, lanes=None):
    """Plain PyTorch K1: (C, T1, T2) per row, the arithmetic of the JAX
    reference's ``_moments`` (scattering-free branch): one sum over k,
    then times inv_err2."""
    if lanes is not None:
        cross, inv_err2 = cross[lanes], inv_err2[lanes]
    K = cross.shape[-1]
    k = torch.arange(K, dtype=torch.float64, device=cross.device)
    frac = torch.remainder(shifts[..., None] * k, 1.0)
    ang = (2.0 * math.pi) * frac
    core = cross * torch.complex(torch.cos(ang), torch.sin(ang))
    core_re, core_im = core.real, core.imag
    tpk = (2.0 * math.pi) * k
    C = torch.sum(core_re, dim=-1) * inv_err2
    T1 = -torch.sum(tpk * core_im, dim=-1) * inv_err2
    T2 = -torch.sum((tpk * tpk) * core_re, dim=-1) * inv_err2
    return torch.stack([C, T1, T2], dim=-1)


def _check_moments(cross, shifts, inv_err2, lanes, what):
    """Check K1's common arguments; returns (B, nchan, K, n)."""
    _check(cross, "cross", torch.complex128, 3)
    _check(shifts, "shifts", torch.float64, 2)
    _check(inv_err2, "inv_err2", torch.float64, 2)
    B, nchan, K = cross.shape
    n = B if lanes is None else lanes.shape[0]
    if lanes is not None:
        _check(lanes, "lanes", torch.int64, 1)
    if tuple(shifts.shape) != (n, nchan) or tuple(inv_err2.shape) != (
            B, nchan):
        raise ValueError("%s: shapes cross %s, shifts %s, inv_err2 %s"
                         " disagree" % (what, tuple(cross.shape),
                                        tuple(shifts.shape),
                                        tuple(inv_err2.shape)))
    return B, nchan, K, n


def moments(cross, shifts, inv_err2, lanes=None):
    """K1 wrapper: per-channel moments [n, nchan, 3] f64 (C, T1, T2; see
    csrc/moments.cu).

    cross [B, nchan, K] complex128, inv_err2 [B, nchan] f64; shifts
    [n, nchan] f64 are the phase shifts of the rows to evaluate, which
    are subints ``lanes`` [n] int64 (all B subints when None)."""
    B, nchan, K, n = _check_moments(cross, shifts, inv_err2, lanes,
                                    "moments")
    _same_device(cross, shifts, inv_err2, lanes)
    if cross.device.type == "cpu":
        return moments_plain(cross, shifts, inv_err2, lanes)
    if cross.device.type != "cuda":
        raise ValueError("moments: unsupported device %s" % cross.device)
    out = torch.empty((n, nchan, 3), dtype=torch.float64,
                      device=cross.device)
    if n * nchan == 0:
        return out
    _launch("moments", cross.device, cross.data_ptr(), shifts.data_ptr(),
            inv_err2.data_ptr(), None if lanes is None else lanes.data_ptr(),
            n, nchan, K, out.data_ptr())
    return out


def moments_launch_floor(n, nchan, device):
    """Launch, uncounted, an empty kernel with the block and grid K1 takes
    for n x nchan rows: the launch floor its times are measured against."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _launch("moments", device, int(n), int(nchan),
            symbol="pp_moments_floor", count=False)


# -- K1, epilogue B: per-row objective, gradient and Hessian ---------------

# the (phi, DM, GM) Hessian's entries on and above the diagonal, in the
# order of moments_grad_hess's columns 4..9
MOMENTS_HESS_UPPER = tuple((p, r) for p in range(3) for r in range(p, 3))
MOMENTS_GRAD_HESS_COLUMNS = ("f",) + tuple("g%d" % p for p in range(3)) \
    + tuple("H%d%d" % pr for pr in MOMENTS_HESS_UPPER)


def moments_grad_hess_plain(cross, shifts, pd, S, inv_err2, lanes=None):
    """Plain PyTorch K1 with epilogue B: [n, 10, nchan]
    (MOMENTS_GRAD_HESS_COLUMNS) from moments_plain's sums, the reference's
    portrait_grad_hess per channel with B = 1 (dS = d2S = 0): ok = S > 0,
    f = -(C^2/S), g_p = -(2 C dC_p / S) with dC_p = T1 pd_p, H_pr = -2
    (C^2/S) (d2C_pr/C + dC_p dC_r/C^2) with d2C_pr = T2 pd_p pd_r, zero
    where not ok.  A channel sum gives the unmasked (f, g, H)."""
    C0, T1, T2 = moments_plain(cross, shifts, inv_err2, lanes).unbind(-1)
    if lanes is not None:
        S = S[lanes]
    ok = S > 0.0
    S = torch.where(ok, S, torch.ones_like(S))
    C = torch.where(ok, C0, torch.zeros_like(C0))
    zero = torch.zeros_like(C)
    pds = pd.unbind(1)
    dC = [T1 * p for p in pds]
    out = [-torch.where(ok, C ** 2 / S, zero)]
    out += [-torch.where(ok, 2.0 * C * d / S, zero) for d in dC]
    safe_C = torch.where(C != 0.0, C, torch.ones_like(C))
    lead = -2.0 * (C ** 2 / S)
    for p, r in MOMENTS_HESS_UPPER:
        out.append(torch.where(ok, lead * (
            T2 * pds[p] * pds[r] / safe_C + dC[p] * dC[r] / safe_C ** 2),
            zero))
    return torch.stack(out, dim=1)


def moments_grad_hess(cross, shifts, pd, S, inv_err2, lanes=None):
    """K1 wrapper, epilogue B: per-row objective, gradient and Hessian
    terms [n, 10, nchan] f64 (MOMENTS_GRAD_HESS_COLUMNS; see
    csrc/moments.cu), whose channel sum is the (phi, DM, GM) fit's
    unmasked (f, g, H).

    ``cross``, ``shifts``, ``inv_err2`` and ``lanes`` are moments'; pd [n, 3, nchan] are the rows' phase-shift derivatives wrt
    (phi, DM, GM) and S [B, nchan] the channels' sum |m|^2 inv_err2."""
    B, nchan, K, n = _check_moments(cross, shifts, inv_err2, lanes,
                                    "moments_grad_hess")
    _check(pd, "pd", torch.float64, 3)
    _check(S, "S", torch.float64, 2)
    if tuple(pd.shape) != (n, 3, nchan) or tuple(S.shape) != (B, nchan):
        raise ValueError("moments_grad_hess: shapes pd %s, S %s for %d rows "
                         "of %d subints of %d channels"
                         % (tuple(pd.shape), tuple(S.shape), n, B, nchan))
    _same_device(cross, shifts, pd, S, inv_err2, lanes)
    if cross.device.type == "cpu":
        return moments_grad_hess_plain(cross, shifts, pd, S, inv_err2, lanes)
    if cross.device.type != "cuda":
        raise ValueError("moments_grad_hess: unsupported device %s"
                         % cross.device)
    out = torch.empty((n, len(MOMENTS_GRAD_HESS_COLUMNS), nchan),
                      dtype=torch.float64, device=cross.device)
    if n * nchan == 0:
        return out
    _launch("moments_grad_hess", cross.device, cross.data_ptr(),
            shifts.data_ptr(), inv_err2.data_ptr(),
            None if lanes is None else lanes.data_ptr(), pd.data_ptr(),
            S.data_ptr(), n, nchan, K, out.data_ptr())
    return out


# -- K3: scattering moments ------------------------------------------------

# K3's nine sums, in the order of its output's last axis
MOMENTS_SCAT_SUMS = ("C", "S", "T1", "T2", "Q0", "Q1", "W2", "S1", "S2")


def moments_scat_plain(cross, abs_m2, shifts, taus, inv_err2, lanes=None):
    """Plain PyTorch K3: the nine sums (MOMENTS_SCAT_SUMS) per row, each
    with the order of operations of the JAX reference's complex
    scattering branch (fit/portrait.py:270-323): B built per element,
    z = cross conj(B) phasor, dB/dtau = -2 pi i k B**2, d2B/dtau**2 =
    2 (-2 pi i k)**2 B**3; one sum over k, then times inv_err2."""
    if lanes is not None:
        cross, inv_err2 = cross[lanes], inv_err2[lanes]
        if abs_m2.shape[0] != 1:
            abs_m2 = abs_m2[lanes]
    K = cross.shape[-1]
    k = torch.arange(K, dtype=torch.float64, device=cross.device)
    frac = torch.remainder(shifts[..., None] * k, 1.0)
    ang = (2.0 * math.pi) * frac
    phsr = torch.complex(torch.cos(ang), torch.sin(ang))
    tpk = (2.0 * math.pi) * k
    x = 2.0 * math.pi * k * taus[..., None]
    denom = 1.0 + x * x
    B = torch.complex(1.0 / denom, -x / denom)
    u = torch.complex(torch.zeros_like(k), -2.0 * math.pi * k)
    dB = u * B ** 2
    d2B = 2.0 * (u ** 2) * B ** 3
    core = cross * torch.conj(B) * phsr
    z1 = cross * torch.conj(dB) * phsr
    C = torch.sum(core.real, dim=-1) * inv_err2
    S = torch.sum(torch.abs(B) ** 2 * abs_m2, dim=-1) * inv_err2
    T1 = -torch.sum(tpk * core.imag, dim=-1) * inv_err2
    T2 = -torch.sum(tpk ** 2 * core.real, dim=-1) * inv_err2
    Q0 = torch.sum(z1.real, dim=-1) * inv_err2
    Q1 = -torch.sum(tpk * z1.imag, dim=-1) * inv_err2
    W2 = torch.sum(torch.real(cross * torch.conj(d2B) * phsr),
                   dim=-1) * inv_err2
    S1 = torch.sum(2.0 * torch.real(B * torch.conj(dB)) * abs_m2,
                   dim=-1) * inv_err2
    S2 = torch.sum(2.0 * torch.real(dB * torch.conj(dB)
                                    + B * torch.conj(d2B)) * abs_m2,
                   dim=-1) * inv_err2
    return torch.stack([C, S, T1, T2, Q0, Q1, W2, S1, S2], dim=-1)


def _check_scat(cross, abs_m2, shifts, taus, inv_err2, lanes, what):
    """Check K3's common arguments; returns (B, nchan, K, n)."""
    _check(cross, "cross", torch.complex128, 3)
    _check(abs_m2, "abs_m2", torch.float64, 3)
    _check(shifts, "shifts", torch.float64, 2)
    _check(taus, "taus", torch.float64, 2)
    _check(inv_err2, "inv_err2", torch.float64, 2)
    B, nchan, K = cross.shape
    n = B if lanes is None else lanes.shape[0]
    if lanes is not None:
        _check(lanes, "lanes", torch.int64, 1)
    if (abs_m2.shape[0] not in (1, B) or tuple(abs_m2.shape[1:]) != (nchan, K)
            or tuple(shifts.shape) != (n, nchan)
            or tuple(taus.shape) != (n, nchan)
            or tuple(inv_err2.shape) != (B, nchan)):
        raise ValueError("%s: shapes cross %s, abs_m2 %s, shifts %s, taus "
                         "%s, inv_err2 %s disagree"
                         % ((what,) + tuple(tuple(t.shape) for t in (
                             cross, abs_m2, shifts, taus, inv_err2))))
    return B, nchan, K, n


def moments_scat(cross, abs_m2, shifts, taus, inv_err2, lanes=None):
    """K3 wrapper: the nine per-channel scattering sums [n, nchan, 9] f64
    (order MOMENTS_SCAT_SUMS; see csrc/moments_scat.cu).

    cross [B, nchan, K] complex128; abs_m2 [B or 1, nchan, K] f64 (one
    set of rows shared by the batch when its first dimension is 1);
    inv_err2 [B, nchan] f64; shifts and taus [n, nchan] f64 are the phase
    shifts and channel scattering times [rot] of the rows to evaluate,
    which are subints ``lanes`` [n] int64 (all B subints when None)."""
    B, nchan, K, n = _check_scat(cross, abs_m2, shifts, taus, inv_err2,
                                 lanes, "moments_scat")
    _same_device(cross, abs_m2, shifts, taus, inv_err2, lanes)
    if cross.device.type == "cpu":
        return moments_scat_plain(cross, abs_m2, shifts, taus, inv_err2,
                                  lanes)
    if cross.device.type != "cuda":
        raise ValueError("moments_scat: unsupported device %s" % cross.device)
    out = torch.empty((n, nchan, len(MOMENTS_SCAT_SUMS)),
                      dtype=torch.float64, device=cross.device)
    if n * nchan == 0:
        return out
    m_bstride = 0 if abs_m2.shape[0] == 1 else nchan * K
    _launch("moments_scat", cross.device, cross.data_ptr(), abs_m2.data_ptr(),
            m_bstride, shifts.data_ptr(), taus.data_ptr(),
            inv_err2.data_ptr(), None if lanes is None else lanes.data_ptr(),
            n, nchan, K, out.data_ptr())
    return out


# -- K3, epilogue B: per-row objective, gradient and Hessian ---------------

# the Hessian's entries on and above the diagonal, in the order of
# moments_scat_grad_hess's columns 6..20
HESS_UPPER = tuple((p, r) for p in range(5) for r in range(p, 5))
GRAD_HESS_COLUMNS = ("f",) + tuple("g%d" % p for p in range(5)) + tuple(
    "H%d%d" % pr for pr in HESS_UPPER)


def grad_hess_rows_plain(sums, taus, pd, lnf, tau, log10_tau):
    """Epilogue B in PyTorch: [n, 21, nchan] (GRAD_HESS_COLUMNS) from the
    nine sums [n, nchan, 9] of K3.  The (tau, alpha) chain rule of
    ops/scattering.py (scattering_times_deriv / _2deriv, with lnf =
    ln(freqs / nu_tau) [n, nchan] and the rows' linear tau [n]), the
    reference's dC, dS, d2C, d2S (fit/portrait.py _moments) and the
    per-channel terms of its portrait_grad_hess, each entry with the
    order of operations of those functions: f = -(C^2/S), g = -(2 C dC/S
    - C^2 dS/S^2), H_pr = -2 (C^2/S) (d2C/C - d2S/(2S) + ...), zero where
    S <= 0.  A channel sum gives the unmasked (f, g, H)."""
    C0, S0, T1, T2, Q0, Q1, W2, S1, S2 = sums.unbind(-1)
    tau = tau[:, None]
    dtau = LN10 * taus if log10_tau else _nonzero_div(taus, tau)
    dalpha = lnf * taus
    if log10_tau:
        d2tau, dtda = LN10 * dtau, LN10 * dalpha
    else:
        d2tau, dtda = torch.zeros_like(dtau), _nonzero_div(dalpha, tau)
    td = (dtau, dalpha)
    t2d = ((d2tau, dtda), (dtda, lnf * dalpha))
    pds = pd.unbind(1)
    zero = torch.zeros_like(C0)
    dC = [T1 * pds[p] for p in range(3)] + [t * Q0 for t in td]
    dS = [zero] * 3 + [t * S1 for t in td]
    ok = S0 > 0.0
    S = torch.where(ok, S0, torch.ones_like(S0))
    C = torch.where(ok, C0, zero)
    out = [-torch.where(ok, C ** 2 / S, zero)]
    out += [-torch.where(ok, 2.0 * C * dC[p] / S - C ** 2 * dS[p] / S ** 2,
                         zero) for p in range(5)]
    sC = torch.where(C != 0.0, C, torch.ones_like(C))
    lead = -2.0 * (C ** 2 / S)
    for p, r in HESS_UPPER:
        d2S = zero
        if r < 3:
            d2C = T2 * pds[p] * pds[r]
        elif p < 3:
            d2C = pds[p] * (td[r - 3] * Q1)
        else:
            tdd = td[p - 3] * td[r - 3]
            d2C = tdd * W2 + t2d[p - 3][r - 3] * Q0
            d2S = tdd * S2 + t2d[p - 3][r - 3] * S1
        inner = d2C / sC - 0.5 * d2S / S + dC[p] * dC[r] / sC ** 2 \
            + dS[p] * dS[r] / S ** 2 - (dC[p] * dS[r] + dS[p] * dC[r]) \
            / (sC * S)
        out.append(torch.where(ok, lead * inner, zero))
    return torch.stack(out, dim=1)


def moments_scat_grad_hess_plain(cross, abs_m2, shifts, taus, inv_err2, pd,
                                 lnf, tau, log10_tau, lanes=None):
    """Plain PyTorch K3 with epilogue B: moments_scat_plain's nine sums,
    then grad_hess_rows_plain: [n, 21, nchan]."""
    return grad_hess_rows_plain(
        moments_scat_plain(cross, abs_m2, shifts, taus, inv_err2, lanes),
        taus, pd, lnf, tau, log10_tau)


def moments_scat_grad_hess(cross, abs_m2, shifts, taus, inv_err2, pd, lnf,
                           tau, log10_tau, lanes=None):
    """K3 wrapper, epilogue B: per-row objective, gradient and Hessian
    terms [n, 21, nchan] f64 (GRAD_HESS_COLUMNS; see
    csrc/moments_scat.cu), whose channel sum is the scattering fit's
    unmasked (f, g, H).

    The first five arguments and ``lanes`` are moments_scat's; pd [n, 3,
    nchan] are the rows' phase-shift derivatives wrt (phi, DM, GM), lnf
    [n, nchan] = ln(freqs / nu_tau), tau [n] the rows' linear tau, and
    ``log10_tau`` whether the fit's tau parameter is log10(tau)."""
    B, nchan, K, n = _check_scat(cross, abs_m2, shifts, taus, inv_err2,
                                 lanes, "moments_scat_grad_hess")
    _check(pd, "pd", torch.float64, 3)
    _check(lnf, "lnf", torch.float64, 2)
    _check(tau, "tau", torch.float64, 1)
    if tuple(pd.shape) != (n, 3, nchan) or tuple(lnf.shape) != (n, nchan) \
            or tuple(tau.shape) != (n,):
        raise ValueError("moments_scat_grad_hess: shapes pd %s, lnf %s, tau "
                         "%s for %d rows of %d channels"
                         % (tuple(pd.shape), tuple(lnf.shape),
                            tuple(tau.shape), n, nchan))
    _same_device(cross, abs_m2, shifts, taus, inv_err2, pd, lnf, tau, lanes)
    log10_tau = bool(log10_tau)
    if cross.device.type == "cpu":
        return moments_scat_grad_hess_plain(cross, abs_m2, shifts, taus,
                                            inv_err2, pd, lnf, tau,
                                            log10_tau, lanes)
    if cross.device.type != "cuda":
        raise ValueError("moments_scat_grad_hess: unsupported device %s"
                         % cross.device)
    out = torch.empty((n, len(GRAD_HESS_COLUMNS), nchan),
                      dtype=torch.float64, device=cross.device)
    if n * nchan == 0:
        return out
    m_bstride = 0 if abs_m2.shape[0] == 1 else nchan * K
    _launch("moments_scat_grad_hess", cross.device, cross.data_ptr(),
            abs_m2.data_ptr(), m_bstride, shifts.data_ptr(), taus.data_ptr(),
            inv_err2.data_ptr(), None if lanes is None else lanes.data_ptr(),
            pd.data_ptr(), lnf.data_ptr(), tau.data_ptr(), int(log10_tau), n,
            nchan, K, out.data_ptr())
    return out


# -- K2: FFTFIT ------------------------------------------------------------

def _phase_objective(phase, cross, inv_err2):
    """(C, dC, d2C) at ``phase`` [N] — the JAX reference's
    phase_shift_objective (phase_shift.py:40) with inv_err2 given."""
    nharm = cross.shape[-1]
    k = torch.arange(nharm, dtype=torch.float64, device=cross.device)
    frac = torch.remainder(phase[..., None] * k, 1.0)
    ang = (2.0 * math.pi) * frac
    w = cross * torch.complex(torch.cos(ang), torch.sin(ang))
    C = -torch.sum(w, dim=-1).real * inv_err2
    dC = (2.0 * math.pi) * torch.sum(k * w.imag, dim=-1) * inv_err2
    d2C = (4.0 * math.pi ** 2) * torch.sum((k * k) * w.real, dim=-1) \
        * inv_err2
    return C, dC, d2C


def fftfit_grid_plain(cross, lo, hi, Ns):
    """Plain K2 grid stage: (Cgrid [N, Ns], grid [Ns]) for cross [N,
    nharm], a few grid points at a time (bounded temporaries)."""
    N, nharm = cross.shape
    dev = cross.device
    k = torch.arange(nharm, dtype=torch.float64, device=dev)
    grid = lo + (hi - lo) * torch.arange(Ns, dtype=torch.float64,
                                         device=dev) / Ns
    chunk = max(1, min(Ns, (1 << 24) // max(N * nharm, 1)))
    cgrid = []
    for g0 in range(0, Ns, chunk):
        ang = (2.0 * math.pi) * torch.remainder(
            grid[g0:g0 + chunk, None] * k[None, :], 1.0)
        cgrid.append(-torch.sum(
            cross.real[:, None, :] * torch.cos(ang)
            - cross.imag[:, None, :] * torch.sin(ang), dim=-1))
    return torch.cat(cgrid, dim=-1), grid


def fftfit_plain(cross, inv_err2, lo, hi, Ns, newton_iter):
    """Plain PyTorch K2: (phase, C, d2C) [N] for cross [N, nharm]."""
    cgrid, grid = fftfit_grid_plain(cross, lo, hi, Ns)
    phase = grid[torch.argmin(cgrid, dim=-1)]
    cell = (hi - lo) / Ns
    for _ in range(newton_iter):
        _, dC, d2C = _phase_objective(phase, cross, inv_err2)
        pos = d2C > 0.0
        step = torch.where(pos, -dC / torch.where(pos, d2C,
                                                  torch.ones_like(d2C)),
                           torch.zeros_like(d2C))
        phase = phase + torch.clamp(step, -cell, cell)
    phase = torch.remainder(phase + 0.5, 1.0) - 0.5
    C, _, d2C = _phase_objective(phase, cross, inv_err2)
    return phase, C, d2C


# The table's padding and the grid's column groups, as in csrc/fftfit.cu
# (kBK, kNsAlign, kColGroup).
FFTFIT_K_ALIGN, FFTFIT_NS_ALIGN, FFTFIT_GROUP = 32, 128, 32
FFTFIT_TABLES_MAX = 8  # phasor tables kept, least recently used dropped
_TABLES = collections.OrderedDict()


def _padded(n, align):
    return -(-n // align) * align


def fftfit_table_plain(nharm, lo, hi, Ns, device="cpu"):
    """Plain K2 phasor table [2 nharm, Ns] f64: row 2k holds
    cos(theta_gk) and row 2k+1 -sin(theta_gk), theta_gk = 2 pi ((v_g k)
    mod 1), v_g = lo + (hi - lo) g / Ns: the reference's grid phasors
    (phase_shift.py:74-80) laid out so that the grid stage is the real
    product view_as_real(cross).reshape(N, 2 nharm) @ T = -Cgrid."""
    k = torch.arange(nharm, dtype=torch.float64, device=device)
    grid = lo + (hi - lo) * torch.arange(Ns, dtype=torch.float64,
                                         device=device) / Ns
    ang = (2.0 * math.pi) * torch.remainder(k[:, None] * grid[None, :], 1.0)
    return torch.stack([torch.cos(ang), -torch.sin(ang)],
                       dim=1).reshape(2 * nharm, Ns)


def fftfit_table(nharm, lo, hi, Ns, device):
    """K2's phasor table for (nharm, lo, hi, Ns) on ``device``, zero-padded
    to [Kp, Nsp] (2 nharm rounded up to FFTFIT_K_ALIGN, Ns to
    FFTFIT_NS_ALIGN); built once per key and cached (the
    FFTFIT_TABLES_MAX most recently used).  On the card the table kernel
    builds it; on the CPU fftfit_table_plain does."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (device, int(nharm), float(lo), float(hi), int(Ns))
    with _STATE_LOCK:
        T = _TABLES.get(key)
        if T is not None:
            _TABLES.move_to_end(key)
            return T
    nharm, lo, hi, Ns = key[1:]
    Kp = _padded(2 * nharm, FFTFIT_K_ALIGN)
    Nsp = _padded(Ns, FFTFIT_NS_ALIGN)
    if device.type == "cuda":
        T = torch.empty((Kp, Nsp), dtype=torch.float64, device=device)
        _launch("fftfit", device, T.data_ptr(), nharm, Ns, lo, hi,
                symbol="pp_fftfit_table", count=False)
    else:
        T = torch.zeros((Kp, Nsp), dtype=torch.float64, device=device)
        T[:2 * nharm, :Ns] = fftfit_table_plain(nharm, lo, hi, Ns, device)
    with _STATE_LOCK:
        _TABLES[key] = T
        while len(_TABLES) > FFTFIT_TABLES_MAX:
            _TABLES.popitem(last=False)
    return T


def _fftfit_launch(cross, inv_err2, lo, hi, Ns, newton_iter, stages=3,
                   scratch=None, count=True):
    """Run K2's stages on the card: 1 grid + argmin partials, 2 Newton,
    3 both.  Returns (out [3, N], scratch): one buffer holds the outputs
    and the grid's partials (pval [N, G] f64, then pidx [N, G] int32,
    G = Nsp / FFTFIT_GROUP), so a stage-2 call can reuse a stage-1
    call's grid."""
    N, nharm = cross.shape
    table = fftfit_table(nharm, lo, hi, Ns, cross.device)
    ng = N * (table.shape[1] // FFTFIT_GROUP)
    if scratch is None:
        scratch = torch.empty(3 * N + ng + (ng + 1) // 2,
                              dtype=torch.float64, device=cross.device)
    out = scratch[:3 * N].view(3, N)
    pval = scratch.data_ptr() + 3 * N * 8
    _launch("fftfit", cross.device, cross.data_ptr(), inv_err2.data_ptr(),
            table.data_ptr(), N, nharm, lo, hi, Ns, newton_iter, stages,
            pval, pval + ng * 8, out.data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), count=count)
    return out, scratch


def fftfit_partials(scratch, N, Ns):
    """The grid's per-group first minima (pval [N, G] f64, pidx [N, G]
    int32) held in a ``_fftfit_launch`` scratch buffer."""
    G = _padded(Ns, FFTFIT_NS_ALIGN) // FFTFIT_GROUP
    pval = scratch[3 * N:3 * N + N * G].view(N, G)
    pidx = scratch[3 * N + N * G:].view(torch.int32)[:N * G].view(N, G)
    return pval, pidx


def fftfit(cross, inv_err2, lo, hi, Ns, newton_iter):
    """K2 wrapper: (phase, C, d2C) [N] f64 for cross [N, nharm]
    complex128 and inv_err2 [N] f64 (see csrc/fftfit.cu)."""
    _check(cross, "cross", torch.complex128, 2)
    _check(inv_err2, "inv_err2", torch.float64, 1)
    N, nharm = cross.shape
    if inv_err2.shape[0] != N:
        raise ValueError("fftfit: inv_err2 has %d rows, cross %d"
                         % (inv_err2.shape[0], N))
    if int(Ns) < 1 or int(newton_iter) < 0:
        raise ValueError("fftfit: need Ns >= 1 and newton_iter >= 0")
    _same_device(cross, inv_err2)
    lo, hi, Ns, newton_iter = float(lo), float(hi), int(Ns), int(newton_iter)
    if cross.device.type == "cpu":
        return fftfit_plain(cross, inv_err2, lo, hi, Ns, newton_iter)
    if cross.device.type != "cuda":
        raise ValueError("fftfit: unsupported device %s" % cross.device)
    if N == 0:
        out = torch.empty((3, 0), dtype=torch.float64, device=cross.device)
        return out[0], out[1], out[2]
    out, _ = _fftfit_launch(cross, inv_err2, lo, hi, Ns, newton_iter)
    return out[0], out[1], out[2]


# -- K4: the fit's spectra set-up ----------------------------------------

def _power(x):
    """|x|^2 per element of a complex tensor as re*re + im*im, each
    product rounded: the reference's real(x conj(x))."""
    return x.real * x.real + x.imag * x.imag


def _abs2(x):
    """|x|^2 as the reference's abs(x) ** 2: the modulus sqrt(re*re +
    im*im), correctly rounded, then its square (torch's vectorised
    complex abs forms the modulus so)."""
    return torch.sqrt(_power(x)) ** 2


def _spectra_plain_rows(dfft, mfft, inv_err2, kmax, cross_out, sd_out,
                        absm2_out, power):
    """K4's common arithmetic in PyTorch, ``power`` the rows' unscaled
    |d_k|^2 (changed in place at k = 0).  The complex product is written
    out in real operations, each rounded, as the kernel does: torch's own
    complex product and abs round differently in their vectorised and
    scalar loops, which would tie a row's bits to its place in the
    chunk."""
    m = mfft if mfft.ndim == 3 else mfft[None]
    d0 = dfft[..., 0] * F0_fact
    power[..., 0] = _power(d0)
    sd_out.copy_(torch.sum(power, dim=-1) * inv_err2)
    dK = dfft[..., :kmax].clone()
    dK[..., 0] = d0
    mK = m[..., :kmax].clone()
    mK[..., 0] *= F0_fact
    (a, b), (c, d) = (torch.view_as_real(dK).unbind(-1),
                      torch.view_as_real(mK).unbind(-1))
    out = torch.view_as_real(cross_out)
    out[..., 0] = a * c + b * d          # d conj(m)
    out[..., 1] = b * c - a * d
    if absm2_out is not None:
        absm2_out.copy_(_abs2(mK).expand_as(absm2_out))


def spectra_plain(dfft, mfft, inv_err2, kmax, cross_out, sd_out,
                  absm2_out=None):
    """Plain PyTorch K4, epilogue A: with harmonic 0 of the data and model
    spectra times F0_fact, cross_out = d conj(m) below kmax, sd_out = the
    row's sum of |d_k|^2 over every harmonic times inv_err2, absm2_out =
    |m_k|^2 below kmax (reference fit/portrait.py:915-924)."""
    _spectra_plain_rows(dfft, mfft, inv_err2, kmax, cross_out, sd_out,
                        absm2_out, _power(dfft))
    return cross_out, sd_out, absm2_out


def noise_kc(nharm):
    """The first harmonic of get_noise_PS's noise mean (frac 4) for rows
    of ``nharm`` harmonics."""
    return int((1 - 1.0 / 4) * nharm)


def spectra_noise_plain(dfft, mfft, weights, nbin, kmax, cross_out, sd_out,
                        noise_out, inv_err2_out, absm2_out=None):
    """Plain PyTorch K4, epilogue B: noise_out = get_noise_PS of each row
    (the mean of |d_k|^2 / nbin over its top quarter of harmonics,
    unscaled, reference ops/noise.py:39), inv_err2_out = (noise
    sqrt(nbin/2))^-2 where weights > 0, else 0, then epilogue A with
    it."""
    power = _power(dfft)
    kc = noise_kc(dfft.shape[-1])
    noise_out.copy_(torch.sqrt(torch.mean(power[..., kc:] / nbin, dim=-1)))
    errs_FT = noise_out * math.sqrt(nbin / 2.0)
    inv_err2_out.copy_(torch.where(weights > 0.0, errs_FT ** -2.0,
                                   torch.zeros_like(errs_FT)))
    _spectra_plain_rows(dfft, mfft, inv_err2_out, kmax, cross_out, sd_out,
                        absm2_out, power)
    return cross_out, sd_out, noise_out, inv_err2_out, absm2_out


def _check_spectra(dfft, mfft, kmax, cross_out, sd_out, absm2_out, rowvecs,
                   what):
    """Check K4's arguments (``rowvecs`` the [r, nchan] f64 vectors by
    name); returns (r, nchan, nharm, m_per_row)."""
    _check(dfft, "dfft", torch.complex128, 3)
    r, nchan, nharm = dfft.shape
    if not isinstance(mfft, torch.Tensor) or mfft.ndim not in (2, 3):
        raise ValueError("%s: mfft must be a 2-D or 3-D tensor" % what)
    _check(mfft, "mfft", torch.complex128, mfft.ndim)
    _check(cross_out, "cross_out", torch.complex128, 3)
    _check(sd_out, "sd_out", torch.float64, 2)
    if absm2_out is not None:
        _check(absm2_out, "absm2_out", torch.float64, 3)
    for name, t in rowvecs.items():
        _check(t, name, torch.float64, 2)
    if not 1 <= kmax <= nharm:
        raise ValueError("%s: kmax %d outside 1..%d" % (what, kmax, nharm))
    m_per_row = mfft.ndim == 3
    want_m = (r, nchan, nharm) if m_per_row else (nchan, nharm)
    bad = [name for name, t, shape in (
        ["mfft", mfft, want_m], ["cross_out", cross_out, (r, nchan, kmax)],
        ["sd_out", sd_out, (r, nchan)],
        ["absm2_out", absm2_out, (r, nchan, kmax)],
        *[[n, t, (r, nchan)] for n, t in rowvecs.items()])
        if t is not None and tuple(t.shape) != shape]
    if bad:
        raise ValueError("%s: shapes of %s disagree with dfft %s, kmax %d"
                         % (what, bad, tuple(dfft.shape), kmax))
    _same_device(dfft, mfft, cross_out, sd_out, absm2_out,
                 *rowvecs.values())
    # double2 loads and stores
    for name, t in (("dfft", dfft), ("mfft", mfft), ("cross_out", cross_out)):
        if t.data_ptr() % 16:
            raise ValueError("%s: %s is not 16-byte aligned" % (what, name))
    return r, nchan, nharm, m_per_row


def spectra(dfft, mfft, inv_err2, kmax, cross_out, sd_out, absm2_out=None):
    """K4 wrapper, epilogue A (see csrc/spectra.cu): one pass over a
    chunk's rFFT.  dfft [r, nchan, nharm] complex128 (left unmodified);
    mfft [nchan, nharm] (a model shared by the rows) or [r, nchan, nharm]
    complex128, neither scaled by F0_fact; inv_err2 [r, nchan] f64; kmax
    in 1..nharm.  Writes cross_out [r, nchan, kmax] complex128 (d
    conj(m)), sd_out [r, nchan] f64 (inv_err2 times the row's data power
    over every harmonic) and, when given, absm2_out [r, nchan, kmax] f64
    (|m|^2): the caller's slices of its preallocated tensors.  Returns
    (cross_out, sd_out, absm2_out)."""
    kmax = int(kmax)
    r, nchan, nharm, per_row = _check_spectra(
        dfft, mfft, kmax, cross_out, sd_out, absm2_out,
        {"inv_err2": inv_err2}, "spectra")
    if dfft.device.type == "cpu":
        return spectra_plain(dfft, mfft, inv_err2, kmax, cross_out, sd_out,
                             absm2_out)
    if dfft.device.type != "cuda":
        raise ValueError("spectra: unsupported device %s" % dfft.device)
    if r * nchan:
        _launch("spectra", dfft.device, dfft.data_ptr(), mfft.data_ptr(),
                int(per_row), inv_err2.data_ptr(), r * nchan, nchan, nharm,
                kmax, float(F0_fact), cross_out.data_ptr(), sd_out.data_ptr(),
                None if absm2_out is None else absm2_out.data_ptr())
    return cross_out, sd_out, absm2_out


def spectra_noise(dfft, mfft, weights, nbin, kmax, cross_out, sd_out,
                  noise_out, inv_err2_out, absm2_out=None):
    """K4 wrapper, epilogue B: as ``spectra`` for a fit that measures its
    own noise.  weights [r, nchan] f64 and ``nbin`` (dfft's nharm is
    nbin // 2 + 1) in place of inv_err2; also writes noise_out [r, nchan]
    (get_noise_PS of each row) and inv_err2_out [r, nchan] (1 /
    sigma_FT^2, 0 where the weight is not > 0), and sd_out with it.
    Returns (cross_out, sd_out, noise_out, inv_err2_out, absm2_out)."""
    kmax, nbin = int(kmax), int(nbin)
    r, nchan, nharm, per_row = _check_spectra(
        dfft, mfft, kmax, cross_out, sd_out, absm2_out,
        {"weights": weights, "noise_out": noise_out,
         "inv_err2_out": inv_err2_out}, "spectra_noise")
    if nharm != nbin // 2 + 1:
        raise ValueError("spectra_noise: %d harmonics are not the rFFT of "
                         "%d bins" % (nharm, nbin))
    if dfft.device.type == "cpu":
        return spectra_noise_plain(dfft, mfft, weights, nbin, kmax, cross_out,
                                   sd_out, noise_out, inv_err2_out, absm2_out)
    if dfft.device.type != "cuda":
        raise ValueError("spectra_noise: unsupported device %s" % dfft.device)
    if r * nchan:
        _launch("spectra_noise", dfft.device, dfft.data_ptr(),
                mfft.data_ptr(), int(per_row), weights.data_ptr(), r * nchan,
                nchan, nharm, kmax, float(F0_fact), nbin, noise_kc(nharm),
                math.sqrt(nbin / 2.0), cross_out.data_ptr(),
                sd_out.data_ptr(), noise_out.data_ptr(),
                inv_err2_out.data_ptr(),
                None if absm2_out is None else absm2_out.data_ptr())
    return cross_out, sd_out, noise_out, inv_err2_out, absm2_out


# -- K5: the archive's decode and baseline -----------------------------------

# csrc/unpack.cu kMaxSharedBins: a longer row keeps its block's prefix
# slice in scratch, at most UNPACK_SCRATCH_BYTES of it (fewer blocks,
# striding)
UNPACK_MAX_SHARED_BINS = 28000
UNPACK_SCRATCH_BYTES = 1 << 28


def baseline_window(nbin, frac=0.125):
    """The baseline's window in bins: max(1, int(frac nbin)), as the
    reference's Archive.remove_baseline."""
    return max(1, int(frac * nbin))


def _window_means(x, nwin):
    """The circular window means of the rows of x [rows, nbin] as the
    reference takes them: an rFFT convolution with a boxcar of nwin bins.
    A CPU tensor's FFTs are numpy's (the reference's own pocketfft:
    torch's CPU FFT is another library, and the tests that hold the port
    to the JAX package bit for bit through ill-conditioned fits need the
    reference's rounding); a CUDA tensor's are cuFFT's."""
    nbin = x.shape[-1]
    box = np.zeros(nbin)
    box[:nwin] = 1.0 / nwin
    if x.device.type == "cpu":
        return torch.from_numpy(np.fft.irfft(
            np.fft.rfft(x.numpy(), axis=-1) * np.conj(np.fft.rfft(box)),
            nbin, axis=-1))
    box = torch.as_tensor(box, device=x.device)
    return torch.fft.irfft(torch.fft.rfft(x, dim=-1)
                           * torch.conj(torch.fft.rfft(box)), n=nbin, dim=-1)


def baseline_plain(x, frac=0.125, out=None):
    """Plain PyTorch K5 baseline: each row of x [rows, nbin] f64 less the
    least mean over its circular windows of baseline_window(nbin, frac)
    bins, in the reference's order (pulseportraiture_tpu/io/psrfits.py:248
    Archive.remove_baseline): the window means as an rFFT convolution
    with a boxcar (_window_means), their minimum, the difference.  Into
    ``out`` when given (x itself allowed)."""
    means = _window_means(x, baseline_window(x.shape[-1], frac))
    level = means.amin(dim=-1, keepdim=True)
    if out is None:
        return x - level
    return torch.sub(x, level, out=out)


def stored_values(raw):
    """The values of stored int16 rows ``raw``, whose bytes are the file's
    big-endian ones (an int16 tensor read in native order), as int32: the
    two bytes of each swapped."""
    u = raw.to(torch.int32) & 0xFFFF
    v = ((u & 0xFF) << 8) | (u >> 8)
    return v - ((v & 0x8000) << 1)


def unpack_plain(raw, scl, offs, frac=None, out=None):
    """Plain PyTorch K5: the stored rows raw [rows, nbin] int16
    (big-endian bytes, stored_values) as float64 times scl, plus offs
    ([rows] f64 each), numpy's rounding (the product, then the sum); with
    ``frac``, then baseline_plain.  Into ``out`` when given."""
    x = stored_values(raw).to(torch.float64) * scl[:, None]
    x = torch.add(x, offs[:, None], out=out) if out is not None \
        else x + offs[:, None]
    return x if frac is None else baseline_plain(x, frac, out=x)


def _slice_len(nbin):
    """csrc/unpack.cu slice_len: a row's prefix slice in doubles."""
    return (nbin + 15) & ~15


def _unpack_scratch(rows, nbin, device):
    """(scratch, blocks) of a K5 baseline launch: none for rows whose
    slice fits a block's shared memory, else one slice a block (a row at
    a time each)."""
    if nbin <= UNPACK_MAX_SHARED_BINS:
        return None, 0
    per = _slice_len(nbin) * 8
    blocks = int(max(1, min(rows, UNPACK_SCRATCH_BYTES // per)))
    return torch.empty(blocks * _slice_len(nbin), dtype=torch.float64,
                       device=device), blocks


def _rows_out(out, shape, like, what):
    """``out`` checked as a contiguous f64 tensor of ``shape`` on like's
    device, or a new one."""
    if out is None:
        return torch.empty(shape, dtype=torch.float64, device=like.device)
    _check(out, "out", torch.float64, len(shape))
    if tuple(out.shape) != tuple(shape):
        raise ValueError("%s: out has shape %s, want %s"
                         % (what, tuple(out.shape), tuple(shape)))
    _same_device(like, out)
    return out


def unpack(raw, scl, offs, frac=None, out=None):
    """K5 wrapper (see csrc/unpack.cu): decode the stored rows raw [rows,
    nbin] int16 (the file's big-endian bytes) with scl and offs [rows] f64
    into out [rows, nbin] f64 (new when None), bit-equal to numpy's
    decode of the values; with ``frac``, the baseline of windows of
    baseline_window(nbin, frac) bins removed in the same launch.  Returns
    out."""
    _check(raw, "raw", torch.int16, 2)
    _check(scl, "scl", torch.float64, 1)
    _check(offs, "offs", torch.float64, 1)
    rows, nbin = raw.shape
    if scl.shape[0] != rows or offs.shape[0] != rows:
        raise ValueError("unpack: %d rows, scl %d, offs %d"
                         % (rows, scl.shape[0], offs.shape[0]))
    out = _rows_out(out, (rows, nbin), raw, "unpack")
    _same_device(raw, scl, offs)
    if raw.device.type == "cpu":
        return unpack_plain(raw, scl, offs, frac, out)
    if raw.device.type != "cuda":
        raise ValueError("unpack: unsupported device %s" % raw.device)
    nwin = 0 if frac is None else baseline_window(nbin, frac)
    scratch, blocks = _unpack_scratch(rows, nbin, raw.device) if nwin \
        else (None, 0)
    if rows * nbin:
        _launch("unpack", raw.device, raw.data_ptr(), scl.data_ptr(),
                offs.data_ptr(), rows, nbin, nwin, out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), blocks)
    return out


def baseline(x, frac=0.125, out=None):
    """K5 wrapper, the baseline alone (see csrc/unpack.cu): x [rows, nbin]
    f64 less each row's least window mean (windows of baseline_window(
    nbin, frac) bins) into out (new when None; x itself allowed).
    Returns out."""
    _check(x, "x", torch.float64, 2)
    rows, nbin = x.shape
    out = _rows_out(out, (rows, nbin), x, "baseline")
    if x.device.type == "cpu":
        return baseline_plain(x, frac, out)
    if x.device.type != "cuda":
        raise ValueError("baseline: unsupported device %s" % x.device)
    scratch, blocks = _unpack_scratch(rows, nbin, x.device)
    if rows * nbin:
        _launch("baseline", x.device, x.data_ptr(), rows, nbin,
                baseline_window(nbin, frac), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), blocks)
    return out


# -- K6: the load's noise and S/N -------------------------------------------

def load_stats_plain(x, X, noise_out, snr_out=None, fudge=3.25):
    """Plain PyTorch K6: noise_out [rows] = get_noise_PS of each row of x
    [rows, nbin] f64 from its rFFT X [rows, nharm] complex128 (the power
    (X conj(X)).real / nbin, the square root of the mean of its top
    quarter) and, when snr_out is given, snr_out [rows] = get_SNR with
    that noise (reference ops/noise.py:64, :237)."""
    pows = (X * torch.conj(X)).real / x.shape[-1]
    noise_out.copy_(noise_PS_of_power(pows))
    if snr_out is not None:
        snr_out.copy_(SNR_of_noise(x, noise_out, fudge))
    return noise_out, snr_out


def load_stats(x, X, noise_out, snr_out=None, fudge=3.25):
    """K6 wrapper (see csrc/loadstats.cu): the noise (and, with snr_out,
    the S/N) of each row of x [rows, nbin] f64 from it and its rFFT X
    [rows, nbin // 2 + 1] complex128, written into noise_out and snr_out
    [rows] f64.  Returns (noise_out, snr_out)."""
    _check(x, "x", torch.float64, 2)
    _check(X, "X", torch.complex128, 2)
    _check(noise_out, "noise_out", torch.float64, 1)
    if snr_out is not None:
        _check(snr_out, "snr_out", torch.float64, 1)
    rows, nbin = x.shape
    nharm = nbin // 2 + 1
    if tuple(X.shape) != (rows, nharm) or noise_out.shape[0] != rows or (
            snr_out is not None and snr_out.shape[0] != rows):
        raise ValueError("load_stats: shapes x %s, X %s, noise_out %s "
                         "disagree" % (tuple(x.shape), tuple(X.shape),
                                       tuple(noise_out.shape)))
    _same_device(x, X, noise_out, snr_out)
    if x.device.type == "cpu":
        return load_stats_plain(x, X, noise_out, snr_out, fudge)
    if x.device.type != "cuda":
        raise ValueError("load_stats: unsupported device %s" % x.device)
    if rows:
        _launch("load_stats", x.device, x.data_ptr(), X.data_ptr(), rows,
                nbin, nharm, noise_kc(nharm), float(fudge),
                noise_out.data_ptr(),
                None if snr_out is None else snr_out.data_ptr())
    return noise_out, snr_out


# -- K7: the rotation phasor --------------------------------------------------

TWO_PI = 2.0 * math.pi


def rotate_plain(X, shifts, out=None):
    """Plain PyTorch K7: X [..., nharm] times ops.fourier.phasor of
    shifts (broadcast against X's leading dimensions).  Into ``out`` when
    given."""
    res = X * phasor(shifts, X.shape[-1])
    if out is None:
        return res
    out.copy_(res)
    return out


def rotate(X, shifts, out=None):
    """K7 wrapper (see csrc/rotate.cu): X [..., nharm]
    complex128 times exp(2j pi ((s k) mod 1)) for shifts s [rot]
    broadcastable to X's leading dimensions, into out (new when None; X
    itself allowed when it has the broadcast shape).  Returns out."""
    if not isinstance(X, torch.Tensor) or X.dtype != torch.complex128:
        raise TypeError("rotate: X must be a complex128 tensor")
    shifts = torch.as_tensor(shifts, dtype=torch.float64, device=X.device)
    lead = torch.broadcast_shapes(X.shape[:-1], shifts.shape)
    nharm = X.shape[-1]
    if out is not None:
        _check(out, "out", torch.complex128, len(lead) + 1)
        if tuple(out.shape) != tuple(lead) + (nharm,):
            raise ValueError("rotate: out has shape %s, want %s"
                             % (tuple(out.shape), tuple(lead) + (nharm,)))
        _same_device(X, out)
    if X.device.type == "cpu":
        return rotate_plain(X, shifts, out)
    if X.device.type != "cuda":
        raise ValueError("rotate: unsupported device %s" % X.device)
    X = X.expand(tuple(lead) + (nharm,)).contiguous()
    shifts = shifts.expand(lead).contiguous()
    if out is None:
        out = torch.empty_like(X)
    rows = shifts.numel()
    if rows * nharm:
        _launch("rotate", X.device, X.data_ptr(), shifts.data_ptr(), rows,
                nharm, TWO_PI, out.data_ptr())
    return out


# -- K8: the wavelet smoothing search -----------------------------------------
#
# Three tiers (csrc/wavelet.cu): the set-up (each row's rFFT, its details
# cD_j, sigma and the thresholds), the scan (every candidate's S/N, chi2 and
# noise from the scan's own transforms, on chip) with the certification and
# the winner's smooth, and the route (the candidates' round trips through
# cuFFT, as the reference reads them) for the rows the certification leaves
# uncertain and for the widths the scan does not take.

# bytes of a chunk's buffers: the route's thresholded arrays T and their
# spectra D (and, on the card, cuFFT's copy of D for the inverse); the
# scan's set-up (C and cD) and candidate statistics
SMOOTH_CHUNK_BYTES = 1 << 30
# the median's sort holds a row's |cD_0| (padded to a power of two) in
# shared memory: 128 KB at 16384 bins
SMOOTH_MAX_BINS = 16384
# the scan takes rows of a power of two bins in this range: its two
# transform buffers (nbin / 2 complex128 each) and the running sum (nbin /
# 2 + 1) sit in shared memory, 192 KB at 8192 bins
SCAN_MIN_BINS = 64
SCAN_MAX_BINS = 8192
# The certification (pp_wavelet_certify, _certify_plain).  The scan's
# transforms round otherwise than the FFT library's round trips, so the
# route's S/N, chi2 and noise of a candidate are the scan's within bounds
# drawn, per candidate, from a worst-case bound on floating-point FFT error:
# Higham, Accuracy and Stability of Numerical Algorithms (2nd ed., 2002),
# Theorem 24.2: a radix-2 FFT of 2^t points with twiddles within mu of
# the true ones has |y^ - y|_2 <= t eta / (1 - t eta) |y|_2, eta = mu +
# gamma_4 (sqrt(2) + mu), gamma_k = k u / (1 - k u), u = 2^-53.  The
# scan's radix-4 pass rounds no more than two radix-2 stages (its 4-point
# DFT has exact twiddles +-1, +-i), its real transform's split step is
# counted as two more: t = log2(nbin) + 1 (_cert_eps).  Its twiddle table
# (ops.wavelet.scan_twiddles) takes the angle 2 pi t / nbin within 1.35 u
# times the true one (at most 2 pi) and numpy's cos and sin within an
# ulp: mu = TWIDDLE_ERR.  The FFT library's transforms are held to the
# same bound: the certification checks it on each row's own data (the
# set-up's rFFT of x and irFFT of C_0 within 2 eps of the scan's), and a
# row that fails goes through the route.  From that, for a candidate of level l + 1 with An =
# sqrt(nbin) sum_{j<=l} max|Q_j| |T_j| (its details' spectra; the scan
# reads |T_j|) and |S| <= Sn = sqrt(sig) + max|P_l| |X_0| + An, the two
# evaluations' spectra differ by at most G0 = 2 eps An + 2 gam (max|P_l|
# sqrt(nbin) |x| + An) before the route's round trip (gam: the synthesis
# sums' rounding, gamma_{2L + 4}, _cert_gam) and G = G0 + 3 eps (Sn + G0)
# after it; so the route's noise lies within En = G / sqrt(nbin (nh - kc))
# of the scan's, the square root of its signal power within G, the
# square root of its chi2 within delta (_cert_bounds_plain), and its S/N
# within [lo, hi].  The gated S/N of a candidate that is no repeat then
# lies within [vlo, vhi] (lo where the gate passes for certain, 0 where it
# may fail; hi where it may pass, 0 where it fails for certain).  A row
# stands when the candidate of the greatest vlo (its choice) has vlo > 0
# and every other candidate's vhi, times 1 + CERT_MARGIN, stays below it;
# a row zeroed stands when no vhi is above 0; a NaN or infinite chi2,
# noise, signal power or bound leaves it uncertain.  CERT_MARGIN and
# CHI2_MARGIN also cover the rounding of the sums of the S/N and the chi2
# (relative, below nbin u).  An uncertain row goes through the route whole.
# The candidates whose noise lies at the round trip's rounding floor have
# wide intervals: a row is uncertain where one of them, or a candidate
# within the margin, could overtake its choice.
CERT_MARGIN = 1e-6
CHI2_MARGIN = 1e-9
_U = 2.0 ** -53
TWIDDLE_ERR = 12.0 * _U
# rows of K8's calls on the card by the tier that decided them: scanned
# (the scan and its certification), redecided (scanned rows the route then
# took, uncertain), unscanned (rows of a width the scan does not take,
# through the route whole)
SMOOTH_ROWS = {"scanned": 0, "redecided": 0, "unscanned": 0}


def smooth_chunk_rows(nlevel, nfact, nbin):
    """Rows of a route chunk: SMOOTH_CHUNK_BYTES over a row's [nlevel,
    nfact] candidates (nbin float64 and twice nbin // 2 + 1 complex128
    each), at least 1."""
    per_row = nlevel * nfact * (nbin * 8 + 2 * (nbin // 2 + 1) * 16)
    return max(1, SMOOTH_CHUNK_BYTES // per_row)


def scan_chunk_rows(nlevel, nfact, nbin):
    """Rows of a scan chunk: SMOOTH_CHUNK_BYTES over a row's set-up (C
    [nlevel, nbin // 2 + 1] complex128, cD [nlevel, nbin] float64) and its
    candidates' statistics (five float64 and a flag each), at least 1."""
    per_row = nlevel * ((nbin // 2 + 1) * 16 + nbin * 8) \
        + nlevel * nfact * 44
    return max(1, SMOOTH_CHUNK_BYTES // per_row)


def scannable(nbin):
    """Whether the scan takes rows of ``nbin`` bins."""
    return SCAN_MIN_BINS <= nbin <= SCAN_MAX_BINS and nbin & (nbin - 1) == 0


def _smooth_args(port, wavelet, nlevel, facts, threshtype, out, choice):
    """Check smooth_search's arguments; returns (tables, out, choice): the
    search tables of ops.wavelet.search_tables on port's device, out and
    choice new where None."""
    from .ops.wavelet import search_tables

    _check(port, "port", torch.float64, 2)
    _check(facts, "facts", torch.float64, 1)
    rows, nbin = port.shape
    if nbin < 2 or nbin % 2 or int(nlevel) < 1 or facts.shape[0] < 1:
        raise ValueError("smooth_search: port %s (nbin even), nlevel %s and "
                         "facts %s: want an even nbin, a level and a factor"
                         % (tuple(port.shape), nlevel, tuple(facts.shape)))
    if threshtype not in ("hard", "soft"):
        raise ValueError("smooth_search: unknown threshold mode '%s'"
                         % threshtype)
    if out is None:
        out = torch.empty_like(port)
    else:
        _check(out, "out", torch.float64, 2)
    if choice is None:
        choice = torch.empty((rows, 2), dtype=torch.int64, device=port.device)
    else:
        _check(choice, "choice", torch.int64, 2)
    if tuple(out.shape) != (rows, nbin) or tuple(choice.shape) != (rows, 2):
        raise ValueError("smooth_search: out %s and choice %s, want %s and "
                         "%s" % (tuple(out.shape), tuple(choice.shape),
                                 (rows, nbin), (rows, 2)))
    _same_device(port, facts, out, choice)
    return search_tables(wavelet, nbin, int(nlevel), port.device), out, choice


def _check_card(port, what):
    if port.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, port.device))
    if port.shape[1] > SMOOTH_MAX_BINS:
        raise ValueError("%s: %d bins; the kernel takes at most %d"
                         % (what, port.shape[1], SMOOTH_MAX_BINS))


def _setup_plain(x, ana, facts):
    """The set-up in torch: X = rFFT(x), cD_j = irFFT(A_j X), each row's
    noise errs (get_noise_PS from X) and thresholds lam [rows, nfact]."""
    nbin = x.shape[-1]
    X = torch.fft.rfft(x, dim=-1)
    xr, xi = X.real[:, None], X.imag[:, None]
    # analysis: C_j = A_j X
    cD = torch.fft.irfft(torch.complex(
        ana.real * xr - ana.imag * xi, ana.real * xi + ana.imag * xr),
        n=nbin, dim=-1)
    # sigma, the thresholds, the row's noise
    errs = noise_PS_of_power(_power(X) / nbin)
    sigma = median(torch.abs(cD[:, 0])) / 0.6745
    lam = facts[None, :] * sigma[:, None] * math.sqrt(
        2.0 * math.log(float(nbin)))
    return X, cD, errs, lam


def _setup_card(x, ana, facts, C, lam, errs):
    """The set-up on the card into C, lam and errs (rows x.shape[0] of
    them): pp_wavelet_analysis, cuFFT's inverse, pp_wavelet_sigma.
    Returns (X, cD)."""
    r, nbin = x.shape
    nlevel, nh = ana.shape
    dev = x.device
    X = torch.fft.rfft(x, dim=-1)
    _launch("smooth_search", dev, X.data_ptr(), ana.data_ptr(), r, nlevel,
            nh, C.data_ptr(), symbol="pp_wavelet_analysis", count=False)
    cD = torch.fft.irfft(C[:r], n=nbin, dim=-1)
    _launch("smooth_search", dev, X.data_ptr(), cD.data_ptr(),
            facts.data_ptr(), r, nlevel, nbin, nh, noise_kc(nh),
            1 << (nbin - 1).bit_length(), facts.shape[0],
            math.sqrt(2.0 * math.log(float(nbin))), lam.data_ptr(),
            errs.data_ptr(), symbol="pp_wavelet_sigma", count=False)
    return X, cD


def _route_candidates_plain(x, tables, facts, soft, t, d):
    """The route's candidates in torch on rows x: (errs, snr, chi2, same)
    with t [r, nlevel, nfact, nbin] the candidates' smooths and d their
    round trip's spectra S' (both written in place); snr not gated."""
    ana, P, Q = tables
    nbin = x.shape[-1]
    nh = nbin // 2 + 1
    kc = noise_kc(nh)
    X, cD, errs, lam = _setup_plain(x, ana, facts)
    xr, xi = X.real[:, None], X.imag[:, None]
    r, nlevel = cD.shape[:2]
    c, lm = cD[:, :, None, :], lam[:, None, :, None]
    if soft:
        torch.mul(torch.sign(c), torch.clamp(torch.abs(c) - lm, min=0.0),
                  out=t)
    else:
        torch.where(torch.abs(c) < lm, torch.zeros((), dtype=c.dtype,
                                                   device=x.device), c, out=t)
    same = torch.zeros((r, nlevel, facts.shape[0]), dtype=torch.bool,
                       device=x.device)
    same[:, :, 1:] = (t[:, :, 1:] == t[:, :, :-1]).all(-1)
    torch.fft.rfft(t, dim=-1, out=d)
    # synthesis in place: d[:, j] <- S_{j+1} = P_{j+1} X
    #                                    + sum_{i<=j} Q_i D_i
    for j in range(nlevel):
        dr, di = d[:, j].real, d[:, j].imag
        qr, qi = Q[j].real, Q[j].imag
        tr, ti = qr * dr - qi * di, qr * di + qi * dr
        accr = tr if j == 0 else accr + tr
        acci = ti if j == 0 else acci + ti
        d[:, j] = torch.complex(P[j] * xr + accr, P[j] * xi + acci)
    torch.fft.irfft(d, n=nbin, dim=-1, out=t)
    torch.fft.rfft(t, dim=-1, out=d)
    # search: each candidate's pseudo-S/N and chi2
    pw = _power(d)
    sig = pw[..., 1:].sum(-1)
    noise = torch.sqrt(pw[..., kc:].sum(-1) / nbin / (nh - kc)) * \
        math.sqrt(0.5 * nbin)
    pos = noise > 0.0
    snr = torch.where(pos, sig / torch.where(pos, noise, 1.0),
                      torch.where(sig > 0.0, math.inf, 0.0))
    serr = torch.where(errs > 0.0, errs, 1.0)
    res = (x[:, None, None, :] - t) / serr[:, None, None, None]
    chi2 = (res * res).sum(-1) / nbin
    return errs, snr, chi2, same


def _route(port, tables, facts, tol, soft, out, choice, card, setup=None):
    """The route over chunks of rows: the kernels' stages on the card
    (``card``), their plain versions otherwise, between the same torch.fft
    calls on the same shapes.  The plain stages round each product and sum
    as the kernels do (real operations, no fused multiply-add), so on one
    device both hand cuFFT the same bits.  The kernels write each row's
    winner (its irFFT(S), already made) into out; the plain stages leave
    out to smooth_search_plain.  ``setup``: the rows' set-up (X, cD, lam,
    errs) where the card has it already (the scan's, gathered: cuFFT gives
    a row the same bits in any batch), else made here."""
    ana, P, Q = tables
    rows, nbin = port.shape
    nlevel, nh = P.shape
    nfact = facts.shape[0]
    kc = noise_kc(nh)
    step = min(rows, smooth_chunk_rows(nlevel, nfact, nbin))
    dev = port.device
    T = torch.empty((step, nlevel, nfact, nbin), dtype=torch.float64,
                    device=dev)
    D = torch.empty((step, nlevel, nfact, nh), dtype=torch.complex128,
                    device=dev)
    if card:
        if setup is None:
            C = torch.empty((step, nlevel, nh), dtype=torch.complex128,
                            device=dev)
            lam = torch.empty((step, nfact), dtype=torch.float64, device=dev)
            errs = torch.empty(step, dtype=torch.float64, device=dev)
        same = torch.empty((step, nlevel, nfact), dtype=torch.int32,
                           device=dev)
        snr = torch.empty((step, nlevel, nfact), dtype=torch.float64,
                          device=dev)
        chi2 = torch.empty_like(snr)
    for c0 in range(0, rows, step):
        x = port[c0:c0 + step]
        r = x.shape[0]
        if card:
            if setup is None:
                X, cD = _setup_card(x, ana, facts, C, lam, errs)
            else:
                X, cD, lam, errs = (t[c0:c0 + r] for t in setup)
            _launch("smooth_search", dev, cD.data_ptr(), lam.data_ptr(), r,
                    nlevel, nfact, nbin, int(soft), T.data_ptr(),
                    same.data_ptr(), symbol="pp_wavelet_threshold",
                    count=False)
            torch.fft.rfft(T[:r], dim=-1, out=D[:r])
            _launch("smooth_search", dev, X.data_ptr(), P.data_ptr(),
                    Q.data_ptr(), r, nlevel, nfact, nh, D.data_ptr(),
                    symbol="pp_wavelet_synthesis", count=False)
            torch.fft.irfft(D[:r], n=nbin, dim=-1, out=T[:r])
            torch.fft.rfft(T[:r], dim=-1, out=D[:r])
            _launch("smooth_search", dev, x.data_ptr(), T.data_ptr(),
                    D.data_ptr(), errs.data_ptr(), r, nlevel, nfact, nbin, nh,
                    kc, float(tol), snr.data_ptr(), chi2.data_ptr(),
                    symbol="pp_wavelet_search", count=False)
            _launch("smooth_search", dev, T.data_ptr(), snr.data_ptr(),
                    chi2.data_ptr(), same.data_ptr(), r, nlevel, nfact,
                    nbin, float(tol), out[c0:c0 + r].data_ptr(),
                    choice[c0:c0 + r].data_ptr(),
                    symbol="pp_wavelet_select")
            continue
        _, snr, chi2, same = _route_candidates_plain(x, tables, facts, soft,
                                                     T[:r], D[:r])
        snr = torch.where(chi2 - 1.0 <= tol, snr, 0.0)
        # select: per level the first best factor that repeats no earlier
        # one, a level kept only when strictly better
        dup = torch.cumprod(same.to(torch.int64), dim=1).bool()
        snr = torch.where(dup, -math.inf, snr)
        best = torch.full((r,), -math.inf, dtype=torch.float64, device=dev)
        bl = torch.full((r,), -1, dtype=torch.int64, device=dev)
        bf = torch.zeros(r, dtype=torch.int64, device=dev)
        for lev in range(nlevel):
            ib = torch.argmax(snr[:, lev], dim=1)
            m = snr[:, lev].gather(1, ib[:, None])[:, 0]
            better = m > best
            bl = torch.where(better, lev, bl)
            bf = torch.where(better, ib, bf)
            best = torch.maximum(best, m)
        ar, blc = torch.arange(r, device=dev), bl.clamp(min=0)
        keep = (bl >= 0) & (best > 0.0) & (chi2[ar, blc, bf] - 1.0 <= tol)
        choice[c0:c0 + r, 0] = torch.where(keep, bl + 1, 0)
        choice[c0:c0 + r, 1] = torch.where(keep, bf, -1)
    return out, choice


# -- K8's scan: its own transforms, in torch -----------------------------------

def _radices(n):
    """The radices of the scan's passes over n = 2^m complex points: one
    radix-2 pass first where m is odd, then radix-4 passes."""
    m = n.bit_length() - 1
    return [2] * (m % 2) + [4] * (m // 2)


def _fft_scan(re, im, tw):
    """The scan's complex forward FFT over the last axis of (re, im) (n
    points, tw scan_twiddles(2n)): Stockham autosort passes, each
    butterfly's inputs times their twiddles, then its radix-2 or radix-4
    DFT, every product and sum rounded in pp_wavelet_scan's order."""
    n = re.shape[-1]
    nbin = 2 * n
    p = 1
    for R in _radices(n):
        m = n // R
        i = torch.arange(m, device=re.device)
        k = i & (p - 1)
        u = [(re[..., i + q * m], im[..., i + q * m]) for q in range(R)]
        for q in range(1, R):
            t = q * k * (nbin // (R * p))
            c, s = tw[t, 0], tw[t, 1]
            a, b = u[q]
            u[q] = (a * c - b * s, a * s + b * c)
        if R == 2:
            (a0r, a0i), (a1r, a1i) = u
            y = [(a0r + a1r, a0i + a1i), (a0r - a1r, a0i - a1i)]
        else:
            (u0r, u0i), (u1r, u1i), (u2r, u2i), (u3r, u3i) = u
            b0r, b0i = u0r + u2r, u0i + u2i
            b1r, b1i = u0r - u2r, u0i - u2i
            b2r, b2i = u1r + u3r, u1i + u3i
            b3r, b3i = u1r - u3r, u1i - u3i
            y = [(b0r + b2r, b0i + b2i), (b1r + b3i, b1i - b3r),
                 (b0r - b2r, b0i - b2i), (b1r - b3i, b1i + b3r)]
        j = (i - k) * R + k
        re, im = torch.empty_like(re), torch.empty_like(im)
        for q in range(R):
            re[..., j + q * p] = y[q][0]
            im[..., j + q * p] = y[q][1]
        p *= R
    return re, im


def _rfft_scan(x, tw):
    """The scan's real FFT of x [..., nbin]: the complex FFT of its
    nbin / 2 (even, odd) pairs, then the split into nbin / 2 + 1
    harmonics.  Returns (re, im)."""
    n = x.shape[-1] // 2
    zr, zi = _fft_scan(x[..., 0::2], x[..., 1::2], tw)
    k = torch.arange(n + 1, device=x.device)
    a, b = k % n, (n - k) % n
    pr, pi, mr, mi = zr[..., a], zi[..., a], zr[..., b], zi[..., b]
    er, ei = (pr + mr) * 0.5, (pi - mi) * 0.5
    orr, oi = (pr - mr) * 0.5, (pi + mi) * 0.5
    c, s = tw[k, 0], tw[k, 1]
    return er + (c * oi + s * orr), ei + (s * oi - c * orr)


def _irfft_scan(Sr, Si, tw):
    """The scan's inverse real FFT of the nbin / 2 + 1 harmonics (Sr, Si)
    to nbin bins (the imaginary parts of harmonics 0 and nbin / 2 dropped,
    as irFFT's): the merge into nbin / 2 complex points, scaled by 1 /
    nbin, and the complex FFT of their conjugates, conjugated."""
    n = Sr.shape[-1] - 1
    nbin = 2 * n
    Si = Si.clone()
    Si[..., 0] = 0.0
    Si[..., n] = 0.0
    k = torch.arange(n, device=Sr.device)
    ar, ai, br, bi = Sr[..., k], Si[..., k], Sr[..., n - k], Si[..., n - k]
    inv = 1.0 / nbin
    er, ei = (ar + br) * inv, (ai - bi) * inv
    o_r, o_i = (ar - br) * inv, (ai + bi) * inv
    c, s = tw[k, 0], tw[k, 1]
    wr, wi = o_r * c + o_i * s, o_i * c - o_r * s
    zr, zi = _fft_scan(er - wi, -(ei + wr), tw)
    out = torch.empty(Sr.shape[:-1] + (nbin,), dtype=Sr.dtype,
                      device=Sr.device)
    out[..., 0::2] = zr
    out[..., 1::2] = -zi
    return out


def _edge_zeroed(v):
    """v with its first and last harmonics set to 0 (a copy)."""
    v = v.clone()
    v[..., 0] = 0.0
    v[..., -1] = 0.0
    return v


def _scan_plain(x, X, cD, lam, errs, P, Q, tw, soft, qmax):
    """The scan in torch: for each row, factor and level l + 1, its
    candidate's spectrum S = P_l X + sum_{j<=l} Q_j rFFT(T_j) from the
    scan's own rFFT of the thresholded details T_j, read as
    pp_wavelet_scan reads it: stats float64 (the pseudo-S/N, not gated; the chi2 against x; the noise get_noise_PS;
    the signal power sig over harmonics 1..nbin/2; the norm sum_{j<=l}
    qmax[j] |T_j| of its details) [rows, nlevel, nfact, 5] and same
    [rows, nlevel, nfact] int32 (T_j equal to the factor before's at every
    bin)."""
    from .ops.wavelet import threshold

    mode = "soft" if soft else "hard"
    rows, nlevel, nbin = cD.shape
    nfact = lam.shape[1]
    nh = nbin // 2 + 1
    kc = noise_kc(nh)
    dev = x.device
    Xr, Xi = X.real[:, None], _edge_zeroed(X.imag)[:, None]
    w = torch.full((nh,), 2.0, dtype=torch.float64, device=dev)
    w[0] = w[-1] = 1.0
    serr = torch.where(errs > 0.0, errs, 1.0)[:, None]
    stats = torch.empty((rows, nlevel, nfact, 5), dtype=torch.float64,
                        device=dev)
    same = torch.zeros((rows, nlevel, nfact), dtype=torch.int32, device=dev)
    tnorm = torch.zeros((rows, nfact), dtype=torch.float64, device=dev)
    for j in range(nlevel):
        t = threshold(cD[:, j, None, :], lam[:, :, None], mode)
        tnorm = tnorm + qmax[j] * torch.sqrt((t * t).sum(-1))
        same[:, j, 1:] = (t[:, 1:] == t[:, :-1]).all(-1).to(torch.int32)
        Dr, Di = _rfft_scan(t, tw)
        qr, qi = Q[j].real, Q[j].imag
        tr, ti = qr * Dr - qi * Di, qr * Di + qi * Dr
        accr = tr if j == 0 else accr + tr
        acci = ti if j == 0 else acci + ti
        Sr = P[j] * Xr + accr
        Si = _edge_zeroed(P[j] * Xi + acci)
        pw = Sr * Sr + Si * Si
        sig = pw[..., 1:].sum(-1)
        noise = torch.sqrt(pw[..., kc:].sum(-1) / nbin / (nh - kc))
        nr = noise * math.sqrt(0.5 * nbin)
        pos = nr > 0.0
        stats[:, j, :, 0] = torch.where(
            pos, sig / torch.where(pos, nr, 1.0),
            torch.where(sig > 0.0, math.inf, 0.0))
        Rr, Ri = Xr - Sr, Xi - Si
        res = ((Rr * Rr + Ri * Ri) * w).sum(-1)
        stats[:, j, :, 1] = res / nbin / (serr * serr) / nbin
        stats[:, j, :, 2] = noise
        stats[:, j, :, 3] = sig
        stats[:, j, :, 4] = tnorm
    return stats, same


def _cert_eps(nbin):
    """The relative error bound of one transform of nbin points (see
    CERT_MARGIN): Higham's Theorem 24.2 with t = log2(nbin) + 1 stages."""
    t = math.log2(nbin) + 1.0
    eta = TWIDDLE_ERR + 4.0 * _U / (1.0 - 4.0 * _U) * (math.sqrt(2.0)
                                                       + TWIDDLE_ERR)
    return t * eta / (1.0 - t * eta)


def _cert_gam(nlevel):
    """gamma_{2 nlevel + 4}: the relative rounding of a candidate's
    synthesis sum P X + sum_j Q_j D_j (see CERT_MARGIN)."""
    k = 2 * nlevel + 4
    return k * _U / (1.0 - k * _U)


def _cert_bounds_plain(x, X, cD, errs, stats, ana0, maxima, tw):
    """The certification's bounds in torch (see CERT_MARGIN,
    pp_wavelet_certify's cand_bounds): (G, En, delta) [rows, nlevel,
    nfact] of each candidate and bad [rows], where the FFT library's rFFT
    of x (X) or irFFT of C_0 = ana0 X (cD_0) strays beyond 2 eps of the
    scan's transforms.  maxima: search_maxima's [2 nlevel]."""
    rows, nlevel, nbin = cD.shape
    nh = nbin // 2 + 1
    eps, gam = _cert_eps(nbin), _cert_gam(nlevel)
    sn, r2n = math.sqrt(nbin), math.sqrt(2.0 / nbin)
    nx = torch.sqrt((x * x).sum(-1))
    pl = maxima[nlevel:][None, :, None]
    An = sn * stats[..., 4]
    Sn = torch.sqrt(stats[..., 3]) + pl * X[:, 0].real.abs()[:, None, None] \
        + An
    G0 = 2.0 * eps * An + 2.0 * gam * (pl * sn * nx[:, None, None] + An)
    G = G0 + 3.0 * eps * (Sn + G0)
    En = G / math.sqrt(nbin * (nh - noise_kc(nh)))
    delta = (math.sqrt(2.0) * eps * nx[:, None, None]
             + r2n * (eps * (Sn + G0) + G0)) / (
        torch.where(errs > 0.0, errs, 1.0)[:, None, None] * sn)
    # the library's transforms of the row against the scan's
    Xr, Xi = _rfft_scan(x, tw)
    fwd = torch.sqrt(((Xr - X.real) ** 2 + (Xi - X.imag) ** 2).sum(-1)) \
        <= 2.0 * eps * (sn * nx)
    xr, xi = X.real, X.imag
    cr = ana0.real * xr - ana0.imag * xi
    ci = ana0.real * xi + ana0.imag * xr
    gap = torch.sqrt(((cD[:, 0] - _irfft_scan(cr, ci, tw)) ** 2).sum(-1))
    inv = gap <= 2.0 * eps * (r2n * torch.sqrt((cr * cr + ci * ci).sum(-1)))
    return G, En, delta, ~(fwd & inv & torch.isfinite(nx))


def _certify_plain(x, X, cD, stats, same, errs, tol, ana0, maxima, tw):
    """The certification and choice in torch (see CERT_MARGIN): (choice
    [rows, 2] int64, the scan's (level, factor) or (0, -1) for a row
    zeroed; uncertain [rows] bool)."""
    rows, nlevel, nfact, _ = stats.shape
    nbin = x.shape[-1]
    snr, chi2, noise, sig, _ = stats.unbind(-1)
    dup = torch.cumprod(same.to(torch.int64), dim=1).bool()
    G, En, delta, bad = _cert_bounds_plain(x, X, cD, errs, stats, ana0,
                                           maxima, tw)
    # the gate: passed for certain, failed for certain, or either
    mchi = CHI2_MARGIN + 2.0 * torch.sqrt(chi2) * delta + delta * delta
    d = chi2 - 1.0
    sure_in, sure_out = d <= tol - mchi, d > tol + mchi
    # the route's S/N within [lo, hi]; its gated S/N within [vlo, vhi]
    c = math.sqrt(0.5 * nbin)
    rs = torch.sqrt(sig)
    sig_lo = torch.clamp(rs - G, min=0.0) ** 2
    sig_hi = (rs + G) ** 2
    nlo = noise - En
    lo = torch.where(sig_lo > 0.0, sig_lo / ((noise + En) * c), 0.0)
    hi = torch.where(sig_hi > 0.0, torch.where(
        nlo > 0.0, sig_hi / (nlo * c), math.inf), 0.0)
    vlo = torch.where(dup, -math.inf, torch.where(sure_in, lo, 0.0))
    vhi = torch.where(dup, -math.inf, torch.where(sure_out, 0.0, hi))
    bad = bad | (~dup & ~(torch.isfinite(chi2) & torch.isfinite(noise)
                          & torch.isfinite(sig) & torch.isfinite(G)
                          & torch.isfinite(delta))).flatten(1).any(1)
    vlo, vhi = vlo.flatten(1), vhi.flatten(1)
    best, win = torch.max(vlo, dim=1)
    keep = best > 0.0
    # a rival: another upper bound within the margin of the best lower
    # bound (kept rows), above 0 (rows zeroed)
    hit = torch.where(keep[:, None], vhi * (1.0 + CERT_MARGIN)
                      >= best[:, None], vhi > 0.0)
    hit[torch.arange(rows, device=x.device), win] &= ~keep
    choice = torch.stack([torch.where(keep, win // nfact + 1, 0),
                          torch.where(keep, win % nfact, -1)], dim=1)
    return choice, bad | hit.any(1)


def _make_plain(x, X, cD, lam, P, Q, tw, soft, choice):
    """The chosen candidates' smooths in torch by the scan's transforms:
    irFFT(P_l X + sum_{j<l} Q_j rFFT(T_j)) at each row's (level l,
    factor), zeros where choice is (0, -1)."""
    from .ops.wavelet import threshold

    mode = "soft" if soft else "hard"
    out = torch.zeros_like(x)
    for lev in torch.unique(choice[:, 0]).tolist():
        if lev <= 0:
            continue
        rows = torch.nonzero(choice[:, 0] == lev)[:, 0]
        lm = lam[rows, choice[rows, 1]][:, None]
        for j in range(lev):
            Dr, Di = _rfft_scan(threshold(cD[rows, j], lm, mode), tw)
            qr, qi = Q[j].real, Q[j].imag
            tr, ti = qr * Dr - qi * Di, qr * Di + qi * Dr
            accr = tr if j == 0 else accr + tr
            acci = ti if j == 0 else acci + ti
        Xs = X[rows]
        out[rows] = _irfft_scan(P[lev - 1] * Xs.real + accr,
                                P[lev - 1] * Xs.imag + acci, tw)
    return out


def smooth_scan_plain(port, wavelet, nlevel, facts, threshtype="hard"):
    """Plain PyTorch version of K8's scan (pp_wavelet_scan, see
    smooth_scan): the set-up in torch, then _scan_plain.  Returns (stats,
    same)."""
    from .ops.wavelet import scan_twiddles, search_maxima

    tables, _, _ = _smooth_args(port, wavelet, nlevel, facts, threshtype,
                                None, None)
    X, cD, errs, lam = _setup_plain(port, tables[0], facts)
    return _scan_plain(port, X, cD, lam, errs, tables[1], tables[2],
                       scan_twiddles(port.shape[1], port.device),
                       threshtype == "soft", search_maxima(
                           wavelet, port.shape[1], int(nlevel), port.device))


def smooth_scan(port, wavelet, nlevel, facts, threshtype="hard"):
    """K8's scan on the card (csrc/wavelet.cu pp_wavelet_scan after the
    set-up's kernels and cuFFT): every candidate's (S/N not gated, chi2,
    noise, signal power, its details' norm) [rows, nlevel, nfact, 5]
    float64 (see _scan_plain) and its repeat
    flag [rows, nlevel, nfact] int32, for rows of a width the scan takes
    (``scannable``).  The plain version for a CPU tensor.  Its launches
    are not counted: the main path counts K8 where it decides
    (smooth_search)."""
    from .ops.wavelet import search_maxima

    if port.device.type == "cpu":
        return smooth_scan_plain(port, wavelet, nlevel, facts, threshtype)
    tables, _, _ = _smooth_args(port, wavelet, nlevel, facts, threshtype,
                                None, None)
    _check_card(port, "smooth_scan")
    rows, nbin = port.shape
    if not scannable(nbin):
        raise ValueError("smooth_scan: %d bins; the scan takes powers of "
                         "two from %d to %d" % (nbin, SCAN_MIN_BINS,
                                                SCAN_MAX_BINS))
    nfact = facts.shape[0]
    maxima = search_maxima(wavelet, nbin, int(nlevel), port.device)
    stats = torch.empty((rows, int(nlevel), nfact, 5), dtype=torch.float64,
                        device=port.device)
    same = torch.empty((rows, int(nlevel), nfact), dtype=torch.int32,
                       device=port.device)
    for c0, x, X, _, cD, lam, errs in _scan_chunks(port, tables, facts):
        _scan_launch(x, X, cD, lam, errs, tables, maxima, facts, threshtype
                     == "soft", stats[c0:], same[c0:])
    return stats, same


def _scan_chunks(port, tables, facts):
    """The set-up on the card over scan chunks: yields (first row, x, X, C,
    cD, lam, errs) per chunk (the buffers reused)."""
    rows, nbin = port.shape
    nlevel, nh = tables[1].shape
    step = min(rows, scan_chunk_rows(nlevel, facts.shape[0], nbin))
    dev = port.device
    C = torch.empty((step, nlevel, nh), dtype=torch.complex128, device=dev)
    lam = torch.empty((step, facts.shape[0]), dtype=torch.float64,
                      device=dev)
    errs = torch.empty(step, dtype=torch.float64, device=dev)
    for c0 in range(0, rows, step):
        x = port[c0:c0 + step]
        X, cD = _setup_card(x, tables[0], facts, C, lam, errs)
        r = x.shape[0]
        yield c0, x, X, C[:r], cD, lam[:r], errs[:r]


def _scan_launch(x, X, cD, lam, errs, tables, maxima, facts, soft, stats,
                 same):
    from .ops.wavelet import scan_twiddles

    r, nbin = x.shape
    _, P, Q = tables
    nlevel, nh = P.shape
    _launch("smooth_search", x.device, X.data_ptr(), cD.data_ptr(),
            lam.data_ptr(), errs.data_ptr(), P.data_ptr(), Q.data_ptr(),
            scan_twiddles(nbin, x.device).data_ptr(), maxima.data_ptr(), r,
            nlevel,
            facts.shape[0], nbin, noise_kc(nh), int(soft), stats.data_ptr(),
            same.data_ptr(), symbol="pp_wavelet_scan", count=False)


def _scan_certify(port, tables, maxima, facts, tol, soft, out, choice):
    """The set-up, the scan and the certification on the card over scan
    chunks of port's rows (a width the scan takes): each certified row's
    choice and smooth into choice and out.  Returns (uncertain [rows] int32
    on the card, the set-up (X, cD, lam, errs) of the rows where they made
    one chunk, else None); no host sync."""
    from .ops.wavelet import scan_twiddles

    _, P, Q = tables
    nbin = port.shape[1]
    nlevel = P.shape[0]
    nfact = facts.shape[0]
    dev = port.device
    tw = scan_twiddles(nbin, dev)
    eps, gam = _cert_eps(nbin), _cert_gam(nlevel)
    uncertain = torch.empty(port.shape[0], dtype=torch.int32, device=dev)
    setup = None
    for c0, x, X, C, cD, lam, errs in _scan_chunks(port, tables, facts):
        setup = (X, cD, lam, errs) if c0 == 0 and x.shape[0] == \
            port.shape[0] else None
        r = x.shape[0]
        stats = torch.empty((r, nlevel, nfact, 5), dtype=torch.float64,
                            device=dev)
        same = torch.empty((r, nlevel, nfact), dtype=torch.int32,
                           device=dev)
        _scan_launch(x, X, cD, lam, errs, tables, maxima, facts, soft, stats,
                     same)
        _launch("smooth_search", dev, x.data_ptr(), X.data_ptr(),
                C.data_ptr(), cD.data_ptr(), lam.data_ptr(), errs.data_ptr(),
                P.data_ptr(), Q.data_ptr(), tw.data_ptr(), maxima.data_ptr(),
                stats.data_ptr(), same.data_ptr(), r, nlevel, nfact, nbin,
                noise_kc(nbin // 2 + 1), int(soft), float(tol), CERT_MARGIN,
                CHI2_MARGIN, eps, gam, out[c0:].data_ptr(),
                choice[c0:].data_ptr(), uncertain[c0:].data_ptr(),
                symbol="pp_wavelet_certify")
    return uncertain, setup


def _plain_smooths(port, wavelet, threshtype, facts, choice, out):
    """Each chosen row's smooth into out as the reference makes its
    candidates: ops.wavelet.wavelet_smooth at the chosen level over every
    row and factor (one call per level chosen)."""
    from .ops.wavelet import wavelet_smooth

    fgrid = facts.reshape(-1, 1)
    for lev in torch.unique(choice[:, 0]).tolist():
        if lev > 0:
            rows = torch.nonzero(choice[:, 0] == lev)[:, 0]
            cand = wavelet_smooth(port, wavelet, lev, threshtype, fgrid)
            out[rows] = cand[choice[rows, 1], rows]
    return out


def _smooth_tiers(port, wavelet, nlevel, facts, tol, threshtype, out, choice,
                  card):
    """K8 in its three tiers over port's rows, on the card (``card``) or
    through the plain versions of the scan and the route: the set-up and
    the scan, the certification with each certified row's choice and
    smooth, then the route over the uncertain rows, gathered with their
    set-up (on the card one host sync, for their count); for a width the
    scan does not take, the route over every row.  Returns (out, choice, uncertain rows [n]
    int64, or None where every row went through the route)."""
    from .ops.wavelet import scan_twiddles, search_maxima

    tables, out, choice = _smooth_args(port, wavelet, nlevel, facts,
                                       threshtype, out, choice)
    rows, nbin = port.shape
    soft = threshtype == "soft"
    tol = float(tol)
    if not rows:
        return out, choice, None
    if not scannable(nbin):
        if card:
            _route(port, tables, facts, tol, soft, out, choice, card=True)
        else:
            smooth_search_plain(port, wavelet, nlevel, facts, tol,
                                threshtype, out, choice)
        return out, choice, None
    maxima = search_maxima(wavelet, nbin, int(nlevel), port.device)
    if card:
        flags, setup = _scan_certify(port, tables, maxima, facts, tol, soft,
                                     out, choice)
        uncertain = torch.nonzero(flags)[:, 0]    # the call's one host sync
        if len(uncertain):
            n = len(uncertain)
            o = torch.empty((n, nbin), dtype=torch.float64,
                            device=port.device)
            c = torch.empty((n, 2), dtype=torch.int64, device=port.device)
            _route(port.index_select(0, uncertain), tables, facts, tol, soft,
                   o, c, card=True, setup=None if setup is None else tuple(
                       t.index_select(0, uncertain) for t in setup))
            out.index_copy_(0, uncertain, o)
            choice.index_copy_(0, uncertain, c)
        return out, choice, uncertain
    ana, P, Q = tables
    tw = scan_twiddles(nbin, port.device)
    X, cD, errs, lam = _setup_plain(port, ana, facts)
    stats, same = _scan_plain(port, X, cD, lam, errs, P, Q, tw, soft, maxima)
    ch, unc = _certify_plain(port, X, cD, stats, same, errs, tol, ana[0],
                             maxima, tw)
    choice.copy_(ch)
    out.copy_(_make_plain(port, X, cD, lam, P, Q, tw, soft, ch))
    uncertain = torch.nonzero(unc)[:, 0]
    if len(uncertain):
        o, c = smooth_search_plain(port[uncertain], wavelet, nlevel, facts,
                                   tol, threshtype)
        out[uncertain] = o
        choice[uncertain] = c
    return out, choice, uncertain


def smooth_search_plain(port, wavelet, nlevel, facts, rchi2_tol,
                        threshtype="hard", out=None, choice=None):
    """Plain PyTorch K8 (see smooth_search): the choice by the route's
    stages in torch; each chosen row's smooth made as the reference makes
    its candidates, ops.wavelet.wavelet_smooth at the chosen level over
    every row and factor (one call per level chosen), so that it checks
    the kernels' candidate spectra against swt / iswt."""
    tables, out, choice = _smooth_args(port, wavelet, nlevel, facts,
                                       threshtype, out, choice)
    out.zero_()
    if not port.shape[0]:
        return out, choice
    _route(port, tables, facts, rchi2_tol, threshtype == "soft", out,
           choice, card=False)
    return _plain_smooths(port, wavelet, threshtype, facts, choice,
                          out), choice


def smooth_search(port, wavelet, nlevel, facts, rchi2_tol, threshtype="hard",
                  out=None, choice=None):
    """K8 wrapper (see csrc/wavelet.cu): smart_smooth's search over the
    rows of port [rows, nbin] float64 (nbin even) with ``wavelet`` ('dbN'
    or the lowpass filter's taps), ``nlevel`` levels and the threshold
    factors facts [nfact] float64, the kernels reading the tables of
    ops.wavelet.search_tables: each row's best candidate (zeros where none
    passes chi2 - 1 <= rchi2_tol) into out [rows, nbin] and its (level,
    factor index) into choice [rows, 2] int64 ((0, -1) where zeroed).

    On the card: the scan and its certification over chunks of
    scan_chunk_rows for widths the scan takes (``scannable``), then the
    route over the uncertain rows, gathered, in chunks of
    smooth_chunk_rows rows (over every row for other widths); one host
    sync a call, for the uncertain rows' count (so a call with uncertain
    rows is not captured in a CUDA graph).  LAUNCHES counts each chunk
    decided (one pp_wavelet_certify or pp_wavelet_select); SMOOTH_ROWS the
    rows by tier.  On the CPU: smooth_search_plain.  Returns (out,
    choice)."""
    if port.device.type == "cpu":
        return smooth_search_plain(port, wavelet, nlevel, facts, rchi2_tol,
                                   threshtype, out, choice)
    _check(port, "port", torch.float64, 2)
    _check_card(port, "smooth_search")
    out, choice, uncertain = _smooth_tiers(port, wavelet, nlevel, facts,
                                           rchi2_tol, threshtype, out,
                                           choice, card=True)
    with _STATE_LOCK:
        if uncertain is None:
            SMOOTH_ROWS["unscanned"] += port.shape[0]
        else:
            SMOOTH_ROWS["scanned"] += port.shape[0]
            SMOOTH_ROWS["redecided"] += len(uncertain)
    return out, choice


# -- K9: the Gaussian portrait fit's normal equations -------------------------

# csrc/gauss.cu's kWarpNgauss (the warp layout up to this many components,
# the FP64 tensor cores beyond), kMaxNgauss and kSseMaxNgauss (the most
# components each epilogue takes on the card, held to the shared memory a
# block takes there by the source's static_asserts; the wrappers raise
# beyond, and fit.gauss keeps jacfwd there).  The launches' geometry is the
# source's alone (gauss_sizes).
GAUSS_WARP_NGAUSS = 2
GAUSS_MAX_NGAUSS = 1888
GAUSS_SSE_MAX_NGAUSS = 6456


def gauss_ngauss(nparam):
    """The components of a Gaussian portrait fit's parameter vector of
    ``nparam`` = 2 + 6 ngauss + 1 entries (dc, tau, six per component,
    the scattering index); raises ValueError for any other length."""
    ngauss, rest = divmod(int(nparam) - 3, 6)
    if ngauss < 1 or rest:
        raise ValueError("a Gaussian portrait's parameters are 2 + 6 ngauss "
                         "+ 1 (ngauss >= 1), got %d" % nparam)
    return ngauss


def gauss_layout(ngauss):
    """The layout gauss_normal takes on the card at ``ngauss`` components:
    "warp" (the Gram's 15 or 36 entries in registers) up to
    GAUSS_WARP_NGAUSS, else "mma" (the FP64 tensor cores)."""
    return "warp" if ngauss <= GAUSS_WARP_NGAUSS else "mma"


GAUSS_SIZES = ("width", "rows", "counters", "chans_per_block", "fan", "smem")


def gauss_sizes(ngauss, nchan, normal=True):
    """csrc/gauss.cu's geometry of a launch of epilogue B (``normal``) or A
    at ``ngauss`` components and ``nchan`` channels, as its pp_gauss_sizes
    gives it: {GAUSS_SIZES key: int}: the doubles in a row of per-lane
    sums, a lane's scratch rows and tree counters, the channels a block,
    the channel tree's fan-in and the shared memory a block takes.  Builds
    the kernel (nvcc); raises ValueError past the epilogue's component
    limit."""
    name = "gauss_normal" if normal else "gauss_sse"
    if name not in _LIBS:
        build([name])
    out = (ctypes.c_int64 * len(GAUSS_SIZES))()
    if _LIBS[name]["pp_gauss_sizes"](int(ngauss), int(nchan), int(normal),
                                     out):
        raise ValueError("%s: no launch of %d components over %d channels"
                         % (name, ngauss, nchan))
    return dict(zip(GAUSS_SIZES, out))


class _GaussBuffers:
    """A launch's scratch rows and its tree's counters (zero: every launch
    leaves them zero), sized by gauss_sizes; with ``outs``,
    gauss_normal's outputs, kept."""

    def __init__(self, B, nchan, ngauss, normal, device, outs=False):
        sz = gauss_sizes(ngauss, nchan, normal)
        self.scratch = torch.empty((B, sz["rows"], sz["width"]),
                                   dtype=torch.float64, device=device)
        self.counters = torch.zeros((B, sz["counters"]), dtype=torch.int32,
                                    device=device)
        P = 6 * ngauss + 3
        self.outs = None if not outs else (
            torch.empty(B, dtype=torch.float64, device=device),
            torch.empty((B, P), dtype=torch.float64, device=device),
            torch.empty((B, P, P), dtype=torch.float64, device=device))


class GaussWork:
    """K9's arguments that stay fixed over a fit (data, errs, bins, freqs,
    nu_ref, model_code), checked once, and the buffers its launches reuse
    per (lanes, components, epilogue): the scratch rows, the channel
    tree's counters and gauss_normal's outputs.  Pass it as ``work=`` to
    gauss_normal / gauss_sse with those same arguments (or tensors of the
    same shapes, strides, dtype and device): the call then checks only
    ``params``.  gauss_normal's outputs are then overwritten by its next
    call with the same work; one work serves one stream at a time."""

    def __init__(self, data, errs, bins, freqs, nu_ref, model_code):
        _check_gauss_fixed(data, errs, bins, freqs, "gauss work")
        self.laws = _gauss_laws(model_code)
        self.device = data.device
        self._layout = (_layout(data), _layout(errs), tuple(bins.shape),
                        tuple(freqs.shape))
        self._bufs = {}

    def check(self, params, data, errs, bins, freqs, model_code):
        """(B, P, ngauss, laws) of a call with this work; raises where its
        fixed arguments are not laid out as the work's or its model code
        is not the work's."""
        _check(params, "params", torch.float64, 2)
        if params.device != self.device or self._layout != (
                _layout(data), _layout(errs), tuple(bins.shape),
                tuple(freqs.shape)):
            raise ValueError("gauss work: the arguments are not laid out as "
                             "the work's (%s)" % (self._layout,))
        if _gauss_laws(model_code) != self.laws:
            raise ValueError("gauss work: model_code %r is not the work's "
                             "(laws %s)" % (model_code, self.laws))
        B, P = params.shape
        return B, P, gauss_ngauss(P), self.laws

    def buffers(self, B, ngauss, normal):
        key = (B, ngauss, normal)
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = self._bufs[key] = _GaussBuffers(
                B, self._layout[0][0][0], ngauss, normal, self.device,
                outs=normal)
        return bufs


def _layout(t):
    return (tuple(t.shape), t.stride(), t.dtype, t.device)


def _gauss_laws(model_code):
    """The three model-code digits (loc, wid, amp) as 0 (power law) or 1
    (linear)."""
    code = str(model_code)
    if len(code) != 3 or set(code) - set("01"):
        raise ValueError("model_code must be three digits of 0 (power law) "
                         "or 1 (linear), got %r" % (model_code,))
    return tuple(int(c) for c in code)


def _check_gauss_fixed(data, errs, bins, freqs, what):
    """Check K9's arguments other than params (see gauss_sse)."""
    _check(data, "data", torch.float64, 2)
    if isinstance(errs, torch.Tensor) and errs.ndim == 2 and \
            errs.stride(1) == 0:
        # per-channel errors broadcast over the bins, read through their
        # row stride (a value a channel): dtype and rank to check
        _check(errs[:1, :1], "errs", torch.float64, 2)
    else:
        _check(errs, "errs", torch.float64, 2)
    _check(bins, "bins", torch.float64, 1)
    _check(freqs, "freqs", torch.float64, 1)
    nchan, nbin = data.shape
    if tuple(errs.shape) != (nchan, nbin) or bins.shape[0] != nbin or \
            freqs.shape[0] != nchan:
        raise ValueError("%s: shapes data %s, errs %s, bins %s, freqs %s "
                         "disagree" % (what, tuple(data.shape),
                                       tuple(errs.shape), tuple(bins.shape),
                                       tuple(freqs.shape)))
    _same_device(data, errs, bins, freqs)


def _check_gauss(params, data, errs, bins, freqs, model_code, what):
    """Check K9's arguments; returns (B, P, ngauss, laws)."""
    _check(params, "params", torch.float64, 2)
    _check_gauss_fixed(data, errs, bins, freqs, what)
    _same_device(params, data)
    B, P = params.shape
    return B, P, gauss_ngauss(P), _gauss_laws(model_code)


def _evolve_plain(p0, slope, logf, dfreq, law):
    """One evolution law at every channel: (value, d value / d p0,
    d value / d slope, cross) [B, nchan, ngauss] of p0 and slope [B,
    ngauss]: the power law exp(logf slope + log p0) (law 0) or the linear
    law dfreq slope + p0 (law 1), the derivatives in the order
    forward-mode takes them (log's tangent 1 / p0, then exp's).  ``cross``
    is the value's tangent along any other parameter: value (0 / p0) for
    the power law, 0 unless p0 = 0 (then NaN, which forward-mode carries
    into every column of the Jacobian), and 0 for the linear law."""
    if law == 0:
        val = torch.exp(logf[None, :, None] * slope[:, None, :]
                        + torch.log(p0)[:, None, :])
        return (val, (1.0 / p0)[:, None, :] * val, logf[None, :, None] * val,
                (0.0 / p0)[:, None, :] * val)
    val = dfreq[None, :, None] * slope[:, None, :] + p0[:, None, :]
    return (val, torch.ones_like(val), dfreq[None, :, None].expand_as(val),
            torch.zeros_like(val))


def _gauss_components_plain(params, bins, freqs, nu_ref, laws, ng):
    """The ``ng`` components of a Gaussian portrait at every channel and
    bin (ops.profiles.gen_gaussian_portrait's arithmetic), for K9's and
    K10's plain versions: the evolution laws' values, derivatives and
    cross tangents (_evolve_plain, [B, nchan, ng] each: ``loc``, ``wid``,
    ``amp``), ``live`` (wid > 0) [B, nchan, ng, 1], sigma, the clipped z
    and unclipped ``zr`` and e [B, nchan, ng, nbin], and G = dc + sum amp
    e [B, nchan, nbin]."""
    B = params.shape[0]
    nu = torch.as_tensor(nu_ref, dtype=torch.float64, device=freqs.device)
    logf = torch.log(freqs) - torch.log(nu)
    dfreq = freqs - nu_ref
    comps = params[:, 2:2 + 6 * ng].reshape(B, ng, 6)
    loc, wid, amp = (_evolve_plain(comps[..., 2 * k], comps[..., 2 * k + 1],
                                   logf, dfreq, laws[k]) for k in range(3))
    mean = torch.remainder(loc[0], 1.0)
    x = bins - mean[..., None]                      # [B, nchan, ng, nbin]
    x = torch.where(x > 0.5, x - 1.0, x)
    x = torch.where(x < -0.5, x + 1.0, x)
    live = (wid[0] > 0.0)[..., None]
    sigma = torch.where(live, (wid[0] / FWHM_FACT)[..., None],
                        torch.ones_like(x[..., :1]))
    zr = x / sigma
    z = torch.clamp(zr, -20.0, 20.0)
    e = torch.where(live, torch.exp(-0.5 * (z * z)), torch.zeros_like(z))
    G = params[:, 0, None, None] + torch.sum(amp[0][..., None] * e, dim=2)
    return dict(loc=loc, wid=wid, amp=amp, live=live, sigma=sigma, zr=zr,
                z=z, e=e, G=G)


def _gauss_basis_plain(c):
    """d model / d (loc, wid) of each evolved component [B, nchan, ng,
    nbin], from _gauss_components_plain's ``c``: 0 where the clip holds z,
    and where wid <= 0 whatever the chain factor (the reference's where
    selects a zero there)."""
    e, z, sigma, live = c["e"], c["z"], c["sigma"], c["live"]
    zero = torch.zeros_like(e)
    inner = torch.abs(c["zr"]) < 20.0
    ae = c["amp"][0][..., None] * e
    b_loc = torch.where(inner, ae * z / sigma, zero)
    b_wid = torch.where(inner, ae * z * z / torch.where(
        live, c["wid"][0][..., None], torch.ones_like(sigma)), zero)
    return b_loc, b_wid


def _gauss_terms_plain(params, data, errs, bins, freqs, nu_ref, laws,
                       columns):
    """The unscattered Gaussian portrait's residual r [B, nchan, nbin]
    (the arithmetic of ops.profiles.gen_gaussian_portrait at tau = 0)
    and, with ``columns``, its Jacobian J [B, nchan, nbin, P] from the
    analytic derivatives (None without)."""
    B, P = params.shape
    ng = gauss_ngauss(P)
    c = _gauss_components_plain(params, bins, freqs, nu_ref, laws, ng)
    r = (data - c["G"]) / errs
    if not columns:
        return r, None
    (_, dl0, dl1, xl), (_, dw0, dw1, xw), (_, da0, da1, xa) = \
        c["loc"], c["wid"], c["amp"]
    e, live = c["e"], c["live"]
    zero = torch.zeros_like(e)
    b_loc, b_wid = _gauss_basis_plain(c)
    cols = [torch.where(live, a[..., None] * b, zero)
            for a, b in ((dl0, b_loc), (dl1, b_loc), (dw0, b_wid),
                         (dw1, b_wid))]
    cols += [da0[..., None] * e, da1[..., None] * e]
    nchan, nbin = data.shape
    comp_cols = torch.stack(cols, dim=3).reshape(B, nchan, 6 * ng, nbin)
    one = torch.ones((B, nchan, nbin, 1), dtype=torch.float64,
                     device=params.device)
    dm = torch.cat([one, torch.zeros_like(one),
                    comp_cols.transpose(-1, -2), torch.zeros_like(one)],
                   dim=-1)
    # the evolved values' tangents along every parameter (0, or NaN from a
    # power law's p0 = 0: through amp always, through loc and wid where
    # the component is live), added to every column as forward-mode does
    cross = xa[..., None] * e + torch.where(
        live, xl[..., None] * b_loc + xw[..., None] * b_wid, zero)
    dm = dm + torch.sum(cross, dim=2)[..., None]
    return r, -dm / errs[..., None]


def gauss_sse_plain(params, data, errs, bins, freqs, nu_ref, model_code,
                    work=None):
    """Plain PyTorch K9, epilogue A: f [B] = sum r^2 of the unscattered
    Gaussian portrait's residual (see gauss_normal_plain; ``work`` is the
    kernel's and unused here)."""
    r, _ = _gauss_terms_plain(params, data, errs, bins, freqs, nu_ref,
                              _gauss_laws(model_code), False)
    return torch.sum(r * r, dim=(-2, -1))


def gauss_normal_plain(params, data, errs, bins, freqs, nu_ref, model_code,
                       work=None):
    """Plain PyTorch K9, epilogue B: (f [B], g [B, P], JtJ [B, P, P]) of
    the residual r = (data - m) / errs of the unscattered Gaussian
    portrait m at params [B, P] (see gauss_normal): its Jacobian's
    columns from the analytic derivatives, then f = sum r^2, g = J^T r
    and J^T J by einsum, as the JAX reference's lm_solve forms them
    (``work`` is the kernel's and unused here)."""
    r, J = _gauss_terms_plain(params, data, errs, bins, freqs, nu_ref,
                              _gauss_laws(model_code), True)
    B, P = params.shape
    r, J = r.reshape(B, -1), J.reshape(B, -1, P)
    return (torch.sum(r * r, dim=-1), torch.einsum("bnp,bn->bp", J, r),
            torch.einsum("bnp,bnq->bpq", J, J))


def _gauss_launch(name, params, data, errs, bins, freqs, nu_ref, laws,
                  bufs, *outs):
    B, P = params.shape
    nchan, nbin = data.shape
    if B > 65535:
        raise ValueError("%s: %d lanes; a launch takes at most 65535"
                         % (name, B))
    per_bin = int(errs.stride(1) != 0)
    _launch(name, params.device, params.data_ptr(), data.data_ptr(),
            errs.data_ptr(), errs.stride(0), per_bin, bins.data_ptr(),
            freqs.data_ptr(), B, gauss_ngauss(P), nchan, nbin,
            float(nu_ref), FWHM_FACT, *laws, bufs.scratch.data_ptr(),
            bufs.counters.data_ptr(),
            *(o.data_ptr() for o in outs))


def gauss_sse(params, data, errs, bins, freqs, nu_ref, model_code,
              work=None):
    """K9 wrapper, epilogue A (see csrc/gauss.cu): f [B] = sum over the
    portrait of r^2, r = (data - m) / errs, m the unscattered Gaussian
    portrait (gen_gaussian_portrait at tau = 0) at each lane's params
    [B, 2 + 6 ngauss + 1] float64 (dc, tau, (loc, dloc, wid, dwid, amp,
    damp) per component, the scattering index), model_code's three
    digits (loc, wid, amp; 0 power law, 1 linear about nu_ref), data and
    errs [nchan, nbin], the bin centres bins [nbin] and freqs [nchan],
    all float64 and contiguous, except that errs may be per-channel
    errors broadcast over the bins (stride 0 along them; read as nchan
    values).  One launch.  ``work`` (a GaussWork of the same fixed
    arguments) skips their checks and keeps the launch's scratch.  More
    than GAUSS_SSE_MAX_NGAUSS components raise ValueError on the card."""
    if work is None:
        B, P, ng, laws = _check_gauss(params, data, errs, bins, freqs,
                                      model_code, "gauss_sse")
    else:
        B, P, ng, laws = work.check(params, data, errs, bins, freqs,
                                    model_code)
    if params.device.type == "cpu":
        return gauss_sse_plain(params, data, errs, bins, freqs, nu_ref,
                               model_code)
    if params.device.type != "cuda":
        raise ValueError("gauss_sse: unsupported device %s" % params.device)
    if ng > GAUSS_SSE_MAX_NGAUSS:
        raise ValueError("gauss_sse: %d components; the kernel takes at most "
                         "%d" % (ng, GAUSS_SSE_MAX_NGAUSS))
    if not (B and data.numel()):
        return torch.zeros(B, dtype=torch.float64, device=params.device)
    bufs = work.buffers(B, ng, False) if work is not None else \
        _GaussBuffers(B, data.shape[0], ng, False, params.device)
    f = torch.empty(B, dtype=torch.float64, device=params.device)
    _gauss_launch("gauss_sse", params, data, errs, bins, freqs, nu_ref, laws,
                  bufs, f)
    return f


def gauss_normal(params, data, errs, bins, freqs, nu_ref, model_code,
                 work=None):
    """K9 wrapper, epilogue B (see csrc/gauss.cu): (f [B], g [B, P], JtJ
    [B, P, P]) float64 for the residual of gauss_sse's arguments and its
    Jacobian J = d r / d params: f = sum r^2, g = J^T r, JtJ = J^T J,
    with no J formed.  The tau and scattering-index columns of J are 0
    (the unscattered model does not depend on them).  One launch: the
    warp layout up to GAUSS_WARP_NGAUSS components, the FP64 tensor cores
    beyond (gauss_layout); more than GAUSS_MAX_NGAUSS components raise
    ValueError on the card (the mma layout's shared memory).  With
    ``work`` (a GaussWork of the same fixed arguments) the fixed arguments
    are not checked again and the outputs are the work's own, overwritten
    by its next gauss_normal call."""
    if work is None:
        B, P, ng, laws = _check_gauss(params, data, errs, bins, freqs,
                                      model_code, "gauss_normal")
    else:
        B, P, ng, laws = work.check(params, data, errs, bins, freqs,
                                    model_code)
    if params.device.type == "cpu":
        return gauss_normal_plain(params, data, errs, bins, freqs, nu_ref,
                                  model_code)
    if params.device.type != "cuda":
        raise ValueError("gauss_normal: unsupported device %s"
                         % params.device)
    if ng > GAUSS_MAX_NGAUSS:
        raise ValueError("gauss_normal: %d components; the kernel takes at "
                         "most %d (the mma layout's shared memory)"
                         % (ng, GAUSS_MAX_NGAUSS))
    dev = params.device
    if not (B and data.numel()):
        return (torch.zeros(B, dtype=torch.float64, device=dev),
                torch.zeros((B, P), dtype=torch.float64, device=dev),
                torch.zeros((B, P, P), dtype=torch.float64, device=dev))
    if work is not None:
        bufs = work.buffers(B, ng, True)
    else:
        bufs = _GaussBuffers(B, data.shape[0], ng, True, dev, outs=True)
    _gauss_launch("gauss_normal", params, data, errs, bins, freqs, nu_ref,
                  laws, bufs, *bufs.outs)
    return bufs.outs


# -- K10: the scattered and joined Gaussian portrait fit's normal equations ---

# csrc/gauss_ft.cu's kMaxNgauss (the Gram's shared memory, as K9's), kMinBins
# and kMaxBins (its transforms take powers of two in that range, in a
# block's shared memory); the wrappers raise beyond, and fit.gauss keeps
# jacfwd there.  The launches' geometry is the source's alone
# (gauss_ft_sizes); gauss_ft_path mirrors its path rule with the source's
# kMaxCluster and kMaxBatches and gauss_common.cuh's kSmemMax and
# kRowBudget.
GAUSS_FT_MAX_NGAUSS = 1888
GAUSS_FT_MIN_BINS = 64
GAUSS_FT_MAX_BINS = 8192
GAUSS_FT_MAX_CLUSTER = 2
GAUSS_FT_MAX_BATCHES = 3
GAUSS_FT_SMEM_MAX = 232448
GAUSS_FT_ROW_BUDGET = 1 << 28
GAUSS_FT_SIZES = ("width", "rows", "counters", "chans_per_block", "fan",
                  "staged", "smem_rows", "smem_gram", "smem_sse", "cluster",
                  "batch", "smem_onchip")
# gauss_ft_normal's calls on the card by path: "onchip", one launch (a
# cluster of blocks a (channel, lane), the rows in shared memory), or
# "staged", two (the rows through device memory); gauss_ft_path says which
GAUSS_FT_PATHS = {"onchip": 0, "staged": 0}


def gauss_ft_ngauss(nparam, njoin):
    """The components of a Gaussian portrait fit's parameter vector of
    ``nparam`` = 2 + 6 ngauss + 1 + 2 njoin entries (dc, tau, six per
    component, the scattering index, a (phase, DM) pair per join group);
    raises ValueError for any other length."""
    return gauss_ngauss(int(nparam) - 2 * int(njoin))


def gauss_ft_takes_bins(nbin):
    """Whether K10's transforms take ``nbin`` bins on the card: a power of
    two from GAUSS_FT_MIN_BINS to GAUSS_FT_MAX_BINS."""
    nbin = int(nbin)
    return GAUSS_FT_MIN_BINS <= nbin <= GAUSS_FT_MAX_BINS and \
        nbin & (nbin - 1) == 0


def gauss_ft_sizes(ngauss, njoin, nchan, nbin, normal=True):
    """csrc/gauss_ft.cu's geometry of a launch of epilogue B (``normal``) or
    A, as its pp_gauss_ft_sizes gives it: {GAUSS_FT_SIZES key: int}: the
    doubles in a row of per-lane sums, a lane's scratch rows and tree
    counters, the channels a Gram block, the tree's fan-in, the staged
    packed rows a (lane, channel) (0 on the on-chip path), the shared
    memory of the rows, Gram and sse kernels, and epilogue B's on-chip
    launch: its cluster size (0: the staged path), rows a transform batch
    and shared memory.  Builds the kernel (nvcc); raises ValueError for a
    problem the kernel does not take."""
    name = "gauss_ft_normal" if normal else "gauss_ft_sse"
    if name not in _LIBS:
        build([name])
    out = (ctypes.c_int64 * len(GAUSS_FT_SIZES))()
    if _LIBS[name]["pp_gauss_ft_sizes"](int(ngauss), int(njoin), int(nchan),
                                        int(nbin), int(normal), out):
        raise ValueError("%s: no launch of %d components, %d join groups "
                         "over [%d, %d]" % (name, ngauss, njoin, nchan, nbin))
    return dict(zip(GAUSS_FT_SIZES, out))


def _gauss_ft_onchip_smem(ngauss, nbin, cs, T):
    """csrc/gauss_ft.cu's onchip_smem: the on-chip kernel's shared memory
    in bytes at cluster size cs and T rows a transform batch."""
    nt = (3 * ngauss + 4 + 15) // 16
    pairs = nt * (nt + 1) // 2
    splits = 1 if pairs >= 8 else 8 // pairs
    stride = (nbin // cs + 15) // 16 * 16 + 4
    return 8 * (max(2 * T * nbin, splits * pairs * 256)
                + (3 * ngauss + 3) * stride + 6 + 10 * ngauss) + 4 * ngauss


def gauss_ft_path(ngauss, njoin, nchan, nbin):
    """gauss_ft_normal's path on the card, as csrc/gauss_ft.cu's rule
    (onchip) chooses it: {"cluster": blocks a (channel, lane), "batch":
    rows a block transforms at once}, or cluster 0 for the staged path.
    The rule: the smallest of the cluster sizes 1 .. GAUSS_FT_MAX_CLUSTER
    (at most nbin / 8) at which a block's shared memory (a slice of every
    stored row, a transform batch's buffers, the Gram's partial sums) fits
    GAUSS_FT_SMEM_MAX with at most GAUSS_FT_MAX_BATCHES transform batches
    a block, with the fewest batches there; the staged path where none
    fits, or where a lane's rows of sums exceed GAUSS_FT_ROW_BUDGET (the
    Gram's blocks then group channels).  Pure Python: gauss_ft_sizes
    reports the source's own choice."""
    ng, nbin = int(ngauss), int(nbin)
    P = 6 * ng + 3 + 2 * int(njoin)
    width = P * (P + 1) // 2 + P + 2
    if int(nchan) * 8 * width <= GAUSS_FT_ROW_BUDGET:
        cs = 1
        while cs <= GAUSS_FT_MAX_CLUSTER and cs <= nbin // 8:
            tb = -(-3 * ng // cs)
            for nb in range(1, min(tb, GAUSS_FT_MAX_BATCHES) + 1):
                T = -(-tb // nb)
                if _gauss_ft_onchip_smem(ng, nbin, cs, T) <= \
                        GAUSS_FT_SMEM_MAX:
                    return {"cluster": cs, "batch": T}
            cs *= 2
    return {"cluster": 0, "batch": 0}


def gauss_ft_active_clusters(ngauss, njoin, nchan, nbin):
    """The clusters of gauss_ft_normal's on-chip launch the current CUDA
    device holds at once (cudaOccupancyMaxActiveClusters); 0 on the
    staged path.  Builds the kernel (nvcc)."""
    if "gauss_ft_normal" not in _LIBS:
        build(["gauss_ft_normal"])
    out = ctypes.c_int(0)
    err = _LIBS["gauss_ft_normal"]["pp_gauss_ft_clusters"](
        int(ngauss), int(njoin), int(nchan), int(nbin), ctypes.byref(out))
    if err:
        raise KernelLaunchError("gauss_ft_normal", err)
    return out.value


def _packing_weights(nbin, dtype, device):
    """The half-complex packing's weights of harmonics 0 .. nbin // 2: 1 at
    harmonic 0 and (even nbin) nbin / 2, sqrt 2 between, all over sqrt
    nbin."""
    K = nbin // 2 + 1
    w = torch.full((K,), math.sqrt(2.0 / nbin), dtype=dtype, device=device)
    w[0] = math.sqrt(1.0 / nbin)
    if nbin % 2 == 0:
        w[-1] = math.sqrt(1.0 / nbin)
    return w


def pack_spectrum(X, nbin):
    """An rFFT X [..., nbin // 2 + 1] packed half-complex into nbin reals:
    Re X_k w_k for every k, then Im X_k w_k for 0 < k < nbin / 2 (the
    _packing_weights), so that the dot product of two packed rows is that
    of the real rows they transform (Parseval; the imaginary parts at
    harmonic 0 and nbin / 2 are those irfft drops)."""
    K = nbin // 2 + 1
    w = _packing_weights(nbin, X.real.dtype, X.device)
    top = K - 1 if nbin % 2 == 0 else K
    return torch.cat([X.real * w, (X.imag * w)[..., 1:top]], dim=-1)


def _proj(X, nbin):
    """X [..., nbin // 2 + 1] with the imaginary parts irfft drops (harmonic
    0 and, for an even nbin, nbin / 2) set to 0."""
    keep = torch.ones(X.shape[-1], dtype=X.real.dtype, device=X.device)
    keep[0] = 0.0
    if nbin % 2 == 0:
        keep[-1] = 0.0
    return torch.complex(X.real, X.imag * keep)


def _gauss_ft_terms_plain(params, data, errs, bins, freqs, nu_ref, laws,
                          groups, njoin, period, columns):
    """The scattered and joined Gaussian portrait's packed residual r [B,
    nchan, nbin] (the spectrum of (data - m) / errs, m the arithmetic of
    ops.profiles.gen_gaussian_portrait with its join groups, packed by
    pack_spectrum) and, with ``columns``, the packed columns of its
    Jacobian [B, nchan, P, nbin] from the columns' spectra (see
    csrc/gauss_ft.cu), with each lane's poison [B] (NaN where forward-mode's
    tangent of an evolved value is NaN at some channel, else 0)."""
    B, P = params.shape
    ng = gauss_ft_ngauss(P, njoin)
    nchan, nbin = data.shape
    K = nbin // 2 + 1
    dev = params.device
    c = _gauss_components_plain(params, bins, freqs, nu_ref, laws, ng)
    Gh = torch.fft.rfft(c["G"])                     # [B, nchan, K]

    # the scattering factor where tau != 0 (1 elsewhere) and its tau
    # derivative, as ops.scattering's scattering_times and
    # scattering_portrait_FT form them
    k = torch.arange(K, dtype=torch.float64, device=dev)
    twopik = 2.0 * math.pi * k
    tau, alpha = params[:, 1], params[:, 2 + 6 * ng]
    scat = (tau != 0.0)[:, None]
    ratio = freqs / nu_ref
    pw = ratio[None, :] ** alpha[:, None]           # [B, nchan]
    taus = (tau / nbin)[:, None] * pw
    xk = twopik * taus[..., None]
    den = 1.0 + xk * xk
    S = torch.where(scat[..., None], torch.complex(1.0 / den, -xk / den),
                    torch.ones_like(den).to(torch.complex128))
    # the join groups' rotation, as ops.fourier.rotate_data forms it
    grp = groups.to(device=dev, dtype=torch.long)
    injoin = grp >= 0
    g0 = grp.clamp(min=0)
    jpar = params[:, 3 + 6 * ng:].reshape(B, -1, 2) if njoin else \
        torch.zeros((B, 1, 2), dtype=torch.float64, device=dev)
    phi, DM = jpar[:, g0, 0], jpar[:, g0, 1]        # [B, nchan]
    fterm = freqs ** -2 - nu_ref ** -2
    shift = phi + (Dconst * DM / period) * fterm
    R = torch.where(injoin[None, :, None], phasor(shift, K),
                    torch.ones_like(S))
    Y = _proj(S * Gh, nbin)
    M = _proj(R * Y, nbin)
    ie = 1.0 / errs[:, 0]                           # a value a channel
    Dh = torch.fft.rfft(data)
    r = pack_spectrum(Dh - M, nbin) * ie[:, None]
    if not columns:
        return r, None, None

    # the component basis rows (gauss.cu's), their spectra through S and R
    (_, dl0, dl1, xl), (_, dw0, dw1, xw), (_, da0, da1, xa) = \
        c["loc"], c["wid"], c["amp"]
    live = c["live"]
    rows = torch.stack([c["e"], *_gauss_basis_plain(c)], dim=3)
    Bh = torch.fft.rfft(rows)
    Zb = _proj(R[:, :, None, None] * _proj(S[:, :, None, None] * Bh, nbin),
               nbin)
    dS = -1j * twopik * S * S
    T = _proj(R * _proj(dS * Gh, nbin), nbin)
    Jn = _proj(1j * twopik * R * Y, nbin)
    c0 = torch.zeros_like(S)

    def on(a, row):
        return a[..., None] * row

    cols = [torch.zeros_like(S)]                    # dc: packed below
    cols.append(on(torch.where(scat, pw / nbin, 0.0), T))
    for c in range(ng):
        lv = live[:, :, c, 0]
        cols += [on(torch.where(lv, dl0[..., c], 0.0), Zb[:, :, c, 1]),
                 on(torch.where(lv, dl1[..., c], 0.0), Zb[:, :, c, 1]),
                 on(torch.where(lv, dw0[..., c], 0.0), Zb[:, :, c, 2]),
                 on(torch.where(lv, dw1[..., c], 0.0), Zb[:, :, c, 2]),
                 on(da0[..., c], Zb[:, :, c, 0]),
                 on(da1[..., c], Zb[:, :, c, 0])]
    cols.append(on(torch.where(scat, taus * torch.log(ratio), 0.0), T))
    disp = Dconst / period * fterm
    for j in range(njoin):
        mine = (grp == j)[None, :, None]
        cols += [torch.where(mine, Jn, c0),
                 torch.where(mine, disp[None, :, None] * Jn, c0)]
    J = pack_spectrum(torch.stack(cols, dim=2), nbin)   # [B, nchan, P, nbin]
    J[:, :, 0, 0] = math.sqrt(nbin)                 # N delta_k0, packed
    J = -J * ie[:, None, None]
    # a power law's p0 = 0 (see _evolve_plain): NaN through amp always,
    # through loc and wid where the component is live
    bad = torch.isnan(xa) | (live[..., 0] & (torch.isnan(xl)
                                             | torch.isnan(xw)))
    poison = torch.where(torch.any(bad.reshape(B, -1), dim=-1),
                         float("nan"), 0.0)
    return r, J, poison


def gauss_ft_sse_plain(params, data, errs, bins, freqs, nu_ref, model_code,
                       groups, njoin, period, work=None):
    """Plain PyTorch K10, epilogue A: f [B] = sum r^2 of the scattered and
    joined Gaussian portrait's residual (see gauss_ft_normal_plain;
    ``work`` is the kernel's and unused here)."""
    r, _, _ = _gauss_ft_terms_plain(params, data, errs, bins, freqs, nu_ref,
                                    _gauss_laws(model_code), groups, njoin,
                                    period, False)
    return torch.sum(r * r, dim=(-2, -1))


def gauss_ft_normal_plain(params, data, errs, bins, freqs, nu_ref,
                          model_code, groups, njoin, period, work=None):
    """Plain PyTorch K10, epilogue B: (f [B], g [B, P], JtJ [B, P, P]) of
    the residual r = (data - m) / errs of the Gaussian portrait m of
    ops.profiles.gen_gaussian_portrait, scattered where tau != 0 and
    rotated in each join group (see gauss_ft_normal), and its Jacobian:
    the columns' spectra from the basis rows' rFFTs and the scattering and
    join factors, packed half-complex (pack_spectrum), then f = sum r^2,
    g = J^T r and J^T J by einsum (``work`` is the kernel's and unused
    here)."""
    r, J, poison = _gauss_ft_terms_plain(
        params, data, errs, bins, freqs, nu_ref, _gauss_laws(model_code),
        groups, njoin, period, True)
    p = poison[:, None]
    return (torch.sum(r * r, dim=(-2, -1)),
            torch.einsum("bcpn,bcn->bp", J, r) + p,
            torch.einsum("bcpn,bcqn->bpq", J, J) + p[..., None])


def _check_gauss_ft_fixed(data, errs, bins, freqs, groups, njoin, what):
    """Check K10's arguments other than params (see gauss_ft_sse)."""
    _check_gauss_fixed(data, errs, bins, freqs, what)
    if errs.stride(1) != 0:
        raise ValueError("%s: errs must be a value a channel, broadcast over "
                         "the bins (stride 0 along them)" % what)
    _check(groups, "groups", torch.int32, 1)
    if groups.shape[0] != data.shape[0]:
        raise ValueError("%s: groups %s for %d channels"
                         % (what, tuple(groups.shape), data.shape[0]))
    _same_device(data, groups)
    njoin = int(njoin)
    if njoin < 0 or bool(((groups < -1) | (groups >= njoin)).any()):
        raise ValueError("%s: each channel's group must be -1 or one of the "
                         "%d join groups" % (what, njoin))


def _check_gauss_ft(params, data, errs, bins, freqs, model_code, groups,
                    njoin, what):
    """Check K10's arguments; returns (B, P, ngauss, laws)."""
    _check(params, "params", torch.float64, 2)
    _check_gauss_ft_fixed(data, errs, bins, freqs, groups, njoin, what)
    _same_device(params, data)
    B, P = params.shape
    return B, P, gauss_ft_ngauss(P, njoin), _gauss_laws(model_code)


class _GaussFtBuffers:
    """A launch's staged rows (epilogue B on the staged path), scratch rows
    and tree counters (zero: every launch leaves them zero), sized by
    gauss_ft_sizes, and its path; with ``outs``, gauss_ft_normal's
    outputs, kept."""

    def __init__(self, B, nchan, nbin, ngauss, njoin, normal, device,
                 outs=False):
        sz = gauss_ft_sizes(ngauss, njoin, nchan, nbin, normal)
        self.path = "onchip" if sz["cluster"] else "staged"
        self.staged = torch.empty((B, nchan, sz["staged"], nbin),
                                  dtype=torch.float64, device=device) \
            if sz["staged"] else None
        self.scratch = torch.empty((B, sz["rows"], sz["width"]),
                                   dtype=torch.float64, device=device)
        self.counters = torch.zeros((B, sz["counters"]), dtype=torch.int32,
                                    device=device)
        P = 6 * ngauss + 3 + 2 * njoin
        self.outs = None if not outs else (
            torch.empty(B, dtype=torch.float64, device=device),
            torch.empty((B, P), dtype=torch.float64, device=device),
            torch.empty((B, P, P), dtype=torch.float64, device=device))


def _data_spectrum(data):
    """The data's rFFT, packed (pack_spectrum): K10's residual row is this
    minus the model's."""
    return pack_spectrum(torch.fft.rfft(data), data.shape[-1]).contiguous()


class GaussFtWork:
    """K10's arguments that stay fixed over a fit (data, errs, bins, freqs,
    nu_ref, model_code, groups, njoin, period), checked once; the data's
    packed spectrum (one rFFT a fit, cuFFT on the card) and the transforms'
    twiddles; and the buffers its launches reuse per (lanes, components,
    epilogue): the staged rows, the scratch rows, the tree's counters and
    gauss_ft_normal's outputs.  Pass it as ``work=`` to gauss_ft_normal /
    gauss_ft_sse with those same arguments (or tensors of the same shapes,
    strides, dtype and device): the call then checks only ``params``.
    gauss_ft_normal's outputs are overwritten by its next call with the
    same work; one work serves one stream at a time."""

    def __init__(self, data, errs, bins, freqs, nu_ref, model_code, groups,
                 njoin, period):
        _check_gauss_ft_fixed(data, errs, bins, freqs, groups, njoin,
                              "gauss_ft work")
        self.laws = _gauss_laws(model_code)
        self.device = data.device
        self.njoin, self.period = int(njoin), float(period)
        self._layout = (_layout(data), _layout(errs), tuple(bins.shape),
                        tuple(freqs.shape), _layout(groups))
        self.dspec = _data_spectrum(data)
        self.twiddles = _gauss_ft_twiddles(data.shape[1], data.device)
        self._bufs = {}

    def check(self, params, data, errs, bins, freqs, model_code, groups,
              njoin, period):
        """(B, P, ngauss, laws) of a call with this work; raises where its
        fixed arguments are not laid out as the work's, or its model code,
        join groups' count or period is not the work's."""
        _check(params, "params", torch.float64, 2)
        if params.device != self.device or self._layout != (
                _layout(data), _layout(errs), tuple(bins.shape),
                tuple(freqs.shape), _layout(groups)):
            raise ValueError("gauss_ft work: the arguments are not laid out "
                             "as the work's (%s)" % (self._layout,))
        if _gauss_laws(model_code) != self.laws or int(njoin) != self.njoin \
                or float(period) != self.period:
            raise ValueError("gauss_ft work: model_code %r, njoin %d, period "
                             "%r are not the work's (laws %s, %d, %r)"
                             % (model_code, njoin, period, self.laws,
                                self.njoin, self.period))
        B, P = params.shape
        return B, P, gauss_ft_ngauss(P, njoin), self.laws

    def buffers(self, B, ngauss, normal):
        key = (B, ngauss, normal)
        bufs = self._bufs.get(key)
        if bufs is None:
            nchan, nbin = self._layout[0][0]
            bufs = self._bufs[key] = _GaussFtBuffers(
                B, nchan, nbin, ngauss, self.njoin, normal, self.device,
                outs=normal)
        return bufs


def _gauss_ft_twiddles(nbin, device):
    """K10's twiddles (K8's table, ops.wavelet.scan_twiddles) on a card,
    None on the CPU (the plain versions take torch.fft)."""
    if torch.device(device).type != "cuda" or not gauss_ft_takes_bins(nbin):
        return None
    from .ops.wavelet import scan_twiddles

    return scan_twiddles(nbin, device)


def _gauss_ft_call(name, params, data, errs, bins, freqs, nu_ref, model_code,
                   groups, njoin, period, work):
    """Check a K10 call; returns (B, P, ngauss, laws, the data's packed
    spectrum, twiddles) for the card, or None for the CPU's plain
    version."""
    if params.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: unsupported device %s" % (name, params.device))
    if work is None:
        B, P, ng, laws = _check_gauss_ft(params, data, errs, bins, freqs,
                                         model_code, groups, njoin, name)
    else:
        B, P, ng, laws = work.check(params, data, errs, bins, freqs,
                                    model_code, groups, njoin, period)
    if params.device.type == "cpu":
        return None
    nbin = data.shape[1]
    if ng > GAUSS_FT_MAX_NGAUSS or not gauss_ft_takes_bins(nbin):
        raise ValueError("%s: %d components over %d bins; the kernel takes at "
                         "most %d components and a power of two from %d to "
                         "%d bins" % (name, ng, nbin, GAUSS_FT_MAX_NGAUSS,
                                      GAUSS_FT_MIN_BINS, GAUSS_FT_MAX_BINS))
    if B > 65535:
        raise ValueError("%s: %d lanes; a launch takes at most 65535"
                         % (name, B))
    if work is not None:
        return B, P, ng, laws, work.dspec, work.twiddles
    return B, P, ng, laws, _data_spectrum(data), _gauss_ft_twiddles(
        nbin, data.device)


def _gauss_ft_launch(name, params, dspec, errs, bins, freqs, groups, tw,
                     nu_ref, laws, ng, njoin, period, bufs, *outs):
    B = params.shape[0]
    nchan, nbin = dspec.shape
    staged = () if name == "gauss_ft_sse" else (
        0 if bufs.staged is None else bufs.staged.data_ptr(),)
    _launch(name, params.device, params.data_ptr(), dspec.data_ptr(),
            errs.data_ptr(), errs.stride(0), bins.data_ptr(),
            freqs.data_ptr(), groups.data_ptr(), tw.data_ptr(), B, ng,
            int(njoin), nchan, nbin, float(nu_ref), FWHM_FACT,
            float(Dconst / period), *laws, *staged, bufs.scratch.data_ptr(),
            bufs.counters.data_ptr(), *(o.data_ptr() for o in outs))


def gauss_ft_sse(params, data, errs, bins, freqs, nu_ref, model_code, groups,
                 njoin, period, work=None):
    """K10 wrapper, epilogue A (see csrc/gauss_ft.cu): f [B] = sum over the
    portrait of r^2, r = (data - m) / errs, m the Gaussian portrait of
    ops.profiles.gen_gaussian_portrait at each lane's params [B, 2 + 6
    ngauss + 1 + 2 njoin] float64 (dc, tau [bins], (loc, dloc, wid, dwid,
    amp, damp) per component, the scattering index, a (phase, DM) pair per
    join group): scattered where tau != 0, each join group's channels
    rotated by its pair (Dconst DM / period dispersion about nu_ref).
    model_code's three digits (loc, wid, amp; 0 power law, 1 linear); data
    [nchan, nbin], errs per-channel errors broadcast over the bins (stride
    0 along them), the bin centres bins [nbin] and freqs [nchan], float64;
    groups [nchan] int32, each channel's join group (-1 outside every
    group); ``njoin`` join groups, ``period`` the fold period.  One launch.
    ``work`` (a GaussFtWork of the same fixed arguments) skips their checks
    and the data's transform and keeps the launch's scratch.  More than
    GAUSS_FT_MAX_NGAUSS components, or bins other than a power of two from
    GAUSS_FT_MIN_BINS to GAUSS_FT_MAX_BINS, raise ValueError on the
    card."""
    call = _gauss_ft_call("gauss_ft_sse", params, data, errs, bins, freqs,
                          nu_ref, model_code, groups, njoin, period, work)
    if call is None:
        return gauss_ft_sse_plain(params, data, errs, bins, freqs, nu_ref,
                                  model_code, groups, njoin, period)
    B, P, ng, laws, dspec, tw = call
    if not B:
        return torch.zeros(0, dtype=torch.float64, device=params.device)
    bufs = work.buffers(B, ng, False) if work is not None else \
        _GaussFtBuffers(B, data.shape[0], data.shape[1], ng, njoin, False,
                        params.device)
    f = torch.empty(B, dtype=torch.float64, device=params.device)
    _gauss_ft_launch("gauss_ft_sse", params, dspec, errs, bins, freqs, groups,
                     tw, nu_ref, laws, ng, njoin, period, bufs, f)
    return f


def gauss_ft_normal(params, data, errs, bins, freqs, nu_ref, model_code,
                    groups, njoin, period, work=None):
    """K10 wrapper, epilogue B (see csrc/gauss_ft.cu): (f [B], g [B, P], JtJ
    [B, P, P]) float64 for the residual of gauss_ft_sse's arguments and its
    Jacobian J = d r / d params: f = sum r^2, g = J^T r, JtJ = J^T J, with
    no J formed.  Where a lane's tau is 0 its tau and scattering-index rows
    and columns are exactly 0 (the reference's model is then unscattered);
    a power law's p0 = 0 gives NaN in every g and JtJ entry.  One launch
    where a channel's packed rows fit the shared memory of a cluster of
    blocks (gauss_ft_path), else two (the rows staged in device memory,
    then their Gram) counted as one; GAUSS_FT_PATHS counts the calls by
    path.  With ``work`` (a
    GaussFtWork of the same fixed arguments) the fixed arguments are not
    checked again and the outputs are the work's own, overwritten by its
    next gauss_ft_normal call."""
    call = _gauss_ft_call("gauss_ft_normal", params, data, errs, bins, freqs,
                          nu_ref, model_code, groups, njoin, period, work)
    if call is None:
        return gauss_ft_normal_plain(params, data, errs, bins, freqs, nu_ref,
                                     model_code, groups, njoin, period)
    B, P, ng, laws, dspec, tw = call
    dev = params.device
    if not B:
        return (torch.zeros(0, dtype=torch.float64, device=dev),
                torch.zeros((0, P), dtype=torch.float64, device=dev),
                torch.zeros((0, P, P), dtype=torch.float64, device=dev))
    if work is not None:
        bufs = work.buffers(B, ng, True)
    else:
        bufs = _GaussFtBuffers(B, data.shape[0], data.shape[1], ng, njoin,
                               True, dev, outs=True)
    _gauss_ft_launch("gauss_ft_normal", params, dspec, errs, bins, freqs,
                     groups, tw, nu_ref, laws, ng, njoin, period, bufs,
                     *bufs.outs)
    with _STATE_LOCK:
        GAUSS_FT_PATHS[bufs.path] += 1
    return bufs.outs


# -- K11: the "fit" noise estimator ---------------------------------------------

# the largest a grid the kernel takes: its tables (S1, S2 and Ya by a, Ya by
# shape: 32 Ns bytes at most for one warp) in the 232,448 bytes of a block's
# shared memory (csrc/noisefit.cu kMaxSmem); rows of any width
NOISE_FIT_MAX_NS = 232448 // 32


def _noise_fit_args(spec, nbin, Ns, noise_out, kc_out):
    if not isinstance(spec, torch.Tensor) or spec.dtype not in (
            torch.float64, torch.complex128):
        raise TypeError("noise_fit: spec must be a float64 (power) or "
                        "complex128 (rFFT) tensor")
    _check(spec, "spec", spec.dtype, 2)
    if spec.is_complex() and (nbin is None or int(nbin) < 1):
        raise ValueError("noise_fit: an rFFT needs its nbin")
    if int(Ns) < 1:
        raise ValueError("noise_fit: Ns must be >= 1, got %d" % Ns)
    rows = spec.shape[0]
    for t, what, dtype in ((noise_out, "noise_out", torch.float64),
                           (kc_out, "kc_out", torch.int64)):
        if t is not None:
            _check(t, what, dtype, 1)
            if t.shape[0] != rows:
                raise ValueError("noise_fit: %s has %d rows, spec %d"
                                 % (what, t.shape[0], rows))
    _same_device(spec, noise_out, kc_out)
    if kc_out is None:
        kc_out = torch.empty(rows, dtype=torch.int64, device=spec.device)
    return kc_out


def noise_fit_plain(spec, nbin=None, fn="exp_dc", fact=1.1, Ns=20,
                    noise_out=None, kc_out=None):
    """Plain PyTorch K11: for each row of spec [R, N] — an rFFT of rows of
    nbin bins (complex128; the power is (X conj(X)).real / nbin, as
    ops.noise._power) or a power spectrum (float64; nbin unused) —
    find_kc's cutoff harmonic into kc_out [R] int64 (ops.noise._argmin_a
    over the _kc_grid tables of N, fn and Ns), and get_noise_fit's noise
    (the harmonics at and above min(fact k_c, int(0.99 N))) into noise_out
    [R] float64 when given.  Returns (noise_out, kc_out)."""
    kc_out = _noise_fit_args(spec, nbin, Ns, noise_out, kc_out)
    pows = (spec * torch.conj(spec)).real / nbin if spec.is_complex() \
        else spec
    N = pows.shape[-1]
    grid = _kc_grid(N, fn, Ns, pows.device)
    kc = grid.kc[_argmin_a(torch.log10(pows), grid, Ns)]
    kc_out.copy_(kc)
    if noise_out is not None:
        k = torch.arange(N, dtype=torch.float64, device=pows.device)
        k_crit = torch.clamp(fact * kc.to(torch.float64), max=int(0.99 * N))
        mask = k[None, :] >= k_crit[:, None]
        noise_out.copy_(torch.sqrt(torch.where(mask, pows, 0.0).sum(dim=-1)
                                   / mask.sum(dim=-1)))
    return noise_out, kc_out


def noise_fit(spec, nbin=None, fn="exp_dc", fact=1.1, Ns=20, noise_out=None,
              kc_out=None):
    """K11 wrapper (see csrc/noisefit.cu): noise_fit_plain's outputs for
    the rows of spec [R, N] (complex128 rFFT of rows of nbin bins, or
    float64 power), one launch.  On the card Ns is at most
    NOISE_FIT_MAX_NS (ValueError beyond).  Returns (noise_out, kc_out)."""
    kc_out = _noise_fit_args(spec, nbin, Ns, noise_out, kc_out)
    if spec.device.type == "cpu":
        return noise_fit_plain(spec, nbin, fn, fact, Ns, noise_out, kc_out)
    if spec.device.type != "cuda":
        raise ValueError("noise_fit: unsupported device %s" % spec.device)
    rows, N = spec.shape
    if int(Ns) > NOISE_FIT_MAX_NS:
        raise ValueError("noise_fit: Ns %d; the kernel takes Ns <= %d"
                         % (Ns, NOISE_FIT_MAX_NS))
    grid = _kc_grid(N, fn, Ns, spec.device)
    if rows:
        _launch("noise_fit", spec.device, spec.data_ptr(),
                int(spec.is_complex()), rows, N, int(nbin or 0),
                grid.uniq.data_ptr(), grid.uniq.shape[0],
                grid.inverse32.data_ptr(), grid.S1.data_ptr(),
                grid.S2.data_ptr(), grid.kc.data_ptr(), int(Ns),
                float(fact), int(0.99 * N),
                None if noise_out is None else noise_out.data_ptr(),
                kc_out.data_ptr())
    return noise_out, kc_out


# -- K12: the synthetic-data writer ---------------------------------------------

# the widths K12's onchip path takes: its two shared-memory buffers of
# nbin / 2 complex doubles (128 KB at 8192 bins) and K8's transforms
SYNTH_MIN_BINS = 64
SYNTH_MAX_BINS = 8192
# K12's calls on the card by path: "onchip" (one launch) or "cufft" (K12's
# harmonics kernel, cuFFT's inverse, K12's epilogue kernel)
SYNTH_PATHS = {"onchip": 0, "cufft": 0}


def synth_path(nbin):
    """K12's path for rows of ``nbin`` bins: "onchip" for a power of two
    from SYNTH_MIN_BINS to SYNTH_MAX_BINS, else "cufft"."""
    nbin = int(nbin)
    return "onchip" if SYNTH_MIN_BINS <= nbin <= SYNTH_MAX_BINS and \
        nbin & (nbin - 1) == 0 else "cufft"


def _synth_args(M, shifts, T, pattern, scales, sigma, weights, out):
    _check(out, "out", torch.float64, 3)
    B, nchan, nbin = out.shape
    _check(M, "M", torch.complex128, 2)
    if tuple(M.shape) != (nchan, nbin // 2 + 1):
        raise ValueError("synth_rows: M has shape %s, want %s"
                         % (tuple(M.shape), (nchan, nbin // 2 + 1)))
    for t, what, shape, dtype in (
            (shifts, "shifts", (B, nchan), torch.float64),
            (T, "T", (nchan, nbin // 2 + 1), torch.complex128),
            (pattern, "pattern", (B, nchan), torch.float64),
            (scales, "scales", (nchan,), torch.float64),
            (sigma, "sigma", (nchan,), torch.float64),
            (weights, "weights", (nchan,), torch.float64)):
        if t is None:
            if what in ("shifts", "scales"):
                raise TypeError("synth_rows: %s is required" % what)
            continue
        _check(t, what, dtype, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError("synth_rows: %s has shape %s, want %s"
                             % (what, tuple(t.shape), shape))
    _same_device(out, M, shifts, T, pattern, scales, sigma, weights)


def synth_rows_plain(M, shifts, T, pattern, scales, sigma, weights, out):
    """Plain PyTorch K12: the rows out [B, nchan, nbin] float64 of the
    model whose rFFT is M [nchan, nbin // 2 + 1] complex128, rotated by
    shifts [B, nchan] [rot] (rotate_plain: M times ops.fourier.phasor),
    where T [nchan, nbin // 2 + 1] complex128 is given its imaginary parts
    at harmonics 0 and nbin / 2 dropped (as irfft drops them) and times T
    (the scattering spectrum), one irfft, then times pattern [B, nchan]
    (the scintillation) where given, times scales [nchan], plus sigma
    [nchan] times the noise out holds on entry where sigma is given, times
    weights [nchan] where given.  In place into out; returns out."""
    _synth_args(M, shifts, T, pattern, scales, sigma, weights, out)
    nbin = out.shape[-1]
    H = rotate_plain(M, shifts)
    if T is not None:
        H.imag[..., 0] = 0.0
        if nbin % 2 == 0:
            H.imag[..., -1] = 0.0
        H = H * T
    x = torch.fft.irfft(H, n=nbin, dim=-1)
    if pattern is not None:
        x = x * pattern[..., None]
    x = x * scales[:, None]
    if sigma is not None:
        x = x + sigma[:, None] * out
    if weights is not None:
        x = x * weights[:, None]
    return out.copy_(x)


def synth_rows(M, shifts, T, pattern, scales, sigma, weights, out):
    """K12 wrapper (see csrc/synth.cu): synth_rows_plain's rows, in place
    into out [B, nchan, nbin] (holding the noise where sigma is given),
    one counted launch, by synth_path: the onchip kernel, or the harmonics
    kernel, cuFFT's inverse and the epilogue kernel (two rows' worth of
    transients, H and x).  Returns out."""
    _synth_args(M, shifts, T, pattern, scales, sigma, weights, out)
    if out.device.type == "cpu":
        return synth_rows_plain(M, shifts, T, pattern, scales, sigma,
                                weights, out)
    if out.device.type != "cuda":
        raise ValueError("synth_rows: unsupported device %s" % out.device)
    B, nchan, nbin = out.shape
    rows = B * nchan
    if not rows:
        return out
    path = synth_path(nbin)

    def ptr(t):
        return None if t is None else t.data_ptr()

    if path == "onchip":
        from .ops.wavelet import scan_twiddles

        tw = scan_twiddles(nbin, out.device)
        _launch("synth_rows", out.device, M.data_ptr(), shifts.data_ptr(),
                ptr(T), ptr(pattern), scales.data_ptr(), ptr(sigma),
                ptr(weights), tw.data_ptr(), rows, nchan, nbin, TWO_PI,
                out.data_ptr())
    else:
        H = torch.empty((rows, nbin // 2 + 1), dtype=torch.complex128,
                        device=out.device)
        _launch("synth_rows", out.device, M.data_ptr(), shifts.data_ptr(),
                ptr(T), rows, nchan, nbin, TWO_PI, H.data_ptr(),
                symbol="pp_synth_harmonics", count=False)
        x = torch.fft.irfft(H, n=nbin, dim=-1)
        del H
        _launch("synth_rows", out.device, x.data_ptr(), ptr(pattern),
                scales.data_ptr(), ptr(sigma), ptr(weights), rows, nchan,
                nbin, out.data_ptr(), symbol="pp_synth_finish")
    with _STATE_LOCK:
        SYNTH_PATHS[path] += 1
    return out
