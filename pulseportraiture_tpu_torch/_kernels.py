"""The port's hand-written CUDA kernels: build, ctypes binding, wrappers.

Three kernels, each a CUDA C++ source under ``csrc/`` compiled for
Hopper (``sm_90a``) by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes``:

  K1 ``moments`` (csrc/moments.cu) — per-channel moments of the portrait
     objective; replaces pulseportraiture_tpu/fit/portrait.py:118
     ``_moments`` (scattering-free branch).
  K3 ``moments_scat`` (csrc/moments_scat.cu) — the nine per-channel
     harmonic sums of the scattering branch of the same ``_moments``
     (:191-323); the (tau, alpha) chain rule on top stays torch.
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

Each wrapper dispatches on its input's device: a CPU tensor takes the
plain PyTorch version beside it (``moments_plain``/``fftfit_plain``/
``moments_scat_plain``,
which the CPU tests use and ``chip_smoke.py`` holds the kernels
against); a CUDA tensor launches the kernel — building it at first use —
or raises.  Nothing falls back from the card to the plain version.  The
wrapper checks device, dtype, shape and contiguity, checks the launch's
``cudaGetLastError()`` and adds one to ``LAUNCHES[name]`` per launch.

Build: ``build()`` starts one ``nvcc`` per source, all at once, writing
``_build/lib<name>-<hash>.so`` (the hash covers the source and the
flags, so an edited source never reuses a stale library).  No CUDA
toolkit is needed to import this module.
"""

import collections
import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time

import torch

__all__ = ["LAUNCHES", "reset_launches", "build", "moments",
           "moments_plain", "moments_scat", "moments_scat_plain",
           "MOMENTS_SCAT_SUMS", "fftfit", "fftfit_plain", "fftfit_table",
           "fftfit_table_plain", "KERNELS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> (source file, C symbol, the JAX function it replaces)
KERNELS = {
    "moments": ("moments.cu", "pp_moments",
                "pulseportraiture_tpu/fit/portrait.py:118"),
    "fftfit": ("fftfit.cu", "pp_fftfit",
               "pulseportraiture_tpu/fit/phase_shift.py:64"),
    "moments_scat": ("moments_scat.cu", "pp_moments_scat",
                     "pulseportraiture_tpu/fit/portrait.py:191"),
}

_VP, _I64, _INT, _DBL = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                         ctypes.c_double)
# kernel name -> {C symbol: argument types}; each returns a cudaError_t
_SYMBOLS = {
    "moments": {"pp_moments": [_VP, _VP, _VP, _VP, _I64, _INT, _INT, _VP,
                               _VP]},
    "fftfit": {"pp_fftfit": [_VP, _VP, _VP, _I64, _INT, _DBL, _DBL, _INT,
                             _INT, _INT, _VP, _VP, _VP, _VP, _VP, _VP],
               "pp_fftfit_table": [_VP, _INT, _INT, _DBL, _DBL, _VP]},
    "moments_scat": {"pp_moments_scat": [_VP, _VP, _I64, _VP, _VP, _VP, _VP,
                                         _I64, _INT, _INT, _VP, _VP]},
}

LAUNCHES = {name: 0 for name in KERNELS}
BUILD_LOG = {}  # name -> nvcc output (register/shared-memory report)
_LIBS = {}
_LOCK = threading.Lock()


def reset_launches():
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _lib_path(name):
    src = os.path.join(CSRC_DIR, KERNELS[name][0])
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:12]))


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
        procs = {}
        for name in todo:
            path = _lib_path(name)
            if os.path.exists(path):
                continue
            tmp = "%s.%d.tmp" % (path, os.getpid())
            cmd = [_nvcc()] + NVCC_FLAGS + [
                "-o", tmp, os.path.join(CSRC_DIR, KERNELS[name][0])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append("%s:\n%s" % (name, out))
            else:
                os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in todo:
            lib = ctypes.CDLL(_lib_path(name))
            fns = {}
            for sym, argtypes in _SYMBOLS[name].items():
                fns[sym] = fn = getattr(lib, sym)
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
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError_t %d"
                           % (name, err))
    if count:
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


def moments(cross, shifts, inv_err2, lanes=None):
    """K1 wrapper: per-channel moments [n, nchan, 3] f64.

    cross [B, nchan, K] complex128, inv_err2 [B, nchan] f64; shifts
    [n, nchan] f64 are the phase shifts of the rows to evaluate, which
    are subints ``lanes`` [n] int64 (all B subints when None)."""
    _check(cross, "cross", torch.complex128, 3)
    _check(shifts, "shifts", torch.float64, 2)
    _check(inv_err2, "inv_err2", torch.float64, 2)
    B, nchan, K = cross.shape
    n = B if lanes is None else lanes.shape[0]
    if lanes is not None:
        _check(lanes, "lanes", torch.int64, 1)
    if tuple(shifts.shape) != (n, nchan) or tuple(inv_err2.shape) != (
            B, nchan):
        raise ValueError("moments: shapes cross %s, shifts %s, inv_err2 %s"
                         " disagree" % (tuple(cross.shape),
                                        tuple(shifts.shape),
                                        tuple(inv_err2.shape)))
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


def moments_scat(cross, abs_m2, shifts, taus, inv_err2, lanes=None):
    """K3 wrapper: the nine per-channel scattering sums [n, nchan, 9] f64
    (order MOMENTS_SCAT_SUMS; see csrc/moments_scat.cu).

    cross [B, nchan, K] complex128; abs_m2 [B or 1, nchan, K] f64 (one
    set of rows shared by the batch when its first dimension is 1);
    inv_err2 [B, nchan] f64; shifts and taus [n, nchan] f64 are the phase
    shifts and channel scattering times [rot] of the rows to evaluate,
    which are subints ``lanes`` [n] int64 (all B subints when None)."""
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
        raise ValueError("moments_scat: shapes cross %s, abs_m2 %s, shifts "
                         "%s, taus %s, inv_err2 %s disagree"
                         % tuple(tuple(t.shape) for t in (
                             cross, abs_m2, shifts, taus, inv_err2)))
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
