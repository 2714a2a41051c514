"""Stationary wavelet denoising (Daubechies), FFT-domain and batched.

Port of the JAX package's ``ops/wavelet.py`` (reference
pplib.py:1621-1761 ``wavelet_smooth``/``smart_smooth``): the undecimated
(a trous) transform with periodic boundaries is a circular convolution
per level, so the transform and its exact inverse are products with the
level-j filter response H(2^j w) in the FFT domain (cuFFT on the card).
The Daubechies filters come from spectral factorization on the host
(``daubechies_dec_lo``).  ``smart_smooth``'s search over the dense
(nlevel x fact) candidate grid runs on the device of its input as hand
kernel K8 (``_kernels.smooth_search``, csrc/wavelet.cu): one transform
of each profile, the thresholded details' transforms per (level, fact),
and each candidate's spectrum from host tables (``search_tables``: the
inverse transform unrolled), with a one-sided reduced-chi2 gate and an
argmax over pseudo-S/N.  On the card a scan with its own transforms
(``scan_twiddles``) decides each row where its bounds allow, the
candidates' round trips through cuFFT the rest.
"""

import functools
import math
from math import comb

import numpy as np
import torch

from ..config import real_dtype
from .stats import median

__all__ = ["daubechies_dec_lo", "swt", "iswt", "wavelet_smooth",
           "smart_smooth", "threshold", "search_tables", "search_maxima",
           "scan_twiddles"]


@functools.lru_cache(maxsize=None)
def daubechies_dec_lo(N):
    """Daubechies scaling (lowpass analysis) filter with N vanishing
    moments (2N taps, 'db{N}'), by spectral factorization (numpy).

    H(z) = sqrt(2) ((1+z)/2)^N Q(z) with |Q(e^{iw})|^2 = P(sin^2(w/2)),
    P(y) = sum_{k<N} C(N-1+k, k) y^k; Q keeps the minimum-phase roots.
    """
    if N < 1:
        raise ValueError("N >= 1 required")
    if N == 1:  # Haar
        return np.array([1.0, 1.0]) / np.sqrt(2.0)
    p = np.array([comb(N - 1 + k, k) for k in range(N)], dtype=np.float64)
    yroots = np.roots(p[::-1])
    zroots = []
    for y in yroots:
        # y = (2 - z - 1/z)/4  =>  z^2 - (2 - 4y) z + 1 = 0
        b = 2.0 - 4.0 * y
        disc = np.sqrt(b * b - 4.0 + 0j)
        for z in ((b + disc) / 2.0, (b - disc) / 2.0):
            if abs(z) < 1.0:
                zroots.append(z)
    q = np.array([1.0 + 0j])
    for z in zroots:
        q = np.convolve(q, np.array([1.0, -z]))
    h = np.array([1.0])
    for _ in range(N):
        h = np.convolve(h, np.array([1.0, 1.0]))
    h = np.convolve(h, q.real)
    return h * (np.sqrt(2.0) / h.sum())


@functools.lru_cache(maxsize=16)
def _filter_responses_np(wavelet, nbin):
    """(H, G) numpy: full-FFT responses of the analysis lo/hi filters on
    an nbin-point circle; g_n = (-1)^n h_{L-1-n} (QMF)."""
    if not wavelet.startswith("db"):
        raise ValueError(f"unsupported wavelet '{wavelet}'")
    h = daubechies_dec_lo(int(wavelet[2:]))
    g = ((-1.0) ** np.arange(len(h))) * h[::-1]
    return np.fft.fft(h, nbin), np.fft.fft(g, nbin)


def _filter_responses(wavelet, nbin, device):
    if isinstance(wavelet, str):
        H, G = _filter_responses_np(wavelet, nbin)
    else:
        h = np.asarray(wavelet, dtype=np.float64)
        g = ((-1.0) ** np.arange(len(h))) * h[::-1]
        H, G = np.fft.fft(h, nbin), np.fft.fft(g, nbin)
    return (torch.as_tensor(H, device=device),
            torch.as_tensor(G, device=device))


def _level_response(H, j):
    """Response of the level-j a-trous-upsampled filter: H(2^j w)."""
    nbin = H.shape[0]
    idx = torch.as_tensor((np.arange(nbin) * (2 ** j)) % nbin,
                          device=H.device)
    return H[idx]


def swt(x, nlevel, wavelet="db8"):
    """Undecimated wavelet transform of [..., nbin] with periodic
    boundaries; returns (cA [..., nbin], cDs list of nlevel arrays,
    finest first).  Perfect-reconstruction partner of ``iswt``."""
    x = torch.as_tensor(x, dtype=real_dtype)
    H, G = _filter_responses(wavelet, x.shape[-1], x.device)
    A = torch.fft.fft(x, dim=-1)
    cDs = []
    for j in range(nlevel):
        Hj, Gj = _level_response(H, j), _level_response(G, j)
        cDs.append(torch.fft.ifft(torch.conj(Gj) * A, dim=-1).real)
        A = torch.conj(Hj) * A
    cA = torch.fft.ifft(A, dim=-1).real
    return cA, cDs


def iswt(cA, cDs, wavelet="db8"):
    """Inverse of ``swt``: exact reconstruction via the synthesis
    responses (|H|^2 + |G|^2 = 2 for orthonormal filters)."""
    cA = torch.as_tensor(cA, dtype=real_dtype)
    H, G = _filter_responses(wavelet, cA.shape[-1], cA.device)
    A = torch.fft.fft(cA, dim=-1)
    for j in reversed(range(len(cDs))):
        Hj, Gj = _level_response(H, j), _level_response(G, j)
        D = torch.fft.fft(cDs[j], dim=-1)
        A = 0.5 * (Hj * A + Gj * D)
    return torch.fft.ifft(A, dim=-1).real


def threshold(c, value, mode="hard"):
    """Hard/soft wavelet thresholding (pywt.threshold semantics)."""
    c = torch.as_tensor(c, dtype=real_dtype)
    value = torch.as_tensor(value, dtype=real_dtype, device=c.device)
    if mode == "hard":
        return torch.where(torch.abs(c) < value, torch.zeros_like(c), c)
    if mode == "soft":
        return torch.sign(c) * torch.clamp(torch.abs(c) - value, min=0.0)
    raise ValueError(f"unknown threshold mode '{mode}'")


def wavelet_smooth(port, wavelet="db8", nlevel=5, threshtype="hard",
                   fact=1.0):
    """Wavelet-denoised portrait or profile (universal threshold).

    port: [nbin] or [..., nbin]; ``fact`` scales the threshold and may
    carry extra leading batch dims (a candidate grid) that broadcast
    against port's batch shape.  Behavioral equivalent of
    pplib.py:1621-1666, batched.
    """
    port = torch.as_tensor(port, dtype=real_dtype)
    nbin = port.shape[-1]
    cA, cDs = swt(port, nlevel, wavelet)
    sigma = median(torch.abs(cDs[0])) / 0.6745
    fact = torch.as_tensor(fact, dtype=real_dtype, device=port.device)
    lopt = fact * sigma * math.sqrt(2.0 * math.log(float(nbin)))
    cA = torch.broadcast_to(cA, lopt.shape + cA.shape[-1:])
    cDs = [threshold(D, lopt[..., None], threshtype) for D in cDs]
    return iswt(cA, cDs, wavelet)


def _search_tables_np(h, nbin, nlevel):
    """(ana, P, Q) of search_tables for the lowpass filter taps h."""
    g = ((-1.0) ** np.arange(len(h))) * h[::-1]
    H, G = np.fft.fft(h, nbin), np.fft.fft(g, nbin)
    nh = nbin // 2 + 1
    k = np.arange(nh)
    ana = np.empty((nlevel, nh), dtype=np.complex128)
    P = np.empty((nlevel, nh), dtype=np.float64)
    Q = np.empty((nlevel, nh), dtype=np.complex128)
    prod = np.ones(nh, dtype=np.complex128)       # prod_{i<j} H_i
    for j in range(nlevel):
        idx = (k * 2 ** j) % nbin
        ana[j] = np.conj(G[idx] * prod)
        Q[j] = G[idx] * prod / 2.0 ** (j + 1)
        prod = prod * H[idx]
        P[j] = np.abs(prod) ** 2 / 2.0 ** (j + 1)
    return ana, P, Q


_TABLES = {}


def search_tables(wavelet, nbin, nlevel, device):
    """The smoothing search's tables on ``device``: the half-spectrum
    (k = 0..nbin/2) responses, with H_i = H(2^i w) and G_i = G(2^i w) the
    level-i responses of ``swt``,

      ana[j] = conj(G_j prod_{i<j} H_i)         cD_j's spectrum over X's
      P[l-1] = prod_{i<l} |H_i|^2 / 2^l         cA_l's share of a candidate
      Q[j]   = G_j prod_{i<j} H_i / 2^(j+1)     cD_j's share of a candidate

    so that the level-l candidate with thresholded details D_j is P[l-1] X
    + sum_{j<l} Q[j] D_j (``iswt``'s recursion unrolled), for j, l - 1 <
    nlevel.  Built once per (wavelet, nbin, nlevel) on the host in
    float64 / complex128 and uploaded once per device."""
    h, key = _table_key(wavelet, nbin, nlevel, device)
    tabs = _TABLES.get(key)
    if tabs is None:
        tabs = tuple(torch.as_tensor(t, device=device) for t in
                     _search_tables_np(h, key[1], key[2]))
        _TABLES[key] = tabs
    return tabs


def search_maxima(wavelet, nbin, nlevel, device):
    """[2 nlevel] float64 on ``device``: max_k |Q[j, k]| for each level j,
    then max_k |P[l, k]| for each level l (search_tables), with which K8's
    certification bounds its candidates' spectra.  Built and cached as
    search_tables."""
    h, key = _table_key(wavelet, nbin, nlevel, device)
    key = ("maxima",) + key
    m = _TABLES.get(key)
    if m is None:
        _, P, Q = _search_tables_np(h, key[2], key[3])
        m = torch.as_tensor(np.concatenate([np.abs(Q).max(-1),
                                            np.abs(P).max(-1)]),
                            device=device)
        _TABLES[key] = m
    return m


def _table_key(wavelet, nbin, nlevel, device):
    """(the lowpass taps, the tables' cache key) of ``wavelet``."""
    if isinstance(wavelet, str):
        if not wavelet.startswith("db"):
            raise ValueError(f"unsupported wavelet '{wavelet}'")
        h = daubechies_dec_lo(int(wavelet[2:]))
    else:
        h = np.asarray(wavelet, dtype=np.float64)
    return h, (tuple(float(v) for v in h), int(nbin), int(nlevel),
               str(torch.device(device)))


def _scan_twiddles_np(nbin):
    """[nbin + P, 2] float64: (cos, -sin)(2 pi t / nbin) for t < nbin, exact
    at the quarter turns; then, for each Stockham pass of the complex FFT
    of nbin / 2 points (radix R, p points done: one radix-2 pass first where
    log2(nbin / 2) is odd, then radix-4), its butterflies' twiddles in the
    order the pass reads them, entry (q - 1) p + k = the table's q k nbin /
    (R p), for q = 1..R-1 and k < p."""
    t = np.arange(nbin)
    ang = 2.0 * np.pi * t / nbin
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    quarter = nbin // 4
    if quarter and nbin % 4 == 0:
        tw[::quarter] = [[1.0, 0.0], [0.0, -1.0], [-1.0, 0.0], [0.0, 1.0]]
    n = nbin // 2
    m = n.bit_length() - 1
    passes, p = [], 1
    for R in [2] * (m % 2) + [4] * (m // 2):
        q, k = np.meshgrid(np.arange(1, R), np.arange(p), indexing="ij")
        passes.append(tw[(q * k * (nbin // (R * p))).ravel()])
        p *= R
    return np.concatenate([tw] + passes)


def scan_twiddles(nbin, device):
    """The twiddle table of the smoothing scan's own transforms (K8's
    pp_wavelet_scan and its plain version): W^t = exp(-2 pi i t / nbin)
    as (re, im) for t < nbin, then each pass's twiddles in its
    butterflies' order (so a warp reads them coalesced), float64, built on
    the host with numpy's cos and sin and uploaded once per (nbin,
    device)."""
    key = ("twiddles", int(nbin), str(torch.device(device)))
    tw = _TABLES.get(key)
    if tw is None:
        tw = torch.as_tensor(_scan_twiddles_np(int(nbin)), device=device)
        _TABLES[key] = tw
    return tw


def _smart_smooth_grid(port, try_nlevels, nfact, rchi2_tol, wavelet,
                       threshtype):
    """The (nlevel x fact) candidate search on ``port``'s device: K8
    (``_kernels.smooth_search``) on the card, its plain version on the
    CPU.

    Returns the per-profile best smooth [..., nbin] (zeros where no
    candidate passes the chi2 gate).  The gate is one-sided, as in the
    JAX package: chi2 <= 1 + tol rejects over-distortion while leaving
    under-smoothed candidates eligible, and the pseudo-S/N argmax (first
    maximum) picks the most aggressive admissible candidate.
    """
    from .. import _kernels

    nbin = port.shape[-1]
    rows = port.reshape(-1, nbin).contiguous()
    facts = torch.linspace(0.0, 3.0, nfact, dtype=real_dtype,
                           device=port.device)
    out, _ = _kernels.smooth_search(rows, wavelet, try_nlevels, facts,
                                    rchi2_tol, threshtype)
    return out.reshape(port.shape)


def smart_smooth(port, try_nlevels=None, rchi2_tol=0.1, wavelet="db8",
                 threshtype="hard", nfact=30, fallback="zero"):
    """Automated wavelet smoothing: maximize pseudo-S/N over
    (nlevel, fact) subject to reduced chi2 <= 1 + ``rchi2_tol``.

    port: [nbin] or [nchan, nbin] tensor; runs on its device and returns
    a tensor there.  Equivalent of pplib.py:1668-1735 with the
    per-profile ``opt.brute`` replaced by the dense grid search.
    ``fallback`` sets what profiles no candidate passes become: 'zero'
    zeroes them (the reference's behaviour, right for eigenvector
    significance screening), 'raw' returns them unsmoothed.
    """
    port = torch.as_tensor(port, dtype=real_dtype)
    nbin = port.shape[-1]
    if try_nlevels == 0 or nbin % 2 != 0:
        return port
    if np.modf(np.log2(nbin))[1] != np.log2(nbin):
        try_nlevels = 1
    elif try_nlevels is None:
        try_nlevels = int(np.log2(nbin))
    out = _smart_smooth_grid(port, int(try_nlevels), int(nfact),
                             float(rchi2_tol), wavelet, threshtype)
    if fallback == "raw":
        failed = ~torch.any(out != 0.0, dim=-1)
        return torch.where(failed[..., None], port, out)
    if port.ndim > 1:  # all-zero profiles stay zero (reference skips)
        out = torch.where(torch.any(port != 0.0, dim=-1)[..., None], out,
                          torch.zeros_like(out))
    return out
