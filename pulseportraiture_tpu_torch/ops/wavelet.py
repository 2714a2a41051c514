"""Stationary wavelet denoising (Daubechies), FFT-domain and batched.

Port of the JAX package's ``ops/wavelet.py`` (reference
pplib.py:1621-1761 ``wavelet_smooth``/``smart_smooth``): the undecimated
(a trous) transform with periodic boundaries is a circular convolution
per level, so the transform and its exact inverse are products with the
level-j filter response H(2^j w) in the FFT domain (cuFFT on the card).
The Daubechies filters come from spectral factorization on the host
(``daubechies_dec_lo``).  ``smart_smooth``'s search is one dense
(nlevel x fact) candidate grid per portrait on the device of its input:
for each level a [nfact, ..., nbin] batch of smoothed candidates, a
one-sided reduced-chi2 gate and an argmax over pseudo-S/N.
"""

import functools
import math
from math import comb

import numpy as np
import torch

from ..config import real_dtype
from .noise import get_noise
from .stats import median

__all__ = ["daubechies_dec_lo", "swt", "iswt", "wavelet_smooth",
           "smart_smooth", "threshold"]


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


def _pseudo_snr(smooth_prof):
    """Fourier-domain pseudo-S/N of the smoothing-factor search
    (reference pplib.py:1737-1761)."""
    sig = torch.sum(torch.abs(torch.fft.rfft(smooth_prof, dim=-1)[..., 1:])
                    ** 2, dim=-1)
    noise = get_noise(smooth_prof) * math.sqrt(smooth_prof.shape[-1] / 2.0)
    pos = noise > 0.0
    return torch.where(pos, sig / torch.where(pos, noise,
                                              torch.ones_like(noise)),
                       torch.where(sig > 0.0, torch.full_like(sig, math.inf),
                                   torch.zeros_like(sig)))


def _smart_smooth_grid(port, try_nlevels, nfact, rchi2_tol, wavelet,
                       threshtype):
    """Dense (nlevel x fact) candidate search on ``port``'s device.

    Returns the per-profile best smooth [..., nbin] (zeros where no
    candidate passes the chi2 gate).  The gate is one-sided, as in the
    JAX package: chi2 <= 1 + tol rejects over-distortion while leaving
    under-smoothed candidates eligible, and the pseudo-S/N argmax (first
    maximum) picks the most aggressive admissible candidate.
    """
    nbin = port.shape[-1]
    errs = get_noise(port)                      # [...] per profile
    safe_errs = torch.where(errs > 0.0, errs, torch.ones_like(errs))
    facts = torch.linspace(0.0, 3.0, nfact, dtype=real_dtype,
                           device=port.device)

    def chi2_of(sm):
        r = (port - sm) / safe_errs[..., None]
        return torch.sum(r * r, dim=-1) / nbin

    best = torch.zeros_like(port)
    best_snr = torch.full(port.shape[:-1], -math.inf, dtype=real_dtype,
                          device=port.device)
    fgrid = facts.reshape((nfact,) + (1,) * (port.ndim - 1))
    for ilevel in range(try_nlevels):
        sm = wavelet_smooth(port, wavelet, ilevel + 1, threshtype, fgrid)
        snr = _pseudo_snr(sm)                   # [nfact, ...]
        ok = chi2_of(sm) - 1.0 <= rchi2_tol
        snr = torch.where(ok, snr, torch.zeros_like(snr))
        ibest = torch.argmax(snr, dim=0)        # [...]
        sm_best = torch.take_along_dim(
            sm, ibest[None, ..., None], dim=0)[0]
        snr_best = torch.take_along_dim(snr, ibest[None], dim=0)[0]
        improve = snr_best > best_snr
        best = torch.where(improve[..., None], sm_best, best)
        best_snr = torch.maximum(best_snr, snr_best)
    final_ok = (best_snr > 0.0) & (chi2_of(best) - 1.0 <= rchi2_tol)
    return torch.where(final_ok[..., None], best, torch.zeros_like(best))


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
