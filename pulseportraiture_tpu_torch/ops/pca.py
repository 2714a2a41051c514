"""Weighted PCA and eigenprofile significance selection.

Port of the JAX package's ``ops/pca.py`` (reference pplib.py:1497-1619
``pca``, ``reconstruct_portrait``, ``find_significant_eigvec``).  The
weighted covariance and the symmetric eigensolve (``torch.linalg.eigh``
in float64, cuSOLVER on the card) run on the device of the portrait; the
significance scan smooths every candidate eigenvector in one batched
``smart_smooth`` there and reads back one S/N per candidate.
"""

import math

import numpy as np
import torch

from ..config import real_dtype
from .noise import get_noise
from .stats import count_crossings
from .wavelet import smart_smooth

__all__ = ["pca", "reconstruct_portrait", "find_significant_eigvec"]


def pca(port, mean_prof=None, weights=None):
    """Principal components of port [nchan, nbin] (channels = samples).

    Returns (eigval [nbin], eigvec [nbin, nbin]) sorted by decreasing
    eigenvalue; eigenvectors are columns, with the signs the eigensolver
    gives (as in the JAX package, none is fixed).  The covariance is the
    unbiased weighted covariance (np.cov aweights semantics).
    Equivalent of pplib.py:1497-1535.
    """
    port = torch.as_tensor(port, dtype=real_dtype)
    nmes = port.shape[0]
    if weights is None:
        w = torch.ones(nmes, dtype=real_dtype, device=port.device)
    else:
        w = torch.as_tensor(weights, dtype=real_dtype, device=port.device)
    if mean_prof is None:
        mean_prof = (port * w[:, None]).sum(dim=0) / w.sum()
    delta = port - torch.as_tensor(mean_prof, dtype=real_dtype,
                                   device=port.device)
    # np.cov(delta.T, aweights=w, ddof=1): weighted mean removed, then
    # normalization sum(w) - sum(w^2)/sum(w)
    wsum = w.sum()
    dmean = (delta * w[:, None]).sum(dim=0) / wsum
    d = delta - dmean
    cov = torch.einsum("i,ij,ik->jk", w, d, d) / (wsum - (w ** 2).sum()
                                                  / wsum)
    eigval, eigvec = torch.linalg.eigh(cov)
    return eigval.flip(0), eigvec.flip(1)


def reconstruct_portrait(port, mean_prof, eigvec):
    """Project port onto the eigvec basis and reconstruct
    (reference pplib.py:1536-1553)."""
    port = torch.as_tensor(port, dtype=real_dtype)
    dev = port.device
    mean_prof = torch.as_tensor(mean_prof, dtype=real_dtype, device=dev)
    eigvec = torch.as_tensor(eigvec, dtype=real_dtype, device=dev)
    return ((port - mean_prof) @ eigvec) @ eigvec.T + mean_prof


def find_significant_eigvec(eigvec, check_max=10, return_max=10,
                            snr_cutoff=150.0, check_crossings=True,
                            check_acorr=True, return_smooth=True,
                            **kwargs):
    """Indices of "significant" eigenvectors by smoothed Fourier S/N.

    eigvec: [nbin, ncomp] column eigenvectors (a tensor; the work runs on
    its device).  An eigenvector is significant when its smoothed
    version's Fourier-power S/N passes ``snr_cutoff``; borderline cases
    (< 3x cutoff) must also cross 10% of their peak fewer than 2% of nbin
    times.  As in the JAX package the reference's autocorrelation rescue
    (``check_acorr``) is dead code there and is accepted but unused.
    Returns (ieig numpy int array, smooth_eigvec [nbin, ncomp] tensor
    holding the smoothed significant vectors, zeros elsewhere), or ieig
    alone.  Behavioral equivalent of pplib.py:1555-1619.
    """
    del check_acorr
    eigvec = torch.as_tensor(eigvec, dtype=real_dtype)
    nbin = eigvec.shape[0]
    ncheck = min(max(check_max, return_max), eigvec.shape[1])
    cand = eigvec[:, :ncheck].T                       # [ncheck, nbin]
    smooth_cand = smart_smooth(cand, **kwargs)
    noise = get_noise(cand) * math.sqrt(nbin / 2.0)
    sig = torch.sum(torch.abs(torch.fft.rfft(smooth_cand, dim=-1)[:, 1:])
                    ** 2, dim=-1)
    snrs = torch.where(noise > 0.0, sig / torch.where(
        noise > 0.0, noise, torch.ones_like(noise)), torch.zeros_like(sig))
    snrs = snrs.cpu().numpy()

    smooth_eigvec = torch.zeros_like(eigvec)
    ieig = []
    for ivec in range(ncheck):
        ev = smooth_cand[ivec]
        ev_snr = snrs[ivec]
        add = False
        if ev_snr >= snr_cutoff:
            if check_crossings and ev_snr < 3 * snr_cutoff:
                aev = torch.abs(ev)
                ncross = int(count_crossings(aev, 0.1 * aev.max()))
                add = ncross < int(0.02 * nbin)
            else:
                add = True
        if add:
            ieig.append(ivec)
            smooth_eigvec[:, ivec] = ev
        if ivec + 1 == check_max or len(ieig) == return_max:
            break
    ieig = np.array(ieig, dtype=int)
    if return_smooth:
        return ieig, smooth_eigvec
    return ieig
