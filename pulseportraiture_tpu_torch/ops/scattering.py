"""Scattering model: tau(nu) power law and its analytic Fourier kernel.

Port of the JAX package's ``ops/scattering.py`` (reference
pplib.py:4053-4101) for what the model build needs:
convolution with the one-sided exponential of timescale tau [rot] is
multiplication of harmonic k by B_k = 1 / (1 + 2 pi i k tau).  The
derivative chain of the scattering fit is not ported yet.
"""

import math

import torch

from ..config import real_dtype

__all__ = ["scattering_times", "scattering_profile_FT",
           "scattering_portrait_FT"]


def scattering_times(tau, alpha, freqs, nu_tau):
    """tau(nu) = tau * (nu/nu_tau)**alpha (reference pplib.py:4053-4059)."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype)
    return tau * (freqs / nu_tau) ** alpha


def scattering_profile_FT(tau, nbin):
    """B_k = (1 + 2 pi i k tau)**-1 for k < nbin//2 + 1; tau=0 gives ones
    (reference pplib.py:4061-4084)."""
    return scattering_portrait_FT(torch.as_tensor(tau, dtype=real_dtype),
                                  nbin)


def scattering_portrait_FT(taus, nbin, nharm=None):
    """Per-channel scattering FT [..., nchan, nharm] (reference
    pplib.py:4086-4101); ``nharm`` builds only the lowest harmonics."""
    taus = torch.as_tensor(taus, dtype=real_dtype)
    if nharm is None:
        nharm = nbin // 2 + 1
    k = torch.arange(nharm, dtype=real_dtype, device=taus.device)
    x = 2.0 * math.pi * k * taus[..., None]
    denom = 1.0 + x * x
    return torch.complex(1.0 / denom, -x / denom)
