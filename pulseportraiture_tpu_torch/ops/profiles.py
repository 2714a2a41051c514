"""Gaussian-component model portraits with frequency evolution laws.

Port of the JAX package's ``ops/profiles.py`` (reference
pplib.py:853-1046) for the model build of the pptoas
path: the portrait generator is vectorized over (channel, component,
bin) and optionally scattered through the analytic kernel.  Channel-group
joins (``join_ichans``) are not ported yet.
"""

import math

import torch

from ..config import real_dtype
from .fourier import get_bin_centers
from .scattering import scattering_portrait_FT, scattering_times

__all__ = ["FWHM_FACT", "gaussian_profile", "gaussian_profile_FT",
           "power_law_evolution", "linear_evolution", "evolve_parameter",
           "gen_gaussian_portrait"]

# FWHM = 2*sqrt(2*ln 2) * sigma
FWHM_FACT = 2.0 * math.sqrt(2.0 * math.log(2.0))


def power_law_evolution(freqs, nu_ref, parameter, index):
    """parameter * (freqs/nu_ref)**index, broadcast [nchan, ngauss]
    (reference pplib.py:996-1011)."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype)
    nu = torch.as_tensor(nu_ref, dtype=real_dtype, device=freqs.device)
    logf = torch.log(freqs) - torch.log(nu)
    return torch.exp(torch.outer(logf, index)
                     + torch.log(parameter)[None, :])


def linear_evolution(freqs, nu_ref, parameter, slope):
    """parameter + slope*(freqs - nu_ref), broadcast [nchan, ngauss]
    (reference pplib.py:1013-1028)."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype)
    return torch.outer(freqs - nu_ref, slope) + parameter[None, :]


def gaussian_profile(nbin, loc, wid, norm=False, device="cpu"):
    """Circularly wrapped Gaussian profile [nbin] of FWHM ``wid`` at
    ``loc`` [rot], with peak amplitude 1 (or unit area when ``norm``);
    zeros for wid <= 0 (reference pplib.py:770-825)."""
    locval = get_bin_centers(nbin, device=device)
    mean = loc % 1.0
    locval = torch.where(locval - mean > 0.5, locval - 1.0, locval)
    locval = torch.where(locval - mean < -0.5, locval + 1.0, locval)
    if not wid > 0.0:
        return torch.zeros(nbin, dtype=real_dtype, device=device)
    sigma = wid / FWHM_FACT
    zs = (locval - mean) / sigma
    zs = torch.where(torch.abs(zs) < 20.0, zs, torch.full_like(zs, 20.0))
    dens = torch.exp(-0.5 * zs ** 2) / (sigma * math.sqrt(2.0 * math.pi))
    if norm:
        return dens
    imax = torch.argmax(dens)
    z_peak = (locval[imax] - loc) / sigma
    fact = torch.exp(-0.5 * z_peak ** 2) / torch.clamp(
        dens[imax], min=torch.finfo(dens.dtype).tiny)
    return fact * dens


def gaussian_profile_FT(nbin, loc, wid, amp, device="cpu"):
    """rFFT [nbin/2+1] of an ``amp``-scaled peak-1 Gaussian profile of
    FWHM ``wid`` at ``loc``: the exact DFT of the wrapped, bin-sampled
    Gaussian, times the half-bin phase factor of the reference's
    t=0-anchored convention (pptoaslib.py:14-50; the JAX package's
    ops/profiles.py:207)."""
    prof = amp * gaussian_profile(nbin, loc, wid, device=device)
    k = torch.arange(nbin // 2 + 1, dtype=real_dtype, device=device)
    ang = math.pi * k / nbin
    return torch.fft.rfft(prof) * torch.complex(torch.cos(ang),
                                                -torch.sin(ang))


_EVOLUTION_FUNCTIONS = {"0": power_law_evolution, "1": linear_evolution}


def evolve_parameter(freqs, nu_ref, parameter, evol_parameter, code):
    """Evolve a per-component parameter across frequency per code digit:
    '0' = power law, '1' = linear (reference pplib.py:1030-1046)."""
    return _EVOLUTION_FUNCTIONS[code](freqs, nu_ref, parameter,
                                      evol_parameter)


def gen_gaussian_portrait(model_code, params, scattering_index, phases,
                          freqs, nu_ref, device="cpu"):
    """Gaussian-component model portrait [nchan, nbin] on ``device``.

    params = [dc, tau_bins, (loc0, d_loc, wid0, d_wid, amp0, d_amp)*ngauss];
    each component's (loc, wid, amp) evolves over frequency per the
    corresponding model_code digit, and a nonzero tau [bin] at nu_ref
    (power law ``scattering_index``) scatters the portrait through the
    analytic FT.  Only ``len(phases)`` is used: the bins are the standard
    bin centers.  Equivalent of pplib.py:853-994.
    """
    params = torch.as_tensor(params, dtype=real_dtype, device=device)
    freqs = torch.as_tensor(freqs, dtype=real_dtype, device=device)
    dc, tau = params[0], float(params[1])
    comps = params[2:].reshape(-1, 6)
    nbin = len(phases)

    locs = evolve_parameter(freqs, nu_ref, comps[:, 0], comps[:, 1],
                            model_code[0])          # [nchan, ngauss]
    wids = evolve_parameter(freqs, nu_ref, comps[:, 2], comps[:, 3],
                            model_code[1])
    amps = evolve_parameter(freqs, nu_ref, comps[:, 4], comps[:, 5],
                            model_code[2])

    locval = get_bin_centers(nbin, device=device)
    mean = torch.remainder(locs, 1.0)
    x = locval[None, None, :] - mean[..., None]
    x = torch.where(x > 0.5, x - 1.0, x)
    x = torch.where(x < -0.5, x + 1.0, x)
    sigma = wids / FWHM_FACT
    safe_sigma = torch.where(wids > 0.0, sigma,
                             torch.ones_like(sigma))[..., None]
    zs = torch.clamp(x / safe_sigma, -20.0, 20.0)
    comps_prof = torch.exp(-0.5 * (zs * zs))
    comps_prof = torch.where((wids > 0.0)[..., None], comps_prof,
                             torch.zeros_like(comps_prof))
    gport = dc + torch.sum(amps[..., None] * comps_prof, dim=1)

    if tau != 0.0:
        taus = scattering_times(tau / nbin, scattering_index, freqs, nu_ref)
        sp_FT = scattering_portrait_FT(taus, nbin)
        gport = torch.fft.irfft(sp_FT * torch.fft.rfft(gport, dim=-1),
                                n=nbin, dim=-1)
    return gport
