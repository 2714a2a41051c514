"""Gaussian-component model portraits with frequency evolution laws.

Port of the JAX package's ``ops/profiles.py`` (reference
pplib.py:853-1046) for the model build of the pptoas
path and the model builders: the portrait generator is vectorized over
(channel, component, bin), optionally scattered through the analytic
kernel, and channel groups (``join_ichans``) rotate by their own
(phase, DM) pairs.
"""

import math

import numpy as np
import torch

from ..config import real_dtype
from .fourier import get_bin_centers, rotate_data
from .scattering import (scattering_portrait_FT, scattering_profile_FT,
                         scattering_times)

__all__ = ["FWHM_FACT", "gaussian_function", "gaussian_profile",
           "gen_gaussian_profile", "gaussian_profile_FT",
           "gaussian_portrait_FT",
           "power_law_evolution", "linear_evolution", "evolve_parameter",
           "gen_gaussian_portrait"]

# FWHM = 2*sqrt(2*ln 2) * sigma
FWHM_FACT = 2.0 * math.sqrt(2.0 * math.log(2.0))


def gaussian_function(xs, loc, wid, norm=False):
    """Gaussian of FWHM ``wid`` at ``loc`` evaluated at ``xs`` (peak 1, or
    unit area with ``norm``; reference pplib.py:752-768)."""
    xs = torch.as_tensor(xs, dtype=real_dtype)
    sigma = wid / FWHM_FACT
    zs = (xs - loc) / sigma
    ys = torch.exp(-0.5 * zs ** 2)
    if norm:
        ys = ys * (sigma ** 2 * 2.0 * math.pi) ** -0.5
    return ys


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
    zeros for wid <= 0 (reference pplib.py:770-825).  Branch-free in
    ``loc`` and ``wid`` (a ``where`` on wid > 0), so it differentiates
    under ``torch.func``."""
    loc = torch.as_tensor(loc, dtype=real_dtype, device=device)
    wid = torch.as_tensor(wid, dtype=real_dtype, device=device)
    locval = get_bin_centers(nbin, device=device)
    mean = torch.remainder(loc, 1.0)
    locval = torch.where(locval - mean > 0.5, locval - 1.0, locval)
    locval = torch.where(locval - mean < -0.5, locval + 1.0, locval)
    sigma = wid / FWHM_FACT
    safe_sigma = torch.where(wid > 0.0, sigma, torch.ones_like(sigma))
    zs = (locval - mean) / safe_sigma
    zs = torch.where(torch.abs(zs) < 20.0, zs, torch.full_like(zs, 20.0))
    dens = torch.exp(-0.5 * (zs * zs)) / (safe_sigma
                                          * math.sqrt(2.0 * math.pi))
    if norm:
        prof = dens
    else:
        imax = torch.argmax(dens).reshape(1)   # a gather: batchable
        z_peak = (locval.gather(0, imax)[0] - loc) / safe_sigma
        fact = torch.exp(-0.5 * (z_peak * z_peak)) / torch.clamp(
            dens.gather(0, imax)[0], min=torch.finfo(dens.dtype).tiny)
        prof = fact * dens
    return torch.where(wid > 0.0, prof, torch.zeros_like(prof))


def gen_gaussian_profile(params, nbin, device="cpu"):
    """Multi-Gaussian profile [nbin]: params = [dc, tau_bins, (loc, wid,
    amp)*n]; a nonzero tau [bin] scatters it through the analytic FT
    (reference pplib.py:827-851).  The scattered profile is always
    computed and selected with a ``where`` on tau != 0, as the JAX
    package does, so the function differentiates in every parameter."""
    params = torch.as_tensor(params, dtype=real_dtype, device=device)
    dc, tau = params[0], params[1]
    comps = params[2:].reshape(-1, 3)
    model = dc + sum(gaussian_profile(nbin, comps[i, 0], comps[i, 1],
                                      device=device) * comps[i, 2]
                     for i in range(comps.shape[0]))
    sp_FT = scattering_profile_FT(tau / nbin, nbin)
    scattered = torch.fft.irfft(sp_FT * torch.fft.rfft(model), n=nbin)
    return torch.where(tau != 0.0, scattered, model)


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
                          freqs, nu_ref, join_ichans=(), P=None,
                          device="cpu"):
    """Gaussian-component model portrait [nchan, nbin] on ``device``.

    params = [dc, tau_bins, (loc0, d_loc, wid0, d_wid, amp0, d_amp)*ngauss]
    (+ a (phase, DM) pair per join group, appended); each component's
    (loc, wid, amp) evolves over frequency per the corresponding
    model_code digit, and a nonzero tau [bin] at nu_ref (power law
    ``scattering_index``) scatters the portrait through the analytic FT.
    ``join_ichans``/``P`` rotate each group of channels by its pair
    (reference pplib.py:977-993).  Only ``len(phases)`` is used: the bins
    are the standard bin centers.  As in the JAX package the scattered
    portrait is always computed and selected with a ``where`` on
    tau != 0, so the function differentiates in every parameter (and in
    the scattering index) under ``torch.func``, the tau = 0 bound
    included.  Equivalent of pplib.py:853-994.
    """
    params = torch.as_tensor(params, dtype=real_dtype, device=device)
    freqs = torch.as_tensor(freqs, dtype=real_dtype, device=device)
    njoin = len(join_ichans)
    if njoin:
        join_params = params[-njoin * 2:]
        params = params[:-njoin * 2]
    dc, tau = params[0], params[1]
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

    taus = scattering_times(tau / nbin, scattering_index, freqs, nu_ref)
    sp_FT = scattering_portrait_FT(taus, nbin)
    scattered = torch.fft.irfft(sp_FT * torch.fft.rfft(gport, dim=-1),
                                n=nbin, dim=-1)
    gport = torch.where(tau != 0.0, scattered, gport)

    for ij, ichans in enumerate(join_ichans):
        ichans = torch.as_tensor(np.asarray(ichans), dtype=torch.long,
                                 device=device)
        gport = gport.index_copy(0, ichans, rotate_data(
            gport[ichans], join_params[2 * ij], join_params[2 * ij + 1], P,
            freqs[ichans], nu_ref, model=True))
    return gport


def gaussian_portrait_FT(model_code, params, scattering_index, nbin, freqs,
                         nu_ref, device="cpu"):
    """rFFT [nchan, nbin/2+1] of gen_gaussian_portrait's portrait (no join
    groups): the model in the harmonic domain."""
    port = gen_gaussian_portrait(model_code, params, scattering_index,
                                 get_bin_centers(nbin, device=device),
                                 freqs, nu_ref, device=device)
    return torch.fft.rfft(port, dim=-1)
