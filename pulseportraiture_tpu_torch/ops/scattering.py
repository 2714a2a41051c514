"""Scattering model: tau(nu) power law, analytic Fourier kernels and the
derivative chain of the scattering fit.

Port of the JAX package's ``ops/scattering.py`` (reference
pplib.py:4053-4101 and :1098-1144; derivative chain pptoaslib.py:246-388).
Convolution with the one-sided exponential of timescale tau [rot] is
multiplication of harmonic k by B_k = 1 / (1 + 2 pi i k tau).  The
derivatives with respect to (tau or log10 tau, alpha) use dB/dtau =
-2 pi i k B**2, finite at tau = 0; the tau == 0 guards are arithmetic
``where``s, as in the JAX module, so no branch depends on the data.

Layouts follow the JAX module: first derivatives stack as [2, ...],
second derivatives as [2, 2, ...] ahead of the channel (and harmonic)
axes; tau, nu_tau and the like broadcast against freqs.
"""

import math

import torch

from ..config import real_dtype

__all__ = [
    "scattering_times",
    "scattering_times_deriv",
    "scattering_times_2deriv",
    "scattering_profile_FT",
    "scattering_portrait_FT",
    "scattering_portrait_FT_deriv",
    "scattering_portrait_FT_2deriv",
    "abs_scattering_portrait_FT",
    "abs_scattering_portrait_FT_deriv",
    "abs_scattering_portrait_FT_2deriv",
    "scattering_kernel",
    "add_scattering",
]

LN10 = math.log(10.0)


def _nonzero_div(num, tau):
    """num / tau where tau != 0, else 0 (the reference's tau == 0 branch
    as an arithmetic where)."""
    tau = torch.as_tensor(tau, dtype=real_dtype, device=num.device)
    nz = tau != 0.0
    return torch.where(nz, num / torch.where(nz, tau, torch.ones_like(tau)),
                       torch.zeros_like(num))


def scattering_times(tau, alpha, freqs, nu_tau):
    """tau(nu) = tau * (nu/nu_tau)**alpha (reference pplib.py:4053-4059)."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype)
    return tau * (freqs / nu_tau) ** alpha


def scattering_times_deriv(tau, freqs, nu_tau, log10_tau, taus):
    """d taus / d(tau or log10 tau, alpha): [2, ...] (reference
    pptoaslib.py:246-257); d taus / d log10(tau) = ln(10) taus."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype, device=taus.device)
    if log10_tau:
        dtau = LN10 * taus
    else:
        dtau = _nonzero_div(taus, tau)
    dalpha = torch.log(freqs / nu_tau) * taus
    return torch.stack([dtau, dalpha])


def scattering_times_2deriv(tau, freqs, nu_tau, log10_tau, taus,
                            taus_deriv):
    """Second derivatives of taus wrt (tau, alpha): [2, 2, ...]
    (reference pptoaslib.py:259-274)."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype, device=taus.device)
    dtau, dalpha = taus_deriv[0], taus_deriv[1]
    if log10_tau:
        d2tau = LN10 * dtau
        dtaudalpha = LN10 * dalpha
    else:
        d2tau = torch.zeros_like(dtau)
        dtaudalpha = _nonzero_div(dalpha, tau)
    d2alpha = torch.log(freqs / nu_tau) * dalpha
    return torch.stack([torch.stack([d2tau, dtaudalpha]),
                        torch.stack([dtaudalpha, d2alpha])])


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


def _minus_2pi_i_k(nharm, device):
    k = torch.arange(nharm, dtype=real_dtype, device=device)
    return torch.complex(torch.zeros_like(k), -2.0 * math.pi * k)


def scattering_portrait_FT_deriv(taus, taus_deriv, scat_port_FT):
    """d scat_FT / d(tau, alpha): [2, ..., nchan, nharm], from dB/dtaus =
    -2 pi i k B**2 and the chain rule (reference pptoaslib.py:318-330)."""
    mjk = _minus_2pi_i_k(scat_port_FT.shape[-1], scat_port_FT.device)
    dB_dtaus = mjk * scat_port_FT ** 2
    return torch.stack([dB_dtaus * taus_deriv[0][..., None],
                        dB_dtaus * taus_deriv[1][..., None]])


def scattering_portrait_FT_2deriv(taus, taus_deriv, taus_2deriv,
                                  scat_port_FT):
    """d2 scat_FT / d(tau, alpha)2: [2, 2, ..., nchan, nharm].  With u =
    -2 pi i k: d2B/dp_i dp_j = 2 u**2 B**3 dtaus_i dtaus_j + u B**2
    d2taus_ij (reference pptoaslib.py:332-356)."""
    u = _minus_2pi_i_k(scat_port_FT.shape[-1], scat_port_FT.device)
    B = scat_port_FT
    dB = u * B ** 2
    d2B = 2.0 * (u ** 2) * B ** 3
    dti = taus_deriv[:, None, ..., None]
    dtj = taus_deriv[None, :, ..., None]
    d2t = taus_2deriv[..., None]
    return d2B * dti * dtj + dB * d2t


def abs_scattering_portrait_FT(scat_port_FT):
    """|B|**2 (reference pptoaslib.py:358-363)."""
    return torch.abs(scat_port_FT) ** 2


def abs_scattering_portrait_FT_deriv(scat_port_FT, scat_port_FT_deriv):
    """d|B|**2/dp = 2 Re(B conj(dB/dp)) (reference pptoaslib.py:365-372)."""
    return 2.0 * torch.real(scat_port_FT * torch.conj(scat_port_FT_deriv))


def abs_scattering_portrait_FT_2deriv(scat_port_FT, scat_port_FT_deriv,
                                      scat_port_FT_2deriv):
    """d2|B|**2/dp_i dp_j = 2 Re(dB_i conj(dB_j) + B conj(d2B_ij))
    (reference pptoaslib.py:374-388)."""
    dBi = scat_port_FT_deriv[:, None]
    dBj = scat_port_FT_deriv[None, :]
    return 2.0 * torch.real(dBi * torch.conj(dBj)
                            + scat_port_FT * torch.conj(scat_port_FT_2deriv))


def scattering_kernel(tau, nu_ref, freqs, nbin, P=1.0, alpha=-4.0):
    """Time-domain one-sided exponential kernels [nchan, nbin], one per
    channel, each of unit sum; tau [sec] at nu_ref (reference
    pplib.py:1098-1119)."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype)
    ts = torch.arange(nbin, dtype=real_dtype, device=freqs.device) \
        * (P / nbin)
    taus = scattering_times(tau, alpha, freqs, nu_ref)
    taus = torch.where(taus == 0.0,
                       torch.full_like(taus, torch.finfo(real_dtype).tiny),
                       taus)
    kern = torch.exp(-ts[None, :] / taus[:, None])
    return kern / kern.sum(dim=-1, keepdim=True)


def add_scattering(port, kernel, repeat=3):
    """Convolve a portrait with a unit-sum time-domain kernel: both tiled
    ``repeat`` times, the tiled kernel renormalized to unit sum, circular
    convolution, the central copy returned (reference
    pplib.py:1121-1144)."""
    port = torch.as_tensor(port, dtype=real_dtype)
    squeeze = port.ndim == 1
    port2 = torch.atleast_2d(port)
    kernel2 = torch.broadcast_to(
        torch.atleast_2d(torch.as_tensor(kernel, dtype=real_dtype,
                                         device=port.device)), port2.shape)
    nbin = port2.shape[-1]
    mid = repeat // 2
    reps = (1,) * (port2.ndim - 1) + (repeat,)
    tiled_d = port2.repeat(*reps)
    tiled_k = kernel2.repeat(*reps)
    tiled_k = tiled_k / tiled_k.sum(dim=-1, keepdim=True)
    conv = torch.fft.irfft(torch.fft.rfft(tiled_d, dim=-1)
                           * torch.fft.rfft(tiled_k, dim=-1),
                           n=repeat * nbin, dim=-1)
    out = conv[..., mid * nbin:(mid + 1) * nbin]
    return out[0] if squeeze else out
