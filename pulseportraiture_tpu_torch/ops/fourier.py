"""Fourier-domain portrait primitives: bin centers, phasors, rotation.

Port of the JAX package's ``ops/fourier.py`` (reference
pplib.py:2338-2575 and pptoaslib.py:181-238), all but its TPU-only
pieces (``rfft_pair``, ``truncate_mantissa``, ``data_operand_hook``).
Conventions are unchanged:

* data ``[..., nchan, nbin]`` with per-channel phase shifts ``[..., nchan]``;
* the phasor argument ``shift * k`` is reduced mod 1 in float64 before
  the trig (k ~ 2048 harmonics times thousands of DM rotations would
  otherwise cost phase precision);
* positive phase/DM rotate data to *earlier* phases (multiplication by
  exp(+2 pi i k shift)).
"""

import math

import torch

from ..config import Dconst, F0_fact, real_dtype

__all__ = ["ipow", "nharm_for", "get_bin_centers", "rfft_portrait",
           "irfft_portrait", "phasor", "apply_phasor", "phase_shifts",
           "phase_shifts_deriv", "rotate_portrait_full", "rotate_data",
           "rotate_profile", "fft_rotate", "add_DM_nu"]

TWO_PI = 2.0 * math.pi


def ipow(x, n):
    """``x ** n`` for a Python int ``n`` by binary exponentiation, with a
    reciprocal for negative ``n`` — the arithmetic the JAX reference's
    ``x ** -2`` / ``x ** -4`` (lax.integer_pow) performs, so both
    packages round the dispersion terms identically."""
    m = abs(int(n))
    acc = None
    while m:
        if m & 1:
            acc = x if acc is None else acc * x
        m >>= 1
        if m:
            x = x * x
    if acc is None:
        acc = x * 0 + 1
    return 1.0 / acc if n < 0 else acc


def nharm_for(nbin):
    """Number of rFFT harmonics for an nbin-bin profile (nbin//2 + 1)."""
    return nbin // 2 + 1


def get_bin_centers(nbin, lo=0.0, hi=1.0, device="cpu"):
    """nbin bin centers with bin edges spanning [lo, hi] (float64).

    Evaluated as start*(1 - i/div) + stop*(i/div) with the endpoint set
    exactly (reference pplib.py:671-684)."""
    diff = hi - lo
    start = lo + diff / (2 * nbin)
    stop = hi - diff / (2 * nbin)
    if nbin == 1:
        return torch.full((1,), start, dtype=real_dtype, device=device)
    div = nbin - 1
    step = torch.arange(div, dtype=real_dtype, device=device) / div
    out = start * (1 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=real_dtype,
                                      device=device)])


def rfft_portrait(port, zap_f0=True):
    """rFFT along the phase axis; the k=0 harmonic is scaled by
    ``F0_fact`` (0: the baseline term is left out of Fourier fits;
    reference pplib.py:64-66)."""
    port_FT = torch.fft.rfft(torch.as_tensor(port).to(real_dtype), dim=-1)
    if zap_f0:
        port_FT[..., 0] *= F0_fact
    return port_FT


def irfft_portrait(port_FT, nbin=None):
    """Inverse rFFT along the phase axis (nbin defaults to 2 (nharm-1))."""
    if nbin is None:
        nbin = 2 * (port_FT.shape[-1] - 1)
    return torch.fft.irfft(port_FT, n=nbin, dim=-1)


def phasor(shifts, nharm, sign=+1.0):
    """exp(sign * 2j*pi * shifts[..., None] * k) for k = 0..nharm-1.

    ``shifts * k`` is reduced mod 1 (floor-mod, like the reference's
    ``%``) in float64 before the trig."""
    shifts = torch.as_tensor(shifts, dtype=real_dtype)
    k = torch.arange(nharm, dtype=real_dtype, device=shifts.device)
    frac = torch.remainder(shifts[..., None] * k, 1.0)
    ang = (TWO_PI * sign) * frac
    return torch.complex(torch.cos(ang), torch.sin(ang))


def apply_phasor(port_FT, shifts):
    """Multiply an rFFT'd portrait [..., nchan, nharm] by the rotation
    phasor for ``shifts`` [..., nchan] (rotations)."""
    return port_FT * phasor(shifts, port_FT.shape[-1])


def _negpow(nu, n):
    """nu ** -n: the reference's integer power for a tensor, its host pow
    for a Python float or numpy value."""
    if isinstance(nu, torch.Tensor):
        return ipow(nu, -n)
    return nu ** -n


def phase_shifts(phi, DM, GM, freqs, nu_DM=math.inf, nu_GM=math.inf, P=None,
                 mod=False):
    """Per-frequency phase delays [rot] for (phi, DM, GM):
    phi + Dconst DM (nu^-2 - nu_DM^-2)/P + Dconst^2 GM (nu^-4 - nu_GM^-4)/P
    (reference pptoaslib.py:181-214).  phi [rot] (or [s] when P is None),
    freqs/nu_DM/nu_GM [MHz], P [s]; ``mod`` wraps |delay| >= 0.5 onto
    [-0.5, 0.5) and is honoured only with P given."""
    if P is None:
        P = 1.0
        mod = False
    freqs = torch.as_tensor(freqs, dtype=real_dtype)
    dispersive = Dconst * DM * (ipow(freqs, -2) - _negpow(nu_DM, 2)) / P
    refractive = (Dconst ** 2) * GM * (ipow(freqs, -4)
                                       - _negpow(nu_GM, 4)) / P
    delays = phi + dispersive + refractive
    if mod:
        delays = torch.where(torch.abs(delays) >= 0.5,
                             torch.remainder(delays, 1.0), delays)
        delays = torch.where(delays >= 0.5, delays - 1.0, delays)
    return delays


def phase_shifts_deriv(freqs, nu_DM=math.inf, nu_GM=math.inf, P=1.0):
    """Gradient of phase_shifts with respect to (phi, DM, GM): [3, nchan]
    (reference pptoaslib.py:216-225; the Hessian is zero)."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype)
    dphi = torch.ones_like(freqs)
    dDM = Dconst * (ipow(freqs, -2) - _negpow(nu_DM, 2)) / P
    dGM = (Dconst ** 2) * (ipow(freqs, -4) - _negpow(nu_GM, 4)) / P
    return torch.stack([dphi, dDM, dGM])


def rotate_portrait_full(port, phi, DM, GM, freqs, nu_DM=math.inf,
                         nu_GM=math.inf, P=None):
    """Rotate a portrait [..., nchan, nbin] by the phi + DM nu^-2 +
    GM nu^-4 phasors (reference pptoaslib.py:52-81)."""
    if P is None:
        P = 1.0
    port = torch.as_tensor(port).to(real_dtype)
    freqs = torch.as_tensor(freqs, dtype=real_dtype, device=port.device)
    port_FT = torch.fft.rfft(port, dim=-1)
    shifts = phase_shifts(phi, DM, GM, freqs, nu_DM, nu_GM, P, mod=False)
    return torch.fft.irfft(apply_phasor(port_FT, shifts), n=port.shape[-1],
                           dim=-1)


def rotate_data(data, phase=0.0, DM=0.0, Ps=None, freqs=None,
                nu_ref=math.inf):
    """Rotate and/or dedisperse data of shape [..., nchan, nbin] or [nbin].

    ``Ps`` may be scalar or [...], ``freqs`` [nchan] or [..., nchan],
    ``nu_ref`` scalar or broadcastable against ``freqs``.  Positive
    phase/DM rotate to earlier phases.  Runs on ``data``'s device."""
    data = torch.as_tensor(data)
    dev = data.device
    if data.ndim == 1:
        if freqs is None:
            return rotate_profile(data, phase)
        P = 1.0 if Ps is None else Ps
        shift = phase + (Dconst * DM / P) * (
            ipow(torch.as_tensor(freqs, dtype=real_dtype, device=dev), -2)
            - _negpow(nu_ref, 2))
        return rotate_profile(data, shift)
    if freqs is None:
        shifts = torch.broadcast_to(
            torch.as_tensor(phase, dtype=real_dtype, device=dev),
            data.shape[:-1])
    else:
        freqs = torch.as_tensor(freqs, dtype=real_dtype, device=dev)
        P = 1.0 if Ps is None else torch.as_tensor(Ps, dtype=real_dtype,
                                                   device=dev)
        if data.ndim > 2 and isinstance(P, torch.Tensor) and P.ndim > 0:
            P = P.reshape(P.shape + (1,) * (data.ndim - 1 - P.ndim))
        D = Dconst * DM / P
        nu_term = _negpow(nu_ref, 2)
        if not isinstance(nu_term, (float, int)):
            nu_term = torch.as_tensor(nu_term, dtype=real_dtype, device=dev)
        shifts = phase + D * (ipow(freqs, -2) - nu_term)
        shifts = torch.broadcast_to(torch.as_tensor(shifts, device=dev),
                                    data.shape[:-1])
    data_FT = torch.fft.rfft(data.to(real_dtype), dim=-1)
    return torch.fft.irfft(apply_phasor(data_FT, shifts), n=data.shape[-1],
                           dim=-1)


def rotate_profile(profile, phase=0.0):
    """Rotate a profile [..., nbin] by phase [rot]; positive = earlier."""
    profile = torch.as_tensor(profile)
    prof_FT = torch.fft.rfft(profile.to(real_dtype), dim=-1)
    phase = torch.as_tensor(phase, dtype=real_dtype, device=profile.device)
    prof_FT = prof_FT * phasor(phase, prof_FT.shape[-1])
    return torch.fft.irfft(prof_FT, n=profile.shape[-1], dim=-1)


def fft_rotate(arr, bins):
    """Rotate ``arr`` [..., nbin] *left* by (possibly fractional) ``bins``:
    the PRESTO-style cross-check of rotate_profile (reference
    pplib.py:2561-2575), ``fft_rotate(arr, b) == rotate_profile(arr,
    b / nbin)``."""
    arr = torch.as_tensor(arr)
    bins = torch.as_tensor(bins, dtype=real_dtype, device=arr.device)
    return rotate_profile(arr, bins / arr.shape[-1])


def add_DM_nu(port, phase=0.0, DM=None, P=None, freqs=None, xs=(-2.0,),
              Cs=(1.0,), nu_ref=math.inf):
    """Rotate a portrait [..., nchan, nbin] by an arbitrary power-law
    dispersion law (reference pplib.py:2509-2546):

        shift = phase + (Dconst DM / P) sum_i C_i (nu^x_i - nu_ref^x_i)

    with ``Cs`` padded with ones up to ``len(xs)``; xs=(-2,), Cs=(1,) is
    plain dedispersion.  The powers are float powers, as in the JAX
    package, so nu_ref = inf with a positive exponent gives inf (and a
    NaN portrait) there as here."""
    port = torch.as_tensor(port).to(real_dtype)
    dev = port.device
    if DM is None or freqs is None:
        shifts = torch.broadcast_to(
            torch.as_tensor(phase, dtype=real_dtype, device=dev),
            port.shape[:-1])
    else:
        freqs = torch.as_tensor(freqs, dtype=real_dtype, device=dev)
        exps = torch.atleast_1d(torch.as_tensor(xs, dtype=real_dtype,
                                                device=dev))
        coefs = torch.atleast_1d(torch.as_tensor(Cs, dtype=real_dtype,
                                                 device=dev))
        coefs = torch.cat([coefs, torch.ones(exps.shape[0] - coefs.shape[0],
                                             dtype=real_dtype, device=dev)])
        nu = torch.as_tensor(nu_ref, dtype=real_dtype, device=dev)
        freq_term = torch.sum(coefs[:, None] * (
            torch.pow(freqs[None, :], exps[:, None])
            - torch.pow(nu, exps[:, None])), dim=0)
        shifts = phase + (Dconst * DM / P) * freq_term
    port_FT = torch.fft.rfft(port, dim=-1)
    return torch.fft.irfft(apply_phasor(port_FT, shifts), n=port.shape[-1],
                           dim=-1)
