"""Off-pulse noise and S/N estimators.

Port of the JAX package's ``ops/noise.py`` (reference
pplib.py:2206-2308) for the "PS" method the pipelines
use: the noise level is the square root of the mean of the top quarter
of the power spectrum, batched over every leading dimension.
"""

import torch

from ..config import real_dtype

__all__ = ["get_noise", "get_noise_PS", "get_SNR"]


def get_noise(data, method="PS", **kwargs):
    """Noise level per leading-batch element of ``data`` [..., nbin]."""
    if method == "PS":
        return get_noise_PS(data, **kwargs)
    raise NotImplementedError(
        "get_noise method '%s' is not yet ported (only 'PS')." % method)


def get_noise_PS(data, frac=4):
    """Noise from the mean of the top 1/frac of the power spectrum
    (reference pplib.py:2227-2253)."""
    data = torch.as_tensor(data).to(real_dtype)
    nbin = data.shape[-1]
    FFT = torch.fft.rfft(data, dim=-1)
    pows = (FFT * torch.conj(FFT)).real / nbin
    npow = pows.shape[-1]
    kc = int((1 - 1.0 / frac) * npow)
    return torch.sqrt(torch.mean(pows[..., kc:], dim=-1))


def get_SNR(prof, fudge=3.25, noise_method="PS"):
    """Lorimer & Kramer S/N with the reference's PSRCHIVE-matching fudge
    (pplib.py:2289-2308).  Assumes the baseline has been removed."""
    prof = torch.as_tensor(prof).to(real_dtype)
    noise = get_noise(prof, method=noise_method)
    Weq = prof.sum(dim=-1) / prof.max(dim=-1).values
    mask = torch.where(Weq <= 0.0, 0.0, 1.0).to(real_dtype)
    Weq = torch.where(Weq <= 0.0, torch.ones_like(Weq), Weq)
    SNR = prof.sum(dim=-1) / (noise * Weq ** 0.5)
    return (SNR * mask) / fudge
