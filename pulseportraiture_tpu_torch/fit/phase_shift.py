"""Batched FFTFIT: 1-D phase-shift fit between data and model profiles.

Port of the JAX package's ``fit/phase_shift.py`` (reference
pplib.py:1244-1280 and :2054-2100).  The grid search and
the safeguarded Newton polish run in kernel K2 (``_kernels.fftfit``,
csrc/fftfit.cu) on the card; the spectra before it and the
scale/error/S/N formulas after it are torch.
"""

import math

import torch

from .. import _kernels
from ..config import F0_fact, real_dtype, resolve_device
from ..ops.noise import get_noise
from ..utils.databunch import DataBunch

__all__ = ["fit_phase_shift", "phase_shift_objective", "cross_spectrum"]


def cross_spectrum(data, model, zap_f0=True):
    """rFFT data & model [..., nbin] and form the conjugate
    cross-spectrum d * conj(m); returns (cross, dFFT, mFFT)."""
    dFFT = torch.fft.rfft(data.to(real_dtype), dim=-1)
    mFFT = torch.fft.rfft(model.to(real_dtype), dim=-1)
    if zap_f0:
        dFFT[..., 0] *= F0_fact
        mFFT[..., 0] *= F0_fact
    return dFFT * torch.conj(mFFT), dFFT, mFFT


def phase_shift_objective(phase, cross, err):
    """C(phi) = -Re sum_k cross_k e^{2pi i k phi} / err^2 and its first
    and second derivatives (reference pplib.py:1244-1280)."""
    return _kernels._phase_objective(phase, cross, err ** -2.0)


def _fit_phase_shift_core(data, model, err_t, lo, hi, Ns, newton_iter):
    """FFTFIT of data against model [N, nbin] with time-domain noise
    err_t [N]; the grid + Newton stage is kernel K2."""
    nbin = data.shape[-1]
    cross, dFFT, mFFT = cross_spectrum(data, model)
    err = err_t * math.sqrt(nbin / 2.0)
    inv_err2 = err ** -2.0
    d = torch.sum(dFFT * torch.conj(dFFT), dim=-1).real * inv_err2
    p = torch.sum(mFFT * torch.conj(mFFT), dim=-1).real * inv_err2
    phase, C, d2C = _kernels.fftfit(cross.contiguous(),
                                    inv_err2.contiguous(), lo, hi, Ns,
                                    newton_iter)
    scale = -C / p
    phase_err = torch.abs(scale * d2C) ** -0.5
    scale_err = p ** -0.5
    red_chi2 = (d - (C ** 2 / p)) / (nbin - 2)
    snr = torch.sqrt(scale ** 2 * p)
    return DataBunch(phase=phase, phase_err=phase_err, scale=scale,
                     scale_err=scale_err, snr=snr, red_chi2=red_chi2)


def fit_phase_shift(data, model, noise=None, bounds=(-0.5, 0.5), Ns=100,
                    newton_iter=6, device=None):
    """Fit the phase of ``data`` with respect to ``model`` (batched FFTFIT).

    data/model: [..., nbin] (any leading batch shape; both broadcast);
    noise: time-domain noise level per batch element (get_noise if None);
    bounds: phase search interval; Ns: grid points.  Runs on ``device``
    (None = the CUDA device, config.default_device).

    Returns a DataBunch of tensors with the batch shape: phase [rot] in
    [-0.5, 0.5), phase_err, scale, scale_err, snr, red_chi2.  Positive
    phase means the data profile lags the model.
    """
    device = resolve_device(device)
    data = torch.as_tensor(data, dtype=real_dtype).to(device)
    model = torch.as_tensor(model, dtype=real_dtype).to(device)
    data, model = torch.broadcast_tensors(data, model)
    if noise is None:
        noise = get_noise(data)
    err_t = torch.broadcast_to(
        torch.as_tensor(noise, dtype=real_dtype).to(device), data.shape[:-1])
    batch = data.shape[:-1]
    nbin = data.shape[-1]
    out = _fit_phase_shift_core(
        data.reshape(-1, nbin), model.reshape(-1, nbin),
        err_t.reshape(-1), float(bounds[0]), float(bounds[1]), int(Ns),
        int(newton_iter))
    return DataBunch(**{k: v.reshape(batch) for k, v in out.items()})
