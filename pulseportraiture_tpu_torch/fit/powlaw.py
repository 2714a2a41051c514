"""Spectral fits: power-law flux fit and DM-from-residuals fit.

Port of the JAX package's ``fit/powlaw.py`` (reference
pplib.py:1763-1840 ``fit_powlaw`` via lmfit and ``fit_DM_to_freq_resids``
via np.polyfit, and the GM <-> DMc discrete-cloud conversions
pptoaslib.py:83-110).  ``fit_powlaw`` runs the port's Levenberg-Marquardt
(fit.lm) on ``device``; the linear fit is host numpy.
"""

import numpy as np
import torch

from ..config import Dconst, resolve_device
from ..ops.powlaw import powlaw
from ..utils.databunch import DataBunch
from .lm import lm_solve

__all__ = ["fit_powlaw", "fit_DM_to_freq_resids", "GM_from_DMc",
           "DMc_from_GM"]


def fit_powlaw(data, init_params, errs, freqs, nu_ref, device=None):
    """Fit amp * (freqs/nu_ref)**alpha to data with uncertainties errs.

    Returns DataBunch(amp, amp_err, alpha, alpha_err, residuals, nu_ref,
    chi2, dof, red_chi2) as the reference's lmfit result surface
    (pplib.py:1763-1802).  Runs on ``device`` (None = the CUDA device).
    """
    device = resolve_device(device)
    data = torch.as_tensor(np.asarray(data, dtype=np.float64), device=device)
    errs = torch.broadcast_to(torch.as_tensor(
        np.asarray(errs, dtype=np.float64), device=device), data.shape)
    freqs = torch.as_tensor(np.asarray(freqs, dtype=np.float64),
                            device=device)

    def residual(x):
        return (data - powlaw(freqs, nu_ref, x[0], x[1])) / errs

    r = lm_solve(residual, torch.as_tensor(
        np.asarray(init_params, dtype=np.float64), device=device))
    residuals = (residual(r.params) * errs).cpu().numpy()
    ndata = int(r.ndata)
    return DataBunch(amp=float(r.params[0]), amp_err=float(r.param_errs[0]),
                     alpha=float(r.params[1]),
                     alpha_err=float(r.param_errs[1]),
                     residuals=residuals, nu_ref=nu_ref,
                     chi2=float(r.chi2), dof=ndata - 2,
                     red_chi2=float(r.chi2) / max(ndata - 2, 1))


def fit_DM_to_freq_resids(freqs, frequency_residuals, errs):
    """Weighted linear fit res = Dconst*DM*nu**-2 + offset; also returns
    the implied zero-crossing frequency nu_ref = (-b/a)**-0.5
    (reference pplib.py:1804-1840; np.polyfit with cov=True, so the
    covariance is scaled by the reduced chi2).  Host numpy."""
    freqs = np.asarray(freqs, dtype=np.float64)
    y = np.asarray(frequency_residuals, dtype=np.float64)
    errs = np.asarray(errs, dtype=np.float64)
    x = freqs ** -2
    p, V = np.polyfit(x=x, y=y, deg=1, w=errs ** -2, cov=True)
    a, b = p
    DM = a / Dconst
    nu_ref = (-b / a) ** -0.5 if -b / a > 0 else np.nan
    a_err, b_err = np.sqrt(np.diag(V))
    cov = V.ravel()[1]
    nu_ref_err = np.sqrt(np.abs(
        (nu_ref ** 2 / 4.0) * ((a_err / a) ** 2 + (b_err / b) ** 2
                               - 2 * cov / (a * b)))) \
        if np.isfinite(nu_ref) else np.nan
    residuals = y - (a * x + b)
    chi2 = float(np.sum((residuals / errs) ** 2))
    dof = len(y) - 2
    return DataBunch(DM=DM, DM_err=a_err / Dconst, offset=b,
                     offset_err=b_err, nu_ref=nu_ref,
                     nu_ref_err=nu_ref_err, ab_cov=cov,
                     residuals=residuals, chi2=chi2, dof=dof,
                     red_chi2=chi2 / max(dof, 1))


# speed of light in [cm/s] over [cm/kpc]: kpc -> light-travel conversion
_C_KPC = 3e10 / 3.1e21


def GM_from_DMc(DMc, D, a_perp):
    """Geometric delay factor GM of a discrete cloud of dispersion
    measure DMc [cm**-3 pc] at distance D [kpc] with transverse scale
    a_perp [AU] (Lam et al. 2016; reference pptoaslib.py:83-96)."""
    return DMc ** 2 * (_C_KPC * D) / (2.0 * (a_perp * 4.8e-9) ** 2)


def DMc_from_GM(GM, D, a_perp):
    """Inverse of GM_from_DMc.  The reference's expression
    (pptoaslib.py:98-110) does not square a_perp and so does not invert
    its own GM_from_DMc; this is the exact inverse, as in the JAX
    package."""
    return (GM * 2.0 * (a_perp * 4.8e-9) ** 2 / (_C_KPC * D)) ** 0.5
