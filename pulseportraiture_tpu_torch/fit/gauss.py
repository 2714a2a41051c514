"""Gaussian profile/portrait fitters and automatic component seeding.

Port of the JAX package's ``fit/gauss.py`` (reference
pplib.py:1842-2052 ``fit_gaussian_profile``/``fit_gaussian_portrait``
and a non-interactive form of the GaussianSelector GUI's ``auto_gauss``
seeding, ppgauss.py:442-479).  The minimizer is the port's bounded
Levenberg-Marquardt (fit.lm) with ``torch.func.jacfwd`` Jacobians through
the vectorized profile and portrait generators, on ``device`` (None = the
CUDA device): the data are uploaded once per fit and the whole loop runs
there.  Seeds and results are host numpy, as in the JAX package.
"""

import numpy as np
import torch

from ..config import resolve_device, wid_max
from ..ops.profiles import (gaussian_profile, gen_gaussian_portrait,
                            gen_gaussian_profile)
from ..utils.databunch import DataBunch
from .lm import lm_solve
from .phase_shift import fit_phase_shift

__all__ = ["fit_gaussian_profile", "fit_gaussian_portrait",
           "auto_gauss_seed", "peak_pick_seed", "dc_seed"]


def _dev(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


def dc_seed(profile):
    """DC-level seed: the 10th-percentile sample of the profile (the
    reference GUI's DCguess, ppgauss.py:419)."""
    profile = np.asarray(profile)
    return float(np.sort(profile)[len(profile) // 10 + 1])


def fit_gaussian_profile(data, init_params, errs, fit_flags=None,
                         fit_scattering=False, quiet=True, device=None):
    """Fit [dc, tau_bins, (loc, wid, amp)*ngauss] to a profile.

    Bounds as the reference: tau >= 0, 0 <= wid <= wid_max, amp >= 0.
    Returns DataBunch(fitted_params, fit_errs, residuals, chi2, dof,
    nfev, return_code) (numpy / numbers).  Equivalent of
    pplib.py:1842-1922.
    """
    device = resolve_device(device)
    data = _dev(data, device)
    nbin = data.shape[-1]
    errs = torch.broadcast_to(_dev(errs, device), data.shape)
    init_params = np.asarray(init_params, dtype=np.float64)
    nparam = len(init_params)
    if fit_flags is None:
        flags = np.ones(nparam)
        flags[1] = float(fit_scattering)
    else:
        # reference semantics: caller flags cover the non-scattering
        # params; tau's flag always comes from fit_scattering
        flags = np.asarray(
            [float(fit_flags[0]), float(fit_scattering)]
            + [float(f) for f in fit_flags[1:nparam - 1]])
    lo = np.full(nparam, -np.inf)
    hi = np.full(nparam, np.inf)
    lo[1] = 0.0
    lo[3::3] = 0.0
    hi[3::3] = wid_max
    lo[4::3] = 0.0

    def residual(x):
        return (data - gen_gaussian_profile(x, nbin, device=device)) / errs

    r = lm_solve(residual, _dev(init_params, device), fit_flags=flags,
                 bounds=(lo, hi))
    residuals = (residual(r.params) * errs).cpu().numpy()
    dof = nbin - int(flags.sum())
    if not quiet:
        print("Multi-Gaussian profile fit: %d gaussians, dof %d, "
              "red chi2 %.2f" % ((nparam - 2) // 3, dof,
                                 float(r.chi2) / max(dof, 1)))
    return DataBunch(fitted_params=r.params.cpu().numpy(),
                     fit_errs=r.param_errs.cpu().numpy(),
                     residuals=residuals, chi2=float(r.chi2), dof=dof,
                     nfev=int(r.nfev), return_code=int(r.return_code))


def fit_gaussian_portrait(model_code, data, init_params, scattering_index,
                          errs, fit_flags, fit_scattering_index, phases,
                          freqs, nu_ref, join_params=(), P=None,
                          quiet=True, device=None):
    """Fit evolving Gaussian components to a portrait.

    init_params = [dc, tau_bins, (loc, dloc, wid, dwid, amp, damp)*n];
    the scattering index rides as an extra trailing parameter (fit when
    ``fit_scattering_index``), and join (phase, DM) pairs append after
    it when ``join_params`` = [join_ichans(x), params, flags] is given.
    Returns DataBunch(fitted_params, fit_errs, scattering_index(+err),
    chi2, dof, nfev, return_code) (numpy / numbers).  Equivalent of pplib.py:1924-2052.
    """
    device = resolve_device(device)
    data = _dev(data, device)
    errs = torch.broadcast_to(_dev(errs, device), data.shape)
    freqs = _dev(freqs, device)
    init_params = np.asarray(init_params, dtype=np.float64)
    nparam = len(init_params)
    flags = np.asarray(fit_flags, dtype=np.float64)[:nparam].copy()

    if len(join_params):
        join_ichans = [np.asarray(ic) for ic in join_params[0]]
        join_vals = np.asarray(join_params[1], dtype=np.float64)
        join_flags = np.asarray(join_params[2], dtype=np.float64)
        njoin = len(join_ichans)
    else:
        join_ichans, join_vals, join_flags, njoin = [], np.array([]), \
            np.array([]), 0

    # full vector: model params + [scattering_index] + join params
    x0 = np.concatenate([init_params, [float(scattering_index)], join_vals])
    xflags = np.concatenate([flags, [float(bool(fit_scattering_index))],
                             join_flags])
    lo = np.full(len(x0), -np.inf)
    hi = np.full(len(x0), np.inf)
    lo[1] = 0.0
    lo[4:nparam:6] = 0.0
    hi[4:nparam:6] = wid_max
    lo[6:nparam:6] = 0.0

    def residual(x):
        mpar = x[:nparam]
        if njoin:
            mpar = torch.cat([mpar, x[nparam + 1:]])
        model = gen_gaussian_portrait(model_code, mpar, x[nparam], phases,
                                      freqs, nu_ref, join_ichans=join_ichans,
                                      P=P, device=device)
        return ((data - model) / errs).reshape(-1)

    r = lm_solve(residual, _dev(x0, device), fit_flags=xflags,
                 bounds=(lo, hi))
    params = r.params.cpu().numpy()
    perrs = r.param_errs.cpu().numpy()
    dof = data.numel() - int(xflags.sum())
    fitted = np.concatenate([params[:nparam], params[nparam + 1:]]) \
        if njoin else params[:nparam]
    fitted_errs = np.concatenate([perrs[:nparam], perrs[nparam + 1:]]) \
        if njoin else perrs[:nparam]
    if not quiet:
        resid = residual(r.params).reshape(data.shape) * errs
        print("Gaussian portrait fit: %d gaussians, dof %d, red chi2 "
              "%.2g, resid std %.3g" % ((nparam - 2) // 6, dof,
                                        float(r.chi2) / max(dof, 1),
                                        float(resid.std())))
    return DataBunch(fitted_params=fitted, fit_errs=fitted_errs,
                     scattering_index=float(params[nparam]),
                     scattering_index_err=float(perrs[nparam]),
                     chi2=float(r.chi2), dof=dof, nfev=int(r.nfev),
                     return_code=int(r.return_code))


def auto_gauss_seed(profile, errs, wid_guess=0.05, tau=0.0,
                    fit_scattering=False, device=None):
    """Single-component automatic seed + fit (the reference GUI's
    auto_gauss mode, ppgauss.py:442-479): amp from the peak, loc from an
    FFTFIT (kernel K2 on the card) against a centered template, DC from
    the 10th percentile.  Returns the fit_gaussian_profile result.
    """
    device = resolve_device(device)
    profile = np.asarray(profile)
    nbin = len(profile)
    dc_guess = dc_seed(profile)
    amp = profile.max()
    first = amp * gaussian_profile(nbin, 0.5, wid_guess, device=device)
    loc = 0.5 + float(fit_phase_shift(
        _dev(profile, device), first,
        noise=errs if np.ndim(errs) == 0 else None, device=device).phase)
    init = [dc_guess, tau, loc % 1.0, wid_guess, amp]
    return fit_gaussian_profile(profile, init, errs,
                                fit_scattering=fit_scattering, device=device)


def peak_pick_seed(profile, errs, max_ngauss=6, snr_stop=5.0, tau=0.0,
                   fit_scattering=False, quiet=True, device=None):
    """Iterative peak-pick-fit-subtract seeding for multi-component
    profiles: add a component at the residual peak with a local-HWHM
    width guess, refit all components, stop when the residual peak drops
    below snr_stop * noise or max_ngauss is reached.  Returns the final
    fit_gaussian_profile result.
    """
    device = resolve_device(device)
    profile = np.asarray(profile, dtype=np.float64)
    nbin = len(profile)
    err_level = float(np.median(np.atleast_1d(np.asarray(errs))))
    dc_guess = dc_seed(profile)
    comps = []
    best = None
    resid = profile - dc_guess
    for _ in range(max_ngauss):
        ipk = int(np.argmax(resid))
        amp = float(resid[ipk])
        if amp < snr_stop * err_level:
            break
        # local half-max width estimate around the peak (circular)
        half = amp / 2.0
        w = 1
        while w < nbin // 2 and (
                resid[(ipk + w) % nbin] > half
                or resid[(ipk - w) % nbin] > half):
            w += 1
        wid = max(2.0 * w / nbin, 1.5 / nbin)
        comps.append([(ipk + 0.5) / nbin, min(wid, wid_max), amp])
        init = [dc_guess, tau] + [v for c in comps for v in c]
        best = fit_gaussian_profile(profile, init, errs,
                                    fit_scattering=fit_scattering,
                                    quiet=quiet, device=device)
        # refine the accepted component list from the fit
        fp = best.fitted_params
        comps = [[fp[2 + 3 * i] % 1.0, fp[3 + 3 * i], fp[4 + 3 * i]]
                 for i in range(len(comps))]
        dc_guess = fp[0]
        model = gen_gaussian_profile(fp, nbin, device=device).cpu().numpy()
        resid = profile - model
    if best is None:
        best = auto_gauss_seed(profile, errs, tau=tau,
                               fit_scattering=fit_scattering, device=device)
    return best
