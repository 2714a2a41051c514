"""Gaussian profile/portrait fitters and automatic component seeding.

Port of the JAX package's ``fit/gauss.py`` (reference
pplib.py:1842-2052 ``fit_gaussian_profile``/``fit_gaussian_portrait``
and a non-interactive form of the GaussianSelector GUI's ``auto_gauss``
seeding, ppgauss.py:442-479).  The minimizer is the port's bounded
Levenberg-Marquardt (fit.lm) on ``device`` (None = the CUDA device): the
data are uploaded once per fit and the whole loop runs there.  A portrait
fit gives lm_solve its normal equations from a kernel (``portrait_route``):
with no join groups and tau frozen at 0 (ppgauss's default) from K9
(``GaussNormal``: _kernels.gauss_normal and gauss_sse, csrc/gauss.cu);
scattered (tau nonzero or fitted: ppgauss --fitscat, --fitalpha, --tau)
or joined (ppgauss -j) from K10 (``GaussFtNormal``: _kernels.
gauss_ft_normal and gauss_ft_sse, csrc/gauss_ft.cu), whose packed spectra
need the errors one value a channel (ppgauss's) and join groups that do
not overlap.  The fits neither kernel takes (errors that vary along the
bins, overlapping groups, and on the card more components than a
kernel's limit or a width K10's transforms do not take), and the profile
fits, take ``torch.func.jacfwd`` Jacobians through the vectorized profile
and portrait generators.  ``FIT_ROUTES`` counts the portrait fits by
route.  Seeds and results are host numpy, as in the JAX package.
"""

import numpy as np
import torch

from .. import _kernels
from ..config import resolve_device, wid_max
from ..ops.fourier import get_bin_centers
from ..ops.profiles import (gaussian_profile, gen_gaussian_portrait,
                            gen_gaussian_profile)
from ..utils.databunch import DataBunch
from .lm import lm_solve
from .phase_shift import fit_phase_shift

__all__ = ["fit_gaussian_profile", "fit_gaussian_portrait",
           "auto_gauss_seed", "peak_pick_seed", "dc_seed", "GaussNormal",
           "GaussFtNormal", "portrait_route", "FIT_ROUTES"]

# fit_gaussian_portrait's calls by route: "normal" (kernel K9's normal
# equations), "spectral" (kernel K10's) or "jacfwd" (torch.func's Jacobian
# of the residual)
FIT_ROUTES = {"normal": 0, "spectral": 0, "jacfwd": 0}


def portrait_route(njoin, tau0, tau_flag, ngauss, device, nbin=None,
                   per_channel=True, disjoint=True):
    """The route of a Gaussian portrait fit of ``ngauss`` components over
    ``nbin`` bins on ``device``: "normal" (K9) for an unscattered, unjoined
    fit (no join groups, tau starting at 0 and frozen) of at most
    _kernels.GAUSS_MAX_NGAUSS components on a CUDA device; "spectral" (K10)
    for the other fits, scattered or joined, whose errors are one value a
    channel (``per_channel``) and whose join groups do not overlap
    (``disjoint``), of at most _kernels.GAUSS_FT_MAX_NGAUSS components over
    a width K10's transforms take (_kernels.gauss_ft_takes_bins; None: not
    known to) on a CUDA device; else "jacfwd".  The CPU's plain versions
    have no limit of components or width."""
    cuda = torch.device(device).type == "cuda"
    if not njoin and tau0 == 0.0 and tau_flag == 0.0:
        if cuda and ngauss > _kernels.GAUSS_MAX_NGAUSS:
            return "jacfwd"
        return "normal"
    if not (per_channel and disjoint):
        return "jacfwd"
    if cuda and (ngauss > _kernels.GAUSS_FT_MAX_NGAUSS or nbin is None
                 or not _kernels.gauss_ft_takes_bins(nbin)):
        return "jacfwd"
    return "spectral"


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


class GaussNormal:
    """The unscattered, unjoined Gaussian portrait fit's least-squares
    problem for lm_solve's ``normal=``: data and errs [nchan, nbin] (errs
    kept as a broadcast view when it is per-channel noise), the bin
    centres and freqs held on their device; ``sse(x)`` and
    ``normal(x)`` at parameters x [B, 2 + 6 ngauss + 1] (the scattering
    index last) are kernel K9's two epilogues (_kernels.gauss_sse,
    gauss_normal; their plain versions for CPU tensors).  The fixed
    arguments are checked once, into a _kernels.GaussWork that keeps the
    launches' scratch and gauss_normal's outputs: ``normal(x)``'s
    tensors are overwritten by its next call."""

    def __init__(self, model_code, data, errs, freqs, nu_ref, nbin):
        self.model_code = str(model_code)
        self.data = data.contiguous()
        self.errs = errs if errs.stride(-1) == 0 else errs.contiguous()
        self.freqs = freqs.contiguous()
        self.nu_ref = float(nu_ref)
        self.bins = get_bin_centers(nbin, device=data.device)
        self.ndata = data.numel()
        self.work = _kernels.GaussWork(self.data, self.errs, self.bins,
                                       self.freqs, self.nu_ref,
                                       self.model_code)

    def _args(self, x):
        return (x.contiguous(), self.data, self.errs, self.bins, self.freqs,
                self.nu_ref, self.model_code)

    def sse(self, x):
        return _kernels.gauss_sse(*self._args(x), work=self.work)

    def normal(self, x):
        return _kernels.gauss_normal(*self._args(x), work=self.work)


class GaussFtNormal:
    """The scattered or joined Gaussian portrait fit's least-squares
    problem for lm_solve's ``normal=``: GaussNormal's arguments (errs a
    value a channel, kept as a broadcast view) and the join groups: each
    channel's group [nchan] (-1 outside every group; the groups may not
    overlap), their count and the fold period P (None: 1, as
    ops.fourier.rotate_data takes it).  ``sse(x)`` and ``normal(x)`` at
    parameters x [B, 2 + 6 ngauss + 1 + 2 njoin] (the scattering index,
    then each group's (phase, DM)) are kernel K10's two epilogues
    (_kernels.gauss_ft_sse, gauss_ft_normal; their plain versions for CPU
    tensors).  The fixed arguments are checked once, into a
    _kernels.GaussFtWork that keeps the data's packed spectrum, the
    launches' scratch and gauss_ft_normal's outputs: ``normal(x)``'s
    tensors are overwritten by its next call."""

    def __init__(self, model_code, data, errs, freqs, nu_ref, nbin, groups,
                 njoin, P=None):
        self.model_code = str(model_code)
        self.data = data.contiguous()
        self.errs = errs
        self.freqs = freqs.contiguous()
        self.nu_ref = float(nu_ref)
        self.bins = get_bin_centers(nbin, device=data.device)
        self.groups = torch.as_tensor(np.asarray(groups), dtype=torch.int32,
                                      device=data.device)
        self.njoin = int(njoin)
        self.period = 1.0 if P is None else float(P)
        self.ndata = data.numel()
        self.work = _kernels.GaussFtWork(*self._args(None)[1:])

    def _args(self, x):
        return (None if x is None else x.contiguous(), self.data, self.errs,
                self.bins, self.freqs, self.nu_ref, self.model_code,
                self.groups, self.njoin, self.period)

    def sse(self, x):
        return _kernels.gauss_ft_sse(*self._args(x), work=self.work)

    def normal(self, x):
        return _kernels.gauss_ft_normal(*self._args(x), work=self.work)


def _join_groups(join_ichans, nchan):
    """Each channel's join group [nchan] (-1 outside every group) and
    whether the groups are disjoint (no channel in two)."""
    groups = np.full(nchan, -1, dtype=np.int64)
    count = np.zeros(nchan, dtype=np.int64)
    for j, ichans in enumerate(join_ichans):
        ichans = np.unique(np.asarray(ichans, dtype=np.int64) % nchan)
        groups[ichans] = j
        count[ichans] += 1
    return groups, bool((count <= 1).all())


def fit_gaussian_portrait(model_code, data, init_params, scattering_index,
                          errs, fit_flags, fit_scattering_index, phases,
                          freqs, nu_ref, join_params=(), P=None,
                          quiet=True, device=None):
    """Fit evolving Gaussian components to a portrait.

    init_params = [dc, tau_bins, (loc, dloc, wid, dwid, amp, damp)*n];
    the scattering index rides as an extra trailing parameter (fit when
    ``fit_scattering_index``), and join (phase, DM) pairs append after
    it when ``join_params`` = [join_ichans(x), params, flags] is given.
    lm_solve takes its normal equations from a kernel where
    portrait_route allows: without join groups and with tau starting at 0
    and frozen (the model stays unscattered) from K9 (GaussNormal); a
    scattered or joined fit from K10 (GaussFtNormal), with errors one
    value a channel and disjoint groups; otherwise it differentiates the
    residual with jacfwd.
    Returns DataBunch(fitted_params, fit_errs, scattering_index(+err),
    chi2, dof, nfev, return_code) (numpy / numbers).  Equivalent of pplib.py:1924-2052.
    """
    device = resolve_device(device)
    data = _dev(data, device)
    errs = np.asarray(errs, dtype=np.float64)
    if errs.ndim == 2 and (errs == errs[:, :1]).all():
        # per-channel noise: a value a channel, broadcast over the bins
        errs = np.ascontiguousarray(errs[:, :1])
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

    groups, disjoint = _join_groups(join_ichans, data.shape[0])
    ngauss = (nparam - 2) // 6
    route = portrait_route(njoin, x0[1], xflags[1], ngauss, device,
                           nbin=data.shape[1],
                           per_channel=errs.stride(-1) == 0,
                           disjoint=disjoint)
    normal = None
    if route == "normal":
        normal = GaussNormal(model_code, data, errs, freqs, nu_ref,
                             len(phases))
    elif route == "spectral":
        normal = GaussFtNormal(model_code, data, errs, freqs, nu_ref,
                               len(phases), groups, njoin, P)
    FIT_ROUTES[route] += 1
    r = lm_solve(residual, _dev(x0, device), fit_flags=xflags,
                 bounds=(lo, hi), normal=normal)
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
