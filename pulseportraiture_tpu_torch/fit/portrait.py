"""Batched portrait fit of (phi, DM): the wideband TOA/DM measurement.

Port of the JAX package's ``fit/portrait.py`` (reference
pptoaslib.py:390-1096) for the scattering-free fits the
wideband pptoas path runs, fit_flags (1, 1, 0, 0, 0) and (1, 0, 0, 0, 0).

Model: data_FT[n, k] ~ a_n * m_FT[n, k] * exp(2 pi i k phi_n), with
per-channel amplitudes a_n = C_n / S_n maximized analytically, so the
minimized objective is f = -sum_n C_n^2 / S_n.

Design, against the reference's vmapped ``lax.while_loop``:

* The conjugate cross-spectrum d conj(m), truncated to the model's
  harmonic support (``model_kmax``), and S_n = sum |m|^2 / sigma_n^2 are
  formed once per fit in complex128/float64.
* Every evaluation of the objective, gradient and Hessian reduces to
  three per-channel moments (C, T1, T2), computed by kernel K1
  (``_kernels.moments``, csrc/moments.cu) for the subints still being
  solved; the 5x5 algebra on top is torch.
* ``_solve`` is the reference's bounded Levenberg-damped Newton loop
  written as a masked batched Python loop: each iteration gathers the
  lanes that are not done, steps them, and scatters the result back, so
  finished lanes stay frozen exactly as under ``vmap``.  Termination
  codes follow the reference (1 f-converged or plateau, 2 x-converged,
  3 max iterations, 4 damping diverged); ``nfev`` is per lane.  The
  ``done`` test syncs the host once per iteration.
"""

import math

import numpy as np
import torch

from .. import _kernels
from ..config import Dconst, F0_fact, real_dtype, resolve_device
from ..ops.fourier import ipow
from ..ops.noise import get_noise
from ..ops.scattering import scattering_times
from ..utils.databunch import DataBunch
from .smallsolve import inv_refined, solve_refined

__all__ = ["fit_portrait_full", "fit_portrait_full_batch",
           "portrait_objective", "portrait_grad_hess", "get_nu_zeros",
           "model_kmax"]

RESULT_KEYS = ("params", "param_errs", "phi", "phi_err", "DM", "DM_err",
               "GM", "GM_err", "tau", "tau_err", "alpha", "alpha_err",
               "scales", "scale_errs", "nu_DM", "nu_GM", "nu_tau",
               "covariance_matrix", "chi2", "red_chi2", "snr",
               "channel_snrs", "nfeval", "return_code")


def _not_ported(what):
    return NotImplementedError(
        "%s is not yet ported to pulseportraiture_tpu_torch." % what)


def _check_flags(fit_flags):
    flags = tuple(int(bool(fl)) for fl in fit_flags)
    if len(flags) != 5:
        raise ValueError("fit_flags must have 5 entries")
    if flags[2]:
        raise _not_ported("GM (nu**-4 delay) fitting")
    if flags[3] or flags[4]:
        raise _not_ported("scattering (tau/alpha) fitting")
    return flags


# -- per-channel moments and their derivatives ----------------------------

def _phase_shift_derivs(freqs, nu_DM, nu_GM, P):
    """[..., 3, nchan] gradient of the per-channel phase shifts wrt
    (phi, DM, GM); nu_DM, nu_GM, P broadcast against freqs."""
    dphi = torch.ones_like(freqs)
    dDM = Dconst * (ipow(freqs, -2) - ipow(nu_DM, -2)) / P
    dGM = (Dconst ** 2) * (ipow(freqs, -4) - ipow(nu_GM, -4)) / P
    return torch.stack([dphi, dDM, dGM], dim=-2)


def _shifts(params, freqs, P, nu_DM, nu_GM):
    """Per-channel phase shifts [n, nchan] of params [n, 5]."""
    phi, DM, GM = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    return phi + Dconst * DM * (ipow(freqs, -2) - ipow(nu_DM, -2)) / P \
        + (Dconst ** 2) * GM * (ipow(freqs, -4) - ipow(nu_GM, -4)) / P


def _derivs(C, S, T1, T2, pd, flags, per_channel=False):
    """(f, grad [n, 5], H [n, 5, 5] or per channel [n, 5, 5, nchan]) from
    the moments — the reference's portrait_grad_hess algebra with B = 1
    (dS = d2S = 0, so the scattering rows/columns vanish)."""
    n, nchan = C.shape
    ok = S > 0.0  # zero-weight (zapped) channels drop out of all sums
    S = torch.where(ok, S, torch.ones_like(S))
    C = torch.where(ok, C, torch.zeros_like(C))
    zero = torch.zeros_like(C)
    f = -torch.sum(torch.where(ok, C ** 2 / S, zero), dim=-1)
    dC = T1[:, None, :] * pd                              # [n, 3, nchan]
    g3 = -torch.sum(torch.where(ok[:, None], 2.0 * C[:, None] * dC
                                / S[:, None], zero[:, None]), dim=-1)
    safe_C = torch.where(C != 0.0, C, torch.ones_like(C))
    d2C = T2[:, None, None, :] * pd[:, :, None, :] * pd[:, None, :, :]
    Hn3 = -2.0 * (C ** 2 / S)[:, None, None] * (
        d2C / safe_C[:, None, None]
        + dC[:, :, None, :] * dC[:, None, :, :]
        / (safe_C ** 2)[:, None, None])
    Hn3 = torch.where(ok[:, None, None], Hn3, zero[:, None, None])
    flags = torch.as_tensor(flags, dtype=real_dtype, device=C.device)
    grad = torch.zeros((n, 5), dtype=real_dtype, device=C.device)
    grad[:, :3] = g3
    grad = grad * flags
    f3 = flags[:3]
    Hn3 = Hn3 * f3[:, None, None] * f3[None, :, None]
    if per_channel:
        H = torch.zeros((n, 5, 5, nchan), dtype=real_dtype, device=C.device)
        H[:, :3, :3] = Hn3
    else:
        H = torch.zeros((n, 5, 5), dtype=real_dtype, device=C.device)
        H[:, :3, :3] = Hn3.sum(dim=-1)
    return f, grad, H


class _Spectra:
    """One batch's fit operands on the device: the truncated
    cross-spectrum [b, nchan, K] complex128, S [b, nchan], inv_err2,
    freqs [b, nchan], P [b, 1]."""

    def __init__(self, cross, S, inv_err2, freqs, P):
        self.cross, self.S, self.inv_err2 = cross, S, inv_err2
        self.freqs, self.P = freqs, P

    def moments(self, params, nu_DM, nu_GM, lanes=None):
        """(C, S, T1, T2) [n, nchan] at params [n, 5] for subints
        ``lanes`` (all when None); nu_DM/nu_GM are [n, 1]."""
        freqs, P, S = self.freqs, self.P, self.S
        if lanes is not None:
            freqs, P, S = freqs[lanes], P[lanes], S[lanes]
        sh = _shifts(params, freqs, P, nu_DM, nu_GM).contiguous()
        m = _kernels.moments(self.cross, sh, self.inv_err2, lanes)
        return m[..., 0], S, m[..., 1], m[..., 2]

    def grad_hess(self, params, nu_DM, nu_GM, flags, lanes=None,
                  per_channel=False):
        C, S, T1, T2 = self.moments(params, nu_DM, nu_GM, lanes)
        freqs, P = (self.freqs, self.P) if lanes is None else \
            (self.freqs[lanes], self.P[lanes])
        pd = _phase_shift_derivs(freqs, nu_DM, nu_GM, P)   # [n, 3, nchan]
        return _derivs(C, S, T1, T2, pd, flags, per_channel)


# -- JAX-shaped single-fit views (tests, interactive use) ----------------

def _single(params, cross, abs_m2, inv_err2, freqs, P):
    params = torch.as_tensor(params, dtype=real_dtype)
    dev = params.device
    cross = torch.as_tensor(cross).to(dev)
    inv_err2 = torch.as_tensor(inv_err2, dtype=real_dtype).to(dev)
    freqs = torch.as_tensor(freqs, dtype=real_dtype).to(dev)
    S = torch.sum(torch.as_tensor(abs_m2, dtype=real_dtype).to(dev),
                  dim=-1) * inv_err2
    P = torch.as_tensor(P, dtype=real_dtype, device=dev).reshape(1, 1)
    return _Spectra(cross[None].contiguous(), S[None].contiguous(),
                    inv_err2[None].contiguous(), freqs[None], P), params[None]


def _ref(nu, dev):
    return torch.as_tensor(nu, dtype=real_dtype, device=dev).reshape(1, 1)


def _moments(params, cross, abs_m2, inv_err2, freqs, P, nu_DM, nu_GM,
             nu_tau, log10_tau, nbin, order=2, scat=False):
    """Per-channel moments of one subint's objective, shaped like the
    reference's ``_moments``: C, S (order>=0); dC, dS [5, nchan]
    (order>=1); d2C, d2S [5, 5, nchan] (order>=2).  Scattering-free
    branch only."""
    if scat:
        raise _not_ported("the scattering branch of _moments")
    sp, x = _single(params, cross, abs_m2, inv_err2, freqs, P)
    dev = x.device
    nu_DM, nu_GM = _ref(nu_DM, dev), _ref(nu_GM, dev)
    C, S, T1, T2 = sp.moments(x, nu_DM, nu_GM)
    C, S, T1, T2 = C[0], S[0], T1[0], T2[0]
    out = {"C": C, "S": S}
    if order < 1:
        return out
    nchan = C.shape[0]
    pd = _phase_shift_derivs(sp.freqs[0], nu_DM[0], nu_GM[0], sp.P[0])
    zeros2 = torch.zeros((2, nchan), dtype=real_dtype, device=dev)
    out.update(dC=torch.cat([T1[None] * pd, zeros2]),
               dS=torch.zeros((5, nchan), dtype=real_dtype, device=dev))
    if order < 2:
        return out
    d2C = torch.zeros((5, 5, nchan), dtype=real_dtype, device=dev)
    d2C[:3, :3] = T2[None, None] * pd[:, None] * pd[None, :]
    out.update(d2C=d2C, d2S=torch.zeros_like(d2C))
    return out


def portrait_objective(params, cross, abs_m2, inv_err2, freqs, P, nu_DM,
                       nu_GM, nu_tau, log10_tau, nbin, scat=False):
    """f = -sum_n C_n^2/S_n for one subint (reference
    pptoaslib.py:525-542)."""
    m = _moments(params, cross, abs_m2, inv_err2, freqs, P, nu_DM, nu_GM,
                 nu_tau, log10_tau, nbin, order=0, scat=scat)
    C, S = m["C"], m["S"]
    ok = S > 0.0
    safe_S = torch.where(ok, S, torch.ones_like(S))
    return -torch.sum(torch.where(ok, C ** 2 / safe_S, torch.zeros_like(C)))


def portrait_grad_hess(params, cross, abs_m2, inv_err2, freqs, P, nu_DM,
                       nu_GM, nu_tau, fit_flags, log10_tau, nbin,
                       per_channel=False, scat=None):
    """(f, gradient [5], Hessian [5, 5] or [5, 5, nchan]) of one
    subint's objective, flags-masked (reference pptoaslib.py:544-643)."""
    flags = _check_flags(fit_flags)
    if scat:
        raise _not_ported("the scattering branch of portrait_grad_hess")
    sp, x = _single(params, cross, abs_m2, inv_err2, freqs, P)
    f, g, H = sp.grad_hess(x, _ref(nu_DM, x.device), _ref(nu_GM, x.device),
                           flags, per_channel=per_channel)
    return f[0], g[0], H[0]


# -- the solver ------------------------------------------------------------

def _solve(sp, init, nu_DM, nu_GM, flags, lo, hi, max_iter=50):
    """Bounded Levenberg-damped Newton minimization, batched over the
    subints of ``sp``: returns dict x [b, 5], f, nfev, rc (reference
    fit/portrait.py:657-756, one lane per subint)."""
    b = init.shape[0]
    dev = init.device
    flags_t = torch.as_tensor(flags, dtype=real_dtype, device=dev)
    unfit = torch.diag(1.0 - flags_t)
    x = init.clone()
    f, g, H = sp.grad_hess(x, nu_DM, nu_GM, flags)
    mu = torch.full((b,), 1e-4, dtype=real_dtype, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    nfev = torch.ones(b, dtype=torch.int64, device=dev)
    rc = torch.full((b,), 3, dtype=torch.int64, device=dev)
    ftol, xtol, mu_max = 1e-12, 1e-12, 1e12
    for _ in range(max_iter):
        act = torch.nonzero(~done).squeeze(1)
        if act.numel() == 0:  # one host sync per iteration
            break
        xa, fa, ga, Ha, mua = x[act], f[act], g[act], H[act], mu[act]
        scale_d = torch.clamp(torch.abs(torch.diagonal(Ha, dim1=-2,
                                                       dim2=-1)), min=1e-30)
        A = Ha + mua[:, None, None] * torch.diag_embed(scale_d) + unfit
        step = -solve_refined(A, ga)
        trial = torch.minimum(torch.maximum(xa + step, lo), hi)
        ft, gt, Ht = sp.grad_hess(trial, nu_DM[act], nu_GM[act], flags,
                                  lanes=act)
        accept = ft < fa
        new_mu = torch.where(accept, torch.clamp(mua * 0.25, min=1e-14),
                             mua * 4.0)
        x_new = torch.where(accept[:, None], trial, xa)
        f_new = torch.where(accept, ft, fa)
        df = torch.abs(fa - f_new)
        dx = torch.max(torch.abs(x_new - xa), dim=-1).values
        one = torch.ones_like(fa)
        f_conv = accept & (df <= ftol * torch.maximum(torch.abs(f_new), one))
        x_conv = accept & (dx <= xtol * torch.maximum(
            torch.max(torch.abs(x_new), dim=-1).values, one))
        # a rejected, unclipped step whose own first-order model predicts
        # less than ftol of improvement marks the arithmetic floor
        pred_dec = -torch.sum(ga * (trial - xa), dim=-1)
        unclipped = torch.all((xa + step >= lo) & (xa + step <= hi), dim=-1)
        plateau = (~accept) & unclipped & (pred_dec >= 0.0) & \
            (pred_dec <= ftol * torch.maximum(torch.abs(fa), one))
        stuck = (~accept) & (new_mu > mu_max)
        rc_a = torch.where(f_conv | plateau, 1, torch.where(
            x_conv, 2, torch.where(stuck, 4, rc[act])))
        x[act] = x_new
        f[act] = f_new
        g[act] = torch.where(accept[:, None], gt, ga)
        H[act] = torch.where(accept[:, None, None], Ht, Ha)
        mu[act] = new_mu
        done[act] = f_conv | x_conv | plateau | stuck
        rc[act] = rc_a
        nfev[act] += 1
    return {"x": x, "f": f, "nfev": nfev, "rc": rc}


# -- finishing: zero-covariance frequencies, Hessian, covariance ---------

def _guarded_pow(ratio, expn, fallback):
    """ratio**expn where ratio > 0, else ``fallback``."""
    ok = ratio > 0.0
    return torch.where(ok, torch.where(ok, ratio, torch.ones_like(ratio))
                       ** expn, fallback)


def get_nu_zeros(sp, params, nu_DM, nu_GM, nu_tau, fit_flags):
    """Zero-covariance reference frequencies [b] (nu_DM, nu_GM, nu_tau)
    for the batch ``sp`` at params [b, 5]; nu_* are [b, 1].  The phase-DM
    closed form for (1, 1, 0, 0, 0); any other scattering-free
    combination keeps the fit frequencies (reference pptoaslib.py:733-906)."""
    flags = _check_flags(fit_flags)
    nz = [nu_DM[:, 0], nu_GM[:, 0], nu_tau[:, 0]]
    if flags == (1, 1, 0, 0, 0):
        _, _, Hn = sp.grad_hess(params, nu_DM, nu_GM, flags,
                                per_channel=True)
        pd = _phase_shift_derivs(sp.freqs, nu_DM, nu_GM, sp.P)
        H21_n = Hn[:, 0, 1] / pd[:, 1]
        ratio = torch.sum(ipow(sp.freqs, -2) * H21_n, dim=-1) \
            / torch.sum(H21_n, dim=-1)
        nz[0] = _guarded_pow(ratio, -0.5, nu_DM[:, 0])
    return nz


def _hess_with_scales(sp, params, nu_DM, nu_GM, flags):
    """(H5 [b, 5, 5], cross_hess [b, 5, nchan], S, C, scales, ok): the
    Hessian blocks including the per-channel amplitudes (reference
    pptoaslib.py:645-731); H5 excludes the dC dC terms, which the
    amplitude block carries."""
    C, S, T1, T2 = sp.moments(params, nu_DM, nu_GM)
    pd = _phase_shift_derivs(sp.freqs, nu_DM, nu_GM, sp.P)
    ok = S > 0.0
    S = torch.where(ok, S, torch.ones_like(S))
    C = torch.where(ok, C, torch.zeros_like(C))
    zero = torch.zeros_like(C)
    safe_C = torch.where(C != 0.0, C, torch.ones_like(C))
    scales = torch.where(ok, C / S, zero)
    flags_t = torch.as_tensor(flags, dtype=real_dtype, device=C.device)
    d2C = T2[:, None, None, :] * pd[:, :, None, :] * pd[:, None, :, :]
    Hn3 = -2.0 * (C ** 2 / S)[:, None, None] * (d2C
                                                / safe_C[:, None, None])
    Hn3 = torch.where(ok[:, None, None], Hn3, zero[:, None, None])
    f3 = flags_t[:3]
    Hn3 = Hn3 * f3[:, None, None] * f3[None, :, None]
    b, nchan = C.shape
    H5 = torch.zeros((b, 5, 5), dtype=real_dtype, device=C.device)
    H5[:, :3, :3] = Hn3.sum(dim=-1)
    cross_hess = torch.zeros((b, 5, nchan), dtype=real_dtype,
                             device=C.device)
    cross_hess[:, :3] = -2.0 * (T1[:, None, :] * pd) * f3[:, None]
    cross_hess = torch.where(ok[:, None], cross_hess, zero[:, None])
    return H5, cross_hess, S, C, scales, ok


def _covariance_with_scales(H5, cross_hess, S, ifit, ok):
    """Woodbury covariance of (fit params, a_n) jointly (reference
    pptoaslib.py:708-725): cov_fit [b, nfit, nfit], scale_errs [b, nchan]."""
    A = H5[:, ifit][:, :, ifit]
    U = cross_hess[:, ifit]                          # [b, nfit, nchan]
    Cinv = torch.where(ok, 1.0 / (2.0 * S), torch.zeros_like(S))
    X = A - (U * Cinv[:, None, :]) @ U.transpose(-1, -2)
    X_inv = inv_refined(X)
    cov_fit = 2.0 * X_inv
    UtXU_diag = torch.einsum("bfn,bfg,bgn->bn", U, X_inv, U)
    scale_errs = torch.where(
        ok, torch.sqrt(2.0 * (Cinv + Cinv ** 2 * UtXU_diag)),
        torch.full_like(S, math.inf))
    return cov_fit, scale_errs


# -- spectra, the per-chunk fit, the public entry points ------------------

def model_kmax(model_port, tail=1e-18):
    """Harmonic cutoff from a concrete model portrait: the smallest K
    (rounded up to a multiple of 128, capped at nharm) such that the model
    power in harmonics >= K is below ``tail`` of the total (reference
    fit/portrait.py:759).  Host numpy; None for an all-zero model."""
    m = model_port
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
    m = np.asarray(m)
    while m.ndim > 2:
        m = m[0]
    mFT = np.fft.rfft(m.reshape(-1, m.shape[-1]), axis=-1)
    mFT[:, 0] = 0.0
    p = np.abs(mFT) ** 2
    tot = p.sum()
    if tot == 0.0:
        return None
    tail_power = np.cumsum(p.sum(axis=0)[::-1])[::-1]
    above = np.flatnonzero(tail_power > tail * tot)
    K = int(above[-1]) + 2 if len(above) else 1
    nharm = p.shape[-1]
    return min(-(-K // 128) * 128, nharm)


def _scat_hint(fit_flags, init_params, log10_tau):
    """May the scattering kernel differ from 1?  True when tau/alpha are
    fitted or a fixed tau is nonzero (reference fit/portrait.py:632)."""
    if fit_flags[3] or fit_flags[4]:
        return True
    if isinstance(init_params, torch.Tensor):
        init_params = init_params.detach().cpu().numpy()
    tau0 = np.asarray(init_params)[..., 3]
    if log10_tau:
        return not np.all(np.isneginf(tau0))
    return bool(np.any(tau0 != 0.0))


def _spectra(data, model, inv_err2, kmax, sub=64):
    """(cross [b, nchan, K], abs_m2 [b or 1, nchan, K], Sd [b]) from data
    [b, nchan, nbin] and model [nchan, nbin] or [b, nchan, nbin], with the
    DC harmonic weighted by F0_fact.  The full-nharm data spectra exist
    for ``sub`` subints at a time only."""
    def rfft0(x):
        X = torch.fft.rfft(x, dim=-1)
        X[..., 0] *= F0_fact
        return X

    shared = model.ndim == 2
    if shared:
        mFFT = rfft0(model)[None]
    crosses, Sds, absm = [], [], []
    for i in range(0, data.shape[0], sub):
        dFFT = rfft0(data[i:i + sub])
        w = inv_err2[i:i + sub]
        Sds.append(torch.sum(torch.abs(dFFT) ** 2 * w[..., None],
                             dim=(-2, -1)))
        m = mFFT if shared else rfft0(model[i:i + sub])
        dK, mK = dFFT[..., :kmax], m[..., :kmax]
        crosses.append(dK * torch.conj(mK))
        if not shared:
            absm.append(torch.abs(mK) ** 2)
        del dFFT
    abs_m2 = torch.abs(mFFT[..., :kmax]) ** 2 if shared else \
        torch.cat(absm)
    return torch.cat(crosses).contiguous(), abs_m2, torch.cat(Sds)


def _fit_chunk(data, model, init, P, freqs, errs, weights, nu_fits,
               nu_outs, nu_outs_mask, flags, lo, hi, max_iter, kmax,
               log10_tau):
    """The batched fit of one chunk; every argument is a device tensor
    with the chunk's leading batch dimension (model may be shared)."""
    b, nchan, nbin = data.shape
    ifit = np.flatnonzero(np.asarray(flags))
    nfit = len(ifit)
    errs_FT = errs * math.sqrt(nbin / 2.0)
    wmask = weights > 0.0
    inv_err2 = torch.where(wmask, errs_FT ** -2.0,
                           torch.zeros_like(errs_FT)).contiguous()
    nchan_ok = wmask.sum(dim=-1)
    dof = nbin * nchan_ok - (nfit + nchan_ok)
    cross, abs_m2, Sd = _spectra(data, model, inv_err2, kmax)
    S = (torch.sum(abs_m2, dim=-1) * inv_err2).contiguous()
    sp = _Spectra(cross, S, inv_err2, freqs, P[:, None])

    wok = wmask.to(real_dtype)
    fq_mean = (freqs * wok).sum(-1) / torch.clamp(wok.sum(-1), min=1.0)
    nu_fit = [torch.where(torch.isnan(nu_fits[:, i]), fq_mean,
                          nu_fits[:, i])[:, None] for i in range(3)]
    sol = _solve(sp, init, nu_fit[0], nu_fit[1], flags, lo, hi, max_iter)
    x = sol["x"]
    phi_fit, DM_fit, GM_fit, tau_fit, alpha_fit = (x[:, i] for i in range(5))

    nz = get_nu_zeros(sp, x, nu_fit[0], nu_fit[1], nu_fit[2], flags)
    nu_out = [nu_outs[:, i] if nu_outs_mask[i] else nz[i] for i in range(3)]
    if flags[1]:  # phi references one frequency (is_toa)
        nu_out[1] = nu_out[0]
    phi_inf = phi_fit - (Dconst / P) * DM_fit * ipow(nu_fit[0][:, 0], -2) \
        - (Dconst ** 2 / P) * GM_fit * ipow(nu_fit[1][:, 0], -4)
    phi_out = phi_inf + (Dconst / P) * DM_fit * ipow(nu_out[0], -2) \
        + (Dconst ** 2 / P) * GM_fit * ipow(nu_out[1], -4)
    phi_out = torch.where(torch.abs(phi_out) >= 0.5,
                          torch.remainder(phi_out, 1.0), phi_out)
    phi_out = torch.where(phi_out >= 0.5, phi_out - 1.0, phi_out)
    tau_lin = 10.0 ** tau_fit if log10_tau else tau_fit
    tau_out = scattering_times(tau_lin, alpha_fit, nu_out[2],
                               nu_fit[2][:, 0])
    if log10_tau:
        tau_out = torch.log10(tau_out)
    params_out = torch.stack([phi_out, DM_fit, GM_fit, tau_out, alpha_fit],
                             dim=1)

    H5, cross_hess, S_ok, C, scales, ok = _hess_with_scales(
        sp, params_out, nu_out[0][:, None], nu_out[1][:, None], flags)
    cov_fit, scale_errs = _covariance_with_scales(
        H5, cross_hess, S_ok, torch.as_tensor(ifit, device=data.device), ok)
    param_errs = torch.zeros((b, 5), dtype=real_dtype, device=data.device)
    param_errs[:, ifit] = torch.sqrt(torch.diagonal(cov_fit, dim1=-2,
                                                    dim2=-1))
    channel_snrs = scales * torch.sqrt(S_ok)
    snr = torch.sqrt(torch.sum(channel_snrs ** 2, dim=-1))
    chi2 = Sd + sol["f"]
    red_chi2 = chi2 / dof
    return dict(
        params=params_out, param_errs=param_errs,
        phi=phi_out, phi_err=param_errs[:, 0],
        DM=DM_fit, DM_err=param_errs[:, 1],
        GM=GM_fit, GM_err=param_errs[:, 2],
        tau=tau_out, tau_err=param_errs[:, 3],
        alpha=alpha_fit, alpha_err=param_errs[:, 4],
        scales=scales, scale_errs=scale_errs,
        nu_DM=nu_out[0], nu_GM=nu_out[1], nu_tau=nu_out[2],
        covariance_matrix=cov_fit, chi2=chi2, red_chi2=red_chi2,
        snr=snr, channel_snrs=channel_snrs,
        nfeval=sol["nfev"], return_code=sol["rc"])


def _per_batch(value, B, device, fill=math.nan):
    """None / scalar / [B] -> [B] f64 tensor on ``device``."""
    if value is None:
        value = fill
    return torch.broadcast_to(_to_dev(value, device), (B,))


def _to_dev(x, device):
    """numpy / scalar / tensor -> float64 tensor on ``device`` (read-only
    numpy views, e.g. broadcasts, are copied first)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=real_dtype)
    arr = np.asarray(x, dtype=np.float64)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _batch_stride(a):
    return a.stride(0) if isinstance(a, torch.Tensor) else a.strides[0]


def fit_portrait_full_batch(data_ports, model_ports, init_params, Ps,
                            freqs, errs=None, weights=None,
                            fit_flags=(1, 1, 0, 0, 0),
                            nu_fits=(None, None, None),
                            nu_outs=(None, None, None), bounds=None,
                            log10_tau=True, max_iter=50, kmax=None,
                            scan_size=None, pad_to=None, device=None):
    """Batched (phi, DM) portrait fit over subints: data [B, nchan, nbin].

    model_ports [nchan, nbin] (shared; also a 3-D array whose rows are one
    broadcast view) or [B, nchan, nbin]; init_params [5] or [B, 5];
    Ps [B] or scalar; freqs [nchan] or [B, nchan]; errs/weights
    [B, nchan] (noise measured, all weights 1 when None); nu_fits a
    3-tuple of None/scalars/[B] arrays or a [B, 3] array (None/NaN = the
    weighted mean frequency); nu_outs a 3-tuple (None = zero-covariance
    frequency).  fit_flags must be scattering- and GM-free.
    ``scan_size`` fits the batch in chunks of that many subints and
    ``pad_to`` is accepted for interface parity; neither changes the
    results.  Runs on ``device`` (None = the CUDA device).

    Returns a DataBunch of stacked per-subint result tensors on
    ``device`` (fields as the reference's fit_portrait_full): params,
    param_errs, phi(_err), DM(_err), GM(_err), tau(_err), alpha(_err),
    scales, scale_errs, nu_DM, nu_GM, nu_tau, covariance_matrix, chi2,
    red_chi2, snr, channel_snrs, nfeval, return_code.
    """
    del pad_to  # bucketing exists for compiled programs; eager needs none
    device = resolve_device(device)
    flags = _check_flags(fit_flags)
    if init_params is None:
        raise _not_ported("in-graph phase seeding (init_params=None)")
    if _scat_hint(flags, init_params, log10_tau):
        raise _not_ported("fits with a fixed nonzero scattering time")
    if getattr(model_ports, "ndim", 0) == 3 and (
            model_ports.shape[0] == 1 or _batch_stride(model_ports) == 0):
        model_ports = model_ports[0]  # one model broadcast over the batch
    if kmax is None:
        kmax = model_kmax(model_ports)
    data = _to_dev(data_ports, device)
    B, nchan, nbin = data.shape
    if kmax is None:
        kmax = nbin // 2 + 1
    model = _to_dev(model_ports, device)
    if model.ndim == 3 and model.shape[0] == 1:
        model = model[0]
    elif model.ndim == 3 and model.shape[0] != B:
        model = torch.broadcast_to(model, data.shape)
    freqs = torch.broadcast_to(_to_dev(freqs, device), (B, nchan))
    P = _per_batch(Ps, B, device)
    init = torch.broadcast_to(_to_dev(init_params, device), (B, 5)).clone()
    if errs is None:
        errs = get_noise(data)
    errs = torch.broadcast_to(_to_dev(errs, device), (B, nchan))
    if weights is None:
        weights = torch.ones((B, nchan), dtype=real_dtype, device=device)
    weights = torch.broadcast_to(_to_dev(weights, device), (B, nchan))
    if nu_fits is None or isinstance(nu_fits, (tuple, list)):
        nu_fits = (None, None, None) if nu_fits is None else nu_fits
        nu_fits_b = torch.stack([_per_batch(nf, B, device)
                                 for nf in nu_fits], dim=1)
    else:
        nu_fits_b = torch.broadcast_to(_to_dev(nu_fits, device), (B, 3))
    if nu_outs is None:
        nu_outs = (None, None, None)
    if isinstance(nu_outs, (tuple, list)):
        nu_outs_mask = tuple(nu is not None for nu in nu_outs)
        nu_outs_b = torch.stack([_per_batch(nu, B, device, 0.0)
                                 for nu in nu_outs], dim=1)
    else:
        nu_outs_mask = (True, True, True)
        nu_outs_b = torch.broadcast_to(_to_dev(nu_outs, device), (B, 3))
    if bounds is None:
        lo = torch.full((5,), -math.inf, dtype=real_dtype, device=device)
        hi = torch.full((5,), math.inf, dtype=real_dtype, device=device)
    else:
        lo = torch.tensor([-math.inf if bd[0] is None else float(bd[0])
                           for bd in bounds], dtype=real_dtype,
                          device=device)
        hi = torch.tensor([math.inf if bd[1] is None else float(bd[1])
                           for bd in bounds], dtype=real_dtype,
                          device=device)
    chunk = B if scan_size is None else max(1, int(scan_size))
    outs = []
    for i in range(0, B, chunk):
        s = slice(i, i + chunk)
        outs.append(_fit_chunk(
            data[s], model if model.ndim == 2 else model[s], init[s], P[s],
            freqs[s], errs[s], weights[s], nu_fits_b[s], nu_outs_b[s],
            nu_outs_mask, flags, lo, hi, int(max_iter), int(kmax),
            bool(log10_tau)))
    if len(outs) == 1:
        return DataBunch(**outs[0])
    return DataBunch(**{k: torch.cat([o[k] for o in outs])
                        for k in RESULT_KEYS})


def fit_portrait_full(data_port, model_port, init_params, P, freqs,
                      nu_fits=(None, None, None),
                      nu_outs=(None, None, None), errs=None, weights=None,
                      fit_flags=(1, 1, 0, 0, 0), bounds=None,
                      log10_tau=True, max_iter=50, kmax=None, device=None):
    """Fit (phi, DM) between one data and model portrait [nchan, nbin]:
    the single-subint view of fit_portrait_full_batch (reference
    pptoaslib.py:928-1096).  Returns a DataBunch of result tensors."""
    data = torch.as_tensor(data_port, dtype=real_dtype)[None]
    nchan = data.shape[1]
    # unset fit frequencies default to the plain mean of the channels
    fmean = float(torch.as_tensor(freqs, dtype=real_dtype).mean())
    nu_fits = tuple(fmean if nf is None else nf for nf in nu_fits)
    out = fit_portrait_full_batch(
        data, model_port, init_params, P, freqs,
        errs=None if errs is None else torch.broadcast_to(
            torch.as_tensor(errs, dtype=real_dtype), (nchan,))[None],
        weights=None if weights is None else torch.as_tensor(
            weights, dtype=real_dtype)[None],
        fit_flags=fit_flags, nu_fits=tuple(nu_fits),
        nu_outs=tuple(nu_outs), bounds=bounds, log10_tau=log10_tau,
        max_iter=max_iter, kmax=kmax, device=device)
    return DataBunch(**{k: v[0] for k, v in out.items()})
