"""Batched 5-parameter portrait fit: (phi, DM, GM, tau, alpha).

Port of the JAX package's ``fit/portrait.py`` (reference
pptoaslib.py:390-1096 and pplib.py:1282-1391, 2102-2204): the wideband
TOA/DM measurement with nu**-4 (GM) delays and a scattering law
tau(nu) = tau (nu/nu_tau)**alpha.

Model: data_FT[n, k] ~ a_n * B_n[k] * m_FT[n, k] * exp(2 pi i k phi_n),
B_n[k] = 1 / (1 + 2 pi i k tau_n), with per-channel amplitudes a_n =
C_n / S_n maximized analytically, so the minimized objective is
f = -sum_n C_n^2 / S_n.

Design, against the reference's vmapped ``lax.while_loop``:

* The conjugate cross-spectrum d conj(m) and |m|^2, truncated to the
  model's harmonic support (``model_kmax``), are formed once per fit in
  complex128/float64.
* Every evaluation of the objective, gradient and Hessian reduces to a
  few per-channel harmonic sums.  Without scattering (B = 1: no tau/alpha
  fit and a zero tau) they are (C, T1, T2), from kernel K1
  (``_kernels.moments``, csrc/moments.cu); with scattering they are the
  nine sums of kernel K3 (``_kernels.moments_scat``,
  csrc/moments_scat.cu).  The (tau, alpha) chain rule and the 5x5 algebra
  on top are torch, for the subints still being solved.
* ``_solve`` is the reference's bounded Levenberg-damped Newton loop
  written as a masked batched Python loop: each iteration gathers the
  lanes that are not done, steps them, and scatters the result back, so
  finished lanes stay frozen exactly as under ``vmap``.  Termination
  codes follow the reference (1 f-converged or plateau, 2 x-converged,
  3 max iterations, 4 damping diverged); ``nfev`` is per lane.  The
  ``done`` test syncs the host once per iteration.
* The zero-covariance frequencies of the flag sets whose closed form is
  a polynomial root ((1,1,1,0,0), (1,1,1,1,0)) are found on the host
  with ``np.roots``: one transfer per batch.
* ``init_params=None`` seeds the phases from live-channel band-average
  profiles through kernel K2 (``fit.phase_shift``), as the reference's
  in-graph seeding does.
"""

import math

import numpy as np
import torch

from .. import _kernels
from ..config import Dconst, F0_fact, real_dtype, resolve_device
from ..debug import check_fit_result
from ..ops.fourier import ipow
from ..ops.noise import get_noise
from ..ops.scattering import (scattering_times, scattering_times_2deriv,
                              scattering_times_deriv)
from ..utils.databunch import DataBunch
from .smallsolve import inv_refined, solve_refined

__all__ = ["fit_portrait_full", "fit_portrait_full_batch", "fit_portrait",
           "get_scales_full", "get_scales", "portrait_objective",
           "portrait_grad_hess", "get_nu_zeros", "model_kmax"]

RESULT_KEYS = ("params", "param_errs", "phi", "phi_err", "DM", "DM_err",
               "GM", "GM_err", "tau", "tau_err", "alpha", "alpha_err",
               "scales", "scale_errs", "nu_DM", "nu_GM", "nu_tau",
               "covariance_matrix", "chi2", "red_chi2", "snr",
               "channel_snrs", "nfeval", "return_code")


def _check_flags(fit_flags):
    flags = tuple(int(bool(fl)) for fl in fit_flags)
    if len(flags) != 5:
        raise ValueError("fit_flags must have 5 entries")
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


def _tau_lin(tau_p, log10_tau):
    return 10.0 ** tau_p if log10_tau else tau_p


def _derivs(C, S, T1, T2, pd, flags, per_channel=False):
    """(f, grad [n, 5], H [n, 5, 5] or per channel [n, 5, 5, nchan]) from
    K1's moments — the reference's portrait_grad_hess algebra with B = 1
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


def _derivs_full(m, flags, per_channel=False):
    """(f, grad [n, 5], H [n, 5, 5] or [n, 5, 5, nchan]) from full moments
    (C, S [n, nchan]; dC, dS [n, 5, nchan]; d2C, d2S [n, 5, 5, nchan]):
    the reference's portrait_grad_hess algebra (:339-373), term for
    term."""
    C, S, dC, dS, d2C, d2S = (m[k] for k in ("C", "S", "dC", "dS", "d2C",
                                             "d2S"))
    ok = S > 0.0
    S = torch.where(ok, S, torch.ones_like(S))
    C = torch.where(ok, C, torch.zeros_like(C))
    zero = torch.zeros_like(C)
    f = -torch.sum(torch.where(ok, C ** 2 / S, zero), dim=-1)
    Cb, Sb = C[:, None], S[:, None]
    grad = -torch.sum(torch.where(ok[:, None], 2.0 * Cb * dC / Sb
                                  - (Cb ** 2) * dS / Sb ** 2,
                                  zero[:, None]), dim=-1)
    flags_t = torch.as_tensor(flags, dtype=real_dtype, device=C.device)
    grad = grad * flags_t
    safe_C = torch.where(C != 0.0, C, torch.ones_like(C))
    sC, Sq = safe_C[:, None, None], S[:, None, None]
    dCi, dCj = dC[:, :, None], dC[:, None, :]
    dSi, dSj = dS[:, :, None], dS[:, None, :]
    Hn = -2.0 * (C ** 2 / S)[:, None, None] * (
        d2C / sC - 0.5 * d2S / Sq + dCi * dCj / sC ** 2
        + dSi * dSj / Sq ** 2 - (dCi * dSj + dSi * dCj) / (sC * Sq))
    Hn = torch.where(ok[:, None, None], Hn, zero[:, None, None])
    Hn = Hn * flags_t[:, None, None] * flags_t[None, :, None]
    return f, grad, (Hn if per_channel else Hn.sum(dim=-1))


def _take(nus, lanes):
    return nus if lanes is None else tuple(nu[lanes] for nu in nus)


class _Spectra:
    """One batch's fit operands on the device: the truncated
    cross-spectrum [b, nchan, K] complex128, |m|^2 [1 or b, nchan, K],
    S [b, nchan] (B = 1), inv_err2, freqs [b, nchan], P [b, 1]; ``scat``
    selects the scattering moments (K3) over the B = 1 ones (K1)."""

    def __init__(self, cross, abs_m2, S, inv_err2, freqs, P, scat=False,
                 log10_tau=False):
        self.cross, self.abs_m2, self.S = cross, abs_m2, S
        self.inv_err2, self.freqs, self.P = inv_err2, freqs, P
        self.scat, self.log10_tau = bool(scat), bool(log10_tau)

    def _rows(self, lanes):
        if lanes is None:
            return self.freqs, self.P, self.S
        return self.freqs[lanes], self.P[lanes], self.S[lanes]

    def moments(self, params, nus, lanes=None):
        """K1: (C, S, T1, T2) [n, nchan] at params [n, 5] for subints
        ``lanes`` (all when None); nus = (nu_DM, nu_GM, nu_tau) [n, 1]."""
        freqs, P, S = self._rows(lanes)
        sh = _shifts(params, freqs, P, nus[0], nus[1]).contiguous()
        m = _kernels.moments(self.cross, sh, self.inv_err2, lanes)
        return m[..., 0], S, m[..., 1], m[..., 2]

    def moments_scat(self, params, nus, lanes=None):
        """K3: ({sum name: [n, nchan]}, taus [n, nchan], tau [n, 1])."""
        freqs, P, _ = self._rows(lanes)
        sh = _shifts(params, freqs, P, nus[0], nus[1]).contiguous()
        tau = _tau_lin(params[:, 3:4], self.log10_tau)
        taus = scattering_times(tau, params[:, 4:5], freqs, nus[2])
        m = _kernels.moments_scat(self.cross, self.abs_m2, sh,
                                  taus.contiguous(), self.inv_err2, lanes)
        return dict(zip(_kernels.MOMENTS_SCAT_SUMS, m.unbind(-1))), taus, tau

    def evaluate(self, params, nus, lanes=None, order=2):
        """The reference's ``_moments`` for a batch: C, S [n, nchan]
        (order >= 0); dC, dS [n, 5, nchan] (order >= 1); d2C, d2S
        [n, 5, 5, nchan] (order >= 2)."""
        freqs, P, _ = self._rows(lanes)
        if self.scat:
            s, taus, tau = self.moments_scat(params, nus, lanes)
            C, S, T1, T2 = s["C"], s["S"], s["T1"], s["T2"]
        else:
            C, S, T1, T2 = self.moments(params, nus, lanes)
        out = {"C": C, "S": S}
        if order < 1:
            return out
        pd = _phase_shift_derivs(freqs, nus[0], nus[1], P)   # [n, 3, nchan]
        if self.scat:
            taus_d = scattering_times_deriv(tau, freqs, nus[2],
                                            self.log10_tau, taus)
            td = taus_d.movedim(0, 1)                          # [n, 2, nchan]
            dC = torch.cat([T1[:, None] * pd, td * s["Q0"][:, None]], 1)
            dS = torch.cat([torch.zeros_like(pd), td * s["S1"][:, None]], 1)
        else:
            dC = torch.cat([T1[:, None] * pd, torch.zeros_like(pd[:, :2])], 1)
            dS = torch.zeros_like(dC)
        out.update(dC=dC, dS=dS)
        if order < 2:
            return out
        n, _, nchan = dC.shape
        d2C = dC.new_zeros((n, 5, 5, nchan))
        d2C[:, :3, :3] = T2[:, None, None] * pd[:, :, None] * pd[:, None, :]
        d2S = torch.zeros_like(d2C)
        if self.scat:
            taus_2d = scattering_times_2deriv(
                tau, freqs, nus[2], self.log10_tau, taus,
                taus_d).movedim(2, 0)                       # [n, 2, 2, nchan]
            cross_CV = pd[:, :, None] * (td * s["Q1"][:, None])[:, None]
            d2C[:, :3, 3:] = cross_CV
            d2C[:, 3:, :3] = cross_CV.transpose(1, 2)
            tdd = td[:, :, None] * td[:, None, :]
            d2C[:, 3:, 3:] = tdd * s["W2"][:, None, None] \
                + taus_2d * s["Q0"][:, None, None]
            d2S[:, 3:, 3:] = tdd * s["S2"][:, None, None] \
                + taus_2d * s["S1"][:, None, None]
        out.update(d2C=d2C, d2S=d2S)
        return out

    def grad_hess(self, params, nus, flags, lanes=None, per_channel=False):
        if self.scat:
            return _derivs_full(self.evaluate(params, nus, lanes), flags,
                                per_channel)
        C, S, T1, T2 = self.moments(params, nus, lanes)
        freqs, P, _ = self._rows(lanes)
        pd = _phase_shift_derivs(freqs, nus[0], nus[1], P)   # [n, 3, nchan]
        return _derivs(C, S, T1, T2, pd, flags, per_channel)


# -- JAX-shaped single-fit views (tests, interactive use) ----------------

def _single(params, cross, abs_m2, inv_err2, freqs, P, nu_DM, nu_GM,
            nu_tau, log10_tau, scat):
    params = torch.as_tensor(params, dtype=real_dtype)
    dev = params.device
    cross = torch.as_tensor(cross).to(dev)
    inv_err2 = torch.as_tensor(inv_err2, dtype=real_dtype).to(dev)
    freqs = torch.as_tensor(freqs, dtype=real_dtype).to(dev)
    abs_m2 = torch.as_tensor(abs_m2, dtype=real_dtype).to(dev)
    S = torch.sum(abs_m2, dim=-1) * inv_err2
    P = torch.as_tensor(P, dtype=real_dtype, device=dev).reshape(1, 1)
    sp = _Spectra(cross[None].contiguous(), abs_m2[None].contiguous(),
                  S[None].contiguous(), inv_err2[None].contiguous(),
                  freqs[None], P, scat=scat, log10_tau=log10_tau)
    nus = tuple(torch.as_tensor(nu, dtype=real_dtype, device=dev)
                .reshape(1, 1) for nu in (nu_DM, nu_GM, nu_tau))
    return sp, params[None], nus


def _moments(params, cross, abs_m2, inv_err2, freqs, P, nu_DM, nu_GM,
             nu_tau, log10_tau, nbin, order=2, scat=True):
    """Per-channel moments of one subint's objective, shaped like the
    reference's ``_moments``: C, S (order>=0); dC, dS [5, nchan]
    (order>=1); d2C, d2S [5, 5, nchan] (order>=2).  ``scat=False`` takes
    B = 1 (kernel K1); ``scat=True`` the scattering sums (kernel K3)."""
    sp, x, nus = _single(params, cross, abs_m2, inv_err2, freqs, P, nu_DM,
                         nu_GM, nu_tau, log10_tau, scat)
    return {key: val[0] for key, val in sp.evaluate(x, nus,
                                                    order=order).items()}


def portrait_objective(params, cross, abs_m2, inv_err2, freqs, P, nu_DM,
                       nu_GM, nu_tau, log10_tau, nbin, scat=True):
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
    subint's objective, flags-masked (reference pptoaslib.py:544-643);
    ``scat=None`` takes the scattering branch when tau or alpha is
    fitted."""
    flags = _check_flags(fit_flags)
    if scat is None:
        scat = bool(flags[3] or flags[4])
    sp, x, nus = _single(params, cross, abs_m2, inv_err2, freqs, P, nu_DM,
                         nu_GM, nu_tau, log10_tau, scat)
    f, g, H = sp.grad_hess(x, nus, flags, per_channel=per_channel)
    return f[0], g[0], H[0]


# -- the solver ------------------------------------------------------------

def _solve(sp, init, nus, flags, lo, hi, max_iter=50):
    """Bounded Levenberg-damped Newton minimization, batched over the
    subints of ``sp``: returns dict x [b, 5], f, nfev, rc (reference
    fit/portrait.py:657-756, one lane per subint)."""
    b = init.shape[0]
    dev = init.device
    flags_t = torch.as_tensor(flags, dtype=real_dtype, device=dev)
    unfit = torch.diag(1.0 - flags_t)
    x = init.clone()
    f, g, H = sp.grad_hess(x, nus, flags)
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
        ft, gt, Ht = sp.grad_hess(trial, _take(nus, act), flags, lanes=act)
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


def _np_real_positive_roots(coeffs):
    """Real, positive roots of each row of polynomial coefficients
    [..., ncoef] (np.roots), NaN-padded to [..., 8] (reference
    fit/portrait.py:428-444)."""
    coeffs = np.asarray(coeffs, dtype=np.float64)
    lead = coeffs.shape[:-1]
    out = np.full(lead + (8,), np.nan)
    for idx in np.ndindex(*lead):
        r = np.roots(coeffs[idx])
        r = np.real(r[np.imag(r) == 0.0])
        r = r[r > 0.0]
        out[idx][:min(len(r), 8)] = r[:8]
    return out


def _roots(coeffs):
    """[b, 8] real positive roots of coeffs [b, ncoef]: one host round
    trip for the batch."""
    host = coeffs.detach().cpu().numpy()
    return torch.as_tensor(_np_real_positive_roots(host), dtype=real_dtype,
                           device=coeffs.device)


def _closest_root(roots, target, fallback):
    """Per row, the root closest to target; ``fallback`` where no real
    positive root exists (reference fit/portrait.py:454-461)."""
    nan = torch.isnan(roots)
    d = torch.where(nan, torch.full_like(roots, math.inf),
                    torch.abs(roots - target[:, None]))
    best = torch.gather(roots, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
    return torch.where((~nan).any(dim=1), best, fallback)


# the flag sets with a zero-covariance form (besides (1,1,1,1,1), which
# takes the (1,1,0,1,1) one); those of _NU_ZERO_ROOTS have one only for
# option 0 or 1
_NU_ZERO_ROOTS = ((1, 1, 1, 0, 0), (1, 1, 1, 1, 0))
_NU_ZERO_FORMS = ((1, 1, 0, 0, 0), (1, 0, 1, 0, 0), (0, 0, 0, 1, 1),
                  (1, 1, 0, 1, 0), (1, 1, 0, 1, 1)) + _NU_ZERO_ROOTS


def _nu_zeros(sp, params, nus, flags, option=0):
    """Zero-covariance reference frequencies [b] (nu_DM, nu_GM, nu_tau)
    for the batch ``sp`` at params [b, 5]; nus are the fit frequencies
    [b, 1] (reference fit/portrait.py:472-629, per flag set)."""
    nu_DM, nu_GM, nu_tau = (nu[:, 0] for nu in nus)
    if flags == (1, 1, 1, 1, 1):
        # the no-GM closed form, as the reference (pptoaslib.py:893-901)
        return _nu_zeros(sp, params, nus, (1, 1, 0, 1, 1), option)
    if flags not in _NU_ZERO_FORMS or (flags in _NU_ZERO_ROOTS
                                       and option not in (0, 1)):
        return [nu_DM, nu_GM, nu_tau]  # no form: keep the fit frequencies
    _, _, Hn = sp.grad_hess(params, nus, flags, per_channel=True)
    freqs = sp.freqs
    pd = _phase_shift_derivs(freqs, nus[0], nus[1], sp.P)   # [b, 3, nchan]
    tau = _tau_lin(params[:, 3:4], sp.log10_tau)
    taus = scattering_times(tau, params[:, 4:5], freqs, nus[2])
    taus_d = scattering_times_deriv(tau, freqs, nus[2], sp.log10_tau, taus)
    fmean = freqs.mean(dim=-1)
    f2, f4 = ipow(freqs, -2), ipow(freqs, -4)

    def tot(x):
        return torch.sum(x, dim=-1)

    nz_DM, nz_GM, nz_tau = nu_DM, nu_GM, nu_tau
    if flags == (1, 1, 0, 0, 0):
        H21_n = Hn[:, 0, 1] / pd[:, 1]
        nz_DM = _guarded_pow(tot(f2 * H21_n) / tot(H21_n), -0.5, nu_DM)
    elif flags == (1, 0, 1, 0, 0):
        H21_n = Hn[:, 0, 2] / pd[:, 2]
        nz_GM = _guarded_pow(tot(f4 * H21_n) / tot(H21_n), -0.25, nu_GM)
    elif flags == (0, 0, 0, 1, 1):
        H21_n = Hn[:, 3, 4] / (taus_d[1] / taus)
        nz_tau = torch.exp(tot(torch.log(freqs) * H21_n) / tot(H21_n))
    elif flags == (1, 1, 0, 1, 0):
        H21_n = Hn[:, 1, 0] / pd[:, 1]
        H23_n = Hn[:, 1, 3] / pd[:, 1]
        Hij = Hn.sum(dim=-1)
        H13, H33 = Hij[:, 3, 0], Hij[:, 3, 3]
        numer = H13 * tot(f2 * H23_n) - H33 * tot(f2 * H21_n)
        denom = H13 * tot(H23_n) - H33 * tot(H21_n)
        nz_DM = _guarded_pow(numer / denom, -0.5, nu_DM)
    elif flags == (1, 1, 1, 0, 0):
        if option == 0:
            H21_n, H23_n = Hn[:, 1, 0] / pd[:, 1], Hn[:, 1, 2] / pd[:, 1]
            H31_n, H33_n = Hn[:, 2, 0] / pd[:, 2], Hn[:, 2, 2] / pd[:, 2]
            A_, B_ = tot(H31_n * f4), tot(H31_n)
            C_, D_ = tot(H23_n * f2), tot(H23_n)
            E_, F_ = tot(H33_n * f4), tot(H33_n)
            G_, H_ = tot(H21_n * f2), tot(H21_n)
        else:
            H21_n, H22_n = Hn[:, 1, 0] / pd[:, 1], Hn[:, 1, 1] / pd[:, 1]
            H31_n, H32_n = Hn[:, 2, 0] / pd[:, 2], Hn[:, 2, 1] / pd[:, 2]
            A_, B_ = tot(H21_n * f4), tot(H21_n)
            C_, D_ = tot(H32_n * f2), tot(H32_n)
            E_, F_ = tot(H22_n * f4), tot(H22_n)
            G_, H_ = tot(H31_n * f2), tot(H31_n)
        zero = torch.zeros_like(A_)
        coeffs = torch.stack([A_ * C_ - E_ * G_, zero, E_ * H_ - A_ * D_,
                              zero, F_ * G_ - B_ * C_, zero,
                              B_ * D_ - F_ * H_], dim=-1)
        nz_DM = _closest_root(_roots(coeffs), fmean, nu_DM)
        nz_GM = nz_DM
    elif flags == (1, 1, 0, 1, 1):
        # indices in the GM-deleted 4x4 system: (phi, DM, tau, alpha)
        H21_n = Hn[:, 1, 0] / pd[:, 1]
        H23_n = Hn[:, 1, 3] / pd[:, 1]
        H24_n = Hn[:, 1, 4] / pd[:, 1]
        tfac = taus_d[1] / taus  # = ln(freqs/nu_tau)
        H41_n, H42_n, H43_n = Hn[:, 4, 0] / tfac, Hn[:, 4, 1] / tfac, \
            Hn[:, 4, 3] / tfac
        Hs = Hn.sum(dim=-1)
        H11, H22, H33, H44 = Hs[:, 0, 0], Hs[:, 1, 1], Hs[:, 3, 3], \
            Hs[:, 4, 4]
        H12, H13, H14 = Hs[:, 0, 1], Hs[:, 0, 3], Hs[:, 0, 4]
        H23, H24 = Hs[:, 1, 3], Hs[:, 1, 4]
        H34 = Hs[:, 3, 4]
        numer = (H34 * H34 - H33 * H44) * tot(f2 * H21_n) + \
            (H13 * H44 - H14 * H34) * tot(f2 * H23_n) + \
            (H14 * H33 - H13 * H34) * tot(f2 * H24_n)
        denom = (H34 * H34 - H33 * H44) * tot(H21_n) + \
            (H13 * H44 - H14 * H34) * tot(H23_n) + \
            (H14 * H33 - H13 * H34) * tot(H24_n)
        nz_DM = _guarded_pow(numer / denom, -0.5, nu_DM)
        lnf = torch.log(freqs)
        numer = (H13 * H22 - H12 * H23) * tot(lnf * H41_n) + \
            (H11 * H23 - H12 * H13) * tot(lnf * H42_n) + \
            (H12 * H12 - H11 * H22) * tot(lnf * H43_n)
        denom = (H13 * H22 - H12 * H23) * tot(H41_n) + \
            (H11 * H23 - H12 * H13) * tot(H42_n) + \
            (H12 * H12 - H11 * H22) * tot(H43_n)
        nz_tau = torch.exp(numer / denom)
    elif flags == (1, 1, 1, 1, 0):
        Hij = Hn.sum(dim=-1)
        H14, H44 = Hij[:, 3, 0], Hij[:, 3, 3]
        dm2 = f2 - ipow(nus[0], -2)
        gm4 = f4 - ipow(nus[1], -4)
        if option == 0:
            H21_n, H23_n, H24_n = (Hn[:, 1, j] / dm2 for j in (0, 2, 3))
            H31_n, H33_n, H34_n = (Hn[:, 2, j] / gm4 for j in (0, 2, 3))
            A_, a_ = tot(f4 * H34_n), tot(H34_n)
            B_, b_ = tot(f2 * H21_n), tot(H21_n)
            C_, c_ = tot(f4 * H31_n), tot(H31_n)
            D_, d_ = tot(f2 * H23_n), tot(H23_n)
            E_, e_ = tot(f4 * H33_n), tot(H33_n)
            F_, f_ = tot(f2 * H24_n), tot(H24_n)
            P5 = A_ ** 2 * B_ + H44 * C_ * D_ + H14 * E_ * F_ \
                - H44 * B_ * E_ - A_ * C_ * F_ - H14 * A_ * D_
            P4 = -A_ ** 2 * b_ - H44 * C_ * d_ - H14 * E_ * f_ \
                + H44 * b_ * E_ + A_ * C_ * f_ + H14 * A_ * d_
            P3 = -2 * A_ * a_ * B_ - H44 * c_ * D_ - H14 * e_ * F_ \
                + H44 * B_ * e_ + (A_ * c_ + a_ * C_) * F_ + H14 * a_ * D_
            P2 = 2 * A_ * a_ * b_ + H44 * c_ * d_ + H14 * e_ * f_ \
                - H44 * b_ * e_ - (A_ * c_ + a_ * C_) * f_ - H14 * a_ * d_
            P1 = a_ ** 2 * B_ - a_ * c_ * F_
            P0 = -a_ ** 2 * b_ + a_ * c_ * f_
            coeffs = torch.stack([P5, P4, P3, P2, P1, P0], dim=-1)
        else:
            H21_n, H22_n, H24_n = (Hn[:, 1, j] / dm2 for j in (0, 1, 3))
            H31_n, H32_n, H34_n = (Hn[:, 2, j] / gm4 for j in (0, 1, 3))
            A_, a_ = tot(f2 * H24_n), tot(H24_n)
            B_, b_ = tot(f4 * H31_n), tot(H31_n)
            C_, c_ = tot(f2 * H21_n), tot(H21_n)
            D_, d_ = tot(f4 * H32_n), tot(H32_n)
            E_, e_ = tot(f2 * H22_n), tot(H22_n)
            F_, f_ = tot(f4 * H34_n), tot(H34_n)
            P4 = A_ ** 2 * B_ + H44 * C_ * D_ + H14 * E_ * F_ \
                - H44 * B_ * E_ - A_ * C_ * F_ - H14 * A_ * D_
            P3 = -2 * A_ * a_ * B_ - H44 * c_ * D_ - H14 * e_ * F_ \
                + H44 * B_ * e_ + (A_ * c_ + a_ * C_) * F_ + H14 * a_ * D_
            P2 = -(A_ ** 2 * b_ - a_ ** 2 * B_) - H44 * C_ * d_ \
                - H14 * E_ * f_ + H44 * b_ * E_ + (A_ * C_ * f_
                                                   - a_ * c_ * F_) \
                + H14 * A_ * d_
            P1 = 2 * A_ * a_ * b_ + H44 * c_ * d_ + H14 * e_ * f_ \
                - H44 * b_ * e_ - (A_ * c_ + a_ * C_) * f_ - H14 * a_ * d_
            P0 = -a_ ** 2 * b_ + a_ * c_ * f_
            coeffs = torch.stack([P4, P3, P2, P1, P0], dim=-1)
        roots = torch.sqrt(torch.abs(_roots(coeffs)))
        nz_DM = _closest_root(roots, fmean, nu_DM)
        nz_GM = nz_DM
    return [nz_DM, nz_GM, nz_tau]


def get_nu_zeros(params, cross, abs_m2, inv_err2, freqs, P, nu_DM, nu_GM,
                 nu_tau, fit_flags, log10_tau, nbin, option=0, scat=None):
    """Zero-covariance reference frequencies [nu_DM, nu_GM, nu_tau] of
    one subint (reference pptoaslib.py:733-906): closed forms per flag
    set, polynomial roots (on the host) for (1,1,1,0,0) and (1,1,1,1,0);
    (1,1,1,1,1) takes the (1,1,0,1,1) form; any other set keeps the fit
    frequencies."""
    flags = _check_flags(fit_flags)
    if scat is None:
        scat = bool(flags[3] or flags[4])
    sp, x, nus = _single(params, cross, abs_m2, inv_err2, freqs, P, nu_DM,
                         nu_GM, nu_tau, log10_tau, scat)
    return [nu[0] for nu in _nu_zeros(sp, x, nus, flags, option)]


def _hess_with_scales(sp, params, nus, flags):
    """(H5 [b, 5, 5], cross_hess [b, 5, nchan], S, C, scales, ok): the
    Hessian blocks including the per-channel amplitudes (reference
    fit/portrait.py:376-403); H5 excludes the dC dC / dS dS terms, which
    the amplitude block carries."""
    m = sp.evaluate(params, nus)
    C, S, dC, dS, d2C, d2S = (m[k] for k in ("C", "S", "dC", "dS", "d2C",
                                             "d2S"))
    ok = S > 0.0
    S = torch.where(ok, S, torch.ones_like(S))
    C = torch.where(ok, C, torch.zeros_like(C))
    zero = torch.zeros_like(C)
    safe_C = torch.where(C != 0.0, C, torch.ones_like(C))
    scales = torch.where(ok, C / S, zero)
    flags_t = torch.as_tensor(flags, dtype=real_dtype, device=C.device)
    Hn = -2.0 * (C ** 2 / S)[:, None, None] * (
        d2C / safe_C[:, None, None] - 0.5 * d2S / S[:, None, None])
    Hn = torch.where(ok[:, None, None], Hn, zero[:, None, None])
    Hn = Hn * flags_t[:, None, None] * flags_t[None, :, None]
    cross_hess = -2.0 * (dC - scales[:, None] * dS) * flags_t[:, None]
    cross_hess = torch.where(ok[:, None], cross_hess, zero[:, None])
    return Hn.sum(dim=-1), cross_hess, S, C, scales, ok


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
    m = model_port if isinstance(model_port, torch.Tensor) \
        else np.asarray(model_port)
    while m.ndim > 2:  # the first model of a batch, before any copy
        m = m[0]
    if isinstance(m, torch.Tensor):
        m = m.detach().cpu().numpy()
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


# profiles (subint x channel rows) per chunk of _spectra: 64 subints of
# 512 channels, or as many one-channel lanes
SPECTRA_ROWS = 64 * 512


def _spectra(data, model, inv_err2, kmax, rows=SPECTRA_ROWS):
    """(cross [b, nchan, K], abs_m2 [1 or b, nchan, K], Sd [b]) from data
    [b, nchan, nbin] and model [nchan, nbin] or [b, nchan, nbin], with the
    DC harmonic weighted by F0_fact.  The full-nharm data spectra exist
    for about ``rows`` profiles at a time only (whole subints, at least
    one); the arithmetic of each row does not depend on the chunks."""
    def rfft0(x):
        X = torch.fft.rfft(x, dim=-1)
        X[..., 0] *= F0_fact
        return X

    shared = model.ndim == 2
    if shared:
        mFFT = rfft0(model)[None]
    sub = max(1, rows // data.shape[1])
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
    return torch.cat(crosses).contiguous(), abs_m2.contiguous(), \
        torch.cat(Sds)


def _seed_phases(data, model, errs, weights):
    """FFTFIT phase seeds [B] from live-channel band-average profiles,
    the model averaged over the same live channels (reference
    fit/portrait.py:1070-1098); the batched fit runs in kernel K2.  The
    channel sums are products with the live-channel mask, so no weighted
    [B, nchan, nbin] copy is made."""
    from .phase_shift import _fit_phase_shift_core

    wok = (weights > 0.0).to(data.dtype)
    wsum = torch.clamp(wok.sum(dim=1), min=1.0)
    prof = torch.matmul(wok[:, None, :], data)[:, 0] / wsum[:, None]
    mprof = (wok @ model if model.ndim == 2 else
             torch.matmul(wok[:, None, :], model)[:, 0]) / wsum[:, None]
    err = torch.sqrt(((errs * wok) ** 2).sum(dim=1)) / wsum
    return _fit_phase_shift_core(prof, mprof, err, -0.5, 0.5, 100, 6).phase


def _fit_chunk(data, model, init, P, freqs, errs, weights, nu_fits,
               nu_outs, nu_outs_mask, flags, lo, hi, max_iter, kmax,
               log10_tau, scat, option, is_toa):
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
    sp = _Spectra(cross, abs_m2, S, inv_err2, freqs, P[:, None], scat=scat,
                  log10_tau=log10_tau)

    wok = wmask.to(real_dtype)
    fq_mean = (freqs * wok).sum(-1) / torch.clamp(wok.sum(-1), min=1.0)
    nu_fit = tuple(torch.where(torch.isnan(nu_fits[:, i]), fq_mean,
                               nu_fits[:, i])[:, None] for i in range(3))
    sol = _solve(sp, init, nu_fit, flags, lo, hi, max_iter)
    x = sol["x"]
    phi_fit, DM_fit, GM_fit, tau_fit, alpha_fit = (x[:, i] for i in range(5))

    nu_out = [nu_outs[:, i] for i in range(3)]
    if not all(nu_outs_mask):
        nz = _nu_zeros(sp, x, nu_fit, flags, option)
        nu_out = [nu_out[i] if nu_outs_mask[i] else nz[i] for i in range(3)]
    if is_toa:  # phi must reference one frequency if both DM & GM fit
        if flags[1]:
            nu_out[1] = nu_out[0]
        elif flags[2]:
            nu_out[0] = nu_out[1]
    phi_inf = phi_fit - (Dconst / P) * DM_fit * ipow(nu_fit[0][:, 0], -2) \
        - (Dconst ** 2 / P) * GM_fit * ipow(nu_fit[1][:, 0], -4)
    phi_out = phi_inf + (Dconst / P) * DM_fit * ipow(nu_out[0], -2) \
        + (Dconst ** 2 / P) * GM_fit * ipow(nu_out[1], -4)
    phi_out = torch.where(torch.abs(phi_out) >= 0.5,
                          torch.remainder(phi_out, 1.0), phi_out)
    phi_out = torch.where(phi_out >= 0.5, phi_out - 1.0, phi_out)
    tau_lin = _tau_lin(tau_fit, log10_tau)
    tau_out = scattering_times(tau_lin, alpha_fit, nu_out[2],
                               nu_fit[2][:, 0])
    if log10_tau:
        tau_out = torch.log10(tau_out)
    params_out = torch.stack([phi_out, DM_fit, GM_fit, tau_out, alpha_fit],
                             dim=1)

    H5, cross_hess, S_ok, C, scales, ok = _hess_with_scales(
        sp, params_out, tuple(nu[:, None] for nu in nu_out), flags)
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
                            scan_size=None, pad_to=None, seed=None,
                            option=0, is_toa=True, device=None):
    """Batched portrait fit over subints: data [B, nchan, nbin].

    model_ports [nchan, nbin] (shared; also a 3-D array whose rows are one
    broadcast view) or [B, nchan, nbin]; init_params [5] or [B, 5] (phi,
    DM, GM, tau or log10 tau [rot], alpha), or None to seed the phases
    from live-channel band averages through kernel K2 (the other
    parameters start at 0, tau at 0); ``seed=True`` seeds the phases of a
    given init.  Seeding needs explicit tau/alpha, so it refuses
    scattering flags.  Ps [B] or scalar; freqs [nchan] or [B, nchan];
    errs/weights [B, nchan] (noise measured, all weights 1 when None);
    nu_fits a 3-tuple of None/scalars/[B] arrays or a [B, 3] array
    (None/NaN = the weighted mean frequency); nu_outs a 3-tuple (None =
    the zero-covariance frequency, found with ``option`` where the flag
    set has two); ``is_toa`` references phi to one frequency when DM and
    GM are both fitted.  A fitted or nonzero fixed tau takes the
    scattering moments (kernel K3), otherwise B = 1 (kernel K1).
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
    if seed is None:
        seed = init_params is None
    if seed and (flags[3] or flags[4]):
        raise ValueError("in-graph seeding seeds only the phase; scattering "
                         "fits need explicit initial tau/alpha.")
    if init_params is None:
        init_params = np.zeros(5)
        if log10_tau:
            init_params[3] = -np.inf  # 10**-inf == 0: no scattering
    scat = _scat_hint(flags, init_params, log10_tau)
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
    if seed:
        init[:, 0] = _seed_phases(data, model, errs, weights)
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
            bool(log10_tau), scat, int(option), bool(is_toa)))
    out = DataBunch(**outs[0]) if len(outs) == 1 else DataBunch(
        **{k: torch.cat([o[k] for o in outs]) for k in RESULT_KEYS})
    # opt-in NaN hook (PPTPU_SANITIZE): fail at the fit that produced a
    # non-finite solution, not pipelines later
    return check_fit_result(out, where="fit_portrait_full_batch")


def fit_portrait_full(data_port, model_port, init_params, P, freqs,
                      nu_fits=(None, None, None),
                      nu_outs=(None, None, None), errs=None, weights=None,
                      fit_flags=(1, 1, 1, 1, 1), bounds=None,
                      log10_tau=True, option=0, max_iter=50, is_toa=True,
                      quiet=True, kmax=None, device=None):
    """Fit (phi, DM, GM, tau, alpha) between one data and model portrait
    [nchan, nbin]: the single-subint view of fit_portrait_full_batch
    (reference pptoaslib.py:928-1096).  Unset fit frequencies default to
    the plain mean of the channel frequencies.  Returns a DataBunch of
    result tensors."""
    del quiet
    data = torch.as_tensor(data_port, dtype=real_dtype)[None]
    nchan = data.shape[1]
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
        max_iter=max_iter, kmax=kmax, option=option, is_toa=is_toa,
        device=device)
    return check_fit_result(DataBunch(**{k: v[0] for k, v in out.items()}),
                            where="fit_portrait_full")


def get_scales_full(params, data_port, model_port, P, freqs, nu_DM, nu_GM,
                    nu_tau, log10_tau=True, device=None):
    """Maximum-likelihood per-channel amplitudes a_n = C_n/S_n at params
    (reference pptoaslib.py:908-926), on the full harmonic range with
    unit weights."""
    device = resolve_device(device)
    data = _to_dev(data_port, device)
    model = _to_dev(model_port, device)
    dFFT = torch.fft.rfft(data, dim=-1)
    mFFT = torch.fft.rfft(model, dim=-1)
    dFFT[..., 0] *= F0_fact
    mFFT[..., 0] *= F0_fact
    cross = dFFT * torch.conj(mFFT)
    abs_m2 = torch.abs(mFFT) ** 2
    inv_err2 = torch.ones(cross.shape[0], dtype=real_dtype, device=device)
    m = _moments(_to_dev(params, device), cross, abs_m2, inv_err2,
                 _to_dev(freqs, device), P, nu_DM, nu_GM, nu_tau, log10_tau,
                 data.shape[-1], order=0)
    return m["C"] / m["S"]


def get_scales(data, model, phase, DM, P, freqs, nu_ref=math.inf,
               device=None):
    """Best-fit per-channel amplitudes for the (phase, DM)-only model
    (Eq. 11 of Pennucci, Demorest & Ransom 2014; reference
    pplib.py:2310-2336)."""
    params = [float(phase), float(DM), 0.0, 0.0, 0.0]
    fmean = float(torch.as_tensor(freqs, dtype=real_dtype).mean())
    return get_scales_full(params, data, model, P, freqs, nu_ref, math.inf,
                           fmean, log10_tau=False, device=device)


def fit_portrait(data, model, init_params, P, freqs, nu_fit=None,
                 nu_out=None, errs=None, bounds=None, max_iter=50,
                 quiet=True, device=None):
    """2-parameter (phase, DM) portrait fit: the 5-parameter fit with
    fit_flags (1, 1, 0, 0, 0) (reference pplib.py:2102-2204).  Returns
    phase, phase_err, DM, DM_err, scales, scale_errs, nu_ref, covariance,
    chi2, red_chi2, snr, nfeval, return_code."""
    init5 = [init_params[0], init_params[1], 0.0, 0.0, 0.0]
    bounds5 = None
    if bounds is not None:
        bounds5 = [tuple(bounds[0]), tuple(bounds[1]), (0.0, 0.0),
                   (0.0, 0.0), (0.0, 0.0)]
    r = fit_portrait_full(data, model, init5, P, freqs,
                          nu_fits=(nu_fit, None, None),
                          nu_outs=(nu_out, None, None), errs=errs,
                          fit_flags=(1, 1, 0, 0, 0), bounds=bounds5,
                          log10_tau=False, max_iter=max_iter, quiet=quiet,
                          device=device)
    return DataBunch(phase=r.phi, phase_err=r.phi_err, DM=r.DM,
                     DM_err=r.DM_err, scales=r.scales,
                     scale_errs=r.scale_errs, nu_ref=r.nu_DM,
                     covariance=r.covariance_matrix[0, 1],
                     chi2=r.chi2, red_chi2=r.red_chi2, snr=r.snr,
                     nfeval=r.nfeval, return_code=r.return_code)
