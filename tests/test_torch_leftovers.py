"""The port's smaller leftovers against the JAX package, on the CPU.

Seeded numpy inputs go through the JAX function and its port:

* ``ops/fourier.py``: nharm_for, rfft_portrait / irfft_portrait,
  phase_shifts_deriv, rotate_portrait_full, fft_rotate and add_DM_nu
  (the power-law dispersion law, Cs padded with ones, nu_ref = inf) —
  within 1e-12 of the peak, NaN where the reference gives NaN;
* ``ops/profiles.py``: gaussian_function, gaussian_portrait_FT — 1e-12
  of the peak;
* ``fit/smallsolve.py``: the unrolled Cholesky factor, solve and inverse
  on a batch of positive-definite matrices — 1e-12; NaN on an
  indefinite one, as in the reference;
* ``debug.py``: the sanitizer raises or warns per ``PPTPU_SANITIZE`` and
  does nothing when it is off, on the fit entry points too.
"""

import math
import warnings

import numpy as np
import pytest
import torch

from pulseportraiture_tpu import debug as jdebug
from pulseportraiture_tpu.fit import smallsolve as jss
from pulseportraiture_tpu.ops import fourier as jfo
from pulseportraiture_tpu.ops import profiles as jpr
from pulseportraiture_tpu_torch import debug as tdebug
from pulseportraiture_tpu_torch.fit import portrait as tfp
from pulseportraiture_tpu_torch.fit import smallsolve as tss
from pulseportraiture_tpu_torch.ops import fourier as tfo
from pulseportraiture_tpu_torch.ops import profiles as tpr

MODEL = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
FREQS = np.linspace(1200.0, 1700.0, 16)


def _portrait(rng, nchan=16, nbin=128):
    x = (np.arange(nbin) + 0.5) / nbin
    loc = rng.uniform(0.3, 0.7, nchan)[:, None]
    return np.exp(-0.5 * ((x - loc) / 0.04) ** 2) \
        + 0.05 * rng.standard_normal((nchan, nbin))


def _peak_close(have, want, tol=1e-12):
    have = have.numpy() if isinstance(have, torch.Tensor) else have
    want = np.asarray(want)
    assert have.shape == want.shape
    assert np.array_equal(np.isnan(have), np.isnan(want))
    ok = ~np.isnan(want)
    scale = np.abs(want[ok]).max() if ok.any() else 1.0
    np.testing.assert_allclose(have[ok], want[ok], rtol=0, atol=tol * scale)


def test_nharm_and_rfft_round_trip():
    rng = np.random.default_rng(0)
    port = _portrait(rng)
    for nbin in (1, 2, 7, 2048):
        assert tfo.nharm_for(nbin) == jfo.nharm_for(nbin)
    for zap in (True, False):
        have = tfo.rfft_portrait(torch.as_tensor(port), zap_f0=zap)
        want = np.asarray(jfo.rfft_portrait(port, zap_f0=zap))
        _peak_close(have.real, want.real)
        _peak_close(have.imag, want.imag)
        _peak_close(tfo.irfft_portrait(have), jfo.irfft_portrait(want))
        _peak_close(tfo.irfft_portrait(have, 130),
                    jfo.irfft_portrait(want, 130))


def test_phase_shifts_deriv_and_rotate_portrait_full():
    rng = np.random.default_rng(1)
    port = _portrait(rng)
    for nu_DM, nu_GM, P in ((math.inf, math.inf, 1.0),
                            (1500.0, 1400.0, 0.004)):
        _peak_close(tfo.phase_shifts_deriv(FREQS, nu_DM, nu_GM, P),
                    jfo.phase_shifts_deriv(FREQS, nu_DM, nu_GM, P))
        _peak_close(
            tfo.rotate_portrait_full(torch.as_tensor(port), 0.21, 3e-3,
                                     1e-6, FREQS, nu_DM, nu_GM, P),
            jfo.rotate_portrait_full(port, 0.21, 3e-3, 1e-6, FREQS, nu_DM,
                                     nu_GM, P))
    _peak_close(tfo.rotate_portrait_full(torch.as_tensor(port), -0.1, 0.0,
                                         0.0, FREQS),
                jfo.rotate_portrait_full(port, -0.1, 0.0, 0.0, FREQS))


def test_fft_rotate():
    rng = np.random.default_rng(2)
    prof = _portrait(rng, nchan=3)
    for bins in (0.0, 3.0, -17.25, 200.5):
        _peak_close(tfo.fft_rotate(torch.as_tensor(prof), bins),
                    jfo.fft_rotate(prof, bins))
        _peak_close(tfo.fft_rotate(torch.as_tensor(prof[0]), bins),
                    jfo.fft_rotate(prof[0], bins))


@pytest.mark.parametrize("phase,DM,P,xs,Cs,nu_ref", [
    (0.1, 2e-3, 0.004, (-2.0,), (1.0,), math.inf),
    (0.1, 2e-3, 0.004, (-2.0,), (1.0,), 1500.0),
    (-0.3, 5e-2, 0.003, (-2.0, -4.0, -1.5), (1.0, 0.3), 1400.0),
    (0.0, 1e-2, 0.005, (-2.2,), (0.7,), math.inf),
    (0.05, 1e-3, 0.004, (-2.0, 1.0), (1.0, 1e-6), 1600.0),
    # a positive exponent at nu_ref = inf: inf in the law, NaN portraits
    (0.05, 1e-3, 0.004, (-2.0, 1.0), (1.0, 1e-6), math.inf),
    # no DM: a plain rotation by phase
    (0.2, None, 0.004, (-2.0,), (1.0,), math.inf),
])
def test_add_DM_nu(phase, DM, P, xs, Cs, nu_ref):
    rng = np.random.default_rng(3)
    port = _portrait(rng)
    want = np.asarray(jfo.add_DM_nu(port, phase, DM, P, FREQS, xs=xs, Cs=Cs,
                                    nu_ref=nu_ref))
    have = tfo.add_DM_nu(torch.as_tensor(port), phase, DM, P, FREQS, xs=xs,
                         Cs=Cs, nu_ref=nu_ref)
    _peak_close(have, want)
    if math.isinf(nu_ref) and max(xs) > 0:
        assert np.isnan(want).all()


def test_gaussian_function_and_portrait_FT():
    xs = np.linspace(-0.2, 1.2, 301)
    for loc, wid in ((0.3, 0.05), (0.9, 0.2)):
        for norm in (False, True):
            _peak_close(tpr.gaussian_function(xs, loc, wid, norm),
                        jpr.gaussian_function(xs, loc, wid, norm))
    for code, tau in (("000", 0.0), ("101", 2.5)):
        params = list(MODEL)
        params[1] = tau
        have = tpr.gaussian_portrait_FT(code, params, -4.0, 256, FREQS,
                                        1500.0)
        want = np.asarray(jpr.gaussian_portrait_FT(code, np.asarray(params),
                                                   -4.0, 256, FREQS, 1500.0))
        scale = np.abs(want).max()
        assert have.shape == want.shape
        assert float(np.abs(have.numpy() - want).max()) <= 1e-12 * scale


def _spd(rng, batch, n):
    A = rng.standard_normal(batch + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_smallsolve_cholesky(n):
    rng = np.random.default_rng(10 + n)
    A = _spd(rng, (4, 3), n)
    b = rng.standard_normal((4, 3, n))
    tA, tb = torch.as_tensor(A), torch.as_tensor(b)
    for have, want in (
            (tss.chol_factor(tA), jss.chol_factor(A)),
            (tss.chol_solve(tss.chol_factor(tA), tb),
             jss.chol_solve(jss.chol_factor(A), b)),
            (tss.solve_sym(tA, tb), jss.solve_sym(A, b)),
            (tss.inv_sym(tA), jss.inv_sym(A))):
        want = np.asarray(want)
        np.testing.assert_allclose(have.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(
        tss.solve_sym(tA, tb).numpy(), np.linalg.solve(A, b[..., None])[..., 0],
        rtol=1e-10)
    if n > 1:  # an indefinite matrix: NaN, as in the reference
        bad = A[0, 0].copy()
        bad[-1, -1] = -10.0 * np.abs(bad).max()
        have = tss.inv_sym(torch.as_tensor(bad)).numpy()
        want = np.asarray(jss.inv_sym(bad))
        assert np.isnan(want).any()
        assert np.array_equal(np.isnan(have), np.isnan(want))


@pytest.mark.parametrize("env,mode", [
    (None, None), ("0", None), ("off", None), ("1", "raise"),
    ("raise", "raise"), ("warn", "warn"), ("log", "warn")])
def test_sanitize_mode(monkeypatch, env, mode):
    if env is None:
        monkeypatch.delenv("PPTPU_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("PPTPU_SANITIZE", env)
    assert tdebug.sanitize_mode() == jdebug.sanitize_mode() == mode
    assert tdebug.enabled() == (mode is not None)


def _checks(mod, params, chi2):
    mod.check_finite(params, "p", allow_inf=True)
    mod.check_fit_result(dict(params=params, chi2=chi2), where="w")


@pytest.mark.parametrize("mode", ["off", "raise", "warn"])
def test_check_finite_per_mode(monkeypatch, mode):
    monkeypatch.setenv("PPTPU_SANITIZE", mode)
    good = torch.tensor([1.0, -math.inf])    # inf allowed in fit results
    nan = torch.tensor([1.0, math.nan])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _checks(tdebug, good.numpy(), np.array(1.0))
        tdebug.check_fit_result(dict(params=good, chi2=torch.tensor(1.0)))
        assert tdebug.check_finite(torch.ones(3)) is not None
    if mode == "off":
        _checks(tdebug, nan, nan)
        return
    for bad in (dict(params=nan, chi2=torch.tensor(1.0)),
                dict(params=good, chi2=torch.tensor(math.nan))):
        for mod, value in ((tdebug, bad), (jdebug, {
                k: v.numpy() for k, v in bad.items()})):
            if mode == "raise":
                with pytest.raises(mod.NonFiniteError):
                    mod.check_fit_result(value)
            else:
                with pytest.warns(RuntimeWarning, match="non-finite"):
                    mod.check_fit_result(value)
    if mode == "raise":
        with pytest.raises(tdebug.NonFiniteError):
            tdebug.check_finite(good, "x")     # allow_inf=False
        with pytest.raises(tdebug.NonFiniteError):
            tdebug.check_finite(np.array([np.nan]), "x")


def test_fit_entry_points_are_sanitized(monkeypatch):
    """A fit poisoned with NaN data raises at fit_portrait_full(_batch)
    with the sanitizer on, and passes through silently with it off."""
    rng = np.random.default_rng(4)
    model = _portrait(rng, 8, 64)
    data = np.stack([model, model]) + 0.01 * rng.standard_normal((2, 8, 64))
    data[1] = np.nan
    freqs = np.linspace(1200.0, 1600.0, 8)
    kw = dict(fit_flags=(1, 1, 0, 0, 0), log10_tau=False, device="cpu")
    monkeypatch.setenv("PPTPU_SANITIZE", "0")
    out = tfp.fit_portrait_full_batch(data, model, np.zeros((2, 5)), 0.004,
                                      freqs, **kw)
    assert torch.isnan(out.chi2[1]) and torch.isfinite(out.chi2[0])
    monkeypatch.setenv("PPTPU_SANITIZE", "1")
    with pytest.raises(tdebug.NonFiniteError, match="fit_portrait_full_batch"):
        tfp.fit_portrait_full_batch(data, model, np.zeros((2, 5)), 0.004,
                                    freqs, **kw)
    with pytest.raises(tdebug.NonFiniteError, match="fit_portrait_full"):
        tfp.fit_portrait_full(data[1], model, np.zeros(5), 0.004, freqs,
                              **kw)
    out = tfp.fit_portrait_full(data[0], model, np.zeros(5), 0.004, freqs,
                                **kw)
    assert torch.isfinite(out.params).all()
