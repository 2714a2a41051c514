"""Parity of the port's scattering physics with the JAX reference.

The same seeded numpy inputs go through the JAX function (on the CPU,
where it takes the complex128 branch) and its port (the plain PyTorch
version of kernel K3, device="cpu"): the derivative chain of
``ops/scattering.py``, the scattering moments of ``_moments``, the
flags-masked gradient/Hessian and the zero-covariance frequencies of
every flag set.  Kernel K3 itself is held against its plain version in
tests/test_torch_moments_scat.py.
"""

import math

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.ops import scattering as jsc
from pulseportraiture_tpu_torch.fit import portrait as tfp
from pulseportraiture_tpu_torch.ops import scattering as tsc

NCHAN, NBIN, K, P0 = 24, 256, 128, 0.005
FREQS = np.linspace(1150.0, 1850.0, NCHAN)
NU_TAU = 1500.0


def _close(have, want, rtol=1e-12, what=""):
    want = np.asarray(want)
    have = have.numpy() if isinstance(have, torch.Tensor) else \
        np.asarray(have)
    scale = max(np.abs(want).max(), 1e-300)
    np.testing.assert_allclose(have, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("log10_tau", [True, False])
@pytest.mark.parametrize("tau", [3e-3, 0.0])
def test_scattering_derivatives_match_reference(log10_tau, tau):
    """taus and their first/second derivatives, the kernel FT derivatives
    and |B|^2's; tau == 0 exercises the arithmetic guards."""
    alpha = -3.8
    taus_t = tsc.scattering_times(tau, alpha, FREQS, NU_TAU)
    taus_j = jsc.scattering_times(tau, alpha, FREQS, NU_TAU)
    _close(taus_t, taus_j, what="taus")
    tau_p = math.log10(tau) if (log10_tau and tau) else tau
    d_t = tsc.scattering_times_deriv(tau, FREQS, NU_TAU, log10_tau, taus_t)
    d_j = jsc.scattering_times_deriv(tau, FREQS, NU_TAU, log10_tau, taus_j)
    _close(d_t, d_j, what="taus_deriv (tau param %g)" % tau_p)
    d2_t = tsc.scattering_times_2deriv(tau, FREQS, NU_TAU, log10_tau, taus_t,
                                       d_t)
    d2_j = jsc.scattering_times_2deriv(tau, FREQS, NU_TAU, log10_tau, taus_j,
                                       d_j)
    _close(d2_t, d2_j, what="taus_2deriv")
    B_t = tsc.scattering_portrait_FT(taus_t, NBIN, nharm=K)
    B_j = jsc.scattering_portrait_FT(taus_j, NBIN, nharm=K)
    _close(B_t, B_j, what="B")
    dB_t = tsc.scattering_portrait_FT_deriv(taus_t, d_t, B_t)
    dB_j = jsc.scattering_portrait_FT_deriv(taus_j, d_j, B_j)
    _close(dB_t, dB_j, what="dB")
    d2B_t = tsc.scattering_portrait_FT_2deriv(taus_t, d_t, d2_t, B_t)
    d2B_j = jsc.scattering_portrait_FT_2deriv(taus_j, d_j, d2_j, B_j)
    _close(d2B_t, d2B_j, what="d2B")
    _close(tsc.abs_scattering_portrait_FT(B_t),
           jsc.abs_scattering_portrait_FT(B_j), what="|B|^2")
    _close(tsc.abs_scattering_portrait_FT_deriv(B_t, dB_t),
           jsc.abs_scattering_portrait_FT_deriv(B_j, dB_j), what="d|B|^2")
    _close(tsc.abs_scattering_portrait_FT_2deriv(B_t, dB_t, d2B_t),
           jsc.abs_scattering_portrait_FT_2deriv(B_j, dB_j, d2B_j),
           what="d2|B|^2")


def test_scattering_kernel_and_add_scattering_match_reference(rng):
    port = rng.standard_normal((NCHAN, 64))
    for tau in (2e-4, 0.0):
        kt = tsc.scattering_kernel(tau, NU_TAU, FREQS, 64, P=0.005)
        kj = jsc.scattering_kernel(tau, NU_TAU, FREQS, 64, P=0.005)
        _close(kt, kj, what="kernel tau=%g" % tau)
        _close(tsc.add_scattering(port, kt), jsc.add_scattering(port, kj),
               what="add_scattering tau=%g" % tau)
    _close(tsc.add_scattering(port[0], kt[0]),
           jsc.add_scattering(port[0], kj[0]), what="1-D profile")


def _spectra(rng):
    """Truncated spectra of a scattered two-Gaussian portrait with noise,
    one zapped channel."""
    x = (np.arange(NBIN) + 0.5) / NBIN
    r = (FREQS / 1500.0)[:, None]
    model = np.exp(-0.5 * ((x - 0.4) / (0.02 * r ** -0.2)) ** 2) \
        + 0.5 * np.exp(-0.5 * ((x - 0.55) / 0.03) ** 2)
    mFT = np.fft.rfft(model, axis=-1)[:, :K]
    B = np.asarray(jsc.scattering_portrait_FT(
        jsc.scattering_times(4e-3, -4.0, FREQS, NU_TAU), NBIN, nharm=K))
    dFT = mFT * B * np.exp(-2j * np.pi * np.arange(K) * 0.1) \
        + 3.0 * (rng.standard_normal((NCHAN, K))
                 + 1j * rng.standard_normal((NCHAN, K)))
    dFT[:, 0] = mFT[:, 0] = 0.0
    inv_err2 = rng.uniform(0.5, 2.0, NCHAN)
    inv_err2[5] = 0.0
    return dFT * np.conj(mFT), np.abs(mFT) ** 2, inv_err2


PARAMS = [
    ([0.013, 2e-3, 1e-4, math.log10(3e-3), -3.7], True),
    ([-0.21, -4e-3, -2e-4, 2e-3, -4.4], False),
    ([0.3, 1e-3, 0.0, -math.inf, -4.0], True),   # tau == 0: B == 1
    ([0.05, 0.0, 0.0, 0.04, -4.0], False),       # tau x K ~ 30
]


@pytest.mark.parametrize("params,log10_tau", PARAMS)
def test_scattering_moments_match_reference(params, log10_tau, rng):
    cross, abs_m2, inv_err2 = _spectra(rng)
    args = (cross, abs_m2, inv_err2, FREQS, P0, 1432.1, 1480.0, NU_TAU,
            log10_tau, NBIN)
    ref = jfp._moments(np.asarray(params), *args, order=2, scat=True)
    got = tfp._moments(np.asarray(params), *args, order=2, scat=True)
    for key in ("C", "S", "dC", "dS", "d2C", "d2S"):
        # the nine harmonic sums are the reference's up to summation order
        # and the factored chain rule: ~1e-15 of the terms' size
        _close(got[key], ref[key], what=key)


@pytest.mark.parametrize("flags", [(1, 1, 0, 1, 1), (1, 1, 0, 1, 0),
                                   (1, 1, 1, 1, 1)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_scattering_grad_hess_match_reference(flags, per_channel, rng):
    cross, abs_m2, inv_err2 = _spectra(rng)
    params = np.array([0.021, 1.5e-3, 1e-4, math.log10(4.5e-3), -3.9])
    args = (cross, abs_m2, inv_err2, FREQS, P0, 1432.1, 1480.0, NU_TAU,
            flags, True, NBIN)
    want = jfp.portrait_grad_hess(params, *args, per_channel=per_channel)
    have = tfp.portrait_grad_hess(params, *args, per_channel=per_channel)
    np.testing.assert_allclose(float(have[0]), float(want[0]), rtol=1e-12)
    for h, w, what in zip(have[1:], want[1:], ("grad", "hess")):
        _close(h, w, what=what)


NU_ZERO_FLAGS = [(1, 1, 0, 0, 0), (1, 0, 1, 0, 0), (0, 0, 0, 1, 1),
                 (1, 1, 0, 1, 0), (1, 1, 1, 0, 0), (1, 1, 0, 1, 1),
                 (1, 1, 1, 1, 0), (1, 1, 1, 1, 1)]


@pytest.mark.parametrize("flags", NU_ZERO_FLAGS)
@pytest.mark.parametrize("option", [0, 1])
def test_nu_zeros_match_reference(flags, option, rng):
    """Closed forms and the polynomial-root forms (roots on the host)."""
    cross, abs_m2, inv_err2 = _spectra(rng)
    params = np.array([0.021, 1.5e-3, 1e-4, math.log10(4.5e-3), -3.9])
    args = (cross, abs_m2, inv_err2, FREQS, P0, 1432.1, 1480.0, NU_TAU,
            flags, True, NBIN)
    want = jfp.get_nu_zeros(params, *args, option=option)
    have = tfp.get_nu_zeros(params, *args, option=option)
    # the root and ratio forms divide sums that cancel: ~1e-12 relative
    for h, w, name in zip(have, want, ("nu_DM", "nu_GM", "nu_tau")):
        np.testing.assert_allclose(float(h), float(w), rtol=1e-10,
                                   err_msg=name)


def _gh_inputs(rng, nchan, log10_tau, nsub=3):
    """K3 epilogue B's arguments for ``nsub`` subints of _spectra (channel
    5 zapped; the first ``nchan`` channels), their reference arguments,
    and the per-subint params."""
    spec = [_spectra(rng) for _ in range(nsub)]
    cross = np.stack([c[:nchan] for c, _, _ in spec])
    abs_m2 = spec[0][1][None, :nchan]  # one model: |m|^2 shared
    inv_err2 = np.stack([w[:nchan] for _, _, w in spec])
    tau = rng.uniform(2e-3, 6e-3, nsub)
    params = np.stack([rng.uniform(-0.3, 0.3, nsub),
                       rng.uniform(-3e-3, 3e-3, nsub),
                       rng.uniform(-2e-4, 2e-4, nsub),
                       np.log10(tau) if log10_tau else tau,
                       rng.uniform(-4.4, -3.6, nsub)], axis=1)
    return cross, abs_m2, inv_err2, params


@pytest.mark.parametrize("flags", [(1, 1, 0, 1, 1), (1, 1, 1, 1, 1),
                                   (1, 1, 0, 1, 0)])
@pytest.mark.parametrize("log10_tau", [True, False])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("nchan", [NCHAN, 1])
def test_grad_hess_plain_matches_reference(flags, log10_tau, per_channel,
                                           nchan, rng):
    """K3 epilogue B's plain version (moments_scat_grad_hess_plain) on a
    lane subset, summed and masked as the solver does, against the
    reference's portrait_grad_hess of each lane (JAX on the CPU, its
    complex128 branch).  Tolerance 1e-12 of each output's largest
    magnitude: the nine sums differ from the reference's only in
    summation order and the factored chain rule (~1e-15 of the terms),
    and the 5x5 algebra, term for term the reference's, divides by C and
    S and cancels (the Hessian's scattering block)."""
    cross, abs_m2, inv_err2, params = _gh_inputs(rng, nchan, log10_tau)
    freqs = FREQS[:nchan]
    nu_DM, nu_GM = 1432.1, 1480.0
    lanes = torch.tensor([2, 0])
    x = torch.as_tensor(params)[lanes]
    n = len(lanes)
    fr = torch.as_tensor(np.tile(freqs, (n, 1)))
    P = torch.full((n, 1), P0, dtype=torch.float64)
    nus = [torch.full((n, 1), v, dtype=torch.float64)
           for v in (nu_DM, nu_GM, NU_TAU)]
    tau = (10.0 ** x[:, 3] if log10_tau else x[:, 3]).contiguous()
    taus = tsc.scattering_times(tau[:, None], x[:, 4:5], fr, nus[2])
    rows = tfp._kernels.moments_scat_grad_hess(
        torch.as_tensor(cross), torch.as_tensor(abs_m2),
        tfp._shifts(x, fr, P, nus[0], nus[1]), taus,
        torch.as_tensor(inv_err2), tfp._phase_shift_derivs(
            fr, nus[0], nus[1], P), torch.log(fr / nus[2]), tau, log10_tau,
        lanes)
    assert tuple(rows.shape) == (n, 21, nchan)
    have = tfp._grad_hess_from_rows(rows, flags, per_channel)
    for i, lane in enumerate(lanes.tolist()):
        want = jfp.portrait_grad_hess(
            params[lane], cross[lane], abs_m2[0], inv_err2[lane], freqs, P0,
            nu_DM, nu_GM, NU_TAU, flags, log10_tau, NBIN,
            per_channel=per_channel, scat=True)
        np.testing.assert_allclose(float(have[0][i]), float(want[0]),
                                   rtol=1e-12)
        for h, w, what in zip(have[1:], want[1:], ("grad", "hess")):
            _close(h[i], w, what="%s lane %d" % (what, lane))


def test_grad_hess_plain_at_zero_tau_is_k1s(rng):
    """At tau == 0, K3 epilogue B's (phi, DM, GM) terms are those of K1's
    epilogue B (the B = 1 algebra of _kernels.moments_grad_hess_plain),
    and its scattering rows and columns vanish."""
    cross, abs_m2, inv_err2, params = _gh_inputs(rng, NCHAN, True)
    n = cross.shape[0]
    fr = torch.as_tensor(np.tile(FREQS, (n, 1)))
    P = torch.full((n, 1), P0, dtype=torch.float64)
    nus = [torch.full((n, 1), v, dtype=torch.float64)
           for v in (1432.1, 1480.0, NU_TAU)]
    x = torch.as_tensor(params)
    sh = tfp._shifts(x, fr, P, nus[0], nus[1])
    pd = tfp._phase_shift_derivs(fr, nus[0], nus[1], P)
    cross, abs_m2 = torch.as_tensor(cross), torch.as_tensor(abs_m2)
    inv_err2 = torch.as_tensor(inv_err2)
    zero = torch.zeros_like(sh)
    rows = tfp._kernels.moments_scat_grad_hess(
        cross, abs_m2, sh, zero, inv_err2, pd, torch.log(fr / nus[2]),
        torch.zeros(n, dtype=torch.float64), True)
    f, g, H = tfp._grad_hess_from_rows(rows, (1, 1, 1, 1, 1),
                                       per_channel=True)
    S = abs_m2.sum(-1) * inv_err2
    f1, g1, H1 = tfp._grad_hess_from_rows(
        tfp._kernels.moments_grad_hess_plain(cross, sh, pd, S, inv_err2),
        (1, 1, 1, 0, 0), per_channel=True)
    _close(f, f1.numpy(), rtol=1e-12, what="f")
    _close(g, g1.numpy(), rtol=1e-12, what="grad")
    _close(H, H1.numpy(), rtol=1e-12, what="hess")
