"""Parity of the PyTorch port's fits with the JAX reference on the CPU.

The same seeded numpy inputs go through the JAX function and its port
(the port's plain PyTorch kernels, device="cpu"): the per-channel
moments (kernel K1's function), the flags-masked gradient/Hessian, the
FFTFIT core (kernel K2's function), the batched (phi, DM) fit, the GM
and scattering fits of every flag set (kernel K3's function), seeding
and the small wrappers.
"""

import math

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.fit import phase_shift as jps
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch.config import Dconst
from pulseportraiture_tpu_torch.fit import phase_shift as tps
from pulseportraiture_tpu_torch.fit import portrait as tfp

NCHAN, NBIN, P0 = 32, 256, 0.005
DM0 = 30.0  # the data are dispersed at DM0 + dDM, as archives are
FREQS = np.linspace(1100.0, 1900.0, NCHAN)


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits here add many variants to the JAX package's jit
    caches, whose size tests/test_retrace_budget.py holds to a budget in
    whatever test process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


def _portrait(nbin=NBIN, freqs=FREQS):
    """A two-component Gaussian portrait with frequency evolution."""
    x = (np.arange(nbin) + 0.5) / nbin
    r = (freqs / 1500.0)[:, None]
    port = np.exp(-0.5 * ((x - 0.35) / (0.03 * r ** -0.3)) ** 2) \
        + 0.4 * r ** -1.0 * np.exp(-0.5 * ((x - 0.55) / 0.02) ** 2)
    return port


def _rotate(port, shifts):
    """Rotate rows of port to earlier phase by shifts [rot]."""
    FT = np.fft.rfft(port, axis=-1)
    k = np.arange(FT.shape[-1])
    return np.fft.irfft(FT * np.exp(2j * np.pi * shifts[..., None] * k),
                        port.shape[-1], axis=-1)


def _fake_batch(rng, nsub, noise=0.02):
    model = _portrait()
    phis = rng.uniform(-0.3, 0.3, nsub)
    dDMs = rng.normal(0.0, 2e-3, nsub)
    nu_ref = 1500.0
    data = np.empty((nsub, NCHAN, NBIN))
    for i in range(nsub):
        sh = -phis[i] - Dconst * (DM0 + dDMs[i]) * (
            FREQS ** -2 - nu_ref ** -2) / P0
        data[i] = _rotate(model, sh) + noise * rng.standard_normal(
            (NCHAN, NBIN))
    return data, model, phis, dDMs


def _spectra(rng):
    data, model, _, _ = _fake_batch(rng, 1)
    data = _rotate(data, Dconst * DM0 * (FREQS ** -2 - 1500.0 ** -2) / P0)
    dFT = np.fft.rfft(data[0], axis=-1)[:, :128]
    mFT = np.fft.rfft(model, axis=-1)[:, :128]
    dFT[:, 0] = mFT[:, 0] = 0.0
    cross = dFT * np.conj(mFT)
    abs_m2 = np.abs(mFT) ** 2
    inv_err2 = rng.uniform(0.5, 2.0, NCHAN)
    inv_err2[4] = 0.0  # a zapped channel
    return cross, abs_m2, inv_err2


@pytest.mark.parametrize("params", [
    [0.013, 2e-3, 0.0, 0.0, 0.0],
    [-0.31, -4e-3, 0.0, 0.0, 0.0],
    [0.27, 0.0, 0.0, 0.0, 0.0],
])
def test_moments_match_reference(params, rng):
    cross, abs_m2, inv_err2 = _spectra(rng)
    args = (cross, abs_m2, inv_err2, FREQS, P0, 1432.1, 1500.0, 1500.0,
            False, NBIN)
    ref = jfp._moments(np.asarray(params), *args, order=2, scat=False)
    got = tfp._moments(np.asarray(params), *args, order=2, scat=False)
    for key in ("C", "S", "dC", "dS", "d2C", "d2S"):
        want = np.asarray(ref[key])
        have = got[key].numpy()
        # sums over 128 harmonics taken in another order: relative to the
        # size of the terms, the f64 floor is ~1e-15
        scale = np.abs(want).max()
        np.testing.assert_allclose(have, want, rtol=1e-12,
                                   atol=1e-12 * scale, err_msg=key)


def test_moments_kernel_function_on_lane_subsets(rng):
    """K1's plain version evaluated on a lane subset equals the full
    evaluation's rows (the solver evaluates only active lanes)."""
    cross = torch.as_tensor(rng.standard_normal((5, 6, 16))
                            + 1j * rng.standard_normal((5, 6, 16)))
    inv_err2 = torch.as_tensor(rng.uniform(0.5, 2.0, (5, 6)))
    shifts = torch.as_tensor(rng.uniform(-40.0, 40.0, (5, 6)))
    full = _kernels.moments(cross, shifts, inv_err2)
    lanes = torch.tensor([3, 0], dtype=torch.int64)
    part = _kernels.moments(cross, shifts[lanes].contiguous(), inv_err2,
                            lanes)
    torch.testing.assert_close(part, full[lanes], rtol=0, atol=0)
    assert set(_kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("flags", [(1, 1, 0, 0, 0), (1, 0, 0, 0, 0)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_grad_hess_match_reference(flags, per_channel, rng):
    cross, abs_m2, inv_err2 = _spectra(rng)
    params = np.array([0.021, 1.5e-3, 0.0, 0.0, 0.0])
    args = (cross, abs_m2, inv_err2, FREQS, P0, 1432.1, 1500.0, 1500.0,
            flags, False, NBIN)
    f_r, g_r, H_r = jfp.portrait_grad_hess(params, *args,
                                           per_channel=per_channel,
                                           scat=False)
    f_t, g_t, H_t = tfp.portrait_grad_hess(params, *args,
                                           per_channel=per_channel,
                                           scat=False)
    np.testing.assert_allclose(float(f_t), float(f_r), rtol=1e-12)
    for have, want in ((g_t, g_r), (H_t, H_r)):
        want = np.asarray(want)
        np.testing.assert_allclose(have.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def _k1_rows_inputs(rng, params):
    """One subint's spectra (channel 4 zapped: S = 0; channel 7's
    cross-spectrum zero: C = 0 with S > 0) and, at ``params`` [1, 5], the
    port's shifts and d shift / d(phi, DM, GM) as the solver forms them."""
    cross, abs_m2, inv_err2 = _spectra(rng)
    cross[7] = 0.0
    fr = torch.as_tensor(FREQS)[None]
    nus = [torch.full((1, 1), v, dtype=torch.float64)
           for v in (1432.1, 1480.0)]
    sh, pd = tfp._shifts_and_derivs(torch.as_tensor(params)[None], fr,
                                    torch.full((1, 1), P0,
                                               dtype=torch.float64), *nus)
    t_cross = torch.as_tensor(cross)[None].contiguous()
    t_ie2 = torch.as_tensor(inv_err2)[None].contiguous()
    S = (torch.as_tensor(abs_m2).sum(-1)[None] * t_ie2).contiguous()
    return (cross, abs_m2, inv_err2), (t_cross, sh.contiguous(),
                                       pd.contiguous(), S, t_ie2)


@pytest.mark.parametrize("flags", [(1, 1, 0, 0, 0), (1, 0, 0, 0, 0),
                                   (1, 1, 1, 0, 0)])
@pytest.mark.parametrize("per_channel", [False, True])
def test_moments_grad_hess_plain_matches_reference(flags, per_channel, rng):
    """K1 epilogue B's plain version, its rows summed over channels and
    flag-masked (fit.portrait._grad_hess_from_rows), is the reference's
    portrait_grad_hess without scattering, a zapped channel (S = 0) and a
    channel with C = 0 among the rows: 1e-12 of each output's largest
    magnitude, as test_grad_hess_match_reference."""
    params = np.array([0.021, 1.5e-3, 2e-6, 0.0, 0.0])
    (cross, abs_m2, inv_err2), args = _k1_rows_inputs(rng, params)
    rows = _kernels.moments_grad_hess_plain(*args)
    assert tuple(rows.shape) == (1, 10, NCHAN)
    assert bool((rows[0, :, 4] == 0.0).all())         # zapped
    assert bool((rows[0, :, 7] == 0.0).all())         # C = 0
    f_t, g_t, H_t = tfp._grad_hess_from_rows(rows, flags, per_channel)
    f_r, g_r, H_r = jfp.portrait_grad_hess(
        params, cross, abs_m2, inv_err2, FREQS, P0, 1432.1, 1480.0, 1500.0,
        flags, False, NBIN, per_channel=per_channel, scat=False)
    np.testing.assert_allclose(float(f_t[0]), float(f_r), rtol=1e-12)
    for have, want in ((g_t[0], g_r), (H_t[0], H_r)):
        want = np.asarray(want)
        np.testing.assert_allclose(have.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_moments_grad_hess_lanes_equal_full_rows(rng):
    """Epilogue B on a lane subset (the solver's still-active subints)
    gives the full evaluation's rows bit for bit; on CPU tensors the
    wrapper takes the plain version and launches nothing."""
    B, nchan, Kh = 5, 6, 16
    cross = torch.as_tensor(rng.standard_normal((B, nchan, Kh))
                            + 1j * rng.standard_normal((B, nchan, Kh)))
    inv_err2 = torch.as_tensor(rng.uniform(0.5, 2.0, (B, nchan)))
    inv_err2[2, 3] = 0.0
    S = torch.as_tensor(rng.uniform(0.5, 2.0, (B, nchan))) * inv_err2
    shifts = torch.as_tensor(rng.uniform(-40.0, 40.0, (B, nchan)))
    pd = torch.as_tensor(np.stack([np.ones((B, nchan)),
                                   rng.uniform(-0.2, 0.2, (B, nchan)),
                                   rng.uniform(-1e-3, 1e-3, (B, nchan))], 1))
    _kernels.reset_launches()
    full = _kernels.moments_grad_hess(cross, shifts, pd, S, inv_err2)
    lanes = torch.tensor([3, 0, 2], dtype=torch.int64)
    part = _kernels.moments_grad_hess(cross, shifts[lanes].contiguous(),
                                      pd[lanes].contiguous(), S, inv_err2,
                                      lanes)
    torch.testing.assert_close(part, full[lanes], rtol=0, atol=0)
    torch.testing.assert_close(
        full, _kernels.moments_grad_hess_plain(cross, shifts, pd, S,
                                               inv_err2), rtol=0, atol=0)
    assert bool((full[2, :, 3] == 0.0).all())
    assert set(_kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("flags", [(1, 1, 0, 0, 0), (1, 0, 0, 0, 0)])
def test_fit_through_k1_grad_hess_matches_reference(flags, rng,
                                                    monkeypatch):
    """The batched no-scattering fit evaluates the solver through K1's
    epilogue B (its wrapper, counted here) and matches the reference:
    TOAs (phi at nu_DM) within 1 ns, rc and nfeval equal."""
    data, model, init, errs, weights, nu_fits = _batch_inputs(rng)
    sel = np.array([0, 1, 2, 3, 4, 6, 7])
    calls = []
    wrapped = _kernels.moments_grad_hess

    def counted(*a, **kw):
        calls.append(a[1].shape[0])
        return wrapped(*a, **kw)

    monkeypatch.setattr(_kernels, "moments_grad_hess", counted)
    kw = dict(errs=errs[sel], weights=weights[sel], fit_flags=flags,
              nu_fits=nu_fits[sel], log10_tau=False, max_iter=50)
    args = (data[sel], model, init[sel], np.full(len(sel), P0),
            np.broadcast_to(FREQS, (len(sel), NCHAN)))
    ref = jfp.fit_portrait_full_batch(*args, **kw)
    got = tfp.fit_portrait_full_batch(*args, device="cpu", **kw)
    assert calls and calls[0] == len(sel)     # the first: every subint
    dt = np.abs(got["phi"].numpy() - np.asarray(ref["phi"])) * P0
    assert dt.max() < 1e-9
    np.testing.assert_array_equal(got["return_code"].numpy(),
                                  np.asarray(ref["return_code"]))
    np.testing.assert_array_equal(got["nfeval"].numpy(),
                                  np.asarray(ref["nfeval"]))


def test_fit_phase_shift_core_matches_reference(rng):
    data, model, _, _ = _fake_batch(rng, 6)
    prof = data.mean(axis=1)
    mprof = np.broadcast_to(model.mean(axis=0), prof.shape).copy()
    err = rng.uniform(0.003, 0.006, 6)
    ref = jps._fit_phase_shift_core(prof, mprof, err, -0.5, 0.5, 100, 6)
    got = tps._fit_phase_shift_core(torch.as_tensor(prof),
                                    torch.as_tensor(mprof),
                                    torch.as_tensor(err), -0.5, 0.5, 100, 6)
    np.testing.assert_allclose(got.phase.numpy(), np.asarray(ref.phase),
                               rtol=0, atol=1e-10)
    for key in ("phase_err", "scale", "scale_err", "snr", "red_chi2"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-9, err_msg=key)


def test_fit_phase_shift_entry_point_cpu(rng):
    data, model, phis, _ = _fake_batch(rng, 3, noise=0.005)
    out = tps.fit_phase_shift(data[:, 12], model[12], device="cpu")
    assert out.phase.dtype == torch.float64
    assert out.phase.shape == (3,)
    assert torch.isfinite(out.phase_err).all()


def _batch_inputs(rng):
    data, model, phis, dDMs = _fake_batch(rng, 8)
    weights = np.ones((8, NCHAN))
    weights[:, 9] = 0.0          # one zapped channel everywhere
    weights[5] = 0.0
    weights[5, 20] = 1.0         # one subint with a single live channel
    errs = np.full((8, NCHAN), 0.02)
    init = np.zeros((8, 5))
    init[:, 0] = phis + rng.normal(0.0, 3e-3, 8)
    init[:, 1] = DM0
    wok = weights > 0
    nu_fit = (FREQS * wok).sum(-1) / wok.sum(-1)
    nu_fits = np.stack([nu_fit] * 3, axis=1)
    return data, model, init, errs, weights, nu_fits


def _compare_fits(ref, got, lanes):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["return_code"], ref["return_code"])
    np.testing.assert_array_equal(got["nfeval"], ref["nfeval"])
    np.testing.assert_allclose(got["phi"], ref["phi"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["DM"], ref["DM"], rtol=1e-9)
    # covariances relative to their diagonals: at the zero-covariance
    # frequency the phi-DM term is rounding noise around 0
    cov_r, cov_t = ref["covariance_matrix"], got["covariance_matrix"]
    d = np.sqrt(np.abs(np.einsum("bii->bi", cov_r)))
    np.testing.assert_array_less(np.abs(cov_t - cov_r),
                                 1e-7 * d[:, :, None] * d[:, None, :])
    for key in ("phi_err", "DM_err", "red_chi2",
                "chi2", "snr", "nu_DM", "scales", "scale_errs",
                "channel_snrs"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-7,
                                   err_msg="%s (lanes %s)" % (key, lanes))


def test_fit_portrait_full_batch_matches_reference(rng):
    data, model, init, errs, weights, nu_fits = _batch_inputs(rng)
    multi = np.array([i for i in range(8) if i != 5])
    single = np.array([5])
    for sel, flags in ((multi, (1, 1, 0, 0, 0)), (single, (1, 0, 0, 0, 0))):
        kw = dict(errs=errs[sel], weights=weights[sel], fit_flags=flags,
                  nu_fits=nu_fits[sel], log10_tau=False, max_iter=50)
        ref = jfp.fit_portrait_full_batch(
            data[sel], model, init[sel], np.full(len(sel), P0),
            np.broadcast_to(FREQS, (len(sel), NCHAN)), **kw)
        got = tfp.fit_portrait_full_batch(
            data[sel], model, init[sel], np.full(len(sel), P0),
            np.broadcast_to(FREQS, (len(sel), NCHAN)), device="cpu", **kw)
        _compare_fits(ref, got, sel)


def test_fit_portrait_full_batch_chunking_is_transparent(rng):
    data, model, init, errs, weights, nu_fits = _batch_inputs(rng)
    sel = np.array([0, 1, 2, 3])
    kw = dict(errs=errs[sel], weights=weights[sel], nu_fits=nu_fits[sel],
              log10_tau=False, device="cpu")
    whole = tfp.fit_portrait_full_batch(data[sel], model, init[sel], P0,
                                        FREQS, **kw)
    chunked = tfp.fit_portrait_full_batch(data[sel], model, init[sel], P0,
                                          FREQS, scan_size=3, pad_to=8, **kw)
    for key in tfp.RESULT_KEYS:
        torch.testing.assert_close(chunked[key], whole[key], rtol=0, atol=0)


TAU_INJ = 4e-3  # [rot] at 1500 MHz, alpha -4
TAU_LO = math.log10(1.0 / (10 * NBIN))  # the pipeline's log10 tau bound


def _scat_inputs(rng, nsub=4, tau_inj=TAU_INJ):
    """A batch scattered by tau_inj [rot] at 1500 MHz (alpha -4), one
    zapped channel, and inits near the truth at the fit frequency."""
    model = _portrait()
    taus = tau_inj * (FREQS / 1500.0) ** -4.0
    x = 2.0 * np.pi * np.arange(NBIN // 2 + 1) * taus[:, None]
    smodel = np.fft.irfft(np.fft.rfft(model, axis=-1) / (1.0 + 1j * x),
                          NBIN, axis=-1)
    phis = rng.uniform(-0.3, 0.3, nsub)
    dDMs = rng.normal(0.0, 2e-3, nsub)
    data = np.empty((nsub, NCHAN, NBIN))
    for i in range(nsub):
        sh = -phis[i] - Dconst * (DM0 + dDMs[i]) * (
            FREQS ** -2 - 1500.0 ** -2) / P0
        data[i] = _rotate(smodel, sh) + 0.02 * rng.standard_normal(
            (NCHAN, NBIN))
    weights = np.ones((nsub, NCHAN))
    weights[:, 9] = 0.0
    wok = weights > 0
    nu_fit = (FREQS * wok).sum(-1) / wok.sum(-1)
    init = np.zeros((nsub, 5))
    init[:, 0] = phis + Dconst * (DM0 + dDMs) * (
        nu_fit ** -2 - 1500.0 ** -2) / P0 + rng.normal(0.0, 3e-3, nsub)
    init[:, 1] = DM0
    init[:, 4] = -4.0
    return dict(data=data, model=model, init=init, weights=weights,
                errs=np.full((nsub, NCHAN), 0.02),
                nu_fits=np.stack([nu_fit] * 3, axis=1))


def _scat_case(rng, flags, log10_tau, fixed_tau=False):
    """(args, kwargs) of a batched fit of ``flags`` on _scat_inputs: tau
    starts 1.5x off when fitted and at the truth when fixed; the
    scattering-free flag sets fit unscattered data from tau 0."""
    scat = bool(flags[3] or flags[4] or fixed_tau)
    c = _scat_inputs(rng, tau_inj=TAU_INJ if scat else 0.0)
    nsub = len(c["data"])
    tau0 = TAU_INJ if fixed_tau else 1.5 * TAU_INJ
    if scat:
        c["init"][:, 3] = math.log10(tau0) if log10_tau else tau0
        bounds = [(None, None)] * 3 + [
            (TAU_LO if log10_tau else 0.0, None), (-10.0, 10.0)]
    else:
        c["init"][:, 3] = -math.inf if log10_tau else 0.0
        bounds = None
    args = (c["data"], c["model"], c["init"], np.full(nsub, P0),
            np.broadcast_to(FREQS, (nsub, NCHAN)))
    kw = dict(errs=c["errs"], weights=c["weights"], fit_flags=flags,
              nu_fits=c["nu_fits"], bounds=bounds, log10_tau=log10_tau,
              max_iter=50)
    return args, kw


def _compare_scat_fits(ref, got, what, nfev_lanes=()):
    """rc and nfeval equal (``nfev_lanes``: lanes that may stop one
    iteration apart); phi, referenced to the reference's nu_DM, within
    1 ns; DM and GM within 1e-9 of their value or 1e-6 of their error
    (a lane at the arithmetic floor may take one more ulp-sized step in
    one package: GM 5e-9 on (1,0,1,0,0) lane 1); log10 tau
    within 5e-7 and alpha within 1e-5 (the JAX package's own bounds for
    its two scattering forms, tests/test_fit_portrait.py:313-324); nu_*,
    errors, chi2 and the covariance within 1e-5."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["return_code"], ref["return_code"],
                                  err_msg=what)
    keep = np.setdiff1d(np.arange(len(ref["nfeval"])), nfev_lanes)
    np.testing.assert_array_equal(got["nfeval"][keep], ref["nfeval"][keep],
                                  err_msg=what)
    assert np.all(np.abs(got["nfeval"] - ref["nfeval"]) <= 1), what
    # phi is the phase at nu_DM, a zero-covariance frequency that rounding
    # in its sums moves by ~1e-8 relative on ill-conditioned lanes
    phi = got["phi"] + Dconst * got["DM"] / P0 * (
        ref["nu_DM"] ** -2.0 - got["nu_DM"] ** -2.0)
    dphi = (phi - ref["phi"] + 0.5) % 1.0 - 0.5
    assert np.abs(dphi).max() * P0 < 1e-9, (what, dphi)
    for key in ("DM", "GM"):
        tol = np.maximum(1e-9 * np.abs(ref[key]), 1e-6 * ref[key + "_err"])
        assert np.all(np.abs(got[key] - ref[key]) <= tol + 1e-300), \
            (what, key, got[key], ref[key])
    np.testing.assert_allclose(got["tau"], ref["tau"], rtol=0, atol=5e-7,
                               err_msg=what)
    np.testing.assert_allclose(got["alpha"], ref["alpha"], rtol=0,
                               atol=1e-5, err_msg=what)
    cov_r, cov_t = ref["covariance_matrix"], got["covariance_matrix"]
    d = np.sqrt(np.abs(np.einsum("bii->bi", cov_r)))
    np.testing.assert_array_less(np.abs(cov_t - cov_r),
                                 1e-5 * d[:, :, None] * d[:, None, :])
    for key in ("nu_DM", "nu_GM", "nu_tau", "phi_err", "DM_err", "GM_err",
                "tau_err", "alpha_err", "red_chi2", "chi2", "snr",
                "scales", "scale_errs", "channel_snrs"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                   err_msg="%s %s" % (what, key))


# Every fit on these inputs stops on the same iteration in both packages
# (rc and nfeval equal on all lanes); on (1,1,0,1,1) with log10 tau lane 1
# ends 1.3e-8 apart in log10 tau, inside the tau/alpha bounds above.  The
# scattering-free sets fit a linear tau of 0, as the pipeline does: a
# log10 tau of -inf makes the plateau exit's trial - x NaN in both
# packages, and a lane at the arithmetic floor then ends on a 1-ulp
# accept/reject of f.
@pytest.mark.parametrize("flags,log10_tau,fixed_tau", [
    ((1, 1, 0, 1, 1), True, False),
    ((1, 1, 0, 1, 1), False, False),
    ((1, 1, 0, 1, 0), True, False),
    ((1, 1, 1, 1, 1), True, False),
    ((1, 0, 1, 0, 0), False, False),
    ((1, 1, 1, 0, 0), False, False),
    ((1, 1, 1, 1, 0), True, False),
    ((0, 0, 0, 1, 1), True, False),
    ((1, 1, 0, 0, 0), True, True),    # a fixed nonzero tau
    ((1, 1, 0, 0, 0), False, True),
])
def test_gm_and_scattering_fits_match_reference(flags, log10_tau, fixed_tau,
                                                rng):
    args, kw = _scat_case(rng, flags, log10_tau, fixed_tau)
    ref = jfp.fit_portrait_full_batch(*args, **kw)
    got = tfp.fit_portrait_full_batch(*args, device="cpu", **kw)
    _compare_scat_fits(ref, got, "%s log10_tau=%s" % (flags, log10_tau))


@pytest.mark.parametrize("flags", [(1, 1, 1, 0, 0), (1, 1, 0, 1, 0),
                                   (1, 1, 0, 1, 1)])
def test_unported_flags_raise(flags, rng):
    """The GM and scattering flag sets through the single-subint
    fit_portrait_full, with the zero-covariance frequencies of option 1
    (the roots flag set's other form), match the reference."""
    args, kw = _scat_case(rng, flags, log10_tau=bool(flags[3]))
    one = dict(errs=kw["errs"][0], weights=kw["weights"][0],
               nu_fits=tuple(kw["nu_fits"][0]), fit_flags=flags,
               bounds=kw["bounds"], log10_tau=kw["log10_tau"], option=1)
    data, model, init = args[0][0], args[1], args[2][0]
    ref = jfp.fit_portrait_full(data, model, init, P0, FREQS, **one)
    got = tfp.fit_portrait_full(data, model, init, P0, FREQS, device="cpu",
                                **one)
    _compare_scat_fits({k: np.asarray(v)[None] for k, v in ref.items()},
                       {k: v[None] for k, v in got.items()}, str(flags))


def test_seeded_fit_matches_reference_and_explicit_seed(rng):
    """init_params=None seeds the phases through K2's function from the
    live-channel band averages: the fit matches the reference's seeded
    fit, and the port's fit from those seeds given explicitly."""
    data, model, init, errs, weights, nu_fits = _batch_inputs(rng)
    sel = np.array([0, 1, 2, 3])
    kw = dict(errs=errs[sel], weights=weights[sel], nu_fits=nu_fits[sel],
              log10_tau=False, max_iter=50)
    args = (data[sel], model, None, P0, FREQS)
    ref = jfp.fit_portrait_full_batch(*args, **kw)
    got = tfp.fit_portrait_full_batch(*args, device="cpu", **kw)
    _compare_fits(ref, got, sel)
    seeds = tfp._seed_phases(torch.as_tensor(data[sel]),
                             torch.as_tensor(model),
                             torch.as_tensor(errs[sel]),
                             torch.as_tensor(weights[sel]))
    init0 = np.zeros((len(sel), 5))
    init0[:, 0] = seeds.numpy()
    again = tfp.fit_portrait_full_batch(data[sel], model, init0, P0, FREQS,
                                        device="cpu", **kw)
    for key in tfp.RESULT_KEYS:
        torch.testing.assert_close(again[key], got[key], rtol=0, atol=0)
    with pytest.raises(ValueError, match="seeding"):
        tfp.fit_portrait_full_batch(data[:2], model, None, P0, FREQS,
                                    fit_flags=(1, 1, 0, 1, 1), device="cpu")


def test_get_scales_and_fit_portrait_match_reference(rng):
    data, model, init, errs, weights, nu_fits = _batch_inputs(rng)
    params = np.array([0.021, DM0 + 1e-3, 0.0, math.log10(2e-3), -4.0])
    want = jfp.get_scales_full(params, data[0], model, P0, FREQS, 1480.0,
                               1500.0, 1500.0)
    have = tfp.get_scales_full(params, data[0], model, P0, FREQS, 1480.0,
                               1500.0, 1500.0, device="cpu")
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-10)
    want = jfp.get_scales(data[0], model, 0.021, DM0, P0, FREQS)
    have = tfp.get_scales(data[0], model, 0.021, DM0, P0, FREQS,
                          device="cpu")
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-10)
    ref = jfp.fit_portrait(data[0], model, init[0, :2], P0, FREQS,
                           errs=errs[0])
    got = tfp.fit_portrait(data[0], model, init[0, :2], P0, FREQS,
                           errs=errs[0], device="cpu")
    assert int(got.return_code) == int(ref.return_code)
    assert int(got.nfeval) == int(ref.nfeval)
    np.testing.assert_allclose(float(got.phase), float(ref.phase), rtol=0,
                               atol=1e-9)
    for key in ("phase_err", "DM", "DM_err", "nu_ref", "red_chi2", "snr"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=1e-7, err_msg=key)
    # at the zero-covariance frequency the phase-DM covariance is rounding
    # noise around 0: compare it on the scale of the two errors
    assert abs(float(got.covariance) - float(ref.covariance)) < \
        1e-7 * float(ref.phase_err * ref.DM_err)


def test_objective_and_phase_objective_match_reference(rng):
    cross, abs_m2, inv_err2 = _spectra(rng)
    params = np.array([0.021, 1.5e-3, 0.0, 0.0, 0.0])
    args = (cross, abs_m2, inv_err2, FREQS, P0, 1432.1, 1500.0, 1500.0,
            False, NBIN)
    np.testing.assert_allclose(
        float(tfp.portrait_objective(params, *args, scat=False)),
        float(jfp.portrait_objective(params, *args, scat=False)),
        rtol=1e-12)
    phase = rng.uniform(-0.5, 0.5, 3)
    cr = cross[:3]
    err = np.array([0.7, 1.1, 1.3])
    want = jps.phase_shift_objective(phase, cr, err)
    have = tps.phase_shift_objective(torch.as_tensor(phase),
                                     torch.as_tensor(cr),
                                     torch.as_tensor(err))
    for h, w in zip(have, want):
        w = np.asarray(w)
        np.testing.assert_allclose(h.numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())


def test_fit_portrait_full_single_matches_reference(rng):
    data, model, init, errs, weights, nu_fits = _batch_inputs(rng)
    kw = dict(errs=errs[0], fit_flags=(1, 1, 0, 0, 0), log10_tau=False)
    ref = jfp.fit_portrait_full(data[0], model, init[0], P0, FREQS, **kw)
    got = tfp.fit_portrait_full(data[0], model, init[0], P0, FREQS,
                                device="cpu", **kw)
    assert int(got.return_code) == int(ref.return_code)
    assert int(got.nfeval) == int(ref.nfeval)
    np.testing.assert_allclose(float(got.phi), float(ref.phi), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(float(got.DM), float(ref.DM), rtol=1e-9)
    for key in ("phi_err", "DM_err", "red_chi2", "nu_DM", "snr"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   rtol=1e-7, err_msg=key)
