"""Parity of the PyTorch port's fits with the JAX reference on the CPU.

The same seeded numpy inputs go through the JAX function and its port
(the port's plain PyTorch kernels, device="cpu"): the per-channel
moments (kernel K1's function), the flags-masked gradient/Hessian, the
FFTFIT core (kernel K2's function) and the batched (phi, DM) fit.
"""

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
    assert _kernels.LAUNCHES == {"moments": 0, "fftfit": 0}


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


@pytest.mark.parametrize("flags", [(1, 1, 1, 0, 0), (1, 1, 0, 1, 0),
                                   (1, 1, 0, 1, 1)])
def test_unported_flags_raise(flags, rng):
    data, model, init, errs, weights, nu_fits = _batch_inputs(rng)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tfp.fit_portrait_full_batch(data[:2], model, init[:2], P0, FREQS,
                                    fit_flags=flags, device="cpu")


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
