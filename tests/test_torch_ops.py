"""Parity of the PyTorch port's array ops and I/O with the JAX reference.

Seeded numpy inputs go through the JAX function and its port on the CPU
(noise and S/N, rotation, Gaussian model portraits from .gmodel files),
and the port's load_data decodes the vendored foreign-archive fixtures
to their committed expected values.
"""

import os

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.io import archive as jarch
from pulseportraiture_tpu.io import gmodel as jgm
from pulseportraiture_tpu.ops import fourier as jfo
from pulseportraiture_tpu.ops import noise as jno
from pulseportraiture_tpu.ops import profiles as jpr
from pulseportraiture_tpu_torch import compat
from pulseportraiture_tpu_torch.io import archive as tarch
from pulseportraiture_tpu_torch.io import gmodel as tgm
from pulseportraiture_tpu_torch.ops import fourier as tfo
from pulseportraiture_tpu_torch.ops import noise as tno
from pulseportraiture_tpu_torch.ops import profiles as tpr
from pulseportraiture_tpu_torch.utils.databunch import DataBunch

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
EXAMPLES = os.path.join(HERE, os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")


def _close(have, want, atol=1e-12):
    have = have.numpy() if isinstance(have, torch.Tensor) else have
    np.testing.assert_allclose(have, np.asarray(want), rtol=0, atol=atol)


def _pulses(rng, shape, nbin=128):
    x = (np.arange(nbin) + 0.5) / nbin
    loc = rng.uniform(0.2, 0.8, shape)[..., None]
    return np.exp(-0.5 * ((x - loc) / 0.03) ** 2) \
        + 0.1 * rng.standard_normal(shape + (nbin,))


def test_get_bin_centers():
    for nbin in (1, 2, 7, 256, 2048):
        have = tfo.get_bin_centers(nbin)
        assert have.dtype == torch.float64 and have.shape == (nbin,)
        _close(have, jfo.get_bin_centers(nbin), 1e-15)


@pytest.mark.parametrize("frac", [4, 8])
def test_get_noise_PS(frac, rng):
    data = rng.standard_normal((3, 5, 128))
    _close(tno.get_noise_PS(torch.as_tensor(data), frac=frac),
           jno.get_noise_PS(data, frac=frac))


def test_get_SNR(rng):
    prof = _pulses(rng, (4, 6))
    _close(tno.get_SNR(torch.as_tensor(prof)), jno.get_SNR(prof), 1e-10)


def test_phasor_and_apply(rng):
    shifts = rng.uniform(-3000.0, 3000.0, (4, 5))
    _close(tfo.phasor(torch.as_tensor(shifts), 65).real,
           np.real(jfo.phasor(shifts, 65)))
    _close(tfo.phasor(torch.as_tensor(shifts), 65).imag,
           np.imag(jfo.phasor(shifts, 65)))


@pytest.mark.parametrize("nu_ref", ["scalar", "inf", "per_subint"])
def test_rotate_data(nu_ref, rng):
    data = _pulses(rng, (3, 8))
    freqs = np.linspace(1200.0, 1800.0, 8)
    Ps = np.array([0.004, 0.005, 0.0061])
    ref = {"scalar": 1500.0, "inf": np.inf,
           "per_subint": rng.uniform(1400, 1600, 3)[:, None]}[nu_ref]
    want = jfo.rotate_data(data, 0.13, 0.0021, Ps, freqs, ref)
    have = tfo.rotate_data(torch.as_tensor(data), 0.13, 0.0021, Ps, freqs,
                           ref)
    _close(have, want)


def test_rotate_profile_and_portrait_phase_only(rng):
    prof = _pulses(rng, ())
    _close(tfo.rotate_profile(torch.as_tensor(prof), 0.37),
           jfo.rotate_profile(prof, 0.37))
    port = _pulses(rng, (5,))
    _close(tfo.rotate_data(torch.as_tensor(port), -0.21),
           jfo.rotate_data(port, -0.21))


@pytest.mark.parametrize("code", ["000", "101"])
def test_gen_gaussian_portrait(code, rng):
    params = np.array([0.01, 3.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2,
                       0.55, 0.02, 0.03, 0.0, 0.4, -0.8])
    if code == "101":  # linear loc and amp laws: slopes per MHz
        params[[3, 7, 13]] = [1e-4, -1e-3, -5e-4]
    freqs = np.linspace(1100.0, 1900.0, 16)
    phases = np.asarray(jfo.get_bin_centers(256))
    want = jpr.gen_gaussian_portrait(code, params, -4.0, phases, freqs,
                                     1500.0)
    have = tpr.gen_gaussian_portrait(code, params, -4.0, phases, freqs,
                                     1500.0)
    _close(have, want)


def test_read_model_example_gmodel():
    """examples/example.gmodel has TAU != 0: the scattered model build."""
    freqs = np.linspace(1150.0, 1850.0, 24)
    phases = np.asarray(jfo.get_bin_centers(512))
    want = jgm.read_model(GMODEL, phases, freqs, 0.0029, quiet=True)
    have = tgm.read_model(GMODEL, phases, freqs, 0.0029, quiet=True)
    assert have[:2] == want[:2]
    _close(have[2], want[2])
    meta_t = tgm.read_model(GMODEL)
    meta_j = jgm.read_model(GMODEL)
    for a, b in zip(meta_t, meta_j):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_write_model_roundtrip(tmp_path):
    path = str(tmp_path / "m.gmodel")
    params = np.array([0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2])
    tgm.write_model(path, "m", "000", 1500.0, params, np.zeros(8, int),
                    -4.0, 0, quiet=True)
    name, code, nu_ref, ngauss, got, _, alpha, _ = tgm.read_model(path)
    assert (name, code, nu_ref, ngauss, alpha) == ("m", "000", 1500.0, 1,
                                                   -4.0)
    np.testing.assert_allclose(got, params, rtol=0, atol=1e-8)


_FIXTURES = {
    "psrchive_style": dict(pscrunch=True, rm_baseline=False),
    "t2pred_style": dict(rm_baseline=False),
    "stokes_style": dict(rm_baseline=False),
}


@pytest.mark.parametrize("name", sorted(_FIXTURES))
def test_load_data_fixtures(name):
    path = os.path.join(DATA, name + ".fits")
    exp = np.load(os.path.join(DATA, name + "_expected.npz"))
    kw = _FIXTURES[name]
    d = tarch.load_data(path, quiet=True, **kw)
    if name == "psrchive_style":
        # pscrunch of AABBCRCI forms AA+BB; channel 2 is zapped
        _close(d.subints[:, 0], exp["data"][:, 0] + exp["data"][:, 1], 1e-9)
        np.testing.assert_array_equal(d.freqs[0], exp["freqs"])
        assert all(set(np.asarray(o)) == {0, 1, 3} for o in d.ok_ichans)
    elif name == "t2pred_style":
        np.testing.assert_allclose(d.Ps, exp["periods"], rtol=1e-12)
        _close(d.subints, exp["data"])
    else:
        assert d.state == "Stokes" and d.subints.shape[1] == 4
        _close(d.subints, exp["data"])
        np.testing.assert_array_equal(d.Ps, exp["periods"])
    # the statistics computed on CPU tensors match the reference's
    j = jarch.load_data(path, quiet=True, **kw)
    for key in ("noise_stds", "SNRs", "phases", "weights", "prof"):
        _close(d[key], j[key], 1e-10)
    for key in ("prof_noise", "prof_SNR", "DM", "nbin", "nchan", "nsub"):
        np.testing.assert_allclose(d[key], j[key], rtol=1e-10)
    assert [e.mjd() for e in d.epochs] == [e.mjd() for e in j.epochs]


def test_make_fake_pulsar_roundtrip(tmp_path):
    par = os.path.join(EXAMPLES, "example.par")
    w = np.ones((3, 8))
    w[1, 2] = 0.0
    out = tarch.make_fake_pulsar(GMODEL, par, str(tmp_path / "f.fits"),
                                 nsub=3, nchan=8, nbin=64, phase=0.1,
                                 dDM=1e-3, weights=w, noise_stds=0.01,
                                 seed=5)
    d = tarch.load_data(out, quiet=True)
    assert d.subints.shape == (3, 1, 8, 64)
    np.testing.assert_array_equal(d.weights, w)
    assert not d.dmc and abs(d.DM - 34.5678) < 1e-9
    # the first n subints do not depend on nsub (one draw per subint)
    out2 = tarch.make_fake_pulsar(GMODEL, par, str(tmp_path / "g.fits"),
                                  nsub=2, nchan=8, nbin=64, phase=0.1,
                                  dDM=1e-3, weights=w[:2], noise_stds=0.01,
                                  seed=5)
    d2 = tarch.load_data(out2, quiet=True)
    np.testing.assert_array_equal(d2.subints, d.subints[:2])


def test_from_reference_converts_arrays():
    bunch = jarch.load_data(os.path.join(DATA, "t2pred_style.fits"),
                            rm_baseline=False, quiet=True)
    conv = compat.from_reference(bunch, device="cpu")
    assert isinstance(conv, DataBunch) and conv.nsub == bunch.nsub
    assert isinstance(conv.subints, torch.Tensor)
    assert conv.subints.dtype == torch.float64
    np.testing.assert_array_equal(conv.subints.numpy(), bunch.subints)
    assert conv.epochs is bunch.epochs and conv.source == bunch.source
    init = compat.from_reference(np.zeros(5), device="cpu")
    assert init.shape == (5,) and init.dtype == torch.float64
    got = compat.from_reference({"model": np.ones((2, 4))}, device="cpu")
    assert type(got) is dict and got["model"].shape == (2, 4)


def test_scattering_and_transforms_match_reference(rng):
    from pulseportraiture_tpu.fit import transforms as jtr
    from pulseportraiture_tpu.ops import scattering as jsc
    from pulseportraiture_tpu_torch.fit import transforms as ttr
    from pulseportraiture_tpu_torch.ops import scattering as tsc
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    freqs = np.linspace(1100.0, 1900.0, 9)
    _close(tsc.scattering_times(1e-3, -4.0, freqs, 1500.0),
           jsc.scattering_times(1e-3, -4.0, freqs, 1500.0))
    for tau in (0.0, 2e-3):
        have = tsc.scattering_profile_FT(tau, 64)
        want = np.asarray(jsc.scattering_profile_FT(tau, 64))
        _close(have.real, want.real)
        _close(have.imag, want.imag)
    _close(ttr.DM_delay(30.0, freqs, 1500.0, P=0.005),
           jtr.DM_delay(30.0, freqs, 1500.0, P=0.005), 1e-9)
    _close(ttr.phase_transform(0.3, 30.0, 1400.0, 1600.0, 0.005, mod=True),
           jtr.phase_transform(0.3, 30.0, 1400.0, 1600.0, 0.005, mod=True),
           1e-12)
    snr = rng.uniform(5.0, 50.0, 9)
    np.testing.assert_allclose(ttr.guess_fit_freq(freqs, snr),
                               float(jtr.guess_fit_freq(freqs, snr)),
                               rtol=1e-13)
    from pulseportraiture_tpu.utils.mjd import MJD as JMJD

    t = ttr.calculate_TOA(MJD.from_mjd(56000.25), 0.005, 0.1, 30.0, 1400.0,
                          np.inf)
    r = jtr.calculate_TOA(JMJD.from_mjd(56000.25), 0.005, 0.1, 30.0,
                          1400.0, np.inf)
    assert t.day == r.day and abs(t.secs - r.secs) < 1e-12
