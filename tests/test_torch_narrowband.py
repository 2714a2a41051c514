"""Narrowband TOAs: the port against the JAX package, and the per-profile
chunking of the portrait fit's spectra.

A 4-subint x 32-channel x 256-bin archive written by the JAX package's
make_fake_pulsar (channel 11 zapped everywhere, subint 2 with one live
channel) goes through both packages' ``pptoas --narrowband`` — the port
with ``--device cpu`` and the plain versions of its kernels — phase-only
and with ``--fit_scat`` (log10 tau and ``--no_logscat``), printing the
phase, flux and parallactic-angle flags and extra flags.  Pass criteria:

* .tim files (tests/torch_tim.py): TOAs within 1 ns, identical flag
  sets, every printed value to its last printed digit (the scattering
  flags within the bounds of tests/test_torch_fit.py; with fit_scat the
  errors and the phase-tau covariance within 1e-4 relative, as below);
* GetTOAs arrays, phase-only: every array within 1e-12 of its largest
  magnitude (one FFTFIT per profile, the same float64 arithmetic);
* with fit_scat: phases within 1e-8 rot (0.03 ns at the archive's
  2.89 ms), scales and fluxes within 1e-7 relative, log10 tau within
  2e-6 (linear tau 1e-6 relative), the errors and covariances, which
  come from the Hessian at the point where each fit stopped, within 1e-4
  relative; ``nfevals`` and ``rcs`` equal on every lane.
"""

import os

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.cli import pptoas as jcli
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.pipelines.toas import GetTOAs as JGetTOAs
from pulseportraiture_tpu_torch.cli import pptoas as tcli
from pulseportraiture_tpu_torch.fit import portrait as tfp
from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs as TGetTOAs
from torch_tim import assert_same_tim

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")
N_TOAS = 3 * 31 + 1


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever test
    process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_narrowband")
    w = np.ones((4, 32))
    w[:, 11] = 0.0
    w[2] = 0.0
    w[2, 17] = 1.0
    out = str(tmp / "nb.fits")
    make_fake_pulsar(GMODEL, PAR, out, nsub=4, nchan=32, nbin=256,
                     tsub=60.0, phase=0.123, dDM=2e-3, weights=w,
                     noise_stds=0.05, seed=20, quiet=True)
    return tmp, out


@pytest.mark.parametrize("extra", [[], ["--fit_scat"],
                                   ["--fit_scat", "--no_logscat"]],
                         ids=["phase", "scat", "scat_linear"])
def test_narrowband_tim_matches_reference(archive, extra):
    tmp, arch = archive
    tag = "_".join(a.strip("-") for a in extra) or "phase"
    args = ["-d", arch, "-m", GMODEL, "--narrowband", "--print_phase",
            "--print_flux", "--print_parangle", "--flags", "pta,TEST",
            "--quiet"] + extra
    tref = str(tmp / ("ref_%s.tim" % tag))
    tport = str(tmp / ("port_%s.tim" % tag))
    assert jcli.main(args + ["-o", tref]) == 0
    assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
    assert_same_tim(tport, tref, N_TOAS, flag_rtol=dict.fromkeys(
        ("phs_err", "log10_scat_time_err", "scat_time_err", "phi_tau_cov",
         "flux_err"), 1e-4) if extra else None)


@pytest.mark.parametrize("flag", ["--narrowband", "--print_flux"])
def test_ported_cli_flags_match_reference(archive, flag):
    """Options the port once refused: each alone on the CLI's defaults,
    against the JAX CLI (one TOA per live channel with --narrowband, per
    subint without)."""
    tmp, arch = archive
    args = ["-d", arch, "-m", GMODEL, "--quiet", flag]
    tref = str(tmp / ("ref_alone_%s.tim" % flag.strip("-")))
    tport = str(tmp / ("port_alone_%s.tim" % flag.strip("-")))
    assert jcli.main(args + ["-o", tref]) == 0
    assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
    assert_same_tim(tport, tref, N_TOAS if flag == "--narrowband" else 4,
                    freq_rtol=1e-7)


def _close(got, want, rtol, atol=0.0, what=""):
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, what
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    scale = max(np.abs(want[ok]).max(), 1e-300) if ok.any() else 1.0
    err = np.abs(got[ok] - want[ok]).max() if ok.any() else 0.0
    assert err <= atol + rtol * scale, (what, err, err / scale)


@pytest.mark.parametrize("kw", [dict(), dict(fit_scat=True),
                                dict(fit_scat=True, log10_tau=False)],
                         ids=["phase", "scat", "scat_linear"])
def test_narrowband_arrays_match_reference(archive, kw):
    _, arch = archive
    ref = JGetTOAs(arch, GMODEL, quiet=True)
    ref.get_narrowband_TOAs(print_flux=True, **kw)
    port = TGetTOAs(arch, GMODEL, quiet=True, device="cpu")
    port.get_narrowband_TOAs(print_flux=True, **kw)
    assert port.ok_isubs[0].tolist() == ref.ok_isubs[0].tolist()
    np.testing.assert_array_equal(port.nfevals[0], ref.nfevals[0])
    np.testing.assert_array_equal(port.rcs[0], ref.rcs[0])
    assert len(port.TOA_list) == len(ref.TOA_list) == N_TOAS
    scat = kw.get("fit_scat", False)
    tight = 1e-12
    if not scat:
        tol = {key: (tight, 0.0) for key in (
            "phis", "phi_errs", "taus", "tau_errs", "scales", "scale_errs",
            "profile_fluxes", "profile_flux_errs", "covariances")}
    else:
        tol = dict(phis=(0.0, 1e-8), scales=(1e-7, 0.0),
                   profile_fluxes=(1e-7, 0.0),
                   taus=(0.0, 2e-6) if kw.get("log10_tau", True)
                   else (1e-6, 0.0))
        for key in ("phi_errs", "tau_errs", "scale_errs", "covariances",
                    "profile_flux_errs"):
            tol[key] = (1e-4, 0.0)
    tol.update(channel_snrs=(1e-10, 0.0), channel_red_chi2s=(1e-10, 0.0))
    for key, (rtol, atol) in tol.items():
        _close(getattr(port, key)[0], getattr(ref, key)[0], rtol, atol,
               key)
    np.testing.assert_array_equal(port.TOA_errs[0] != 0,
                                  ref.TOA_errs[0] != 0)
    for tp, tr in zip(port.TOA_list, ref.TOA_list):
        dt = (tp.MJD.day - tr.MJD.day) * 86400.0 + (tp.MJD.secs - tr.MJD.secs)
        assert abs(dt) < 1e-9
        assert tp.frequency == tr.frequency
        assert list(tp.flags) == list(tr.flags)


def test_narrowband_cli_refusals(archive, capsys):
    """The JAX CLI's refusals: --one_DM and --checkpoint are wideband-only;
    --psrchive is not ported.  --showplot runs and draws nothing, as in
    the JAX CLI: the .tim equals the run without it."""
    tmp, arch = archive
    base = ["-d", arch, "-m", GMODEL, "--narrowband", "--device", "cpu"]
    assert tcli.main(base + ["--one_DM"]) == 1
    assert tcli.main(base + ["--checkpoint", "x.tim"]) == 1
    assert "cannot be combined" in capsys.readouterr().err
    assert tcli.main(base + ["--psrchive"]) == 2
    assert "not yet ported" in capsys.readouterr().err
    tims = [str(tmp / ("nb_showplot%d.tim" % on)) for on in (1, 0)]
    assert tcli.main(base + ["--showplot", "--quiet", "-o", tims[0]]) == 0
    assert tcli.main(base + ["--quiet", "-o", tims[1]]) == 0
    text = open(tims[0]).read()
    assert len(text.splitlines()) == N_TOAS + 1   # FORMAT and the TOAs
    assert text == open(tims[1]).read()


def test_spectra_chunks_by_profiles(monkeypatch):
    """A one-channel batch of more than 64 lanes (the narrowband fit_scat
    shape) gives the same cross, |m|^2 and Sd whatever the chunk size,
    and a 512-channel batch keeps chunks of 64 subints."""
    rng = np.random.default_rng(4)
    data = torch.as_tensor(rng.standard_normal((300, 1, 64)))
    model = torch.as_tensor(rng.standard_normal((300, 1, 64)))
    inv_err2 = torch.as_tensor(rng.uniform(0.5, 2.0, (300, 1)))
    whole = tfp._spectra(data, model, 20, inv_err2)[:3]
    for rows in (1, 7, 64, 299, 100000):
        part = tfp._spectra(data, model, 20, inv_err2, rows=rows)[:3]
        for a, b in zip(part, whole):
            assert torch.equal(a, b)
    calls = []
    real = torch.fft.rfft

    def counting(x, *a, **k):
        calls.append(x.shape[0])
        return real(x, *a, **k)

    monkeypatch.setattr(torch.fft, "rfft", counting)
    tfp._spectra(data, model[0], 20, inv_err2)
    assert calls == [1, 300]          # the shared model, one data chunk
    calls.clear()
    tfp._spectra(torch.zeros((130, 512, 8), dtype=torch.float64),
                 torch.zeros((512, 8), dtype=torch.float64), 5,
                 torch.ones((130, 512), dtype=torch.float64))
    assert calls == [512, 64, 64, 2]  # the model, then 64 subints a chunk
