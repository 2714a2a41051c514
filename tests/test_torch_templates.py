"""Wideband pptoas with spline and FITS templates, flux estimates and
instrumental responses: the port against the JAX package.

Archives: 4 subints x 32 channels x 256 bins from the JAX package's
make_fake_pulsar (channel 11 zapped, subint 2 with one live channel).
Templates: a PCA/B-spline model that the JAX package's
``models.spline.make_spline_model`` builds from one of them (the
ppspline path), and FITS templates written by make_fake_pulsar with one
subint and no noise (32 channels, and one channel, which the pipeline
tiles over the band).  The port runs with ``--device cpu`` (the plain
versions of its kernels).  Pass criteria: .tim files as in
tests/torch_tim.py (TOAs within 1 ns, identical flag sets, printed values
to their last digit); the flux arrays within 1e-9 relative.
"""

import os

import numpy as np
import pytest

from pulseportraiture_tpu.cli import pptoas as jcli
from pulseportraiture_tpu.dataportrait import DataPortrait
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.models.spline import make_spline_model, write_model
from pulseportraiture_tpu.pipelines.toas import GetTOAs as JGetTOAs
from pulseportraiture_tpu_torch.cli import pptoas as tcli
from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs as TGetTOAs
from torch_tim import assert_same_tim

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever test
    process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_templates")
    w = np.ones((4, 32))
    w[:, 11] = 0.0
    w[2] = 0.0
    w[2, 17] = 1.0
    arch = str(tmp / "d.fits")
    make_fake_pulsar(GMODEL, PAR, arch, nsub=4, nchan=32, nbin=256,
                     tsub=60.0, phase=0.21, dDM=1e-3, weights=w,
                     noise_stds=0.03, seed=41, quiet=True)
    # the spline model: built from a brighter archive of the same pulsar
    bright = str(tmp / "bright.fits")
    make_fake_pulsar(GMODEL, PAR, bright, nsub=2, nchan=32, nbin=256,
                     tsub=60.0, noise_stds=0.005, seed=42, quiet=True)
    spl = str(tmp / "model.spl")
    write_model(spl, make_spline_model(DataPortrait(bright, quiet=True),
                                       max_ncomp=4, smooth=False,
                                       snr_cutoff=50.0, quiet=True))
    templates = dict(spline=spl)
    for nchan in (32, 1):
        path = str(tmp / ("tmpl%d.fits" % nchan))
        make_fake_pulsar(GMODEL, PAR, path, nsub=1, nchan=nchan, nbin=256,
                         bw=800.0 if nchan > 1 else 25.0, tsub=60.0,
                         noise_stds=0.0, seed=0, quiet=True)
        templates["fits%d" % nchan] = path
    return tmp, arch, templates


@pytest.mark.parametrize("template", ["spline", "fits32", "fits1"])
@pytest.mark.parametrize("extra", [["--print_flux"],
                                   ["--print_flux", "--fit_scat"],
                                   ["--narrowband", "--print_flux"]],
                         ids=["flux", "flux_scat", "narrowband"])
def test_template_tim_matches_reference(setup, template, extra):
    tmp, arch, templates = setup
    tag = "%s_%s" % (template, "_".join(a.strip("-") for a in extra))
    args = ["-d", arch, "-m", templates[template], "--print_phase",
            "--quiet"] + extra
    tref = str(tmp / ("ref_%s.tim" % tag))
    tport = str(tmp / ("port_%s.tim" % tag))
    assert jcli.main(args + ["-o", tref]) == 0
    assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
    n = 3 * 31 + 1 if "--narrowband" in extra else 4
    assert_same_tim(tport, tref, n, freq_rtol=1e-7)


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("template", ["gmodel", "spline", "fits32"])
@pytest.mark.parametrize("ird", [
    dict(DM=1.0, wids=[], irf_types=[]),
    dict(DM=0.0, wids=[0.004], irf_types=["rect"]),
    dict(DM=1.0, wids=[0.004, 0.002], irf_types=["rect", "gauss"])],
    ids=["dm_smear", "rect", "dm_rect_gauss"])
def test_instrumental_response_and_flux_match_reference(setup, template,
                                                        ird):
    """gt.ird with DM smearing and constant-width responses, applied to
    the model of every template kind, with flux estimates."""
    _, arch, templates = setup
    model = GMODEL if template == "gmodel" else templates[template]
    ref = JGetTOAs(arch, model, quiet=True)
    port = TGetTOAs(arch, model, quiet=True, device="cpu")
    for gt in (ref, port):
        gt.ird.update(DM=ird["DM"], wids=list(ird["wids"]),
                      irf_types=list(ird["irf_types"]))
        gt.get_TOAs(bary=False, print_flux=True,
                    add_instrumental_response=True)
    assert len(port.TOA_list) == len(ref.TOA_list) == 4
    for tp, tr in zip(port.TOA_list, ref.TOA_list):
        dt = (tp.MJD.day - tr.MJD.day) * 86400.0 + (tp.MJD.secs - tr.MJD.secs)
        assert abs(dt) < 1e-9
        assert list(tp.flags) == list(tr.flags)
    for key in ("profile_fluxes", "profile_flux_errs", "fluxes",
                "flux_errs", "flux_freqs"):
        assert _rel(getattr(port, key)[0], getattr(ref, key)[0]) <= 1e-9, key
    np.testing.assert_array_equal(port.nfevals[0], ref.nfevals[0])
    np.testing.assert_array_equal(port.rcs[0], ref.rcs[0])


def test_fits_template_nbin_mismatch_skips_archive(setup, tmp_path, capsys):
    """A FITS template whose nbin is not the archive's: the archive is
    skipped with the JAX package's message."""
    _, arch, _ = setup
    tmpl = str(tmp_path / "t128.fits")
    make_fake_pulsar(GMODEL, PAR, tmpl, nsub=1, nchan=32, nbin=128,
                     tsub=60.0, noise_stds=0.0, seed=0, quiet=True)
    gt = TGetTOAs(arch, tmpl, quiet=True, device="cpu")
    gt.get_TOAs()
    assert gt.TOA_list == [] and gt.ok_idatafiles == []
    assert "Model nbin != data nbin" in capsys.readouterr().out


@pytest.mark.parametrize("extra", [["--print_flux"],
                                   ["--print_flux", "--fit_scat"],
                                   ["--narrowband", "--print_flux"]],
                         ids=["flux", "flux_scat", "narrowband"])
def test_per_subint_frequencies_match_reference(tmp_path, extra):
    """A foreign archive whose channel frequencies drift between subints
    (one model per subint): flux estimates and narrowband TOAs."""
    fits = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "t2pred_style.fits")
    args = ["-d", fits, "-m", GMODEL, "--no_bary", "--quiet"] + extra
    tref, tport = str(tmp_path / "r.tim"), str(tmp_path / "p.tim")
    assert jcli.main(args + ["-o", tref]) == 0
    assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
    assert_same_tim(tport, tref, 9 if "--narrowband" in extra else 3,
                    freq_rtol=1e-7)
