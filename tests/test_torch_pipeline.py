"""The whole wideband pptoas slice: the port's CLI against the JAX one.

Two 4-subint x 32-channel x 256-bin archives written by the JAX package's
make_fake_pulsar (one zapped channel, one subint with a single live
channel) go through both packages' ``pptoas`` command lines — the port
with ``--device cpu`` — with and without ``--no_bary`` and under the
other supported options; a third (a subint with two live channels, one
with one) under the GM and scattering options.  The .tim files must
agree: TOA MJDs within 1 ns, identical flag sets, and the same values
for every flag (the scattering flags within the tau/alpha bounds of the
fit tests).  The model (examples/example.gmodel) scatters with TAU = 20
us at 1500 MHz, so every archive is scattered.
"""

import os

import numpy as np
import pytest

from pulseportraiture_tpu.cli import pptoas as jcli
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu_torch.cli import pptoas as tcli
from torch_tim import assert_same_tim as _assert_same_tim

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits here add many variants to the JAX package's jit
    caches, whose size tests/test_retrace_budget.py holds to a budget in
    whatever test process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pptoas")
    files = []
    for i, (phase, dDM) in enumerate([(0.123, 2e-3), (-0.31, -1e-3)]):
        w = np.ones((4, 32))
        w[:, 11] = 0.0
        if i == 1:
            w[2] = 0.0
            w[2, 17] = 1.0  # a subint with one live channel
        out = str(tmp / ("a%d.fits" % i))
        make_fake_pulsar(GMODEL, PAR, out, nsub=4, nchan=32, nbin=256,
                         tsub=60.0, phase=phase, dDM=dDM, weights=w,
                         noise_stds=0.05, seed=20 + i, quiet=True)
        files.append(out)
    meta = str(tmp / "archives.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    return tmp, meta


@pytest.mark.parametrize("extra", [
    [], ["--no_bary"], ["--nu_ref", "1400", "--print_parangle"],
    ["--nu_ref", "inf", "--no_bary"], ["--fix_DM"],
    ["-T", "--DM", "34.5", "--flags", "pta,TEST"]],
    ids=["bary", "topo", "nu_ref", "nu_ref_inf", "fix_DM", "tscrunch"])
def test_pptoas_tim_matches_reference(archives, extra):
    tmp, meta = archives
    tag = "_".join(a.strip("-") for a in extra) or "bary"
    args = ["-d", meta, "-m", GMODEL, "--print_phase", "--quiet"] + extra
    tref = str(tmp / ("ref_%s.tim" % tag))
    tport = str(tmp / ("port_%s.tim" % tag))
    assert jcli.main(args + ["-o", tref]) == 0
    assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
    _assert_same_tim(tport, tref, 2 if "-T" in extra else 8)


def test_pptoas_per_subint_frequencies_match_reference(tmp_path):
    """A foreign archive whose channel frequencies drift between subints
    (one model per subint).  The template does not fit it (red chi2
    ~1e3, one non-finite DM error): the two packages must still agree
    on every printed value."""
    fits = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "t2pred_style.fits")
    args = ["-d", fits, "-m", GMODEL, "--no_bary", "--quiet"]
    tref, tport = str(tmp_path / "r.tim"), str(tmp_path / "p.tim")
    assert jcli.main(args + ["-o", tref]) == 0
    assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
    _assert_same_tim(tport, tref, 3)


def test_pptoas_princeton_and_one_DM(archives):
    tmp, meta = archives
    base = ["-d", meta, "-m", GMODEL, "--no_bary", "--quiet"]
    for flags in (["-f", "princeton"], ["--one_DM"]):
        name = "_".join(f.strip("-") for f in flags)
        tref = str(tmp / ("ref_%s.out" % name))
        tport = str(tmp / ("port_%s.out" % name))
        extra = ["--errfile", tport + ".err"] if "princeton" in flags \
            else []
        assert jcli.main(base + flags + ["-o", tref] + (
            ["--errfile", tref + ".err"] if extra else [])) == 0
        assert tcli.main(base + flags + ["-o", tport, "--device", "cpu"]
                         + extra) == 0
        ref = open(tref).read().splitlines()
        port = open(tport).read().splitlines()
        assert len(port) == len(ref)
        if extra:
            np.testing.assert_allclose(
                np.loadtxt(tport + ".err"), np.loadtxt(tref + ".err"),
                rtol=1e-5)
        else:
            assert all("-DM_mean" in ln for ln in port[1:])


@pytest.mark.parametrize("flag", ["--fit_scat", "--fit_dt4", "--psrchive",
                                  "--showplot"])
def test_unported_cli_flags_fail(archives, flag, capsys):
    """Options still to port fail and say so; --fit_scat and --fit_dt4
    run and match the JAX CLI on the same archives."""
    tmp, meta = archives
    if flag in ("--fit_scat", "--fit_dt4"):
        args = ["-d", meta, "-m", GMODEL, "--quiet", flag]
        tref = str(tmp / ("ref_%s.tim" % flag.strip("-")))
        tport = str(tmp / ("port_%s.tim" % flag.strip("-")))
        assert jcli.main(args + ["-o", tref]) == 0
        assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
        _assert_same_tim(tport, tref, 8, freq_rtol=1e-7)
        return
    rc = tcli.main(["-d", meta, "-m", GMODEL, "--device", "cpu", flag])
    assert rc != 0
    assert "not yet ported" in capsys.readouterr().err


@pytest.fixture(scope="module")
def scat_archive(tmp_path_factory):
    """4 x 32 x 256, one zapped channel; subint 1 has two live channels
    (the degraded GM group), subint 3 one."""
    tmp = tmp_path_factory.mktemp("torch_pptoas_scat")
    w = np.ones((4, 32))
    w[:, 11] = 0.0
    w[1] = 0.0
    w[1, [4, 27]] = 1.0
    w[3] = 0.0
    w[3, 17] = 1.0
    out = str(tmp / "s.fits")
    make_fake_pulsar(GMODEL, PAR, out, nsub=4, nchan=32, nbin=256,
                     tsub=60.0, phase=0.21, dDM=1e-3, weights=w,
                     noise_stds=0.02, seed=31, quiet=True)
    return tmp, out


@pytest.mark.parametrize("extra", [
    ["--fit_scat"], ["--fit_scat", "--fix_alpha", "--no_bary"],
    ["--fit_scat", "--no_logscat"],
    ["--fit_scat", "--scat_guess", "3e-5,1400,-4.2"],
    ["--fit_scat", "--nu_tau", "1400", "--nu_ref", "1500"],
    ["--fit_dt4"], ["--fit_dt4", "--fit_scat"]],
    ids=["scat", "fix_alpha", "no_logscat", "scat_guess", "nu_tau", "dt4",
         "dt4_scat"])
def test_pptoas_scattering_and_gm_tim_matches_reference(scat_archive, extra):
    tmp, arch = scat_archive
    tag = "_".join(a.strip("-").replace(",", "_") for a in extra)
    args = ["-d", arch, "-m", GMODEL, "--print_phase", "--quiet"] + extra
    tref = str(tmp / ("ref_%s.tim" % tag))
    tport = str(tmp / ("port_%s.tim" % tag))
    assert jcli.main(args + ["-o", tref]) == 0
    assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
    _assert_same_tim(tport, tref, 4, freq_rtol=1e-7)


def test_pptoas_per_subint_frequencies_fit_scat_matches_reference(tmp_path):
    """The drifting-frequency archive (one model per subint) with
    --fit_scat."""
    fits = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "t2pred_style.fits")
    args = ["-d", fits, "-m", GMODEL, "--no_bary", "--quiet", "--fit_scat"]
    tref, tport = str(tmp_path / "r.tim"), str(tmp_path / "p.tim")
    assert jcli.main(args + ["-o", tref]) == 0
    assert tcli.main(args + ["-o", tport, "--device", "cpu"]) == 0
    _assert_same_tim(tport, tref, 3, freq_rtol=1e-7)
