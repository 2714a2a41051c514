"""The spline model builder (ppspline) and DataPortrait: the port against
the JAX package on the CPU.

Archives: a bright 2-subint x 32-channel x 256-bin archive of
examples/example.gmodel (an evolving, scattered two-component pulsar)
from the JAX package's make_fake_pulsar for the model, two half-band
archives for the join path, and a fainter 2-subint archive to time.  The
port runs with ``device="cpu"``.

Pass criteria: the DataPortrait arrays within 1e-12 of their largest
magnitude (the flux power-law fit within 1e-6 of its errors);
``make_spline_model``'s model portrait at the data's frequencies within
1e-8 relative, with the same significant eigenvectors (the eigenvector
signs are the eigensolver's in both packages and may differ: the model
does not depend on them); each package reads the other's .spl into the
same portrait within 1e-8; pptoas with each package's .spl: TOAs within
1 ns (tests/torch_tim.py).
"""

import os

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.cli import ppspline as jspl_cli
from pulseportraiture_tpu.cli import pptoas as jtoas_cli
from pulseportraiture_tpu.dataportrait import DataPortrait as JDP
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import load_data, make_fake_pulsar
from pulseportraiture_tpu.io.splmodel import read_spline_model as jread
from pulseportraiture_tpu.models.spline import make_spline_model as jmake
from pulseportraiture_tpu_torch.cli import ppspline as tspl_cli
from pulseportraiture_tpu_torch.cli import pptoas as ttoas_cli
from pulseportraiture_tpu_torch.dataportrait import DataPortrait as TDP
from pulseportraiture_tpu_torch.io.splmodel import read_spline_model as tread
from pulseportraiture_tpu_torch.models.spline import \
    make_spline_model as tmake
from torch_tim import assert_same_tim

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")
EXACT_TOL = 1e-12
MODEL_TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU tensors run fastest on one intra-op thread; more
    threads only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference's fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever test
    process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_spline")
    w = np.ones((2, 32))
    w[:, 9] = 0.0
    bright = str(tmp / "bright.fits")
    make_fake_pulsar(GMODEL, PAR, bright, nsub=2, nchan=32, nbin=256,
                     tsub=60.0, noise_stds=0.005, weights=w, seed=42,
                     quiet=True)
    bands = []
    for i, nu0 in enumerate((1300.0, 1700.0)):
        path = str(tmp / ("band%d.fits" % i))
        make_fake_pulsar(GMODEL, PAR, path, nsub=1, nchan=8, nbin=256,
                         nu0=nu0, bw=400.0, tsub=60.0, phase=0.02 * i,
                         noise_stds=0.01, seed=60 + i, quiet=True)
        bands.append(path)
    meta = str(tmp / "bands.meta")
    with open(meta, "w") as f:
        f.write("\n".join(bands) + "\n")
    arch = str(tmp / "epoch.fits")
    make_fake_pulsar(GMODEL, PAR, arch, nsub=2, nchan=32, nbin=256,
                     tsub=60.0, phase=0.13, dDM=5e-4, noise_stds=0.03,
                     seed=43, quiet=True)
    return tmp, bright, meta, arch


_ATTRS = ("port", "portx", "noise_stdsxs", "flux_prof", "flux_profx",
          "freqs", "SNRsxs", "weights")


def _same_state(t, j, tol=EXACT_TOL, attrs=_ATTRS):
    for key in attrs:
        assert _rel(getattr(t, key), getattr(j, key)) <= tol, key


def test_dataportrait_methods_match_reference(setup, tmp_path):
    """normalize (every method) and unnormalize, smooth_portrait (plain
    and smart), rotate_stuff, fit_flux_profile, unload_archive."""
    _, bright, _, _ = setup
    j, t = JDP(bright, quiet=True), TDP(bright, quiet=True, device="cpu")
    _same_state(t, j)
    for method in ("mean", "max", "rms", "abs", "prof"):
        j.normalize_portrait(method)
        t.normalize_portrait(method)
        _same_state(t, j)
        j.unnormalize_portrait()
        t.unnormalize_portrait()
        _same_state(t, j)
    j.rotate_stuff(0.1, 2e-3)
    t.rotate_stuff(0.1, 2e-3)
    _same_state(t, j)
    fj, ft = j.fit_flux_profile(), t.fit_flux_profile()
    for key in ("amp", "alpha"):
        assert abs(ft[key] - fj[key]) <= 1e-6 * fj[key + "_err"]
        np.testing.assert_allclose(ft[key + "_err"], fj[key + "_err"],
                                   rtol=1e-6)
    out_j, out_t = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    j.unload_archive(out_j)
    t.unload_archive(out_t)
    a, b = load_data(out_j, quiet=True), load_data(out_t, quiet=True)
    np.testing.assert_array_equal(b.subints, a.subints)
    for kw in (dict(), dict(smart=True)):
        j.smooth_portrait(**kw)
        t.smooth_portrait(**kw)
        _same_state(t, j, tol=1e-10)


def test_dataportrait_join_matches_reference(setup, tmp_path):
    """A metafile of two bands: the joined, frequency-sorted arrays, the
    FFTFIT join seeds, apply_joinfile (and undo), and the joinfile
    written and read back."""
    _, _, meta, _ = setup
    j, t = JDP(meta, quiet=True), TDP(meta, quiet=True, device="cpu")
    assert t.njoin == j.njoin == 2
    _same_state(t, j)
    np.testing.assert_allclose(t.join_params, j.join_params, rtol=0,
                               atol=1e-12)
    for a, b in zip(t.join_ichans + t.join_ichanxs,
                    j.join_ichans + j.join_ichanxs):
        np.testing.assert_array_equal(a, b)
    for undo in (False, True):
        j.apply_joinfile(1500.0, undo=undo)
        t.apply_joinfile(1500.0, undo=undo)
        _same_state(t, j)
    t.join_params[2:] = [0.011, -3e-4]
    jf = t.write_join_parameters(str(tmp_path / "bands.join"))
    again = TDP(meta, joinfile=jf, quiet=True, device="cpu")
    np.testing.assert_allclose(again.join_params, [0.0, 0.0, 0.011, -3e-4],
                               atol=1e-10)
    ref = JDP(meta, joinfile=jf, quiet=True)
    np.testing.assert_array_equal(again.join_params, ref.join_params)


@pytest.mark.parametrize("smooth", [False, True], ids=["raw", "smoothed"])
def test_make_spline_model_matches_reference(setup, smooth):
    _, bright, _, _ = setup
    j, t = JDP(bright, quiet=True), TDP(bright, quiet=True, device="cpu")
    j.normalize_portrait("prof")
    t.normalize_portrait("prof")
    bj = jmake(j, max_ncomp=6, smooth=smooth, snr_cutoff=50.0)
    bt = tmake(t, max_ncomp=6, smooth=smooth, snr_cutoff=50.0)
    np.testing.assert_array_equal(bt.ieig, bj.ieig)
    assert bt.ncomp == bj.ncomp >= 2
    assert _rel(bt.eigval, bj.eigval) <= 1e-10
    assert _rel(bt.mean_prof, bj.mean_prof) <= MODEL_TOL
    assert _rel(bt.modelx, bj.modelx) <= MODEL_TOL
    assert _rel(bt.model, bj.model) <= MODEL_TOL
    assert _rel(t.reconst_port, j.reconst_port) <= MODEL_TOL
    # the projections up to each eigenvector's sign
    sign = np.sign(np.sum(bt.eigvec * bj.eigvec, axis=0))
    assert _rel(bt.proj_port * sign, bj.proj_port) <= MODEL_TOL
    assert _rel(bt.eigvec * sign, bj.eigvec) <= MODEL_TOL


def test_ppspline_cli_spl_and_toas_match_reference(setup):
    """ppspline -s by both packages: each .spl read by both packages
    gives the same portrait at the archive's frequencies; -a writes the
    model archive; pptoas of each package with its own .spl (written to
    the same path in turn, which the TOA flags name): TOAs within 1 ns."""
    tmp, bright, _, arch = setup
    freqs = load_data(arch, quiet=True).freqs[0]
    path = str(tmp / "bright.spl")
    ports, tims, archs = {}, {}, {}
    for name, scli, tcli, extra in (
            ("ref", jspl_cli, jtoas_cli, []),
            ("port", tspl_cli, ttoas_cli, ["--device", "cpu"])):
        archs[name] = str(tmp / (name + "_model.fits"))
        assert scli.main(["-d", bright, "-o", path, "-s", "-n", "6",
                          "-S", "50", "-a", archs[name], "--quiet"]
                         + extra) == 0
        ports[name] = [np.asarray(jread(path, freqs)[1]),
                       tread(path, freqs, device="cpu")[1].numpy()]
        tims[name] = str(tmp / (name + ".tim"))
        assert tcli.main(["-d", arch, "-m", path, "--print_phase",
                          "--quiet", "-o", tims[name]] + extra) == 0
    ref = ports["ref"][0]
    for got in ports["ref"][1:] + ports["port"]:
        assert _rel(got, ref) <= MODEL_TOL
    a = load_data(archs["ref"], quiet=True)
    b = load_data(archs["port"], quiet=True)
    step = (a.subints.max(-1) - a.subints.min(-1)) / 32766
    assert np.all(np.abs(b.subints - a.subints)
                  <= MODEL_TOL * np.abs(a.subints).max()
                  + 1.001 * step[..., None])
    assert_same_tim(tims["port"], tims["ref"], 2)


def test_ppspline_cli_refuses_plots(setup):
    """--plots, refused until the plots were ported, writes the JAX CLI's
    three figures under the model name (-l)."""
    tmp, bright, _, _ = setup
    name = str(tmp / "plots")
    assert tspl_cli.main(["-d", bright, "-o", name + ".spl", "-l", name,
                          "--plots", "--quiet", "--device", "cpu"]) == 0
    for suffix in (".eigs.png", ".proj.png", ".resids.png"):
        assert os.path.getsize(name + suffix) > 1000
