"""The plotting entry points of the port's CLIs and the Gaussian selector,
against the JAX package's.

The archives of tests/test_cli_viz_zap.py (written by the JAX package's
make_fake_pulsar: 2 subints x 16 channels x 128 bins with two hot
channels, and a clean one-subint archive) go through both packages'
``ppzap --hist``, ``ppspline --plots``, ``ppgauss --figure`` and
``ppgauss --interactive`` (the port with ``--device cpu``).  The ppzap
histograms are held together by their data (tests/torch_figs.py:
counts exact, bin edges within 1e-9 of the largest, as the channel
reduced chi2s agree within 1e-10, tests/test_torch_zap.py), and every
figure file the JAX CLI writes, the port writes under the same name.
The GaussianSelector's state machine and its matplotlib event wiring
are driven the same way in both packages: sketched components equal,
fitted parameters within 1e-6 of their errors and chi2 within 1e-10
relative (tests/test_torch_lm_gauss.py), the drawn curves within 1e-6
of their peak.  On a headless
backend ``--interactive`` exits 1 in both.  matplotlib's Agg backend
throughout.
"""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from matplotlib.backend_bases import (KeyEvent, MouseButton,  # noqa: E402
                                      MouseEvent)

from pulseportraiture_tpu.cli import ppgauss as jgauss_cli  # noqa: E402
from pulseportraiture_tpu.cli import ppspline as jspline_cli  # noqa: E402
from pulseportraiture_tpu.cli import ppzap as jzap_cli  # noqa: E402
from pulseportraiture_tpu.fit import portrait as jfp  # noqa: E402
from pulseportraiture_tpu.io.archive import make_fake_pulsar  # noqa: E402
from pulseportraiture_tpu.io.gmodel import write_model  # noqa: E402
from pulseportraiture_tpu.ops.profiles import \
    gen_gaussian_profile  # noqa: E402
from pulseportraiture_tpu.viz.selector import \
    GaussianSelector as JSelector  # noqa: E402
from pulseportraiture_tpu_torch.cli import ppgauss as tgauss_cli  # noqa
from pulseportraiture_tpu_torch.cli import ppspline as tspline_cli  # noqa
from pulseportraiture_tpu_torch.cli import ppzap as tzap_cli  # noqa: E402
from pulseportraiture_tpu_torch.models.gauss import \
    GaussianModelPortrait as TGaussPortrait  # noqa: E402
from pulseportraiture_tpu_torch.viz.selector import \
    GaussianSelector as TSelector  # noqa: E402
from torch_figs import assert_same_figure  # noqa: E402

MODEL_PARAMS = np.array([0.02, 0.0, 0.40, 0.0, 0.05, 0.0, 1.0, -0.5])
Z_TOL = 1e-6      # |port - reference| / error of each fitted parameter
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _close_figs():
    yield
    plt.close("all")


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference's TOA fits add variants to the JAX package's jit
    caches, which tests/test_retrace_budget.py holds to a budget in
    whatever test process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_vizcli")
    gm = str(tmp / "f.gmodel")
    write_model(gm, "fake", "000", 1500.0, MODEL_PARAMS,
                np.ones(8, int), -4.0, 0, quiet=True)
    par = str(tmp / "f.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 100.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    noise = np.full(16, 0.005)
    noise[3] = 0.08
    noise[11] = 0.05
    hot = str(tmp / "hot.fits")
    make_fake_pulsar(gm, par, hot, nsub=2, nchan=16, nbin=128, nu0=1500.0,
                     bw=800.0, tsub=60.0, noise_stds=noise,
                     dedispersed=False, seed=3, quiet=True)
    clean = str(tmp / "clean.fits")
    make_fake_pulsar(gm, par, clean, nsub=1, nchan=16, nbin=128,
                     nu0=1500.0, bw=800.0, tsub=60.0, noise_stds=0.004,
                     dedispersed=True, seed=4, quiet=True)
    return tmp, gm, par, hot, clean


@pytest.mark.parametrize("threshold", ["1.3", "0.9"])
def test_cli_ppzap_hist(setup, threshold):
    """``ppzap -m --hist`` saves <datafiles>_ppzap_hist.png with the JAX
    CLI's histogram: the same counts, edges, threshold line, labels and
    title (the channels above -R and the channel count)."""
    tmp, gm, par, hot, clean = setup
    png = hot + "_ppzap_hist.png"
    figs = []
    for cli, extra in ((jzap_cli, []), (tzap_cli, CPU)):
        plt.close("all")
        if os.path.exists(png):
            os.remove(png)
        out = str(tmp / ("zap_h_%s.cmds" % threshold))
        assert cli.main(["-d", hot, "-m", gm, "-o", out, "--hist",
                         "-R", threshold, "--quiet"] + extra) == 0
        assert os.path.getsize(png) > 1000
        figs.append(plt.gcf())
    ref, port = figs
    assert_same_figure(port, ref, rtol=1e-9)
    ax = port.axes[0]
    assert len(ax.patches) == 32   # 2 subints x 16 channels: 32 bins
    assert sum(p.get_height() for p in ax.patches) == 32
    assert ax.get_title().endswith("> %.1f" % float(threshold))
    assert ax.get_xlabel() == r"Reduced $\chi^2$"
    # without -m there is no post-fit chi2: no histogram is drawn
    plt.close("all")
    os.remove(png)
    assert tzap_cli.main(["-d", hot, "-o", str(tmp / "zap_n.cmds"),
                          "--hist", "--quiet"] + CPU) == 0
    assert not os.path.exists(png)


def _same_fit(got, want):
    """Two profile fits (fit_gaussian_profile) agree: dof equal,
    parameters within Z_TOL of their errors, chi2 1e-10 relative."""
    assert got.dof == want.dof
    err = np.asarray(want.fit_errs)
    z = np.abs(np.asarray(got.fitted_params)
               - np.asarray(want.fitted_params))
    z = np.where(np.isfinite(err), z / np.where(err > 0, err, 1.0), 0.0)
    assert z.max() <= Z_TOL, z
    np.testing.assert_allclose(got.chi2, want.chi2, rtol=1e-10)


def _same_state(tsel, jsel, fitted):
    assert tsel.ngauss == jsel.ngauss
    assert tsel.done == jsel.done
    assert (tsel.last_fit is None) == (jsel.last_fit is None)
    if fitted:
        _same_fit(tsel.last_fit, jsel.last_fit)
    # fitted components (kept after a removal) within the fits' bound
    np.testing.assert_allclose(np.reshape(tsel.init_params, -1),
                               np.reshape(jsel.init_params, -1), rtol=0,
                               atol=1e-6)


def test_gaussian_selector_state_machine():
    """Selector state transitions, display-free: sketch -> fit ->
    remove -> result, the port's against the JAX package's."""
    nbin = 256
    true = [0.01, 0.0, 0.30, 0.04, 1.0, 0.62, 0.08, 0.5]
    prof = np.asarray(gen_gaussian_profile(true, nbin))
    rng = np.random.default_rng(7)
    noise = 0.01
    data = prof + rng.normal(0, noise, nbin)

    jsel = JSelector(data, noise, show_instructions=False)
    tsel = TSelector(data, noise, show_instructions=False, device="cpu")
    assert tsel.dc == jsel.dc
    np.testing.assert_array_equal(tsel.errs, jsel.errs)
    for sel in (jsel, tsel):
        sel.add_from_drag(0.27, 0.34, 0.9)
        sel.add_from_drag(0.57, 0.66, 0.45)
    _same_state(tsel, jsel, fitted=False)
    assert tsel.init_params == jsel.init_params   # sketched, not fitted
    for sel in (jsel, tsel):
        sel.redraw()
    assert_same_figure(tsel.fig, jsel.fig, rtol=1e-12)
    assert tsel.ngauss == 2 and len(tsel.init_params) == 8
    fit = tsel.fit()
    jsel.fit()
    _same_state(tsel, jsel, fitted=True)
    locs = sorted([tsel.components[0][0], tsel.components[1][0]])
    assert abs(locs[0] - 0.30) < 0.005
    assert abs(locs[1] - 0.62) < 0.005
    assert fit.chi2 / fit.dof < 1.5
    # the drawn profile, components, fitted curve and residual
    for sel in (jsel, tsel):
        sel.redraw()
    assert len(tsel.ax_resid.get_lines()) == 1
    assert_same_figure(tsel.fig, jsel.fig, rtol=1e-6)
    # remove invalidates the fit; result() refits the remaining one
    for sel in (jsel, tsel):
        sel.remove_last()
    _same_state(tsel, jsel, fitted=False)
    assert tsel.ngauss == 1 and tsel.last_fit is None
    assert tsel.result() is not None and jsel.result() is not None
    _same_state(tsel, jsel, fitted=True)
    for sel in (jsel, tsel):
        sel.finish()
    assert tsel.done and jsel.done
    # scattering: a zero tau seed is lifted off its bound, as by the JAX
    # package, and the fit runs with tau free
    jsel = JSelector(data, noise, fixscat=False, show_instructions=False)
    tsel = TSelector(data, noise, fixscat=False, show_instructions=False,
                     device="cpu")
    assert tsel.tau == jsel.tau == 0.1
    for sel in (jsel, tsel):
        sel.add_from_drag(0.27, 0.34, 0.9)
        sel.fit()
    _same_state(tsel, jsel, fitted=True)


def test_gaussian_selector_events():
    """The selector through real matplotlib events (Agg backend): a
    left drag sketches, a middle click fits, a right click removes, 'q'
    finishes; the port's state equals the JAX package's after each."""
    nbin = 128
    prof = np.asarray(gen_gaussian_profile([0.0, 0.0, 0.5, 0.06, 1.0],
                                           nbin))
    rng = np.random.default_rng(3)
    data = prof + rng.normal(0, 0.02, nbin)
    jsel = JSelector(data, 0.02, show_instructions=False)
    tsel = TSelector(data, 0.02, show_instructions=False, device="cpu")

    def mouse(name, x, y, button):
        for sel in (jsel, tsel):
            px, py = sel.ax_prof.transData.transform((x, y))
            ev = MouseEvent(name, sel.canvas, px, py, button=button)
            sel.canvas.callbacks.process(name, ev)

    mouse("button_press_event", 0.44, 0.2, MouseButton.LEFT)
    mouse("motion_notify_event", 0.52, 0.8, MouseButton.LEFT)
    np.testing.assert_allclose(tsel._span.get_x(), jsel._span.get_x())
    mouse("button_release_event", 0.56, 0.9, MouseButton.LEFT)
    assert tsel.ngauss == 1
    np.testing.assert_allclose(tsel.components, jsel.components,
                               rtol=1e-12)
    mouse("button_press_event", 0.5, 0.5, MouseButton.MIDDLE)
    assert tsel.last_fit is not None
    _same_state(tsel, jsel, fitted=True)
    assert abs(tsel.components[0][0] - 0.5) < 0.01
    mouse("button_press_event", 0.5, 0.5, MouseButton.RIGHT)
    assert tsel.ngauss == 0 and jsel.ngauss == 0
    for sel in (jsel, tsel):
        sel.canvas.callbacks.process(
            "key_press_event", KeyEvent("key_press_event", sel.canvas, "q"))
    assert tsel.done and jsel.done


def test_cli_ppgauss_interactive_headless(setup, capsys):
    """--interactive on a headless backend exits 1 with the JAX CLI's
    message instead of a traceback; GaussianModelPortrait.fit_profile raises
    the same RuntimeError."""
    tmp, gm, par, hot, clean = setup
    assert jgauss_cli.main(["-d", clean, "--interactive",
                            "-o", str(tmp / "ij.gmodel")]) == 1
    ref_err = capsys.readouterr().err
    assert tgauss_cli.main(["-d", clean, "--interactive",
                            "-o", str(tmp / "it.gmodel")] + CPU) == 1
    err = capsys.readouterr().err
    assert "headless" in err and err == ref_err
    assert not os.path.exists(str(tmp / "it.gmodel"))
    dp = TGaussPortrait(clean, quiet=True, device="cpu")
    with pytest.raises(RuntimeError, match="headless"):
        dp.fit_profile(dp.portx.mean(axis=0), interactive=True)


def test_cli_ppgauss_figure(setup):
    """--figure saves the final model's data/model/residual figure, as
    the JAX CLI does."""
    tmp, gm, par, hot, clean = setup
    for tag, cli, extra in (("j", jgauss_cli, []), ("t", tgauss_cli, CPU)):
        png = str(tmp / ("gfig_%s.png" % tag))
        assert cli.main(["-d", clean, "--autogauss", "0.05",
                         "-o", str(tmp / ("gfig_%s.gmodel" % tag)),
                         "--figure", png] + extra) == 0
        assert os.path.getsize(png) > 1000


def test_cli_ppspline_plots(setup):
    """--plots writes the JAX CLI's three figures, named after the model
    (-l): the eigenprofiles, the spline projections and the residuals.
    The archive's profile evolves (examples/example.gmodel), so the
    model has eigenprofiles to draw."""
    tmp, gm, par, hot, clean = setup
    examples = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples")
    evo = str(tmp / "evo.fits")
    make_fake_pulsar(os.path.join(examples, "example.gmodel"),
                     os.path.join(examples, "example.par"), evo, nsub=1,
                     nchan=32, nbin=128, nu0=1500.0, bw=800.0, tsub=60.0,
                     noise_stds=0.01, dedispersed=True, seed=5, quiet=True)
    written = {}
    for tag, cli, extra in (("j", jspline_cli, []),
                            ("t", tspline_cli, CPU)):
        name = str(tmp / ("spl_%s" % tag))
        before = set(os.listdir(tmp))
        assert cli.main(["-d", evo, "-o", name + ".spl", "-l", name,
                         "-n", "4", "--plots", "--quiet"] + extra) == 0
        new = set(os.listdir(tmp)) - before
        written[tag] = sorted(f[len("spl_j"):] for f in new
                              if f.endswith(".png"))
        for f in new:
            if f.endswith(".png"):
                assert os.path.getsize(str(tmp / f)) > 1000
    assert written["t"] == written["j"] == [".eigs.png", ".proj.png",
                                            ".resids.png"]
