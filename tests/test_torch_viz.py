"""The port's plotting layer (viz, viz.figdata) against the JAX package's.

Every figure function of pulseportraiture_tpu_torch.viz draws the same
seeded numpy inputs as pulseportraiture_tpu.viz, and the two figures are
held together by their data, never their pixels (tests/torch_figs.py: each
axes' titles, labels, scales and limits, image arrays with their extent,
origin and color limits, line and scatter data with their styles and
colors, histogram outlines, tick labels, the suptitle and
``fig.pp_rchi2``).  Image and line data are exact where both packages
draw the same numpy input.  Numbers the port computes on the device
(figdata) are held to the JAX package's: the channel reduced chi2s to
rtol 1e-12 of the JAX package's per-channel get_red_chi2 loop, the
stacked profiles' FFTFIT to tests/test_torch_fftfit.py's bounds (phase
1e-10 rot, scale 1e-9 relative), a fitted subint (GetTOAs.show_fit) to
1e-10 of its largest magnitude, as tests/test_torch_zap.py holds
return_fit.  The contents asserted by tests/test_viz_content.py and
tests/test_cli_viz_zap.py::test_viz_smoke are asserted of the port's
figures too.  The port runs with ``device="cpu"``; matplotlib's Agg
backend throughout.
"""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pulseportraiture_tpu import viz as jviz  # noqa: E402
from pulseportraiture_tpu.fit import portrait as jfp  # noqa: E402
from pulseportraiture_tpu.fit.phase_shift import \
    fit_phase_shift as jfit_phase_shift  # noqa: E402
from pulseportraiture_tpu.ops.fourier import \
    rotate_data as jrotate  # noqa: E402
from pulseportraiture_tpu.ops.noise import get_noise as jget_noise  # noqa
from pulseportraiture_tpu.ops.stats import get_red_chi2  # noqa: E402
from pulseportraiture_tpu_torch import viz as tviz  # noqa: E402
from pulseportraiture_tpu_torch.viz import figdata  # noqa: E402
from torch_figs import assert_near, assert_same_figure  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


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


def image_axes(fig):
    return [ax for ax in fig.axes if ax.images]


def make_port(nchan=8, nbin=32):
    rng = np.random.default_rng(3)
    port = np.zeros((nchan, nbin))
    port[:, 10] = np.linspace(1.0, 2.0, nchan)  # marker column
    return port + rng.normal(0, 0.01, port.shape)


def test_show_portrait_renders_the_array_unrotated():
    port = make_port()
    phases = np.linspace(0, 1, 32, endpoint=False)
    freqs = np.linspace(1100.0, 1900.0, 8)
    ref = jviz.show_portrait(port, phases=phases, freqs=freqs, title="t",
                             show=False)
    fig = tviz.show_portrait(port, phases=phases, freqs=freqs, title="t",
                             show=False)
    assert_same_figure(fig, ref)
    (ax,) = image_axes(fig)
    shown = np.asarray(ax.images[0].get_array())
    np.testing.assert_array_equal(shown, port)  # no transpose/flip
    assert ax.images[0].origin == "lower"
    ext = tuple(ax.images[0].get_extent())
    assert ext == (phases[0], phases[-1], freqs[0], freqs[-1])
    assert ax.get_xlabel() == "Phase [rot]"
    assert any(a.get_ylabel() == "Frequency [MHz]" for a in fig.axes)
    # tensors are drawn as the same numbers
    fig_t = tviz.show_portrait(torch.as_tensor(port),
                               phases=torch.as_tensor(phases),
                               freqs=torch.as_tensor(freqs), title="t",
                               show=False)
    assert_same_figure(fig_t, ref)


def test_show_portrait_rvrsd_flips_band():
    port = make_port()
    freqs = np.linspace(1100.0, 1900.0, 8)
    kw = dict(freqs=freqs, rvrsd=True, show=False, prof=False,
              fluxprof=False)
    fig = tviz.show_portrait(port, **kw)
    assert_same_figure(fig, jviz.show_portrait(port, **kw))
    (ax,) = image_axes(fig)
    np.testing.assert_array_equal(np.asarray(ax.images[0].get_array()),
                                  port[::-1])
    ext = tuple(ax.images[0].get_extent())
    assert ext[2] == freqs[-1] and ext[3] == freqs[0]


def test_show_residual_plot_panels_and_chi2_payload():
    rng = np.random.default_rng(11)
    nchan, nbin = 8, 32
    model = np.zeros((nchan, nbin))
    model[:, 12] = 1.0
    noise = np.full(nchan, 0.02)
    port = model + rng.normal(0, 0.02, model.shape)
    port[3] *= 1.5  # one misfit channel
    kw = dict(freqs=np.arange(nchan), noise_stds=noise, show=False)
    ref = jviz.show_residual_plot(port, model, **kw)
    fig = tviz.show_residual_plot(port, model, device=CPU, **kw)
    assert_same_figure(fig, ref, rtol=1e-12)
    data_ax, model_ax, resid_ax = image_axes(fig)[:3]
    np.testing.assert_array_equal(
        np.asarray(data_ax.images[0].get_array()), port)
    np.testing.assert_array_equal(
        np.asarray(model_ax.images[0].get_array()), model)
    np.testing.assert_array_equal(
        np.asarray(resid_ax.images[0].get_array()), port - model)
    assert [a.get_title() for a in (data_ax, model_ax, resid_ax)] == \
        ["Data", "Model", "Residuals"]
    clims = {a.images[0].get_clim() for a in (data_ax, model_ax,
                                              resid_ax)}
    assert len(clims) == 1
    want = np.array([
        float(np.asarray(get_red_chi2(port[i], model[i], errs=noise[i],
                                      dof=nbin)))
        for i in range(nchan)])
    np.testing.assert_allclose(fig.pp_rchi2, want, rtol=1e-12)
    assert np.argmax(fig.pp_rchi2) == 3
    assert fig.pp_rchi2[3] > 5 * np.median(fig.pp_rchi2)
    hist_ax = [ax for ax in fig.axes if ax.get_xlabel().startswith(
        "Red.")][0]
    assert f"total = {nchan}" in hist_ax.get_ylabel()
    # rvrsd and nfit, and resids given
    kw.update(rvrsd=True, nfit=2, resids=0.5 * (port - model))
    assert_same_figure(tviz.show_residual_plot(port, model, device=CPU,
                                               **kw),
                       jviz.show_residual_plot(port, model, **kw),
                       rtol=1e-12)


def test_show_residual_plot_zapped_channels_excluded():
    model = np.zeros((6, 16))
    model[:, 4] = 1.0
    port = model + 0.01
    port[2] = 0.0  # zapped channel: zero weight
    kw = dict(show=False, noise_stds=np.full(6, 0.01))
    fig = tviz.show_residual_plot(port, model, device=CPU, **kw)
    assert len(fig.pp_rchi2) == 5
    assert_same_figure(fig, jviz.show_residual_plot(port, model, **kw),
                       rtol=1e-12)


@pytest.mark.parametrize("nfit", [0, 2])
@pytest.mark.parametrize("given_noise", [True, False])
def test_residual_payload_equals_per_channel_loop(nfit, given_noise):
    """The batched reduced chi2 equals the JAX package's loop over
    get_red_chi2, one live channel at a time (rtol 1e-12); without
    noise_stds each live row's noise is get_noise of that row."""
    rng = np.random.default_rng(21 + nfit)
    nchan, nbin = 24, 64
    model = np.zeros((nchan, nbin))
    model[:, 20:26] = rng.uniform(0.5, 2.0, (nchan, 1))
    noise = rng.uniform(0.01, 0.05, nchan)
    port = model + noise[:, None] * rng.standard_normal((nchan, nbin))
    port[[2, 17]] = 0.0  # zapped
    live = port.mean(axis=1) != 0.0
    portx, modelx = port[live], model[live]
    if given_noise:
        noisex = noise[live]
    else:
        noisex = np.asarray(jget_noise(portx))
    want = np.array([float(np.asarray(get_red_chi2(
        portx[i], modelx[i], errs=noisex[i], dof=nbin - nfit)))
        for i in range(len(portx))])
    got = figdata.residual_payload(
        torch.as_tensor(port), torch.as_tensor(model),
        torch.as_tensor(noise) if given_noise else None, nfit)
    np.testing.assert_array_equal(got.live.numpy(), live)
    np.testing.assert_allclose(got.noise_stds.numpy(), noisex, rtol=1e-12)
    np.testing.assert_allclose(got.rchi2.numpy(), want, rtol=1e-12)


def test_show_profiles_offsets_and_colors():
    model = make_port(nchan=4)
    phases = (np.arange(32) + 0.5) / 32
    ref_fig, ref_ax = plt.subplots()
    jviz.show_profiles(model, phases=phases, offset=0.5, ax=ref_ax)
    fig, ax = plt.subplots()
    assert tviz.show_profiles(model, phases=phases, offset=0.5,
                              ax=ax) is ax
    assert_same_figure(fig, ref_fig)
    assert len(ax.collections) == 4
    for i, coll in enumerate(ax.collections):
        xy = np.asarray(coll.get_offsets())
        np.testing.assert_array_equal(xy[:, 0], phases)
        np.testing.assert_allclose(xy[:, 1], model[i] + 0.5 * i,
                                   atol=1e-14)
        want = plt.cm.Spectral((model[i] - model.min())
                               / (model.max() - model.min()))
        np.testing.assert_allclose(np.asarray(coll.get_facecolor()),
                                   want, atol=1e-12)
    # the defaults: bin-centre phases, offset range / nprof, current axes
    ref_fig = plt.figure()
    jviz.show_profiles(model)
    fig = plt.figure()
    tviz.show_profiles(model)
    assert_same_figure(fig, ref_fig)


def test_show_stacked_profiles_content_and_rvrsd():
    nchan, nbin = 12, 32
    rng = np.random.default_rng(7)
    data = np.zeros((nchan, nbin))
    data[:, 10] = np.linspace(1.0, 2.0, nchan)
    model = data + 0.0
    data = data + rng.normal(0, 0.01, data.shape)
    phases = (np.arange(nbin) + 0.5) / nbin
    freqs = np.linspace(1100.0, 1900.0, nchan)
    kw = dict(phases=phases, freqs=freqs, show=False)
    fig = tviz.show_stacked_profiles(data, model, **kw)
    assert_same_figure(fig, jviz.show_stacked_profiles(data, model, **kw))
    ax = fig.axes[0]
    lines = ax.get_lines()
    assert len(lines) == 2 * nchan
    off = (data.max() - data.min()) * 0.25
    for i in range(nchan):
        mline, dline = lines[2 * i], lines[2 * i + 1]
        assert mline.get_linestyle() == "--"
        assert dline.get_linestyle() == "-"
        assert dline.get_color() == mline.get_color()
        np.testing.assert_array_equal(mline.get_xdata(), phases)
        np.testing.assert_allclose(mline.get_ydata(), model[i] + i * off,
                                   atol=1e-14)
        np.testing.assert_allclose(dline.get_ydata(), data[i] + i * off,
                                   atol=1e-14)
    assert ax.get_xlabel() == "Phase [rot]"
    assert ax.get_ylabel() == "Approx. Frequency [MHz]"
    assert [t.get_text() for t in ax.get_yticklabels()] == \
        [str(int(round(f))) for f in freqs[::10]]
    kw.update(rvrsd=True, title="rv")
    fig2 = tviz.show_stacked_profiles(data, model, **kw)
    assert_same_figure(fig2, jviz.show_stacked_profiles(data, model, **kw))
    lines2 = fig2.axes[0].get_lines()
    np.testing.assert_allclose(lines2[1].get_ydata(), data[-1],
                               atol=1e-14)
    assert [t.get_text() for t in fig2.axes[0].get_yticklabels()] == \
        [str(int(round(f))) for f in freqs[::-1][::10]]
    # no model and no axes given: the data itself, bin and channel axes
    assert_same_figure(tviz.show_stacked_profiles(data, show=False),
                       jviz.show_stacked_profiles(data, show=False))


def _shifted_profiles(nprof=10, nbin=64, seed=8):
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    model = np.exp(-0.5 * ((x - 0.4) / 0.03) ** 2) * np.linspace(
        1.0, 2.0, nprof)[:, None]
    k = np.arange(nbin // 2 + 1)
    shift = rng.uniform(-0.2, 0.2, nprof)
    data = 0.7 * np.fft.irfft(np.fft.rfft(model, axis=-1) * np.exp(
        2j * np.pi * shift[:, None] * k), nbin, axis=-1)
    data += 0.02 * rng.standard_normal(data.shape)
    data[3] = model[3]  # a row equal to its model: not fitted
    return data, model


def test_stacked_fits_equal_per_profile_fits():
    """One batched FFTFIT over the rows that differ from their model
    equals the JAX package's per-profile fit_phase_shift(Ns=100) and
    rotate_data: phase within 1e-10 rot, scale 1e-9 relative, the fitted
    models within 1e-9 of their peak; equal rows keep their model."""
    data, model = _shifted_profiles()
    got = figdata.stacked_fits(torch.as_tensor(data),
                               torch.as_tensor(model))
    fitted = np.array([np.any(d - m) for d, m in zip(data, model)])
    np.testing.assert_array_equal(got.fitted.numpy(), fitted)
    assert not fitted[3] and fitted.sum() == len(data) - 1
    phases, scales, models = [], [], np.array(model)
    for i in np.flatnonzero(fitted):
        r = jfit_phase_shift(data[i], model[i], Ns=100)
        phases.append(float(np.asarray(r.phase)))
        scales.append(float(np.asarray(r.scale)))
        models[i] = scales[-1] * np.asarray(jrotate(model[i], -phases[-1]))
    np.testing.assert_allclose(got.phase.numpy(), phases, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.scale.numpy(), scales, rtol=1e-9)
    assert_near(got.models.numpy(), models, 1e-9, "fitted models")
    np.testing.assert_array_equal(got.models[3].numpy(), model[3])


def test_show_stacked_profiles_fit():
    data, model = _shifted_profiles()
    phases = (np.arange(data.shape[-1]) + 0.5) / data.shape[-1]
    kw = dict(phases=phases, fit=True, show=False)
    fig = tviz.show_stacked_profiles(data, model, device=CPU, **kw)
    assert_same_figure(fig, jviz.show_stacked_profiles(data, model, **kw),
                       rtol=1e-9)
    # the fitted model lies on the data, not where it was drawn unfitted
    mline = fig.axes[0].get_lines()[0]
    assert np.abs(mline.get_ydata() - data[0]).max() < 0.1
    assert np.abs(model[0] - data[0]).max() > 0.5


def test_show_eigenprofiles_rows_and_truncation():
    nbin, ncomp = 32, 3
    rng = np.random.default_rng(5)
    mean = np.sin(2 * np.pi * (np.arange(nbin) + 0.5) / nbin)
    eig = rng.normal(0, 1.0, (ncomp, nbin))  # rows = eigenprofiles
    smooth = eig + 0.1
    kw = dict(eigprofs=eig, smooth_eigprofs=smooth, mean_prof=mean,
              smooth_mean_prof=mean + 0.05, title="e", show=False)
    fig = tviz.show_eigenprofiles(**kw)
    assert_same_figure(fig, jviz.show_eigenprofiles(**kw))
    assert len(fig.axes) == 1 + ncomp
    x = (np.arange(nbin) + 0.5) / nbin
    np.testing.assert_array_equal(fig.axes[0].get_lines()[0].get_xdata(),
                                  x)
    np.testing.assert_allclose(fig.axes[0].get_lines()[0].get_ydata(),
                               mean, atol=1e-14)
    assert fig.axes[0].get_ylabel() == "Mean profile"
    for k in range(ncomp):
        ax = fig.axes[1 + k]
        raw, sm = ax.get_lines()[:2]
        np.testing.assert_allclose(raw.get_ydata(), eig[k], atol=1e-14)
        np.testing.assert_allclose(sm.get_ydata(), smooth[k], atol=1e-14)
        assert ax.get_ylabel() == "Eigenprofile %d" % (k + 1)
    assert fig.axes[-1].get_xlabel() == "Phase [rot]"
    kw = dict(eigprofs=eig, mean_prof=mean, ncomp=2, show=False)
    fig2 = tviz.show_eigenprofiles(**kw)
    assert len(fig2.axes) == 3
    assert_same_figure(fig2, jviz.show_eigenprofiles(**kw))


def test_show_eigenprofiles_from_spline_dataportrait():
    class FakeSM:
        pass

    class FakeDP:
        pass

    nbin = 16
    sm = FakeSM()
    rng = np.random.default_rng(2)
    sm.eigvec = rng.normal(0, 1, (nbin, 2))  # [nbin, ncomp] as stored
    sm.mean_prof = rng.normal(0, 1, nbin)
    dp = FakeDP()
    dp.spline_model = sm
    fig = tviz.show_eigenprofiles(dp, show=False)
    assert_same_figure(fig, jviz.show_eigenprofiles(dp, show=False))
    assert len(fig.axes) == 3
    np.testing.assert_allclose(fig.axes[0].get_lines()[0].get_ydata(),
                               sm.mean_prof, atol=1e-14)
    for k in range(2):
        np.testing.assert_allclose(
            fig.axes[1 + k].get_lines()[0].get_ydata(), sm.eigvec[:, k],
            atol=1e-14)


def test_show_spline_curve_projections_content():
    from scipy import interpolate as si

    nprof, ndim = 24, 2
    freqs = np.linspace(1100.0, 1900.0, nprof)
    rng = np.random.default_rng(9)
    proj = np.stack([np.linspace(-1, 1, nprof) ** 2,
                     np.sin(freqs / 300.0)], axis=1)
    proj = proj + rng.normal(0, 0.01, proj.shape)
    tck, _ = si.splprep(proj.T, u=freqs, k=3, s=float(nprof))
    weights = rng.uniform(1.0, 3.0, nprof)
    kw = dict(tck=tck, freqs=freqs, weights=weights, title="p",
              show=False)
    fig = tviz.show_spline_curve_projections(proj, **kw)
    assert_same_figure(fig, jviz.show_spline_curve_projections(proj, **kw))
    assert len(fig.axes) == ndim
    interp_freqs = np.linspace(freqs.min(), freqs.max(), nprof * 10)
    curve = np.array(si.splev(interp_freqs, tck))
    knots = np.array(si.splev(tck[0], tck))
    for ic in range(ndim):
        lines = fig.axes[ic].get_lines()
        data_line, curve_line, knot_line = lines[nprof:nprof + 3]
        np.testing.assert_array_equal(data_line.get_xdata(), freqs)
        np.testing.assert_allclose(data_line.get_ydata(), proj[:, ic],
                                   atol=1e-14)
        np.testing.assert_allclose(curve_line.get_ydata(), curve[ic],
                                   atol=1e-12)
        np.testing.assert_array_equal(knot_line.get_xdata(),
                                      np.asarray(tck[0]))
        np.testing.assert_allclose(knot_line.get_ydata(), knots[ic],
                                   atol=1e-12)
        assert fig.axes[ic].get_ylabel() == "Coordinate %d" % (ic + 1)
    assert fig.axes[-1].get_xlabel() == "Frequency [MHz]"
    kw = dict(tck=tck, freqs=freqs, icoord=1, show=False)
    fig2 = tviz.show_spline_curve_projections(proj, **kw)
    assert len(fig2.axes) == 1
    assert_same_figure(fig2,
                       jviz.show_spline_curve_projections(proj, **kw))


def test_set_colormap():
    """The default image colormap is set and returned as by the JAX
    package; an unknown name raises before anything changes."""
    try:
        for name in ("viridis", "magma"):
            ref = jviz.set_colormap(name)
            assert plt.rcParams["image.cmap"] == name
            plt.rcParams["image.cmap"] = "gray"
            got = tviz.set_colormap(name)
            assert plt.rcParams["image.cmap"] == name
            assert got.name == ref.name == name
        with pytest.raises(ValueError):
            tviz.set_colormap("no-such-map")
        assert plt.rcParams["image.cmap"] == "magma"
    finally:
        plt.rcParams["image.cmap"] = matplotlib.rcParamsDefault[
            "image.cmap"]


_CHECK_NO_MPL = """
import sys
sys.modules["matplotlib"] = None      # matplotlib cannot be imported
sys.path.insert(0, %r)
import pulseportraiture_tpu_torch.viz as viz
import pulseportraiture_tpu_torch.viz.selector as selector
from pulseportraiture_tpu_torch.viz import figdata
import numpy as np, torch
assert sorted(viz.__all__) == sorted(%r)
assert selector.__all__ == ["GaussianSelector", "select_gaussians"]
port = torch.ones((3, 16), dtype=torch.float64)
port[1] = 0.0
pay = figdata.residual_payload(port, 0.5 * port,
                               torch.ones(3, dtype=torch.float64))
assert pay.live.tolist() == [True, False, True]
assert pay.rchi2.tolist() == [0.25, 0.25]
try:
    viz.show_portrait(np.ones((2, 4)), show=False)
except ImportError:
    pass
else:
    raise AssertionError("drew without matplotlib")
assert not torch.cuda.is_initialized()
assert not any(m == "jax" or m.startswith("pulseportraiture_tpu.")
               for m in sys.modules)
print("ok")
"""


def test_viz_imports_without_matplotlib():
    """viz, viz.selector and viz.figdata import, and figdata computes,
    with matplotlib unimportable (the card's machine has none); a draw
    then raises ImportError."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK_NO_MPL % (ROOT, jviz.__all__)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"
    assert tviz.__all__ == jviz.__all__


def test_device_policy_of_the_figure_numbers(monkeypatch):
    """Host arrays are reduced on the CUDA device unless ``device`` says
    otherwise: without a card that raises; tensors keep their device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = make_port()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tviz.show_residual_plot(port, port, noise_stds=np.ones(8),
                                show=False)
    data, model = _shifted_profiles()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tviz.show_stacked_profiles(data, model, fit=True, show=False)
    fig = tviz.show_residual_plot(torch.as_tensor(port),
                                  torch.as_tensor(0.9 * port),
                                  noise_stds=np.full(8, 0.01), show=False)
    assert len(fig.pp_rchi2) == 8
    # drawing alone needs no device
    tviz.show_stacked_profiles(data, model, show=False)


# -- the wrappers over GetTOAs and DataPortrait (test_viz_smoke) ------------

MODEL_PARAMS = np.array([0.02, 0.0, 0.40, 0.0, 0.05, 0.0, 1.0, -0.5])


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    from pulseportraiture_tpu.io.archive import make_fake_pulsar
    from pulseportraiture_tpu.io.gmodel import write_model

    tmp = tmp_path_factory.mktemp("torch_viz")
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
    w = np.ones((2, 16))
    w[:, 6] = 0.0
    hot = str(tmp / "hot.fits")
    make_fake_pulsar(gm, par, hot, nsub=2, nchan=16, nbin=128, nu0=1500.0,
                     bw=800.0, tsub=60.0, noise_stds=noise, weights=w,
                     dedispersed=False, seed=3, quiet=True)
    clean = str(tmp / "clean.fits")
    make_fake_pulsar(gm, par, clean, nsub=1, nchan=16, nbin=128,
                     nu0=1500.0, bw=800.0, tsub=60.0, noise_stds=0.004,
                     dedispersed=True, seed=4, quiet=True)
    return tmp, gm, hot, clean


@pytest.fixture(scope="module")
def toas(archives):
    from pulseportraiture_tpu.pipelines.toas import GetTOAs as JGetTOAs
    from pulseportraiture_tpu_torch.pipelines.toas import \
        GetTOAs as TGetTOAs

    _, gm, hot, _ = archives
    ref = JGetTOAs([hot], gm, quiet=True)
    ref.get_TOAs(bary=False)
    port = TGetTOAs([hot], gm, quiet=True, device=CPU)
    port.get_TOAs(bary=False, show_plot=True)   # draws nothing
    return port, ref


def imgs(fig):
    return [ax.images[0] for ax in fig.axes if ax.images]


@pytest.mark.parametrize("rotate", [0.0, 0.125])
def test_show_fit_and_subint(toas, archives, rotate):
    """GetTOAs.show_fit / show_subint draw the fitted subint: the figure
    of the JAX package's within 1e-10 (the fit's payload), titles
    naming the archive and subint, the reduced chi2s of the live
    channels with dof = nbin - nfit."""
    port, ref = toas
    tmp, _, hot, _ = archives
    fit_port, fit_model, ok_ichans = port.return_fit(0, 1)[:3]
    if rotate:
        fit_port = np.asarray(jrotate(fit_port, rotate))
        fit_model = np.asarray(jrotate(fit_model, rotate))
    fig = port.show_fit(0, 1, rotate=rotate, show=False)
    assert_same_figure(fig, ref.show_fit(0, 1, rotate=rotate, show=False),
                       rtol=1e-10)
    np.testing.assert_allclose(np.asarray(imgs(fig)[0].get_array()),
                               fit_port, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(imgs(fig)[1].get_array()),
                               fit_model, rtol=0, atol=1e-12)
    assert fig.axes[0].get_title() == "%s subint 1" % hot
    # the zapped channel's data are not zero: it is drawn and counted,
    # as by the JAX package
    assert len(ok_ichans) == 15 and len(fig.pp_rchi2) == 16
    fig = port.show_subint(0, 1, rotate=rotate, show=False)
    assert_same_figure(fig, ref.show_subint(0, 1, rotate=rotate,
                                            show=False), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(imgs(fig)[0].get_array()),
                               fit_port, rtol=0, atol=1e-12)
    for name, draw in (("fit", port.show_fit), ("subint",
                                                port.show_subint)):
        png = str(tmp / ("%s_%g.png" % (name, rotate)))
        assert draw(0, 0, rotate=rotate, savefig=png) == png
        assert os.path.getsize(png) > 1000


def test_fit_payload_reduces_on_the_runs_device(toas):
    """figdata.fitted_subint keeps the fitted subint on the GetTOAs
    run's device, and residual_payload's chi2s there are show_fit's."""
    port, _ = toas
    f = figdata.fitted_subint(port, 0, 0)
    assert f.port.device == f.model.device == f.noise_stds.device == \
        port.device
    pay = figdata.residual_payload(f.port, f.model, f.noise_stds,
                                   port.nfit)
    fig = tviz.show_fit(port, 0, 0, show=False)
    np.testing.assert_array_equal(pay.rchi2.numpy(), fig.pp_rchi2)
    np.testing.assert_array_equal(pay.live.numpy(),
                                  f.port.numpy().mean(axis=1) != 0.0)


@pytest.fixture(scope="module")
def spline_portraits(archives):
    from pulseportraiture_tpu.models.spline import \
        SplineModelPortrait as JSpline
    from pulseportraiture_tpu_torch.models.spline import \
        SplineModelPortrait as TSpline

    _, _, _, clean = archives
    ref = JSpline(clean, quiet=True)
    ref.make_spline_model(max_ncomp=4, quiet=True)
    port = TSpline(clean, quiet=True, device=CPU)
    port.make_spline_model(max_ncomp=4, quiet=True)
    return port, ref


def test_dataportrait_views(spline_portraits, archives):
    """show_model_fit / show_data_portrait (and the DataPortrait methods)
    draw the DataPortrait's own arrays; the data panels equal the JAX
    package's (the phases within 1e-15), the model within the spline
    models' 1e-8."""
    port, ref = spline_portraits
    tmp = archives[0]
    fig = tviz.show_data_portrait(port, show=False)
    assert_same_figure(fig, jviz.show_data_portrait(ref, show=False),
                       rtol=1e-15)
    np.testing.assert_array_equal(np.asarray(imgs(fig)[0].get_array()),
                                  port.portx)
    assert_same_figure(port.show_data_portrait(show=False), fig)
    fig = tviz.show_model_fit(port, show=False)
    np.testing.assert_array_equal(np.asarray(imgs(fig)[0].get_array()),
                                  port.portx)
    np.testing.assert_array_equal(np.asarray(imgs(fig)[1].get_array()),
                                  port.modelx)
    assert [a.get_title() for a in image_axes(fig)] == \
        ["Data", "Model", "Residuals"]
    rfig = jviz.show_model_fit(ref, show=False)
    np.testing.assert_allclose(
        np.asarray(imgs(fig)[1].get_array()),
        np.asarray(imgs(rfig)[1].get_array()), rtol=0,
        atol=1e-8 * np.abs(ref.modelx).max())
    want = np.array([float(np.asarray(get_red_chi2(
        port.portx[i], port.modelx[i], errs=port.noise_stdsxs[i],
        dof=port.portx.shape[-1]))) for i in range(len(port.portx))])
    np.testing.assert_allclose(fig.pp_rchi2, want, rtol=1e-12)
    assert_same_figure(port.show_model_fit(show=False), fig)
    fig = port.show_model_portrait(show=False)
    assert_same_figure(fig, tviz.show_portrait(
        port.modelx, phases=port.phases, freqs=port.freqsxs[0],
        show=False))
    rfig = ref.show_model_portrait(show=False)
    np.testing.assert_allclose(
        np.asarray(imgs(fig)[0].get_array()),
        np.asarray(imgs(rfig)[0].get_array()), rtol=0,
        atol=1e-8 * np.abs(ref.modelx).max())
    png = str(tmp / "model_fit.png")
    assert tviz.show_model_fit(port, savefig=png) == png
    assert os.path.getsize(png) > 1000


def test_spline_model_views(spline_portraits):
    """show_eigenprofiles / show_spline_curve_projections of a spline
    DataPortrait draw its model's mean profile, eigenprofiles (columns
    of eigvec), projections and curve."""
    port, ref = spline_portraits
    sm = port.spline_model
    fig = tviz.show_eigenprofiles(port, show=False)
    assert len(fig.axes) == 1 + sm.eigvec.shape[1] == \
        1 + ref.spline_model.eigvec.shape[1]
    assert_same_figure(fig, tviz.show_eigenprofiles(
        eigprofs=sm.eigvec.T, mean_prof=sm.mean_prof, show=False))
    np.testing.assert_allclose(
        fig.axes[0].get_lines()[0].get_ydata(),
        np.asarray(ref.spline_model.mean_prof), rtol=0,
        atol=1e-8 * np.abs(ref.spline_model.mean_prof).max())
    fig = tviz.show_spline_curve_projections(port, show=False)
    assert_same_figure(fig, tviz.show_spline_curve_projections(
        sm.proj_port, tck=sm.tck, freqs=port.freqsxs[0], show=False))
    assert len(fig.axes) == sm.proj_port.shape[1]
