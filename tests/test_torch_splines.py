"""The port's spline modules against the JAX package and scipy.

``ops/splines.py`` (``splev``, ``fft_resample``, ``gen_spline_portrait``)
and ``io/splmodel.py`` (the npz container and legacy pickles) of
pulseportraiture_tpu_torch, on the CPU, against the same functions of the
JAX package and ``scipy.interpolate.splev`` on the same seeded inputs.
Tolerance: 1e-12 relative to each result's largest magnitude (the
de Boor recursion and the FFTs are the same arithmetic in float64; only
sums of products may round in another order).
"""

import pickle

import numpy as np
import pytest
import scipy.interpolate as si
import torch

from pulseportraiture_tpu.io import splmodel as jspl
from pulseportraiture_tpu.ops import splines as jsplines
from pulseportraiture_tpu_torch.io import splmodel as tspl
from pulseportraiture_tpu_torch.ops import splines as tsplines

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, \
        np.abs(got - want).max() / scale


def _curve(k, seed, ndim=3, npts=40):
    """A smoothing-spline fit of degree k to a seeded noisy curve over
    1200-1800 MHz: (t, c, k) scalar when ndim is 0, else parametric."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.uniform(1200.0, 1800.0, npts))
    if ndim == 0:
        return si.splrep(u, np.sin(u / 90.0) + 0.05 * rng.standard_normal(
            npts), k=k, s=npts * 0.05 ** 2)
    x = [np.cos(u / (60.0 + 20 * i)) + 0.03 * rng.standard_normal(npts)
         for i in range(ndim)]
    tck, _ = si.splprep(x, u=u, k=k, s=npts * 0.03 ** 2)
    return tck


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("ndim", [0, 3], ids=["scalar", "parametric"])
def test_splev_matches_jax_and_scipy(k, ndim):
    """Inside [t_k, t_n], at the knots themselves, and extrapolated on
    both sides (splev's ext=0)."""
    tck = _curve(k, seed=10 * k + ndim, ndim=ndim)
    t = np.asarray(tck[0])
    x = np.concatenate([np.linspace(1100.0, 1900.0, 57), t[k:-k],
                        [t[k] - 1e-9, t[-k - 1] + 1e-9]])
    got = tsplines.splev(x, tck).numpy()
    _close(got, np.asarray(jsplines.splev(x, tck)))
    _close(got, np.asarray(si.splev(x, tck)))


def test_splev_on_a_tensor_keeps_its_device():
    tck = _curve(3, seed=1)
    x = torch.linspace(1250.0, 1750.0, 9, dtype=torch.float64)
    out = tsplines.splev(x, tck)
    assert out.shape == (3, 9) and out.device == x.device
    _close(out.numpy(), si.splev(x.numpy(), tck))


@pytest.mark.parametrize("n,nbin", [(128, 256), (256, 64), (256, 96),
                                    (127, 200), (200, 127)],
                         ids=["up", "down_even", "down_even2", "up_odd",
                              "down_odd"])
def test_fft_resample_matches_jax(n, nbin):
    rng = np.random.default_rng(n + nbin)
    port = rng.standard_normal((3, n))
    _close(tsplines.fft_resample(port, nbin).numpy(),
           np.asarray(jsplines.fft_resample(port, nbin)))


def _spline_parts(nbin=128, neig=3, seed=5):
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    mean_prof = np.exp(-0.5 * ((x - 0.4) / 0.03) ** 2)
    eigvec = np.linalg.qr(rng.standard_normal((nbin, max(neig, 1))))[0][
        :, :neig]
    tck = _curve(3, seed=seed, ndim=max(neig, 1))
    return mean_prof, eigvec, tck


@pytest.mark.parametrize("neig,nbin_out", [(3, None), (0, None), (3, 256),
                                           (2, 64), (0, 256)],
                         ids=["neig3", "neig0", "neig3_up", "neig2_down",
                              "neig0_up"])
def test_gen_spline_portrait_matches_jax(neig, nbin_out):
    mean_prof, eigvec, tck = _spline_parts(neig=neig)
    freqs = np.linspace(1210.0, 1790.0, 16)
    got = tsplines.gen_spline_portrait(mean_prof, freqs, eigvec, tck,
                                       nbin_out).numpy()
    want = np.asarray(jsplines.gen_spline_portrait(mean_prof, freqs,
                                                   eigvec, tck, nbin_out))
    assert got.shape == (16, nbin_out or 128)
    _close(got, want)


def _legacy_pickle(path, parts):
    mean_prof, eigvec, tck = parts
    t, c, k = tck
    with open(path, "wb") as f:
        pickle.dump(["legacy", "J0000+0000", "a.fits", mean_prof, eigvec,
                     [t, [np.asarray(ci) for ci in c], k]], f, protocol=2)


def test_spline_containers_round_trip_between_packages(tmp_path):
    """npz files written by either package read in the other, legacy
    pickles read in both, and the portraits agree."""
    mean_prof, eigvec, tck = _spline_parts()
    freqs = np.linspace(1220.0, 1780.0, 8)
    paths = dict(port=str(tmp_path / "p.spl"), jax=str(tmp_path / "j.spl"),
                 legacy=str(tmp_path / "l.spl"))
    tspl.write_spline_model(paths["port"], "m", "J0000+0000", "a.fits",
                            mean_prof, eigvec, tck)
    jspl.write_spline_model(paths["jax"], "m", "J0000+0000", "a.fits",
                            mean_prof, eigvec, tck)
    _legacy_pickle(paths["legacy"], (mean_prof, eigvec, tck))
    for path in paths.values():
        t_contents = tspl.read_spline_model(path)
        j_contents = jspl.read_spline_model(path)
        assert t_contents[:3] == j_contents[:3]
        for a, b in zip(t_contents[3:5], j_contents[3:5]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t_contents[5][0], j_contents[5][0])
        np.testing.assert_array_equal(np.asarray(t_contents[5][1]),
                                      np.asarray(j_contents[5][1]))
        assert t_contents[5][2] == j_contents[5][2] == 3
        name, port = tspl.read_spline_model(path, freqs, 256)
        jname, jport = jspl.read_spline_model(path, freqs, 256)
        assert name == jname
        _close(port.numpy(), np.asarray(jport))
        mf, proj = tspl.get_spline_model_coords(path, nfreq=50)
        jmf, jproj = jspl.get_spline_model_coords(path, nfreq=50)
        np.testing.assert_array_equal(mf, jmf)
        _close(proj, np.asarray(jproj))
    # the port's npz holds the JAX package's arrays, names and types
    with np.load(paths["port"]) as zp, np.load(paths["jax"]) as zj:
        assert sorted(zp.files) == sorted(zj.files)
        for key in zj.files:
            assert zp[key].dtype == zj[key].dtype, key
            np.testing.assert_array_equal(zp[key], zj[key])
