"""The port's statistics, Gaussian FT, instrumental responses and
portrait normalization against the JAX package.

``ops/stats.py``, ``ops/profiles.gaussian_profile(_FT)``,
``ops/instrumental.py`` and ``ops/normalize.py`` of
pulseportraiture_tpu_torch on the CPU against the JAX package's functions
on the same seeded inputs.  Tolerance: 1e-12 relative to each result's
largest magnitude (the same float64 formulas; sums and FFTs may round in
another order).  'prof' normalization fits scales through FFTFIT (the
plain version of kernel K2 here): 1e-10.
"""

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.ops import instrumental as jinst
from pulseportraiture_tpu.ops import normalize as jnorm
from pulseportraiture_tpu.ops import profiles as jprof
from pulseportraiture_tpu.ops import stats as jstats
from pulseportraiture_tpu_torch.ops import instrumental as tinst
from pulseportraiture_tpu_torch.ops import normalize as tnorm
from pulseportraiture_tpu_torch.ops import profiles as tprof
from pulseportraiture_tpu_torch.ops import stats as tstats

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, \
        np.abs(got - want).max() / scale


def test_stats_match_jax():
    rng = np.random.default_rng(3)
    data = rng.standard_normal(50) + 3.0
    errs = rng.uniform(0.1, 1.0, 50)
    errs[[4, 9]] = 0.0       # excluded points
    errs[17] = -1.0
    for args in ((data,), (data, errs), (data, 0.5)):
        tm, te = tstats.weighted_mean(*args)
        jm, je = jstats.weighted_mean(*args)
        _close(tm, jm)
        _close(te, je)
        _close(tstats.get_WRMS(*args), jstats.get_WRMS(*args))
    # the batched form: each row as the reference's weighted mean
    rows, rerrs = data.reshape(5, 10), errs.reshape(5, 10)
    bm, be = tstats.weighted_mean(rows, rerrs, dim=-1)
    for i in range(5):
        jm, je = jstats.weighted_mean(rows[i], rerrs[i])
        _close(bm[i], jm)
        _close(be[i], je)
    x = np.sin(np.linspace(0, 20, 200))
    for x0 in (0.0, 0.3, np.sin(2.0)):
        assert int(tstats.count_crossings(x, x0)) == \
            int(jstats.count_crossings(x, x0))
    port = rng.standard_normal((6, 64))
    model = port + 0.1 * rng.standard_normal((6, 64))
    noise = rng.uniform(0.05, 0.2, 6)
    for args, kw in (((port, model), {}),
                     ((port, model), dict(errs=noise, dof=60)),
                     ((port[0], model[0]), dict(errs=noise[0], dof=62)),
                     ((port[0], model[0]), {})):
        _close(tstats.get_red_chi2(*args, **kw),
               jstats.get_red_chi2(*args, **kw))


@pytest.mark.parametrize("nbin", [64, 255, 2048])
@pytest.mark.parametrize("loc,wid,amp", [(0.3, 0.05, 1.0), (0.97, 0.2, 2.5),
                                         (-0.2, 0.01, 0.7), (0.5, 0.0, 1.0)])
def test_gaussian_profile_and_FT_match_jax(nbin, loc, wid, amp):
    _close(tprof.gaussian_profile(nbin, loc, wid),
           jprof.gaussian_profile(nbin, loc, wid))
    _close(tprof.gaussian_profile(nbin, loc, wid, norm=True),
           jprof.gaussian_profile(nbin, loc, wid, norm=True))
    _close(tprof.gaussian_profile_FT(nbin, loc, wid, amp),
           jprof.gaussian_profile_FT(nbin, loc, wid, amp))


@pytest.mark.parametrize("irf_type", ["rect", "gauss"])
@pytest.mark.parametrize("wid", [0.0, 0.003, 0.04])
def test_instrumental_response_FT_matches_jax(irf_type, wid):
    for nbin in (128, 2048):
        _close(tinst.instrumental_response_FT(nbin, wid, irf_type),
               jinst.instrumental_response_FT(nbin, wid, irf_type))


@pytest.mark.parametrize("DM,wids,types", [
    (0.0, [0.01], ["rect"]), (30.0, [], []),
    (30.0, [0.004, 0.01], ["rect", "gauss"]), (0.0, [], [])],
    ids=["rect", "dm_smear", "dm_rect_gauss", "none"])
def test_instrumental_response_port_FT_matches_jax(DM, wids, types):
    """DM smearing (DM as the reference's on/off gate), constant-width
    responses, and both together; a one-channel band too."""
    freqs = np.linspace(1100.0, 1900.0, 32)
    for f in (freqs, freqs[:1]):
        _close(tinst.instrumental_response_port_FT(256, f, DM, 0.003,
                                                   wids, types),
               jinst.instrumental_response_port_FT(256, f, DM, 0.003,
                                                   wids, types))


def test_instrumental_response_rejects_unknown_type():
    with pytest.raises(ValueError):
        tinst.instrumental_response_FT(64, 0.01, "boxcar")


@pytest.mark.parametrize("method", ["mean", "max", "rms", "abs", "prof"])
def test_normalize_portrait_matches_jax(method):
    rng = np.random.default_rng(11)
    x = (np.arange(128) + 0.5) / 128
    prof = np.exp(-0.5 * ((x - 0.3) / 0.04) ** 2)
    port = prof * rng.uniform(0.5, 2.0, (8, 1)) + \
        0.05 * rng.standard_normal((8, 128))
    port[3] = 0.0  # a zapped channel passes through with norm 1
    weights = np.ones(8)
    weights[5] = 0.0
    got, norms = tnorm.normalize_portrait(port, method, weights=weights,
                                          return_norms=True)
    want, jnorms = jnorm.normalize_portrait(port, method, weights=weights,
                                            return_norms=True)
    rtol = 1e-10 if method == "prof" else RTOL
    _close(got, want, rtol)
    _close(norms, jnorms, rtol)
    _close(tnorm.unnormalize_portrait(got, norms),
           jnorm.unnormalize_portrait(want, jnorms), rtol)
    _close(tnorm.normalize_portrait(port[None], method)[0],
           jnorm.normalize_portrait(port[None], method)[0], rtol)
