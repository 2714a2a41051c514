"""The fit's spectra set-up, kernel K4 (csrc/spectra.cu), on the CPU: its
plain versions against the JAX reference's expressions.

The same seeded numpy inputs go through the reference and the port:

* ``_kernels.spectra_plain`` (epilogue A) against reference
  fit/portrait.py:915-924 run with jnp on the same arrays: the data
  power Sd within 1e-13 relative (a sum of positive terms in another
  order), each cross element within 1e-14 of |d_k| |m_k| (the two
  frameworks may round the complex product differently) and |m|^2
  within 1e-14 relative, for shared and per-row models, kmax below and
  at nharm, odd nbin, and a nonzero F0_fact;
* ``_kernels.spectra_noise_plain`` (epilogue B): its noise against
  reference ``ops.noise.get_noise_PS`` within 1e-14 relative, and the
  1 / sigma_FT^2 weights built from it;
* the port's ``fit_portrait_full_batch(errs=None)``, whose noise comes
  out of the spectra pass and whose phases are seeded after it, against
  the reference's ``errs=None`` fit (TOAs within 1 ns, DM and chi2 within
  test_torch_fit.py's tolerances), and on (1, 1, 2) and (2, 1, 1) meshes
  of CPU devices against the port's unsharded ``errs=None`` fit, held by
  test_torch_sharding.py's ``_assert_port_equal``;
* both plain versions give the same bits whatever the chunk of rows;
* the wrappers' argument checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.ops import noise as jno
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch.config import F0_fact
from pulseportraiture_tpu_torch.fit import portrait as tfp
from pulseportraiture_tpu_torch.parallel import mesh as tmesh
from test_torch_fit import FREQS, P0, _batch_inputs
from test_torch_sharding import (FLAGS, _args, _assert_port_equal,  # noqa
                                 _assert_ref_close, problem)

@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """As test_torch_fit.py: the reference fits' jit variants go when the
    module ends (tests/test_retrace_budget.py holds the caches' size)."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


def _inputs(seed, r, nchan, nbin, per_row):
    """Data [r, nchan, nbin], a model [nchan, nbin] or [r, nchan, nbin]
    (a pulse plus noise, so |m| spans decades), inv_err2 [r, nchan] with
    a zero, weights [r, nchan] with a zapped channel."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    pulse = np.exp(-0.5 * ((x - 0.4) / 0.03) ** 2)
    data = pulse + rng.normal(0.0, 0.3, (r, nchan, nbin)) + 2.0
    mshape = (r, nchan, nbin) if per_row else (nchan, nbin)
    model = pulse + rng.normal(0.0, 0.01, mshape)
    inv_err2 = rng.uniform(0.5, 2.0, (r, nchan))
    inv_err2[0, -1] = 0.0
    weights = np.ones((r, nchan))
    weights[:, nchan // 2] = 0.0
    return data, model, inv_err2, weights


def _reference_spectra(dFFT, mFFT, inv_err2, kmax, f0):
    """Reference fit/portrait.py:915-924 (the complex128 path) from the
    rFFTs dFFT and mFFT on: (cross, Sd per subint, |m|^2, |d| |m| per
    cross element)."""
    dFFT = jnp.asarray(dFFT).at[..., 0].multiply(f0)
    mFFT = jnp.asarray(mFFT).at[..., 0].multiply(f0)
    Sd = jnp.sum(jnp.abs(dFFT) ** 2 * jnp.asarray(inv_err2)[..., None],
                 axis=(-2, -1))
    dK, mK = dFFT[..., :kmax], mFFT[..., :kmax]
    cross = dK * jnp.conj(mK)
    return (np.asarray(cross), np.asarray(Sd), np.asarray(jnp.abs(mK) ** 2),
            np.asarray(jnp.abs(dK) * jnp.abs(mK)))


def _outs(r, nchan, kmax, per_row=True):
    cross = torch.empty((r, nchan, kmax), dtype=torch.complex128)
    sd = torch.empty((r, nchan), dtype=torch.float64)
    absm2 = torch.empty((r, nchan, kmax), dtype=torch.float64) \
        if per_row else None
    return cross, sd, absm2


def _assert_cross(got, want, scale):
    """Each element within 1e-14 of its ``scale`` (|d| |m|)."""
    gap = np.abs(got - want)
    assert np.all(gap <= 1e-14 * scale), float(
        (gap / np.maximum(scale, 1e-300)).max())


# (subints, channels, nbin, kmax or None for nharm, a model per row)
CASES = [
    (3, 8, 64, 12, False),     # kmax < nharm, shared model
    (3, 8, 64, None, False),   # kmax = nharm
    (4, 5, 64, 20, True),      # a model per row (ppalign)
    (3, 6, 63, 17, False),     # odd nbin
    (3, 6, 63, None, True),    # odd nbin, per row, kmax = nharm
    (9, 1, 128, 40, True),     # one channel a lane (narrowband --fit_scat)
]


def _case_id(c):
    return "%dx%dx%d-k%s%s" % (c[0], c[1], c[2], c[3] or "all",
                               "-rows" if c[4] else "")


@pytest.mark.parametrize("f0", [F0_fact, 0.5], ids=["F0_fact", "f0_half"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_spectra_plain_matches_reference(case, f0, monkeypatch):
    r, nchan, nbin, kmax, per_row = case
    nharm = nbin // 2 + 1
    kmax = nharm if kmax is None else kmax
    data, model, inv_err2, _ = _inputs(r + nbin, r, nchan, nbin, per_row)
    monkeypatch.setattr(_kernels, "F0_fact", f0)
    dfft = torch.fft.rfft(torch.as_tensor(data), dim=-1)
    mfft = torch.fft.rfft(torch.as_tensor(model), dim=-1)
    want_x, want_sd, want_m2, scale = _reference_spectra(
        dfft.numpy(), mfft.numpy(), inv_err2, kmax, f0)
    before = dfft.clone(), mfft.clone()
    cross, sd, absm2 = _outs(r, nchan, kmax)
    _kernels.spectra_plain(dfft, mfft, torch.as_tensor(inv_err2), kmax,
                           cross, sd, absm2)
    assert torch.equal(dfft, before[0]) and torch.equal(mfft, before[1])
    _assert_cross(cross.numpy(), want_x, scale)
    np.testing.assert_allclose(sd.sum(-1).numpy(), want_sd, rtol=1e-13,
                               atol=0)
    np.testing.assert_allclose(
        absm2.numpy(), np.broadcast_to(want_m2, absm2.shape), rtol=1e-14,
        atol=0)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_fit_spectra_match_reference(case):
    """The fit's set-up (_spectra: torch's rFFT and the K4 wrapper, chunks
    of two subints) against the reference's from its own rFFT: Sd per
    subint within 1e-13 relative; each cross element within 1e-13 of its
    row's largest |d| times largest |m|, and |m|^2 within 1e-13 of the
    row's largest (the two FFTs round by ~log2(nbin) ulps of a row's
    norm, not of each harmonic)."""
    r, nchan, nbin, kmax, per_row = case
    kmax = nbin // 2 + 1 if kmax is None else kmax
    data, model, inv_err2, _ = _inputs(7 * r + nbin, r, nchan, nbin, per_row)
    dref = np.asarray(jnp.fft.rfft(jnp.asarray(data), axis=-1))
    mref = np.asarray(jnp.fft.rfft(jnp.asarray(model), axis=-1))
    want_x, want_sd, want_m2, _ = _reference_spectra(dref, mref, inv_err2,
                                                     kmax, F0_fact)
    cross, abs_m2, Sd = tfp._spectra(
        torch.as_tensor(data), torch.as_tensor(model), kmax,
        torch.as_tensor(inv_err2), rows=2 * nchan)[:3]
    assert abs_m2.shape == ((r,) if per_row else (1,)) + (nchan, kmax)
    dmax = np.abs(dref).max(-1, keepdims=True)
    mmax = np.abs(mref).max(-1, keepdims=True)
    _assert_cross(cross.numpy(), want_x, 10.0 * dmax * mmax)
    np.testing.assert_allclose(Sd.numpy(), want_sd, rtol=1e-13, atol=0)
    m2 = want_m2.reshape(abs_m2.shape)
    assert np.all(np.abs(abs_m2.numpy() - m2)
                  <= 1e-13 * (mmax ** 2).reshape(abs_m2.shape[:-1] + (1,)))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_spectra_noise_plain_matches_reference(case):
    """Epilogue B: the noise of each row against reference get_noise_PS
    (1e-14 relative), 1 / sigma_FT^2 where the weight is > 0 and 0 where
    it is not (3e-14: the square of the noise's), Sd with it (1e-13), and
    the cross and |m|^2 of epilogue A."""
    r, nchan, nbin, kmax, per_row = case
    nharm = nbin // 2 + 1
    kmax = nharm if kmax is None else kmax
    data, model, _, weights = _inputs(3 * r + nbin, r, nchan, nbin, per_row)
    noise_ref = np.asarray(jno.get_noise_PS(data))
    ie2_ref = np.where(weights > 0.0,
                       (noise_ref * np.sqrt(nbin / 2.0)) ** -2.0, 0.0)
    dfft = torch.fft.rfft(torch.as_tensor(data), dim=-1)
    mfft = torch.fft.rfft(torch.as_tensor(model), dim=-1)
    want_x, want_sd, want_m2, scale = _reference_spectra(
        dfft.numpy(), mfft.numpy(), ie2_ref, kmax, F0_fact)
    cross, sd, absm2 = _outs(r, nchan, kmax)
    noise, ie2 = torch.empty_like(sd), torch.empty_like(sd)
    _kernels.spectra_noise_plain(dfft, mfft, torch.as_tensor(weights), nbin,
                                 kmax, cross, sd, noise, ie2, absm2)
    np.testing.assert_allclose(noise.numpy(), noise_ref, rtol=1e-14, atol=0)
    np.testing.assert_allclose(ie2.numpy(), ie2_ref, rtol=3e-14, atol=0)
    assert np.all(ie2.numpy()[weights == 0.0] == 0.0)
    np.testing.assert_allclose(sd.sum(-1).numpy(), want_sd, rtol=1e-13,
                               atol=0)
    _assert_cross(cross.numpy(), want_x, scale)
    np.testing.assert_allclose(absm2.numpy(), np.broadcast_to(
        want_m2, absm2.shape), rtol=1e-14, atol=0)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "rows"])
@pytest.mark.parametrize("noise", [False, True], ids=["A", "B"])
def test_spectra_chunk_invariance(noise, per_row):
    """Both plain versions (through _spectra, given inv_err2 or weights)
    give the same bits whatever the chunk of rows, one subint to the
    whole batch; a zero weight's row has a zero inv_err2."""
    r, nchan, nbin, kmax = 11, 6, 96, 25
    data, model, inv_err2, weights = _inputs(5, r, nchan, nbin, per_row)
    data, model = torch.as_tensor(data), torch.as_tensor(model)
    arg = {"weights" if noise else "inv_err2":
           torch.as_tensor(weights if noise else inv_err2)}
    n = 5 if noise else 3  # epilogue A returns no noise
    whole = tfp._spectra(data, model, kmax, rows=10 ** 6, **arg)[:n]
    for rows in (1, nchan, 3 * nchan + 1, 7 * nchan):
        part = tfp._spectra(data, model, kmax, rows=rows, **arg)[:n]
        for a, b in zip(part, whole):
            assert torch.equal(a, b), rows
    if noise:
        assert bool((whole[4][:, nchan // 2] == 0.0).all())


def test_get_scales_full_through_the_set_up():
    """get_scales_full takes the set-up at kmax = nharm with unit weights:
    the reference's scales within 1e-10 relative (test_torch_fit.py's
    bound), here with the harmonic count odd."""
    data, model = _inputs(9, 1, 5, 63, False)[:2]
    freqs = np.linspace(1300.0, 1700.0, 5)
    params = np.array([0.01, 1e-4, 0.0, -np.inf, 0.0])
    want = jfp.get_scales_full(params, data[0], model, P0, freqs, 1500.0,
                               1500.0, 1500.0)
    have = tfp.get_scales_full(params, data[0], model, P0, freqs, 1500.0,
                               1500.0, 1500.0, device="cpu")
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-10)


# -- the fit with errs=None --------------------------------------------------

def _toa_gap_s(phi_a, phi_b):
    return float(np.abs((np.asarray(phi_a) - np.asarray(phi_b) + 0.5) % 1.0
                        - 0.5).max() * P0)


def test_errs_none_fit_matches_reference(rng):
    """fit_portrait_full_batch(errs=None, init_params=None): the noise
    measured in the spectra pass (K4-B) and the phases seeded after it;
    against the reference's errs=None fit: TOAs within 1 ns, DM within
    1e-9 and chi2 within 1e-7 relative (test_torch_fit.py's tolerances),
    rc and nfeval equal."""
    data, model, _, _, weights, nu_fits = _batch_inputs(rng)
    kw = dict(weights=weights, fit_flags=(1, 1, 0, 0, 0), nu_fits=nu_fits,
              log10_tau=False, max_iter=50)
    ref = jfp.fit_portrait_full_batch(data, model, None, P0, FREQS, **kw)
    got = tfp.fit_portrait_full_batch(data, model, None, P0, FREQS,
                                      device="cpu", **kw)
    _assert_ref_fit(got, ref)


def _assert_ref_fit(got, ref):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert _toa_gap_s(got["phi"], ref["phi"]) < 1e-9
    np.testing.assert_allclose(got["DM"], ref["DM"], rtol=1e-9)
    np.testing.assert_allclose(got["chi2"], ref["chi2"], rtol=1e-7)
    np.testing.assert_array_equal(got["return_code"], ref["return_code"])
    np.testing.assert_array_equal(got["nfeval"], ref["nfeval"])


@pytest.mark.parametrize("init", ["given", "seeded"])
def test_errs_none_sharding_problem_matches_reference(problem, init):
    """errs=None on test_torch_sharding.py's problem (8 x 16 x 128, noise
    0.005; its DMs are offsets near 0), given init and seeded, held to
    that file's reference tolerances (phi and DM within 1e-8, snr 1e-6
    relative, TOAs 1 ns) and chi2 within 1e-7 relative."""
    args = _args(problem, init)
    kw = dict(fit_flags=FLAGS, log10_tau=False)
    got = tfp.fit_portrait_full_batch(*args, device="cpu", **kw)
    ref = {k: np.asarray(v) for k, v in
           jfp.fit_portrait_full_batch(*args, **kw).items()}
    _assert_ref_close(got, ref, problem["P0"], "errs=None " + init)
    np.testing.assert_allclose(got["chi2"].numpy(), ref["chi2"], rtol=1e-7)


def test_errs_none_fit_chunks_and_seeds(rng):
    """errs=None in scan chunks gives the one-chunk fit's bits, and each
    chunk launches the noise epilogue once (never the get_noise rFFT)."""
    data, model, _, _, weights, nu_fits = _batch_inputs(rng)
    kw = dict(weights=weights, nu_fits=nu_fits, log10_tau=False,
              device="cpu")
    whole = tfp.fit_portrait_full_batch(data, model, None, P0, FREQS, **kw)
    calls = []
    saved = _kernels.spectra_noise

    def count(dfft, *a, **k):
        calls.append(dfft.shape[0])
        return saved(dfft, *a, **k)

    _kernels.spectra_noise = count
    try:
        chunked = tfp.fit_portrait_full_batch(data, model, None, P0, FREQS,
                                              scan_size=3, **kw)
    finally:
        _kernels.spectra_noise = saved
    assert calls == [3, 3, 2]
    for key in tfp.RESULT_KEYS:   # NaN: lane 5's one channel fixes no DM
        torch.testing.assert_close(chunked[key], whole[key], rtol=0, atol=0,
                                   equal_nan=True)


@pytest.fixture(scope="module")
def unsharded_no_errs(problem):
    """The port's unsharded errs=None fit of the sharding problem, given
    init."""
    return tfp.fit_portrait_full_batch(*_args(problem), fit_flags=FLAGS,
                                       log10_tau=False, device="cpu")


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 1)])
def test_errs_none_mesh_equals_unsharded(problem, unsharded_no_errs, shape):
    """errs=None on a mesh: each cell measures its noise in its spectra
    pass (K4-B) and the fit equals the unsharded errs=None fit."""
    out = tfp.fit_portrait_full_batch(
        *_args(problem), fit_flags=FLAGS, log10_tau=False,
        mesh=tmesh.make_mesh(*shape, devices=["cpu"] * int(np.prod(shape))))
    _assert_port_equal(out, unsharded_no_errs, "errs=None %s" % (shape,))


# -- the wrappers' argument checks -------------------------------------------

def _valid(r=2, nchan=3, nbin=16, kmax=5):
    nharm = nbin // 2 + 1
    g = torch.Generator().manual_seed(0)
    dfft = torch.randn((r, nchan, nharm), dtype=torch.complex128,
                       generator=g)
    mfft = torch.randn((nchan, nharm), dtype=torch.complex128, generator=g)
    w = torch.rand((r, nchan), dtype=torch.float64, generator=g)
    cross, sd, _ = _outs(r, nchan, kmax, per_row=False)
    return dict(dfft=dfft, mfft=mfft, w=w, kmax=kmax, cross=cross, sd=sd,
                nbin=nbin)


def _call(v, noise):
    if noise:
        return _kernels.spectra_noise(
            v["dfft"], v["mfft"], v["w"], v["nbin"], v["kmax"], v["cross"],
            v["sd"], torch.empty_like(v["sd"]), torch.empty_like(v["sd"]))
    return _kernels.spectra(v["dfft"], v["mfft"], v["w"], v["kmax"],
                            v["cross"], v["sd"])


BAD = {
    "dfft_dtype": lambda v: v.update(dfft=v["dfft"].to(torch.complex64)),
    "dfft_2d": lambda v: v.update(dfft=v["dfft"][0]),
    "dfft_strided": lambda v: v.update(
        dfft=torch.cat([v["dfft"], v["dfft"]], -1)[..., ::2]),
    "mfft_nchan": lambda v: v.update(mfft=v["mfft"][:2]),
    "weights_dtype": lambda v: v.update(w=v["w"].float()),
    "weights_shape": lambda v: v.update(w=v["w"][:, :2].contiguous()),
    "cross_kmax": lambda v: v.update(
        cross=torch.empty((2, 3, 4), dtype=torch.complex128)),
    "cross_transposed": lambda v: v.update(
        cross=torch.empty((2, 5, 3), dtype=torch.complex128).transpose(1, 2)),
    "sd_dtype": lambda v: v.update(sd=v["sd"].float()),
    "kmax_zero": lambda v: v.update(kmax=0),
    "kmax_above_nharm": lambda v: v.update(kmax=10),
    "nbin_odd": lambda v: v.update(nbin=15),
}


@pytest.mark.parametrize("noise", [False, True], ids=["A", "B"])
@pytest.mark.parametrize("bad", sorted(BAD))
def test_spectra_wrappers_refuse_bad_arguments(bad, noise):
    v = _valid()
    _call(v, noise)  # the valid arguments pass
    BAD[bad](v)
    if bad == "nbin_odd" and not noise:
        _call(v, noise)  # epilogue A takes no nbin
        return
    with pytest.raises((TypeError, ValueError)):
        _call(v, noise)
