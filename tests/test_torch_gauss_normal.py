"""Kernel K9 (csrc/gauss.cu) on the CPU: the Gaussian portrait fit's
normal equations against the JAX package.

K9's plain version (the route its wrappers take for CPU tensors) gives
f = sum r^2, g = J^T r and J^T J of the unscattered Gaussian portrait's
err-weighted residual from the model's analytic derivatives.  Held to
``jax.jacfwd`` of the JAX package's fit_gaussian_portrait residual
(pulseportraiture_tpu/fit/gauss.py:124-131) on the same numpy inputs:
each of f, g and J^T J within 1e-12 of its largest magnitude (sums of
~4,000 terms taken in another order), lane by lane, with power-law and
linear evolution, one and three components, a component straddling the
phase wrap, a narrow one clipped at |z| = 20 over most bins, one whose
width goes <= 0 over part of the band, per-bin errors and three lanes;
the tau and scattering-index columns zero; the NaN forward-mode gives
at an amplitude's 0 bound given as NaN.  Then lm_solve through the normal
equations against lm_solve through the residual's Jacobian, and the
port's fit_gaussian_portrait on its K9 route against the JAX package's
(parameters within 1e-6 of their errors, rc equal, chi2 1e-10
relative), also at 19 components, and the route each kind of fit takes
(K9 up to its component limit on the card); per-channel errors as a
broadcast view, GaussWork's one check, and the layouts' choice and
limits.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pulseportraiture_tpu.fit import gauss as jg
from pulseportraiture_tpu.fit.lm import lm_solve as jlm
from pulseportraiture_tpu.ops import profiles as jprof
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch.fit import gauss as tg
from pulseportraiture_tpu_torch.fit.lm import lm_solve as tlm
from pulseportraiture_tpu_torch.ops import profiles as tprof
from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers

TOL = 1e-12       # f, g and J^T J against jacfwd's, of their largest magnitude
Z_TOL = 1e-6      # |normal route - reference| / error of each parameter
NU_REF = 1500.0

# (model code, components (loc0, dloc, wid0, dwid, amp0, damp), lanes,
# channels, bins)
CASES = {
    "000-1": ("000", [[0.35, -0.05, 0.05, 0.1, 1.0, -1.2]], 1, 16, 256),
    # loc crosses 1 over the band (the wrap); a component 0.0006 wide
    # (|z| > 20 at most bins); one whose width is <= 0 below ~1250 MHz
    "111-3": ("111", [[0.995, -2e-5, 0.03, 1e-5, 1.0, -1e-3],
                      [0.5, 0.0, 0.0006, 0.0, 0.4, 0.0],
                      [0.2, 1e-4, 0.005, 2e-5, 0.3, 0.0]], 1, 24, 128),
    # loc goes below 0 over the band (remainder of a negative loc)
    "101-3": ("101", [[0.002, -1e-5, 0.04, 0.2, 1.0, 1e-4],
                      [0.6, 0.0, 0.02, -0.3, 0.5, -2e-4],
                      [0.3, 0.0, 0.0008, 0.0, 0.2, 0.0]], 1, 32, 128),
    "000-3-lanes": ("000", [[0.3, -0.05, 0.04, 0.1, 1.0, -1.2],
                            [0.55, 0.02, 0.02, -0.2, 0.6, 0.5],
                            [0.97, 0.0, 0.03, 0.0, 0.3, -2.0]], 3, 16, 128),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, as the other port tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(code, comps, lanes, nchan, nbin, seed=0):
    """Params [lanes, P] (dc, tau = 0, the components, the scattering
    index), data near the model of the first lane with noise, per-bin
    errors and the band."""
    rng = np.random.default_rng(seed)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    base = np.concatenate([[0.02, 0.0], np.ravel(comps), [-4.0]])
    x = np.stack([base * (1.0 + 0.003 * k * np.sign(np.arange(len(base))
                                                    % 3 - 1))
                  for k in range(lanes)])
    phases = np.arange(nbin) / nbin
    model = np.asarray(jprof.gen_gaussian_portrait(
        code, base[:-1], base[-1], phases, freqs, NU_REF))
    errs = 0.02 * rng.uniform(0.5, 1.5, (nchan, nbin))
    data = model + rng.normal(0.0, 1.0, (nchan, nbin)) * errs
    return x, data, errs, freqs


def _reference(code, x, data, errs, freqs):
    """f, g, J^T J and J at one lane's x: jax.jacfwd of the JAX package's
    fit_gaussian_portrait residual."""
    nbin = data.shape[1]
    phases = jnp.asarray(np.arange(nbin) / nbin)
    npar = len(x) - 1

    def res(v):
        model = jprof.gen_gaussian_portrait(code, v[:npar], v[npar], phases,
                                            jnp.asarray(freqs), NU_REF)
        return ((jnp.asarray(data) - model) / jnp.asarray(errs)).ravel()

    v = jnp.asarray(x)
    r = np.asarray(jax.jit(res)(v))
    J = np.asarray(jax.jit(jax.jacfwd(res))(v))
    return float(r @ r), J.T @ r, J.T @ J, J


def _args(x, data, errs, freqs, code):
    t = torch.as_tensor
    return (t(np.atleast_2d(x)), t(data), t(errs),
            get_bin_centers(data.shape[1]), t(freqs), NU_REF, code)


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_normal_plain_matches_jacfwd(case):
    code, comps, lanes, nchan, nbin = CASES[case]
    x, data, errs, freqs = _problem(code, comps, lanes, nchan, nbin)
    args = _args(x, data, errs, freqs, code)
    f, g, JtJ = _kernels.gauss_normal(*args)
    fs = _kernels.gauss_sse(*args)
    P = x.shape[1]
    assert g.shape == (lanes, P) and JtJ.shape == (lanes, P, P)
    for b in range(lanes):
        fr, gr, Hr, J = _reference(code, x[b], data, errs, freqs)
        assert np.isfinite(Hr).all()
        # the tau and scattering-index columns are zero in both
        assert not J[:, 1].any() and not J[:, -1].any()
        for k in (1, P - 1):
            assert g[b, k] == 0.0
            assert not JtJ[b, k].any() and not JtJ[b, :, k].any()
        assert abs(float(f[b]) - fr) <= TOL * fr
        assert abs(float(fs[b]) - fr) <= TOL * fr
        assert _rel(g[b], gr) <= TOL
        assert _rel(JtJ[b], Hr) <= TOL


def test_cases_cover_the_wrap_the_clip_and_dead_widths():
    """The cases' components reach what they are meant to: loc across the
    wrap, |z| >= 20 at most bins of the narrow component, wid <= 0 in part
    of the band."""
    code, comps, _, nchan, _ = CASES["111-3"]
    freqs = np.linspace(1100.0, 1900.0, nchan)
    dnu = freqs - NU_REF
    loc = comps[0][0] + comps[0][1] * dnu
    assert loc.min() < 1.0 < loc.max()
    wid = comps[2][2] + comps[2][3] * dnu
    assert (wid <= 0).sum() >= 3 and (wid > 0).sum() >= 3
    # 40 sigma of the narrow component span under 3 of the 128 bins
    assert 40 * comps[1][2] / jprof.FWHM_FACT * 128 < 3
    code, comps, _, nchan, _ = CASES["101-3"]
    loc = comps[0][0] + comps[0][1] * (np.linspace(1100.0, 1900.0, nchan)
                                       - NU_REF)
    assert loc.min() < 0.0 < loc.max()


@pytest.mark.parametrize("param,nan", [(6, True), (4, False)],
                         ids=["amp0_zero", "wid0_zero"])
def test_power_law_zero_p0_as_jacfwd(param, nan):
    """A power-law parameter at its 0 bound.  amp0 = 0: log's tangent is
    0 / 0 along every parameter, so jacfwd's J is NaN in every column (in
    both packages) and K9's g and J^T J are NaN throughout, not a tidied
    0; f stays finite.  wid0 = 0: the width is 0 at every channel, the
    reference's where selects a zero, and everything is finite."""
    code, comps, _, nchan, nbin = CASES["000-1"]
    x, data, errs, freqs = _problem(code, comps, 1, nchan, nbin)
    x[0, param] = 0.0
    fr, gr, Hr, J = _reference(code, x[0], data, errs, freqs)
    f, g, JtJ = _kernels.gauss_normal(*_args(x, data, errs, freqs, code))
    assert np.isnan(J).all() == nan and np.isnan(J).any() == nan
    np.testing.assert_array_equal(np.isnan(g[0].numpy()), np.isnan(gr))
    np.testing.assert_array_equal(np.isnan(JtJ[0].numpy()), np.isnan(Hr))
    assert np.isfinite(fr) and abs(float(f[0]) - fr) <= TOL * fr
    if not nan:
        assert _rel(g[0], gr) <= TOL and _rel(JtJ[0], Hr) <= TOL


def _fit_setup(code="000", fit_alpha=False, seed=3):
    """A two-component portrait (24 x 128) and the vectors
    fit_gaussian_portrait builds: x0, flags, bounds (tau frozen at 0)."""
    comps = {"000": [[0.35, -0.05, 0.05, 0.1, 1.0, -1.2],
                     [0.6, 0.02, 0.03, -0.2, 0.5, 0.4]],
             "101": [[0.35, -1e-5, 0.05, 0.1, 1.0, -4e-4],
                     [0.6, 2e-5, 0.03, -0.2, 0.5, 2e-4]]}[code]
    true, data, errs, freqs = _problem(code, comps, 1, 24, 128, seed)
    params = true[0, :-1]
    init = params * np.where(np.arange(len(params)) % 2, 1.03, 0.98)
    flags = np.ones(len(params))
    flags[1] = 0.0
    return params, init, flags, data, errs, freqs, fit_alpha


def _bounds(nparam, n):
    lo = np.full(n, -np.inf)
    hi = np.full(n, np.inf)
    lo[1] = 0.0
    lo[4:nparam:6] = 0.0
    hi[4:nparam:6] = 0.25
    lo[6:nparam:6] = 0.0
    return lo, hi


@pytest.mark.parametrize("fit_alpha", [False, True],
                         ids=["alpha_fixed", "alpha_fitted"])
def test_lm_solve_normal_matches_residual(fit_alpha):
    """lm_solve(normal=GaussNormal) against lm_solve on the residual's
    jacfwd, same problem (two lanes, one started farther off): params
    within 1e-6 of their errors, the same infinite errors (a fitted
    scattering index has a zero column), rc equal, chi2 1e-10 relative."""
    params, init, flags, data, errs, freqs, _ = _fit_setup()
    nparam = len(params)
    x0 = np.stack([np.concatenate([init, [-4.0]]),
                   np.concatenate([init * 1.01, [-4.0]])])
    xflags = np.concatenate([flags, [float(fit_alpha)]])
    lo, hi = _bounds(nparam, nparam + 1)
    dt, et, ft = (torch.as_tensor(a) for a in (data, errs, freqs))
    phases = np.arange(data.shape[1]) / data.shape[1]

    def residual(x):
        model = tprof.gen_gaussian_portrait("000", x[:nparam], x[nparam],
                                            phases, ft, NU_REF)
        return ((dt - model) / et).reshape(-1)

    normal = tg.GaussNormal("000", dt, et, ft, NU_REF, data.shape[1])
    want = tlm(residual, torch.as_tensor(x0), fit_flags=xflags,
               bounds=(lo, hi))
    got = tlm(None, torch.as_tensor(x0), fit_flags=xflags, bounds=(lo, hi),
              normal=normal)
    errs_w = want.param_errs.numpy()
    np.testing.assert_array_equal(np.isinf(got.param_errs.numpy()),
                                  np.isinf(errs_w))
    assert np.isinf(errs_w[:, nparam]).all() == fit_alpha
    fin = np.isfinite(errs_w) & (errs_w > 0)
    gap = np.abs(got.params.numpy() - want.params.numpy())
    assert np.all(gap[fin] <= Z_TOL * errs_w[fin])
    assert np.all(np.abs(got.param_errs.numpy()[fin] - errs_w[fin])
                  <= Z_TOL * errs_w[fin])
    np.testing.assert_array_equal(got.return_code.numpy(),
                                  want.return_code.numpy())
    np.testing.assert_allclose(got.chi2.numpy(), want.chi2.numpy(),
                               rtol=1e-10)
    assert got.ndata == want.ndata == data.size


@pytest.mark.parametrize("code,fit_alpha", [("000", False), ("101", True)])
def test_fit_gaussian_portrait_k9_route_matches_reference(code, fit_alpha):
    """The port's fit_gaussian_portrait on the CPU takes K9's route (no
    join groups, tau frozen at 0) and matches the JAX package's: params
    and errors within 1e-6 of the errors, the same infinite errors, rc
    equal (the reference's lm_solve on the same residual, since its fit
    returns no rc), chi2 1e-10 relative."""
    params, init, flags, data, errs, freqs, _ = _fit_setup(code)
    nbin = data.shape[1]
    phases = np.arange(nbin) / nbin
    args = (code, data, init, -4.0, errs, flags, fit_alpha, phases, freqs,
            NU_REF)
    before = dict(tg.FIT_ROUTES)
    got = tg.fit_gaussian_portrait(*args, device="cpu")
    assert tg.FIT_ROUTES["normal"] == before["normal"] + 1
    assert tg.FIT_ROUTES["jacfwd"] == before["jacfwd"]
    ref = jg.fit_gaussian_portrait(*args)
    errs_r = np.asarray(ref.fit_errs)
    np.testing.assert_array_equal(np.isinf(got.fit_errs), np.isinf(errs_r))
    fin = np.isfinite(errs_r) & (errs_r > 0)
    assert fin.sum() >= len(params) - 1
    assert np.all(np.abs(got.fitted_params - np.asarray(ref.fitted_params))
                  [fin] <= Z_TOL * errs_r[fin])
    assert np.all(np.abs(got.fit_errs - errs_r)[fin] <= Z_TOL * errs_r[fin])
    assert np.isinf(got.scattering_index_err) == fit_alpha
    np.testing.assert_allclose(got.chi2, ref.chi2, rtol=1e-10)
    nparam = len(init)
    x0 = np.concatenate([init, [-4.0]])
    xflags = np.concatenate([flags, [float(fit_alpha)]])

    def jres(x):
        return ((jnp.asarray(data) - jprof.gen_gaussian_portrait(
            code, x[:nparam], x[nparam], phases, freqs, NU_REF))
            / jnp.asarray(errs)).ravel()

    ref_lm = jlm(jres, x0, fit_flags=xflags,
                 bounds=_bounds(nparam, nparam + 1))
    assert got.return_code == int(ref_lm.return_code)


@pytest.mark.parametrize("kind,route", [
    pytest.param("joined", "spectral", id="joined"),
    pytest.param("tau_nonzero", "spectral", id="tau_nonzero"),
    pytest.param("tau_fitted", "spectral", id="tau_fitted"),
    pytest.param("tau_fitted_per_bin_errs", "jacfwd",
                 id="tau_fitted_per_bin_errs"),
    pytest.param("overlapping_joins", "jacfwd", id="overlapping_joins")])
def test_other_fits_keep_jacfwd(kind, route):
    """The fits K9 does not take: join groups, a nonzero starting tau (a
    scattered model) and a fitted tau take K10's route ("spectral") since
    it exists; those K10 does not take either keep jacfwd: errors that
    vary along the bins, and join groups that share a channel.  The route
    counter says which ran, and K9's never does."""
    nbin, nchan, P = 64, 8, 0.005
    freqs = np.linspace(1100.0, 1900.0, nchan)
    params = np.array([0.02, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2])
    phases = np.arange(nbin) / nbin
    rng = np.random.default_rng(5)
    model = tprof.gen_gaussian_portrait("000", params, -4.0, phases, freqs,
                                        NU_REF).numpy()
    data = model + rng.normal(0.0, 0.01, model.shape)
    init = params * 1.01
    flags = np.ones(len(params))
    flags[1] = 0.0
    join = ()
    errs = np.full(data.shape, 0.01)
    if kind in ("joined", "overlapping_joins"):
        first = 4 if kind == "joined" else 5
        join = [[np.arange(0, first), np.arange(4, nchan)],
                np.array([0.0, 0.0, 0.0, 0.0]), np.array([0, 0, 1, 1])]
    elif kind == "tau_nonzero":
        init[1] = 2.0
    else:
        flags[1] = 1.0
        if kind == "tau_fitted_per_bin_errs":
            errs = errs * np.linspace(0.9, 1.1, nbin)
    before = dict(tg.FIT_ROUTES)
    fit = tg.fit_gaussian_portrait("000", data, init, -4.0, errs, flags,
                                   False, phases, freqs, NU_REF, join, P,
                                   device="cpu")
    assert tg.FIT_ROUTES[route] == before[route] + 1
    assert tg.FIT_ROUTES["normal"] == before["normal"]
    assert sum(tg.FIT_ROUTES.values()) == sum(before.values()) + 1
    assert np.isfinite(fit.fitted_params).all() and np.isfinite(fit.chi2)


def test_gauss_wrappers_refuse_bad_arguments():
    code, comps, _, nchan, nbin = CASES["000-1"]
    x, data, errs, freqs = _problem(code, comps, 1, nchan, nbin)
    args = list(_args(x, data, errs, freqs, code))
    for fn in (_kernels.gauss_normal, _kernels.gauss_sse):
        bad = list(args)
        bad[0] = args[0].float()
        with pytest.raises(TypeError, match="float64"):
            fn(*bad)
        bad = list(args)
        bad[0] = args[0][:, :-1].contiguous()
        with pytest.raises(ValueError, match="6 ngauss"):
            fn(*bad)
        bad = list(args)
        bad[2] = args[2][:, :-1].contiguous()
        with pytest.raises(ValueError, match="disagree"):
            fn(*bad)
        bad = list(args)
        bad[1] = args[1].t().contiguous().t()
        with pytest.raises(ValueError, match="contiguous"):
            fn(*bad)
        with pytest.raises(ValueError, match="model_code"):
            fn(*args[:-1], "020")
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args))


def _limit_layout():
    K = _kernels
    assert K.GAUSS_WARP_NGAUSS == 2
    assert [K.gauss_layout(n) for n in (1, 2, 3, 19, K.GAUSS_MAX_NGAUSS)] \
        == ["warp", "warp", "mma", "mma", "mma"]


def _limit_max():
    # the mma layout's limit, well past the tiled design's former 756
    # (csrc/gauss.cu's static_assert holds it to a block's shared memory;
    # tests/test_torch_cuda_paths.py reads the geometry on the card)
    K = _kernels
    assert K.GAUSS_MAX_NGAUSS == 1888 > 756


def _limit_sse():
    K = _kernels
    assert K.GAUSS_SSE_MAX_NGAUSS == 6456 >= K.GAUSS_MAX_NGAUSS


@pytest.mark.parametrize("case", ["layout", "max", "sse"])
def test_gauss_normal_shared_memory_limit(case):
    """The layouts' choice and limits: the warp layout at 1-2 components,
    the FP64 tensor cores beyond; the most components epilogue B's mma
    layout and epilogue A take within the H100's 232,448 bytes of shared
    memory a block."""
    globals()["_limit_" + case]()


@pytest.mark.parametrize("ngauss,device,route", [
    ("max-1", "cuda", "normal"), ("max", "cuda", "normal"),
    ("max+1", "cuda", "jacfwd"), ("max+1", "cpu", "normal"),
    (1, "cuda", "normal"), (1, "cpu", "normal")])
def test_portrait_route_reads_the_kernel_limit(ngauss, device, route):
    """fit.gauss.portrait_route: an unscattered, unjoined fit takes K9 on a
    CUDA device up to _kernels.GAUSS_MAX_NGAUSS components and jacfwd
    beyond; the CPU's plain version has no limit.  The other fits (join
    groups, a nonzero or fitted tau) take K10's route instead, within its
    own limit on the card (tests/test_torch_gauss_ft_normal.py holds it),
    and never K9's.  Decided from the problem and its device (no card
    needed)."""
    n = _kernels.GAUSS_MAX_NGAUSS
    ng = {"max-1": n - 1, "max": n, "max+1": n + 1}.get(ngauss, ngauss)
    assert tg.portrait_route(0, 0.0, 0.0, ng, device) == route
    assert tg.portrait_route(0, 0.0, 0.0, ng, torch.device(device)) == route
    k10 = "spectral" if device == "cpu" or \
        ng <= _kernels.GAUSS_FT_MAX_NGAUSS else "jacfwd"
    for other in ((1, 0.0, 0.0), (0, 2.0, 0.0), (0, 0.0, 1.0)):
        assert tg.portrait_route(*other, ng, device, nbin=2048) == k10


@pytest.mark.parametrize("ngauss,route", [(1, "normal"), (2, "jacfwd")])
def test_fit_routes_count_both_sides_of_the_limit(monkeypatch, ngauss,
                                                  route):
    """fit_gaussian_portrait counts its route in FIT_ROUTES, and the route
    follows the limit constant: with GAUSS_MAX_NGAUSS set to 1 and the
    route decided as for a CUDA device, a one-component fit takes K9 and a
    two-component fit jacfwd (the fits themselves run on the CPU)."""
    real = tg.portrait_route
    monkeypatch.setattr(_kernels, "GAUSS_MAX_NGAUSS", 1)
    monkeypatch.setattr(tg, "portrait_route",
                        lambda nj, t0, tf, ng, dev, **kw: real(
                            nj, t0, tf, ng, "cuda", **kw))
    comps = [[0.35, -0.05, 0.05, 0.1, 1.0, -1.2],
             [0.6, 0.02, 0.03, -0.2, 0.5, 0.4]][:ngauss]
    true, data, errs, freqs = _problem("000", comps, 1, 12, 64, seed=2)
    params = true[0, :-1]
    flags = np.ones(len(params))
    flags[1] = 0.0
    before = dict(tg.FIT_ROUTES)
    fit = tg.fit_gaussian_portrait("000", data, params * 1.01, -4.0, errs,
                                   flags, False, np.arange(64) / 64, freqs,
                                   NU_REF, device="cpu")
    other = "jacfwd" if route == "normal" else "normal"
    assert tg.FIT_ROUTES[route] == before[route] + 1
    assert tg.FIT_ROUTES[other] == before[other]
    assert np.isfinite(fit.fitted_params).all() and fit.return_code in (1, 2)


def test_gauss_work_checks_the_fixed_arguments_once():
    """A GaussWork checks data, errs, bins and freqs when it is made; a call
    with it checks params, that the fixed arguments are laid out as the
    work's (shape, strides, dtype, device) and that its model code is the
    work's, and gives the bits of a call without it (on the CPU, the plain
    version's)."""
    code, comps, _, nchan, nbin = CASES["000-3-lanes"]
    x, data, errs, freqs = _problem(code, comps, 3, nchan, nbin)
    args = _args(x, data, errs, freqs, code)
    work = _kernels.GaussWork(*args[1:])
    for fn in (_kernels.gauss_normal, _kernels.gauss_sse):
        got, want = fn(*args, work=work), fn(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)
        with pytest.raises(TypeError, match="float64"):
            fn(args[0].float(), *args[1:], work=work)
        with pytest.raises(ValueError, match="laid out"):
            fn(args[0], args[1][:, :-1].contiguous(), *args[2:], work=work)
        with pytest.raises(ValueError, match="laid out"):
            fn(*args[:2], args[2][:, :1].expand(nchan, nbin), *args[3:],
               work=work)
        with pytest.raises(ValueError, match="not the work's"):
            fn(*args[:-1], "111", work=work)
    with pytest.raises(ValueError, match="disagree"):
        _kernels.GaussWork(args[1], args[2][:, :-1].contiguous(),
                           *args[3:])
    with pytest.raises(ValueError, match="model_code"):
        _kernels.GaussWork(*args[1:-1], "012")


def test_per_channel_errs_are_read_as_a_value_a_channel():
    """Per-channel errors broadcast over the bins (stride 0 along them) go
    into K9 as that view, with the same results as the materialised
    errors; fit_gaussian_portrait hands GaussNormal such a view when the
    errors it is given are constant along each channel (ppgauss's), and
    contiguous per-bin errors otherwise."""
    code, comps, _, nchan, nbin = CASES["000-1"]
    x, data, _, freqs = _problem(code, comps, 1, nchan, nbin)
    noise = np.linspace(0.01, 0.03, nchan)
    full = np.outer(noise, np.ones(nbin))
    args = list(_args(x, data, full, freqs, code))
    view = list(args)
    view[2] = torch.as_tensor(noise)[:, None].expand(nchan, nbin)
    assert view[2].stride() == (1, 0)
    for a, b in zip(_kernels.gauss_normal(*view), _kernels.gauss_normal(*args)):
        assert torch.equal(a, b)
    assert torch.equal(_kernels.gauss_sse(*view), _kernels.gauss_sse(*args))

    seen = []

    class Keep(tg.GaussNormal):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self.errs.stride())

    params = x[0, :-1]
    flags = np.ones(len(params))
    flags[1] = 0.0
    phases = np.arange(nbin) / nbin
    per_bin = full * np.linspace(0.9, 1.1, nbin)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "GaussNormal", Keep)
        for errs in (full, per_bin):
            tg.fit_gaussian_portrait(code, data, params * 1.01, -4.0, errs,
                                     flags, False, phases, freqs, NU_REF,
                                     device="cpu")
    assert seen == [(1, 0), (nbin, 1)]


def test_fit_gaussian_portrait_19_components_k9_route():
    """A 19-component portrait (one more than pass 1's single tile takes
    on the card) fits through K9's route and matches the JAX package's
    fit: params and errors within 1e-6 of the errors, chi2 1e-10
    relative."""
    ng, nchan, nbin = 19, 16, 256
    comps = [[0.03 + 0.05 * c, -0.01, 0.012, 0.05, 1.0 - 0.03 * c, -1.0]
             for c in range(ng)]
    true, data, _, freqs = _problem("000", comps, 1, nchan, nbin, seed=4)
    params = true[0, :-1]
    init = params * np.where(np.arange(len(params)) % 2, 1.01, 0.995)
    flags = np.ones(len(params))
    flags[1] = 0.0
    errs = np.outer(0.02 * np.random.default_rng(1).uniform(0.5, 1.5, nchan),
                    np.ones(nbin))
    args = ("000", data, init, -4.0, errs, flags, False,
            np.arange(nbin) / nbin, freqs, NU_REF)
    before = dict(tg.FIT_ROUTES)
    got = tg.fit_gaussian_portrait(*args, device="cpu")
    assert tg.FIT_ROUTES["normal"] == before["normal"] + 1
    assert tg.FIT_ROUTES["jacfwd"] == before["jacfwd"]
    ref = jg.fit_gaussian_portrait(*args)
    errs_r = np.asarray(ref.fit_errs)
    fin = np.isfinite(errs_r) & (errs_r > 0)
    assert fin.sum() == len(params) - 1 and got.return_code == 1
    assert np.all(np.abs(got.fitted_params - np.asarray(ref.fitted_params))
                  [fin] <= Z_TOL * errs_r[fin])
    assert np.all(np.abs(got.fit_errs - errs_r)[fin] <= Z_TOL * errs_r[fin])
    np.testing.assert_allclose(got.chi2, ref.chi2, rtol=1e-10)


_CTYPE = {"const void*": _kernels._VP, "void*": _kernels._VP,
          "int64_t": _kernels._I64, "int": _kernels._INT,
          "double": _kernels._DBL}


@pytest.mark.parametrize("name", ["gauss_normal", "gauss_sse",
                                  "gauss_sizes"])
def test_gauss_bindings_match_the_source(name):
    """Each C entry point pp_<name> of csrc/gauss.cu takes, in order, the
    argument types its ctypes bindings declare (the launches' stream
    last)."""
    text = open(_kernels.CSRC_DIR + "/gauss.cu").read()
    symbol = "pp_" + name
    bound = [syms[symbol] for syms in _kernels._SYMBOLS.values()
             if symbol in syms]
    assert bound
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % symbol, text)
    assert m is not None
    params = [re.sub(r"\s+\w+$", "", p.strip()) for p in m.group(1).split(",")]
    for argtypes in bound:
        assert [_CTYPE[p] for p in params] == argtypes


@pytest.mark.parametrize("python,source", [
    ("GAUSS_WARP_NGAUSS", "kWarpNgauss"), ("GAUSS_MAX_NGAUSS", "kMaxNgauss"),
    ("GAUSS_SSE_MAX_NGAUSS", "kSseMaxNgauss")])
def test_gauss_constants_match_the_source(python, source):
    """The wrappers' layout choice and limits are csrc/gauss.cu's."""
    text = open(_kernels.CSRC_DIR + "/gauss.cu").read()
    m = re.search(r"constexpr int %s = (\d+);" % source, text)
    assert m is not None
    assert int(m.group(1)) == getattr(_kernels, python)
