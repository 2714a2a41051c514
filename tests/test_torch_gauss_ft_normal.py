"""Kernel K10 (csrc/gauss_ft.cu) on the CPU: the scattered and joined
Gaussian portrait fit's normal equations against the JAX package.

K10's plain versions (the route its wrappers take for CPU tensors) give
f = sum r^2, g = J^T r and J^T J of the Gaussian portrait's err-weighted
residual, scattered where tau != 0 and rotated in each join group, from
the spectra of the Jacobian's columns packed half-complex (Parseval: the
errors are one value a channel).  Held to ``jax.jacfwd`` of the JAX
package's fit_gaussian_portrait residual (pulseportraiture_tpu/fit/
gauss.py:124-131) on the same numpy inputs: f and J^T J within 1e-12 of
their largest magnitude and g within 1e-10 (TOL, G_TOL), lane by lane,
for model codes 000 and 111, one to three components, one and three lanes, at tau > 0 (the scattering
index fixed or fitted: the Jacobian has its column either way), tau = 0
with tau fitted (its and the scattering index's rows and columns exactly
0), two join groups, joined and scattered, a component across the phase
wrap, a width <= 0 over part of the band, a power law's p0 = 0 (NaN where
jacfwd's is), and even widths whose Nyquist harmonic carries signal.  Then
the port's fit_gaussian_portrait on K10's route against the JAX package's
(parameters within max(1e-6, 4 sqrt(eps chi2)) of their errors, rc
equal), the route each kind of fit takes and FIT_ROUTES counting it,
GaussFtWork's checks, and the C source's constants and signatures.  The
kernel itself is held to these plain versions on the card
(tests/test_torch_cuda_paths.py, chip_smoke.py).
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
from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers

# f and J^T J against jacfwd's, of their largest magnitude (sums of ~2,000
# terms taken in another order, through other transforms); g within G_TOL:
# near the solution g = J^T r sums terms of ||J|| ||r|| to much less, and
# both packages' transforms round r by ~1e-16 of the model, so where a
# narrow component makes J's columns reach 1e8 (the dead-width and wrap
# cases) g agrees to 1.2e-11 and 5.2e-11 of its largest magnitude, and to
# 5e-13 elsewhere
TOL = 1e-12
G_TOL = 1e-10
NU_REF = 1500.0
PERIOD = 0.005

# components (loc0, dloc, wid0, dwid, amp0, damp) per model code
COMPS = {
    "000": [[0.35, -0.05, 0.05, 0.1, 1.0, -1.2],
            [0.6, 0.02, 0.02, -0.2, 0.5, 0.4],
            [0.8, 0.0, 0.004, 0.0, 0.3, -2.0]],
    "111": [[0.3, -1e-5, 0.04, 1e-5, 1.0, -2e-4],
            [0.62, 2e-5, 0.02, -1e-5, 0.5, 1e-4],
            [0.85, 0.0, 0.004, 0.0, 0.3, 0.0]],
}
# (model code, components, lanes, channels, bins, tau [bins], scattering
# index, join groups)
TWO = [np.arange(0, 5), np.arange(5, 12)]
CASES = {
    "tau-000-1": ("000", 1, 1, 12, 128, 3.0, -4.0, ()),
    "tau-111-3-lanes": ("111", 3, 3, 8, 64, 1.5, -4.0, ()),
    "alpha-000-2": ("000", 2, 1, 16, 256, 2.0, -3.1, ()),
    "tau0-000-2": ("000", 2, 1, 12, 128, 0.0, -4.0, ()),
    "tau0-111-1-lanes": ("111", 1, 3, 8, 64, 0.0, -4.0, ()),
    "joined-000-2": ("000", 2, 1, 12, 128, 0.0, -4.0, TWO),
    "joined-111-3-lanes": ("111", 3, 3, 12, 64, 0.0, -4.0, TWO),
    "joined-tau-000-3": ("000", 3, 1, 12, 128, 2.5, -4.0, TWO),
    "joined-tau-111-1-lanes": ("111", 1, 3, 12, 64, 1.0, -3.5, TWO),
}
JOIN_PARAMS = np.array([0.013, 1e-3, -0.021, -2e-3])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, as the other port tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups(joins, nchan):
    groups = np.full(nchan, -1, dtype=np.int32)
    for j, ichans in enumerate(joins):
        groups[ichans] = j
    return groups


def _problem(code, comps, lanes, nchan, nbin, tau, alpha, joins, seed=0):
    """Params [lanes, P] (dc, tau, the components, the scattering index,
    each join group's (phase, DM)), data near the first lane's model with
    noise, per-channel errors and the band."""
    rng = np.random.default_rng(seed)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    jp = JOIN_PARAMS[:2 * len(joins)]
    base = np.concatenate([[0.02, tau], np.ravel(comps), [alpha], jp])
    x = np.stack([base * (1.0 + 0.003 * k * np.sign(np.arange(len(base))
                                                    % 3 - 1))
                  for k in range(lanes)])
    phases = np.arange(nbin) / nbin
    npar = 2 + 6 * len(comps)
    model = np.asarray(jprof.gen_gaussian_portrait(
        code, np.concatenate([base[:npar], jp]), alpha, phases, freqs,
        NU_REF, join_ichans=joins, P=PERIOD))
    noise = 0.02 * rng.uniform(0.5, 1.5, nchan)
    data = model + rng.normal(0.0, 1.0, (nchan, nbin)) * noise[:, None]
    return x, data, noise, freqs


def _reference(code, x, data, noise, freqs, joins):
    """f, g, J^T J and J at one lane's x: jax.jacfwd of the JAX package's
    fit_gaussian_portrait residual (its parameter vector: the model's, the
    scattering index, the join pairs)."""
    nbin = data.shape[1]
    phases = jnp.asarray(np.arange(nbin) / nbin)
    npar = len(x) - 1 - 2 * len(joins)
    errs = jnp.asarray(np.outer(noise, np.ones(nbin)))

    def res(v):
        mpar = jnp.concatenate([v[:npar], v[npar + 1:]]) if len(joins) \
            else v[:npar]
        model = jprof.gen_gaussian_portrait(
            code, mpar, v[npar], phases, jnp.asarray(freqs), NU_REF,
            join_ichans=joins, P=PERIOD if len(joins) else None)
        return ((jnp.asarray(data) - model) / errs).ravel()

    v = jnp.asarray(x)
    r = np.asarray(jax.jit(res)(v))
    J = np.asarray(jax.jit(jax.jacfwd(res))(v))
    return float(r @ r), J.T @ r, J.T @ J, J


def _args(x, data, noise, freqs, code, joins):
    t = torch.as_tensor
    nchan, nbin = data.shape
    return (t(np.atleast_2d(x)), t(data),
            t(noise[:, None]).expand(nchan, nbin), get_bin_centers(nbin),
            t(freqs), NU_REF, code, t(_groups(joins, nchan)), len(joins),
            PERIOD if len(joins) else 1.0)


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / np.abs(want).max()


def _case(name):
    code, ng, lanes, nchan, nbin, tau, alpha, joins = CASES[name]
    x, data, noise, freqs = _problem(code, COMPS[code][:ng], lanes, nchan,
                                     nbin, tau, alpha, joins)
    return code, x, data, noise, freqs, joins


@pytest.mark.parametrize("case", sorted(CASES))
def test_normal_plain_matches_jacfwd(case):
    code, x, data, noise, freqs, joins = _case(case)
    args = _args(x, data, noise, freqs, code, joins)
    f, g, JtJ = _kernels.gauss_ft_normal(*args)
    fs = _kernels.gauss_ft_sse(*args)
    lanes, P = x.shape
    assert g.shape == (lanes, P) and JtJ.shape == (lanes, P, P)
    for b in range(lanes):
        fr, gr, Hr, _ = _reference(code, x[b], data, noise, freqs, joins)
        assert abs(float(f[b]) - fr) <= TOL * fr
        assert abs(float(fs[b]) - fr) <= TOL * fr
        assert _rel(g[b], gr) <= G_TOL
        assert _rel(JtJ[b], Hr) <= TOL
        np.testing.assert_array_equal(JtJ[b].numpy(), JtJ[b].numpy().T)


@pytest.mark.parametrize("case", ["tau0-000-2", "tau0-111-1-lanes",
                                  "joined-000-2"])
def test_tau_zero_rows_and_columns_exactly_zero(case):
    """At tau = 0 the reference's model is unscattered (its where selects
    that branch), so jacfwd's tau and scattering-index columns are exactly
    0; K10's g and J^T J hold exact zeros there too, with no rounding
    residue, as lm_solve's identifiability mask (colnorm > 1e-30) needs."""
    code, x, data, noise, freqs, joins = _case(case)
    _, g, JtJ = _kernels.gauss_ft_normal(*_args(x, data, noise, freqs, code,
                                               joins))
    ia = x.shape[1] - 1 - 2 * len(joins)
    _, _, _, J = _reference(code, x[0], data, noise, freqs, joins)
    assert not J[:, 1].any() and not J[:, ia].any()
    for i in (1, ia):
        assert not g[:, i].any()
        assert not JtJ[:, i, :].any() and not JtJ[:, :, i].any()
    assert JtJ[:, 0, 0].abs().min() > 0


def test_cases_cover_the_wrap_the_nyquist_and_joins():
    """The fixtures reach what the kernel must get right: the last
    component of each code is narrow enough that the Nyquist harmonic of
    an even width carries signal; the scattered cases hold tau > 0 and
    the tau0 ones exactly 0; the join groups split the band in two."""
    for code, comps in COMPS.items():
        for nbin in (64, 128, 256):
            port = np.asarray(jprof.gen_gaussian_portrait(
                code, np.concatenate([[0.0, 0.0], np.ravel(comps)]), -4.0,
                np.arange(nbin) / nbin, np.linspace(1100.0, 1900.0, 8),
                NU_REF))
            ny = np.abs(np.fft.rfft(port)[:, -1])
            assert ny.min() > 1e-12 * np.abs(port).sum(axis=1).max()
    assert _groups(TWO, 12).tolist() == [0] * 5 + [1] * 7


def _edge_case(kind):
    """A one-lane scattered problem with an edge in it: a component whose
    loc crosses 1 over the band (the wrap), one whose width goes <= 0
    below ~1250 MHz (dead there), or an amplitude's power-law p0 at 0."""
    comps = [list(c) for c in COMPS["000"][:2]]
    if kind == "wrap":
        comps[0][:2] = [0.995, -6e-5]
    elif kind == "dead":
        comps[1][2:4] = [0.01, 4e-5]
    x, data, noise, freqs = _problem("111" if kind != "p0" else "000",
                                     comps, 1, 16, 128, 2.0, -4.0, ())
    if kind == "p0":
        x[0, 6] = 0.0
    return ("111" if kind != "p0" else "000"), x, data, noise, freqs


@pytest.mark.parametrize("kind", ["wrap", "dead"])
def test_wrap_and_dead_width_match_jacfwd(kind):
    code, x, data, noise, freqs = _edge_case(kind)
    freq_dnu = freqs - NU_REF
    if kind == "wrap":
        loc = x[0, 2] + x[0, 3] * freq_dnu
        assert loc.min() < 1.0 < loc.max()
    else:
        wid = x[0, 10] + x[0, 11] * freq_dnu
        assert (wid <= 0).sum() >= 3 and (wid > 0).sum() >= 3
    f, g, JtJ = _kernels.gauss_ft_normal(*_args(x, data, noise, freqs, code,
                                               ()))
    fr, gr, Hr, _ = _reference(code, x[0], data, noise, freqs, ())
    assert abs(float(f[0]) - fr) <= TOL * fr
    assert _rel(g[0], gr) <= G_TOL and _rel(JtJ[0], Hr) <= TOL


def test_power_law_zero_p0_as_jacfwd():
    """amp0 at its 0 bound under the power law: forward-mode's tangent of
    the amplitude is 0 / 0 along every parameter and the transforms carry
    it to every bin, so jacfwd's J is NaN in every column and K10's g and
    J^T J are NaN throughout; f stays finite."""
    code, x, data, noise, freqs = _edge_case("p0")
    fr, gr, Hr, J = _reference(code, x[0], data, noise, freqs, ())
    f, g, JtJ = _kernels.gauss_ft_normal(*_args(x, data, noise, freqs, code,
                                               ()))
    assert np.isnan(J).all()
    np.testing.assert_array_equal(np.isnan(g[0].numpy()), np.isnan(gr))
    np.testing.assert_array_equal(np.isnan(JtJ[0].numpy()), np.isnan(Hr))
    assert np.isfinite(fr) and abs(float(f[0]) - fr) <= TOL * fr


# -- the fits -----------------------------------------------------------------

def _z_floor(chi2):
    """The gap below which float64 chi2 cannot tell two parameter vectors
    apart, in units of the errors: two LM runs summing in other orders may
    stop anywhere within it."""
    return max(1e-6, 4.0 * np.sqrt(np.finfo(float).eps * chi2))


FIT_CASES = {
    # (model code, tau start, tau fitted, alpha fitted, join groups)
    "scattered": ("000", 2.0, True, False, ()),
    "scattered_alpha": ("000", 2.0, True, True, ()),
    "tau_fixed": ("111", 1.5, False, False, ()),
    "joined": ("000", 0.0, False, False, TWO),
    "joined_scattered": ("000", 2.0, True, True, TWO),
}


def _fit_args(kind):
    code, tau, tau_fit, alpha_fit, joins = FIT_CASES[kind]
    comps = COMPS[code][:2]
    # the data scattered by tau 2 where tau is fitted, else by the fit's tau
    true, data, noise, freqs = _problem(code, comps, 1, 12, 128,
                                        2.0 if tau_fit else tau, -4.0, joins,
                                        seed=5)
    nparam = 2 + 6 * len(comps)
    params = true[0, :nparam].copy()
    init = params * np.where(np.arange(nparam) % 2, 1.02, 0.98)
    init[1] = tau
    flags = np.ones(nparam)
    flags[1] = float(tau_fit)
    join = ()
    if joins:
        # the first group's phase frozen at its truth, the rest fitted
        join = [joins, np.array([JOIN_PARAMS[0], 0.0, -0.02, 0.0]),
                np.array([0, 1, 1, 1])]
    nbin = data.shape[1]
    errs = np.outer(noise, np.ones(nbin))
    return (code, data, init, -3.7, errs, flags, alpha_fit,
            np.arange(nbin) / nbin, freqs, NU_REF, join,
            PERIOD if joins else None)


@pytest.mark.parametrize("kind", sorted(FIT_CASES))
def test_fit_gaussian_portrait_k10_route_matches_reference(kind):
    """The port's fit_gaussian_portrait on the CPU takes K10's route and
    matches the JAX package's: every parameter and error within
    max(1e-6, 4 sqrt(eps chi2)) of the reference's error, the same
    infinite errors, rc equal to the reference's lm_solve on the same
    residual (its fit returns no rc), chi2 1e-10 relative."""
    args = _fit_args(kind)
    before = dict(tg.FIT_ROUTES)
    got = tg.fit_gaussian_portrait(*args, device="cpu")
    assert tg.FIT_ROUTES["spectral"] == before["spectral"] + 1
    assert tg.FIT_ROUTES["jacfwd"] == before["jacfwd"]
    assert tg.FIT_ROUTES["normal"] == before["normal"]
    ref = jg.fit_gaussian_portrait(*args)
    z = _z_floor(ref.chi2)
    errs_r = np.asarray(ref.fit_errs)
    np.testing.assert_array_equal(np.isinf(got.fit_errs), np.isinf(errs_r))
    fin = np.isfinite(errs_r) & (errs_r > 0)
    assert fin.sum() >= 12
    assert np.all(np.abs(got.fitted_params - np.asarray(ref.fitted_params))
                  [fin] <= z * errs_r[fin])
    assert np.all(np.abs(got.fit_errs - errs_r)[fin] <= z * errs_r[fin])
    if args[6]:
        assert abs(got.scattering_index - ref.scattering_index) <= \
            z * ref.scattering_index_err
    np.testing.assert_allclose(got.chi2, ref.chi2, rtol=1e-10)

    code, data, init, alpha, errs, flags, fit_alpha, phases, freqs, \
        nu_ref, join, P = args
    nparam = len(init)
    nj = len(join[0]) if join else 0
    jv = join[1] if join else np.zeros(0)
    x0 = np.concatenate([init, [alpha], jv])
    xflags = np.concatenate([flags, [float(fit_alpha)],
                             join[2] if join else np.zeros(0)])
    lo = np.full(len(x0), -np.inf)
    hi = np.full(len(x0), np.inf)
    lo[1] = 0.0
    lo[4:nparam:6] = 0.0
    hi[4:nparam:6] = 0.25
    lo[6:nparam:6] = 0.0

    def jres(x):
        mpar = jnp.concatenate([x[:nparam], x[nparam + 1:]]) if nj \
            else x[:nparam]
        return ((jnp.asarray(data) - jprof.gen_gaussian_portrait(
            code, mpar, x[nparam], phases, freqs, nu_ref,
            join_ichans=join[0] if nj else (), P=P))
            / jnp.asarray(errs)).ravel()

    ref_lm = jlm(jres, x0, fit_flags=xflags, bounds=(lo, hi))
    assert got.return_code == int(ref_lm.return_code)


@pytest.mark.parametrize("ngauss,device,route", [
    ("max", "cuda", "spectral"), ("max+1", "cuda", "jacfwd"),
    ("max+1", "cpu", "spectral"), (1, "cpu", "spectral")])
def test_portrait_route_reads_k10_limit(ngauss, device, route):
    """fit.gauss.portrait_route: a scattered or joined fit takes K10 on a
    CUDA device up to _kernels.GAUSS_FT_MAX_NGAUSS components and jacfwd
    beyond; the CPU's plain version has no limit.  Decided from the
    problem and its device (no card needed)."""
    n = _kernels.GAUSS_FT_MAX_NGAUSS
    ng = {"max": n, "max+1": n + 1}.get(ngauss, ngauss)
    for kind in ((1, 0.0, 0.0), (0, 2.0, 0.0), (0, 0.0, 1.0), (2, 3.0, 1.0)):
        assert tg.portrait_route(*kind, ng, device, nbin=2048) == route


@pytest.mark.parametrize("why", ["per_bin_errs", "overlapping_groups",
                                 "width_odd", "width_wide", "width_small",
                                 "width_unknown"])
def test_portrait_route_keeps_jacfwd(why):
    """What K10 does not take keeps jacfwd: errors that vary along the bins
    (Parseval does not hold) and overlapping join groups (their
    composition is left to the reference's own arithmetic) on any device;
    on the card a width its transforms do not take (not a power of two,
    beyond GAUSS_FT_MAX_BINS or below GAUSS_FT_MIN_BINS, or not given)."""
    kw = dict(nbin=2048)
    devices = ("cuda",)
    if why == "per_bin_errs":
        kw["per_channel"], devices = False, ("cuda", "cpu")
    elif why == "overlapping_groups":
        kw["disjoint"], devices = False, ("cuda", "cpu")
    else:
        kw["nbin"] = {"width_odd": 2000, "width_wide": 16384,
                      "width_small": 32, "width_unknown": None}[why]
        assert tg.portrait_route(0, 2.0, 1.0, 3, "cpu", **kw) == "spectral"
    for dev in devices:
        assert tg.portrait_route(0, 2.0, 1.0, 3, dev, **kw) == "jacfwd"
        assert tg.portrait_route(1, 0.0, 0.0, 3, dev, **kw) == "jacfwd"
    # the unscattered, unjoined fit stays K9's whatever K10 would take
    assert tg.portrait_route(0, 0.0, 0.0, 3, "cuda", **kw) == "normal"


@pytest.mark.parametrize("kind", ["per_bin_errs", "overlapping_groups"])
def test_fits_k10_does_not_take_count_jacfwd(kind):
    """fit_gaussian_portrait counts those fits in FIT_ROUTES["jacfwd"] and
    still fits: errors that vary along the bins, and two join groups
    sharing a channel."""
    args = list(_fit_args("joined_scattered" if kind == "overlapping_groups"
                          else "scattered"))
    if kind == "per_bin_errs":
        args[4] = args[4] * np.linspace(0.9, 1.1, args[4].shape[1])
    else:
        args[10] = [[np.arange(0, 6), np.arange(5, 12)], args[10][1],
                    args[10][2]]
    before = dict(tg.FIT_ROUTES)
    fit = tg.fit_gaussian_portrait(*args, device="cpu")
    assert tg.FIT_ROUTES["jacfwd"] == before["jacfwd"] + 1
    assert tg.FIT_ROUTES["spectral"] == before["spectral"]
    assert np.isfinite(fit.fitted_params).all() and np.isfinite(fit.chi2)


def test_join_groups_of_channels():
    groups, disjoint = tg._join_groups([np.arange(0, 3), [5, 6]], 8)
    assert groups.tolist() == [0, 0, 0, -1, -1, 1, 1, -1] and disjoint
    _, disjoint = tg._join_groups([np.arange(0, 3), [2, 6]], 8)
    assert not disjoint


# -- the wrappers' checks, the work, the source -------------------------------

def test_gauss_ft_wrappers_refuse_bad_arguments():
    code, x, data, noise, freqs, joins = _case("joined-000-2")
    args = list(_args(x, data, noise, freqs, code, joins))
    for fn in (_kernels.gauss_ft_normal, _kernels.gauss_ft_sse):
        bad = list(args)
        bad[0] = args[0][:, :-1].contiguous()
        with pytest.raises(ValueError, match="6 ngauss"):
            fn(*bad)
        bad = list(args)
        bad[2] = torch.as_tensor(np.outer(noise, np.ones(data.shape[1])))
        with pytest.raises(ValueError, match="a value a channel"):
            fn(*bad)
        bad = list(args)
        bad[7] = args[7].long()
        with pytest.raises(TypeError, match="int32"):
            fn(*bad)
        bad = list(args)
        bad[7] = args[7].clone()
        bad[7][0] = 2
        with pytest.raises(ValueError, match="join groups"):
            fn(*bad)
        with pytest.raises(ValueError, match="model_code"):
            fn(*args[:6], "020", *args[7:])
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args))


def test_gauss_ft_work_checks_the_fixed_arguments_once():
    """A GaussFtWork checks data, errs, bins, freqs and groups when it is
    made and keeps the data's packed spectrum; a call with it checks
    params and that the rest is laid out as the work's, with its model
    code, join groups' count and period; its results are the plain
    version's."""
    code, x, data, noise, freqs, joins = _case("joined-tau-000-3")
    args = _args(x, data, noise, freqs, code, joins)
    work = _kernels.GaussFtWork(*args[1:])
    spec = np.fft.rfft(data)
    w = np.full(spec.shape[1], np.sqrt(2.0 / data.shape[1]))
    w[0] = w[-1] = np.sqrt(1.0 / data.shape[1])
    packed = np.concatenate([spec.real * w, (spec.imag * w)[:, 1:-1]], 1)
    np.testing.assert_allclose(work.dspec.numpy(), packed, rtol=0,
                               atol=1e-14 * np.abs(packed).max())
    for name in ("gauss_ft_normal", "gauss_ft_sse"):
        fn = getattr(_kernels, name)
        got, want = fn(*args, work=work), fn(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not the work's"):
        _kernels.gauss_ft_sse(*args[:9], 0.007, work=work)
    with pytest.raises(ValueError, match="laid out"):
        _kernels.gauss_ft_sse(args[0], args[1][:, :64].contiguous(),
                              *args[2:], work=work)


def test_packing_is_parseval():
    """Two real rows' packed spectra have the rows' dot product, for an
    even and an odd width."""
    rng = np.random.default_rng(1)
    for nbin in (64, 63):
        a, b = rng.normal(size=(2, 3, nbin))
        pa, pb = (_kernels.pack_spectrum(torch.fft.rfft(torch.as_tensor(v)),
                                         nbin) for v in (a, b))
        assert pa.shape == (3, nbin)
        np.testing.assert_allclose(torch.sum(pa * pb, -1).numpy(),
                                   np.sum(a * b, -1), rtol=1e-13)


def test_gauss_ft_takes_bins():
    K = _kernels
    assert [K.gauss_ft_takes_bins(n) for n in (32, 64, 2048, 2000, 8192,
                                               16384)] == \
        [False, True, True, False, True, False]


_CTYPE = {"const void*": _kernels._VP, "void*": _kernels._VP,
          "int64_t": _kernels._I64, "int": _kernels._INT,
          "double": _kernels._DBL}


@pytest.mark.parametrize("name", ["gauss_ft_normal", "gauss_ft_sse",
                                  "gauss_ft_sizes", "gauss_ft_clusters"])
def test_gauss_ft_bindings_match_the_source(name):
    """Each C entry point pp_<name> of csrc/gauss_ft.cu takes, in order,
    the argument types its ctypes bindings declare (the launches' stream
    last)."""
    text = open(_kernels.CSRC_DIR + "/gauss_ft.cu").read()
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
    ("GAUSS_FT_MAX_NGAUSS", "kMaxNgauss"), ("GAUSS_FT_MIN_BINS", "kMinBins"),
    ("GAUSS_FT_MAX_BINS", "kMaxBins"), ("GAUSS_FT_MAX_CLUSTER", "kMaxCluster"),
    ("GAUSS_FT_MAX_BATCHES", "kMaxBatches")])
def test_gauss_ft_constants_match_the_source(python, source):
    """The wrappers' and the route's limits, and the path rule's largest
    cluster and most transform batches a block, are csrc/gauss_ft.cu's."""
    text = open(_kernels.CSRC_DIR + "/gauss_ft.cu").read()
    m = re.search(r"constexpr int %s = (\d+);" % source, text)
    assert m is not None
    assert int(m.group(1)) == getattr(_kernels, python)


def test_gauss_ft_path_constants_match_the_source():
    """gauss_ft_path's shared-memory limit and row budget are
    csrc/gauss_common.cuh's kSmemMax and kRowBudget, and the eight warps
    a block its Gram's splits assume the on-chip kernel's kCThreads
    (csrc/gauss_ft.cu)."""
    common = open(_kernels.CSRC_DIR + "/gauss_common.cuh").read()
    m = re.search(r"constexpr int kSmemMax = (\d+);", common)
    assert m is not None and int(m.group(1)) == _kernels.GAUSS_FT_SMEM_MAX
    m = re.search(r"constexpr int64_t kRowBudget = int64_t\(1\) << (\d+);",
                  common)
    assert m is not None
    assert 1 << int(m.group(1)) == _kernels.GAUSS_FT_ROW_BUDGET
    text = open(_kernels.CSRC_DIR + "/gauss_ft.cu").read()
    assert "constexpr int kCThreads = 256;" in text
    assert "constexpr int kCWarps = kCThreads / 32;" in text


# (ngauss, njoin, nchan, nbin) -> (cluster, batch): the smoke's K10 cases
# ([512, 2048] at one and four components on chip, in clusters of one and
# two blocks; 19 there and over 8192 bins staged), the card tests'
# shapes, and where the staged path stays: past two blocks or three
# transform batches a block, and past the rows of sums' budget
PATH_CASES = [((1, 0, 512, 2048), (1, 3)), ((4, 2, 512, 2048), (2, 3)),
              ((19, 2, 512, 2048), (0, 0)), ((19, 0, 512, 8192), (0, 0)),
              ((1, 0, 128, 1024), (1, 3)), ((2, 2, 64, 512), (1, 6)),
              ((3, 0, 128, 1024), (1, 5)), ((3, 0, 64, 2048), (2, 3)),
              ((21, 2, 32, 512), (2, 11)), ((1, 0, 16, 64), (1, 3)),
              ((2, 0, 64, 4096), (2, 1)), ((8, 0, 32, 1024), (2, 6)),
              ((5, 0, 512, 2048), (0, 0)), ((1, 0, 16, 8192), (0, 0)),
              ((1, 0, 600000, 2048), (0, 0))]


@pytest.mark.parametrize("shape,path", PATH_CASES,
                         ids=lambda v: "x".join(map(str, v)))
def test_gauss_ft_path_rule(shape, path):
    """gauss_ft_path (the Python mirror of csrc/gauss_ft.cu's onchip rule,
    held to the source's own choice on the card) at the smoke's and the
    card tests' shapes."""
    got = _kernels.gauss_ft_path(*shape)
    assert (got["cluster"], got["batch"]) == path


@pytest.mark.parametrize("nbin", [64, 512, 2048, 8192])
def test_gauss_ft_path_rule_takes_the_smallest_cluster(nbin):
    """Over 1 to 60 components: an on-chip choice fits the shared memory
    with a cluster of at most GAUSS_FT_MAX_CLUSTER (and nbin / 8) blocks
    and at most GAUSS_FT_MAX_BATCHES transform batches a block, no smaller
    cluster does, and no fewer batches fit at its size; a staged choice
    fits at no cluster size."""
    K = _kernels

    def batches(ng, cs):   # fewest batches that fit at cs, and their rows
        tb = -(-3 * ng // cs)
        for nb in range(1, min(tb, K.GAUSS_FT_MAX_BATCHES) + 1):
            if K._gauss_ft_onchip_smem(ng, nbin, cs, -(-tb // nb)) <= \
                    K.GAUSS_FT_SMEM_MAX:
                return nb, -(-tb // nb)
        return None

    sizes = [cs for cs in (1, 2, 4, 8, 16)
             if cs <= min(nbin // 8, K.GAUSS_FT_MAX_CLUSTER)]
    for ng in range(1, 61):
        got = K.gauss_ft_path(ng, 2, 64, nbin)
        fits = {cs: batches(ng, cs) for cs in sizes}
        if not got["cluster"]:
            assert all(v is None for v in fits.values()), (ng, fits)
            continue
        cs, T = got["cluster"], got["batch"]
        assert cs in sizes and fits[cs][1] == T
        assert K._gauss_ft_onchip_smem(ng, nbin, cs, T) <= K.GAUSS_FT_SMEM_MAX
        assert all(fits[other] is None for other in sizes if other < cs)


@pytest.mark.parametrize("ngauss", [1, 4, 19])
def test_gauss_ft_slices_partition_the_gram(ngauss):
    """The on-chip kernel's Gram of packed rows: block j of a cluster of cs
    owns the harmonics [j h, j h + h), h = N / 2 cs, and block 0 also N /
    2, holding each row's Re and Im of them (Re k at 2 (k - j h), Im k
    next; the Nyquist Re in block 0's second place); each block sums its
    slice in its eight warps' splits, the splits added in order and then
    the blocks in rank order, the dc row's entries from its one nonzero
    real (sqrt N at harmonic 0, block 0's first).  The slices hold every
    packed real once (k = 0, N/2, the interior's Re and Im) and the sum
    equals the full Gram within 1e-13 of its largest entry, at every
    cluster size."""
    rng = np.random.default_rng(7)
    nbin, n = 256, 128
    q1 = 3 * ngauss + 4
    x = rng.normal(size=(q1 - 1, nbin))
    x[0] += 3.0 * np.cos(np.pi * np.arange(nbin))   # the Nyquist harmonic
    V = np.zeros((q1, nbin))
    V[0, 0] = np.sqrt(nbin)                          # the dc row
    V[1:] = _kernels.pack_spectrum(torch.fft.rfft(torch.as_tensor(x)),
                                   nbin).numpy()
    full = V @ V.T
    nt = (q1 + 15) // 16
    pairs = nt * (nt + 1) // 2
    S = 1 if pairs >= 8 else 8 // pairs
    for cs in (1, 2, 4, 8, 16):
        L, h = nbin // cs, n // cs
        ks = L // 8
        seen = np.zeros(nbin, int)
        tot = None
        for r in range(cs):
            where = np.zeros(L, int)                 # packed real at each place
            for i in range(h):
                k = r * h + i
                where[2 * i] = k
                where[2 * i + 1] = n + k if k else n
            seen[where] += 1
            Z = V[:, where].copy()
            Z[0] = 0.0                               # dc: 0 in the products
            blk = None
            for sp in range(S):
                lo, hi = sp * ks // S * 8, (sp + 1) * ks // S * 8
                part = Z[:, lo:hi] @ Z[:, lo:hi].T
                blk = part if blk is None else blk + part
            tot = blk if tot is None else tot + blk
        assert (seen == 1).all()
        tot[0, :] = np.sqrt(nbin) * V[:, 0]
        tot[:, 0] = tot[0, :]
        tot[0, 0] = np.sqrt(nbin) * np.sqrt(nbin)
        np.testing.assert_allclose(tot, full, rtol=0,
                                   atol=1e-13 * np.abs(full).max())


def test_gauss_ft_source_in_the_build():
    """K10 (csrc/gauss_ft.cu) is a built source: both entry points and
    their traced CUDA functions are in it, each has a plain version and a
    launch count; its library's hash covers the headers it shares with K8
    and K9."""
    assert "gauss_ft.cu" in _kernels.SOURCES
    text = open(_kernels.CSRC_DIR + "/gauss_ft.cu").read()
    for name in ("gauss_ft_normal", "gauss_ft_sse"):
        assert _kernels._lib_of(name) == "gauss_ft"
        assert 'extern "C" int %s(' % _kernels.KERNELS[name][1] in text
        assert "__global__" in text and _kernels.TRACE_NAMES[name] in text
        assert callable(getattr(_kernels, name + "_plain"))
        assert name in _kernels.LAUNCHES
    assert _kernels._source_files("gauss_ft.cu") == [
        "gauss_ft.cu", "fft_block.cuh", "gauss_common.cuh"]
    assert "gauss_common.cuh" in _kernels._source_files("gauss.cu")
    assert "fft_block.cuh" in _kernels._source_files("wavelet.cu")
