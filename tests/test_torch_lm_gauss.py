"""The Gaussian model builder (ppgauss): the port against the JAX package.

lm_solve, the Gaussian profile and portrait fits (joins, a fitted
scattering index), gen_gaussian_portrait and its forward-mode Jacobian,
make_gaussian_model and the ppgauss CLI, all on the CPU (``device="cpu"``,
the plain versions of the kernels) beside the JAX package's functions on
the same numpy inputs.  Pass criteria: fitted parameters within 1e-6 of
their errors (parameters that cannot be identified report an infinite
error in both packages), return codes and nfev equal, the portrait and
its Jacobian within 1e-12 of their largest magnitude, TOAs made with the
two packages' .gmodel files within 1 ns (tests/torch_tim.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pulseportraiture_tpu.cli import ppgauss as jgauss_cli
from pulseportraiture_tpu.cli import pptoas as jtoas_cli
from pulseportraiture_tpu.fit import gauss as jg
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.fit.lm import lm_solve as jlm
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import read_model, write_model
from pulseportraiture_tpu.models.gauss import \
    make_gaussian_model as jmake
from pulseportraiture_tpu.ops import profiles as jprof
from pulseportraiture_tpu_torch.cli import ppgauss as tgauss_cli
from pulseportraiture_tpu_torch.cli import pptoas as ttoas_cli
from pulseportraiture_tpu_torch.fit import gauss as tg
from pulseportraiture_tpu_torch.fit.lm import lm_solve as tlm
from pulseportraiture_tpu_torch.models.gauss import \
    make_gaussian_model as tmake
from pulseportraiture_tpu_torch.ops import profiles as tprof
from torch_tim import assert_same_tim

Z_TOL = 1e-6      # |port - reference| / error of each fitted parameter
PORT_TOL = 1e-12  # portraits and Jacobians, relative to their maximum
MODEL = np.array([0.05, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2])


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
    """The reference's portrait fits (check_convergence, pptoas) add
    variants to the JAX package's jit caches, which
    tests/test_retrace_budget.py holds to a budget in whatever test
    process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


def _z(got, want, errs):
    """Largest |got - want| / err over the parameters with a finite,
    nonzero error; the two packages must agree on which errors are inf."""
    got, want, errs = (np.asarray(a, float) for a in (got, want, errs))
    fin = np.isfinite(errs) & (errs > 0)
    return float(np.max(np.abs(got[fin] - want[fin]) / errs[fin],
                        initial=0.0))


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / np.abs(want).max()


def _profile(true, nbin, sigma, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(jprof.gen_gaussian_profile(true, nbin)) \
        + rng.normal(0.0, sigma, nbin)


# -- lm_solve ---------------------------------------------------------------

def test_lm_solve_batched_matches_reference():
    """Three starts of one scattered-profile problem solved in lockstep,
    bounds active: the second start sits at the tau = 0 bound, where the
    tau column of the Jacobian vanishes (its damping term underflows to
    a float32 zero pivot, the step is rejected, as in the reference).
    Params within 1e-6 of their errors, rc and nfev equal lane by lane,
    the same infinite errors."""
    nbin = 128
    data = _profile([0.0, 4.0, 0.3, 0.05, 1.0], nbin, 0.01, 1)
    x0 = np.array([[0.0, 2.0, 0.30, 0.05, 1.0],
                   [0.0, 0.0, 0.31, 0.06, 0.9],
                   [0.01, 6.0, 0.29, 0.04, 1.1]])
    lo = np.array([-np.inf, 0.0, -np.inf, 0.0, 0.0])
    hi = np.array([np.inf, np.inf, np.inf, 0.25, np.inf])
    dj = jnp.asarray(data)
    dt = torch.as_tensor(data)
    ref = jlm(lambda x: (dj - jprof.gen_gaussian_profile(x, nbin)) / 0.01,
              x0, bounds=(lo, hi))
    got = tlm(lambda x: (dt - tprof.gen_gaussian_profile(x, nbin)) / 0.01,
              torch.as_tensor(x0), bounds=(lo, hi))
    errs = np.asarray(ref.param_errs)
    assert np.isinf(errs[1, 1])
    np.testing.assert_array_equal(np.isinf(got.param_errs.numpy()),
                                  np.isinf(errs))
    assert _z(got.params.numpy(), ref.params, errs) <= Z_TOL
    assert _z(got.param_errs.numpy(), ref.param_errs, errs) <= Z_TOL
    np.testing.assert_array_equal(got.nfev.numpy(), np.asarray(ref.nfev))
    np.testing.assert_array_equal(got.return_code.numpy(),
                                  np.asarray(ref.return_code))
    np.testing.assert_allclose(got.chi2.numpy(), np.asarray(ref.chi2),
                               rtol=1e-10)


# -- the profile and portrait generators ------------------------------------

def _portrait_inputs(tau):
    freqs = np.linspace(1100.0, 1900.0, 12)
    params = np.array([0.02, tau, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2,
                       0.6, 0.02, 0.03, 0.0, 0.5, 0.5])
    joins = [np.arange(0, 5), np.arange(5, 12)]
    jparams = np.array([0.0, 1e-3, 0.013, -2e-3])
    return freqs, params, joins, jparams


@pytest.mark.parametrize("tau", [0.0, 3.0], ids=["tau0", "tau3"])
def test_gen_gaussian_portrait_and_jacobian_match_reference(tau):
    """The portrait with two join groups and its forward-mode Jacobian in
    every parameter, the scattering index included: at the tau = 0 bound
    (the unscattered branch of the where, no NaN from the other) and at
    tau = 3 bins."""
    freqs, params, joins, jparams = _portrait_inputs(tau)
    nbin, P = 128, 0.005
    phases = np.arange(nbin) / nbin
    x = np.concatenate([params, jparams, [-4.0]])
    npar = len(params) + len(jparams)

    def jport(v):
        return jprof.gen_gaussian_portrait("001", v[:npar], v[npar], phases,
                                           freqs, 1500.0, joins, P)

    def tport(v):
        return tprof.gen_gaussian_portrait("001", v[:npar], v[npar], phases,
                                           freqs, 1500.0, joins, P)

    ref = np.asarray(jax.jit(jport)(jnp.asarray(x)))
    got = tport(torch.as_tensor(x)).numpy()
    assert _rel(got, ref) <= PORT_TOL
    jref = np.asarray(jax.jit(jax.jacfwd(jport))(jnp.asarray(x)))
    jgot = torch.func.jacfwd(tport)(torch.as_tensor(x)).numpy()
    assert np.isfinite(jgot).all()
    assert _rel(jgot, jref) <= PORT_TOL
    if tau == 0.0:  # the unscattered branch: tau and alpha do not enter
        assert not jgot[..., 1].any() and not jgot[..., npar].any()


def test_gen_gaussian_profile_matches_reference():
    for tau in (0.0, 5.0):
        p = np.array([0.1, tau, 0.3, 0.04, 1.0, 0.62, 0.1, 0.45, 0.9,
                      0.0, 1.0])
        ref = np.asarray(jprof.gen_gaussian_profile(p, 256))
        assert _rel(tprof.gen_gaussian_profile(p, 256).numpy(), ref) \
            <= PORT_TOL


# -- the Gaussian fits --------------------------------------------------------

@pytest.mark.parametrize("fit_scattering", [False, True],
                         ids=["unscattered", "scattering"])
def test_fit_gaussian_profile_matches_reference(fit_scattering):
    nbin = 128
    true = [0.02, 3.0 if fit_scattering else 0.0, 0.30, 0.04, 1.0, 0.62,
            0.1, 0.45]
    data = _profile(true, nbin, 0.01, 2)
    init = [0.0, 1.0 if fit_scattering else 0.0, 0.31, 0.05, 0.9, 0.6,
            0.08, 0.5]
    ref = jg.fit_gaussian_profile(data, init, 0.01,
                                  fit_scattering=fit_scattering)
    got = tg.fit_gaussian_profile(data, init, 0.01,
                                  fit_scattering=fit_scattering,
                                  device="cpu")
    assert _z(got.fitted_params, ref.fitted_params, ref.fit_errs) <= Z_TOL
    assert _z(got.fit_errs, ref.fit_errs, ref.fit_errs) <= Z_TOL
    np.testing.assert_array_equal(np.isinf(got.fit_errs),
                                  np.isinf(ref.fit_errs))
    assert got.dof == ref.dof
    np.testing.assert_allclose(got.chi2, ref.chi2, rtol=1e-10)


def test_fit_gaussian_portrait_joined_alpha_fitted_matches_reference():
    """A scattered, evolving two-component portrait in two join groups:
    tau, the scattering index and the groups' (phase, DM) pairs fitted
    (the first group's phase frozen).  Params within 1e-6 of their
    errors; nfev and rc equal those of the reference's lm_solve on the
    same residual.  (Single-archive portrait fits run in
    test_make_gaussian_model_matches_reference.)"""
    nbin, P = 128, 0.005
    freqs, params, joins, jparams = _portrait_inputs(3.0)
    phases = np.arange(nbin) / nbin
    model = np.asarray(jprof.gen_gaussian_portrait(
        "001", np.concatenate([params, jparams]), -4.0, phases, freqs,
        1500.0, joins, P))
    rng = np.random.default_rng(4)
    data = model + rng.normal(0.0, 0.01, model.shape)
    errs = np.full(data.shape, 0.01)
    init = params * np.where(np.arange(len(params)) % 2, 1.02, 0.98)
    flags = np.ones(len(params))
    join_params = [joins, np.array([0.0, 0.0, 0.01, 0.0]),
                   np.array([0, 1, 1, 1])]
    args = ("001", data, init, -3.5, errs, flags, True, phases, freqs,
            1500.0, join_params, P)
    ref = jg.fit_gaussian_portrait(*args)
    got = tg.fit_gaussian_portrait(*args, device="cpu")
    assert np.isfinite(ref.scattering_index_err)
    assert _z(got.fitted_params, ref.fitted_params, ref.fit_errs) <= Z_TOL
    assert _z(got.fit_errs, ref.fit_errs, ref.fit_errs) <= Z_TOL
    assert abs(got.scattering_index - ref.scattering_index) <= \
        Z_TOL * ref.scattering_index_err
    np.testing.assert_allclose(got.chi2, ref.chi2, rtol=1e-10)
    # nfev and rc: the JAX function returns neither, so the residual the
    # port fitted is solved again by the reference's lm_solve
    nparam = len(init)
    x0 = np.concatenate([init, [-3.5], join_params[1]])
    xflags = np.concatenate([flags, [1.0], join_params[2]])
    lo = np.full(len(x0), -np.inf)
    hi = np.full(len(x0), np.inf)
    lo[1] = 0.0
    lo[4:nparam:6] = 0.0
    hi[4:nparam:6] = 0.25
    lo[6:nparam:6] = 0.0

    def jres(x):
        mpar = jnp.concatenate([x[:nparam], x[nparam + 1:]])
        return ((jnp.asarray(data) - jprof.gen_gaussian_portrait(
            "001", mpar, x[nparam], phases, freqs, 1500.0, joins, P))
            / 0.01).ravel()

    ref_lm = jlm(jres, x0, fit_flags=xflags, bounds=(lo, hi))
    assert got.nfev == int(ref_lm.nfev)
    assert got.return_code == int(ref_lm.return_code)


# -- the model builder and its CLI -----------------------------------------

@pytest.fixture(scope="module")
def gauss_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_gauss")
    gm = str(tmp / "true.gmodel")
    write_model(gm, "fake", "000", 1500.0, MODEL, np.ones(8, int), -4.0, 0,
                quiet=True)
    par = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "examples", "example.par")
    avg = str(tmp / "avg.fits")
    make_fake_pulsar(gm, par, avg, nsub=1, nchan=16, nbin=128, nu0=1500.0,
                     bw=800.0, tsub=60.0, noise_stds=0.01, dedispersed=True,
                     seed=7, quiet=True)
    arch = str(tmp / "epoch.fits")
    make_fake_pulsar(gm, par, arch, nsub=2, nchan=16, nbin=128, nu0=1500.0,
                     bw=800.0, tsub=60.0, phase=0.1, dDM=8e-4,
                     noise_stds=0.03, dedispersed=False, seed=51,
                     quiet=True)
    return tmp, gm, avg, arch


@pytest.mark.parametrize("mode", ["autogauss", "peak_pick", "improve"])
def test_make_gaussian_model_matches_reference(gauss_setup, mode):
    """niter 1: the profile seed (one --autogauss component, or
    peak-picked), or improve mode from a .gmodel; the fitted model
    params and errors within 1e-6 of the errors, the convergence test's
    verdict equal."""
    _, gm, avg, _ = gauss_setup
    kw = dict(autogauss=dict(auto_gauss=0.05), peak_pick=dict(),
              improve=dict(modelfile=gm))[mode]
    ref = jmake(avg, niter=1, **kw)
    got = tmake(avg, niter=1, device="cpu", **kw)
    errs = ref.model_param_errs
    assert _z(got.model_params, ref.model_params, errs) <= Z_TOL
    assert _z(got.model_param_errs, ref.model_param_errs, errs) <= Z_TOL
    assert got.cnvrgnc == ref.cnvrgnc
    assert _rel(got.model, ref.model) <= 1e-8


def test_ppgauss_cli_gmodel_and_toas_match_reference(gauss_setup):
    """ppgauss --autogauss 0.05 --niter 1 by both packages: the .gmodel
    and _errs numbers within 1e-6 of the errors; pptoas of each package
    with its own .gmodel (written to the same path in turn, which the
    TOA flags name) on a 2-subint archive: TOAs within 1 ns."""
    tmp, _, avg, arch = gauss_setup
    path = str(tmp / "avg.gmodel")
    out, tims = {}, {}
    for name, gcli, tcli, extra in (
            ("ref", jgauss_cli, jtoas_cli, []),
            ("port", tgauss_cli, ttoas_cli, ["--device", "cpu"])):
        assert gcli.main(["-d", avg, "--autogauss", "0.05", "--niter", "1",
                          "-o", path] + extra) == 0
        out[name] = (read_model(path), read_model(path + "_errs"))
        tims[name] = str(tmp / (name + ".tim"))
        assert tcli.main(["-d", arch, "-m", path, "--print_phase",
                          "--quiet", "-o", tims[name]] + extra) == 0
    (rm, re), (pm, pe) = out["ref"], out["port"]
    assert pm[:4] == rm[:4]        # name, code, nu_ref, ngauss
    errs = re[4]
    assert _z(pm[4], rm[4], errs) <= Z_TOL
    assert _z(pe[4], re[4], errs) <= Z_TOL
    np.testing.assert_array_equal(pm[5], rm[5])
    assert_same_tim(tims["port"], tims["ref"], 2)


def test_ppgauss_cli_refuses_unported_options(gauss_setup, capsys):
    """--interactive and --figure, refused until the plots were ported:
    on a headless backend --interactive exits 1 with the JAX CLI's
    message, and --figure saves the final fit's figure."""
    import matplotlib

    matplotlib.use("Agg")
    tmp, _, avg, _ = gauss_setup
    out = str(tmp / "cli_flags.gmodel")
    assert tgauss_cli.main(["-d", avg, "-o", out, "--interactive",
                            "--device", "cpu"]) == 1
    assert "headless" in capsys.readouterr().err
    assert not os.path.exists(out)
    png = str(tmp / "cli_flags.png")
    assert tgauss_cli.main(["-d", avg, "-o", out, "--autogauss", "0.05",
                            "--figure", png, "--device", "cpu"]) == 0
    assert os.path.getsize(png) > 1000
