"""The port's per-channel and template paths, its template builders and
its sharded fit on the card: kernels against their plain versions.

Each test runs a path of pulseportraiture_tpu_torch on the CUDA device
twice — through the hand kernels (K1 csrc/moments.cu and K3
csrc/moments_scat.cu, both epilogues of each, K2 csrc/fftfit.cu, K4
csrc/spectra.cu, both epilogues), then
with their plain PyTorch versions swapped in on the same device — and
holds the two runs
to the port's parity bar: TOAs within 1 ns, equal rc and nfeval, equal
zap lists, fluxes within 1e-9 relative (1e-7 with the narrowband
scattering fits, whose scales move with the ~1e-8 differences in tau of
fits the data barely constrain, as between the port and the JAX
package), post-fit channel reduced chi2 within 2e-9 relative (each moves
to first order with the fitted phase, DM and scales, which converged
fits leave ~1e-11 apart);
K3 alone at one channel per lane within 1e-12 of each sum's largest
magnitude; K4 alone with its cross and |m|^2 bit-equal and each row's
sums within 1e-13 relative, its wrappers refusing bad arguments and never
falling back; the template-building paths (align, spline, Gaussian) with aligned
portraits within 5e-8 of their peak and weights within 1e-9 (the bound
of the CPU parity tests against the JAX package: the (phase, DM) fits
stop at the f64 floor of their objective, ~1e-9 rot apart, and a subint
rotated that much differently moves the portrait by ~1e-8 of its peak;
read on the card: 1.5e-9), spline models within 1e-10 and Gaussian model
parameters within 1e-6 of their errors.  The load's kernels (K5
csrc/unpack.cu, K6 csrc/loadstats.cu, K7 csrc/rotate.cu) against their
plain versions: the decode bit-equal, the baseline within 1e-12 of each
row's range (rows above shared memory's reach included), noise 1e-13 and
S/N 1e-12 relative, the phasor pass 1e-13 of each row's largest
harmonic, its weighted sum 1e-12 and the same bits twice; load_data on
the card against the plain versions on the card and against the CPU.
The smoothing search (K8 csrc/wavelet.cu) against its plain version:
the same (level, factor) on every row and each smooth within 1e-10 of
its row's peak, at eight shapes (a width its scan does not take among
them), in chunks, never falling back; its scan against the scan's plain
version (S/N and chi2 within 1e-12 relative, the repeat flags equal);
cuFFT's rows equal whatever their batch.  The Gaussian portrait fit's
normal equations (K9 csrc/gauss.cu) against their plain version: f, g
and J^T J within 1e-12 of their largest magnitude lane by lane at 1 to
24 components (both layouts) and 1 to 3 lanes, the same bits twice and
under CUDA-graph replay, the NaN of an amplitude at its 0 bound, 757
components and a fit there; ppgauss on the card against the CPU (model
parameters within max(1e-6, 4 sqrt(eps chi2)) of their errors: float64
chi2's floor, where K9's and its plain version's LM runs stop apart).

Readings on an H100 80GB HBM3 (700 W), kernels against plain: the
scattering fluxes 1.48e-8 (log10 tau) and 2.03e-8 (linear tau), the
template fluxes <= 9.5e-15, the reduced chi2 2.48e-10, the same in two
runs.  With the phasors of K1 and K3 taken in single precision (a wrong
kernel) they read 3.7e-5 and 3.2e-5, 7.7e-9 and 2.44e-7, and the
narrowband rc and nfeval differ; the zap lists stay equal, so only the
chi2 bound catches that fault on the zap path.  The archives are written by the port's
make_fake_pulsar.  The "fit" noise estimators and make_fake_dataset
are held to the port on the CPU: cutoffs equal, noise within 1e-12
relative, synthetic portraits within 1e-12 of their peak.  The "fit" noise
estimator's kernel (K11 csrc/noisefit.cu) against its plain version on the
card: cutoffs equal (a mismatch counted as a tie only within the chi2
rounding bound of chip_smoke.k11_ties, none expected), noise within 1e-12
relative, at a grid wider than 20 points and at rows wider than shared
memory too, each estimator and load_data launching it; the
synthetic-data writer (K12 csrc/synth.cu) against its plain version on the
same noise: every row within 1e-13 of its peak on both its paths (onchip,
and cufft at the other widths), make_fake_dataset and make_fake_portrait
launching it a block and counting its path, the same noise draws as the
plain version's.  Marked
``cuda``: they skip without a card.  This file
imports no JAX, so it runs on a machine without it:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_paths.py
"""

import contextlib
import math
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GMODEL = os.path.join(ROOT, "examples", "example.gmodel")
PAR = os.path.join(ROOT, "examples", "example.par")

pytestmark = pytest.mark.cuda
DEVICE = "cuda"


def _chip_smoke():
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pulseportraiture_tpu_torch import _kernels

    return _kernels


@contextlib.contextmanager
def plain_kernels(K):
    """The plain versions in place of the kernels, on the card."""
    saved = {name: getattr(K, name) for name in K.KERNELS}
    for name in K.KERNELS:
        setattr(K, name, getattr(K, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


@pytest.fixture(scope="module")
def archive(card, tmp_path_factory):
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar

    tmp = tmp_path_factory.mktemp("cuda_paths")
    w = np.ones((4, 64))
    w[:, 11] = 0.0
    w[2] = 0.0
    w[2, 17] = 1.0
    out = str(tmp / "d.fits")
    make_fake_pulsar(GMODEL, PAR, out, nsub=4, nchan=64, nbin=512,
                     tsub=60.0, phase=0.123, dDM=2e-3, weights=w,
                     noise_stds=0.05, seed=5, quiet=True)
    return tmp, out


def spline_model_from_gmodel(path, nchan=64, nbin=512, neig=3):
    """A spline model of examples/example.gmodel: its portrait over the
    band, an SVD to ``neig`` eigenprofiles, their coordinates fit by
    scipy's splprep, written by the port's write_spline_model."""
    from scipy.interpolate import splprep

    from pulseportraiture_tpu_torch.io.gmodel import read_model
    from pulseportraiture_tpu_torch.io.splmodel import write_spline_model
    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers

    freqs = np.linspace(1050.0, 1950.0, nchan)
    _, _, port = read_model(GMODEL, get_bin_centers(nbin).numpy(), freqs,
                            0.00289, quiet=True)
    port = port.numpy()
    mean_prof = port.mean(axis=0)
    _, _, vt = np.linalg.svd(port - mean_prof, full_matrices=False)
    eigvec = vt[:neig].T                                   # [nbin, neig]
    proj = (port - mean_prof) @ eigvec                     # [nchan, neig]
    tck, _ = splprep(proj.T, u=freqs, k=3, s=0.0)
    write_spline_model(path, "example", "J0000+0000", GMODEL, mean_prof,
                       eigvec, tck)
    return path


def _toas(gt):
    return [(t.MJD.day, t.MJD.secs, t.frequency) for t in gt.TOA_list]


def _max_dt_ns(a, b):
    assert len(a) == len(b)
    return max(abs((x[0] - y[0]) * 86400.0 + x[1] - y[1]) * 1e9
               for x, y in zip(a, b))


def _run(K, model, method, archive, ird=None, **kw):
    """GetTOAs ``method`` on the card with the kernels, then with the
    plain versions: (kernel run, plain run, launches of the kernel run)."""
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    runs = []
    for plain in (False, True):
        gt = GetTOAs(archive, model, quiet=True, device=DEVICE)
        gt.ird.update(ird or {})
        K.reset_launches()
        with plain_kernels(K) if plain else contextlib.nullcontext():
            getattr(gt, method)(**kw)
        runs.append((gt, dict(K.LAUNCHES)))
    return runs[0][0], runs[1][0], runs[0][1]


@pytest.mark.parametrize("kw", [dict(), dict(fit_scat=True),
                                dict(fit_scat=True, log10_tau=False)],
                         ids=["phase", "scat", "scat_linear"])
def test_narrowband_kernels_match_plain(card, archive, kw):
    _, arch = archive
    kern, plain, launches = _run(card, GMODEL, "get_narrowband_TOAs",
                                 archive=arch, print_flux=True, **kw)
    assert launches["fftfit"] >= 1
    if kw:
        assert launches["moments_scat"] >= 1
        assert launches["moments_scat_grad_hess"] >= 1
    assert len(kern.TOA_list) == 3 * 63 + 1
    assert _max_dt_ns(_toas(kern), _toas(plain)) < 1.0
    np.testing.assert_array_equal(kern.rcs[0], plain.rcs[0])
    np.testing.assert_array_equal(kern.nfevals[0], plain.nfevals[0])
    f, g = kern.profile_fluxes[0], plain.profile_fluxes[0]
    rtol = 1e-7 if kw else 1e-9
    assert np.abs(f - g).max() <= rtol * np.abs(g).max()


@pytest.mark.parametrize("template", ["spline", "fits"])
def test_templates_flux_and_response_kernels_match_plain(card, archive,
                                                         template):
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar

    tmp, arch = archive
    if template == "spline":
        model = spline_model_from_gmodel(str(tmp / "m.spl"))
    else:
        model = make_fake_pulsar(GMODEL, PAR, str(tmp / "t.fits"), nsub=1,
                                 nchan=64, nbin=512, tsub=60.0,
                                 noise_stds=0.0, seed=0, quiet=True)
    kern, plain, launches = _run(
        card, model, "get_TOAs", archive=arch, bary=False, print_flux=True,
        add_instrumental_response=True,
        ird=dict(DM=1.0, wids=[0.002], irf_types=["rect"]))
    assert launches["moments"] >= 1 and launches["fftfit"] >= 1
    assert len(kern.TOA_list) == 4
    assert _max_dt_ns(_toas(kern), _toas(plain)) < 1.0
    for key in ("fluxes", "flux_errs", "flux_freqs"):
        a, b = getattr(kern, key)[0], getattr(plain, key)[0]
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max(), key


def test_channels_to_zap_kernels_match_plain(card, archive):
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    _, arch = archive
    zaps, chi2s = [], []
    for plain in (False, True):
        gt = GetTOAs(arch, GMODEL, quiet=True, device=DEVICE)
        with plain_kernels(card) if plain else contextlib.nullcontext():
            gt.get_TOAs(quiet=True)
            zaps.append(gt.get_channels_to_zap())
        chi2s.append([c for s in gt.channel_red_chi2s[0] for c in s])
    assert zaps[0] == zaps[1]
    np.testing.assert_allclose(chi2s[0], chi2s[1], rtol=2e-9)


def test_moments_scat_one_channel_per_lane(card):
    """K3 at nchan = 1 with a separate |m|^2 per lane and a lane subset:
    the narrowband fit_scat shape."""
    K = card
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, K_ = 3000, 129

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda",
                          dtype=torch.float64)

    cross = torch.complex(rand(n, 1, K_) - 0.5, rand(n, 1, K_) - 0.5)
    abs_m2 = rand(n, 1, K_)
    inv_err2 = rand(n, 1) + 0.5
    for lanes in (None, torch.sort(torch.randperm(
            n, generator=gen, device="cuda")[:777]).values):
        m = n if lanes is None else len(lanes)
        shifts = (rand(m, 1) - 0.5) * 100.0
        taus = rand(m, 1) * 0.02
        got = K.moments_scat(cross, abs_m2, shifts, taus, inv_err2, lanes)
        want = K.moments_scat_plain(cross, abs_m2, shifts, taus, inv_err2,
                                    lanes)
        err = (got - want).abs().amax(dim=(0, 1)) / \
            want.abs().amax(dim=(0, 1)).clamp_min(1e-300)
        assert float(err.max()) <= 1e-12, err


# K1 cases: (subints, channels, harmonics, rows evaluated: a lane subset of
# that many subints, or all when None)
K1_CASES = [
    (6, 7, 37, None),      # K not a multiple of the 16 lanes of a row
    (5, 3, 1, None),       # K = 1
    (300, 1, 128, 77),     # one channel per subint, lanes
    (1, 511, 128, None),   # one subint: an odd row count
    (9, 512, 128, None),
    (64, 512, 128, 40),    # pptoas chunks: lanes
]


@pytest.mark.parametrize("case", K1_CASES, ids=lambda c: "x".join(
    map(str, c[:3])) + ("" if c[3] is None else "-lanes%d" % c[3]))
def test_moments_kernels_match_plain_on_the_card(card, case):
    """K1's two epilogues against their plain versions on the card: each
    sum within 1e-12 and each of epilogue B's ten columns within 1e-10 of
    its largest magnitude (B divides by C and S; chip_smoke.py K1_GH_TOL),
    and a zapped channel's rows zero."""
    K = card
    B, nchan, Kh, nlanes = case
    gen = torch.Generator(device="cuda").manual_seed(B * 100 + nchan + Kh)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device="cuda",
                          dtype=torch.float64)

    cross = torch.complex(rand(B, nchan, Kh) - 0.5, rand(B, nchan, Kh) - 0.5)
    inv_err2 = rand(B, nchan) + 0.5
    inv_err2[0, -1] = 0.0
    S = (rand(B, nchan) + 0.1) * inv_err2
    lanes = None if nlanes is None else torch.sort(torch.randperm(
        B, generator=gen, device="cuda")[:nlanes]).values
    n = B if lanes is None else nlanes
    shifts = (rand(n, nchan) - 0.5) * 4000.0
    pd = torch.stack([torch.ones((n, nchan), dtype=torch.float64,
                                 device="cuda"), (rand(n, nchan) - 0.5) * 0.4,
                      (rand(n, nchan) - 0.5) * 2e-3], dim=1).contiguous()
    for name, args, tol in (
            ("moments", (cross, shifts, inv_err2, lanes), 1e-12),
            ("moments_grad_hess", (cross, shifts, pd, S, inv_err2, lanes),
             1e-10)):
        got = getattr(K, name)(*args)
        want = getattr(K, name + "_plain")(*args)
        axes = (0, 1) if name == "moments" else (0, 2)
        err = (got - want).abs().amax(dim=axes) / \
            want.abs().amax(dim=axes).clamp_min(1e-300)
        assert float(err.max()) <= tol, (name, err)
        if lanes is None:
            zapped = got[0, -1] if name == "moments" else got[0, :, -1]
            assert bool((zapped == 0.0).all()), name


def test_no_scattering_fit_kernel_equals_plain_on_the_card(card):
    """A (phi, DM) fit of 48 subints of 64 x 512 on the card through K1's
    epilogue B, then through the plain versions: TOAs within 1 ns, rc and
    nfeval equal; and its solver went through epilogue B, one launch per
    evaluation."""
    from pulseportraiture_tpu_torch.fit.portrait import \
        fit_portrait_full_batch
    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait
    from pulseportraiture_tpu_torch.pipelines.synth import make_fake_dataset

    mp = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    ds = make_fake_dataset(gen, mp, nsub=48, nchan=64, nbin=512,
                           lofreq=1300.0, bw=400.0, P=0.005, noise_std=0.05,
                           device=DEVICE)
    model = gen_gaussian_portrait("000", mp, -4.0, get_bin_centers(512),
                                  ds.freqs, ds.nu_ref, device=DEVICE)

    def fit():
        return fit_portrait_full_batch(
            ds.subints, model, None, 0.005, ds.freqs,
            fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30,
            device=DEVICE)

    card.reset_launches()
    got = fit()
    assert card.LAUNCHES["moments_grad_hess"] >= 2
    with plain_kernels(card):
        want = fit()
    dphi = ((want.phi - got.phi + 0.5) % 1.0 - 0.5).abs().max()
    assert float(dphi) * 0.005 < 1e-9
    assert torch.equal(want.return_code, got.return_code)
    assert torch.equal(want.nfeval, got.nfeval)


@pytest.fixture(scope="module")
def epochs(card, tmp_path_factory):
    """Two 4-subint x 64-channel x 512-bin epochs with their own phase and
    DM offsets, and a noiseless one-subint template."""
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar

    tmp = tmp_path_factory.mktemp("cuda_builders")
    files = [make_fake_pulsar(GMODEL, PAR, str(tmp / ("e%d.fits" % i)),
                              nsub=4, nchan=64, nbin=512, tsub=60.0,
                              phase=ph, dDM=dDM, noise_stds=0.1, seed=20 + i,
                              quiet=True)
             for i, (ph, dDM) in enumerate(((0.12, 1e-3), (-0.21, -2e-3)))]
    tmpl = make_fake_pulsar(GMODEL, PAR, str(tmp / "tmpl.fits"), nsub=1,
                            nchan=64, nbin=512, tsub=60.0, noise_stds=0.0,
                            dedispersed=True, seed=0, quiet=True)
    return tmp, files, tmpl


def test_template_builders_kernels_match_plain(card, epochs):
    """align_archives (niter 2), then from one aligned archive
    make_spline_model (-N prof: K2) and make_gaussian_model (--autogauss,
    niter 1: K2 seeds, K1 convergence test) on the card, through the
    kernels and then the plain versions: aligned portraits within 5e-8 of
    their peak and weights within 1e-9 (the fits' floor, as in
    tests/test_torch_align.py), spline model portraits within 1e-10,
    Gaussian model parameters within 1e-6 of their errors."""
    from pulseportraiture_tpu_torch.dataportrait import DataPortrait
    from pulseportraiture_tpu_torch.models.gauss import make_gaussian_model
    from pulseportraiture_tpu_torch.models.spline import make_spline_model
    from pulseportraiture_tpu_torch.pipelines.align import align_archives

    K = card
    tmp, files, tmpl = epochs
    aligned, spline, gauss = [], [], []
    for plain in (False, True):
        K.reset_launches()
        with plain_kernels(K) if plain else contextlib.nullcontext():
            out = str(tmp / ("aligned%d.fits" % plain))
            aligned.append(align_archives(files, tmpl, niter=2, outfile=out,
                                          device=DEVICE)[1:])
            if not plain:
                launches = dict(K.LAUNCHES)
            source = str(tmp / "aligned0.fits")   # both builders: one input
            dp = DataPortrait(source, quiet=True, device=DEVICE)
            dp.normalize_portrait("prof")
            spline.append(make_spline_model(dp, max_ncomp=4, smooth=True,
                                            snr_cutoff=50.0).model)
            gauss.append(make_gaussian_model(source, auto_gauss=0.05,
                                             niter=1, device=DEVICE))
    (pk, wk), (pp, wp) = aligned
    assert launches["moments"] > 0 and launches["fftfit"] > 0
    assert np.isfinite(pk).all() and np.isfinite(gauss[0].model_params).all()
    assert np.abs(pk - pp).max() <= 5e-8 * np.abs(pp).max()
    assert np.abs(wk - wp).max() <= 1e-9 * np.abs(wp).max()
    assert np.abs(spline[0] - spline[1]).max() <= \
        1e-10 * np.abs(spline[1]).max()
    errs = gauss[1].model_param_errs
    fin = np.isfinite(errs) & (errs > 0)
    assert np.all(np.abs(gauss[0].model_params - gauss[1].model_params)[fin]
                  <= 1e-6 * errs[fin])


def test_joined_gaussian_portrait_fit_card_matches_cpu(card):
    """ppgauss's fit of a portrait in two join groups (their phase and
    DM fitted under torch.func's vmap and jacfwd, the model's rotation
    the differentiable phasor product, not K7) on the card against the
    CPU: parameters within 1e-6 of their errors, errors within 1e-6
    relative, chi2 within 1e-9 relative, rc equal (nfev is not held:
    the stop test on chi2's relative change meets the card's and the
    CPU's FFT rounding, 17 against 19 evaluations on an H100)."""
    from pulseportraiture_tpu_torch.fit.gauss import fit_gaussian_portrait
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    nbin, P = 128, 0.005
    freqs = np.linspace(1100.0, 1900.0, 12)
    params = np.array([0.02, 3.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2,
                       0.6, 0.02, 0.03, 0.0, 0.5, 0.5])
    joins = [np.arange(0, 5), np.arange(5, 12)]
    phases = np.arange(nbin) / nbin
    model = gen_gaussian_portrait(
        "001", np.concatenate([params, [0.0, 1e-3, 0.013, -2e-3]]), -4.0,
        phases, freqs, 1500.0, joins, P).numpy()
    rng = np.random.default_rng(4)
    data = model + rng.normal(0.0, 0.01, model.shape)
    init = params * np.where(np.arange(len(params)) % 2, 1.02, 0.98)
    args = ("001", data, init, -3.5, np.full(data.shape, 0.01),
            np.ones(len(params)), True, phases, freqs, 1500.0,
            [joins, np.array([0.0, 0.0, 0.01, 0.0]), np.array([0, 1, 1, 1])],
            P)
    got = fit_gaussian_portrait(*args, device=DEVICE)
    want = fit_gaussian_portrait(*args, device="cpu")
    errs = np.asarray(want.fit_errs)
    fin = np.isfinite(errs) & (errs > 0)
    assert fin.sum() > len(params)
    assert np.all(np.abs(np.asarray(got.fitted_params)
                         - np.asarray(want.fitted_params))[fin]
                  <= 1e-6 * errs[fin])
    assert np.all(np.abs(np.asarray(got.fit_errs) - errs)[fin]
                  <= 1e-6 * errs[fin])
    assert abs(got.chi2 - want.chi2) <= 1e-9 * want.chi2
    assert got.return_code == want.return_code


def _noise_profiles(nbin=2048, n=300, seed=8):
    """Pulses of random height and width on white noise, white noise
    alone, and three all-zero channels."""
    rng = np.random.default_rng(seed)
    ph = (np.arange(nbin) + 0.5) / nbin
    x = rng.standard_normal((n, nbin))
    x[:200] += rng.uniform(1.0, 50.0, (200, 1)) * np.exp(
        -0.5 * ((ph - 0.4) / rng.uniform(0.002, 0.05, (200, 1))) ** 2)
    x[[3, 150, n - 1]] = 0.0
    return torch.as_tensor(x)


@pytest.mark.parametrize("fn", ["exp_dc", "half_tri"])
def test_noise_fit_card_matches_cpu(card, fn):
    """find_kc, get_noise_fit and the brickwall cutoffs on the card
    against the CPU on the same profiles: cutoffs equal (the first-index
    choice on ties holds on both devices), noise within 1e-12 relative,
    zeroed channels 0 on both."""
    from pulseportraiture_tpu_torch.ops import noise

    host = _noise_profiles()
    dev = host.to(DEVICE)
    assert torch.equal(noise.find_kc(noise._power(dev)[1], fn=fn).cpu(),
                       noise.find_kc(noise._power(host)[1], fn=fn))
    n_h = noise.get_noise_fit(host, fn=fn)
    n_d = noise.get_noise_fit(dev, fn=fn).cpu()
    assert torch.equal(n_h == 0, n_d == 0) and int((n_h == 0).sum()) == 3
    ok = n_h != 0
    assert float(((n_d - n_h).abs()[ok] / n_h[ok]).max()) <= 1e-12
    ps = noise.get_noise(host)[:, None]
    assert torch.equal(noise.fit_brickwall(dev, ps.to(DEVICE)).cpu(),
                       noise.fit_brickwall(host, ps))


def test_make_fake_dataset_card_matches_cpu(card, monkeypatch):
    """make_fake_dataset on the card against the CPU: noiseless, with
    explicit phases and dDMs, scattering and drawn scintillation (one
    numpy seed on both devices), in blocks of 3 subints — within 1e-12 of
    the peak; with noise, reproducible from the seed, of the asked
    standard deviation."""
    from pulseportraiture_tpu_torch.pipelines import synth

    monkeypatch.setattr(synth, "BLOCK_BYTES", 3 * 128 * 1024 * 8)
    rng = np.random.default_rng(2)
    kw = dict(nsub=8, nchan=128, nbin=1024, P=0.004, t_scat=1e-4,
              phases=rng.uniform(-0.4, 0.4, 8), dDMs=rng.normal(0, 1e-3, 8),
              scint=True, noise_std=0.0)
    MODEL = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
    host = synth.make_fake_dataset(torch.Generator().manual_seed(5), MODEL,
                                   device="cpu", **kw)
    dev = synth.make_fake_dataset(
        torch.Generator(device=DEVICE).manual_seed(5), MODEL, device=DEVICE,
        **kw)
    want = host.subints
    assert float((dev.subints.cpu() - want).abs().max()) <= \
        1e-12 * float(want.abs().max())
    clean, a, b = (synth.make_fake_dataset(
        torch.Generator(device=DEVICE).manual_seed(6), MODEL, device=DEVICE,
        **dict(kw, noise_std=sd)).subints for sd in (0.0, 0.3, 0.3))
    assert torch.equal(a, b)
    assert abs(float((a - clean).std()) - 0.3) < 0.01


def _survey(K, archives, wd, plain=False, **kw):
    """run_survey of the port on the card over ``archives``; the
    checkpoint's TOA lines and the kernels' launches."""
    from pulseportraiture_tpu_torch.runner.execute import run_survey
    from pulseportraiture_tpu_torch.runner.plan import plan_survey

    K.reset_launches()
    with plain_kernels(K) if plain else contextlib.nullcontext():
        s = run_survey(plan_survey(archives, modelfile=GMODEL), wd,
                       process_index=0, process_count=1, bary=False,
                       device=DEVICE, **kw)
    assert s["counts"]["done"] == len(archives)
    toas = [ln.split() for ln in open(s["checkpoint"])
            if ln.split() and ln.split()[0] not in ("FORMAT", "C")]
    return toas, dict(K.LAUNCHES)


def _tim_dt_ns(a, b):
    assert len(a) == len(b)
    out = 0.0
    for x, y in zip(a, b):
        assert x[0] == y[0]
        dx, fx = x[2].split(".")
        dy, fy = y[2].split(".")
        out = max(out, abs((int(dx) - int(dy)) + float("0." + fx)
                           - float("0." + fy)) * 86400e9)
    return out


@pytest.mark.parametrize("kw", [dict(), dict(fit_scat=True)],
                         ids=["phase", "scat"])
def test_survey_archive_goes_through_kernels(card, archive, tmp_path, kw):
    """A CUDA-tensor survey archive (run_survey, device cuda) launches K2
    and K1 (K3 with fit_scat) — no plain fallback on the card — and its
    TOAs equal those of the plain versions within 1 ns."""
    _, path = archive
    got, launches = _survey(card, [path], str(tmp_path / "k"), **kw)
    assert launches["fftfit"] > 0
    assert launches["moments_scat" if kw else "moments"] > 0
    ref, plain_launches = _survey(card, [path], str(tmp_path / "p"),
                                  plain=True, **kw)
    assert sum(plain_launches.values()) == 0
    assert _tim_dt_ns(got, ref) < 1.0


def _serve(K, archives, wd, plain=False, **kw):
    """The port's TOAService on the card, four requests from two tenants
    in one cycle: {archive: TOA line tokens}, the launches, the batched
    fits' argument devices and the microbatch_dispatch sizes."""
    import json as _json
    import shutil

    from pulseportraiture_tpu_torch import obs
    from pulseportraiture_tpu_torch.service import TOAService

    seen = []
    K.build()           # before the cycle: an nvcc run would outlast it
    K.reset_launches()
    svc = TOAService(GMODEL, wd, batch_window_s=30.0, batch_max=4,
                     backoff_s=0.0, get_toas_kw=dict(bary=False, **kw),
                     device=DEVICE).start()
    run_dir = obs.current().dir
    try:
        # each request's own copy: the ledger would replay a known one
        paths = []
        for i, src in enumerate(archives):
            paths.append(os.path.join(wd, "req%d.fits" % i))
            shutil.copyfile(src, paths[-1])
        bucket = svc._bucket((64, 512))
        fit = bucket.batcher._resolve_fit()

        def spy(*a, **k):
            seen.append([x.device.type for x in a[:2]] + [
                k[n].device.type for n in ("errs", "weights", "nu_fits")])
            return fit(*a, **k)

        bucket.batcher._fit = spy
        with plain_kernels(K) if plain else contextlib.nullcontext():
            ids = [svc.submit(("alice", "bob")[i % 2], p)["request_id"]
                   for i, p in enumerate(paths)]
            res = [svc.wait(r, timeout=600) for r in ids]
    finally:
        assert svc.shutdown(timeout=300)
    assert [r["state"] for r in res] == ["done"] * len(paths), res
    # keyed and named by the copy's file name (the runs' directories
    # differ)
    toas = {os.path.basename(r["archive"]): [
        [os.path.basename(r["archive"])] + ln.split()[1:]
        for ln in r["toa_lines"]] for r in res}
    sizes = [e["n_requests"] for e in map(
        _json.loads, open(os.path.join(run_dir, "events.jsonl")))
        if e.get("name") == "microbatch_dispatch"]
    return toas, dict(K.LAUNCHES), seen, sizes


@pytest.mark.parametrize("kw", [dict(), dict(fit_scat=True)],
                         ids=["phase", "scat"])
def test_service_coalesced_dispatch_on_the_card(card, archive, tmp_path,
                                                kw):
    """Four requests of one bucket from two tenants share each batched
    fit on the card (one per fit-flag group: the archive's subint 2 has
    one live channel): the joined data, models, errs, weights and nu
    columns reach it as CUDA tensors, K2 runs per request and K1 (K3
    with fit_scat) in the combined fits, and every request's TOAs equal
    the plain versions' within 1 ns."""
    _, path = archive
    got, launches, seen, sizes = _serve(card, [path] * 4,
                                        str(tmp_path / "k"), **kw)
    assert sizes == [4, 4] and len(seen) == 2
    assert all(s == ["cuda"] * 5 for s in seen)
    assert launches["fftfit"] >= 4
    assert launches["moments_scat" if kw else "moments"] > 0
    ref, plain_launches, _, _ = _serve(card, [path] * 4,
                                       str(tmp_path / "p"), plain=True,
                                       **kw)
    assert sum(plain_launches.values()) == 0
    for name in got:
        assert _tim_dt_ns(got[name], ref[name]) < 1.0


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 4, 1)],
                         ids=["2x2x2", "1x4x1"])
def test_sharded_fit_on_the_card(card, shape):
    """A given-init fit of 64 subints of 128 x 512 (make_fake_dataset on
    the card) sharded over a mesh of the card named eight (four) times:
    its TOAs (phi, DM and their reference frequency), rc and nfeval equal
    the unsharded kernel fit's, K1 (both epilogues) launched once per
    channel shard and evaluation; the same sharded fit through the plain versions
    within 1 ns."""
    from pulseportraiture_tpu_torch.fit.portrait import \
        fit_portrait_full_batch
    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait
    from pulseportraiture_tpu_torch.parallel.mesh import make_mesh
    from pulseportraiture_tpu_torch.pipelines.synth import make_fake_dataset

    mp = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    ds = make_fake_dataset(gen, mp, nsub=64, nchan=128, nbin=512,
                           lofreq=1300.0, bw=400.0, P=0.005, noise_std=0.05,
                           device=DEVICE)
    model = gen_gaussian_portrait("000", mp, -4.0, get_bin_centers(512),
                                  ds.freqs, ds.nu_ref, device=DEVICE)
    init = torch.zeros((64, 5), dtype=torch.float64, device=DEVICE)
    init[:, 0] = ds.phases_inj
    mesh = make_mesh(*shape, devices=[DEVICE] * 8 if shape[0] > 1
                     else [DEVICE] * 4)

    def fit(m):
        return fit_portrait_full_batch(
            ds.subints, model, init, 0.005, ds.freqs, fit_flags=(1, 1, 0,
                                                                 0, 0),
            log10_tau=False, max_iter=30, mesh=m, device=DEVICE)

    want = fit(None)
    card.reset_launches()
    got = fit(mesh)
    for name in ("moments", "moments_grad_hess"):
        assert card.LAUNCHES[name] % shape[1] == 0
        assert card.LAUNCHES[name] > 0
    for key in ("phi", "DM", "nu_DM", "nfeval", "return_code"):
        assert torch.equal(got[key], want[key]), key
    with plain_kernels(card):
        plain = fit(mesh)
    dphi = ((plain.phi - got.phi + 0.5) % 1.0 - 0.5).abs().max()
    assert float(dphi) * 0.005 < 1e-9
    assert torch.equal(plain.return_code, got.return_code)


def test_viz_figure_numbers_card_match_cpu(card, archive):
    """The figures' numbers (viz.figdata) from a GetTOAs run on the card
    against the same run on the CPU: every fitted subint within 1e-8 of
    its largest magnitude (the rotated data move to first order with the
    fitted phase, which converged fits leave ~1e-11 rot apart, times the
    steepest harmonic, 2 pi nbin / 2: 1.6e-8; read 2.1e-9 on the H100), the
    channel reduced chi2s within 2e-9 relative (the post-fit bound
    above), the stacked-profile FFTFIT of one subint's fitted channels in
    one K2 launch, its phases within 1e-9 rot of the CPU's and of the
    plain version's on the card; ppzap --hist's numbers alike.  No
    matplotlib is needed."""
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
    from pulseportraiture_tpu_torch.viz import figdata

    _, arch = archive
    runs = {}
    for dev in (DEVICE, "cpu"):
        gt = GetTOAs(arch, GMODEL, quiet=True, device=dev)
        gt.get_TOAs(quiet=True, show_plot=True)
        gt.get_channels_to_zap()
        runs[dev] = gt
    for isub in runs["cpu"].ok_isubs[0]:
        got, want = (figdata.fitted_subint(runs[d], 0, isub)
                     for d in (DEVICE, "cpu"))
        assert got.port.device.type == torch.device(DEVICE).type
        for key in ("port", "model"):
            g, w = got[key].cpu(), want[key]
            assert float((g - w).abs().max()) <= 1e-8 * float(
                w.abs().max()), key
        pays = [figdata.residual_payload(f.port, f.model, f.noise_stds,
                                         runs["cpu"].nfit)
                for f in (got, want)]
        assert torch.equal(pays[0].live.cpu(), pays[1].live)
        np.testing.assert_allclose(pays[0].rchi2.cpu().numpy(),
                                   pays[1].rchi2.numpy(), rtol=2e-9)
    f = figdata.fitted_subint(runs[DEVICE], 0, 0)
    ok = list(f.ok_ichans)
    card.reset_launches()
    fits = figdata.stacked_fits(f.port[ok], f.model[ok])
    assert card.LAUNCHES["fftfit"] == 1 and int(fits.fitted.sum()) == 63
    with plain_kernels(card):
        plain = figdata.stacked_fits(f.port[ok], f.model[ok])
    fc = figdata.fitted_subint(runs["cpu"], 0, 0)
    cpu = figdata.stacked_fits(fc.port[ok], fc.model[ok])
    for other in (plain.phase.cpu(), cpu.phase):
        assert float((fits.phase.cpu() - other).abs().max()) <= 1e-9
    hists = [figdata.zap_hist(runs[d].channel_red_chi2s, 1.3)
             for d in (DEVICE, "cpu")]
    np.testing.assert_allclose(hists[0][0], hists[1][0], rtol=2e-9)
    assert hists[0][1] == hists[1][1]


# K4 cases: (subints, channels, nbin, kmax or None for nharm, a model per
# row)
K4_CASES = [
    (6, 7, 64, 12, False),       # rows shorter than a warp's 128 harmonics
    (5, 3, 63, 32, True),        # odd nbin, a model per row
    (300, 1, 128, None, True),   # one channel a lane, kmax = nharm
    (1, 511, 256, 129, False),   # one subint, kmax = nharm, odd row count
    (3, 2, 2, 2, False),         # nbin 2: two harmonics
    (64, 512, 2048, 128, False),  # the throughput chunk
]


@pytest.mark.parametrize("f0", [None, 0.5], ids=["F0_fact", "f0_half"])
@pytest.mark.parametrize("case", K4_CASES, ids=lambda c: "%dx%dx%d-k%s%s" % (
    c[0], c[1], c[2], c[3] or "all", "-rows" if c[4] else ""))
def test_spectra_kernels_match_plain_on_the_card(card, monkeypatch, case,
                                                 f0):
    """K4's two epilogues against their plain versions on the card: the
    cross and |m|^2 bit-equal (the same rounded operations, no fused
    multiply-add) and each row's data power, noise and inv_err2 within
    1e-13 relative (sums of positive terms in another order); the dfft
    left unmodified, a zero weight's inv_err2 and data power 0, and one
    launch counted per call."""
    K = card
    if f0 is not None:
        monkeypatch.setattr(K, "F0_fact", f0)
    r, nchan, nbin, kmax, per_row = case
    nharm = nbin // 2 + 1
    kmax = nharm if kmax is None else kmax
    gen = torch.Generator(device=DEVICE).manual_seed(r + nchan + nbin)
    dfft = torch.fft.rfft(torch.randn((r, nchan, nbin), generator=gen,
                                      device=DEVICE, dtype=torch.float64)
                          + 2.0, dim=-1)
    mfft = torch.fft.rfft(torch.randn(
        (r, nchan, nbin) if per_row else (nchan, nbin), generator=gen,
        device=DEVICE, dtype=torch.float64), dim=-1)
    before = dfft.clone()
    w = torch.rand((r, nchan), generator=gen, device=DEVICE,
                   dtype=torch.float64) + 0.5
    w[0, -1] = 0.0

    def outs(n):
        return [torch.empty((r, nchan, kmax), dtype=torch.complex128,
                            device=DEVICE)] + [
            torch.empty((r, nchan), dtype=torch.float64, device=DEVICE)
            for _ in range(n)] + [torch.empty(
                (r, nchan, kmax), dtype=torch.float64, device=DEVICE)
                if per_row else None]

    for name, head, nvec in (("spectra", (dfft, mfft, w, kmax), 1),
                             ("spectra_noise", (dfft, mfft, w, nbin, kmax),
                              3)):
        got, want = outs(nvec), outs(nvec)
        n0 = K.LAUNCHES[name]
        getattr(K, name)(*head, *got)
        assert K.LAUNCHES[name] == n0 + 1
        getattr(K, name + "_plain")(*head, *want)
        assert torch.equal(got[0], want[0]), name       # cross
        if per_row:
            assert torch.equal(got[-1], want[-1]), name  # |m|^2
        for g, p in zip(got[1:1 + nvec], want[1:1 + nvec]):
            err = ((g - p).abs() / p.abs().clamp_min(1e-300)).max()
            assert float(err) <= 1e-13, (name, float(err))
        assert float(got[1][0, -1]) == 0.0
        if name == "spectra_noise":
            assert float(got[3][0, -1]) == 0.0
    assert torch.equal(dfft, before)


def test_spectra_wrappers_refuse_on_the_card(card, monkeypatch):
    """K4's wrappers on CUDA tensors refuse a wrong dtype, shape or
    contiguity, and never fall back to the plain versions: with those
    made to raise, a valid call still launches the kernel."""
    K = card
    r, nchan, nbin, kmax = 2, 3, 16, 5
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    dfft = torch.randn((r, nchan, nbin // 2 + 1), dtype=torch.complex128,
                       generator=gen, device=DEVICE)
    mfft = dfft[0].clone()
    w = torch.ones((r, nchan), dtype=torch.float64, device=DEVICE)
    cross = torch.empty((r, nchan, kmax), dtype=torch.complex128,
                        device=DEVICE)
    sd = torch.empty((r, nchan), dtype=torch.float64, device=DEVICE)

    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(K, "spectra_plain", boom)
    monkeypatch.setattr(K, "spectra_noise_plain", boom)
    n0 = K.LAUNCHES["spectra"], K.LAUNCHES["spectra_noise"]
    K.spectra(dfft, mfft, w, kmax, cross, sd)
    K.spectra_noise(dfft, mfft, w, nbin, kmax, cross, sd, sd.clone(),
                    sd.clone())
    torch.cuda.synchronize()
    assert (K.LAUNCHES["spectra"], K.LAUNCHES["spectra_noise"]) == (
        n0[0] + 1, n0[1] + 1)
    bad = [
        (dfft.to(torch.complex64), mfft, w, kmax, cross, sd),
        (dfft, mfft, w.float(), kmax, cross, sd),
        (dfft, mfft[:2], w, kmax, cross, sd),
        (dfft, mfft, w, kmax + 1, cross, sd),
        (torch.cat([dfft, dfft], -1)[..., ::2], mfft, w, kmax, cross, sd),
        (dfft, mfft, w, kmax, torch.empty(
            (r, kmax, nchan), dtype=torch.complex128,
            device=DEVICE).transpose(1, 2), sd),
        (dfft, mfft, w.cpu(), kmax, cross, sd),
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            K.spectra(*args)
        with pytest.raises((TypeError, ValueError)):
            K.spectra_noise(*args[:3], nbin, *args[3:], sd.clone(),
                            sd.clone())


def test_errs_none_fit_kernel_equals_plain_on_the_card(card):
    """A seeded (phi, DM) fit of 48 subints of 64 x 512 without errs: the
    noise from K4's second epilogue (launched once, K4's first never),
    the phases seeded after it; through the plain versions: TOAs within
    1 ns, rc and nfeval equal."""
    from pulseportraiture_tpu_torch.fit.portrait import \
        fit_portrait_full_batch
    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait
    from pulseportraiture_tpu_torch.pipelines.synth import make_fake_dataset

    mp = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    ds = make_fake_dataset(gen, mp, nsub=48, nchan=64, nbin=512,
                           lofreq=1300.0, bw=400.0, P=0.005, noise_std=0.05,
                           device=DEVICE)
    model = gen_gaussian_portrait("000", mp, -4.0, get_bin_centers(512),
                                  ds.freqs, ds.nu_ref, device=DEVICE)

    def fit():
        return fit_portrait_full_batch(
            ds.subints, model, None, 0.005, ds.freqs,
            fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30,
            device=DEVICE)

    card.reset_launches()
    got = fit()
    assert card.LAUNCHES["spectra_noise"] == 1
    assert card.LAUNCHES["spectra"] == 0
    with plain_kernels(card):
        want = fit()
    dphi = ((want.phi - got.phi + 0.5) % 1.0 - 0.5).abs().max()
    assert float(dphi) * 0.005 < 1e-9
    assert torch.equal(want.return_code, got.return_code)
    assert torch.equal(want.nfeval, got.nfeval)


# -- the load on the card: K5, K6 and K7 ------------------------------------

LOAD_CASES = [(300, 2048), (64, 63), (3, 2), (6, 16385), (5, 32768),
              (2, 30001)]


@pytest.mark.parametrize("case", LOAD_CASES, ids=lambda c: "%dx%d" % c)
def test_load_kernels_match_plain_on_the_card(card, case):
    """K5's decode bit-equal to its plain version, its baseline (with the
    decode and alone, rows above shared memory's reach included) within
    1e-12 of each row's range; K6's noise within 1e-13 and S/N within
    1e-12 relative; K7 within 1e-13 of each row's largest harmonic; each
    launch counted."""
    K = card
    rows, nbin = case
    gen = torch.Generator(device=DEVICE).manual_seed(rows * 7 + nbin)
    raw = torch.randint(-32767, 32768, (rows, nbin), generator=gen,
                        device=DEVICE, dtype=torch.int64).to(torch.int16)
    scl = torch.rand(rows, generator=gen, device=DEVICE,
                     dtype=torch.float64) * 1e-3
    offs = (torch.rand(rows, generator=gen, device=DEVICE,
                       dtype=torch.float64) - 0.5) * 1e3
    K.reset_launches()
    x = K.unpack(raw, scl, offs)
    assert torch.equal(x, K.unpack_plain(raw, scl, offs))
    spread = (x.amax(-1, keepdim=True) - x.amin(-1, keepdim=True)).clamp_min(
        1e-300)
    want = K.baseline_plain(x)
    for got in (K.unpack(raw, scl, offs, frac=0.125), K.baseline(x),
                K.baseline(x.clone(), out=None)):
        assert float(((got - want).abs() / spread).max()) <= 1e-12
    inplace = x.clone()
    K.baseline(inplace, out=inplace)
    assert float(((inplace - want).abs() / spread).max()) <= 1e-12
    base = want.contiguous()
    X = torch.fft.rfft(base, dim=-1)
    outs = [torch.empty(rows, dtype=torch.float64, device=DEVICE)
            for _ in range(4)]
    K.load_stats(base, X, outs[0], outs[1])
    K.load_stats_plain(base, X, outs[2], outs[3])
    assert float(((outs[0] - outs[2]).abs() / outs[2].abs()).max()) <= 1e-13
    assert float(((outs[1] - outs[3]).abs() / outs[3].abs().clamp_min(
        1e-300)).max()) <= 1e-12
    shifts = (torch.rand(rows, generator=gen, device=DEVICE,
                         dtype=torch.float64) - 0.5) * 80.0
    scale = X.abs().amax(-1, keepdim=True).clamp_min(1e-300)
    got = K.rotate(X, shifts)
    assert float(((got - K.rotate_plain(X, shifts)).abs() / scale).max()) \
        <= 1e-13
    Y = X.clone()
    K.rotate(Y, shifts, out=Y)
    assert torch.equal(Y, got)
    torch.cuda.synchronize()
    assert {n: K.LAUNCHES[n] for n in ("unpack", "baseline", "load_stats",
                                       "rotate")} == dict(
        unpack=2, baseline=3, load_stats=1, rotate=2)


@pytest.mark.parametrize("kw", [
    dict(), dict(dedisperse=True, flux_prof=True),
    dict(tscrunch=True, fscrunch=True, flux_prof=True),
    dict(noise_method="fit", get_SNRs=False)],
    ids=["default", "dedisperse", "scrunch", "noise_fit"])
def test_load_data_card_matches_plain_and_cpu(card, archive, kw):
    """load_data on the card through K5-K7, with their plain versions on
    the card, and on the CPU: subints within 1e-12 of each row's range,
    noise within 1e-13 and S/N within 1e-12 relative (1e-12 for the
    "fit" noise), prof within 1e-12 of its peak, flux_prof within 1e-12
    of its largest; the kernels launched."""
    from pulseportraiture_tpu_torch.io.archive import load_data

    K = card
    _, path = archive
    K.reset_launches()
    got = load_data(path, device=DEVICE, **kw)
    launched = dict(K.LAUNCHES)
    with plain_kernels(K):
        plain = load_data(path, device=DEVICE, **kw)
    host = load_data(path, device="cpu", **kw)
    assert launched["load_stats"] >= 2 and launched["unpack"] == 1
    assert launched["baseline"] == int("dedisperse" in kw)
    assert launched["rotate"] >= 1   # the work copy's dedispersion
    for want in (plain, host):
        s = want.subints
        spread = np.maximum(np.ptp(s, axis=-1, keepdims=True), 1e-300)
        assert np.max(np.abs(got.subints - s) / spread) <= 1e-12
        nt = 1e-12 if kw.get("noise_method") == "fit" else 1e-13
        assert np.max(np.abs(got.noise_stds - want.noise_stds)
                      / np.maximum(np.abs(want.noise_stds), 1e-300)) <= nt
        assert np.max(np.abs(got.SNRs - want.SNRs)
                      / np.maximum(np.abs(want.SNRs), 1e-300)) <= 1e-12
        assert np.max(np.abs(got.prof - want.prof)) \
            <= 1e-12 * np.abs(want.prof).max()
        for key in ("prof_noise", "prof_SNR"):
            assert abs(got[key] - want[key]) <= 1e-12 * abs(want[key])
        if kw.get("flux_prof"):
            assert np.max(np.abs(got.flux_prof - want.flux_prof)) \
                <= 1e-12 * np.abs(want.flux_prof).max()
        np.testing.assert_array_equal(got.masks, want.masks)


def _baseline_gap(got, want):
    """Largest |got - want| over each row's range of want; NaN in both is no
    gap, NaN in one an infinite one."""
    spread = (want.amax(-1, keepdim=True) - want.amin(-1, keepdim=True))
    gap = (got - want).abs() / spread.clamp_min(1e-300)
    both = torch.isnan(got) & torch.isnan(want)
    one = torch.isnan(got) ^ torch.isnan(want)
    gap = torch.where(both, torch.zeros_like(gap), gap)
    gap = torch.where(one, torch.full_like(gap, float("inf")), gap)
    return float(gap.max())


def _stored(rows, nbin, seed, pad=0):
    """(stored rows on the card, their values [rows, nbin] int16 on the
    host): random values written into FITS-like records with a ``pad``-byte
    column before DATA (an odd stride and offset when pad is odd), packed
    by io.archive.stored_rows and uploaded."""
    from pulseportraiture_tpu_torch.io.archive import stored_rows

    rng = np.random.default_rng(seed)
    vals = rng.integers(-32768, 32768, (rows, nbin)).astype(np.int16)
    fields = ([("PAD", "S%d" % pad)] if pad else []) + [
        ("DATA", ">i2", (nbin,))]
    table = np.zeros(rows, dtype=fields)
    table["DATA"] = vals
    col = np.frombuffer(memoryview(table.tobytes()), dtype=table.dtype)
    packed = stored_rows(col["DATA"].reshape(rows, 1, 1, nbin),
                         torch.device(DEVICE))
    return packed.to(DEVICE), vals


STORED_CASES = {
    "odd_stride": dict(rows=40, nbin=2048, pad=3),
    "odd_nbin": dict(rows=33, nbin=999, pad=5),
    "one_row": dict(rows=1, nbin=2048, pad=0),
    "misaligned": dict(rows=7, nbin=512, pad=0, shift=1),
    "nan_rows": dict(rows=9, nbin=1024, pad=0, nan=True),
    "scratch": dict(rows=3, nbin=32768, pad=1),
}


@pytest.mark.parametrize("case", sorted(STORED_CASES))
def test_unpack_stored_column_on_the_card(card, case):
    """K5 on the stored column: the decode bit-equal to numpy's decode of
    the values and to unpack_plain, its baseline (with the decode and
    alone) within 1e-12 of each row's range of the plain version's, at
    odd record strides, odd nbin, a single row (an idle warp in its block),
    tensors off 16-byte alignment (the scalar path), rows with NaN (their
    baseline NaN in both) and rows above shared memory's reach (scratch);
    each launch counted."""
    K = card
    c = STORED_CASES[case]
    rows, nbin = c["rows"], c["nbin"]
    raw, vals = _stored(rows, nbin, seed=rows + nbin, pad=c["pad"])
    rng = np.random.default_rng(nbin)
    scl = torch.as_tensor(rng.uniform(1e-4, 1.0, rows).astype(np.float32)
                          .astype(np.float64), device=DEVICE)
    offs = torch.as_tensor(rng.uniform(-50, 50, rows).astype(np.float32)
                           .astype(np.float64), device=DEVICE)
    if c.get("nan"):
        scl[rows // 2] = float("nan")
    out = None
    if c.get("shift"):
        # raw and out 2 and 8 bytes off 16-byte alignment
        buf = torch.empty(rows * nbin + 1, dtype=torch.int16, device=DEVICE)
        buf[1:].copy_(raw.reshape(-1))
        raw = buf[1:].view(rows, nbin)
        out = torch.empty(rows * nbin + 1, dtype=torch.float64,
                          device=DEVICE)[1:].view(rows, nbin)
        assert raw.data_ptr() % 16 and out.data_ptr() % 16
    K.reset_launches()
    x = K.unpack(raw, scl, offs, out=out)
    want = vals.astype(np.float64) * scl.cpu().numpy()[:, None] \
        + offs.cpu().numpy()[:, None]
    np.testing.assert_array_equal(x.cpu().numpy(), want)
    assert torch.equal(K.unpack_plain(raw, scl, offs).nan_to_num(7.0),
                       x.nan_to_num(7.0))
    base = K.baseline_plain(x.clone())
    got = K.unpack(raw, scl, offs, frac=0.125)
    assert _baseline_gap(got, base) <= 1e-12
    xin = x if c.get("shift") else x.clone()  # misaligned: scalar path
    if c.get("nan"):
        xin[1, nbin // 3] = float("nan")
        base = K.baseline_plain(xin.clone())
    assert _baseline_gap(K.baseline(xin), base) <= 1e-12
    K.baseline(xin, out=xin)
    assert _baseline_gap(xin, base) <= 1e-12
    if c.get("nan"):
        assert torch.isnan(xin[1]).all() and torch.isnan(xin[rows // 2]).all()
        assert not torch.isnan(xin[0]).any()
    torch.cuda.synchronize()
    assert {n: K.LAUNCHES[n] for n in ("unpack", "baseline")} == dict(
        unpack=2, baseline=2)


def test_unpack_wrappers_refuse_on_the_card(card):
    """K5's wrappers raise on what the kernel does not take, on the card
    as on the CPU, and never fall back to the plain version: a refused
    call launches nothing."""
    K = card
    raw = torch.zeros(4, 64, dtype=torch.int16, device=DEVICE)
    ones = torch.ones(4, dtype=torch.float64, device=DEVICE)
    x = torch.zeros(4, 64, dtype=torch.float64, device=DEVICE)
    K.reset_launches()
    bad = [
        (TypeError, lambda: K.unpack(raw.float(), ones, ones)),
        (ValueError, lambda: K.unpack(raw[:, ::2], ones, ones)),
        (ValueError, lambda: K.unpack(raw, ones[:3], ones)),
        (ValueError, lambda: K.unpack(raw, ones.cpu(), ones)),
        (ValueError, lambda: K.unpack(raw, ones, ones, out=x[:3])),
        (TypeError, lambda: K.baseline(x.float())),
        (ValueError, lambda: K.baseline(x.t())),
        (ValueError, lambda: K.baseline(x, out=torch.empty_like(x).cpu())),
    ]
    for err, call in bad:
        with pytest.raises(err):
            call()
    assert K.LAUNCHES["unpack"] == K.LAUNCHES["baseline"] == 0


@pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan"])
def test_gettoas_device_cube_on_the_card(card, archive, nan):
    """GetTOAs on a bunch loaded on the card indexes the load's device cube
    (no upload of the portraits) and gives the same TOAs, rc and nfeval
    as the same bunch without its cube (the host batch uploaded), with a
    NaN channel zapped by both guards; the cube is taken off the bunch."""
    from pulseportraiture_tpu_torch.io.archive import take_device_cube
    from pulseportraiture_tpu_torch.pipelines.toas import (
        GetTOAs, load_archive_data)

    _, path = archive
    runs = []
    for keep in (True, False):
        d = load_archive_data(path, device=DEVICE)
        assert d.device_cube is not None and d.device_cube.is_cuda
        if nan:
            d.subints[1, 0, 5, 9] = np.nan
            d.device_cube[1, 0, 5, 9] = float("nan")
        if not keep:
            take_device_cube(d)
        gt = GetTOAs([path], GMODEL, quiet=True, device=DEVICE)
        gt.preload(path, ("data", d))
        gt.get_TOAs(bary=False)
        assert d.device_cube is None
        runs.append(gt)
    assert _max_dt_ns(_toas(runs[0]), _toas(runs[1])) == 0.0
    for attr in ("rcs", "nfevals", "n_nonfinite_zapped"):
        assert [np.asarray(v).tolist() for v in getattr(runs[0], attr)] == \
            [np.asarray(v).tolist() for v in getattr(runs[1], attr)]
    assert [int(n) for n in runs[0].n_nonfinite_zapped] == [int(nan)]


# K8 (csrc/wavelet.cu) against its plain version: (rows, nbin, levels,
# threshold mode, wavelet); 8192 bins take the median's sort and the scan
# above 48 KB of shared memory, the taps an explicit filter, 1000 bins a
# width the scan does not take (every row through the route)
SMOOTH_CASES = [(10, 2048, 11, "hard", "db8"), (1, 2048, 11, "hard", "db8"),
                (64, 2048, 11, "soft", "db8"), (16, 1000, 1, "hard", "db8"),
                (8, 8192, 13, "hard", "db8"), (8, 256, 8, "soft", "taps"),
                (512, 2048, 11, "hard", "db8"), (8, 64, 6, "hard", "db8")]
SMOOTH_TOL = 1e-10


def _smooth_rows(rows, nbin, seed):
    """Seeded rows cycling through a two-Gaussian pulse plus noise at S/N
    from ~3 to ~300, the pulse with a spike one bin wide, pure noise, an
    all-zero row and the noiseless pulse."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    pulse = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2) \
        + 0.5 * np.exp(-0.5 * ((x - 0.5) / 0.04) ** 2)
    spike = np.exp(-0.5 * ((x - 0.3) * nbin) ** 2)
    out = []
    for i in range(rows):
        kind = i % 6
        noise = rng.standard_normal(nbin) * 0.1
        if kind == 0:
            out.append(pulse * rng.uniform(0.1, 10.0) + noise)
        elif kind == 1:
            out.append(pulse + 10.0 * spike + noise)
        elif kind == 2:
            out.append(noise * 10.0)
        elif kind == 3 and rows > 6:
            out.append(np.zeros(nbin))
        elif kind == 4 and rows > 6:
            out.append(pulse)
        else:
            out.append(pulse * rng.uniform(1.0, 3.0) + noise)
    return torch.as_tensor(np.array(out), device=DEVICE)


@pytest.mark.parametrize("case", SMOOTH_CASES, ids=lambda c: "%dx%d-%d-%s-%s"
                         % c)
def test_smooth_search_kernel_matches_plain(card, monkeypatch, case):
    """K8 against its plain version on the card: the same (level, factor)
    per row, the same rows zeroed, each smooth within SMOOTH_TOL of its
    row's peak; one counted launch per chunk decided, the scan's chunks
    and the route's chunks of the uncertain rows (here also in chunks of
    3 rows), the rows counted by tier; the plain version never called for
    a CUDA tensor."""
    K = card
    rows, nbin, nlevel, mode, wavelet = case
    if wavelet == "taps":
        from pulseportraiture_tpu_torch.ops.wavelet import daubechies_dec_lo
        wavelet = tuple(daubechies_dec_lo(2))
    port = _smooth_rows(rows, nbin, rows + nbin)
    facts = torch.linspace(0.0, 3.0, 30, dtype=torch.float64, device=DEVICE)
    want, wchoice = K.smooth_search_plain(port, wavelet, nlevel, facts, 0.1,
                                          mode)

    def boom(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(K, "smooth_search_plain", boom)
    for chunk in (None, 3):
        if chunk is not None:
            monkeypatch.setattr(K, "smooth_chunk_rows", lambda *a: chunk)
            monkeypatch.setattr(K, "scan_chunk_rows", lambda *a: chunk)
        step = K.smooth_chunk_rows(nlevel, 30, nbin)
        K.reset_launches()
        got, choice = K.smooth_search(port, wavelet, nlevel, facts, 0.1, mode)
        torch.cuda.synchronize()
        tiers = dict(K.SMOOTH_ROWS)
        if K.scannable(nbin):
            # a launch per scan chunk, and per route chunk of the uncertain
            # rows
            assert tiers["scanned"] == rows and tiers["unscanned"] == 0
            chunks = -(-rows // K.scan_chunk_rows(nlevel, 30, nbin))
            assert K.LAUNCHES["smooth_search"] == \
                chunks + -(-tiers["redecided"] // step)
        else:
            assert tiers == dict(scanned=0, redecided=0, unscanned=rows)
            assert K.LAUNCHES["smooth_search"] == -(-rows // step)
        assert torch.equal(choice, wchoice), (choice, wchoice)
        peak = want.abs().max(dim=-1).values.clamp(min=1e-300)
        gap = (got - want).abs().max(dim=-1).values
        assert bool((gap <= SMOOTH_TOL * peak).all()), gap / peak
        assert torch.equal(got.abs().sum(-1) == 0, want.abs().sum(-1) == 0)


def test_smooth_search_refuses_on_the_card(card):
    """K8 raises on what it does not take, on the card as on the CPU (more
    bins than its sort holds among them), launching nothing; smart_smooth
    on a CUDA tensor goes through it."""
    from pulseportraiture_tpu_torch.ops.wavelet import smart_smooth

    K = card
    facts = torch.linspace(0.0, 3.0, 30, dtype=torch.float64, device=DEVICE)
    big = torch.zeros(2, 2 * K.SMOOTH_MAX_BINS, dtype=torch.float64,
                      device=DEVICE)
    port = _smooth_rows(4, 256, 1)
    K.reset_launches()
    bad = [
        (ValueError, lambda: K.smooth_search(big, "db8", 1, facts, 0.1)),
        (ValueError, lambda: K.smooth_search(port, "db8", 8, facts, 0.1,
                                             "garrote")),
        (TypeError, lambda: K.smooth_search(port.float(), "db8", 8, facts,
                                            0.1)),
        (ValueError, lambda: K.smooth_search(port.t().contiguous().t(),
                                             "db8", 8, facts, 0.1)),
        (ValueError, lambda: K.smooth_search(port, "db8", 8, facts.cpu(),
                                             0.1)),
    ]
    for err, call in bad:
        with pytest.raises(err):
            call()
    assert K.LAUNCHES["smooth_search"] == 0
    out = smart_smooth(port)
    torch.cuda.synchronize()
    # the scan's chunk, and the route's chunk where a row is uncertain
    assert out.device.type == "cuda" and K.LAUNCHES["smooth_search"] == \
        1 + min(1, K.SMOOTH_ROWS["redecided"])
    assert K.SMOOTH_ROWS["scanned"] == 4


# K8's scan (pp_wavelet_scan) against its plain version: (rows, nbin,
# levels, threshold mode)
SCAN_CASES = [(10, 2048, 11, "hard"), (64, 256, 8, "soft"),
              (8, 8192, 13, "hard"), (4, 64, 6, "soft")]


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "%dx%d-%d-%s" % c)
def test_smooth_scan_kernel_matches_plain(card, case):
    """The scan kernel against smooth_scan_plain, which runs the same
    transforms in torch with every product and sum rounded in the same
    order: the S/N and chi2 of every candidate where both are positive
    and finite within 1e-12 relative (the two differ in their sums'
    order only), the noise and signal power likewise, the repeat flags
    equal."""
    K = card
    rows, nbin, nlevel, mode = case
    port = _smooth_rows(rows, nbin, 7 * rows + nbin)
    facts = torch.linspace(0.0, 3.0, 30, dtype=torch.float64, device=DEVICE)
    st, same = K.smooth_scan(port, "db8", nlevel, facts, mode)
    sp, samep = K.smooth_scan_plain(port, "db8", nlevel, facts, mode)
    torch.cuda.synchronize()
    assert torch.equal(same, samep)
    ok = torch.isfinite(sp).all(-1) & (sp > 0).all(-1)
    assert bool(ok.any())
    rel = (st - sp).abs() / sp.abs()
    assert float(rel[ok].max()) <= 1e-12


def test_cufft_rows_batch_invariant(card):
    """The route's agreement with the plain version rests on cuFFT giving
    a row the same bits whatever its batch: the transforms of rows
    gathered in batches of other sizes equal those of the full batch,
    and smooth_search_plain at full size and row by row chooses the
    same."""
    K = card
    g = torch.Generator(device=DEVICE).manual_seed(3)
    for nbin in (2048, 1000, 8192):
        x = torch.randn(64, nbin, generator=g, device=DEVICE,
                        dtype=torch.float64)
        C = torch.randn(64, 11, nbin // 2 + 1, generator=g, device=DEVICE,
                        dtype=torch.complex128)
        full_r = torch.fft.rfft(x, dim=-1)
        full_i = torch.fft.irfft(C, n=nbin, dim=-1)
        for B in (1, 3, 10):
            idx = torch.randperm(64, generator=g, device=DEVICE)[:B]
            assert torch.equal(torch.fft.rfft(x[idx], dim=-1), full_r[idx])
            assert torch.equal(torch.fft.irfft(C[idx], n=nbin, dim=-1),
                               full_i[idx])
    port = _smooth_rows(24, 2048, 5)
    facts = torch.linspace(0.0, 3.0, 30, dtype=torch.float64, device=DEVICE)
    _, whole = K.smooth_search_plain(port, "db8", 11, facts, 0.1)
    for i in range(port.shape[0]):
        _, one = K.smooth_search_plain(port[i:i + 1], "db8", 11, facts, 0.1)
        assert torch.equal(one[0], whole[i]), i


# K9 (csrc/gauss.cu): (components, lanes, model code); the kernel against
# its plain version within GAUSS_TOL of each output's largest magnitude per
# lane (sums of ~130,000 terms in another order: the Gram per channel, then
# the chain rule and the channel tree; an H100 read <= 1.1e-13 at [512,
# 2048]).  1-2 components take the warp layout, 3 and more the FP64 tensor
# cores (4: k-steps split over warps; 21 and 24: two row blocks, three
# panels)
GAUSS_CASES = [(1, 1, "000"), (2, 2, "010"), (3, 1, "111"), (4, 1, "100"),
               (8, 1, "101"), (1, 3, "000"), (3, 3, "011"), (8, 3, "000"),
               (19, 1, "000"), (21, 1, "110"), (24, 2, "101")]
GAUSS_TOL = 1e-12


def _gauss_inputs(ngauss, lanes, code, nchan=128, nbin=1024, seed=11,
                  per_channel=False):
    """K9's arguments on the card: lanes of ngauss components (slopes
    sized to the code's laws), data a noisy model, per-bin errors (or
    per-channel ones broadcast over the bins, as ppgauss gives them)."""
    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    rng = np.random.default_rng(seed)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    slope = {"0": (-0.05, 0.1, -1.2), "1": (-1e-5, 1e-5, -4e-4)}
    comps = []
    for c in range(ngauss):
        comps += [0.1 + 0.8 * c / max(ngauss, 1), slope[code[0]][0],
                  0.01 + 0.005 * c, slope[code[1]][1], 1.0 / (c + 1),
                  slope[code[2]][2]]
    base = np.concatenate([[0.03, 0.0], comps, [-4.0]])
    x = np.stack([base * (1.0 + 0.002 * k) for k in range(lanes)])
    x[:, 1] = 0.0
    model = gen_gaussian_portrait(code, base[:-1], base[-1],
                                  np.arange(nbin) / nbin, freqs,
                                  1500.0).numpy()
    errs = 0.05 * rng.uniform(0.5, 1.5, (nchan, nbin))
    data = model + rng.normal(0.0, 1.0, (nchan, nbin)) * errs
    t = lambda a: torch.as_tensor(a, device=DEVICE)  # noqa: E731
    errs = t(errs)
    if per_channel:
        errs = errs[:, :1].contiguous().expand(nchan, nbin)
    return (t(x), t(data), errs, get_bin_centers(nbin, device=DEVICE),
            t(freqs), 1500.0, code)


def _lane_gap(got, want):
    """Largest gap over the lanes, each relative to its lane's largest
    magnitude (NaN where both are NaN counted as equal)."""
    got, want = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    gap = (got - want).nan_to_num(0.0).abs().amax(-1)
    return float((gap / want.nan_to_num(0.0).abs().amax(-1).clamp_min(
        1e-300)).max())


@pytest.mark.parametrize("case", GAUSS_CASES, ids=lambda c: "%dg-%dl-%s" % c)
def test_gauss_kernels_match_plain_on_the_card(card, case):
    """K9's two epilogues against their plain versions on the card (f, g
    and J^T J within GAUSS_TOL of their largest magnitude, lane by lane),
    one counted launch a call, and two calls the same bits (no atomics on
    the sums; the tree's counters set back to 0), with and without a
    GaussWork."""
    K = card
    args = _gauss_inputs(*case)
    work = K.GaussWork(*args[1:])
    n0 = dict(K.LAUNCHES)
    got = K.gauss_normal(*args)
    again = K.gauss_normal(*args)
    sse = K.gauss_sse(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gauss_normal"] == n0["gauss_normal"] + 2
    assert K.LAUNCHES["gauss_sse"] == n0["gauss_sse"] + 1
    want = K.gauss_normal_plain(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        assert _lane_gap(a[:, None], b[:, None]) <= GAUSS_TOL
    assert _lane_gap(sse[:, None], want[0][:, None]) <= GAUSS_TOL
    assert torch.equal(sse, K.gauss_sse(*args))
    for _ in range(2):
        for a, b in zip(K.gauss_normal(*args, work=work), got):
            assert torch.equal(a, b)
        assert torch.equal(K.gauss_sse(*args, work=work), sse)


@pytest.mark.parametrize("ngauss", [1, 4, 19])
def test_gauss_kernels_graph_replay_same_bits(card, ngauss):
    """A call of each epilogue captured in a CUDA graph and replayed three
    times gives the eager call's bits every time: the channel tree's
    counters start each replay at 0."""
    K = card
    args = _gauss_inputs(ngauss, 2, "000", per_channel=True)
    work = K.GaussWork(*args[1:])
    want = [t.clone() for t in K.gauss_normal(*args, work=work)]
    want_f = K.gauss_sse(*args, work=work)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = K.gauss_normal(*args, work=work)
        f = K.gauss_sse(*args, work=work)
    for _ in range(3):
        for t in outs:
            t.zero_()
        f.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, want):
            assert torch.equal(a, b)
        assert torch.equal(f, want_f)


@pytest.mark.parametrize("ngauss,lanes", [(8, 1), (19, 1), (19, 2),
                                          (24, 1), (24, 2)])
def test_gauss_normal_tiles_give_the_same_bits(card, ngauss, lanes):
    """The mma layout in one 64-row panel (8, 19 components) and in three
    (24: two row blocks) over 700 bins (a last round of 28): two calls,
    each with buffers of its own, and two through one GaussWork give the
    same bits (no atomics on the sums; the tree's counters set back to
    0)."""
    K = card
    args = _gauss_inputs(ngauss, lanes, "000", nchan=64, nbin=700)
    assert K.gauss_layout(ngauss) == "mma"
    want = [t.clone() for t in K.gauss_normal(*args)]
    work = K.GaussWork(*args[1:])
    for got in (K.gauss_normal(*args), K.gauss_normal(*args, work=work),
                K.gauss_normal(*args, work=work)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _sizes_one_panel(K):
    # up to 20 components the Gram's 62 rows fill one 64-row panel: every
    # row staged, under the 48 KB a block takes without opting in; two
    # 64-row blocks' staged rows beyond
    one, two = K.gauss_sizes(20, 512)["smem"], K.gauss_sizes(21, 512)["smem"]
    assert one <= 48 * 1024 < two and two - one > 30000
    assert K.gauss_sizes(2, 512)["smem"] == 0  # the warp layout's is static


def _sizes_max(K):
    # the mma layout's limit: 84 bytes a component once the panels are two
    # full row blocks, within the H100's 232,448 bytes a block; epilogue
    # A's 36; each refused one component past its limit
    n, m = K.GAUSS_MAX_NGAUSS, K.GAUSS_SSE_MAX_NGAUSS
    top = K.gauss_sizes(n, 4)["smem"]
    assert top <= 232448 < top + 84
    assert top - K.gauss_sizes(n - 1, 4)["smem"] == 84
    assert K.gauss_sizes(m, 4, normal=False)["smem"] == 36 * m <= 232448
    with pytest.raises(ValueError, match="no launch"):
        K.gauss_sizes(n + 1, 4)
    with pytest.raises(ValueError, match="no launch"):
        K.gauss_sizes(m + 1, 4, normal=False)


def _sizes_rows(K):
    # a row of per-lane sums: J^T J's upper triangle over 6 ngauss + 1
    # live parameters, g, f and the poison; channels grouped a block only
    # where a lane's rows would pass 2^28 bytes
    width = {ng: K.gauss_sizes(ng, 512)["width"] for ng in (1, 19)}
    assert width == {1: 28 + 7 + 2, 19: 115 * 116 // 2 + 115 + 2}
    cpb = [K.gauss_sizes(ng, 512)["chans_per_block"]
           for ng in (1, 19, 100, K.GAUSS_MAX_NGAUSS)]
    assert cpb == [1, 1, 3, 980]


def _sizes_tree(K):
    # (fan-in, scratch rows, counters) a lane: one level where a node may
    # read every row (epilogue A), fan-in 8 for long rows; rows are the
    # leaves' and the inner levels', counters every level's nodes
    def tree(ng, nchan, normal=True):
        sz = K.gauss_sizes(ng, nchan, normal)
        return sz["fan"], sz["rows"], sz["counters"]

    assert tree(1, 512, False) == (512, 512, 1)
    assert tree(1, 512) == (27, 512 + 19, 19 + 1)
    assert tree(19, 512) == (8, 512 + 64 + 8, 64 + 8 + 1)
    assert tree(19, 1) == (8, 1, 1)
    assert tree(100, 512) == (8, 171 + 22 + 3, 22 + 3 + 1)


@pytest.mark.parametrize("case", ["one_panel", "max", "rows", "tree"])
def test_gauss_sizes_on_the_card(card, case):
    """csrc/gauss.cu's launch geometry as pp_gauss_sizes gives it to the
    wrappers: the mma layout's shared memory and limit, epilogue A's, the
    rows of sums and the channel tree."""
    globals()["_sizes_" + case](card)


@pytest.mark.parametrize("ngauss", [1, 3, 19])
def test_gauss_per_channel_errs_on_the_card(card, ngauss):
    """Per-channel errors broadcast over the bins (stride 0, as ppgauss
    gives them: each channel's 1 / err^2 applied once to its Gram) against
    the plain version and against the same errors materialised (1 / err
    in every bin), each within GAUSS_TOL."""
    K = card
    view = _gauss_inputs(ngauss, 2, "111", per_channel=True)
    assert view[2].stride(1) == 0
    full = list(view)
    full[2] = view[2].contiguous()
    got, per_bin = K.gauss_normal(*view), K.gauss_normal(*full)
    want = K.gauss_normal_plain(*full)
    for a, b, c in zip(got, per_bin, want):
        assert _lane_gap(a[:, None], c[:, None]) <= GAUSS_TOL
        assert _lane_gap(a[:, None], b[:, None]) <= GAUSS_TOL
    sse = K.gauss_sse(*view)
    assert _lane_gap(sse[:, None], want[0][:, None]) <= GAUSS_TOL
    assert _lane_gap(sse[:, None], K.gauss_sse(*full)[:, None]) <= GAUSS_TOL


def _z_floor(chi2):
    """The largest gap, in errors, at which two LM runs of one float64
    problem may stop apart: max(1e-6, 4 sqrt(eps chi2)) (a move of z
    errors changes chi2 by ~z^2 at reduced chi2 ~1, which float64 chi2
    cannot see below eps chi2)."""
    return max(1e-6, 4.0 * np.sqrt(np.finfo(float).eps * chi2))


def test_gaussian_portrait_fit_19_components_card_matches_cpu(card):
    """fit_gaussian_portrait with 19 components (the mma layout's one
    panel on the card) through K9 on the card and its plain version on the
    CPU: params and errors within _z_floor of the errors, rc equal."""
    from pulseportraiture_tpu_torch.fit import gauss as fg
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    ng, nchan, nbin = 19, 64, 512
    K = card
    comps = [[0.03 + 0.05 * c, -0.01, 0.012, 0.05, 1.0 - 0.03 * c, -1.0]
             for c in range(ng)]
    params = np.concatenate([[0.02, 0.0], np.ravel(comps)])
    freqs = np.linspace(1100.0, 1900.0, nchan)
    rng = np.random.default_rng(4)
    noise = 0.02 * rng.uniform(0.5, 1.5, nchan)
    model = gen_gaussian_portrait("000", params, -4.0,
                                  np.arange(nbin) / nbin, freqs,
                                  1500.0).numpy()
    data = model + rng.normal(0.0, 1.0, model.shape) * noise[:, None]
    flags = np.ones(len(params))
    flags[1] = 0.0
    init = params * np.where(np.arange(len(params)) % 2, 1.01, 0.995)
    args = ("000", data, init, -4.0, np.outer(noise, np.ones(nbin)), flags,
            False, np.arange(nbin) / nbin, freqs, 1500.0)
    K.reset_launches()
    routes = dict(fg.FIT_ROUTES)
    card_fit = fg.fit_gaussian_portrait(*args, device="cuda")
    assert K.LAUNCHES["gauss_normal"] > 0 and K.LAUNCHES["gauss_sse"] > 0
    cpu_fit = fg.fit_gaussian_portrait(*args, device="cpu")
    assert fg.FIT_ROUTES["normal"] == routes["normal"] + 2
    assert fg.FIT_ROUTES["jacfwd"] == routes["jacfwd"]
    err = cpu_fit.fit_errs
    fin = np.isfinite(err) & (err > 0)
    assert fin.sum() == len(params) - 1
    gap = np.abs(card_fit.fitted_params - cpu_fit.fitted_params)[fin] / err[fin]
    z_tol = _z_floor(cpu_fit.chi2)
    print("ppgauss-19: chi2 %r gap/err %r floor %r" % (cpu_fit.chi2,
                                                      gap.max(), z_tol))
    assert gap.max() <= z_tol
    assert np.all(np.abs(card_fit.fit_errs - err)[fin] <= z_tol * err[fin])
    assert card_fit.return_code == cpu_fit.return_code


def test_gauss_kernels_nan_and_limits_on_the_card(card):
    """An amplitude's power law at its 0 bound gives NaN in every g and
    J^T J entry, as the plain version (and forward-mode) does, f finite;
    757 components (above the tiled design's former limit of 756) against the plain version
    on the card, channels grouped two a block; more components than the
    mma layout's shared memory holds, float32 parameters and a CPU mix
    raise."""
    K = card
    args = list(_gauss_inputs(1, 2, "000"))
    x = args[0].clone()
    x[0, 6] = 0.0
    args[0] = x
    got, want = K.gauss_normal(*args), K.gauss_normal_plain(*args)
    assert torch.isnan(got[1][0]).all() and torch.isnan(got[2][0]).all()
    assert torch.isfinite(got[1][1]).all() and torch.isfinite(got[0]).all()
    for a, b in zip(got, want):
        assert _lane_gap(a[:, None], b[:, None]) <= GAUSS_TOL
    wide = _gauss_inputs(757, 1, "000", nchan=4, nbin=64)
    assert K.gauss_sizes(757, 4)["chans_per_block"] == 2
    for a, b in zip(K.gauss_normal(*wide), K.gauss_normal_plain(*wide)):
        assert _lane_gap(a[:, None], b[:, None]) <= GAUSS_TOL
    big = _gauss_inputs(K.GAUSS_MAX_NGAUSS + 1, 1, "000", nchan=4, nbin=64)
    with pytest.raises(ValueError, match="at most %d" % K.GAUSS_MAX_NGAUSS):
        K.gauss_normal(*big)
    assert torch.isfinite(K.gauss_sse(*big)).all()
    with pytest.raises(TypeError, match="float64"):
        K.gauss_normal(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="must be on"):
        K.gauss_sse(args[0].cpu(), *args[1:])


def test_gaussian_portrait_fit_757_components_takes_k9(card):
    """A fit of 757 components (the tiled design took at most 756; the mma
    layout takes GAUSS_MAX_NGAUSS) goes through K9 on the card, counted
    in FIT_ROUTES["normal"], and its dc (the one parameter fitted) and
    chi2 agree with the CPU's within _z_floor and 1e-9."""
    from pulseportraiture_tpu_torch.fit import gauss as fg
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    ng, nchan, nbin = 757, 4, 64
    K = card
    assert fg.portrait_route(0, 0.0, 0.0, ng, "cuda") == "normal"
    assert fg.portrait_route(0, 0.0, 0.0, K.GAUSS_MAX_NGAUSS + 1,
                             "cuda") == "jacfwd"
    comps = [[(c + 0.5) / ng, 0.0, 0.004, 0.0, 0.2, 0.0] for c in range(ng)]
    params = np.concatenate([[0.02, 0.0], np.ravel(comps)])
    freqs = np.linspace(1100.0, 1900.0, nchan)
    rng = np.random.default_rng(6)
    model = gen_gaussian_portrait("111", params, -4.0,
                                  np.arange(nbin) / nbin, freqs,
                                  1500.0).numpy()
    data = model + rng.normal(0.0, 0.01, model.shape)
    flags = np.zeros(len(params))
    flags[0] = 1.0
    init = params.copy()
    init[0] = 0.03
    args = ("111", data, init, -4.0, np.full(data.shape, 0.01), flags,
            False, np.arange(nbin) / nbin, freqs, 1500.0)
    K.reset_launches()
    routes = dict(fg.FIT_ROUTES)
    card_fit = fg.fit_gaussian_portrait(*args, device="cuda")
    assert K.LAUNCHES["gauss_normal"] > 0 and K.LAUNCHES["gauss_sse"] > 0
    assert fg.FIT_ROUTES["normal"] == routes["normal"] + 1
    cpu_fit = fg.fit_gaussian_portrait(*args, device="cpu")
    assert fg.FIT_ROUTES["jacfwd"] == routes["jacfwd"]
    err = cpu_fit.fit_errs[0]
    assert np.isfinite(err) and err > 0
    assert abs(card_fit.fitted_params[0] - cpu_fit.fitted_params[0]) \
        <= _z_floor(cpu_fit.chi2) * err
    assert abs(card_fit.chi2 - cpu_fit.chi2) <= 1e-9 * cpu_fit.chi2
    assert card_fit.return_code == cpu_fit.return_code


# ppgauss card-vs-CPU fixtures: (seed, channels, bins, noise)
PPGAUSS_CASES = [(7, 64, 512, 0.01), (8, 128, 1024, 0.01),
                 (9, 256, 512, 0.03)]


@pytest.mark.parametrize("case", PPGAUSS_CASES,
                         ids=lambda c: "seed%d-%dx%d" % c[:3])
def test_ppgauss_cli_card_matches_cpu(card, tmp_path, monkeypatch, case):
    """ppgauss --autogauss 0.05 --niter 1 on the card (its portrait fits
    through K9, no jacfwd) against the same CLI on the CPU (K9's plain
    version): the fitted model parameters (read from the CLI's
    GaussianModelPortrait at full precision) within _z_floor(chi2) of
    their errors, the floor below which float64 chi2 cannot tell two
    parameter vectors apart: K9 and its plain version sum in other
    orders, so their LM runs may stop apart at that floor.  Each case
    prints its chi2, gap and floor.  The .gmodel files within that and
    their printed digit (8 decimals)."""
    from pulseportraiture_tpu_torch.cli import ppgauss
    from pulseportraiture_tpu_torch.fit import gauss as fg
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
    from pulseportraiture_tpu_torch.io.gmodel import read_model, write_model
    from pulseportraiture_tpu_torch.models import gauss as mg

    built, chi2 = [], []
    make = mg.GaussianModelPortrait.make_gaussian_model

    def keep(self, *a, **kw):
        built.append(self)
        return make(self, *a, **kw)

    monkeypatch.setattr(mg.GaussianModelPortrait, "make_gaussian_model",
                        keep)

    K = card
    gm = str(tmp_path / "true.gmodel")
    write_model(gm, "fake", "000", 1500.0,
                [0.05, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2],
                np.ones(8, int), -4.0, 0, quiet=True)
    seed, nchan, nbin, noise = case
    avg = make_fake_pulsar(gm, PAR, str(tmp_path / "avg.fits"), nsub=1,
                           nchan=nchan, nbin=nbin, nu0=1500.0, bw=800.0,
                           tsub=60.0, noise_stds=noise, dedispersed=True,
                           seed=seed, quiet=True)
    out = {}
    for dev in ("cuda", "cpu"):
        K.reset_launches()
        routes = dict(fg.FIT_ROUTES)
        path = str(tmp_path / ("%s.gmodel" % dev))
        assert ppgauss.main(["-d", avg, "--autogauss", "0.05", "--niter",
                             "1", "-o", path, "--device", dev]) == 0
        assert fg.FIT_ROUTES["jacfwd"] == routes["jacfwd"]
        assert fg.FIT_ROUTES["normal"] > routes["normal"]
        if dev == "cuda":
            assert K.LAUNCHES["gauss_normal"] > 0
            assert K.LAUNCHES["gauss_sse"] > 0
        out[dev] = (built[-1].model_params, built[-1].model_param_errs,
                    read_model(path)[4])
        chi2.append(built[-1].chi2)
    (pk, _, fk), (pc, ec, fc) = out["cuda"], out["cpu"]
    fin = np.isfinite(ec) & (ec > 0)
    assert fin.sum() >= 6 and np.isfinite(pk).all()
    z_tol = _z_floor(chi2[-1])
    gap = float(np.max(np.abs(pk - pc)[fin] / ec[fin]))
    print("ppgauss %s: chi2 %r gap/err %r floor %r" % (case, chi2[-1], gap,
                                                      z_tol))
    assert gap <= z_tol
    assert np.abs(fk - fc).max() <= z_tol * ec[fin].max() + 1.01e-8


# K10 (csrc/gauss_ft.cu): (components, lanes, model code, kind, channels,
# bins); kind: tau > 0 ("tau"), tau = 0 with tau fitted ("tau0"), two join
# groups ("joined"), both ("joined_tau").  The kernel against its plain
# version within GAUSS_FT_TOL of each output's largest magnitude per lane
# (an H100 read <= 6.7e-16 for f, 4e-14 for g and 1.9e-14 for J^T J); the
# cases take epilogue B's every path (_kernels.gauss_ft_path): on chip in
# clusters of one and two blocks, and staged
GAUSS_FT_CASES = [(1, 1, "000", "tau", 128, 1024),
                  (2, 2, "111", "tau0", 64, 512),
                  (3, 1, "000", "joined", 128, 1024),
                  (4, 3, "101", "joined_tau", 64, 256),
                  (19, 1, "000", "tau", 64, 2048),
                  (21, 1, "011", "joined_tau", 32, 512),
                  (1, 1, "000", "tau", 16, 64),
                  (2, 1, "000", "joined_tau", 16, 8192),
                  (1, 1, "000", "joined_tau", 64, 2048),
                  (4, 2, "011", "joined_tau", 64, 2048),
                  (10, 1, "000", "tau", 32, 2048),
                  (4, 1, "000", "joined", 16, 8192),
                  (19, 1, "000", "joined_tau", 16, 8192)]
GAUSS_FT_TOL = 1e-12


def _gauss_ft_inputs(ngauss, lanes, code, kind, nchan, nbin, seed=12):
    """K10's arguments on the card: K9's lanes (_gauss_inputs) with tau
    (2 bins, or 0) and two join groups splitting the band where ``kind``
    says, per-channel errors broadcast over the bins, the data a noisy
    model."""
    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    rng = np.random.default_rng(seed)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    slope = {"0": (-0.05, 0.1, -1.2), "1": (-1e-5, 1e-5, -4e-4)}
    comps = []
    for c in range(ngauss):
        comps += [0.1 + 0.8 * c / ngauss, slope[code[0]][0],
                  0.01 + 0.005 * c, slope[code[1]][1], 1.0 / (c + 1),
                  slope[code[2]][2]]
    joined = kind.startswith("joined")
    tau = 2.0 if kind in ("tau", "joined_tau") else 0.0
    jp = [0.01, 1e-3, -0.02, -2e-3] if joined else []
    joins = [np.arange(0, nchan // 3), np.arange(nchan // 3, nchan)] \
        if joined else ()
    base = np.concatenate([[0.03, tau], comps, [-4.0], jp])
    x = np.stack([base * (1.0 + 0.002 * k) for k in range(lanes)])
    x[:, 1] = tau
    npar = 2 + 6 * ngauss
    model = gen_gaussian_portrait(
        code, np.concatenate([base[:npar], jp]), -4.0,
        np.arange(nbin) / nbin, freqs, 1500.0, join_ichans=joins,
        P=0.005).numpy()
    noise = 0.05 * rng.uniform(0.5, 1.5, nchan)
    data = model + rng.normal(0.0, 1.0, (nchan, nbin)) * noise[:, None]
    groups = np.full(nchan, -1, dtype=np.int32)
    for j, ichans in enumerate(joins):
        groups[ichans] = j
    t = lambda a: torch.as_tensor(a, device=DEVICE)  # noqa: E731
    return (t(x), t(data), t(noise[:, None]).expand(nchan, nbin),
            get_bin_centers(nbin, device=DEVICE), t(freqs), 1500.0, code,
            t(groups), len(joins), 0.005)


def _gauss_ft_gaps(got, want):
    """(f, g, J^T J) gaps, each _lane_gap."""
    return [_lane_gap(a[:, None], b[:, None]) for a, b in zip(got, want)]


@pytest.mark.parametrize("case", GAUSS_FT_CASES,
                         ids=lambda c: "%dg-%dl-%s-%s-%dx%d" % c)
def test_gauss_ft_kernels_match_plain_on_the_card(card, case):
    """K10's two epilogues against their plain versions on the card (f, g
    and J^T J within GAUSS_FT_TOL of their largest magnitude, lane by
    lane; the same NaNs), one counted launch a call, each epilogue B call
    counted on the path gauss_ft_path names (the source's own choice, as
    gauss_ft_sizes reports it), two calls the same bits (no atomics on the
    sums; the tree's counters set back to 0), with and without a
    GaussFtWork."""
    K = card
    args = _gauss_ft_inputs(*case)
    nchan, nbin = args[1].shape
    path = K.gauss_ft_path(case[0], args[8], nchan, nbin)
    sz = K.gauss_ft_sizes(case[0], args[8], nchan, nbin)
    assert (sz["cluster"], sz["batch"]) == (path["cluster"], path["batch"])
    onchip = "onchip" if path["cluster"] else "staged"
    work = K.GaussFtWork(*args[1:])
    n0, p0 = dict(K.LAUNCHES), dict(K.GAUSS_FT_PATHS)
    got = K.gauss_ft_normal(*args)
    again = K.gauss_ft_normal(*args)
    sse = K.gauss_ft_sse(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["gauss_ft_normal"] == n0["gauss_ft_normal"] + 2
    assert K.GAUSS_FT_PATHS[onchip] == p0[onchip] + 2
    assert sum(K.GAUSS_FT_PATHS.values()) == sum(p0.values()) + 2
    assert K.LAUNCHES["gauss_ft_sse"] == n0["gauss_ft_sse"] + 1
    want = K.gauss_ft_normal_plain(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    gf, gg, gh = _gauss_ft_gaps(got, want)
    gs = _lane_gap(sse[:, None], want[0][:, None])
    print("K10 %s: f %.3g g %.3g JtJ %.3g sse %.3g" % (case, gf, gg, gh, gs))
    assert max(gf, gg, gh, gs) <= GAUSS_FT_TOL
    assert torch.equal(sse, K.gauss_ft_sse(*args))
    for _ in range(2):
        for a, b in zip(K.gauss_ft_normal(*args, work=work), got):
            assert torch.equal(a, b)
        assert torch.equal(K.gauss_ft_sse(*args, work=work), sse)
    if case[3] == "tau0":   # the tau and scattering-index rows: exact zeros
        ia = args[0].shape[1] - 1 - 2 * args[8]
        for i in (1, ia):
            assert not got[1][:, i].any()
            assert not got[2][:, i].any() and not got[2][:, :, i].any()


@pytest.mark.parametrize("ngauss,nbin,cluster", [(1, 2048, 1), (4, 2048, 2),
                                                (19, 2048, 0), (19, 8192, 0)])
def test_gauss_ft_graph_replay_same_bits(card, ngauss, nbin, cluster):
    """A call of each epilogue captured in a CUDA graph and replayed three
    times gives the eager call's bits every time, on both of epilogue B's
    paths (on chip in clusters of one and two blocks, staged)."""
    K = card
    args = _gauss_ft_inputs(ngauss, 2, "000", "joined_tau", 64, nbin)
    assert K.gauss_ft_path(ngauss, 2, 64, nbin)["cluster"] == cluster
    work = K.GaussFtWork(*args[1:])
    want = [t.clone() for t in K.gauss_ft_normal(*args, work=work)]
    want_f = K.gauss_ft_sse(*args, work=work)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = K.gauss_ft_normal(*args, work=work)
        f = K.gauss_ft_sse(*args, work=work)
    for _ in range(3):
        for t in outs:
            t.zero_()
        f.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(outs, want):
            assert torch.equal(a, b)
        assert torch.equal(f, want_f)


def test_gauss_ft_nan_sizes_and_limits_on_the_card(card):
    """A power law's amp0 at its 0 bound gives NaN in every g and J^T J
    entry and a finite f, as the plain version; pp_gauss_ft_sizes gives
    the path, the staged rows, the shared memory and the tree as the
    source's geometry says (four components over [512, 2048] on chip in
    a two-block cluster, no staged rows; 19 staged); the
    wrappers raise past the component limit and at widths the transforms
    do not take."""
    K = card
    args = list(_gauss_ft_inputs(2, 2, "000", "tau", 32, 512))
    x = args[0].clone()
    x[1, 6] = 0.0
    args[0] = x
    got, want = K.gauss_ft_normal(*args), K.gauss_ft_normal_plain(*args)
    assert torch.isnan(got[1][1]).all() and torch.isnan(got[2][1]).all()
    assert torch.isfinite(got[0]).all()
    assert not torch.isnan(got[1][0]).any()
    assert max(_gauss_ft_gaps(got, want)) <= GAUSS_FT_TOL
    sz = K.gauss_ft_sizes(4, 2, 512, 2048)
    assert (sz["cluster"], sz["batch"], sz["staged"]) == (2, 3, 0)
    assert sz["smem_onchip"] == K._gauss_ft_onchip_smem(4, 2048, 2, 3)
    sz = K.gauss_ft_sizes(19, 2, 512, 2048)
    P = 6 * 19 + 3 + 4
    assert (sz["cluster"], sz["staged"]) == (0, 3 * 19 + 3)
    assert sz["width"] == P * (P + 1) // 2 + P + 2
    assert sz["smem_rows"] == 16 * 2048 + 16 * 1025 + 40
    assert sz["smem_gram"] == 8 * (10 * 19 + 2 * 64 * 36 + 4) + 4 * (19 + 4)
    assert K.gauss_ft_sizes(1, 0, 512, 2048, normal=False)["smem_sse"] == \
        16 * 2048 + 40
    for bad in ((K.GAUSS_FT_MAX_NGAUSS + 1, 0, 8, 256),
                (1, 0, 8, 2000), (1, 0, 8, 16384), (1, 0, 8, 32)):
        with pytest.raises(ValueError, match="no launch"):
            K.gauss_ft_sizes(*bad)
    wide = list(_gauss_ft_inputs(1, 1, "000", "tau", 8, 1000))
    for fn in (K.gauss_ft_normal, K.gauss_ft_sse):
        with pytest.raises(ValueError, match="power of two"):
            fn(*wide)


def test_gauss_ft_fit_card_matches_cpu(card):
    """fit_gaussian_portrait of a scattered, joined portrait (tau and the
    scattering index fitted, two join groups) through K10 on the card
    (FIT_ROUTES["spectral"], both epilogues launched) against the CPU's
    plain version: parameters within _z_floor(chi2) of their errors, chi2
    1e-9 relative, rc equal."""
    from pulseportraiture_tpu_torch.fit import gauss as fg

    args0 = _gauss_ft_inputs(3, 1, "000", "joined_tau", 64, 1024)
    nparam = 2 + 6 * 3
    x, data = args0[0][0].cpu().numpy(), args0[1].cpu().numpy()
    nbin = data.shape[1]
    errs = np.outer(args0[2][:, 0].cpu().numpy(), np.ones(nbin))
    init = x[:nparam] * np.where(np.arange(nparam) % 2, 1.01, 0.99)
    nchan = data.shape[0]
    joins = [np.arange(0, nchan // 3), np.arange(nchan // 3, nchan)]
    jargs = [joins, np.array([x[nparam + 1], 0.0, -0.019, 0.0]),
             np.array([0, 1, 1, 1])]
    args = ("000", data, init, -3.8, errs, np.ones(nparam), True,
            np.arange(nbin) / nbin, args0[4].cpu().numpy(), 1500.0, jargs,
            0.005)
    K = card
    K.reset_launches()
    routes = dict(fg.FIT_ROUTES)
    gpu = fg.fit_gaussian_portrait(*args, device="cuda")
    assert K.LAUNCHES["gauss_ft_normal"] > 0 and K.LAUNCHES["gauss_ft_sse"] > 0
    assert fg.FIT_ROUTES["spectral"] == routes["spectral"] + 1
    cpu = fg.fit_gaussian_portrait(*args, device="cpu")
    assert fg.FIT_ROUTES["jacfwd"] == routes["jacfwd"]
    fin = np.isfinite(cpu.fit_errs) & (cpu.fit_errs > 0)
    assert fin.sum() >= len(init) + 2
    gap = np.abs(gpu.fitted_params - cpu.fitted_params)[fin] \
        / cpu.fit_errs[fin]
    print("K10 fit: chi2 %r gap/err %r" % (cpu.chi2, gap.max()))
    assert gap.max() <= _z_floor(cpu.chi2)
    assert abs(gpu.chi2 - cpu.chi2) <= 1e-9 * cpu.chi2
    assert gpu.return_code == cpu.return_code


# -- K11 (csrc/noisefit.cu) and K12 (csrc/synth.cu) ----------------------------

def _k11_rows(nbin, n, seed=12):
    """Pulses on white noise, white noise, two zeroed rows and a unit
    impulse (a flat power spectrum: every b = 0 point ties)."""
    rng = np.random.default_rng(seed)
    ph = (np.arange(nbin) + 0.5) / nbin
    x = rng.standard_normal((n, nbin))
    m = (2 * n) // 3
    x[:m] += rng.uniform(1.0, 50.0, (m, 1)) * np.exp(
        -0.5 * ((ph - 0.4) / rng.uniform(0.002, 0.05, (m, 1))) ** 2)
    x[[1, n - 2]] = 0.0
    x[n - 1] = 0.0
    x[n - 1, 0] = 1.0
    return torch.as_tensor(x)


K11_CASES = [("exp_dc", 2048, 600, 20), ("half_tri", 2048, 600, 20),
             ("exp_dc", 64, 300, 20), ("half_tri", 512, 300, 20),
             ("exp_dc", 8192, 64, 20), ("half_tri", 32768, 12, 20),
             ("half_tri", 2048, 300, 27), ("exp_dc", 65536, 12, 20),
             ("half_tri", 131072, 6, 23)]


@pytest.mark.parametrize("fn,nbin,n,Ns", K11_CASES)
def test_noise_fit_kernel_matches_plain_on_the_card(card, fn, nbin, n, Ns):
    """K11 against its plain version on the card, from the spectrum and
    from the power: cutoffs equal but for ties (chip_smoke.k11_ties: none
    expected, a fault never), noise within 1e-12 relative where the
    cutoffs agree (the zeroed rows' 0, a_0's cutoff there and on the flat
    power), one launch a call, the same bits twice; a grid of more than 20
    points, and rows whose power does not fit shared memory (65,536 bins
    and more), among the cases."""
    K = card
    dev = _k11_rows(nbin, n).to(DEVICE)
    X = torch.fft.rfft(dev, dim=-1)

    def outs():
        return (torch.empty(n, dtype=torch.float64, device=DEVICE),
                torch.empty(n, dtype=torch.int64, device=DEVICE))

    got, again, want = outs(), outs(), outs()
    n0 = K.LAUNCHES["noise_fit"]
    K.noise_fit(X, nbin, fn, 1.1, Ns, *got)
    K.noise_fit(X, nbin, fn, 1.1, Ns, *again)
    assert K.LAUNCHES["noise_fit"] == n0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    K.noise_fit_plain(X, nbin, fn, 1.1, Ns, *want)
    ties, faults = _chip_smoke().k11_ties(X, nbin, fn, Ns, got[1], want[1])
    assert faults == 0 and ties == 0
    same = got[1] == want[1]
    zero = want[0] == 0
    assert torch.equal(got[0] == 0, zero) and int(zero.sum()) == 2
    ok = same & ~zero
    assert float(((got[0] - want[0]).abs()[ok] / want[0][ok]).max()) <= 1e-12
    from pulseportraiture_tpu_torch.ops import noise

    kc0 = int(noise._kc_grid(nbin // 2 + 1, fn, Ns, DEVICE).kc[0])
    assert int(got[1][n - 1]) == kc0 and int(got[1][1]) == kc0
    # the power as input: find_kc's route
    P = (X * X.conj()).real / nbin
    kc_k = K.noise_fit(P, None, fn, Ns=Ns)[1]
    assert torch.equal(kc_k, want[1])


def test_noise_fit_estimators_launch_k11(card, archive, monkeypatch):
    """get_noise_fit, find_kc, get_noise(method="fit"), get_SNR and
    normalize_portrait with noise_method="fit", and load_data(noise_method=
    "fit") on the card launch K11 (its plain version made to raise), and
    agree with the CPU: cutoffs equal, noise within 1e-12 relative."""
    from pulseportraiture_tpu_torch.io.archive import load_data
    from pulseportraiture_tpu_torch.ops import noise
    from pulseportraiture_tpu_torch.ops.normalize import normalize_portrait

    K = card
    host = _k11_rows(1024, 200)
    want_n, want_kc = noise.get_noise_fit(host), noise.find_kc(
        noise._power(host)[1], fn="half_tri")
    cpu_load = load_data(archive[1], noise_method="fit", device="cpu")

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(K, "noise_fit_plain", refuse)
    dev = host.to(DEVICE)
    n0 = K.LAUNCHES["noise_fit"]
    got_n = noise.get_noise_fit(dev).cpu()
    got_kc = noise.find_kc(noise._power(dev)[1], fn="half_tri").cpu()
    noise.get_noise(dev, method="fit")
    noise.get_SNR(dev, noise_method="fit")
    normalize_portrait(dev.reshape(4, 50, -1), "rms", noise_method="fit")
    assert K.LAUNCHES["noise_fit"] == n0 + 5
    assert torch.equal(got_kc, want_kc)
    ok = want_n != 0
    assert torch.equal(got_n == 0, ~ok)
    assert float(((got_n - want_n).abs()[ok] / want_n[ok]).max()) <= 1e-12
    n0 = K.LAUNCHES["noise_fit"]
    card_load = load_data(archive[1], noise_method="fit", device=DEVICE)
    assert K.LAUNCHES["noise_fit"] > n0
    a, b = np.asarray(card_load.noise_stds), np.asarray(cpu_load.noise_stds)
    live = b != 0
    assert np.array_equal(a == 0, ~live)
    assert np.abs(a - b)[live].max() <= 1e-12 * b[live].max()


def test_noise_fit_limits_on_the_card(card):
    """Ns beyond NOISE_FIT_MAX_NS raises before a launch; a row of 40,000
    harmonics (its power re-read from device memory) and a 60-point grid
    (three passes of shape accumulators) launch, a constant power giving
    a_0's cutoff as the plain version does."""
    K = card
    X = torch.fft.rfft(_k11_rows(256, 8).to(DEVICE), dim=-1)
    n0 = K.LAUNCHES["noise_fit"]
    with pytest.raises(ValueError, match="Ns"):
        K.noise_fit(X, 256, Ns=K.NOISE_FIT_MAX_NS + 1)
    assert K.LAUNCHES["noise_fit"] == n0
    P = torch.full((2, 40000), 3.0, dtype=torch.float64, device=DEVICE)
    assert torch.equal(K.noise_fit(P, None)[1], K.noise_fit_plain(P, None)[1])
    small = torch.full((1, 200), 3.0, dtype=torch.float64, device=DEVICE)
    kc = K.noise_fit(small, None, "half_tri", Ns=60)[1]
    assert K.LAUNCHES["noise_fit"] == n0 + 2
    assert int(kc[0]) == 1                    # floor(a_0) = 1
    assert torch.equal(kc, K.noise_fit_plain(small, None, "half_tri",
                                             Ns=60)[1])
    torch.cuda.synchronize()


def _k12_args(nbin, B, nchan, scat, scint, noisy, weighted, seed=3):
    """synth_rows' arguments on the card: a random model spectrum, shifts,
    a scattering spectrum, a scintillation pattern, scales, sigma, weights
    (each as asked), and out holding standard normals."""
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=DEVICE)
    nh = nbin // 2 + 1
    model = torch.randn((nchan, nbin), generator=g, **f64)
    M = torch.fft.rfft(model, dim=-1)
    shifts = torch.rand((B, nchan), generator=g, **f64) * 4.0 - 2.0
    T = None
    if scat:
        tau = torch.rand((nchan, 1), generator=g, **f64) * 20.0
        k = torch.arange(nh, **f64)
        T = (1.0 / (1.0 + 2j * math.pi * k * tau / nbin)).contiguous()
    pattern = torch.rand((B, nchan), generator=g, **f64) if scint else None
    scales = torch.rand(nchan, generator=g, **f64) + 0.5
    sigma = torch.rand(nchan, generator=g, **f64) if noisy else None
    w = (torch.rand(nchan, generator=g, **f64) > 0.2).double() \
        if weighted else None
    out = torch.randn((B, nchan, nbin), generator=g, **f64)
    return [M, shifts, T, pattern, scales, sigma, w, out]


K12_CASES = [(64, 3, 16, False, False, False, False),
             (512, 3, 64, True, True, True, True),
             (2048, 4, 64, True, False, True, False),
             (2048, 2, 32, False, True, False, True),
             (8192, 2, 16, True, True, True, True),
             (1000, 3, 32, True, True, True, True),
             (999, 2, 16, True, False, True, False),
             (32, 3, 8, False, True, True, True),
             (16384, 2, 8, True, True, True, False)]


@pytest.mark.parametrize("case", K12_CASES, ids=lambda c: "nbin%d" % c[0])
def test_synth_rows_kernel_matches_plain_on_the_card(card, case):
    """K12 against its plain version on the same inputs and the same
    noise, on its onchip path and (1000, 999, 32 and 16384 bins) its cufft
    path: every row within 1e-13 of its peak, a zero-weighted row 0, one
    launch a call counted on its path, the same bits twice."""
    K = card
    a, b, c = (_k12_args(*case) for _ in range(3))
    n0, p0 = K.LAUNCHES["synth_rows"], dict(K.SYNTH_PATHS)
    K.synth_rows(*a)
    K.synth_rows(*b)
    K.synth_rows_plain(*c)
    assert K.LAUNCHES["synth_rows"] == n0 + 2
    path = K.synth_path(case[0])
    assert K.SYNTH_PATHS[path] == p0[path] + 2
    assert torch.equal(a[-1], b[-1])
    got, want = a[-1].cpu(), c[-1].cpu()
    peak = want.abs().amax(dim=-1, keepdim=True)
    assert bool(((got - want).abs() <= 1e-13 * peak).all()), \
        float(((got - want).abs() / peak.clamp(min=1e-300)).max())
    if a[6] is not None:
        assert bool((got[:, a[6].cpu() == 0] == 0).all())


def test_make_fake_routes_on_the_card(card, monkeypatch):
    """make_fake_dataset and make_fake_portrait on the card: K12 launched a
    block and counted on its path (onchip at 1024 bins, cufft at 1000);
    K12 and its plain version from one generator seed within 1e-13 of each
    row's peak at both widths (so the same noise draws), and bit-equal
    with a zero model."""
    from pulseportraiture_tpu_torch.pipelines import synth

    K = card
    MODEL = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
    ZERO = MODEL[:6] + [0.0, -1.2]
    monkeypatch.setattr(synth, "BLOCK_BYTES", 3 * 64 * 1024 * 8)
    kw = dict(nsub=7, nchan=64, nbin=1024, P=0.004, t_scat=1e-4, scint=True,
              noise_std=0.2, device=DEVICE)

    def make(params, **extra):
        return synth.make_fake_dataset(
            torch.Generator(device=DEVICE).manual_seed(9), params,
            **dict(kw, **extra)).subints.cpu()

    n0, p0 = K.LAUNCHES["synth_rows"], dict(K.SYNTH_PATHS)
    kernel, kernel0 = make(MODEL), make(ZERO)
    assert K.LAUNCHES["synth_rows"] == n0 + 6
    assert K.SYNTH_PATHS["onchip"] == p0["onchip"] + 6
    n0, p0 = K.LAUNCHES["synth_rows"], dict(K.SYNTH_PATHS)
    narrow = make(MODEL, nbin=1000)
    assert narrow.shape[-1] == 1000
    assert K.LAUNCHES["synth_rows"] == n0 + 3
    assert K.SYNTH_PATHS["cufft"] == p0["cufft"] + 3
    assert K.SYNTH_PATHS["onchip"] == p0["onchip"]
    with monkeypatch.context() as m:
        m.setattr(K, "synth_rows", K.synth_rows_plain)
        plain, plain0 = make(MODEL), make(ZERO)
        narrow_plain = make(MODEL, nbin=1000)
    assert torch.equal(kernel0, plain0)
    for got, want in ((kernel, plain), (narrow, narrow_plain)):
        peak = want.abs().amax(dim=-1, keepdim=True)
        assert bool(((got - want).abs() <= 1e-13 * peak).all())
    n0 = K.LAUNCHES["synth_rows"]
    synth.make_fake_portrait(MODEL, 64, 2048, np.linspace(1200, 1600, 64),
                             0.004, phase=0.1, device=DEVICE)
    synth.make_fake_portrait(MODEL, 64, 1000, np.linspace(1200, 1600, 64),
                             0.004, phase=0.1, device=DEVICE)
    assert K.LAUNCHES["synth_rows"] == n0 + 2
