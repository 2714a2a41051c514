"""The port's per-channel and template paths and its template builders on
the card: kernels against their plain versions.

Each test runs a path of pulseportraiture_tpu_torch on the CUDA device
twice — through the hand kernels (K1 csrc/moments.cu, K2 csrc/fftfit.cu,
K3 csrc/moments_scat.cu), then with their plain PyTorch versions swapped
in on the same device — and holds the two runs to the port's parity bar:
TOAs within 1 ns, equal rc and nfeval, equal zap lists, fluxes within
1e-9 relative (1e-7 with the narrowband scattering fits, whose scales
move with the ~1e-8 differences in tau of fits the data barely
constrain, as between the port and the JAX package), post-fit channel
reduced chi2 within 2e-9 relative (each moves to first order with the
fitted phase, DM and scales, which converged fits leave ~1e-11 apart);
K3 alone at one channel per lane within 1e-12 of each sum's largest
magnitude; the template builders (align, spline, Gaussian) with aligned
portraits within 5e-8 of their peak and weights within 1e-9 (the bound
of the CPU parity tests against the JAX package: the (phase, DM) fits
stop at the f64 floor of their objective, ~1e-9 rot apart, and a subint
rotated that much differently moves the portrait by ~1e-8 of its peak;
read on the card: 1.5e-9), spline models within 1e-10 and Gaussian model
parameters within 1e-6 of their errors.

Readings on an H100 80GB HBM3 (700 W), kernels against plain: the
scattering fluxes 1.48e-8 (log10 tau) and 2.03e-8 (linear tau), the
template fluxes <= 9.5e-15, the reduced chi2 2.48e-10, the same in two
runs.  With the phasors of K1 and K3 taken in single precision (a wrong
kernel) they read 3.7e-5 and 3.2e-5, 7.7e-9 and 2.44e-7, and the
narrowband rc and nfeval differ; the zap lists stay equal, so only the
chi2 bound catches that fault on the zap path.  The archives are written by the port's
make_fake_pulsar.  The "fit" noise estimators and make_fake_dataset
are held to the port on the CPU: cutoffs equal, noise within 1e-12
relative, synthetic portraits within 1e-12 of their peak.  Marked
``cuda``: they skip without a card.  This file
imports no JAX, so it runs on a machine without it:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_paths.py
"""

import contextlib
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GMODEL = os.path.join(ROOT, "examples", "example.gmodel")
PAR = os.path.join(ROOT, "examples", "example.par")

pytestmark = pytest.mark.cuda
DEVICE = "cuda"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pulseportraiture_tpu_torch import _kernels

    return _kernels


@contextlib.contextmanager
def plain_kernels(K):
    """The plain versions in place of the kernels, on the card."""
    saved = K.moments, K.fftfit, K.moments_scat
    K.moments, K.fftfit, K.moments_scat = (K.moments_plain, K.fftfit_plain,
                                           K.moments_scat_plain)
    try:
        yield
    finally:
        K.moments, K.fftfit, K.moments_scat = saved


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
