"""Import hygiene of the PyTorch port and its device policy.

Importing every module of pulseportraiture_tpu_torch (and chip_smoke.py)
in a fresh interpreter must pull in neither JAX nor the JAX package, and
must not initialize CUDA; and the entry points must refuse to run when
no CUDA device exists unless the caller asked for the CPU.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, %r)
import pulseportraiture_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    pulseportraiture_tpu_torch.__path__, 'pulseportraiture_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
             or m == 'pulseportraiture_tpu'
             or m.startswith('pulseportraiture_tpu.'))
assert not bad, bad
import torch
assert not torch.cuda.is_initialized()
print(len(names))
"""


def test_port_imports_no_jax_and_touch_no_device():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", _CHECK % ROOT],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 25  # every module was walked


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_fit_without_device_raises_without_cuda(monkeypatch):
    from pulseportraiture_tpu_torch.fit.portrait import \
        fit_portrait_full_batch

    _no_cuda(monkeypatch)
    data = np.random.default_rng(0).standard_normal((2, 4, 32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_portrait_full_batch(data, data[0], np.zeros(5), 0.005,
                                np.linspace(1200.0, 1600.0, 4))


def test_entry_points_without_device_raise_without_cuda(monkeypatch,
                                                        tmp_path):
    from pulseportraiture_tpu_torch.cli import pptoas
    from pulseportraiture_tpu_torch.config import default_device
    from pulseportraiture_tpu_torch.fit.phase_shift import fit_phase_shift
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    _no_cuda(monkeypatch)
    gm = os.path.join(ROOT, "examples", "example.gmodel")
    with pytest.raises(RuntimeError):
        default_device()
    with pytest.raises(RuntimeError):
        fit_phase_shift(np.ones((2, 16)), np.ones(16))
    with pytest.raises(RuntimeError):
        GetTOAs([], gm)
    with pytest.raises(RuntimeError):
        pptoas.main(["-d", gm, "-m", gm, "-o", str(tmp_path / "x.tim")])
    # asking for the CPU is honoured
    assert GetTOAs([], gm, device="cpu").device == torch.device("cpu")


def test_kernel_wrappers_check_their_inputs():
    from pulseportraiture_tpu_torch import _kernels

    cross = torch.zeros((2, 3, 8), dtype=torch.complex128)
    sh = torch.zeros((2, 3), dtype=torch.float64)
    with pytest.raises(TypeError):
        _kernels.moments(cross.to(torch.complex64), sh, sh)
    with pytest.raises(ValueError):
        _kernels.moments(cross, sh[:1], sh)
    with pytest.raises(ValueError):
        _kernels.moments(cross.transpose(0, 1).contiguous().transpose(0, 1),
                         sh, sh)
    with pytest.raises(ValueError):
        _kernels.fftfit(cross[:, 0], torch.zeros(3, dtype=torch.float64),
                        -0.5, 0.5, 10, 2)


def test_smoke_script_refuses_without_cuda():
    """chip_smoke.py exits non-zero and prints no result without a card."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT,
                                                        "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Run on a machine with the card (no JAX needed there):
    python -m pytest -m cuda --noconftest tests/test_torch_import_clean.py"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pulseportraiture_tpu_torch import _kernels

    gen = torch.Generator(device="cuda").manual_seed(1)
    cross = torch.randn((4, 16, 128), generator=gen, device="cuda",
                        dtype=torch.complex128)
    sh = torch.rand((4, 16), generator=gen, device="cuda",
                    dtype=torch.float64) * 100.0
    w = torch.ones((4, 16), device="cuda", dtype=torch.float64)
    torch.testing.assert_close(_kernels.moments(cross, sh, w),
                               _kernels.moments_plain(cross, sh, w),
                               rtol=1e-12, atol=1e-12)
    cr = cross[:, 0].contiguous()
    got = _kernels.fftfit(cr, w[:, 0].contiguous(), -0.5, 0.5, 50, 4)
    want = _kernels.fftfit_plain(cr, w[:, 0].contiguous(), -0.5, 0.5, 50, 4)
    for g, p in zip(got, want):
        torch.testing.assert_close(g, p, rtol=1e-10, atol=1e-12)
    # grids that tie (harmonic 2 only: ties at 0/32 and 16/48 of 64 over
    # [-0.5, 0.5)), a NaN row, and over [-0.25, 0.25) a grid that holds a
    # NaN after -inf values (harmonic 1 = i*inf: sin = 0 exactly at point 32
    # only; over [-0.5, 0.5) sincospi and cos(2 pi x) disagree on whether
    # sin(pi) is 0, so that row is left out there)
    hand = torch.zeros((4, 3), dtype=torch.complex128, device="cuda")
    hand[0, 2], hand[1, 2] = 1.0, -1.0
    hand[2] = math.nan
    hand[3, 1] = complex(0.0, math.inf)
    ones = torch.ones(4, dtype=torch.float64, device="cuda")
    for lo, hi, rows in ((-0.5, 0.5, 3), (-0.25, 0.25, 4)):
        for it in (0, 6):
            got = _kernels.fftfit(hand[:rows], ones[:rows], lo, hi, 64, it)
            want = _kernels.fftfit_plain(hand[:rows], ones[:rows], lo, hi,
                                         64, it)
            for g, p in zip(got, want):
                torch.testing.assert_close(g, p, rtol=1e-12, atol=1e-12,
                                           equal_nan=True)


def _pulses(N, nbin, seed):
    """N noisy copies of one pulse at random phases (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.35) / 0.02) ** 2)
    k = np.arange(nbin // 2 + 1)
    ph = rng.uniform(-0.45, 0.45, N)
    data = np.fft.irfft(np.fft.rfft(prof) * np.exp(
        2j * np.pi * ph[:, None] * k), nbin, axis=-1)
    data += 0.05 * rng.standard_normal((N, nbin))
    cross = np.fft.rfft(data, axis=-1) * np.conj(np.fft.rfft(prof))
    cross[:, 0] = 0.0
    return cross, np.full(N, 1.0 / (0.05 ** 2 * nbin / 2))


# N picks K2's launch shapes: 128 x 128 grid tiles (1000 at Ns 2048),
# 64 x 64 tiles with K over clusters of 8 (1, 17, 1000), 4 (3000), 2 (5000)
# or 1 (9000) blocks; 4 (N <= 528), 2 or 1 (N > 2112) warps per profile.
@pytest.mark.cuda
@pytest.mark.parametrize("N,nharm,Ns,lo,hi,newton_iter,nan_row", [
    (1, 1025, 100, -0.5, 0.5, 6, False),
    (17, 65, 100, -0.25, 0.25, 6, True),
    (1000, 1025, 100, -0.5, 0.5, 6, False),
    (1000, 1025, 2048, -0.5, 0.5, 6, False),
    (17, 1025, 2048, -0.25, 0.25, 0, True),
    (1000, 65, 100, -0.25, 0.25, 0, False),
    (3000, 129, 100, -0.5, 0.5, 6, True),
    (5000, 129, 100, -0.25, 0.25, 6, False),
    (9000, 129, 100, -0.5, 0.5, 6, False),
])
def test_fftfit_kernel_matches_plain_on_the_card(N, nharm, Ns, lo, hi,
                                                 newton_iter, nan_row):
    """K2 at ragged N, three widths, two grids, the narrowband bounds,
    with and without Newton steps, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from pulseportraiture_tpu_torch import _kernels

    cross, w = _pulses(N, 2 * (nharm - 1), seed=N + nharm)
    if nan_row:
        cross[N // 2] = np.nan
    cr = torch.as_tensor(cross, device="cuda")
    w = torch.as_tensor(w, device="cuda")
    want = _kernels.fftfit_plain(cr, w, lo, hi, Ns, newton_iter)
    got = _kernels.fftfit(cr, w, lo, hi, Ns, newton_iter)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-9,
                               equal_nan=True)
    for g, p in zip(got[1:], want[1:]):
        ok = torch.isfinite(p)
        assert torch.equal(torch.isnan(g), torch.isnan(p))
        err = (g[ok] - p[ok]).abs().max() / p[ok].abs().max()
        assert float(err) <= 1e-12, float(err)


def test_template_builders_walked_and_refuse_without_cuda(monkeypatch,
                                                          tmp_path):
    """The template-building modules are among those the import check
    walks, and their entry points refuse to run without a CUDA device
    unless asked for the CPU."""
    import pkgutil

    import pulseportraiture_tpu_torch
    from pulseportraiture_tpu_torch.cli import ppalign, ppgauss, ppspline
    from pulseportraiture_tpu_torch.dataportrait import DataPortrait
    from pulseportraiture_tpu_torch.fit.lm import lm_solve
    from pulseportraiture_tpu_torch.pipelines.align import align_archives

    names = {m.name for m in pkgutil.walk_packages(
        pulseportraiture_tpu_torch.__path__, "pulseportraiture_tpu_torch.")}
    prefix = "pulseportraiture_tpu_torch."
    assert {prefix + m for m in (
        "pipelines.align", "ops.wavelet", "ops.pca", "ops.powlaw",
        "fit.lm", "fit.powlaw", "fit.gauss", "dataportrait",
        "models.spline", "models.gauss", "cli.ppalign", "cli.ppspline",
        "cli.ppgauss")} <= names
    _no_cuda(monkeypatch)
    gm = os.path.join(ROOT, "examples", "example.gmodel")
    meta = tmp_path / "m.meta"
    meta.write_text(gm + "\n")
    for cli, argv in ((ppalign, ["-M", str(meta), "-I", gm]),
                      (ppspline, ["-d", gm]), (ppgauss, ["-d", gm])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)
    with pytest.raises(RuntimeError):
        align_archives([gm], gm)
    with pytest.raises(RuntimeError):
        DataPortrait(gm)
    with pytest.raises(RuntimeError):
        lm_solve(lambda x: x, np.zeros(2))


def test_leftover_modules_walked_and_refuse_without_cuda(monkeypatch):
    """The synthetic-data factory, the timing stage, the sanitizer and the
    "fit" noise estimators are among the modules the import check walks;
    the factory's entry points refuse to run without a CUDA device unless
    asked for the CPU."""
    import pkgutil

    import pulseportraiture_tpu_torch
    from pulseportraiture_tpu_torch.pipelines import synth

    names = {m.name for m in pkgutil.walk_packages(
        pulseportraiture_tpu_torch.__path__, "pulseportraiture_tpu_torch.")}
    prefix = "pulseportraiture_tpu_torch."
    assert {prefix + m for m in ("pipelines.synth", "pipelines.timing",
                                 "debug", "ops.noise")} <= names
    _no_cuda(monkeypatch)
    model = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth.make_fake_dataset(torch.Generator(), model, nsub=1, nchan=2,
                                nbin=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synth.make_fake_portrait(model, 2, 16, [1400.0, 1500.0], 0.004)
    assert synth.make_fake_dataset(torch.Generator(), model, nsub=1,
                                   nchan=2, nbin=16,
                                   device="cpu").subints.shape == (1, 2, 16)
