"""Import hygiene of the PyTorch port and its device policy.

Importing every module of pulseportraiture_tpu_torch (and chip_smoke.py)
in a fresh interpreter must pull in neither JAX nor the JAX package, and
must not initialize CUDA; and the entry points must refuse to run when
no CUDA device exists unless the caller asked for the CPU.
"""

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
