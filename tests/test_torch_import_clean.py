"""Import hygiene of the PyTorch port and its device policy.

Importing every module of pulseportraiture_tpu_torch (and chip_smoke.py)
in a fresh interpreter must pull in neither JAX nor the JAX package, and
must not initialize CUDA; and the entry points must refuse to run when
no CUDA device exists unless the caller asked for the CPU.  The survey
runner's modules (runner/, parallel/, cli/ppsurvey) are also imported by
name, and the worker command line ``ppsurvey supervise`` builds runs the
port's ppsurvey without importing JAX.
"""

import json
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


def test_obs_and_fault_modules_walked():
    """The observability layer, the fault-injection harness and the
    ppusage CLI are among the modules the import check walks (no JAX,
    no CUDA initialized by importing them)."""
    import pkgutil

    import pulseportraiture_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(
        pulseportraiture_tpu_torch.__path__, "pulseportraiture_tpu_torch.")}
    prefix = "pulseportraiture_tpu_torch."
    assert {prefix + m for m in (
        "obs", "obs.core", "obs.devtime", "obs.flight", "obs.health",
        "obs.manifest", "obs.memory", "obs.merge", "obs.metrics",
        "obs.monitor", "obs.quality", "obs.trace", "obs.tracing",
        "obs.usage", "testing", "testing.faults", "cli.ppusage")} <= names


# the survey runner, its process layer and its CLI: imported by name, so
# a module that failed to exist would fail here, not just be skipped
_SURVEY_MODULES = [
    "pulseportraiture_tpu_torch.runner",
    "pulseportraiture_tpu_torch.runner.plan",
    "pulseportraiture_tpu_torch.runner.queue",
    "pulseportraiture_tpu_torch.runner.execute",
    "pulseportraiture_tpu_torch.runner.workloads",
    "pulseportraiture_tpu_torch.runner.prefetch",
    "pulseportraiture_tpu_torch.runner.warm",
    "pulseportraiture_tpu_torch.runner.respawn",
    "pulseportraiture_tpu_torch.runner.supervisor",
    "pulseportraiture_tpu_torch.parallel",
    "pulseportraiture_tpu_torch.parallel.multihost",
    "pulseportraiture_tpu_torch.cli.ppsurvey",
]

_CHECK_SURVEY = """
import importlib, sys
sys.path.insert(0, %r)
for name in %r:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
             or m == 'pulseportraiture_tpu'
             or m.startswith('pulseportraiture_tpu.'))
assert not bad, bad
import torch
assert not torch.cuda.is_initialized()
assert not torch.distributed.is_initialized()
print("ok")
"""


def test_survey_modules_import_no_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK_SURVEY % (ROOT, _SURVEY_MODULES)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


# run a supervise worker's command line (argv after "-m module") inside
# this interpreter and report whether it pulled in JAX or the JAX package
_CHECK_WORKER = """
import json, runpy, sys
sys.path.insert(0, %r)
module, argv = sys.argv[1], sys.argv[2:]
sys.argv = [module] + argv
try:
    runpy.run_module(module, run_name="__main__")
except SystemExit as e:
    rc = e.code
else:
    rc = 0
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
             or m == 'pulseportraiture_tpu'
             or m.startswith('pulseportraiture_tpu.'))
print(json.dumps({"rc": rc, "bad": bad}))
"""


def test_supervise_worker_command_imports_no_jax(tmp_path):
    """The command line ``ppsurvey supervise`` gives each worker runs the
    port's ppsurvey, with the supervisor's --device, and the worker
    imports nothing of JAX while it fits."""
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
    from pulseportraiture_tpu_torch.runner.plan import plan_survey
    from pulseportraiture_tpu_torch.runner.supervisor import Supervisor

    gm = os.path.join(ROOT, "examples", "example.gmodel")
    arch = str(tmp_path / "a.fits")
    make_fake_pulsar(gm, os.path.join(ROOT, "examples", "example.par"),
                     arch, nsub=2, nchan=8, nbin=64, noise_stds=0.05,
                     seed=3, quiet=True)
    wd = str(tmp_path / "wd")
    os.makedirs(wd)
    plan_survey([arch], modelfile=gm).save(os.path.join(wd, "plan.json"))
    sup = Supervisor(wd, max_workers=1, device="cpu")
    cmd = sup._worker_cmd(sup.slots[0]) + ["--no_bary"]
    assert cmd[0] == sys.executable and cmd[1] == "-m"
    assert cmd[2] == "pulseportraiture_tpu_torch.cli.ppsurvey"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK_WORKER % ROOT] + cmd[2:],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "bad": []}


def test_ppsurvey_without_device_raises_without_cuda(monkeypatch, tmp_path):
    from pulseportraiture_tpu_torch.cli import ppsurvey
    from pulseportraiture_tpu_torch.runner.execute import run_survey
    from pulseportraiture_tpu_torch.runner.warm import warm_plan

    _no_cuda(monkeypatch)
    gm = os.path.join(ROOT, "examples", "example.gmodel")
    wd = str(tmp_path / "wd")
    assert ppsurvey.main(["plan", "-d", gm, "-m", gm, "-w", wd]) == 0
    plan = os.path.join(wd, "plan.json")
    for argv in (["run", "-w", wd], ["warm", "-w", wd]):
        with pytest.raises(RuntimeError):
            ppsurvey.main(argv)
    with pytest.raises(RuntimeError):
        run_survey(plan, wd)
    with pytest.raises(RuntimeError):
        warm_plan(plan, gm)


# the TOA service, its fleet router and their CLIs: imported by name
_SERVICE_MODULES = [
    "pulseportraiture_tpu_torch.service",
    "pulseportraiture_tpu_torch.service.batcher",
    "pulseportraiture_tpu_torch.service.daemon",
    "pulseportraiture_tpu_torch.service.server",
    "pulseportraiture_tpu_torch.service.router",
    "pulseportraiture_tpu_torch.service.warm",
    "pulseportraiture_tpu_torch.cli.ppserve",
    "pulseportraiture_tpu_torch.cli.pprouter",
    "pulseportraiture_tpu_torch.cli.pploadgen",
]


def test_service_modules_import_no_jax():
    """The service modules and the ppserve / pprouter / pploadgen CLIs
    import no JAX and touch no device on import."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK_SURVEY % (ROOT, _SERVICE_MODULES)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ok"


def test_service_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """TOAService, ``ppserve start`` / ``warm`` and ``pprouter start``
    (and the FleetRouter under it) refuse to run without a CUDA device
    unless asked for the CPU, before they serve or spawn anything."""
    from pulseportraiture_tpu_torch.cli import ppserve, pprouter
    from pulseportraiture_tpu_torch.runner.plan import plan_survey
    from pulseportraiture_tpu_torch.service import FleetRouter, TOAService

    _no_cuda(monkeypatch)
    gm = os.path.join(ROOT, "examples", "example.gmodel")
    wd = str(tmp_path / "wd")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOAService(gm, wd)
    with pytest.raises(RuntimeError):
        FleetRouter(gm, str(tmp_path / "fleet"), n_daemons=1)
    plan = str(tmp_path / "plan.json")
    plan_survey([], modelfile=gm).save(plan)
    for argv in (["start", "-w", wd, "-m", gm],
                 ["warm", "-w", wd, "-m", gm, "--plan", plan]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ppserve.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pprouter.main(["start", "-w", str(tmp_path / "fleet"), "-m", gm,
                       "-n", "1"])
    assert not os.path.exists(os.path.join(wd, "ppserve.sock"))
    assert not os.path.exists(str(tmp_path / "fleet" / "d0"))
    # asking for the CPU is honoured
    svc = TOAService(gm, wd, device="cpu")
    assert svc.device == torch.device("cpu")
    assert FleetRouter(gm, str(tmp_path / "f2"), n_daemons=1,
                       device="cpu").device == torch.device("cpu")


# run the router's daemon command line (argv after "-m module") inside
# this interpreter: a helper thread submits one archive over the
# daemon's socket and then asks it to drain; report the exit code, the
# request's state and whether JAX or the JAX package was imported
_CHECK_DAEMON = """
import json, os, runpy, sys, threading, time
sys.path.insert(0, %r)
module, sock, archive = sys.argv[1:4]
sys.argv = [module] + sys.argv[4:]
seen = {}

def drive():
    from pulseportraiture_tpu_torch.service import client_request
    t0 = time.time()
    while not os.path.exists(sock) and time.time() - t0 < 120:
        time.sleep(0.05)
    r = client_request(sock, {"op": "submit", "tenant": "t",
                              "archive": archive, "wait": True,
                              "timeout_s": 120}, timeout=150)
    seen["state"] = r.get("state")
    client_request(sock, {"op": "shutdown"}, timeout=30)

th = threading.Thread(target=drive, daemon=True)
th.start()
try:
    runpy.run_module(module, run_name="__main__")
except SystemExit as e:
    rc = e.code
else:
    rc = 0
th.join(30)
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
             or m == 'pulseportraiture_tpu'
             or m.startswith('pulseportraiture_tpu.'))
print(json.dumps({"rc": rc, "bad": bad, "state": seen.get("state")}))
"""


def test_router_daemon_command_imports_no_jax(tmp_path):
    """The command line a FleetRouter spawns each daemon with runs the
    port's ppserve with the router's --device; that daemon serves a
    request and drains to exit 0 without importing JAX."""
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
    from pulseportraiture_tpu_torch.service import FleetRouter

    gm = os.path.join(ROOT, "examples", "example.gmodel")
    arch = str(tmp_path / "a.fits")
    make_fake_pulsar(gm, os.path.join(ROOT, "examples", "example.par"),
                     arch, nsub=2, nchan=8, nbin=64, noise_stds=0.05,
                     seed=3, quiet=True)
    router = FleetRouter(gm, str(tmp_path / "fleet"), n_daemons=1,
                         daemon_args=["--no_bary"], device="cpu")
    wd = router._daemons[0].workdir
    cmd = router._daemon_cmd() + ["-w", wd]
    assert cmd[0] == sys.executable and cmd[1] == "-m"
    assert cmd[2] == "pulseportraiture_tpu_torch.cli.ppserve"
    assert cmd[cmd.index("--device") + 1] == "cpu"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK_DAEMON % ROOT, cmd[2],
         router._daemons[0].socket, arch] + cmd[3:],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "bad": [], "state": "done"}, proc.stderr
