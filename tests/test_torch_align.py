"""The align-and-average path (ppalign): the port against the JAX package.

Archives: three epochs of 2 subints x 256 bins from the JAX package's
make_fake_pulsar, two with 16 channels (one channel zapped in one) and
one with 8 (the nearest-frequency ``chan_map`` path), each with its own
injected phase and DM offset.  The port runs on the CPU
(``device="cpu"``: the plain versions of kernels K1 and K2).

Pass criteria:

* ``_rotate_batch`` within 1e-12 of the largest magnitude;
* the block accumulation (rotate, weights, sum; both the one-template
  and the ``chan_map`` branch), given the reference's own fit results:
  portrait and weights within 1e-12;
* ``align_archives`` and the ppalign CLI end to end: portrait within
  5e-8 and weights within 1e-9 of their largest magnitude.  The bound
  is the fits', not the accumulation's: the (phase, DM) fits of the two
  packages agree to the f64 floor of their objective near its minimum
  (~1e-9 rot in phase and ~1e-10 relative in DM on this data, as
  tests/test_torch_fit.py holds them to 1e-9), and a subint rotated
  1e-9 rot differently moves a pulse of these widths by ~1e-8 of its
  peak (measured: <= 8.2e-9 and 1.4e-10);
* ``average_archives`` with and without -P: within 1e-12;
* archives read back from PSRFITS: as above, plus one step of the
  file's int16 encoding (each profile's span / 32766), since two values
  a hair apart can round to neighbouring codes.
"""

import os

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.cli import ppalign as jcli
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import load_data, make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.pipelines import align as jal
from pulseportraiture_tpu_torch.cli import ppalign as tcli
from pulseportraiture_tpu_torch.pipelines import align as tal
from pulseportraiture_tpu_torch.utils.databunch import DataBunch

EXACT_TOL = 1e-12
PORT_TOL = 5e-8
WEIGHT_TOL = 1e-9
MODEL = np.array([0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2])


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
    """The reference's fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever test
    process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _assert_same_archive(port, ref, tol):
    """Two written archives: equal weights, data within ``tol`` of the
    largest magnitude plus one int16 step of each profile."""
    a, b = load_data(ref, quiet=True), load_data(port, quiet=True)
    assert b.subints.shape == a.subints.shape
    np.testing.assert_array_equal(b.weights, a.weights)
    assert (b.DM, b.dmc) == (a.DM, a.dmc)
    step = (a.subints.max(-1) - a.subints.min(-1)) / 32766
    bound = tol * np.abs(a.subints).max() + 1.001 * step[..., None]
    assert np.all(np.abs(b.subints - a.subints) <= bound)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_align")
    gm = str(tmp / "fake.gmodel")
    write_model(gm, "fake", "000", 1500.0, MODEL, np.zeros(8, int), -4.0, 0,
                quiet=True)
    par = str(tmp / "fake.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    rng = np.random.default_rng(5)
    files = []
    for i, nchan in enumerate((16, 16, 8)):
        w = np.ones((2, nchan))
        if i == 1:
            w[:, 5] = 0.0
        out = str(tmp / ("ep_%d.fits" % i))
        make_fake_pulsar(gm, par, out, nsub=2, nchan=nchan, nbin=256,
                         nu0=1500.0, bw=400.0, tsub=30.0,
                         phase=float(rng.uniform(-0.3, 0.3)),
                         dDM=float(rng.normal(0, 1e-3)), weights=w,
                         noise_stds=0.05, dedispersed=False,
                         seed=300 + i, quiet=True)
        files.append(out)
    init = str(tmp / "init.fits")
    jal.average_archives(files[:2], init, palign=True)
    meta = str(tmp / "epochs.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    return tmp, files, init, meta


@pytest.mark.parametrize("npol", [1, 4])
def test_rotate_batch_matches_reference(npol):
    rng = np.random.default_rng(0)
    B, nchan, nbin = 5, 8, 64
    shape = (B, nchan, nbin) if npol == 1 else (B, npol, nchan, nbin)
    data = rng.standard_normal(shape)
    phis = rng.uniform(-0.5, 0.5, B)
    DMs = rng.normal(30.0, 1.0, B)
    Ps = rng.uniform(0.004, 0.006, B)
    freqs = np.sort(rng.uniform(1200.0, 1800.0, (B, nchan)), axis=-1)
    nus = rng.uniform(1300.0, 1700.0, B)
    ref = np.asarray(jal._rotate_batch(data, phis, DMs, Ps, freqs, nus))
    got = tal._rotate_batch(*(torch.as_tensor(a) for a in (
        data, phis, DMs, Ps, freqs, nus))).numpy()
    assert _rel(got, ref) <= EXACT_TOL


@pytest.mark.parametrize("palign", [False, True], ids=["plain", "P"])
def test_average_archives_matches_reference(setup, palign):
    tmp, files, _, _ = setup
    ref, port = str(tmp / "avg_ref.fits"), str(tmp / "avg_port.fits")
    jal.average_archives(files, ref, palign=palign)
    tal.average_archives(files, port, palign=palign, device="cpu")
    _assert_same_archive(port, ref, EXACT_TOL)


@pytest.mark.parametrize("files_used", [2, 3], ids=["same", "chan_map"])
def test_accumulate_given_reference_fits_matches_reference(
        setup, monkeypatch, files_used):
    """The port's blocks fed the reference's fit results (captured
    block by block): the rotations, weights and sums alone, over two
    iterations.  With the 8-channel epoch the block takes the
    row-by-row ``chan_map`` branch."""
    _, files, init, _ = setup
    fits = []
    jfit = jal.fit_portrait_full_batch

    def capture(*args, **kw):
        out = jfit(*args, **kw)
        fits.append({k: np.array(out[k]) for k in
                     ("phi", "DM", "nu_DM", "scales")})
        return out

    monkeypatch.setattr(jal, "fit_portrait_full_batch", capture)
    _, pj, wj = jal.align_archives(files[:files_used], init, niter=2,
                                   outfile=os.devnull)
    replay = iter(fits)

    def given(ports, *args, **kw):
        return DataBunch(**{k: torch.as_tensor(v, device=ports.device)
                            for k, v in next(replay).items()})

    monkeypatch.setattr(tal, "fit_portrait_full_batch", given)
    _, pt, wt = tal.align_archives(files[:files_used], init, niter=2,
                                   outfile=os.devnull, device="cpu")
    assert next(replay, None) is None       # as many blocks as the reference
    assert _rel(pt, pj) <= EXACT_TOL
    assert _rel(wt, wj) <= EXACT_TOL


@pytest.mark.parametrize("kw,files_used", [
    (dict(niter=1), 2),
    (dict(niter=2, fit_dm=False), 2),
    (dict(niter=2, norm="prof", place=0.25), 3),
    (dict(niter=1, norm="max", rot_phase=0.1), 3),
], ids=["niter1", "niter2_noDM", "chan_map_prof_place", "chan_map_max_rot"])
def test_align_archives_matches_reference(setup, kw, files_used):
    tmp, files, init, _ = setup
    ref, port = str(tmp / "al_ref.fits"), str(tmp / "al_port.fits")
    _, pj, wj = jal.align_archives(files[:files_used], init, outfile=ref,
                                   **kw)
    _, pt, wt = tal.align_archives(files[:files_used], init, outfile=port,
                                   device="cpu", **kw)
    assert pt.shape == pj.shape == (1, 16, 256)
    assert _rel(pt, pj) <= PORT_TOL
    assert _rel(wt, wj) <= WEIGHT_TOL
    _assert_same_archive(port, ref, PORT_TOL)
    assert load_data(port, quiet=True).DM == 0.0


@pytest.mark.parametrize("args", [
    ["--niter", "2", "-P"],
    ["-I", "INIT", "-s", "-N", "prof", "-r", "0.05"],
    ["-g", "0.05", "-D", "--place", "0.3"],
], ids=["average_P_niter2", "init_smooth_prof_rot", "gauss_noDM_place"])
def test_ppalign_cli_matches_reference(setup, args):
    """Both CLIs on the metafile of all three epochs: the output archives
    (and the wavelet-smoothed copy of -s) agree."""
    tmp, _, init, meta = setup
    args = [init if a == "INIT" else a for a in args]
    ref, port = str(tmp / "cli_ref.fits"), str(tmp / "cli_port.fits")
    assert jcli.main(["-M", meta, "-o", ref] + args) == 0
    assert tcli.main(["-M", meta, "-o", port, "--device", "cpu"]
                     + args) == 0
    pairs = [(ref, port)] + ([(ref + ".sm", port + ".sm")]
                             if "-s" in args else [])
    for r, p in pairs:
        _assert_same_archive(p, r, PORT_TOL)


def test_ppalign_cli_stokes_matches_reference(tmp_path):
    """-p on two four-polarization (Stokes) epochs: the average (-P) and
    the aligned archives keep all four polarizations, the shift measured
    on total intensity and applied to each."""
    gm = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      os.pardir, "examples", "example.gmodel")
    par = os.path.join(os.path.dirname(gm), "example.par")
    files = [make_fake_pulsar(gm, par, str(tmp_path / ("s%d.fits" % i)),
                              nsub=2, npol=4, nchan=16, nbin=256,
                              tsub=60.0, phase=0.1 * i, dDM=1e-3 * i,
                              noise_stds=0.05, seed=70 + i, quiet=True)
             for i in range(2)]
    meta = str(tmp_path / "stokes.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    ref, port = str(tmp_path / "ref.fits"), str(tmp_path / "port.fits")
    args = ["-M", meta, "-p", "-P", "--niter", "1"]
    assert jcli.main(args + ["-o", ref]) == 0
    assert tcli.main(args + ["-o", port, "--device", "cpu"]) == 0
    assert load_data(port, quiet=True).subints.shape == (1, 4, 16, 256)
    _assert_same_archive(port, ref, PORT_TOL)
