"""The synthetic-data factory of the port against the JAX package.

``pipelines/synth.py`` and ``io/archive.py::make_fake_pulsar``'s
scintillation and power-law dispersion options, on the CPU.  The two
packages draw their random numbers from different generators (the port
from torch and numpy Generators, the JAX package from jax.random), so
the portraits are held to each other without noise, or with explicit
scintillation triplets; the draws themselves are checked for their
order, reproducibility and statistics.  Pass criteria:

* add_scintillation, make_fake_portrait, make_fake_dataset (noiseless,
  explicit phases and dDMs, with and without scattering) and the data
  make_fake_pulsar unloads (captured before the PSRFITS int16 encoding)
  with explicit scint triplets and xs/Cs/nu_DM: within 1e-12 of the
  peak, the epochs and periods equal;
* make_fake_dataset's blocks do not change its result, and its fields
  are the JAX package's;
* make_fake_pulsar with ``scint=False`` keeps the port's numpy draw
  order (one noise draw per subint), so earlier archives do not move;
  ``xs`` without ``Cs`` raises in both packages.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from pulseportraiture_tpu.io import archive as jarch
from pulseportraiture_tpu.io import psrfits as jpsr
from pulseportraiture_tpu.pipelines import synth as jsyn
from pulseportraiture_tpu_torch.io import archive as tarch
from pulseportraiture_tpu_torch.io import psrfits as tpsr
from pulseportraiture_tpu_torch.pipelines import synth as tsyn

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
GM = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")
MODEL = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
TRIPLETS = [0.7, 2.5, 0.1, 0.3, 4.0, 0.6, 0.9, 1.2, 0.33]


def _peak_close(have, want, tol=1e-12):
    have = have.numpy() if isinstance(have, torch.Tensor) else have
    want = np.asarray(want)
    assert have.shape == want.shape
    np.testing.assert_allclose(have, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_add_scintillation():
    rng = np.random.default_rng(0)
    port = rng.standard_normal((3, 16, 64))
    want = np.asarray(jsyn.add_scintillation(port, params=TRIPLETS))
    _peak_close(tsyn.add_scintillation(torch.as_tensor(port),
                                       params=TRIPLETS), want)
    # one row of triplets per leading index
    rows = np.array([TRIPLETS, TRIPLETS[3:] + TRIPLETS[:3],
                     TRIPLETS[::-1]])
    have = tsyn.add_scintillation(torch.as_tensor(port), params=rows)
    for i in range(3):
        _peak_close(have[i], jsyn.add_scintillation(port[i], params=rows[i]))
    # drawn triplets: from the numpy Generator, reproducibly
    p = tsyn.scintillation_params(np.random.default_rng(5), 3, 1.0, 5.0)
    assert p.shape == (9,) and (p[0::3] <= 1.0).all() and (p[1::3] > 0).all()
    a = tsyn.add_scintillation(torch.as_tensor(port), rng=np.random.
                               default_rng(5), nsin=3, amax=1.0, wmax=5.0)
    _peak_close(a, jsyn.add_scintillation(port, params=p))
    assert tsyn.add_scintillation(torch.as_tensor(port)).equal(
        torch.as_tensor(port))


@pytest.mark.parametrize("kw", [
    dict(phase=0.13, DM=2e-3),
    dict(phase=-0.3, DM=-1e-3, t_scat=2e-4, scint="given",
         scint_params=TRIPLETS, scales=np.linspace(0.5, 1.5, 32),
         weights=(np.arange(32) % 5 != 0).astype(float)),
    dict(phase=0.4, DM=0.0, nu_ref=1400.0, nu_dm=1500.0, model_code="101"),
])
def test_make_fake_portrait_noiseless(kw):
    freqs = np.linspace(1200.0, 1600.0, 32)
    want = np.asarray(jsyn.make_fake_portrait(MODEL, 32, 256, freqs, 0.004,
                                              **kw))
    have = tsyn.make_fake_portrait(MODEL, 32, 256, freqs, 0.004,
                                   device="cpu", **kw)
    _peak_close(have, want)


def test_make_fake_portrait_noise_and_scint_draws():
    freqs = np.linspace(1200.0, 1600.0, 32)
    kw = dict(phase=0.1, noise_std=0.5, device="cpu")
    a = tsyn.make_fake_portrait(MODEL, 32, 256, freqs, 0.004,
                                generator=torch.Generator().manual_seed(3),
                                **kw)
    b = tsyn.make_fake_portrait(MODEL, 32, 256, freqs, 0.004,
                                generator=torch.Generator().manual_seed(3),
                                **kw)
    clean = tsyn.make_fake_portrait(MODEL, 32, 256, freqs, 0.004, **kw)
    assert torch.equal(a, b)
    assert abs(float((a - clean).std()) - 0.5) < 0.02
    s = tsyn.make_fake_portrait(MODEL, 32, 256, freqs, 0.004, scint=True,
                                rng=np.random.default_rng(9), device="cpu")
    trip = tsyn.scintillation_params(np.random.default_rng(9), 3, 1.0, 5.0)
    _peak_close(s, jsyn.make_fake_portrait(MODEL, 32, 256, freqs, 0.004,
                                           scint="given", scint_params=trip))
    with pytest.raises(ValueError):
        tsyn.make_fake_portrait(MODEL, 32, 256, freqs, 0.004, scint=True,
                                device="cpu")


@pytest.mark.parametrize("t_scat", [0.0, 1e-4])
def test_make_fake_dataset_noiseless(t_scat, monkeypatch):
    nsub, nchan, nbin = 6, 16, 128
    rng = np.random.default_rng(1)
    phases = rng.uniform(-0.4, 0.4, nsub)
    dDMs = rng.normal(0.0, 1e-3, nsub)
    kw = dict(nsub=nsub, nchan=nchan, nbin=nbin, lofreq=1300.0, bw=400.0,
              P=0.004, phases=phases, dDMs=dDMs, noise_std=0.0,
              t_scat=t_scat)
    want = jsyn.make_fake_dataset(jax.random.key(0), MODEL, **kw)
    gen = torch.Generator().manual_seed(0)
    have = tsyn.make_fake_dataset(gen, MODEL, device="cpu", **kw)
    _peak_close(have.subints, want.subints)
    for key in ("freqs", "weights", "noise_stds", "Ps", "phases_inj",
                "dDMs_inj", "model_params"):
        np.testing.assert_allclose(have[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-15, err_msg=key)
    assert set(have) == set(want)
    assert have.nbin == want.nbin and have.DM0 == want.DM0
    assert have.model_code == want.model_code
    assert have.nu_ref == pytest.approx(want.nu_ref, rel=1e-15)
    # blocks of two subints give the same portraits, scintillated too
    kw["scint"] = True
    whole = tsyn.make_fake_dataset(torch.Generator().manual_seed(0), MODEL,
                                   device="cpu", **kw)
    monkeypatch.setattr(tsyn, "BLOCK_BYTES", 2 * nchan * nbin * 8)
    blocked = tsyn.make_fake_dataset(torch.Generator().manual_seed(0), MODEL,
                                     device="cpu", **kw)
    assert torch.equal(blocked.subints, whole.subints)
    assert not torch.equal(whole.subints, have.subints)


def test_make_fake_dataset_draws():
    kw = dict(nsub=5, nchan=8, nbin=64, noise_std=0.2, scint=True,
              device="cpu")
    a = tsyn.make_fake_dataset(torch.Generator().manual_seed(4), MODEL, **kw)
    b = tsyn.make_fake_dataset(torch.Generator().manual_seed(4), MODEL, **kw)
    for key in ("subints", "phases_inj", "dDMs_inj"):
        assert torch.equal(a[key], b[key])
    assert (a.phases_inj.abs() <= 0.4).all()
    assert len(set(a.phases_inj.tolist())) == 5
    with pytest.raises(ValueError, match="generator"):
        tsyn.make_fake_dataset(types.SimpleNamespace(device="cuda"), MODEL,
                               **kw)


def _capture(monkeypatch, mod):
    """Archives unloaded through ``mod.Archive.unload``, kept in order."""
    seen = []
    orig = mod.Archive.unload

    def unload(self, filename, quiet=True):
        seen.append(dict(data=np.array(self.data), Ps=np.array(self.Ps),
                         epochs=[e.mjd() for e in self.epochs]))
        return orig(self, filename, quiet=quiet)

    monkeypatch.setattr(mod.Archive, "unload", unload)
    return seen


@pytest.mark.parametrize("kw", [
    dict(scint=TRIPLETS, phase=0.2, dDM=2e-3),
    dict(xs=(-2.0, -4.0), Cs=(1.0, 0.2), nu_DM=1400.0, phase=0.2, dDM=3e-3,
         dedispersed=True),
    dict(xs=(-2.1,), Cs=(1.0,), phase=-0.1, dDM=1e-3, scint=TRIPLETS,
         t_scat=5e-5),
])
def test_make_fake_pulsar_options(kw, tmp_path, monkeypatch):
    seen_t = _capture(monkeypatch, tpsr)
    seen_j = _capture(monkeypatch, jpsr)
    common = dict(nsub=3, nchan=16, nbin=128, tsub=60.0, noise_stds=0.0,
                  seed=2, **kw)
    tarch.make_fake_pulsar(GM, PAR, str(tmp_path / "t.fits"), **common)
    jarch.make_fake_pulsar(GM, PAR, str(tmp_path / "j.fits"), **common)
    (t,), (j,) = seen_t, seen_j
    _peak_close(t["data"], j["data"])
    assert t["epochs"] == j["epochs"]
    np.testing.assert_array_equal(t["Ps"], j["Ps"])


def test_make_fake_pulsar_draw_order(tmp_path, monkeypatch):
    """scint=False: one (npol, nchan, nbin) noise draw per subint from
    default_rng(seed), as before the scintillation option existed."""
    seen = _capture(monkeypatch, tpsr)
    kw = dict(nsub=3, nchan=8, nbin=64, dedispersed=True, seed=7)
    tarch.make_fake_pulsar(GM, PAR, str(tmp_path / "a.fits"),
                           noise_stds=0.0, **kw)
    tarch.make_fake_pulsar(GM, PAR, str(tmp_path / "b.fits"),
                           noise_stds=0.3, **kw)
    noise = np.random.default_rng(7).standard_normal((3, 1, 8, 64))
    np.testing.assert_allclose(seen[1]["data"] - seen[0]["data"],
                               0.3 * noise, rtol=0, atol=1e-12)
    # scint=True draws its triplets before each subint's noise
    tarch.make_fake_pulsar(GM, PAR, str(tmp_path / "c.fits"), scint=True,
                           noise_stds=0.3, **kw)
    rng = np.random.default_rng(7)
    for isub in range(3):
        trip = tsyn.scintillation_params(rng, 3, 1.0, 5.0)
        want = tsyn.add_scintillation(torch.as_tensor(seen[0]["data"][isub]),
                                      params=trip).numpy() \
            + 0.3 * rng.standard_normal((1, 8, 64))
        np.testing.assert_allclose(seen[2]["data"][isub], want, rtol=0,
                                   atol=1e-12)


def test_xs_without_Cs_raises(tmp_path):
    with pytest.raises(ValueError):
        tarch.make_fake_pulsar(GM, PAR, str(tmp_path / "t.fits"), nsub=1,
                               nchan=4, nbin=32, xs=(-2.0,))
    with pytest.raises(ValueError):
        jarch.make_fake_pulsar(GM, PAR, str(tmp_path / "j.fits"), nsub=1,
                               nchan=4, nbin=32, xs=(-2.0,), dDM=1e-3)
