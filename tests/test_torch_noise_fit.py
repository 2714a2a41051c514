"""The "fit" noise estimators of the port against the JAX package.

Seeded numpy profiles — noisy pulses, scattered pulses, white noise
(a flat spectrum), a constant, a noiseless pulse, all-zero channels and
a channel with one zero harmonic — go through the JAX function and its
port on the CPU.  Pass criteria:

* ``find_kc``: the cutoff equal on every channel, with both ``fn``s
  (the reference's first-index choice on the b = 0 ties, and its a = a_0
  on channels whose log power is not finite);
* ``get_noise_fit`` / ``get_noise(method="fit")`` and
  ``half_triangle_function`` within 1e-12 relative (the noiseless
  pulse's noise is FFT round-off, ~1e-18 of its unit peak: 1e-15
  absolute); the Wiener filter (in [0, 1]) and ``wiener_smooth`` within
  1e-12 of their peak; the brickwall cutoffs equal;
* ``load_data``, ``normalize_portrait`` and ``get_SNR`` with
  ``noise_method="fit"``: the same bounds on the same archive and data.
"""

import os

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.io import archive as jarch
from pulseportraiture_tpu.ops import noise as jno
from pulseportraiture_tpu.ops import normalize as jnorm
from pulseportraiture_tpu_torch.io import archive as tarch
from pulseportraiture_tpu_torch.ops import noise as tno
from pulseportraiture_tpu_torch.ops import normalize as tnorm

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")


def _profiles(nbin, seed=0):
    """[40, nbin]: the channel kinds of the module docstring."""
    rng = np.random.default_rng(seed)
    ph = (np.arange(nbin) + 0.5) / nbin
    x = rng.standard_normal((40, nbin))
    for i in range(10, 24):                      # pulses, narrow to wide
        x[i] += 3.0 * i * np.exp(-0.5 * ((ph - 0.3) / (0.004 * (i - 9))) ** 2)
    k = np.arange(nbin // 2 + 1)
    for i in range(24, 30):                      # scattered pulses
        tau = 0.01 * (i - 23)
        pulse = np.exp(-0.5 * ((ph - 0.4) / 0.01) ** 2)
        x[i] += 40.0 * np.fft.irfft(np.fft.rfft(pulse)
                                    / (1 + 2j * np.pi * k * tau), nbin)
    x[30:33] = 0.0                               # zapped channels
    x[33] = np.exp(-0.5 * ((ph - 0.5) / 0.02) ** 2)   # noiseless
    x[34] = 1.0                                  # constant
    x[35] -= x[35].mean()                        # tiny DC harmonic
    x[36] = np.fft.irfft(np.fft.rfft(x[36]) * (k != 5), nbin)  # zero power
    return x


def _pows(x):
    return np.abs(np.fft.rfft(x, axis=-1)) ** 2 / x.shape[-1]


def _close(have, want, rtol=1e-12, atol=0.0):
    have = have.numpy() if isinstance(have, torch.Tensor) else have
    want = np.asarray(want)
    assert have.shape == want.shape
    assert np.array_equal(np.isnan(have), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(have[ok], want[ok], rtol=rtol, atol=atol)


# at full width one channel of each kind (the reference's grid is 65.6 MB
# per channel there)
KINDS = [0, 12, 20, 26, 30, 33, 34, 35, 36]


@pytest.mark.parametrize("fn", ["exp_dc", "half_tri"])
@pytest.mark.parametrize("nbin", [32, 256, 2048])
def test_find_kc_equal(fn, nbin):
    pows = _pows(_profiles(nbin, seed=nbin))
    if nbin == 2048:
        pows = pows[KINDS]
    want = np.array([int(jno.find_kc(p, fn=fn)) for p in pows])
    have = tno.find_kc(torch.as_tensor(pows), fn=fn)
    assert have.shape == (len(pows),)
    np.testing.assert_array_equal(have.numpy(), want)
    assert int(tno.find_kc(torch.as_tensor(pows[1]), fn=fn)) == want[1]


def test_find_kc_blocks(monkeypatch):
    """Channels split over several grid blocks give the same cutoffs."""
    pows = torch.as_tensor(_pows(_profiles(256, seed=3)))
    whole = tno.find_kc(pows)
    monkeypatch.setattr(tno, "GRID_ROWS", 7)
    assert torch.equal(tno.find_kc(pows.reshape(4, 10, -1)),
                       whole.reshape(4, 10))


@pytest.mark.parametrize("fn,fact", [("exp_dc", 1.1), ("half_tri", 3.0)])
def test_get_noise_fit(fn, fact, monkeypatch):
    x = _profiles(128, seed=7)
    want = np.asarray(jno.get_noise_fit(x, fact=fact, fn=fn))
    monkeypatch.setattr(tno, "GRID_ROWS", 16)
    have = tno.get_noise_fit(torch.as_tensor(x), fact=fact, fn=fn).numpy()
    assert have[30:33].tolist() == [0.0, 0.0, 0.0] == want[30:33].tolist()
    live = np.ones(40, bool)
    live[33] = False
    _close(have[live], want[live])
    _close(have[33], want[33], rtol=0, atol=1e-15)
    # leading dimensions of any shape, through the dispatcher
    _close(tno.get_noise(torch.as_tensor(x[:4].reshape(2, 2, -1)),
                         method="fit", fact=fact, fn=fn),
           want[:4].reshape(2, 2))
    _close(tno.get_noise(torch.as_tensor(x[12]), method="fit", fact=fact,
                         fn=fn), want[12])
    with pytest.raises(ValueError):
        tno.get_noise(torch.as_tensor(x), method="nope")


def test_half_triangle_function():
    for a, b, dc, N in ((5.7, 2.0, -1.0, 16), (1.0, 0.5, 0.0, 4),
                        (30.2, 3.0, 1.0, 20)):
        _close(tno.half_triangle_function(a, b, dc, N),
               jno.half_triangle_function(a, b, dc, N))


def test_wiener_and_brickwall():
    x = _profiles(512, seed=11)[10:30].copy()
    noise = np.asarray(jno.get_noise(x))[:, None]
    tx, tn = torch.as_tensor(x), torch.as_tensor(noise)
    # H is in [0, 1]; where the signal power nears the noise floor it is a
    # difference of nearly equal numbers: 1e-12 of its peak
    _close(tno.wiener_filter(tx, tn), jno.wiener_filter(x, noise), rtol=0,
           atol=1e-12)
    kc = tno.fit_brickwall(tx, tn)
    np.testing.assert_array_equal(kc.numpy(),
                                  np.asarray(jno.fit_brickwall(x, noise)))
    _close(tno.brickwall_filter(257, kc),
           jno.brickwall_filter(257, np.asarray(kc)), rtol=0)
    assert tno.brickwall_filter(8, 3).tolist() == [1.0] * 3 + [0.0] * 5
    for brickwall in (False, True):
        want = np.asarray(jno.wiener_smooth(x, noise, brickwall=brickwall))
        have = tno.wiener_smooth(tx, tn, brickwall=brickwall)
        assert have.dtype == torch.float64
        np.testing.assert_allclose(have.numpy(), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    # one profile, a scalar noise
    _close(tno.wiener_smooth(tx[3], float(noise[3, 0])),
           jno.wiener_smooth(x[3], float(noise[3, 0])), rtol=0,
           atol=1e-12 * np.abs(x[3]).max())


def test_normalize_and_snr_with_fit_noise():
    # the noiseless and constant channels (33, 34) have a round-off noise
    x = _profiles(128, seed=5)[:30].reshape(3, 10, 128)
    tx = torch.as_tensor(x)
    port, norms = tnorm.normalize_portrait(tx, "rms", return_norms=True,
                                           noise_method="fit")
    jport, jnorms = jnorm.normalize_portrait(x, "rms", return_norms=True,
                                             noise_method="fit")
    _close(norms, jnorms)
    np.testing.assert_allclose(port.numpy(), np.asarray(jport), rtol=1e-12,
                               atol=1e-15)
    _close(tno.get_SNR(tx, noise_method="fit"),
           jno.get_SNR(x, noise_method="fit"), atol=1e-12)


def test_load_data_with_fit_noise(tmp_path):
    """load_data(noise_method="fit") on one archive read by both packages,
    with two channels zeroed (as a zapped archive holds them)."""
    gm = os.path.join(EXAMPLES, "example.gmodel")
    par = os.path.join(EXAMPLES, "example.par")
    path = str(tmp_path / "fake.fits")
    tarch.make_fake_pulsar(gm, par, path, nsub=2, nchan=8, nbin=128,
                           phase=0.1, dDM=1e-3, noise_stds=0.3, seed=4)
    data = tarch.load_data(path, rm_baseline=False,
                           device="cpu").subints.copy()
    data[:, :, [2, 5]] = 0.0
    zeroed = str(tmp_path / "zeroed.fits")
    tarch.unload_new_archive(data, path, zeroed, dmc=0)
    for f in (path, zeroed):
        have = tarch.load_data(f, noise_method="fit", device="cpu")
        want = jarch.load_data(f, noise_method="fit")
        _close(have.noise_stds, want.noise_stds)
        _close(have.SNRs, want.SNRs, atol=1e-12)
    assert (have.noise_stds[:, :, [2, 5]] == 0.0).all()
