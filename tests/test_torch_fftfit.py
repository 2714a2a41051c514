"""K2 (FFTFIT) pieces against the JAX reference on the CPU.

The card runs K2's grid stage as a real float64 product of the
cross-spectrum, read as [N, 2 nharm], with a shared phasor table.  These
tests hold that table and that layout against the reference's grid
phasors and Cgrid (pulseportraiture_tpu/fit/phase_shift.py:73-82) on
seeded inputs, check the first-minimum / NaN rule of the argmin on
hand-made rows, and check the wrapper's table cache.  The kernel itself
runs only on the card (tests/test_torch_import_clean.py, ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pulseportraiture_tpu.fit import phase_shift as jps
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch.fit import phase_shift as tps


def _ref_phasors(nharm, lo, hi, Ns):
    """The reference's grid phasors ph [Ns, nharm] (phase_shift.py:74-80)."""
    grid = lo + (hi - lo) * jnp.arange(Ns, dtype=jnp.float64) / Ns
    k = jnp.arange(nharm, dtype=jnp.float64)
    ang = 2.0 * jnp.pi * ((grid[:, None] * k[None, :]) % 1.0)
    return np.asarray(jnp.cos(ang) + 1j * jnp.sin(ang)), np.asarray(grid)


def _profiles(rng, N, nbin, noise=0.05):
    """N noisy copies of one pulse at random phases, and the pulse."""
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.35) / 0.02) ** 2)
    k = np.arange(nbin // 2 + 1)
    ph = rng.uniform(-0.45, 0.45, N)
    data = np.fft.irfft(np.fft.rfft(prof) * np.exp(
        2j * np.pi * ph[:, None] * k), nbin, axis=-1)
    data += noise * rng.standard_normal((N, nbin))
    return data, np.broadcast_to(prof, (N, nbin)).copy()


@pytest.mark.parametrize("nharm,lo,hi,Ns", [(1025, -0.5, 0.5, 100),
                                            (65, -0.25, 0.25, 100),
                                            (129, -0.5, 0.5, 256)])
def test_table_plain_matches_reference_phasors(nharm, lo, hi, Ns):
    ph, _ = _ref_phasors(nharm, lo, hi, Ns)
    T = _kernels.fftfit_table_plain(nharm, lo, hi, Ns).numpy()
    assert T.shape == (2 * nharm, Ns)
    np.testing.assert_allclose(T[0::2].T, ph.real, rtol=0, atol=1e-15)
    np.testing.assert_allclose(-T[1::2].T, ph.imag, rtol=0, atol=1e-15)
    # the padded table the kernel reads holds it in its corner, zeros
    # elsewhere
    P = _kernels.fftfit_table(nharm, lo, hi, Ns, "cpu").numpy()
    assert P.shape[0] % _kernels.FFTFIT_K_ALIGN == 0
    assert P.shape[1] % _kernels.FFTFIT_NS_ALIGN == 0
    np.testing.assert_array_equal(P[:2 * nharm, :Ns], T)
    assert not P[2 * nharm:].any() and not P[:, Ns:].any()


@pytest.mark.parametrize("N,nbin,lo,hi,Ns", [(64, 2048, -0.5, 0.5, 100),
                                             (40, 256, -0.25, 0.25, 100),
                                             (16, 256, -0.5, 0.5, 256)])
def test_real_product_layout_matches_reference_grid(N, nbin, lo, hi, Ns,
                                                    rng):
    data, model = _profiles(rng, N, nbin)
    cross = np.array(jps.cross_spectrum(data, model)[0])
    nharm = cross.shape[-1]
    ph, _ = _ref_phasors(nharm, lo, hi, Ns)
    want = -np.real(np.asarray(jnp.einsum("...h,gh->...g", cross, ph)))
    A = torch.view_as_real(torch.as_tensor(cross)).reshape(N, 2 * nharm)
    T = _kernels.fftfit_table(nharm, lo, hi, Ns, "cpu")
    have = -(A @ T[:2 * nharm]).numpy()[:, :Ns]
    np.testing.assert_allclose(have, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(np.argmin(have, axis=-1),
                                  np.asarray(jnp.argmin(want, axis=-1)))


def test_argmin_rule_matches_reference():
    """torch.argmin (the plain K2's) and jnp.argmin agree on ties and
    NaNs: the lowest index wins a tie, the first NaN wins over any
    number, -inf included."""
    nan, inf = np.nan, np.inf
    rows = np.array([[2.0, 0.0, 0.0, 1.0], [1.0, nan, -inf, nan],
                     [nan, nan, nan, nan], [-inf, 3.0, -inf, 0.0],
                     [0.0, -0.0, 0.0, 1.0]])
    np.testing.assert_array_equal(
        torch.argmin(torch.as_tensor(rows), dim=-1).numpy(),
        np.asarray(jnp.argmin(jnp.asarray(rows), axis=-1)))


def _hand_rows(nharm=3):
    """Cross rows whose grids tie or hold NaNs at known grid points (Ns
    64): harmonic 2 only, +-1, over [-0.5, 0.5) ties at 0/32 and 16/48;
    harmonic 1 only, i*inf, over [-0.25, 0.25) is -inf before grid point
    32, NaN there (sin = 0 exactly), +inf after; a NaN row."""
    tie = np.zeros((2, nharm), complex)
    tie[0, 2], tie[1, 2] = 1.0, -1.0
    odd = np.zeros((2, nharm), complex)
    odd[0, 1] = complex(0.0, np.inf)
    odd[1] = np.nan
    return ((tie, -0.5, 0.5, [0, 16]), (odd, -0.25, 0.25, [32, 0]))


@pytest.mark.parametrize("newton_iter", [0, 6])
def test_fftfit_first_minimum_on_hand_rows(newton_iter):
    Ns = 64
    for cross, lo, hi, first in _hand_rows():
        grid = lo + (hi - lo) * np.arange(Ns) / Ns
        cr = torch.as_tensor(cross)
        phase, C, d2C = _kernels.fftfit(cr, torch.ones(len(cross),
                                                       dtype=torch.float64),
                                        lo, hi, Ns, newton_iter)
        want = (grid[first] + 0.5) % 1.0 - 0.5
        np.testing.assert_allclose(phase.numpy(), want, rtol=0, atol=1e-12)
        if lo == -0.25:  # NaN grids stay NaN, no Newton step taken
            assert torch.isnan(C).all() and torch.isnan(d2C).all()


@pytest.mark.parametrize("bounds", [(-0.5, 0.5), (-0.25, 0.25)])
@pytest.mark.parametrize("newton_iter", [0, 6])
def test_fftfit_plain_matches_reference_core(bounds, newton_iter, rng):
    data, model = _profiles(rng, 12, 256, noise=0.2)
    err = rng.uniform(0.1, 0.3, 12)
    ref = jps._fit_phase_shift_core(data, model, err, bounds[0], bounds[1],
                                    100, newton_iter)
    got = tps._fit_phase_shift_core(torch.as_tensor(data),
                                    torch.as_tensor(model),
                                    torch.as_tensor(err), bounds[0],
                                    bounds[1], 100, newton_iter)
    np.testing.assert_allclose(got.phase.numpy(), np.asarray(ref.phase),
                               rtol=0, atol=1e-10)
    for key in ("phase_err", "scale", "snr", "red_chi2"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-9, err_msg=key)


def test_table_cache_reuses_and_rebuilds():
    _kernels._TABLES.clear()
    T = _kernels.fftfit_table(65, -0.5, 0.5, 100, "cpu")
    assert _kernels.fftfit_table(65, -0.5, 0.5, 100, "cpu") is T
    for args in ((65, -0.25, 0.5, 100), (65, -0.5, 0.25, 100),
                 (65, -0.5, 0.5, 64), (129, -0.5, 0.5, 100)):
        assert _kernels.fftfit_table(*args, "cpu") is not T
    assert _kernels.fftfit_table(65, -0.5, 0.5, 100, "cpu") is T
    for i in range(2 * _kernels.FFTFIT_TABLES_MAX):
        _kernels.fftfit_table(17, -0.5, 0.5, 10 + i, "cpu")
    assert len(_kernels._TABLES) == _kernels.FFTFIT_TABLES_MAX
    assert _kernels.fftfit_table(65, -0.5, 0.5, 100, "cpu") is not T
    assert _kernels.LAUNCHES["fftfit"] == 0
