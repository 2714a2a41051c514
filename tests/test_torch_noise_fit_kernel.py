"""K11's plain version (``_kernels.noise_fit_plain``, csrc/noisefit.cu's
arithmetic in torch) against the JAX package's ``get_noise_fit`` and
``find_kc`` on the same seeded numpy rows, on the CPU.

Rows: noisy pulses of several widths, white noise, a scattered pulse,
zeroed channels (a non-finite log power: the reference's a = a_0), a unit
impulse (a flat power spectrum: the constant log power whose b = 0 points
tie over every a, the first index winning) and a row with one zero
harmonic.  Pass criteria: the cutoff k_c equal on every row and the noise
within 1e-12 relative (the zeroed rows' noise exactly 0), with both
``fn``s, two values of ``fact`` and nbin 64, 512 and 2048; the flat argmin
of ``ops.noise._chi2_grid`` consistent with k_c; an a grid of more than 20
points against the JAX package too; the wrapper on CPU tensors taking the
plain version bit for bit and refusing bad arguments; ops.noise's
estimators going through the wrapper a chunk at a time (on the card, fewer
rows for wide spectra); the tie bound of ``chip_smoke.k11_chi2_bound``
holding the evaluation against one in extended precision, and
``chip_smoke.k11_ties`` telling a mismatch that is no tie for a fault; the
C entry point's arguments and limits against the source.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.ops import noise as jno
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch.ops import noise as tno

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

NROWS = {64: 16, 512: 12, 2048: 8}


def _rows(nbin, seed):
    """[NROWS[nbin], nbin]: the row kinds of the module docstring."""
    rng = np.random.default_rng(seed)
    n = NROWS[nbin]
    ph = (np.arange(nbin) + 0.5) / nbin
    x = rng.standard_normal((n, nbin))
    for i in range(n - 6):                        # pulses, narrow to wide
        x[i] += rng.uniform(3.0, 60.0) * np.exp(
            -0.5 * ((ph - rng.uniform(0.2, 0.8)) / (0.004 * (i + 1))) ** 2)
    k = np.arange(nbin // 2 + 1)
    pulse = np.exp(-0.5 * ((ph - 0.4) / 0.01) ** 2)
    x[n - 6] += 40.0 * np.fft.irfft(np.fft.rfft(pulse)
                                    / (1 + 2j * np.pi * k * 0.03), nbin)
    x[n - 5:n - 3] = 0.0                          # zapped channels
    x[n - 3] = 0.0
    x[n - 3, 0] = 1.0                             # flat power: b = 0 ties
    x[n - 2] = np.fft.irfft(np.fft.rfft(x[n - 2]) * (k != 3), nbin)
    return x                                      # the last row: noise


def _pows(x):
    return np.abs(np.fft.rfft(x, axis=-1)) ** 2 / x.shape[-1]


@pytest.mark.parametrize("nbin", [64, 512, 2048])
@pytest.mark.parametrize("fact", [1.1, 2.5])
@pytest.mark.parametrize("fn", ["exp_dc", "half_tri"])
def test_plain_matches_jax(fn, fact, nbin):
    x = _rows(nbin, seed=nbin + int(10 * fact))
    n = len(x)
    X = torch.fft.rfft(torch.as_tensor(x), dim=-1)
    noise = torch.empty(n, dtype=torch.float64)
    kc = torch.empty(n, dtype=torch.int64)
    out = _kernels.noise_fit_plain(X, nbin, fn, fact, 20, noise, kc)
    assert out[0] is noise and out[1] is kc
    want_kc = np.array([int(jno.find_kc(p, fn=fn)) for p in _pows(x)])
    np.testing.assert_array_equal(kc.numpy(), want_kc)
    want = np.asarray(jno.get_noise_fit(x, fact=fact, fn=fn))
    zero = want == 0.0
    assert zero.sum() == 2 and (noise.numpy()[zero] == 0.0).all()
    np.testing.assert_allclose(noise.numpy()[~zero], want[~zero], rtol=1e-12,
                               atol=0)
    # the flat argmin names k_c's a; a = a_0 on rows whose log power is
    # not finite: the zeroed ones, and a zero harmonic's
    grid = tno._kc_grid(nbin // 2 + 1, fn, 20, "cpu")
    chi2, live = tno._chi2_grid(torch.log10(torch.as_tensor(_pows(x))),
                                grid, 20)
    flat = torch.argmin(chi2, dim=-1)
    assert not live[n - 5:n - 3].any() and live[:n - 6].all()
    assert bool((kc[~live] == grid.kc[0]).all())
    assert torch.equal(grid.kc[flat[live] // 400], kc[live])
    # the flat power's every b = 0 point ties: the first, (a, b, dc) = 0
    assert int(flat[n - 3]) == 0 and int(kc[n - 3]) == int(grid.kc[0])
    # the power itself as input: the same cutoffs
    kc2 = _kernels.noise_fit_plain(torch.as_tensor(_pows(x)), None, fn,
                                   Ns=20)[1]
    np.testing.assert_array_equal(kc2.numpy(), want_kc)


@pytest.mark.parametrize("fn", ["exp_dc", "half_tri"])
def test_constant_log_power_takes_a0(fn):
    """find_kc of a constant power spectrum (lmax = lmin: every b is 0)
    is a_0's cutoff in both packages, at every Ns."""
    pows = np.full((3, 40), 2.5)
    for Ns in (20, 7):
        want = int(jno.find_kc(pows[0], fn=fn, Ns=Ns))
        kc = _kernels.noise_fit_plain(torch.as_tensor(pows), None, fn,
                                      Ns=Ns)[1]
        chi2 = tno._chi2_grid(torch.log10(torch.as_tensor(pows)),
                              tno._kc_grid(40, fn, Ns, "cpu"), Ns)[0]
        assert kc.tolist() == [want] * 3
        assert torch.argmin(chi2, dim=-1).tolist() == [0] * 3


@pytest.mark.parametrize("fn,Ns", [("exp_dc", 23), ("half_tri", 31)])
def test_plain_matches_jax_beyond_20_points(fn, Ns):
    """An a grid wider than the kernel's 20 shape accumulators (its second
    pass runs twice): the cutoffs equal the JAX package's find_kc."""
    x = _rows(512, seed=Ns)
    kc = _kernels.noise_fit_plain(torch.as_tensor(_pows(x)), None, fn,
                                  Ns=Ns)[1]
    want = [int(jno.find_kc(p, fn=fn, Ns=Ns)) for p in _pows(x)]
    assert kc.tolist() == want
    assert tno._kc_grid(257, fn, Ns, "cpu").uniq.shape[0] > 20


def test_wrapper_on_the_cpu_is_the_plain_version():
    x = torch.as_tensor(_rows(512, seed=3))
    X = torch.fft.rfft(x, dim=-1)
    outs = [(torch.empty(len(x), dtype=torch.float64),
             torch.empty(len(x), dtype=torch.int64)) for _ in range(2)]
    _kernels.noise_fit(X, 512, "half_tri", 3.0, 20, *outs[0])
    _kernels.noise_fit_plain(X, 512, "half_tri", 3.0, 20, *outs[1])
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    n0 = dict(_kernels.LAUNCHES)
    _kernels.noise_fit(X, 512)
    assert _kernels.LAUNCHES == n0          # the plain version counts none


@pytest.mark.parametrize("bad,err", [
    (lambda X: (X.real.to(torch.float32), 512), TypeError),
    (lambda X: (X[:, ::2], 512), ValueError),          # not contiguous
    (lambda X: (X[0], 512), ValueError),               # 1-D
    (lambda X: (X, None), ValueError),                 # an rFFT needs nbin
])
def test_wrapper_refuses_bad_spectra(bad, err):
    X = torch.fft.rfft(torch.as_tensor(_rows(64, seed=1)), dim=-1)
    with pytest.raises(err):
        _kernels.noise_fit(*bad(X))


def test_wrapper_refuses_bad_outputs():
    X = torch.fft.rfft(torch.as_tensor(_rows(64, seed=1)), dim=-1)
    n = X.shape[0]
    with pytest.raises(ValueError, match="rows"):
        _kernels.noise_fit(X, 64, noise_out=torch.empty(n + 1,
                                                        dtype=torch.float64))
    with pytest.raises(TypeError):
        _kernels.noise_fit(X, 64, kc_out=torch.empty(n, dtype=torch.int32))
    with pytest.raises(ValueError, match="Ns"):
        _kernels.noise_fit(X, 64, Ns=0)


def test_card_chunks_are_bounded_by_bytes():
    """On the card a chunk is GRID_ROWS_CUDA rows of spectrum, fewer where
    they would pass SPECTRUM_CHUNK_BYTES; on the CPU GRID_ROWS."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tno._block_rows(cuda, 1025) == tno.GRID_ROWS_CUDA
    assert tno._block_rows(cuda, 32769) == tno.SPECTRUM_CHUNK_BYTES // (
        16 * 32769) < tno.GRID_ROWS_CUDA
    assert tno._block_rows(cuda, 1 << 27) == 1
    assert tno._block_rows(cpu, 32769) == tno.GRID_ROWS


def test_estimators_call_the_wrapper_per_chunk(monkeypatch):
    """get_noise_fit and find_kc hand each chunk of rows to
    _kernels.noise_fit (one launch a chunk on the card), with the same
    result as one chunk."""
    x = torch.as_tensor(_rows(512, seed=9))
    whole_n = tno.get_noise_fit(x, fact=2.0)
    whole_kc = tno.find_kc(torch.as_tensor(_pows(x.numpy())), fn="half_tri")
    calls = []
    orig = _kernels.noise_fit

    def spy(spec, *a, **kw):
        calls.append((spec.dtype, spec.shape[0]))
        return orig(spec, *a, **kw)

    monkeypatch.setattr(_kernels, "noise_fit", spy)
    monkeypatch.setattr(tno, "GRID_ROWS", 5)
    assert torch.equal(tno.get_noise_fit(x.reshape(3, 4, -1), fact=2.0),
                       whole_n.reshape(3, 4))
    assert calls == [(torch.complex128, 5), (torch.complex128, 5),
                     (torch.complex128, 2)]
    calls.clear()
    assert torch.equal(tno.find_kc(torch.as_tensor(_pows(x.numpy())),
                                   fn="half_tri"), whole_kc)
    assert calls == [(torch.float64, 5), (torch.float64, 5),
                     (torch.float64, 2)]
    with pytest.raises(ValueError, match="fn"):
        tno.get_noise_fit(x, fn="nope")


def test_grid_tables_are_cached():
    g = tno._kc_grid(257, "exp_dc", 20, "cpu")
    assert tno._kc_grid(257, "exp_dc", 20, torch.device("cpu")) is g
    assert tno._kc_grid(257, "half_tri", 20, "cpu") is not g
    assert g.inverse32.dtype == torch.int32 and torch.equal(
        g.inverse32.long(), g.inverse)
    assert g.uniq.is_contiguous() and g.uniq.shape[1] == 257


@pytest.mark.parametrize("fn", ["exp_dc", "half_tri"])
def test_tie_bound_covers_the_rounding(fn):
    """chip_smoke.k11_chi2_bound's chi2 at every row's argmin, and at a
    few other grid points, lies within half its bound of the same sum in
    extended precision (numpy longdouble) — the bound covers two
    evaluations, so one is within half of it; and the bound is small (a
    relative 1e-10 of chi2 at most, so that it decides nothing but
    rounding)."""
    X = torch.fft.rfft(torch.as_tensor(_rows(512, seed=21)), dim=-1)
    grid = tno._kc_grid(257, fn, 20, "cpu")
    pows = (X * X.conj()).real / 512
    chi2_grid, live = tno._chi2_grid(torch.log10(pows), grid, 20)
    X, choice = X[live], torch.argmin(chi2_grid[live], dim=-1)
    pw = ((X * X.conj()).real / 512).numpy().astype(np.longdouble)
    logp = np.log10(pw)
    for flat in (choice, torch.full_like(choice, 7999),
                 torch.full_like(choice, 4321)):
        chi2, bound = chip_smoke.k11_chi2_bound(X, 512, fn, 20, flat)
        for r in range(len(X)):
            f = int(flat[r])
            ia, ib, idc = f // 400, (f // 20) % 20, f % 20
            lmin, lmax = logp[r].min(), logp[r].max()
            t = np.longdouble(ib) / 19
            b = (lmax - lmin) * t
            dc = lmin * (1 - np.longdouble(idc) / 19) + lmax * (
                np.longdouble(idc) / 19)
            s = grid.uniq[grid.inverse[ia]].numpy().astype(np.longdouble)
            exact = ((logp[r] - b * s - dc) ** 2).sum()
            assert abs(float(chi2[r]) - float(exact)) <= 0.5 * float(
                bound[r]), (r, f)
            assert float(bound[r]) <= 1e-10 * float(exact) + 1e-20


def test_tie_judge_tells_faults():
    """chip_smoke.k11_ties: equal cutoffs are no mismatch; a cutoff moved
    to another a's on a row with a clear minimum is a fault, as is a
    mismatch on a row whose log power is not finite or a cutoff that is no
    a's."""
    x = _rows(512, seed=5)
    X = torch.fft.rfft(torch.as_tensor(x), dim=-1)
    kc = _kernels.noise_fit_plain(X, 512, "exp_dc")[1]
    grid = tno._kc_grid(257, "exp_dc", 20, "cpu")
    assert chip_smoke.k11_ties(X, 512, "exp_dc", 20, kc, kc.clone()) == (0, 0)
    other = kc.clone()
    n = len(x)
    other[0] = grid.kc[-1] if int(kc[0]) != int(grid.kc[-1]) else grid.kc[0]
    other[n - 5] = grid.kc[3]                   # a zeroed row
    other[n - 1] = -7                           # no a's cutoff
    assert chip_smoke.k11_ties(X, 512, "exp_dc", 20, kc, other) == (0, 3)


_CTYPE = {"const void*": _kernels._VP, "void*": _kernels._VP,
          "int64_t": _kernels._I64, "int": _kernels._INT,
          "double": _kernels._DBL}


def test_binding_and_limits_match_the_source():
    """pp_noise_fit takes, in order, the argument types its ctypes binding
    declares; NOISE_FIT_MAX_NS is the largest a grid whose tables (32 Ns
    bytes for one warp) fit the source's kMaxSmem, and the kernel holds
    kAcc shape accumulators at a time; noisefit.cu is a built source with a
    launch count."""
    text = open(_kernels.CSRC_DIR + "/noisefit.cu").read()
    m = re.search(r'extern "C" int pp_noise_fit\(([^)]*)\)', text)
    params = [re.sub(r"\s+\w+$", "", p.strip()) for p in m.group(1).split(",")]
    assert [_CTYPE[p] for p in params] == \
        _kernels._SYMBOLS["noise_fit"]["pp_noise_fit"]
    const = {k: int(v) for k, v in re.findall(
        r"constexpr \w+ (k\w+) = (\d+);", text)}
    assert 32 * _kernels.NOISE_FIT_MAX_NS <= const["kMaxSmem"] \
        < 32 * (_kernels.NOISE_FIT_MAX_NS + 1)
    assert const["kAcc"] == 20
    assert "noisefit.cu" in _kernels.SOURCES and "noise_fit" in \
        _kernels.LAUNCHES
    assert "__global__" in text and _kernels.TRACE_NAMES["noise_fit"] in text
