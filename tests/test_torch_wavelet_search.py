"""K8's search (smart_smooth's wavelet smoothing search): the port's plain
version against the JAX package's _smart_smooth_grid on the CPU.

The port finds each profile's candidate from one transform of the
profile and tables (ops.wavelet.search_tables: the inverse transform
unrolled) and its plain version makes the chosen smooth with
wavelet_smooth, as the reference makes every candidate.  Inputs are
seeded numpy rows: pure noise, a two-Gaussian pulse plus noise at three
S/N, the pulse with a spike one bin wide, an all-zero row and the noiseless
pulse, at nbin 256 (8 levels), 2048 (11 levels) and 1000 (one level),
hard and soft thresholds.  Pass criteria: the tables against swt / iswt
within 1e-12 of the largest magnitude; the same rows zeroed, the same
(level, factor) chosen per row — the reference's choice read as the
first candidate of its grid that its output equals, within 1e-12 of the
row's peak — and each smooth within 1e-10 (SMOOTH_TOL) of its row's
peak; the choice and smooth independent of the chunk of rows; the
wrapper's refusals.  The parity floor: where the winning candidates'
pseudo-S/N is set by the FFT round trip's rounding (their noise
estimate below RHO_FLOOR of their peak: low-S/N and pure-noise rows at
2048 bins), the reference's own choice changes from call to call and
between batched and single-row calls (a row of seed 7 picks level 8 or
9, 2.3e-2 of its peak apart); there the port's choice must be such a
candidate too, pass the gate and equal the reference's candidate.  The kernel against this plain version is
tests/test_torch_cuda_paths.py::test_smooth_search_kernel_matches_plain,
on the card.
"""

import math
import re

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.ops import wavelet as jw
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch.ops import wavelet as tw

TABLE_TOL = 1e-12
SMOOTH_TOL = 1e-10
NFACT = 30
# a candidate's pseudo-S/N is decided at the FFT round trip's rounding
# floor when its noise estimate is below this share of its peak (the
# round trip's rounding noise is ~1e-16 of the peak): the reference's own
# choice among such candidates changes between calls
RHO_FLOOR = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread, so the test workers do not
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(nbin, seed):
    """Seeded rows: the pulse plus noise at S/N ~3, 30 and 300, the pulse
    with a spike one bin wide, pure noise, an all-zero row and the noiseless
    pulse."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    pulse = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2) \
        + 0.5 * np.exp(-0.5 * ((x - 0.5) / 0.04) ** 2)
    spike = np.exp(-0.5 * ((x - 0.3) * nbin / 1.0) ** 2)
    rows = [pulse * snr / 30.0 + rng.standard_normal(nbin) * 0.1
            for snr in (3.0, 30.0, 300.0)]
    rows.append(pulse + 10.0 * spike + rng.standard_normal(nbin) * 0.1)
    rows.append(rng.standard_normal(nbin))
    rows.append(np.zeros(nbin))
    rows.append(pulse)
    return np.array(rows)


def _reference_choices(port, out, nlevel, threshtype):
    """Per row, the first (level, factor) of the reference's grid whose
    candidate is the reference's output (within 1e-12 of its peak); None
    where the row was zeroed."""
    facts = np.linspace(0.0, 3.0, NFACT).reshape(NFACT, 1)
    picks = [None] * len(port)
    for ilevel in range(nlevel):
        cand = np.asarray(jw.wavelet_smooth(port, "db8", ilevel + 1,
                                            threshtype, facts))
        for i in range(len(port)):
            if picks[i] is not None or not out[i].any():
                continue
            gap = np.abs(cand[:, i] - out[i]).max(axis=-1)
            hit = np.flatnonzero(gap <= 1e-12 * np.abs(out[i]).max())
            if len(hit):
                picks[i] = (ilevel + 1, int(hit[0]))
    return picks


def _search(port, nlevel, threshtype):
    """(smooths, choices) of the port's search (the plain version, on
    the CPU) over the rows of numpy ``port``."""
    facts = torch.linspace(0.0, 3.0, NFACT, dtype=torch.float64)
    return _kernels.smooth_search(torch.as_tensor(port), "db8", nlevel,
                                  facts, 0.1, threshtype)


def _reference_candidate(port, row, pick, threshtype):
    """The reference's candidate (level, factor) ``pick`` of ``row``, its
    noise estimate over its peak, and whether it passes the chi2 gate."""
    level, f = pick
    facts = np.linspace(0.0, 3.0, NFACT)
    sm = np.asarray(jw.wavelet_smooth(port[row], "db8", level, threshtype,
                                      facts[f]))
    rho = float(jw.get_noise(sm)) / np.abs(sm).max()
    errs = float(jw.get_noise(port[row]))
    chi2 = np.sum(((port[row] - sm) / errs) ** 2) / port.shape[-1]
    return sm, rho, chi2 - 1.0 <= 0.1


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize("nbin", [256, 1000])
@pytest.mark.parametrize("wavelet", ["db2", "db8", "taps"])
def test_search_tables_match_swt_iswt(wavelet, nbin):
    """ana gives swt's details, P and Q iswt's candidate of any level from
    the profile's spectrum and the details' (an explicit filter too)."""
    if wavelet == "taps":
        wavelet = tuple(jw.daubechies_dec_lo(4))
    nlevel = 5
    rng = np.random.default_rng(nbin)
    x = rng.standard_normal((3, nbin))
    ana, P, Q = (t.numpy() for t in tw.search_tables(wavelet, nbin, nlevel,
                                                     "cpu"))
    assert ana.shape == P.shape == Q.shape == (nlevel, nbin // 2 + 1)
    X = np.fft.rfft(x, axis=-1)
    jwav = np.asarray(wavelet) if isinstance(wavelet, tuple) else wavelet
    _, cDs = jw.swt(x, nlevel, jwav)
    for j in range(nlevel):
        assert _rel(np.fft.irfft(ana[j] * X, nbin, axis=-1),
                    np.asarray(cDs[j])) <= TABLE_TOL
    for lev in range(1, nlevel + 1):
        cA = np.asarray(jw.swt(x, lev, jwav)[0])
        d = [rng.standard_normal((3, nbin)) for _ in range(lev)]
        want = np.asarray(jw.iswt(cA, d, jwav))
        S = P[lev - 1] * X + sum(Q[j] * np.fft.rfft(d[j], axis=-1)
                                 for j in range(lev))
        assert _rel(np.fft.irfft(S, nbin, axis=-1), want) <= TABLE_TOL


@pytest.mark.parametrize("threshtype", ["hard", "soft"])
@pytest.mark.parametrize("nbin,nlevel", [(256, 8), (2048, 11), (1000, 1)])
def test_plain_search_matches_reference(nbin, nlevel, threshtype):
    port = _rows(nbin, 7)
    ref = np.asarray(jw._smart_smooth_grid(port, nlevel, NFACT, 0.1, "db8",
                                           threshtype))
    got, choice = (t.numpy() for t in _search(port, nlevel, threshtype))
    zeroed = ~np.any(ref != 0.0, axis=-1)
    np.testing.assert_array_equal(~np.any(got != 0.0, axis=-1), zeroed)
    np.testing.assert_array_equal(choice[zeroed], [[0, -1]] * zeroed.sum())
    picks = [None if lev == 0 else (int(lev), int(f)) for lev, f in choice]
    want = _reference_choices(port, ref, nlevel, threshtype)
    peak = np.maximum(np.abs(ref).max(axis=-1), 1e-300)
    for i, (pick, wpick) in enumerate(zip(picks, want)):
        if pick == wpick:
            assert np.abs(got[i] - ref[i]).max() <= SMOOTH_TOL * peak[i]
            continue
        # a tie at the rounding floor: both candidates' S/N are set by
        # rounding (the reference itself picks either from call to call);
        # both pass the gate, and the port's smooth is its candidate
        sm, rho, ok = _reference_candidate(port, i, pick, threshtype)
        _, wrho, wok = _reference_candidate(port, i, wpick, threshtype)
        assert ok and wok and max(rho, wrho) < RHO_FLOOR, (i, pick, wpick)
        assert np.abs(got[i] - sm).max() <= SMOOTH_TOL * np.abs(sm).max()
    # the all-zero row and the noiseless pulse (its noise estimate at the
    # rounding floor: no candidate but the row itself passes the gate, and
    # that one has no S/N above the others') are zeroed; the noisy rows
    # are smoothed
    assert zeroed[5] and not zeroed[:5].any()


def test_soft_and_hard_choose_differently():
    """The spike keeps fine detail coefficients above the thresholds: the
    two modes choose and smooth differently (the soft path is not the
    hard one)."""
    port = _rows(256, 7)
    hard, soft = _search(port, 8, "hard"), _search(port, 8, "soft")
    assert (hard[1][3] != soft[1][3]).any()
    assert (hard[0][3] - soft[0][3]).abs().max() > 0.1


def test_smart_smooth_portrait_matches_reference():
    """A [2, 4, nbin] stack through smart_smooth (the rows flattened for the
    search), with fallback 'raw'."""
    port = _rows(256, 11)[:4]
    port = np.stack([port, port[::-1] * 0.5])
    ref = np.asarray(jw.smart_smooth(port, fallback="raw"))
    got = tw.smart_smooth(torch.as_tensor(port), fallback="raw").numpy()
    assert got.shape == port.shape
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(got - ref) <= SMOOTH_TOL * peak).all()


def test_search_is_chunk_invariant(monkeypatch):
    """Rows one at a time give the bits of rows all at once."""
    port = torch.as_tensor(_rows(256, 3))
    facts = torch.linspace(0.0, 3.0, NFACT, dtype=torch.float64)
    whole = _kernels.smooth_search(port, "db8", 8, facts, 0.1, "soft")
    monkeypatch.setattr(_kernels, "SMOOTH_CHUNK_BYTES", 1)
    assert _kernels.smooth_chunk_rows(8, NFACT, 256) == 1
    one = _kernels.smooth_search(port, "db8", 8, facts, 0.1, "soft")
    assert torch.equal(whole[0], one[0]) and torch.equal(whole[1], one[1])


def test_search_refuses_what_it_cannot_take():
    port = torch.as_tensor(_rows(256, 3))
    facts = torch.linspace(0.0, 3.0, NFACT, dtype=torch.float64)
    with pytest.raises(ValueError, match="threshold mode"):
        _kernels.smooth_search(port, "db8", 8, facts, 0.1, "garrote")
    with pytest.raises(ValueError, match="nbin even"):
        _kernels.smooth_search(port[:, :255].contiguous(), "db8", 8, facts,
                               0.1)
    with pytest.raises(TypeError, match="float64"):
        _kernels.smooth_search(port.float(), "db8", 8, facts, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        _kernels.smooth_search(port.t().contiguous().t(), "db8", 8, facts,
                               0.1)
    with pytest.raises(ValueError, match="unsupported wavelet"):
        _kernels.smooth_search(port, "sym4", 8, facts, 0.1)


_CTYPE = {"const void*": _kernels._VP, "void*": _kernels._VP,
          "int64_t": _kernels._I64, "int": _kernels._INT,
          "double": _kernels._DBL}


@pytest.mark.parametrize("symbol", sorted(_kernels._SYMBOLS["smooth_search"]))
def test_search_bindings_match_the_source(symbol):
    """Each C entry point of csrc/wavelet.cu takes, in order, the argument
    types its ctypes binding declares (the stream last, as every
    entry's)."""
    text = open(_kernels.CSRC_DIR + "/wavelet.cu").read()
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % symbol, text)
    assert m is not None
    params = [re.sub(r"\s+\w+$", "", p.strip()) for p in m.group(1).split(",")]
    assert [_CTYPE[p] for p in params] == _kernels._SYMBOLS[
        "smooth_search"][symbol]


def test_chunk_rows_bound_the_buffers():
    n = _kernels.smooth_chunk_rows(11, NFACT, 2048)
    per_row = 11 * NFACT * (2048 * 8 + 2 * 1025 * 16)
    assert n * per_row <= _kernels.SMOOTH_CHUNK_BYTES < (n + 1) * per_row
    assert math.isclose(n, 64, abs_tol=2)
