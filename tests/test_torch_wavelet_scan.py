"""K8's scan and certification (csrc/wavelet.cu pp_wavelet_scan,
pp_wavelet_certify) through their plain versions on the CPU, against the
route (the candidates' round trips through the FFT library, the
_kernels._route_candidates_plain stages), smooth_search_plain and the JAX
package's _smart_smooth_grid.

The scan reads every candidate's S/N and chi2 from its own transforms
(_kernels._fft_scan: Stockham radix-2/4 passes over a host twiddle table),
so it rounds otherwise than the route.  The S/N of a candidate whose noise
lies near the round trip's rounding floor moves with that rounding: the
scan's and the route's differ by ~1e-5 relative where the candidate's
noise is 1e-12 of its peak, 1e-14 where it is 1e-4 of it (my CPU runs).
So the certification does not compare values: it takes intervals, drawn
per row from a worst-case bound on floating-point FFT error (Higham's
Theorem 24.2, _kernels._cert_bounds_plain: G on the gap of a candidate's
two spectra, En on its noise, delta on the square root of its chi2), and
a row stands when the scan's choice's lower bound beats every other
candidate's upper bound (_kernels.CERT_MARGIN).  The FFT library's part of
that premise is checked on each row's own data: its rFFT of the row and
irFFT of C_0 within 2 eps of the scan's, else the row goes to the route.

Inputs are seeded numpy rows: the rows of test_torch_wavelet_search.py
(pure noise, a two-Gaussian pulse plus noise at S/N ~3, 30 and 300, the
pulse with a one-bin spike, an all-zero row, the noiseless pulse), pure
noise rows, and the mixed rows of test_torch_cuda_paths.py.  Pass
criteria: (1) the scan's transforms within 1e-14 of each row's norm of
torch.fft's; (2) every candidate's route noise, square root of its signal
power and of its chi2 within a sixteenth of the bounds (the CPU shows them
~1e-3 of the bounds), the route's S/N within [lo, hi] drawn from the
bounds, and off the floor (noise >= 1e-4 of the peak) the two S/N and chi2
within 1e-12 relative; the repeat flags equal; the library's transforms
of each row pass the check, and a transform moved beyond the bound fails
it; (3) every row that holds two or more gated candidates at the rounding
floor (noise below RHO_FLOOR of the peak, where the reference's own choice
changes from call to call) is uncertain, and every certified row's (level,
factor) is smooth_search_plain's and the JAX reference's (its output equal
to that candidate within 1e-12 of its peak); with the bounds set to 0 the
rule certifies rows whose choice the rounding decides, and some differ
from plain's; (4) the three tiers through the plain versions give
smooth_search_plain's (level, factor) on every row and its smooths within
SMOOTH_TOL of each row's peak.
"""

import math

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.ops import wavelet as jw
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch.ops.wavelet import (scan_twiddles,
                                                    search_maxima,
                                                    search_tables)

NFACT = 30
TOL = 0.1
SMOOTH_TOL = 1e-10
FFT_TOL = 1e-14
# the rounding floor of test_torch_wavelet_search.py
RHO_FLOOR = 1e-14
# off the floor: candidates whose noise is at least this share of their
# peak, where the scan and the route agree to 1e-12
OFF_FLOOR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(nbin, seed):
    """test_torch_wavelet_search.py's rows: the pulse plus noise at S/N ~3,
    30 and 300, the pulse with a one-bin spike, pure noise, an all-zero
    row and the noiseless pulse."""
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


def _noise(nbin, seed):
    return np.random.default_rng(seed).standard_normal((4, nbin))


def _mixed(nbin, seed, rows=12):
    """test_torch_cuda_paths.py's rows: pulses of S/N ~0.3 to ~300, the
    spiked pulse, loud noise, all-zero and noiseless rows."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    pulse = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2) \
        + 0.5 * np.exp(-0.5 * ((x - 0.5) / 0.04) ** 2)
    spike = np.exp(-0.5 * ((x - 0.3) * nbin) ** 2)
    out = []
    for i in range(rows):
        noise = rng.standard_normal(nbin) * 0.1
        out.append([pulse * rng.uniform(0.1, 10.0) + noise,
                    pulse + 10.0 * spike + noise, noise * 10.0,
                    np.zeros(nbin), pulse,
                    pulse * rng.uniform(1.0, 3.0) + noise][i % 6])
    return np.array(out)


def _facts():
    return torch.linspace(0.0, 3.0, NFACT, dtype=torch.float64)


def _scan(port, nlevel, threshtype):
    """(stats, same) of the plain scan, the set-up's errs, and the
    arguments of _kernels._cert_bounds_plain after errs."""
    nbin = port.shape[1]
    tables = search_tables("db8", nbin, nlevel, "cpu")
    tw = scan_twiddles(nbin, "cpu")
    maxima = search_maxima("db8", nbin, nlevel, "cpu")
    X, cD, errs, lam = _kernels._setup_plain(port, tables[0], _facts())
    stats, same = _kernels._scan_plain(
        port, X, cD, lam, errs, tables[1], tables[2], tw,
        threshtype == "soft", maxima)
    return stats, same, errs, (X, cD, tables[0][0], maxima, tw)


def _certify(port, stats, same, errs, more):
    X, cD, ana0, maxima, tw = more
    return _kernels._certify_plain(port, X, cD, stats, same, errs, TOL,
                                   ana0, maxima, tw)


def _route(port, nlevel, threshtype):
    """The route's candidates: (snr, chi2, noise, sig, peak, same, errs),
    snr not gated, noise get_noise_PS of each smooth, peak its largest
    magnitude."""
    rows, nbin = port.shape
    nh = nbin // 2 + 1
    kc = _kernels.noise_kc(nh)
    tables = search_tables("db8", nbin, nlevel, "cpu")
    t = torch.empty((rows, nlevel, NFACT, nbin), dtype=torch.float64)
    d = torch.empty((rows, nlevel, NFACT, nh), dtype=torch.complex128)
    errs, snr, chi2, same = _kernels._route_candidates_plain(
        port, tables, _facts(), threshtype == "soft", t, d)
    pw = _kernels._power(d)
    noise = torch.sqrt(pw[..., kc:].sum(-1) / nbin / (nh - kc))
    return (snr, chi2, noise, pw[..., 1:].sum(-1), t.abs().amax(-1), same,
            errs)


@pytest.mark.parametrize("inverse", [False, True], ids=["rfft", "irfft"])
@pytest.mark.parametrize("nbin", [64, 256, 2048, 4096])
def test_scan_transforms_match_torch_fft(nbin, inverse):
    rng = np.random.default_rng(nbin)
    x = torch.as_tensor(rng.standard_normal((5, nbin)))
    tw = scan_twiddles(nbin, "cpu")
    X = torch.fft.rfft(x, dim=-1)
    norm = torch.linalg.vector_norm(x, dim=-1)
    if inverse:
        got = _kernels._irfft_scan(X.real, X.imag, tw)
        gap = (got - torch.fft.irfft(X, n=nbin, dim=-1)).abs().amax(-1)
    else:
        re, im = _kernels._rfft_scan(x, tw)
        gap = torch.maximum((re - X.real).abs().amax(-1),
                            (im - X.imag).abs().amax(-1))
        norm = norm * math.sqrt(nbin)       # Parseval: |X| ~ sqrt(nbin) |x|
    assert bool((gap <= FFT_TOL * norm).all()), gap / norm


@pytest.mark.parametrize("nbin", [64, 2048, 8192])
def test_scan_twiddles_follow_the_passes(nbin):
    """After the nbin natural entries, each pass's twiddles in the order
    pp_wavelet_scan's butterflies read them: entry (q - 1) p + k of a pass
    of radix R over p points done is the table's q k nbin / (R p)."""
    tw = scan_twiddles(nbin, "cpu")
    off, p = nbin, 1
    for R in _kernels._radices(nbin // 2):
        q = torch.arange(1, R)[:, None]
        k = torch.arange(p)[None, :]
        want = tw[(q * k * (nbin // (R * p))).flatten()]
        assert torch.equal(tw[off:off + (R - 1) * p], want)
        off += (R - 1) * p
        p *= R
    assert off == tw.shape[0] and p == nbin // 2


SCAN_CASES = [(256, 8, "hard", "rows"), (2048, 11, "hard", "rows"),
              (2048, 11, "soft", "rows"), (2048, 11, "hard", "noise")]


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "%d-%d-%s-%s" % c)
def test_scan_within_the_route_bounds(case):
    nbin, nlevel, mode, kind = case
    port = torch.as_tensor(_rows(nbin, 7) if kind == "rows"
                           else _noise(nbin, 5))
    stats, same, errs, more = _scan(port, nlevel, mode)
    snr, chi2, noise, sig, peak, rsame, rerrs = _route(port, nlevel, mode)
    assert torch.equal(same.bool(), rsame)
    assert torch.equal(errs, rerrs)
    dup = torch.cumprod(rsame.to(torch.int64), dim=1).bool()
    X, cD, ana0, maxima, tw = more
    G, En, delta, bad = _kernels._cert_bounds_plain(port, X, cD, errs, stats,
                                                     ana0, maxima, tw)
    assert not bool(bad.any())
    s_snr, s_chi2, s_noise, s_sig, _ = stats.unbind(-1)
    # within a sixteenth of the bounds
    assert bool(((s_noise - noise).abs() <= En / 16.0).all())
    assert bool(((s_sig.sqrt() - sig.sqrt()).abs() <= G / 16.0).all())
    assert bool(((s_chi2.sqrt() - chi2.sqrt()).abs() <= delta / 16.0).all())
    c = math.sqrt(0.5 * nbin)
    lo = torch.clamp(s_sig.sqrt() - G, min=0.0) ** 2 / ((s_noise + En) * c)
    nlo = s_noise - En
    hi = torch.where(nlo > 0.0, (s_sig.sqrt() + G) ** 2 / (nlo * c),
                     math.inf)
    live = ~dup & (sig > 0.0)
    assert bool(((snr >= lo) & (snr <= hi))[live].all())
    # off the floor the two agree to the last digits (the chi2 where the
    # residual is not itself at the floor: a candidate that keeps every
    # coefficient is the row, its chi2 rounding)
    off = ~dup & (noise >= OFF_FLOOR * peak) & (snr > 0.0)
    assert bool(off.any())
    rel = ((s_snr - snr).abs() / snr)[off]
    assert float(rel.max()) <= 1e-12
    off = off & (chi2 >= 1e-6)
    assert float(((s_chi2 - chi2).abs() / chi2)[off].max()) <= 1e-12


def _reference_choices(port, out, nlevel, threshtype):
    """Per row, the first (level, factor) of the JAX reference's grid whose
    candidate is its output (within 1e-12 of its peak); None where the row
    was zeroed."""
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


CERT_CASES = [(2048, 11, "hard", "rows", 7), (2048, 11, "soft", "rows", 11),
              (2048, 11, "hard", "noise", 5), (2048, 11, "soft", "noise", 6),
              (256, 8, "hard", "rows", 3)]


@pytest.mark.parametrize("case", CERT_CASES,
                         ids=lambda c: "%d-%d-%s-%s%d" % c)
def test_certified_rows_match_plain_and_reference(case):
    nbin, nlevel, mode, kind, seed = case
    np_port = _rows(nbin, seed) if kind == "rows" else _noise(nbin, seed)
    port = torch.as_tensor(np_port)
    stats, same, errs, more = _scan(port, nlevel, mode)
    choice, uncertain = _certify(port, stats, same, errs, more)
    # rows with two or more gated candidates at the floor are uncertain
    snr, chi2, noise, _, peak, rsame, _ = _route(port, nlevel, mode)
    dup = torch.cumprod(rsame.to(torch.int64), dim=1).bool()
    floor = ~dup & (chi2 - 1.0 <= TOL) & (noise < RHO_FLOOR * peak)
    nonzero = (port != 0.0).any(-1)
    many = (floor.flatten(1).sum(1) >= 2) & nonzero
    assert bool(uncertain[many].all())
    # certified rows: plain's and the reference's (level, factor)
    _, want = _kernels.smooth_search_plain(port, "db8", nlevel, _facts(), TOL,
                                           mode)
    ok = ~uncertain
    assert bool(ok.any()) or kind == "noise"
    assert torch.equal(choice[ok], want[ok])
    ref = np.asarray(jw._smart_smooth_grid(np_port, nlevel, NFACT, TOL, "db8",
                                           mode))
    picks = _reference_choices(np_port, ref, nlevel, mode)
    for i in torch.nonzero(ok)[:, 0].tolist():
        lev, f = choice[i].tolist()
        assert picks[i] == (None if lev == 0 else (lev, f)), (i, picks[i])


def test_a_zero_bound_certifies_what_rounding_decides(monkeypatch):
    """With the bounds set to 0 the rule certifies rows whose choice the
    rounding floor decides: some of those differ from plain's."""
    port = torch.as_tensor(np.concatenate([_rows(2048, s)[:5]
                                           for s in (7, 11, 3)]))
    bounds = _kernels._cert_bounds_plain

    def zero(*a):
        G, En, delta, bad = bounds(*a)
        return G * 0.0, En * 0.0, delta * 0.0, bad

    monkeypatch.setattr(_kernels, "_cert_bounds_plain", zero)
    stats, same, errs, more = _scan(port, 11, "hard")
    choice, uncertain = _certify(port, stats, same, errs, more)
    _, want = _kernels.smooth_search_plain(port, "db8", 11, _facts(), TOL)
    ok = ~uncertain
    assert bool((choice[ok] != want[ok]).any(-1).any())


@pytest.mark.parametrize("moved", ["rfft", "irfft"])
def test_a_library_transform_beyond_the_bound_fails_the_check(moved):
    """The certification's check of the FFT library on a row's own data:
    the set-up's rFFT of x (X) and irFFT of C_0 (cD_0) pass as they come;
    one harmonic of X, or one bin of cD_0, moved by 4 eps of the norm the
    check draws its bound from, fails it, and the row is uncertain."""
    nbin, nlevel = 2048, 11
    port = torch.as_tensor(_rows(nbin, 7)[1:3])
    stats, same, errs, more = _scan(port, nlevel, "hard")
    X, cD, ana0, maxima, tw = more
    assert not bool(_kernels._cert_bounds_plain(port, X, cD, errs, stats,
                                                ana0, maxima, tw)[3].any())
    eps = _kernels._cert_eps(nbin)
    X2, cD2 = X.clone(), cD.clone()
    if moved == "rfft":
        X2[0, 5] += 4.0 * eps * math.sqrt(nbin) * float(port[0].norm())
    else:
        C0 = ana0 * X[1]
        cD2[1, 0, 7] += 4.0 * eps * math.sqrt(2.0 / nbin) * float(C0.abs(
        ).norm())
    bad = _kernels._cert_bounds_plain(port, X2, cD2, errs, stats, ana0,
                                      maxima, tw)[3]
    assert bad.tolist() == ([True, False] if moved == "rfft"
                            else [False, True])
    _, uncertain = _kernels._certify_plain(port, X2, cD2, stats, same, errs,
                                           TOL, ana0, maxima, tw)
    assert bool(uncertain[0 if moved == "rfft" else 1])


@pytest.mark.parametrize("wavelet", ["db8", "taps"])
def test_search_maxima_are_the_tables(wavelet):
    """search_maxima: max_k |Q[j, k]| per level, then max_k |P[l, k]| per
    level, of search_tables' own tables (numpy's and torch's complex
    magnitudes may differ in the last bit)."""
    if wavelet == "taps":
        from pulseportraiture_tpu_torch.ops.wavelet import daubechies_dec_lo
        wavelet = tuple(daubechies_dec_lo(2))
    _, P, Q = search_tables(wavelet, 256, 8, "cpu")
    m = search_maxima(wavelet, 256, 8, "cpu")
    assert torch.allclose(m[:8], Q.abs().amax(-1), rtol=4 * 2.0 ** -53,
                          atol=0.0)
    assert torch.equal(m[8:], P.abs().amax(-1))


TIER_CASES = [(2048, 11, "hard", "rows", 7), (2048, 11, "soft", "mixed", 5),
              (256, 8, "soft", "mixed", 3), (64, 6, "hard", "mixed", 9),
              (1000, 1, "hard", "rows", 3)]


@pytest.mark.parametrize("case", TIER_CASES,
                         ids=lambda c: "%d-%d-%s-%s%d" % c)
def test_three_tiers_match_plain(case):
    nbin, nlevel, mode, kind, seed = case
    port = torch.as_tensor(_rows(nbin, seed) if kind == "rows"
                           else _mixed(nbin, seed))
    want, wchoice = _kernels.smooth_search_plain(port, "db8", nlevel,
                                                 _facts(), TOL, mode)
    got, choice, uncertain = _kernels._smooth_tiers(
        port, "db8", nlevel, _facts(), TOL, mode, None, None, card=False)
    assert torch.equal(choice, wchoice)
    peak = want.abs().amax(-1).clamp(min=1e-300)
    assert bool(((got - want).abs().amax(-1) <= SMOOTH_TOL * peak).all())
    if _kernels.scannable(nbin):
        # some rows certified, some through the route
        assert 0 < len(uncertain) < port.shape[0]
    else:
        assert uncertain is None


def test_scan_chunk_rows_bound_the_buffers():
    n = _kernels.scan_chunk_rows(11, NFACT, 2048)
    per_row = 11 * (1025 * 16 + 2048 * 8) + 11 * NFACT * 44
    assert n * per_row <= _kernels.SMOOTH_CHUNK_BYTES < (n + 1) * per_row
    assert n >= 512       # ppalign -s's [512, 2048] in one chunk
    assert [_kernels.scannable(n) for n in (32, 64, 1000, 2048, 8192,
                                            16384)] == [False, True, False,
                                                        True, True, False]
