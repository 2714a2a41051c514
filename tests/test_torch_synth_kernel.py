"""K12's plain version (``_kernels.synth_rows_plain``, csrc/synth.cu's
single-inverse formulation in torch) against the JAX package's
``make_fake_portrait`` on the same inputs, on the CPU, and the paths and
noise draws of ``pipelines/synth.py`` around it.

Pass criteria:

* ``synth_rows_plain`` fed the port's model spectrum, rotation shifts,
  scattering spectrum, scintillation pattern, scales and weights against
  the JAX package's noiseless portrait (``key=None``), with and without
  scattering and scintillation, weights with zeros, a linear model code,
  and at 1000 bins (a width the onchip path does not take: the cufft
  path's): every row within 1e-13 of its peak (a zero-weighted row exactly
  0);
* the onchip path's transform (K8's scan inverse, ``_kernels._irfft_scan``)
  on the plain version's spectrum within 1e-14 of each row's peak of
  irfft's;
* the noise: make_fake_dataset and make_fake_portrait draw, block by
  block, what the earlier two-round-trip formulation drew from one
  generator seed — bit-equal where the model is zero, the generators'
  states equal after, and within 1e-13 of each row's peak with a real
  model;
* the path rule (onchip for a power of two from 64 to 8192 bins, else
  cufft), make_fake_* calling the wrapper once a block, the wrapper on CPU
  tensors taking the plain version bit for bit and refusing bad arguments,
  and the C entry points' arguments and width limits against the source.
"""

import math
import re

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.pipelines import synth as jsyn
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch.config import scattering_alpha
from pulseportraiture_tpu_torch.ops import fourier as tfour
from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait
from pulseportraiture_tpu_torch.ops.scattering import (scattering_portrait_FT,
                                                       scattering_times)
from pulseportraiture_tpu_torch.ops.wavelet import scan_twiddles
from pulseportraiture_tpu_torch.pipelines import synth as tsyn

MODEL = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
ZERO = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 0.0, -1.2]   # amplitude 0
TRIPLETS = [0.7, 2.5, 0.1, 0.3, 4.0, 0.6, 0.9, 1.2, 0.33]
NCHAN = 32


def _row_close(have, want, tol):
    have = have.numpy() if isinstance(have, torch.Tensor) else have
    want = np.asarray(want)
    assert have.shape == want.shape
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert (np.abs(have - want) <= tol * peak).all(), \
        float((np.abs(have - want) / np.where(peak > 0, peak, 1)).max())


def _inputs(nbin, phase=0.0, DM=0.0, t_scat=0.0, scint=None, scales=1.0,
            weights=None, nu_ref=None, nu_dm=math.inf, code="000", P=0.004):
    """synth_rows' inputs for one portrait of NCHAN channels, as
    make_fake_portrait forms them."""
    freqs = torch.linspace(1200.0, 1600.0, NCHAN, dtype=torch.float64)
    nu_ref = float(freqs.mean()) if nu_ref is None else nu_ref
    model = gen_gaussian_portrait(code, MODEL, scattering_alpha,
                                  tfour.get_bin_centers(nbin), freqs, nu_ref)
    M = torch.fft.rfft(model, dim=-1)
    one = torch.ones(1, 1, dtype=torch.float64)
    shifts = tfour.data_shifts((1, NCHAN), -phase * one, -DM * one, P, freqs,
                               nu_dm).contiguous()
    T = None
    if t_scat:
        T = scattering_portrait_FT(scattering_times(
            t_scat / P, scattering_alpha, freqs, nu_ref), nbin).contiguous()
    pattern = None if scint is None else tsyn.scintillation_pattern(
        np.asarray(scint)[None], NCHAN)
    scales = torch.broadcast_to(torch.as_tensor(scales, dtype=torch.float64),
                                (NCHAN,)).contiguous()
    w = None if weights is None else torch.as_tensor(weights,
                                                     dtype=torch.float64)
    return M, shifts, T, pattern, scales, w, freqs.numpy(), nu_ref


CASES = [
    dict(nbin=128, phase=0.13, DM=2e-3),
    dict(nbin=256, phase=-0.3, DM=-1e-3, t_scat=2e-4, scint=TRIPLETS,
         scales=np.linspace(0.5, 1.5, NCHAN),
         weights=(np.arange(NCHAN) % 5 != 0).astype(float)),
    dict(nbin=1000, phase=0.21, DM=1e-3, t_scat=1e-4, scint=TRIPLETS),
    dict(nbin=64, phase=0.4, nu_ref=1400.0, nu_dm=1500.0, code="101"),
    dict(nbin=2048, phase=0.2, DM=-2e-3, t_scat=5e-4),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "nbin%d" % c["nbin"])
def test_plain_matches_jax(case):
    kw = dict(case)
    nbin = kw.pop("nbin")
    M, shifts, T, pattern, scales, w, freqs, nu_ref = _inputs(nbin, **kw)
    out = torch.empty(1, NCHAN, nbin, dtype=torch.float64)
    assert _kernels.synth_rows_plain(M, shifts, T, pattern, scales, None, w,
                                     out) is out
    want = jsyn.make_fake_portrait(
        MODEL, NCHAN, nbin, freqs, 0.004, model_code=kw.get("code", "000"),
        nu_ref=nu_ref, phase=kw.get("phase", 0.0), DM=kw.get("DM", 0.0),
        t_scat=kw.get("t_scat", 0.0),
        scint="given" if "scint" in kw else False,
        scint_params=kw.get("scint"), scales=kw.get("scales", 1.0),
        weights=kw.get("weights"), nu_dm=kw.get("nu_dm", math.inf))
    _row_close(out[0], want, 1e-13)
    if w is not None:
        assert (out[0][w == 0] == 0).all()
    # the onchip path's transform: K8's scan inverse of the same spectrum
    if _kernels.synth_path(nbin) == "onchip":
        H = _kernels.rotate_plain(M, shifts)
        if T is not None:
            H.imag[..., 0] = 0.0
            H.imag[..., -1] = 0.0
            H = H * T
        x = _kernels._irfft_scan(H.real, H.imag, scan_twiddles(nbin, "cpu"))
        _row_close(x, torch.fft.irfft(H, n=nbin, dim=-1), 1e-14)
    # the path: onchip where it takes the width
    assert _kernels.synth_path(nbin) == (
        "onchip" if nbin != 1000 else "cufft")


def _two_round_trips(model, freqs, P, phases, DMs, nu_dm, scat_FT,
                     scint_params, scales, noise_std, generator, weights):
    """The earlier formulation of a block: rotate_data (rFFT, phasor,
    irFFT), the scattering's own round trip, add_scintillation, scales,
    torch.randn's noise, weights."""
    B = phases.shape[0]
    nchan, nbin = model.shape
    port = tfour.rotate_data(model.expand(B, nchan, nbin), -phases[:, None],
                             -DMs[:, None], P, freqs, nu_dm)
    if scat_FT is not None:
        port = torch.fft.irfft(scat_FT * torch.fft.rfft(port, dim=-1),
                               n=nbin, dim=-1)
    if scint_params is not None:
        port = tsyn.add_scintillation(port, params=scint_params)
    port = port * scales[:, None]
    if generator is not None:
        port = port + noise_std[:, None] * torch.randn(
            port.shape, generator=generator, dtype=torch.float64)
    if weights is not None:
        port = port * weights[:, None]
    return port


@pytest.mark.parametrize("params,exact", [(ZERO, True), (MODEL, False)],
                         ids=["zero_model", "model"])
def test_dataset_noise_draws_match_the_two_round_trips(params, exact,
                                                       monkeypatch):
    nsub, nchan, nbin, seed = 5, 8, 64, 11
    rng = np.random.default_rng(4)
    phases, dDMs = rng.uniform(-0.4, 0.4, nsub), rng.normal(0, 1e-3, nsub)
    kw = dict(nsub=nsub, nchan=nchan, nbin=nbin, P=0.004, phases=phases,
              dDMs=dDMs, noise_std=0.3, t_scat=1e-4, scint=True)
    monkeypatch.setattr(tsyn, "BLOCK_BYTES", 2 * nchan * nbin * 8)
    gen = torch.Generator().manual_seed(seed)
    calls = []
    orig = _kernels.synth_rows
    monkeypatch.setattr(_kernels, "synth_rows",
                        lambda *a: calls.append(a[-1].shape) or orig(*a))
    ds = tsyn.make_fake_dataset(gen, params, device="cpu", **kw)
    assert calls == [(2, nchan, nbin), (2, nchan, nbin), (1, nchan, nbin)]
    # the earlier formulation, block by block, from the same seed
    ref = torch.Generator().manual_seed(seed)
    model = gen_gaussian_portrait("000", params, scattering_alpha,
                                  tfour.get_bin_centers(nbin), ds.freqs,
                                  ds.nu_ref)
    scat = scattering_portrait_FT(scattering_times(
        1e-4 / 0.004, scattering_alpha, ds.freqs, ds.nu_ref), nbin)
    trip = tsyn.scintillation_params(np.random.default_rng(seed), nsin=3,
                                     amax=1.0, wmax=5.0, size=(nsub,))
    ones = torch.ones(nchan, dtype=torch.float64)
    want = torch.cat([_two_round_trips(
        model, ds.freqs, 0.004, ds.phases_inj[s], ds.dDMs_inj[s], ds.nu_ref,
        scat, trip[s], ones, 0.3 * ones, ref, None)
        for s in (slice(0, 2), slice(2, 4), slice(4, 5))])
    assert torch.equal(torch.as_tensor(gen.get_state()),
                       torch.as_tensor(ref.get_state()))
    if exact:
        assert torch.equal(ds.subints, want)
    else:
        _row_close(ds.subints, want, 1e-13)


def test_portrait_noise_is_the_generator_draw():
    freqs = np.linspace(1200.0, 1600.0, 16)
    port = tsyn.make_fake_portrait(ZERO, 16, 128, freqs, 0.004, phase=0.2,
                                   noise_std=0.5, device="cpu",
                                   weights=np.linspace(0.0, 1.0, 16),
                                   generator=torch.Generator().manual_seed(7))
    n = torch.randn((1, 16, 128), generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64)[0]
    w = torch.as_tensor(np.linspace(0.0, 1.0, 16))
    assert torch.equal(port, (0.5 * n) * w[:, None])


def test_route_rule_and_counts(monkeypatch):
    """The path rule; make_fake_portrait calls _kernels.synth_rows once
    (its plain version on the CPU, the same bits as calling that
    directly); the CPU counts no path."""
    for nbin, path in ((64, "onchip"), (2048, "onchip"), (8192, "onchip"),
                       (32, "cufft"), (1000, "cufft"), (16384, "cufft"),
                       (1, "cufft")):
        assert _kernels.synth_path(nbin) == path
    freqs = np.linspace(1200.0, 1600.0, 8)
    kw = dict(phase=0.1, t_scat=1e-4, noise_std=0.2, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(_kernels, "synth_rows", _kernels.synth_rows_plain)
        plain = tsyn.make_fake_portrait(
            MODEL, 8, 64, freqs, 0.004,
            generator=torch.Generator().manual_seed(2), **kw)
    calls = []
    orig = _kernels.synth_rows
    monkeypatch.setattr(_kernels, "synth_rows",
                        lambda *a: calls.append(a[-1].shape) or orig(*a))
    p0 = dict(_kernels.SYNTH_PATHS)
    wrapped = tsyn.make_fake_portrait(
        MODEL, 8, 64, freqs, 0.004, generator=torch.Generator().manual_seed(2),
        **kw)
    assert calls == [(1, 8, 64)]
    assert _kernels.SYNTH_PATHS == p0
    assert torch.equal(wrapped, plain)


def _args(nbin=64, B=2):
    M, shifts, T, pattern, scales, w, _, _ = _inputs(nbin, phase=0.1,
                                                     t_scat=1e-4,
                                                     scint=TRIPLETS)
    shifts = shifts.expand(B, NCHAN).contiguous()
    pattern = pattern.expand(B, NCHAN).contiguous()
    sigma = torch.full((NCHAN,), 0.2, dtype=torch.float64)
    w = torch.linspace(0.0, 1.0, NCHAN, dtype=torch.float64)
    out = torch.randn((B, NCHAN, nbin), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1))
    return [M, shifts, T, pattern, scales, sigma, w, out]


def test_wrapper_on_the_cpu_is_the_plain_version():
    a, b = _args(), _args()
    n0 = dict(_kernels.LAUNCHES)
    _kernels.synth_rows(*a)
    _kernels.synth_rows_plain(*b)
    assert torch.equal(a[-1], b[-1])
    assert _kernels.LAUNCHES == n0          # the plain version counts none
    # sigma None: out is only written, its contents ignored
    c, d = _args(), _args()
    d[-1].fill_(7.0)
    _kernels.synth_rows(*c[:5], None, *c[6:])
    _kernels.synth_rows(*d[:5], None, *d[6:])
    assert torch.equal(c[-1], d[-1])


@pytest.mark.parametrize("i,bad,err", [
    (0, lambda t: t[:, :-1].contiguous(), ValueError),      # M's width
    (1, lambda t: t.t(), ValueError),                       # not contiguous
    (1, lambda t: None, TypeError),                         # shifts needed
    (2, lambda t: t.to(torch.complex64), TypeError),
    (3, lambda t: t[:1], ValueError),                       # pattern rows
    (4, lambda t: None, TypeError),                         # scales needed
    (7, lambda t: t[..., :-1], ValueError),                 # out's width
])
def test_wrapper_refuses_bad_arguments(i, bad, err):
    a = _args()
    a[i] = bad(a[i])
    with pytest.raises(err):
        _kernels.synth_rows(*a)


_CTYPE = {"const void*": _kernels._VP, "void*": _kernels._VP,
          "int64_t": _kernels._I64, "int": _kernels._INT,
          "double": _kernels._DBL}


def test_binding_and_limits_match_the_source():
    """pp_synth_rows, pp_synth_harmonics and pp_synth_finish take, in
    order, the argument types their ctypes bindings declare; pp_synth_rows
    refuses the widths synth_path sends to the cufft path; synth.cu is a
    built source with a launch count, its onchip and staged row kernels
    both named by the trace name and the harmonics kernel not, and includes
    K7's phasor header (which rotate.cu includes too) and the
    transforms'."""
    text = open(_kernels.CSRC_DIR + "/synth.cu").read()
    for sym in ("pp_synth_rows", "pp_synth_harmonics", "pp_synth_finish"):
        m = re.search(r'extern "C" int %s\(([^)]*)\)' % sym, text)
        params = [re.sub(r"\s+\w+$", "", p.strip())
                  for p in m.group(1).split(",")]
        assert [_CTYPE[p] for p in params] == \
            _kernels._SYMBOLS["synth_rows"][sym], sym
    assert "nbin < %d || nbin > %d" % (_kernels.SYNTH_MIN_BINS,
                                       _kernels.SYNTH_MAX_BINS) in text
    assert _kernels._source_files("synth.cu") == [
        "synth.cu", "fft_block.cuh", "phasor.cuh"]
    assert _kernels._source_files("rotate.cu") == ["rotate.cu", "phasor.cuh"]
    assert "synth.cu" in _kernels.SOURCES and "synth_rows" in \
        _kernels.LAUNCHES
    kernels = re.findall(r"^(\w+)\(", text, re.M)
    name = _kernels.TRACE_NAMES["synth_rows"]
    assert sorted(k for k in kernels if name in k) == [
        "synth_rows_onchip_kernel", "synth_rows_staged_kernel"]
    assert "synth_harmonics_kernel" in kernels
