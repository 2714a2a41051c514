"""The port's wideband GLS timing stage against the JAX package's.

``pipelines/timing.py`` is numpy only; the port keeps its own copy.
The same .tim and par files go through both packages.  Pass criteria:

* on the committed ``tests/data/golden_wb.*``: parse_tim equal field
  for field, wideband_gls_fit within 1e-12 relative of the reference
  (errors, wrms, chi2; parameters within 1e-12 of their errors), and
  against ``golden_wb_expected.json`` at test_timing_crossval.py's
  tolerance (5e-3 of each error; errors 1e-6 relative);
* on a two-receiver wideband .tim written by the port's write_TOAs:
  rescaled_errors, phase_residuals and dmx_epochs equal within 1e-12,
  and the GLS as above under every par extension — DMX, JUMP (flag,
  MJD, FREQ and TEL forms; fitted and fixed), DMJUMP, T2EFAC/T2EQUAD,
  DMEFAC/DMEQUAD, global EFAC — and with DMDATA off;
* run_tempo_if_available returns None without tempo, in both.
"""

import json
import os

import numpy as np
import pytest

from pulseportraiture_tpu.pipelines import timing as jt
from pulseportraiture_tpu_torch.config import Dconst
from pulseportraiture_tpu_torch.io.timfile import TOA, write_TOAs
from pulseportraiture_tpu_torch.pipelines import timing as tt
from pulseportraiture_tpu_torch.utils.mjd import MJD

HERE = os.path.dirname(os.path.abspath(__file__))
TIMF = os.path.join(HERE, "data", "golden_wb.tim")
PARF = os.path.join(HERE, "data", "golden_wb.par")
EXPECTED = json.load(open(os.path.join(HERE, "data",
                                       "golden_wb_expected.json")))
F0, PEPOCH, DM0 = 100.0, 56000.0, 30.0


def _same_toas(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["archive"] == y["archive"] and x["site"] == y["site"]
        assert x["freq"] == y["freq"] and x["err_us"] == y["err_us"]
        assert (x["mjd"].day, x["mjd"].secs) == (y["mjd"].day, y["mjd"].secs)
        assert x["flags"] == y["flags"]


def _same_fit(have, want):
    assert list(have["params"]) == list(want["params"])
    for name, value in want["params"].items():
        err = want["errors"][name]
        assert abs(have["params"][name] - value) <= 1e-12 * err, name
        assert have["errors"][name] == pytest.approx(err, rel=1e-12)
    for key in ("prefit_wrms_us", "postfit_wrms_us", "chi2", "red_chi2"):
        assert have[key] == pytest.approx(want[key], rel=1e-12), key
    for key in ("dof", "ntoa", "fit_dm", "fit_f1"):
        assert have[key] == want[key], key
    assert len(have["dmx"]) == len(want["dmx"])
    for d, e in zip(have["dmx"], want["dmx"]):
        assert (d["name"], d["r1"], d["r2"], d["ntoa"]) == \
            (e["name"], e["r1"], e["r2"], e["ntoa"])
        assert d["dDM"] == pytest.approx(e["dDM"], abs=1e-12 * e["err"])
        assert d["err"] == pytest.approx(e["err"], rel=1e-12)
    for key in ("jumps", "dmjumps"):
        assert len(have[key]) == len(want[key])
        for d, e in zip(have[key], want[key]):
            assert list(d) == list(e)
            for k in d:
                if isinstance(e[k], float):
                    assert d[k] == pytest.approx(e[k], rel=1e-12,
                                                 abs=1e-18), (key, k)
                else:
                    assert d[k] == e[k], (key, k)


def test_golden_files():
    have, want = tt.parse_tim(TIMF), jt.parse_tim(TIMF)
    _same_toas(have, want)
    fit = tt.wideband_gls_fit(have, PARF)
    _same_fit(fit, jt.wideband_gls_fit(want, PARF))
    for name in ("offset_rot", "dF0_hz", "dDM"):
        err = EXPECTED["errors"][name]
        assert abs(fit["params"][name] - EXPECTED[name]) < 5e-3 * err
        assert fit["errors"][name] == pytest.approx(err, rel=1e-6)
    assert fit["postfit_wrms_us"] == pytest.approx(
        EXPECTED["postfit_wrms_us"], rel=2e-3)
    assert fit["chi2"] == pytest.approx(EXPECTED["chi2"], rel=2e-3)
    assert fit["dof"] == EXPECTED["dof"]


@pytest.fixture(scope="module")
def two_receiver_tim(tmp_path_factory):
    """48 wideband TOAs over 4 epochs 10 days apart, two receivers and
    two sites, with a per-epoch DM wander, a RcvrB time offset and a
    RcvrB DM bias injected."""
    rng = np.random.default_rng(6)
    P = 1.0 / F0
    toas = []
    for ep in range(4):
        dDM = 3e-4 * (ep - 1.5)
        for i in range(12):
            fe = "RcvrA" if i % 2 else "RcvrB"
            nu = (800.0 if fe == "RcvrA" else 1500.0) + 40.0 * (i // 2)
            n = round((ep * 10 * 86400.0 + i * 1800.0) * F0)
            resid = 0.01 + 2e-10 * n * P + Dconst * dDM * nu ** -2.0 / P \
                + rng.normal(0, 0.8e-6 / P) + (2e-6 / P if fe == "RcvrB"
                                               else 0.0)
            dt = (n + resid) * P + Dconst * DM0 * nu ** -2.0
            toas.append(TOA(
                "e%d.fits" % ep, nu, MJD(int(PEPOCH), dt), 0.8,
                "AO" if i % 3 == 0 else "GBT", "ao" if i % 3 == 0 else "gbt",
                DM=DM0 + dDM + (5e-4 if fe == "RcvrB" else 0.0)
                + rng.normal(0, 2e-4), DM_error=2e-4,
                flags={"fe": fe, "snr": 50.0 + i}))
    d = tmp_path_factory.mktemp("tim")
    timf = str(d / "two.tim")
    write_TOAs(toas, outfile=timf, append=False)
    return d, timf


PAR_BASE = "PSR J0\nF0 %.1f 1\nPEPOCH %.1f\nDM %.1f\n" % (F0, PEPOCH, DM0)


@pytest.mark.parametrize("extra,kw", [
    ("DMDATA 1\n", {}),
    ("DMDATA 1\nDMX 6.5\nF1 0.0 1\n", {}),
    ("DMDATA 1\nDMX 6.5\nJUMP -fe RcvrB 0.0 1\nDMJUMP -fe RcvrB 0.0 1\n",
     {}),
    ("DMDATA 1\nJUMP -fe RcvrB 1.5e-6\nDMJUMP -fe RcvrB 4e-4\n"
     "T2EFAC -fe RcvrB 1.3\nT2EQUAD -fe RcvrA 0.2\nDMEFAC -fe RcvrA 1.1\n"
     "DMEQUAD -fe RcvrB 1e-4\n", {}),
    ("DMDATA 1\nEFAC 1.2\nDMEFAC 1.5\nJUMP MJD 56009.0 56011.0 0.0 1\n"
     "JUMP FREQ 1400 1800 1.0d-6\nJUMP TEL ao 0.0 1\n", {}),
    ("DMDATA 0\n", {}),
    ("DMDATA 1\n", dict(dmx=True, dmx_window_days=2.0, fit_f1=True)),
    ("DMDATA 1\nDMX 6.5\n", dict(fit_dm=True, dmx=False)),
])
def test_gls_against_reference(two_receiver_tim, extra, kw, tmp_path):
    _, timf = two_receiver_tim
    parf = str(tmp_path / "wb.par")
    with open(parf, "w") as f:
        f.write(PAR_BASE + extra)
    have, want = tt.parse_tim(timf), jt.parse_tim(timf)
    _same_toas(have, want)
    for a, b in zip(tt.rescaled_errors(have, parf),
                    jt.rescaled_errors(want, parf)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    for a, b in zip(tt.phase_residuals(have, parf)[:2],
                    jt.phase_residuals(want, parf)[:2]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    _same_fit(tt.wideband_gls_fit(have, parf, **kw),
              jt.wideband_gls_fit(want, parf, **kw))


def test_dmx_epochs_and_tempo():
    mjds = np.array([5.0, 0.0, 0.1, 7.0, 30.0, 6.4, 36.6])
    for window in (6.5, 1.0):
        a, b = tt.dmx_epochs(mjds, window), jt.dmx_epochs(mjds, window)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    assert tt.run_tempo_if_available(PARF, TIMF) == \
        jt.run_tempo_if_available(PARF, TIMF)
