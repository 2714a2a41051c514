"""Comparison of two .tim files written by the two packages' pptoas.

Shared by the port's CLI parity tests (tests/test_torch_*.py): TOA MJDs
within 1 ns, identical flag sets, every printed value to its last
printed digit (the scattering flags within the tau/alpha bounds of
tests/test_torch_fit.py, and any flag given in ``flag_rtol`` within
that relative tolerance).
"""

import numpy as np


def lines(path, skip_comments=False):
    """The lines of a .tim file but FORMAT, split; ``skip_comments``
    drops the comment lines too (a checkpoint's "C pp_done" markers)."""
    skip = ("FORMAT", "C ", "#") if skip_comments else ("FORMAT",)
    return [ln.split() for ln in open(path).read().splitlines()
            if ln and not ln.startswith(skip)]


def flags(tok):
    return dict(zip(tok[5::2], tok[6::2]))


# scattering flags: the fits agree within 5e-7 in log10 tau and 1e-5 in
# alpha (tests/test_torch_fit.py), so these may differ in the last digit
# printed by more than its rounding; bounds on the printed values
SCAT_TOL = {"scat_time": 1e-5, "scat_time_err": 1e-5,
            "log10_scat_time": 5e-7, "log10_scat_time_err": 1e-5,
            "scat_ind": 1e-5, "scat_ind_err": 1e-5}


def assert_same_tim(tport, tref, n, freq_rtol=1e-9, flag_rtol=None,
                    skip_comments=False):
    """``freq_rtol``: the reference-frequency column; the zero-covariance
    frequency of a GM or scattering fit is a ratio of sums that cancel,
    and moves by ~1e-9 relative with rounding (its TOA moving with it, so
    the MJDs still agree within 1 ns).  ``flag_rtol``: {flag: relative
    tolerance} for values that may differ by more than their printed
    digits (the errors of ill-conditioned fits).  ``skip_comments``: as
    for :func:`lines`; otherwise a comment line fails the count."""
    port, ref = lines(tport, skip_comments), lines(tref, skip_comments)
    assert len(port) == len(ref) == n
    for p, r in zip(port, ref):
        assert p[0] == r[0] and p[4] == r[4]          # archive, site
        day_p, frac_p = p[2].split(".")
        day_r, frac_r = r[2].split(".")
        dt_ns = ((int(day_p) - int(day_r))
                 + float("0." + frac_p) - float("0." + frac_r)) * 86400e9
        assert abs(dt_ns) < 1.0, (p[2], r[2])
        np.testing.assert_allclose(float(p[1]), float(r[1]), rtol=freq_rtol)
        np.testing.assert_allclose(float(p[3]), float(r[3]), atol=1.5e-3)
        fp, fr = flags(p), flags(r)
        assert list(fp) == list(fr)
        for key in fp:
            try:
                vp, vr = float(fp[key]), float(fr[key])
            except ValueError:
                assert fp[key] == fr[key], key
                continue
            if np.isnan(vr):  # e.g. the error of a degenerate fit
                assert np.isnan(vp), key
                continue
            # printed values: agree to the last printed digit
            last = 10.0 ** -(len(fr[key].split(".")[1])
                             if "." in fr[key] else 0)
            tol = 1.5 * last * max(1.0, abs(vr) * 1e-6)
            if key in SCAT_TOL:
                tol = max(tol, last + SCAT_TOL[key] * max(1.0, abs(vr)))
            if flag_rtol and key[1:] in flag_rtol:
                tol = max(tol, flag_rtol[key[1:]] * abs(vr))
            assert abs(vp - vr) <= tol, (key, fp[key], fr[key])
