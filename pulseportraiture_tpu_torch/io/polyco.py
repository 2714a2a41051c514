"""Pulse-phase predictors: tempo POLYCO and tempo2 T2PREDICT (Chebyshev).

Real fold-mode PSRFITS archives carry the folding ephemeris as a POLYCO
or T2PREDICT HDU, and the folding period drifts across subintegrations;
the reference reads ``get_folding_period()`` from every Integration via
PSRCHIVE (pplib.py:2733, :3343).  This module is the
in-repo equivalent: evaluate pulse phase/spin frequency at arbitrary
epochs so the PSRFITS layer (io/psrfits.py) can assign every subint its
own folding period.

Conventions implemented:

* tempo polyco segments (tempo "polyco.dat"):
    DT = (T - TMID) [min],
    phase(T) = RPHASE + 60 * DT * F0ref + sum_k COEF[k] * DT**k,
    f(T) [Hz] = F0ref + (1/60) * sum_k k * COEF[k] * DT**(k-1).
* tempo2 ChebyModelSet (T2PREDICT HDU text):
    phase(T, nu) = DISPERSION_CONSTANT / nu**2 + Cheb2D(x(T), y(nu))
  with x, y the ranges mapped to [-1, 1] and the i=0 / j=0 coefficients
  taken at half weight (tempo2's summation convention); the spin
  frequency is the analytic d(phase)/dT via Chebyshev differentiation.
"""

import numpy as np

__all__ = ["PolycoSegment", "Polyco", "ChebyModel", "ChebyModelSet",
           "parse_polyco_text", "parse_t2predict_text",
           "polyco_from_spin"]


class PolycoSegment:
    """One tempo polyco block: valid for ``nspan`` minutes around tmid."""

    def __init__(self, tmid, rphase, f0ref, coeffs, nspan=1440,
                 ref_freq=0.0, site="@", log10_fit_err=0.0):
        self.tmid = float(tmid)              # MJD (TDB)
        self.rphase = float(rphase)          # reference phase [rot]
        self.f0ref = float(f0ref)            # reference spin freq [Hz]
        self.coeffs = np.asarray(coeffs, dtype=np.float64)
        self.nspan = float(nspan)            # validity span [min]
        self.ref_freq = float(ref_freq)      # observing freq [MHz]
        self.site = site
        self.log10_fit_err = float(log10_fit_err)

    def contains(self, mjd):
        return abs(mjd - self.tmid) * 1440.0 <= self.nspan / 2.0

    def phase(self, mjd):
        dt = (np.asarray(mjd, dtype=np.float64) - self.tmid) * 1440.0
        poly = np.polynomial.polynomial.polyval(dt, self.coeffs)
        return self.rphase + 60.0 * dt * self.f0ref + poly

    def freq(self, mjd):
        """Spin frequency [Hz] at mjd."""
        dt = (np.asarray(mjd, dtype=np.float64) - self.tmid) * 1440.0
        dcoef = np.polynomial.polynomial.polyder(self.coeffs) \
            if len(self.coeffs) > 1 else np.zeros(1)
        return self.f0ref + np.polynomial.polynomial.polyval(dt,
                                                             dcoef) / 60.0


class Polyco:
    """A set of polyco segments with nearest-segment dispatch."""

    def __init__(self, segments, psr=""):
        if not segments:
            raise ValueError("Polyco needs at least one segment.")
        self.segments = sorted(segments, key=lambda s: s.tmid)
        self.psr = psr

    def _segment_for(self, mjd):
        best, bestd = None, np.inf
        for seg in self.segments:
            d = abs(mjd - seg.tmid)
            if d < bestd:
                best, bestd = seg, d
        return best

    def phase(self, mjd):
        return self._segment_for(float(mjd)).phase(float(mjd))

    def freq(self, mjd):
        return self._segment_for(float(mjd)).freq(float(mjd))

    def period(self, mjd):
        """Folding period [s] at mjd (1 / spin frequency)."""
        return 1.0 / self.freq(mjd)

    def periods(self, mjds):
        return np.asarray([self.period(m) for m in np.atleast_1d(mjds)])


def polyco_from_spin(F0, F1, pepoch, tmid=None, nspan=1440, ncoef=3,
                     site="@", psr=""):
    """Exact single-segment polyco for a (F0, F1) spin-down model.

    phase(t) = F0*dt + F1/2 dt**2 (dt in s from ``pepoch``) is quadratic,
    so with F0ref = F0 + F1*dts (dts = seconds from pepoch to tmid) and
    COEF[2] = 1800*F1 the polyco reproduces it to machine precision —
    the generator-side predictor for make_fake_pulsar's drifting-period
    archives.
    """
    tmid = float(pepoch if tmid is None else tmid)
    dts = (tmid - pepoch) * 86400.0
    f0ref = F0 + F1 * dts
    rphase = F0 * dts + 0.5 * F1 * dts ** 2
    coeffs = np.zeros(max(int(ncoef), 3))
    coeffs[2] = 1800.0 * F1  # (60 s/min)^2 * F1/2
    return Polyco([PolycoSegment(tmid, rphase, f0ref, coeffs,
                                 nspan=nspan, site=site)], psr=psr)


def parse_polyco_text(text):
    """Parse tempo 'polyco.dat' blocks.

    Block layout (tempo polyco format): line 1 = name, date, utc, tmid,
    dm, doppler, log10(fit rms); line 2 = rphase, f0, site, span, ncoef,
    obs freq [, binary phase...]; then ncoef coefficients, 3 per line.
    """
    lines = [ln for ln in text.splitlines() if ln.strip()]
    segments, psr = [], ""
    i = 0
    while i + 1 < len(lines):
        head1 = lines[i].split()
        head2 = lines[i + 1].split()
        psr = head1[0]
        tmid = float(head1[3])
        log10rms = float(head1[6]) if len(head1) > 6 else 0.0
        rphase = float(head2[0])
        f0ref = float(head2[1])
        site = head2[2]
        nspan = float(head2[3])
        ncoef = int(head2[4])
        ref_freq = float(head2[5]) if len(head2) > 5 else 0.0
        coeffs = []
        i += 2
        while len(coeffs) < ncoef:
            coeffs.extend(float(tok.replace("D", "E").replace("d", "e"))
                          for tok in lines[i].split())
            i += 1
        segments.append(PolycoSegment(tmid, rphase, f0ref, coeffs[:ncoef],
                                      nspan=nspan, ref_freq=ref_freq,
                                      site=site,
                                      log10_fit_err=log10rms))
    return Polyco(segments, psr=psr)


def _cheby2d_eval(coeffs, x, y):
    """sum_ij c_ij T_i(x) T_j(y), i=0/j=0 rows at half weight.

    Returns a true Python float for scalar (x, y) inputs — chebvander
    promotes 0-d inputs to shape (1,), which would otherwise leak out
    as a size-1 array (a hard error to float() under future NumPy).
    """
    c = np.array(coeffs, dtype=np.float64)
    c[0, :] *= 0.5
    c[:, 0] *= 0.5
    Tx = np.polynomial.chebyshev.chebvander(np.asarray(x), c.shape[0] - 1)
    Ty = np.polynomial.chebyshev.chebvander(np.asarray(y), c.shape[1] - 1)
    out = np.einsum("...i,ij,...j->...", Tx, c, Ty)
    if np.ndim(x) == 0 and np.ndim(y) == 0:
        return out.reshape(()).item()
    return out.reshape(np.broadcast_shapes(np.shape(x), np.shape(y)))


class ChebyModel:
    """One tempo2 ChebyModel segment (2-D Chebyshev phase predictor)."""

    def __init__(self, mjd_start, mjd_end, freq_start, freq_end, coeffs,
                 dispersion_constant=0.0, psrname="", sitename=""):
        self.mjd_start = float(mjd_start)
        self.mjd_end = float(mjd_end)
        self.freq_start = float(freq_start)
        self.freq_end = float(freq_end)
        self.coeffs = np.asarray(coeffs, dtype=np.float64)
        self.dispersion_constant = float(dispersion_constant)
        self.psrname = psrname
        self.sitename = sitename

    def _xy(self, mjd, freq):
        x = 2.0 * (np.asarray(mjd) - self.mjd_start) \
            / (self.mjd_end - self.mjd_start) - 1.0
        y = 2.0 * (np.asarray(freq) - self.freq_start) \
            / (self.freq_end - self.freq_start) - 1.0
        return x, y

    def contains(self, mjd):
        return self.mjd_start <= mjd <= self.mjd_end

    def phase(self, mjd, freq):
        x, y = self._xy(mjd, freq)
        ph = _cheby2d_eval(self.coeffs, x, y)
        if self.dispersion_constant:
            ph = ph + self.dispersion_constant / np.asarray(freq) ** 2
        return ph

    def freq_spin(self, mjd, freq):
        """Spin frequency [Hz] = d(phase)/dt via Chebyshev derivative."""
        x, y = self._xy(mjd, freq)
        c = np.array(self.coeffs, dtype=np.float64)
        c[0, :] *= 0.5
        c[:, 0] *= 0.5
        # half-weights are folded into c, so the derivative series dc
        # evaluates with plain (unweighted) Chebyshev summation
        dc = np.polynomial.chebyshev.chebder(c, axis=0)
        Tx = np.polynomial.chebyshev.chebvander(np.asarray(x),
                                                dc.shape[0] - 1)
        Ty = np.polynomial.chebyshev.chebvander(np.asarray(y),
                                                dc.shape[1] - 1)
        dphase_dx = np.einsum("...i,ij,...j->...", Tx, dc, Ty)
        dx_dmjd = 2.0 / (self.mjd_end - self.mjd_start)
        out = dphase_dx * dx_dmjd / 86400.0
        # chebvander promotes 0-d inputs to (1,); hand scalars back as
        # true scalars so float(period(...)) stays legal under future
        # NumPy (see _cheby2d_eval)
        if np.ndim(mjd) == 0 and np.ndim(freq) == 0:
            return out.reshape(()).item()
        return out.reshape(np.broadcast_shapes(np.shape(mjd),
                                               np.shape(freq)))


class ChebyModelSet:
    """tempo2 predictor: a set of ChebyModel segments."""

    def __init__(self, models):
        if not models:
            raise ValueError("ChebyModelSet needs at least one segment.")
        self.models = models

    def _model_for(self, mjd):
        for m in self.models:
            if m.contains(mjd):
                return m
        # nearest by midpoint outside all ranges
        return min(self.models,
                   key=lambda m: abs(mjd - 0.5 * (m.mjd_start
                                                  + m.mjd_end)))

    def phase(self, mjd, freq):
        return self._model_for(float(mjd)).phase(float(mjd), freq)

    def freq(self, mjd, freq):
        return self._model_for(float(mjd)).freq_spin(float(mjd), freq)

    def period(self, mjd, freq):
        return 1.0 / self.freq(mjd, freq)

    def periods(self, mjds, freq):
        return np.asarray([self.period(m, freq)
                           for m in np.atleast_1d(mjds)])


def parse_t2predict_text(text):
    """Parse a tempo2 ChebyModelSet (T2PREDICT HDU text payload)."""
    models = []
    cur = None
    coeff_rows = []
    ncoeff_time = ncoeff_freq = None
    for ln in text.splitlines():
        tok = ln.split()
        if not tok:
            continue
        key = tok[0].upper()
        if key == "CHEBYMODELSET":
            continue
        if key == "CHEBYMODEL":
            if tok[1].upper() == "BEGIN":
                cur = {}
                coeff_rows = []
                ncoeff_time = ncoeff_freq = None
            elif tok[1].upper() == "END" and cur is not None:
                coeffs = np.asarray(coeff_rows, dtype=np.float64)
                if ncoeff_time is not None and ncoeff_freq is not None:
                    coeffs = coeffs.reshape(ncoeff_time, ncoeff_freq)
                models.append(ChebyModel(
                    cur["time0"], cur["time1"], cur["freq0"], cur["freq1"],
                    coeffs,
                    dispersion_constant=cur.get("disp", 0.0),
                    psrname=cur.get("psrname", ""),
                    sitename=cur.get("sitename", "")))
                cur = None
        elif cur is None:
            continue
        elif key == "PSRNAME":
            cur["psrname"] = tok[1]
        elif key == "SITENAME":
            cur["sitename"] = tok[1]
        elif key == "TIME_RANGE":
            cur["time0"], cur["time1"] = float(tok[1]), float(tok[2])
        elif key == "FREQ_RANGE":
            cur["freq0"], cur["freq1"] = float(tok[1]), float(tok[2])
        elif key == "DISPERSION_CONSTANT":
            cur["disp"] = float(tok[1])
        elif key == "NCOEFF_TIME":
            ncoeff_time = int(tok[1])
        elif key == "NCOEFF_FREQ":
            ncoeff_freq = int(tok[1])
        elif key == "COEFFS":
            coeff_rows.append([float(t) for t in tok[1:]])
    return ChebyModelSet(models)
