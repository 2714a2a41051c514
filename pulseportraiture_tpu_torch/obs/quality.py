"""Fit-quality observability: scientific correctness as a diffable
observable.

Wall time, device seconds, request latency, causality and memory say
how a run went — but the *product* of a wideband
timing run (Pennucci 2019's per-subint measurement statistics: reduced
chi^2, TOA error, S/N, convergence) was invisible to ``obs_diff``, so
a silently-wrong fit passed every gate.  This module turns the
per-subint quantities ``GetTOAs`` already computes into deterministic
per-run **quality fingerprints**:

* **Distributions** — reduced chi^2, TOA error [us] and S/N go into
  log-bucketed :class:`~.metrics.Histogram` series with FIXED
  geometries (the ``CHI2_*`` / ``ERR_*`` / ``SNR_*`` schema constants
  below; a geometry change is a schema change): shard merges stay
  exact integer bucket sums, and two runs' distributions are
  comparable bucket by bucket — the ``obs_diff --quality-rel``
  total-variation gate.
* **Exact counters** — subints fitted, bad fits (``red_chi2`` above
  ``$PPTPU_QUALITY_CHI2_BAD``, non-converged return codes, non-finite
  results), error-inflated subints (``red_chi2`` above
  ``$PPTPU_QUALITY_CHI2_INFLATED`` — the regime where quoted TOA
  errors understate the scatter), zapped channels — Recorder manifest
  counters plus ``pps_quality_*_total`` metrics counters, so merged
  runs sum exactly and the ``--watch`` views get a quality row.
* **Per-archive events** — one ``quality`` event per archive carrying
  the exact medians, the offending subint indices and a
  residual-whiteness statistic (lag-1 autocorrelation of the
  standardized phase residuals; Taylor 1992's FFTFIT goodness-of-fit
  intuition — a faithful template leaves white residuals), stamped
  with bucket/workload attribution from the ambient :func:`context`.

Never fatal, host-side only (call it on host arrays, after the fit's
results were copied off the card), and disabled = free: with no run active every module-level helper is one
attribute read + ``None`` check.
"""

import contextlib
import os
import threading

from . import core as _core
from . import metrics as _metrics

__all__ = ["HIST_RED_CHI2", "HIST_TOA_ERR", "HIST_SNR",
           "CTR_SUBINTS", "CTR_BAD_SUBINTS",
           "chi2_bad_threshold", "error_inflation_threshold",
           "whiteness_r1", "summarize", "record_archive", "context",
           "fingerprint", "group_fingerprints", "gt_fingerprint",
           "QualityState"]

# -- schema constants ----------------------------------------------------
# Histogram series names + FIXED geometries.  Histogram.merge is exact
# only over identical (lo, hi, per_octave); every process must build
# these series with exactly these constants, so they live here, not at
# call sites.  per_octave=8 gives ~9% relative bucket resolution.
HIST_RED_CHI2 = "pps_fit_red_chi2"
CHI2_LO, CHI2_HI, CHI2_PER_OCTAVE = 1.0 / 64, 1024.0, 8
HIST_TOA_ERR = "pps_toa_err_us"
ERR_LO, ERR_HI, ERR_PER_OCTAVE = 1e-3, 16384.0, 8
HIST_SNR = "pps_fit_snr"
SNR_LO, SNR_HI, SNR_PER_OCTAVE = 0.25, 16384.0, 8

# metrics counters (summable across shard prefixes — the --watch row)
CTR_SUBINTS = "pps_quality_subints_total"
CTR_BAD_SUBINTS = "pps_quality_bad_subints_total"

# cap on offending-subint indices carried per quality event
MAX_BAD_ISUBS = 16


def chi2_bad_threshold():
    """$PPTPU_QUALITY_CHI2_BAD: reduced-chi^2 above which a subint
    counts as a bad fit (default 3.0)."""
    v = os.environ.get("PPTPU_QUALITY_CHI2_BAD", "").strip()
    try:
        return float(v) if v else 3.0
    except ValueError:
        return 3.0


def error_inflation_threshold():
    """$PPTPU_QUALITY_CHI2_INFLATED: reduced-chi^2 above which the
    quoted TOA error understates the residual scatter (default 1.5)."""
    v = os.environ.get("PPTPU_QUALITY_CHI2_INFLATED", "").strip()
    try:
        return float(v) if v else 1.5
    except ValueError:
        return 1.5


def _converged_rcs():
    # the solver's converged return codes (obs/core.py fit_telemetry
    # owns the authoritative tuple; rc 3 = iteration budget exhausted,
    # rc 4 = damping stuck)
    return getattr(_core, "_CONVERGED_RCS", (0, 1, 2))


def whiteness_r1(phis, phi_errs=None):
    """Lag-1 autocorrelation of the standardized phase residuals of one
    archive (subint/time order): r1 = sum z_t z_{t+1} / sum z_t^2 with
    z = (phi - weighted mean) / phi_err.  A faithful template leaves
    white residuals (|r1| small); a drifting or mis-rotated one leaves
    correlated structure.  None for < 3 finite points or zero variance
    — whiteness of two subints is not a statement.
    """
    try:
        import numpy as np

        phis = np.asarray(phis, dtype=float).ravel()
        if phi_errs is None:
            errs = np.ones_like(phis)
        else:
            errs = np.asarray(phi_errs, dtype=float).ravel()
        okm = np.isfinite(phis) & np.isfinite(errs) & (errs > 0.0)
        phis, errs = phis[okm], errs[okm]
        if len(phis) < 3:
            return None
        w = errs ** -2.0
        mean = float(np.sum(w * phis) / np.sum(w))
        z = (phis - mean) / errs
        denom = float(np.sum(z * z))
        if denom <= 0.0:
            return None
        return float(np.sum(z[:-1] * z[1:]) / denom)
    except Exception:
        return None


def _median(values):
    try:
        import numpy as np

        v = np.asarray(values, dtype=float).ravel()
        v = v[np.isfinite(v)]
        return float(np.median(v)) if len(v) else None
    except Exception:
        return None


def summarize(red_chi2s, toa_errs_us, snrs=None, rcs=None, phis=None,
              phi_errs=None, n_zapped=0, isubs=None):
    """One archive's quality fingerprint from host-side per-subint
    arrays (pure computation, no recorder): exact medians, bad-fit
    breakdown (chi^2 / return code / non-finite), error-inflated
    count, residual whiteness.  Callers pass the *fitted* subints only
    (``isubs`` optionally names their archive indices for
    attribution).
    """
    import numpy as np

    chi2 = np.asarray(red_chi2s, dtype=float).ravel()
    errs = np.asarray(toa_errs_us, dtype=float).ravel()
    n = len(chi2)
    thr_bad = chi2_bad_threshold()
    thr_infl = error_inflation_threshold()
    finite = np.isfinite(chi2) & np.isfinite(errs)
    bad_chi2 = finite & (chi2 > thr_bad)
    if rcs is None:
        bad_rc = np.zeros(n, dtype=bool)
    else:
        rc = np.asarray(rcs).ravel().astype(int)
        bad_rc = ~np.isin(rc, np.asarray(_converged_rcs(), dtype=int))
    bad = bad_chi2 | bad_rc | ~finite
    inflated = finite & (chi2 > thr_infl)
    fp = {
        "n_subints": int(n),
        "n_bad": int(bad.sum()),
        "n_bad_chi2": int(bad_chi2.sum()),
        "n_bad_rc": int(bad_rc.sum()),
        "n_nonfinite": int((~finite).sum()),
        "n_error_inflated": int(inflated.sum()),
        "n_zapped": int(n_zapped),
        "bad_fit_rate": round(float(bad.sum()) / n, 6) if n else None,
        "median_red_chi2": _median(chi2),
        "max_red_chi2": float(np.max(chi2[finite]))
        if finite.any() else None,
        "median_toa_err_us": _median(errs),
        "chi2_bad_threshold": thr_bad,
    }
    if snrs is not None:
        fp["median_snr"] = _median(snrs)
    if phis is not None:
        fp["whiteness_r1"] = whiteness_r1(phis, phi_errs)
    if bad.any():
        where = np.flatnonzero(bad)
        if isubs is not None:
            idx = np.asarray(isubs).ravel()
            where = idx[where[where < len(idx)]]
        fp["bad_isubs"] = [int(i) for i in where[:MAX_BAD_ISUBS]]
    for k in ("median_red_chi2", "max_red_chi2", "median_toa_err_us",
              "median_snr", "whiteness_r1"):
        if fp.get(k) is not None:
            fp[k] = round(fp[k], 6)
    return fp


def gt_fingerprint(gt):
    """Fingerprint of the LAST archive fitted by a GetTOAs-style
    result object (the service daemon's per-request stamp: each request
    fits one archive).  Handles both the wideband per-subint arrays and
    the narrowband per-channel grids; None when nothing was fitted.
    Never fatal."""
    try:
        import numpy as np

        if not getattr(gt, "ok_isubs", None):
            return None
        ok = np.asarray(gt.ok_isubs[-1])
        chi2 = np.asarray(gt.red_chi2s[-1]) if getattr(
            gt, "red_chi2s", None) else None
        phi_errs = np.asarray(gt.phi_errs[-1])
        Ps = np.asarray(gt.Ps[-1])
        if chi2 is not None and chi2.ndim == 1:        # wideband
            rcs = np.asarray(gt.rcs[-1])[ok] if getattr(
                gt, "rcs", None) else None
            return summarize(
                chi2[ok], phi_errs[ok] * Ps[ok] * 1e6,
                snrs=np.asarray(gt.snrs[-1])[ok] if getattr(
                    gt, "snrs", None) else None,
                rcs=rcs, phis=np.asarray(gt.phis[-1])[ok],
                phi_errs=phi_errs[ok],
                n_zapped=int(gt.n_nonfinite_zapped[-1]) if getattr(
                    gt, "n_nonfinite_zapped", None) else 0,
                isubs=ok)
        if getattr(gt, "channel_red_chi2s", None):     # narrowband
            chi2 = np.asarray(gt.channel_red_chi2s[-1])
            snrs = np.asarray(gt.channel_snrs[-1])
            live = np.zeros(chi2.shape, dtype=bool)
            live[ok] = snrs[ok] > 0.0
            errs = phi_errs * Ps[:, None] * 1e6
            return summarize(chi2[live], errs[live], snrs=snrs[live],
                             phis=np.asarray(gt.phis[-1])[live],
                             phi_errs=phi_errs[live])
        return None
    except Exception:
        return None


# -- ambient attribution context (runner: bucket/workload) --------------

_tls = threading.local()


@contextlib.contextmanager
def context(bucket=None, workload=None, tenant=None):
    """Stamp quality records emitted in this thread's dynamic extent
    with runner attribution (shape bucket, workload pass, tenant) —
    the survey engine wraps each archive's fit so per-bucket and
    per-workload fingerprints come out of one shared emission point in
    the pipelines."""
    prev = getattr(_tls, "labels", None)
    _tls.labels = {k: v for k, v in (("bucket", bucket),
                                     ("workload", workload),
                                     ("tenant", tenant)) if v is not None}
    try:
        yield
    finally:
        _tls.labels = prev


def _labels():
    return getattr(_tls, "labels", None) or {}


# -- per-run aggregation -------------------------------------------------


class _Group:
    """Per-(bucket, workload) aggregate: exact counts + local fixed-
    geometry histograms for group medians (these never cross process
    boundaries — cross-shard merging happens on the registry series)."""

    __slots__ = ("n_subints", "n_bad", "n_zapped", "chi2", "err")

    def __init__(self):
        self.n_subints = 0
        self.n_bad = 0
        self.n_zapped = 0
        self.chi2 = _metrics.Histogram(CHI2_LO, CHI2_HI,
                                       CHI2_PER_OCTAVE)
        self.err = _metrics.Histogram(ERR_LO, ERR_HI, ERR_PER_OCTAVE)

    def fingerprint(self):
        n = self.n_subints
        return {"n_subints": n, "n_bad": self.n_bad,
                "n_zapped": self.n_zapped,
                "bad_fit_rate": round(self.n_bad / n, 6) if n else None,
                "median_red_chi2": self.chi2.quantile(0.5),
                "median_toa_err_us": self.err.quantile(0.5)}


class QualityState:
    """Per-recorder quality aggregation.

    Created lazily by :meth:`~.core.Recorder.quality_state` on the
    first quality record (a run that fits nothing costs nothing) and
    stopped by ``Recorder.close()``, which writes the run-level
    fingerprint gauges into the manifest.  The histogram series live
    in the run's streaming-metrics registry (creating it here is the
    same activation the memory sampler's gauges ride), so rotation,
    torn-tail discipline and exact shard merge are inherited, not
    reimplemented.
    """

    def __init__(self, recorder):
        self._recorder = recorder
        self._lock = threading.Lock()
        self.n_archives = 0
        self.n_subints = 0
        self.n_bad = 0
        self.n_zapped = 0
        self.n_error_inflated = 0
        self._groups = {}
        reg = recorder.metrics_registry()
        self._chi2 = reg.histogram(HIST_RED_CHI2, CHI2_LO, CHI2_HI,
                                   CHI2_PER_OCTAVE)
        self._err = reg.histogram(HIST_TOA_ERR, ERR_LO, ERR_HI,
                                  ERR_PER_OCTAVE)
        self._snr = reg.histogram(HIST_SNR, SNR_LO, SNR_HI,
                                  SNR_PER_OCTAVE)

    def record(self, fp, red_chi2s, toa_errs_us, snrs=None,
               labels=None):
        """Fold one archive's fingerprint + raw per-subint arrays into
        the run aggregate and the registry distributions."""
        import numpy as np

        rec = self._recorder
        for v in np.asarray(red_chi2s, dtype=float).ravel():
            self._chi2.observe(v)
        for v in np.asarray(toa_errs_us, dtype=float).ravel():
            self._err.observe(v)
        if snrs is not None:
            for v in np.asarray(snrs, dtype=float).ravel():
                self._snr.observe(v)
        reg = rec.metrics_registry()
        reg.inc(CTR_SUBINTS, fp["n_subints"])
        if fp["n_bad"]:
            reg.inc(CTR_BAD_SUBINTS, fp["n_bad"])
        rec.bump("quality_subints", fp["n_subints"])
        for ctr, key in (("quality_bad_subints", "n_bad"),
                         ("quality_bad_chi2", "n_bad_chi2"),
                         ("quality_bad_rc", "n_bad_rc"),
                         ("quality_nonfinite", "n_nonfinite"),
                         ("quality_error_inflated", "n_error_inflated"),
                         ("quality_zapped", "n_zapped")):
            if fp.get(key):
                rec.bump(ctr, fp[key])
        labels = labels or {}
        gkey = (labels.get("bucket") or "-",
                labels.get("workload") or "-")
        with self._lock:
            self.n_archives += 1
            self.n_subints += fp["n_subints"]
            self.n_bad += fp["n_bad"]
            self.n_zapped += fp["n_zapped"]
            self.n_error_inflated += fp["n_error_inflated"]
            g = self._groups.get(gkey)
            if g is None:
                g = self._groups[gkey] = _Group()
            g.n_subints += fp["n_subints"]
            g.n_bad += fp["n_bad"]
            g.n_zapped += fp["n_zapped"]
        for v in np.asarray(red_chi2s, dtype=float).ravel():
            g.chi2.observe(v)
        for v in np.asarray(toa_errs_us, dtype=float).ravel():
            g.err.observe(v)

    def fingerprint(self):
        """The run-level fingerprint (medians at histogram resolution,
        ~9% — per-archive events carry the exact ones)."""
        with self._lock:
            n = self.n_subints
            out = {"n_archives": self.n_archives, "n_subints": n,
                   "n_bad": self.n_bad, "n_zapped": self.n_zapped,
                   "n_error_inflated": self.n_error_inflated,
                   "bad_fit_rate": round(self.n_bad / n, 6)
                   if n else None}
        out["median_red_chi2"] = self._chi2.quantile(0.5)
        out["median_toa_err_us"] = self._err.quantile(0.5)
        return out

    def group_fingerprints(self):
        """{"<bucket>|<workload>": fingerprint} for every attribution
        group seen (the survey-summary breakdown)."""
        with self._lock:
            groups = dict(self._groups)
        return {"%s|%s" % k: g.fingerprint()
                for k, g in sorted(groups.items())}

    def stop(self):
        """Run end: record the run-level fingerprint as manifest
        gauges (the summary obs_report / obs_diff / bench read back
        without parsing metrics.jsonl)."""
        if not self.n_subints:
            return
        rec = self._recorder
        fp = self.fingerprint()
        for key in ("median_red_chi2", "median_toa_err_us",
                    "bad_fit_rate"):
            if fp.get(key) is not None:
                rec.set_gauge("quality_%s" % key, fp[key])


# -- module-level helpers (the instrumented-code API) -------------------


def _state():
    rec = _core._active
    if rec is None:
        return None
    return rec.quality_state()


def record_archive(archive, red_chi2s, toa_errs_us, snrs=None,
                   rcs=None, phis=None, phi_errs=None, n_zapped=0,
                   isubs=None, **extra):
    """Record one archive's fit quality into the active run (the
    single emission point both GetTOAs drivers call on the host
    arrays the TOA lines were built from).

    Emits a ``quality`` event (exact medians, bad-fit breakdown,
    whiteness, ambient bucket/workload attribution), feeds the fixed-
    geometry distribution series and bumps the exact counters.
    Returns the fingerprint dict, or None when no run is active.
    Never fatal — a quality probe must not kill
    a fit that just succeeded.
    """
    rec = _core._active
    if rec is None:
        return None
    try:
        fp = summarize(red_chi2s, toa_errs_us, snrs=snrs, rcs=rcs,
                       phis=phis, phi_errs=phi_errs,
                       n_zapped=n_zapped, isubs=isubs)
        labels = _labels()
        st = rec.quality_state()
        if st is not None:
            st.record(fp, red_chi2s, toa_errs_us, snrs=snrs,
                      labels=labels)
        ev = dict(fp)
        ev["archive"] = archive
        ev.update(labels)
        ev.update(extra)
        rec.emit("quality", **ev)
        return fp
    except Exception:
        return None


def fingerprint():
    """The active run's run-level quality fingerprint, or None when no
    run is active or nothing was recorded (bench / runner summary
    read)."""
    rec = _core._active
    if rec is None or rec._quality is None:
        return None
    st = rec.quality_state()
    if st is None or not st.n_subints:
        return None
    return st.fingerprint()


def group_fingerprints():
    """Per-(bucket, workload) fingerprints of the active run, or None
    (the survey-summary breakdown)."""
    rec = _core._active
    if rec is None or rec._quality is None:
        return None
    st = rec.quality_state()
    if st is None or not st.n_subints:
        return None
    return st.group_fingerprints()
