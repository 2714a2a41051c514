"""Wideband timing: parse .tim files and run a GLS timing fit.

Port of the JAX package's ``pipelines/timing.py``, which is numpy only:
a host copy, with no device work.  It closes the loop the reference's
notebook closes with tempo (examples/example_make_model_and_TOAs.ipynb
cells 43-56: a GLS fit with ``DMDATA 1`` so wideband DM measurements
enter the fit as data), in-repo; with a real ``tempo`` installed the
same two files can go to it.

The model fit is the wideband set [offset, dF0, dF1, DM]: TOA phase
residuals and DM measurements are combined in one weighted
least-squares system, the wideband-GLS structure of Pennucci+ (2014):

  r_phase_i = off + dF0 * dt_i + dF1 * dt_i^2 / 2
              + (Dconst / nu_i^2 / P) * dDM_e(i) + noise
  DM_i      = DM0 + dDM_e(i) + noise_DM

where dDM_e is either one global correction or — with ``dmx=True`` or
DMX in the par, tempo's DMDATA+DMX configuration — an independent
correction per DMX epoch (TOAs grouped into fixed-length windows like
tempo's DMX ranges).  Par-file DMX_xxxx values themselves are assumed
zero in the prefit residuals; the fit estimates them from scratch.
"""

import numpy as np

from ..config import Dconst
from ..io.parfile import read_par
from ..utils.mjd import MJD

__all__ = ["parse_tim", "phase_residuals", "rescaled_errors",
           "dmx_epochs", "wideband_gls_fit", "run_tempo_if_available"]


def parse_tim(timfile):
    """Parse an IPTA/tempo2 .tim file (as written by io.timfile).

    Returns a list of DataBunch-like dicts with archive, freq [MHz],
    mjd (two-part utils.mjd.MJD), err_us, and a flags dict (pp_dm /
    pp_dme parsed to float when present).
    """
    toas = []
    with open(timfile) as f:
        for ln in f:
            tok = ln.split()
            if not tok or tok[0] in ("FORMAT", "C", "#", "MODE"):
                continue
            arch, freq, mjd_s, err, site = tok[:5]
            day, _, frac = mjd_s.partition(".")
            flags = {}
            rest = tok[5:]
            for i in range(0, len(rest) - 1, 2):
                if rest[i].startswith("-"):
                    key = rest[i][1:]
                    try:
                        flags[key] = float(rest[i + 1])
                    except ValueError:
                        flags[key] = rest[i + 1]
            toas.append(dict(
                archive=arch, freq=float(freq),
                mjd=MJD(int(day), float("0." + frac) * 86400.0),
                err_us=float(err), site=site, flags=flags))
    return toas


def _selector_mask(toas, flag, flagval):
    """Boolean mask of TOAs whose ``-<flag> <value>`` matches a par
    selector (JUMP/T2EFAC/... lines).  parse_tim floats numeric flag
    values, so both string and numeric representations compare equal
    ('800' matches 800.0)."""
    out = np.zeros(len(toas), dtype=bool)
    for i, t in enumerate(toas):
        tv = t["flags"].get(flag)
        if tv is None:
            continue
        if str(tv) == str(flagval):
            out[i] = True
        else:
            try:
                out[i] = float(tv) == float(flagval)
            except (TypeError, ValueError):
                pass
    return out


def _jump_mask(toas, j):
    """TOA mask for one par JUMP entry, any of tempo's four forms:
    flag selector, MJD range, FREQ range [MHz], or TEL site."""
    if "lo" in j:  # JUMP MJD t1 t2 / JUMP FREQ f1 f2
        if j["flag"] == "MJD":
            vals = np.array([t["mjd"].day + t["mjd"].secs / 86400.0
                             for t in toas])
        else:
            vals = np.array([t["freq"] for t in toas])
        return (vals >= j["lo"]) & (vals <= j["hi"])
    if j["flag"] == "TEL":
        return np.array([t["site"] == j["flagval"] for t in toas],
                        dtype=bool)
    return _selector_mask(toas, j["flag"], j["flagval"])


def _jump_label(j):
    if "lo" in j:
        return "JUMP_%s_%g_%g" % (j["flag"], j["lo"], j["hi"])
    return "JUMP_%s_%s" % (j["flag"], j["flagval"])


def rescaled_errors(toas, par):
    """Per-TOA (err_us, dm_err) with par EFAC/EQUAD-style rescaling.

    tempo2 convention: sigma' = EFAC * sqrt(sigma^2 + EQUAD^2), with
    T2EFAC/T2EQUAD [us] selecting TOAs by flag and DMEFAC/DMEQUAD
    [pc cm^-3] doing the same for the wideband DM uncertainties.  A TOA
    matched by several lines of the same kind uses the first match.
    Flagless tempo1-style global lines ('EFAC 1.5') apply to every TOA
    a selector line did not match.
    Returns (err_us [ntoa], dm_err [ntoa; NaN where no -pp_dme]).
    """
    p = par if not isinstance(par, str) else read_par(par)
    err_us = np.array([t["err_us"] for t in toas], dtype=np.float64)
    dm_err = np.array([t["flags"].get("pp_dme", np.nan) for t in toas],
                      dtype=np.float64)

    def first_match(lines, global_key, default):
        # flagless global value (a plain par field) is the fallback
        # for TOAs no selector line matched
        fallback = p.get(global_key, default)
        fallback = float(fallback) if not isinstance(fallback, str) \
            else default
        vals = np.full(len(toas), np.nan)
        for ln in lines:
            m = _selector_mask(toas, ln["flag"], ln["flagval"])
            vals = np.where(np.isnan(vals) & m, ln["value"], vals)
        return np.where(np.isnan(vals), fallback, vals)

    equad = first_match(p.get("equads", []), "EQUAD", 0.0)
    efac = first_match(p.get("efacs", []), "EFAC", 1.0)
    err_us = efac * np.sqrt(err_us ** 2 + equad ** 2)
    dmequad = first_match(p.get("dmequads", []), "DMEQUAD", 0.0)
    dmefac = first_match(p.get("dmefacs", []), "DMEFAC", 1.0)
    dm_err = dmefac * np.sqrt(dm_err ** 2 + dmequad ** 2)
    return err_us, dm_err


def _dispersion_term(nu):
    """Dispersion delay per unit DM [s]; a TOA frequency of 0.0 encodes
    infinite frequency (no delay), as written by format_toa_line."""
    return np.where(nu > 0.0,
                    Dconst / np.where(nu > 0.0, nu, 1.0) ** 2.0, 0.0)


def phase_residuals(toas, par):
    """Pulse-phase residuals [rot] of TOAs against a (F0, F1, DM) par.

    A TOA is the arrival time *at its reference frequency*, so the
    ephemeris DM's dispersion delay at that frequency is removed before
    evaluating the spin phase (what tempo does with the par DM; a
    frequency of 0 encodes infinite frequency, i.e. no delay).
    Residuals are wrapped to (-0.5, 0.5].
    Returns (resid [rot], dt [s from PEPOCH], P [s]).
    """
    p = par if not isinstance(par, str) else read_par(par)
    F0 = float(p.F0)
    F1 = float(p.get("F1", 0.0))
    DM = float(p.get("DM", 0.0))
    PEPOCH = float(p.get("PEPOCH"))
    pe_day = int(PEPOCH)
    pe_sec = (PEPOCH - pe_day) * 86400.0
    nu = np.array([t["freq"] for t in toas])
    delay = DM * _dispersion_term(nu)
    dt = np.array([(t["mjd"].day - pe_day) * 86400.0
                   + (t["mjd"].secs - pe_sec) for t in toas]) - delay
    phase = F0 * dt + 0.5 * F1 * dt * dt
    resid = ((phase + 0.5) % 1.0) - 0.5
    return resid, dt, 1.0 / F0


def dmx_epochs(mjds, window_days=6.5):
    """Group TOA MJDs into DMX-style fixed-length ranges.

    Like tempo's DMX binning: sorted TOAs open a new range when they
    fall outside ``window_days`` of the current range's first TOA.
    Returns (epoch_index per TOA [int], list of (r1, r2) range bounds).
    """
    order = np.argsort(mjds)
    idx = np.empty(len(mjds), dtype=int)
    ranges = []
    start = None
    for i in order:
        if start is None or mjds[i] - start > window_days:
            start = mjds[i]
            ranges.append([mjds[i], mjds[i]])
        idx[i] = len(ranges) - 1
        ranges[-1][1] = mjds[i]
    return idx, [tuple(r) for r in ranges]


def wideband_gls_fit(toas, par, fit_dm=None, fit_f1=None, dmx=None,
                     dmx_window_days=None):
    """Weighted GLS of [phase offset, dF0, dF1, DM/DMX] on wideband TOAs.

    ``fit_dm`` defaults to True when the par has ``DMDATA 1`` (the
    notebook's convention): the per-TOA -pp_dm/-pp_dme measurements
    then enter the system as data alongside the TOA residuals.
    ``fit_f1`` defaults to the par's F1 fit flag (``F1 <val> 1``).
    ``dmx`` defaults to True when the par carries DMX (a range length
    or DMX_xxxx entries); per-epoch dDM corrections then replace the
    single global dDM, with TOAs binned into ``dmx_window_days``-long
    ranges (default: the par's DMX value, else 6.5 d, tempo's default).

    Par noise/offset extensions are honored (the reference defers these
    to tempo — notebook cells 43-56; this stage inlines them):

    - ``JUMP -flag val offset [fit]`` — a receiver/backend time offset
      [s] applied to TOAs matching ``-flag val``.  The par offset is
      removed from the prefit residuals; lines with a fit flag of 1 get
      a free column (the correction, in seconds).  Positive JUMP =
      matching TOAs arrive later.  Per-jump results land in ``jumps``.
    - ``DMJUMP -flag val offset [fit]`` — PINT's wideband per-receiver
      DM-measurement offset [pc cm^-3]: a bias of the matching TOAs'
      -pp_dm values (e.g. from template evolution misfit in one band),
      NOT a physical delay — it enters the DM data rows only.  Fixed
      offsets are subtracted from the measurements; fit=1 adds a free
      column.  Results land in ``dmjumps``.
    - ``T2EFAC/T2EQUAD`` (+ ``DMEFAC/DMEQUAD`` for the wideband DM
      uncertainties): sigma' = EFAC * sqrt(sigma^2 + EQUAD^2), tempo2's
      convention (see ``rescaled_errors``).

    Returns a dict with params, errors, per-epoch ``dmx`` results,
    per-jump ``jumps`` results, prefit/postfit weighted rms [us], chi2,
    and dof.
    """
    p = par if not isinstance(par, str) else read_par(par)
    if fit_dm is None:
        fit_dm = int(float(p.get("DMDATA", 0))) == 1
    if fit_f1 is None:
        fit_f1 = p.get("fit_flags", {}).get("F1", 0) == 1
    has_dmx = "DMX" in p or any(k.startswith("DMX_") for k in p)
    if dmx is None:
        # auto-DMX requires the wideband DM rows: per-epoch DM columns
        # constrained by phase residuals alone are rank-deficient for
        # single-frequency epochs (tempo pairs DMX with DMDATA here too)
        dmx = has_dmx and fit_dm
    if dmx_window_days is None:
        dmx_val = p.get("DMX", 6.5)
        dmx_window_days = float(dmx_val) \
            if isinstance(dmx_val, (int, float)) and dmx_val > 0 else 6.5
    DM0 = float(p.get("DM", 0.0))
    resid, dt, P = phase_residuals(toas, p)
    nu = np.array([t["freq"] for t in toas])
    err_us_r, dme_r = rescaled_errors(toas, p)
    err_rot = err_us_r * 1e-6 / P
    disp = _dispersion_term(nu) / P  # phase per unit DM

    # JUMPs: remove the par offsets from the prefit residuals (re-wrap
    # after — a jump can carry a residual across the +-0.5 boundary)
    jumps = list(p.get("jumps", []))
    jump_masks = [_jump_mask(toas, j) for j in jumps]
    for j, m in zip(jumps, jump_masks):
        if j["offset_s"]:
            resid = resid - m * (j["offset_s"] / P)
    resid = ((resid + 0.5) % 1.0) - 0.5

    # spin columns, in phase units
    cols = [np.ones_like(dt), dt]
    names = ["offset_rot", "dF0_hz"]
    if fit_f1:
        cols.append(0.5 * dt * dt)
        names.append("dF1_hz_s")
    nspin = len(cols)

    # DM columns: one global dDM, or one per DMX epoch
    if dmx:
        mjds = np.array([t["mjd"].day + t["mjd"].secs / 86400.0
                         for t in toas])
        eidx, ranges = dmx_epochs(mjds, dmx_window_days)
        nep = len(ranges)
        dm_cols = np.zeros((len(toas), nep))
        dm_cols[np.arange(len(toas)), eidx] = disp
        cols.extend(list(dm_cols.T))
        names.extend(f"DMX_{e + 1:04d}" for e in range(nep))
    else:
        eidx, ranges, nep = None, [], 0
        if fit_dm:
            cols.append(disp)
            names.append("dDM")
    # free JUMP columns (fit flag 1) go last so the DM-row indexing
    # below (columns nspin..nspin+nep) stays contiguous
    njump_start = len(cols)
    for j, m in zip(jumps, jump_masks):
        if j.get("fit", 0):
            if not m.any():
                raise ValueError(
                    "%s (fit) matches no TOAs — its design column "
                    "would be all-zero" % _jump_label(j))
            cols.append(m.astype(np.float64) / P)  # rot per second
            names.append(_jump_label(j))
    M = np.stack(cols, axis=1)
    y = resid.copy()
    w = err_rot ** -2.0

    dmjumps = list(p.get("dmjumps", []))
    dmjump_masks = [_selector_mask(toas, dj["flag"], dj["flagval"])
                    for dj in dmjumps]
    dmjump_start = M.shape[1]
    if fit_dm:
        # wideband DM measurements as data rows: DM_i - DM0 = dDM_e(i)
        dms = np.array([t["flags"].get("pp_dm", np.nan) for t in toas])
        # fixed DMJUMP offsets come off the measurements up front
        for dj, m in zip(dmjumps, dmjump_masks):
            if dj["offset_dm"]:
                dms = dms - np.where(m, dj["offset_dm"], 0.0)
        dmes = dme_r  # DMEFAC/DMEQUAD-rescaled
        okd = np.isfinite(dms) & np.isfinite(dmes) & (dmes > 0)
        Md = np.zeros((int(okd.sum()), M.shape[1]))
        if dmx:
            Md[np.arange(Md.shape[0]), nspin + eidx[okd]] = 1.0
        else:
            Md[:, nspin] = 1.0
        M = np.vstack([M, Md])
        y = np.concatenate([y, dms[okd] - DM0])
        w = np.concatenate([w, dmes[okd] ** -2.0])
        # free DMJUMP columns act on the DM rows alone
        dmjump_start = M.shape[1]
        for dj, m in zip(dmjumps, dmjump_masks):
            if dj.get("fit", 0):
                if not m[okd].any():
                    raise ValueError(
                        "DMJUMP -%s %s (fit) matches no wideband DM "
                        "rows — its design column would be all-zero"
                        % (dj["flag"], dj["flagval"]))
                col = np.concatenate([np.zeros(len(toas)),
                                      m[okd].astype(np.float64)])
                M = np.hstack([M, col[:, None]])
                names.append("DMJUMP_%s_%s" % (dj["flag"], dj["flagval"]))

    # weighted LSQ via column-scaled QR: the spin columns span ~16
    # decades (1, dt, dt^2/2 at dt~1e8 s), where forming the normal
    # equations squares an already-large condition number
    sw = np.sqrt(w)
    Aw = M * sw[:, None]
    scale = np.linalg.norm(Aw, axis=0)
    scale[scale == 0.0] = 1.0
    Q, R = np.linalg.qr(Aw / scale)
    rdiag = np.abs(np.diag(R))
    if R.shape[0] != R.shape[1] or rdiag.min() < 1e-12 * rdiag.max():
        raise ValueError(
            "singular wideband design matrix (%d rows x %d params): "
            "with dmx=True each epoch needs constraining data — DM "
            "measurement rows (DMDATA 1 + -pp_dm flags) or "
            "multi-frequency TOAs per epoch." % (M.shape[0], M.shape[1]))
    xs = np.linalg.solve(R, Q.T @ (y * sw))
    Rinv = np.linalg.solve(R, np.eye(R.shape[0]))
    cov = (Rinv @ Rinv.T) / np.outer(scale, scale)
    x = xs / scale
    errs = np.sqrt(np.diag(cov))
    post = y - M @ x
    ntoa = len(toas)
    wrms_us = np.sqrt(np.sum(w[:ntoa] * post[:ntoa] ** 2)
                      / np.sum(w[:ntoa])) * P * 1e6
    prefit_us = np.sqrt(np.sum(w[:ntoa] * resid ** 2)
                        / np.sum(w[:ntoa])) * P * 1e6
    chi2 = float(np.sum(w * post ** 2))
    dof = len(y) - M.shape[1]
    dmx_out = [dict(name=names[nspin + e], r1=ranges[e][0],
                    r2=ranges[e][1],
                    mjd_mid=0.5 * (ranges[e][0] + ranges[e][1]),
                    dDM=float(x[nspin + e]),
                    err=float(errs[nspin + e]),
                    ntoa=int(np.sum(eidx == e)))
               for e in range(nep)]
    jump_out = []
    k = njump_start
    for j, m in zip(jumps, jump_masks):
        jd = dict(flag=j["flag"], flagval=j.get("flagval"),
                  offset_s=float(j["offset_s"]),
                  fit=bool(j.get("fit", 0)), ntoa=int(m.sum()))
        if "lo" in j:
            jd["lo"], jd["hi"] = float(j["lo"]), float(j["hi"])
        if jd["fit"]:
            jd["delta_s"] = float(x[k])
            jd["err_s"] = float(errs[k])
            jd["total_s"] = jd["offset_s"] + jd["delta_s"]
            k += 1
        else:
            jd["total_s"] = jd["offset_s"]
        jump_out.append(jd)
    dmjump_out = []
    k = dmjump_start
    for dj, m in zip(dmjumps, dmjump_masks):
        dd = dict(flag=dj["flag"], flagval=dj["flagval"],
                  offset_dm=float(dj["offset_dm"]),
                  fit=bool(dj.get("fit", 0)) and fit_dm,
                  ntoa=int(m.sum()))
        if dd["fit"]:
            dd["delta_dm"] = float(x[k])
            dd["err_dm"] = float(errs[k])
            dd["total_dm"] = dd["offset_dm"] + dd["delta_dm"]
            k += 1
        else:
            dd["total_dm"] = dd["offset_dm"]
        dmjump_out.append(dd)
    return dict(params=dict(zip(names, x)),
                errors=dict(zip(names, errs)),
                dmx=dmx_out, jumps=jump_out, dmjumps=dmjump_out,
                prefit_wrms_us=float(prefit_us),
                postfit_wrms_us=float(wrms_us),
                chi2=chi2, red_chi2=chi2 / max(dof, 1), dof=dof,
                ntoa=ntoa, fit_dm=bool(fit_dm), fit_f1=bool(fit_f1))


def run_tempo_if_available(parfile, timfile, quiet=True):
    """Run the external tempo GLS fit when installed; None otherwise.

    The files are the same ones wideband_gls_fit consumes, so an
    environment with tempo/tempo_utils reproduces the reference
    notebook's end stage exactly.
    """
    import shutil
    import subprocess

    if shutil.which("tempo") is None:
        return None
    proc = subprocess.run(["tempo", "-G", "-f", parfile, timfile],
                          capture_output=True, text=True)
    if not quiet:
        print(proc.stdout)
    return proc.returncode
