"""Minimal pulsar-ephemeris (.par) reader.

Replacement for the optional external ``parfile`` module the reference
uses (pplib.py:3271-3302 falls back to manual parsing of
PSR/PSRJ, RAJ, DECJ, F0/P0, PEPOCH, DM).  All fields are kept; values
are typed as float where they parse, with fit-flag and uncertainty
columns preserved.
"""

import numpy as np

from ..utils.databunch import DataBunch

__all__ = ["read_par", "write_par"]

_STRING_FIELDS = {"PSR", "PSRJ", "PSRB", "RAJ", "DECJ", "RA", "DEC",
                  "EPHEM", "CLK", "CLOCK", "UNITS", "TZRSITE", "BINARY",
                  "TIMEEPH", "T2CMETHOD", "CORRECT_TROPOSPHERE", "PLANET_SHAPIRO",
                  "DILATEFREQ", "INFO", "NITS", "IBOOT", "DMDATA"}

# repeatable flag-selector lines: "<KEY> -<flag> <flagval> <value> ..."
# (tempo2/PINT noise+offset extensions).  Stored as lists, not fields:
#   JUMP     -> par.jumps    [{flag, flagval, offset_s, fit}] for the
#       flag form; tempo's non-flag forms parse too, as
#       {flag: "MJD"|"FREQ", lo, hi, offset_s, fit} and
#       {flag: "TEL", flagval: site, offset_s, fit}
#   DMJUMP   -> par.dmjumps  [{flag, flagval, offset_dm, fit}]  (PINT's
#       wideband per-receiver DM-measurement offset, pc cm^-3)
#   T2EFAC / EFAC   -> par.efacs    [{flag, flagval, value}]
#   T2EQUAD / EQUAD -> par.equads   [{flag, flagval, value}]  (us)
#   DMEFAC   -> par.dmefacs  |  DMEQUAD -> par.dmequads  (pc cm^-3)
_SELECTOR_KEYS = {"JUMP": "jumps", "DMJUMP": "dmjumps",
                  "T2EFAC": "efacs", "EFAC": "efacs",
                  "T2EQUAD": "equads", "EQUAD": "equads",
                  "DMEFAC": "dmefacs", "DMEQUAD": "dmequads"}
_OFFSET_FIELD = {"JUMP": "offset_s", "DMJUMP": "offset_dm"}


def _float_ftn(tok):
    return float(tok.replace("D", "E").replace("d", "e"))


def _fit_flag(toks, i):
    return int(toks[i]) if len(toks) > i \
        and toks[i].lstrip("+-").isdigit() else 0


def _parse_value(key, value):
    if key in _STRING_FIELDS:
        return value
    try:
        return float(value.replace("D", "E").replace("d", "e"))
    except ValueError:
        return value


def read_par(parfile):
    """Parse a .par file into a DataBunch.

    Returns fields by name (e.g. par.PSR, par.DM, par.F0), plus derived
    ``P0`` (from F0 if absent), ``fit_flags`` and ``uncertainties``
    dicts for lines carrying extra columns.
    """
    fields = {}
    fit_flags = {}
    uncertainties = {}
    selectors = {name: [] for name in set(_SELECTOR_KEYS.values())}
    with open(parfile) as f:
        for line in f:
            toks = line.split()
            if not toks or toks[0].startswith("#"):
                continue
            key = toks[0]
            if len(toks) < 2:
                continue
            if key in _SELECTOR_KEYS and len(toks) >= 4 \
                    and toks[1].startswith("-"):
                entry = DataBunch(flag=toks[1][1:], flagval=toks[2],
                                  value=_float_ftn(toks[3]))
                if key in _OFFSET_FIELD:
                    entry[_OFFSET_FIELD[key]] = entry.pop("value")
                    entry["fit"] = _fit_flag(toks, 4)
                selectors[_SELECTOR_KEYS[key]].append(entry)
                continue
            if key == "JUMP" and toks[1].upper() in ("MJD", "FREQ") \
                    and len(toks) >= 5:
                # tempo's range forms: JUMP MJD t1 t2 off [fit]
                selectors["jumps"].append(DataBunch(
                    flag=toks[1].upper(), lo=_float_ftn(toks[2]),
                    hi=_float_ftn(toks[3]),
                    offset_s=_float_ftn(toks[4]),
                    fit=_fit_flag(toks, 5)))
                continue
            if key == "JUMP" and toks[1].upper() == "TEL" \
                    and len(toks) >= 4:
                selectors["jumps"].append(DataBunch(
                    flag="TEL", flagval=toks[2],
                    offset_s=_float_ftn(toks[3]),
                    fit=_fit_flag(toks, 4)))
                continue
            fields[key] = _parse_value(key, toks[1])
            if len(toks) >= 3:
                try:
                    fit_flags[key] = int(toks[2])
                except ValueError:
                    pass
            if len(toks) >= 4:
                try:
                    uncertainties[key] = float(toks[3])
                except ValueError:
                    pass
    if "P0" not in fields and "F0" in fields:
        fields["P0"] = 1.0 / np.float64(fields["F0"])
    if "F0" not in fields and "P0" in fields:
        fields["F0"] = 1.0 / np.float64(fields["P0"])
    if "PSR" not in fields and "PSRJ" in fields:
        fields["PSR"] = fields["PSRJ"]
    return DataBunch(fit_flags=fit_flags, uncertainties=uncertainties,
                     **selectors, **fields)


_SELECTOR_WRITE_KEYS = {"jumps": "JUMP", "dmjumps": "DMJUMP",
                        "efacs": "T2EFAC", "equads": "T2EQUAD",
                        "dmefacs": "DMEFAC", "dmequads": "DMEQUAD"}


def write_par(parfile, fields, fit_flags=None, quiet=True):
    """Write a simple .par file from a mapping of field -> value."""
    fit_flags = fit_flags or {}
    with open(parfile, "w") as f:
        for key, value in fields.items():
            if key in ("fit_flags", "uncertainties"):
                continue
            if key in _SELECTOR_WRITE_KEYS:
                for s in value:
                    if key == "jumps" and "lo" in s:
                        line = "%-12s %s %.15g %.15g %.15g %d" % (
                            "JUMP", s["flag"], s["lo"], s["hi"],
                            s["offset_s"], s.get("fit", 0))
                    elif key == "jumps" and s["flag"] == "TEL":
                        line = "%-12s TEL %s %.15g %d" % (
                            "JUMP", s["flagval"], s["offset_s"],
                            s.get("fit", 0))
                    else:
                        val = s.get("offset_s",
                                    s.get("offset_dm", s.get("value")))
                        line = "%-12s -%s %s %.15g" % (
                            _SELECTOR_WRITE_KEYS[key], s["flag"],
                            s["flagval"], val)
                        if key in ("jumps", "dmjumps"):
                            line += " %d" % s.get("fit", 0)
                    f.write(line + "\n")
                continue
            if isinstance(value, float):
                line = "%-12s %.15g" % (key, value)
            else:
                line = "%-12s %s" % (key, value)
            if key in fit_flags:
                line += " %d" % fit_flags[key]
            f.write(line + "\n")
    if not quiet:
        print("%s written." % parfile)
