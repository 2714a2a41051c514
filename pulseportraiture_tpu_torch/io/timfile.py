"""TOA records and TOA-file writers (IPTA/tempo2 and Princeton formats).

Equivalent of the reference's TOA class (pptoas.py:31-73)
and ``filter_TOAs``/``write_princeton_TOA``/``write_TOAs``
(pplib.py:3386-3509), minus the Py2 ``exec``-based
attribute plumbing (SURVEY.md §7.4 calls that out as an artifact not to
reproduce) — flags live in a plain dict with operator-based filtering.
"""

import operator

import numpy as np

__all__ = ["TOA", "filter_TOAs", "write_TOAs", "write_princeton_TOA",
           "format_toa_line"]

_OPS = {">": operator.gt, ">=": operator.ge, "<": operator.lt,
        "<=": operator.le, "==": operator.eq, "!=": operator.ne}


class TOA:
    """One time-of-arrival measurement with metadata flags.

    archive: source file name; frequency: reference frequency [MHz] (may
    be inf); MJD: utils.mjd.MJD epoch; TOA_error [us]; telescope /
    telescope_code; DM/DM_error [cm**-3 pc] for wideband TOAs; flags: a
    dict of arbitrary '-flag value' pairs for the .tim line.
    """

    def __init__(self, archive, frequency, MJD, TOA_error, telescope,
                 telescope_code, DM=None, DM_error=None, flags=None):
        self.archive = archive
        self.frequency = frequency
        self.MJD = MJD
        self.TOA_error = TOA_error
        self.telescope = telescope
        self.telescope_code = telescope_code
        self.DM = DM
        self.DM_error = DM_error
        self.flags = dict(flags or {})

    def get(self, flag, default=None):
        """Flag value, falling back to real attributes (snr, gof, ...)."""
        if flag in self.flags:
            return self.flags[flag]
        return getattr(self, flag, default)

    def __repr__(self):
        return (f"TOA({self.archive}, {self.frequency} MHz, "
                f"{self.MJD}, +/-{self.TOA_error} us)")

    def write_TOA(self, inf_is_zero=True, outfile=None):
        write_TOAs(self, inf_is_zero=inf_is_zero, outfile=outfile,
                   append=True)


def filter_TOAs(TOAs, flag, cutoff, criterion=">=", pass_unflagged=False,
                return_culled=False):
    """Filter TOAs on a flag/attribute against a cutoff.

    Equivalent of pplib.py:3386-3413 with the exec-based
    comparison replaced by operator dispatch.
    """
    comp = _OPS[criterion]
    new_toas, culled = [], []
    for toa in TOAs:
        val = toa.get(flag)
        if val is not None:
            (new_toas if comp(val, cutoff) else culled).append(toa)
        else:
            (new_toas if pass_unflagged else culled).append(toa)
    if return_culled:
        return new_toas, culled
    return new_toas


def _format_flag_value(flag, value):
    if isinstance(value, str):
        return value
    if isinstance(value, (bool, np.bool_)):
        return "%d" % int(value)
    if isinstance(value, (int, np.integer)):
        return "%d" % value
    if "_cov" in flag:
        return "%.1e" % value
    if "phs" in flag:
        return "%.8f" % value
    if "flux" in flag:
        return "%.5f" % value
    return "%.3f" % value


def format_toa_line(toa, inf_is_zero=True):
    """One loosely-IPTA/tempo2 .tim line, with -pp_dm/-pp_dme wideband
    flags (format per pplib.py:3478-3503)."""
    freq = toa.frequency
    if freq == np.inf and inf_is_zero:
        freq = 0.0
    day, frac = toa.MJD.format_parts(15)
    line = "%s %.8f %d%s   %.3f  %s" % (toa.archive, freq, day, frac,
                                        toa.TOA_error,
                                        toa.telescope_code)
    if toa.DM is not None:
        line += " -pp_dm %.7f" % toa.DM
    if toa.DM_error is not None:
        line += " -pp_dme %.7f" % toa.DM_error
    for flag, value in toa.flags.items():
        if value is not None:
            line += " -%s %s" % (flag, _format_flag_value(flag, value))
    return line


def write_TOAs(TOAs, inf_is_zero=True, SNR_cutoff=0.0, outfile=None,
               append=True):
    """Write .tim lines to outfile (append by default) or stdout.

    Equivalent of pplib.py:3451-3509, plus the
    ``FORMAT 1`` header tempo2/PINT expect at the top of an IPTA-format
    tim file — emitted whenever this call starts a fresh file (the
    reference leaves it to the user's editor).
    """
    import os

    toas = TOAs if isinstance(TOAs, (list, tuple)) else [TOAs]
    toas = filter_TOAs(toas, "snr", SNR_cutoff, ">=", pass_unflagged=False)
    lines = [format_toa_line(t, inf_is_zero) for t in toas]
    if outfile is None:
        for line in lines:
            print(line)
    elif lines:
        fresh = not append or not os.path.exists(outfile) \
            or os.path.getsize(outfile) == 0
        with open(outfile, "a" if append else "w") as of:
            if fresh:
                of.write("FORMAT 1\n")
            of.write("".join(line + "\n" for line in lines))
    elif not append and os.path.exists(outfile):
        # all TOAs culled: an overwrite call must still truncate (stale
        # TOAs from a previous run would otherwise survive), but leave
        # no header-only file behind and create nothing new
        open(outfile, "w").close()


def write_princeton_TOA(TOA_MJDi, TOA_MJDf, TOA_err, nu_ref, dDM, obs="@",
                        name=" " * 13, outfile=None):
    """Princeton-format TOA line (columns per tempo documentation).

    Equivalent of pplib.py:3415-3449 — and usable from
    the TOA pipeline, fixing the reference's dangling
    ``write_princeton_TOAs`` call (pptoas.py:1589).
    """
    if nu_ref == np.inf:
        nu_ref = 0.0
    toa = "%5d" % int(TOA_MJDi) + ("%.13f" % TOA_MJDf)[1:]
    line = obs + " %13s %8.3f %s %8.3f              %9.5f" % \
        (name, nu_ref, toa, TOA_err, dDM)
    if outfile is None:
        print(line)
    else:
        with open(outfile, "a") as of:
            of.write(line + "\n")
    return line
