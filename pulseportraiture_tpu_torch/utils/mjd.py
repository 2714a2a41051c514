"""Two-part MJD arithmetic with sub-nanosecond precision.

Replacement for the PSRCHIVE ``pr.MJD`` objects the reference leans on
(epochs from archives, TOA epochs: pplib.py:2634-2648, pptoas.py:527-530).
A single float64 MJD only resolves ~1 us at MJD ~ 55000; TOAs need ns, so
the day is kept as an integer and the in-day offset in seconds as a
float64 (resolution ~1e-11 s).
"""

__all__ = ["MJD"]


class MJD:
    """MJD as (integer day, seconds into the day)."""

    __slots__ = ("day", "secs")

    def __init__(self, day=0, secs=0.0):
        day = int(day)
        secs = float(secs)
        extra, secs = divmod(secs, 86400.0)
        self.day = day + int(extra)
        self.secs = secs

    @classmethod
    def from_mjd(cls, mjd):
        """Build from a float MJD (precision-limited; prefer two-part)."""
        day = int(mjd // 1)
        return cls(day, (mjd - day) * 86400.0)

    @classmethod
    def from_imjd_smjd(cls, imjd, smjd, offs=0.0):
        """From PSRFITS STT_IMJD / STT_SMJD / STT_OFFS fields."""
        return cls(int(imjd), float(smjd) + float(offs))

    def intday(self):
        return self.day

    def fracday(self):
        return self.secs / 86400.0

    def in_seconds(self):
        return self.day * 86400.0 + self.secs

    def mjd(self):
        return self.day + self.secs / 86400.0

    def add_seconds(self, secs):
        return MJD(self.day, self.secs + secs)

    def __add__(self, other):
        if isinstance(other, MJD):
            return MJD(self.day + other.day, self.secs + other.secs)
        return MJD(self.day, self.secs + float(other) * 86400.0)

    def __sub__(self, other):
        """Difference in seconds (MJD) or shifted MJD (scalar days)."""
        if isinstance(other, MJD):
            return (self.day - other.day) * 86400.0 + \
                (self.secs - other.secs)
        return MJD(self.day, self.secs - float(other) * 86400.0)

    def __eq__(self, other):
        return isinstance(other, MJD) and self.day == other.day and \
            self.secs == other.secs

    def __lt__(self, other):
        return (self.day, self.secs) < (other.day, other.secs)

    def __le__(self, other):
        return (self.day, self.secs) <= (other.day, other.secs)

    def __hash__(self):
        return hash((self.day, self.secs))

    def __repr__(self):
        return f"MJD({self.day}, {self.secs!r})"

    def format_parts(self, frac_digits=15):
        """(day, '.ddd...') strings with rounding carried into the day.

        Naive '%.15f' % fracday() prints a time within ~4e-12 day of
        midnight as '1.000...' next to the *old* integer day — a TOA
        early by a full day.  Rounding is applied first and the carry
        propagated.
        """
        frac = self.fracday()
        rounded = round(frac, frac_digits)
        day = self.day
        if rounded >= 1.0:
            day += 1
            rounded = 0.0
        return day, ("%.*f" % (frac_digits, rounded))[1:]

    def __str__(self):
        day, frac = self.format_parts(15)
        return f"{day}{frac}"
