"""Telescope name -> TEMPO/TEMPO2 observatory-code table.

Equivalent of telescope_codes.py: if $TEMPO2 is set, the
table is sourced from ``$TEMPO2/observatory/observatories.dat`` (+
``aliases``); otherwise a built-in table is used.  The mapping itself is
public observatory-catalog data (TEMPO2 distribution).  The first code
in each list is the one written on TOA lines (pplib.py:2676-2677).
"""

import os

__all__ = ["telescope_code_dict", "get_telescope_code"]

# name -> [primary code, aliases...]; compact (name, codes-string) pairs.
_BUILTIN = [
    ("ARECIBO", "ao 3 arecebo arecibo"), ("AXIS", "axi"),
    ("CAMBRIDGE", "cam"), ("COE", "coe"), ("DARNHALL", "l"),
    ("DE601", "EFlfr"), ("DE601HBA", "EFlfrhba"),
    ("DE601LBA", "EFlfrlba"), ("DE601LBH", "EFlfrlbh"),
    ("DE602", "UWlfr"), ("DE602HBA", "UWlfrhba"),
    ("DE602LBA", "UWlfrlba"), ("DE602LBH", "UWlfrlbh"),
    ("DE603", "TBlfr"), ("DE603HBA", "TBlfrhba"),
    ("DE603LBA", "TBlfrlba"), ("DE603LBH", "TBlfrlbh"),
    ("DE604", "POlfr"), ("DE604HBA", "POlfrhba"),
    ("DE604LBA", "POlfrlba"), ("DE604LBH", "POlfrlbh"),
    ("DE605", "JUlfr"), ("DE605HBA", "JUlfrhba"),
    ("DE605LBA", "JUlfrlba"), ("DE605LBH", "JUlfrlbh"),
    ("DE609", "NDlfr"), ("DE609HBA", "NDlfrhba"),
    ("DE609LBA", "NDlfrlba"), ("DE609LBH", "NDlfrlbh"),
    ("DEFFORD", "n"), ("DSS_43", "tid43 6"), ("EFFELSBERG", "eff g"),
    ("EFFELSBERG_ASTERIX", "effix"), ("FAST", "fast"),
    ("FI609", "Filfr"), ("FI609HBA", "Filfrhba"),
    ("FI609LBA", "Filfrlba"), ("FI609LBH", "Filfrlbh"),
    ("FR606", "FRlfr"), ("FR606HBA", "FRlfrhba"),
    ("FR606LBA", "FRlfrlba"), ("FR606LBH", "FRlfrlbh"),
    ("GB140", "gb140"), ("GB300", "gb300"), ("GB853", "gb853"),
    ("GBT", "gbt 1 gb"), ("GEO600", "geo600"), ("GMRT", "gmrt"),
    ("GOLDSTONE", "gs"), ("GRAO", "grao"), ("HAMBURG", "hamburg"),
    ("HANFORD", "lho"), ("HARTEBEESTHOEK", "hart"), ("HOBART", "hob"),
    ("JBOAFB", "jbafb"), ("JBODFB", "jbdfb q"), ("JBOROACH", "jbroach"),
    ("JB_42FT", "jb42"), ("JB_MKII", "jbmk2 h"),
    ("JB_MKII_DFB", "jbmk2dfb"), ("JB_MKII_RCH", "jbmk2roach"),
    ("JODRELL", "jb 8 y z"), ("JODRELL2", "q"), ("JODRELLM4", "jbm4"),
    ("KAGRA", "kagra"), ("KAT-7", "k7"), ("KNOCKIN", "m"),
    ("LA_PALMA", "p"), ("LIVINGSTON", "llo"), ("LOFAR", "lofar t"),
    ("LWA1", "lwa1 x"), ("MEERKAT", "meerkat m"), ("MKIII", "jbmk3 j"),
    ("MOST", "mo"), ("MWA", "mwa"), ("NANCAY", "ncy f"),
    ("NANSHAN", "NS"), ("NARRABRI", "atca 2"), ("NUPPI", "ncyobs w"),
    ("OP", "obspm"), ("PARKES", "pks 7"), ("PRINCETON", "princeton"),
    ("SE607", "ONlfr"), ("SE607HBA", "ONlfrhba"),
    ("SE607LBA", "ONlfrlba"), ("SE607LBH", "ONlfrlbh"),
    ("SRT", "srt z"), ("STL_BAT", "STL_BAT"), ("TABLEY", "k"),
    ("UAO", "NS"), ("UK608", "UKlfr"), ("UK608HBA", "UKlfrhba"),
    ("UK608LBA", "UKlfrlba"), ("UK608LBH", "UKlfrlbh"),
    ("UTR-2", "UTR2"), ("VIRGO", "virgo"), ("VLA", "vla c"),
    ("WARKWORTH_12M", "wark12m"), ("WARKWORTH_30M", "wark30m"),
    ("WSRT", "wsrt i"),
]


def _from_tempo2():
    """Source the table from $TEMPO2 observatory data, if available."""
    t2 = os.environ.get("TEMPO2")
    if not t2:
        return None
    path = os.path.join(t2, "observatory", "observatories.dat")
    if not os.path.isfile(path):
        return None
    table = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            toks = line.split()
            table[toks[-2].upper()] = [toks[-1]]
    alias_path = os.path.join(t2, "observatory", "aliases")
    if os.path.isfile(alias_path):
        with open(alias_path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                toks = line.split()
                for telescope, codes in table.items():
                    if toks[0] == codes[0]:
                        codes.extend(toks[1:])
    return table


telescope_code_dict = _from_tempo2() or {
    name: codes.split() for name, codes in _BUILTIN}


def get_telescope_code(telescope, default=None):
    """Primary TOA-line code for a telescope name (case-insensitive)."""
    codes = telescope_code_dict.get(str(telescope).upper())
    if codes:
        return codes[0]
    if default is not None:
        return default
    raise KeyError(f"Unknown telescope '{telescope}'; add it to "
                   f"telescope_code_dict or set $TEMPO2.")
