"""Minimal FITS container I/O: headers + binary tables, pure NumPy.

The reference reaches PSRFITS through the external PSRCHIVE C++ library
(pplib.py:35 and SURVEY.md §0/L0); this framework keeps
archive I/O in-repo.  Only the FITS subset PSRFITS needs is implemented:
the primary HDU (header-only) and BINTABLE extensions with column types
L, X, B, I, J, K, E, D, A and TDIM reshaping.  All multi-byte fields are
big-endian per the FITS standard.

``read_fits`` copies no part of the file's bytes: each HDU's header and
table are parsed from a ``memoryview`` of the one buffer read, and the
int16 DATA column of a table stays as stored (a big-endian view into that
buffer, row stride NAXIS1), so the archive loader packs it once into its
upload buffer and the decode kernel swaps the bytes; every other numeric
column is converted to native byte order.
"""

import numpy as np

__all__ = ["Header", "HDU", "read_fits", "write_fits"]

BLOCK = 2880
CARD = 80

# FITS binary-table type code -> (numpy big-endian dtype, item size)
_TFORM_DTYPES = {
    "L": ("S1", 1), "B": (">u1", 1), "I": (">i2", 2), "J": (">i4", 4),
    "K": (">i8", 8), "E": (">f4", 4), "D": (">f8", 8), "A": ("S1", 1),
}


class Header(dict):
    """Ordered FITS header: mapping of keyword -> value, plus comments."""

    def __init__(self):
        super().__init__()
        self.comments = {}
        self.order = []

    def set(self, key, value, comment=""):
        if key not in self:
            self.order.append(key)
        self[key] = value
        if comment:
            self.comments[key] = comment

    @staticmethod
    def _parse_value(raw):
        raw = raw.strip()
        if raw.startswith("'"):
            end = raw.rfind("'")
            return raw[1:end].rstrip()
        if raw in ("T", "F"):
            return raw == "T"
        try:
            if any(c in raw for c in ".EeDd") and not raw.isdigit():
                return float(raw.replace("D", "E").replace("d", "e"))
            return int(raw)
        except ValueError:
            return raw

    @classmethod
    def from_bytes(cls, buf):
        """Parse header cards until END from ``buf`` (bytes or a
        memoryview: only one card at a time is copied); returns (header,
        ncards_blocks)."""
        hdr = cls()
        offset = 0
        while True:
            card = bytes(buf[offset:offset + CARD]).decode("ascii",
                                                           "replace")
            offset += CARD
            key = card[:8].strip()
            if key == "END":
                break
            if key in ("COMMENT", "HISTORY", ""):
                continue
            body = card[8:]
            if not body.startswith("= "):
                continue
            rest = body[2:]
            # strip inline comment (outside quoted strings)
            if rest.lstrip().startswith("'"):
                q2 = rest.find("'", rest.find("'") + 1)
                val_str = rest[:q2 + 1]
            else:
                slash = rest.find("/")
                val_str = rest if slash < 0 else rest[:slash]
            hdr.set(key, cls._parse_value(val_str))
        nblocks = (offset + BLOCK - 1) // BLOCK
        return hdr, nblocks

    @staticmethod
    def _format_value(value):
        if isinstance(value, bool):
            return "T" if value else "F"
        if isinstance(value, (int, np.integer)):
            return "%20d" % value
        if isinstance(value, (float, np.floating)):
            s = "%20.14G" % value
            return s if len(s) <= 20 else "%20.8G" % value
        s = str(value)
        return "'%-8s'" % s if len(s) <= 8 else "'%s'" % s

    def to_bytes(self):
        cards = []
        for key in self.order:
            val = self._format_value(self[key])
            comment = self.comments.get(key, "")
            card = "%-8s= %20s" % (key, val)
            if comment:
                card += " / " + comment
            cards.append(card[:CARD].ljust(CARD))
        cards.append("END".ljust(CARD))
        data = "".join(cards).encode("ascii")
        pad = (-len(data)) % BLOCK
        return data + b" " * pad


class HDU:
    """One header-data unit: header + (for BINTABLE) dict of columns."""

    def __init__(self, header=None, columns=None, name=""):
        self.header = header or Header()
        self.columns = columns or {}
        self.name = name or self.header.get("EXTNAME", "")


def _parse_tform(tform):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    return repeat, code


def _parse_tdim(tdim):
    return tuple(int(v) for v in tdim.strip().strip("()").split(","))


def _read_bintable(header, raw):
    nrow = header["NAXIS2"]
    rowbytes = header["NAXIS1"]
    tfields = header["TFIELDS"]
    names, fmts, shapes = [], [], {}
    for i in range(1, tfields + 1):
        name = str(header.get(f"TTYPE{i}", f"COL{i}")).strip()
        repeat, code = _parse_tform(str(header[f"TFORM{i}"]))
        dt, _ = _TFORM_DTYPES[code]
        names.append(name)
        if code == "A":
            fmts.append(("S%d" % repeat) if repeat else "S1")
        else:
            fmts.append("%d%s" % (repeat, dt) if repeat != 1 else dt)
        if f"TDIM{i}" in header:
            # FITS TDIM is Fortran (fastest-first); numpy is C — reverse.
            shapes[name] = tuple(reversed(_parse_tdim(
                str(header[f"TDIM{i}"]))))
    dtype = np.dtype({"names": names, "formats": fmts})
    if dtype.itemsize != rowbytes:
        raise ValueError(f"BINTABLE row size mismatch: dtype "
                         f"{dtype.itemsize} vs NAXIS1 {rowbytes}")
    table = np.frombuffer(raw[:nrow * rowbytes], dtype=dtype)
    columns = {}
    for name in names:
        col = table[name]
        if name in shapes:
            col = col.reshape((nrow,) + shapes[name])
        if col.dtype.kind in "iuf" and name != "DATA":
            col = col.astype(col.dtype.newbyteorder("="))
        columns[name] = col
    return columns


def read_fits(path):
    """Read a FITS file into a list of HDUs (module docstring: the DATA
    column stays a big-endian view of the file's bytes)."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    hdus = []
    offset = 0
    while offset < len(buf):
        header, nblocks = Header.from_bytes(buf[offset:])
        offset += nblocks * BLOCK
        columns = {}
        if header.get("XTENSION", "").strip() == "BINTABLE":
            nbytes = header["NAXIS1"] * header["NAXIS2"]
            columns = _read_bintable(header, buf[offset:offset + nbytes])
            offset += ((nbytes + BLOCK - 1) // BLOCK) * BLOCK
        elif header.get("NAXIS", 0) > 0:
            nbytes = abs(header.get("BITPIX", 8)) // 8
            for i in range(1, header["NAXIS"] + 1):
                nbytes *= header[f"NAXIS{i}"]
            offset += ((nbytes + BLOCK - 1) // BLOCK) * BLOCK
        hdus.append(HDU(header, columns))
        if not header.get("XTENSION") and not hdus[0].header.get("EXTEND",
                                                                 True):
            break
    return hdus


def _column_tform(arr):
    """(tform, big-endian dtype str, per-row shape) for a column array."""
    kind = arr.dtype.kind
    if kind in ("S", "U"):
        size = int(arr.dtype.itemsize if kind == "S"
                   else arr.dtype.itemsize // 4)
        return "%dA" % size, "S%d" % size, ()
    per_row = int(np.prod(arr.shape[1:], dtype=int))
    code = {"f4": "E", "f8": "D", "i2": "I", "i4": "J", "i8": "K",
            "u1": "B"}[arr.dtype.str[-2:]]
    dt, _ = _TFORM_DTYPES[code]
    fmt = "%d%s" % (per_row, dt) if per_row != 1 else dt
    return ("%d%s" % (per_row, code) if per_row != 1 else code), fmt, \
        arr.shape[1:]


def write_bintable_hdu(name, columns, extra_header=None):
    """Build a BINTABLE HDU from an ordered {name: array} mapping.

    Arrays are [nrow, ...]; multi-dim columns get TDIM.  extra_header:
    ordered (key, value, comment) triples appended after the standard
    table keywords.
    """
    names = list(columns)
    nrow = len(next(iter(columns.values()))) if columns else 0
    fmts, tforms, tdims = [], [], {}
    for cname in names:
        arr = np.asarray(columns[cname])
        if arr.dtype.kind == "U":
            arr = arr.astype("S%d" % max(1, max((len(s) for s in
                                                 arr.ravel().astype(str)),
                                                default=1)))
            columns[cname] = arr
        tform, fmt, shape = _column_tform(arr)
        tforms.append(tform)
        fmts.append(fmt)
        if len(shape) >= 1 and arr.dtype.kind not in ("S",):
            if len(shape) > 1:
                tdims[cname] = "(" + ",".join(str(s) for s in
                                              reversed(shape)) + ")"
    dtype = np.dtype({"names": names, "formats": fmts})
    table = np.zeros(nrow, dtype=dtype)
    for cname in names:
        arr = np.asarray(columns[cname])
        if arr.dtype.kind == "S":
            table[cname] = arr
        else:
            table[cname] = arr.reshape(nrow, -1).astype(
                table.dtype[cname].base, copy=False).reshape(
                    table[cname].shape)
    hdr = Header()
    hdr.set("XTENSION", "BINTABLE", "binary table extension")
    hdr.set("BITPIX", 8)
    hdr.set("NAXIS", 2)
    hdr.set("NAXIS1", dtype.itemsize, "width of table in bytes")
    hdr.set("NAXIS2", nrow, "number of rows")
    hdr.set("PCOUNT", 0)
    hdr.set("GCOUNT", 1)
    hdr.set("TFIELDS", len(names))
    for i, (cname, tform) in enumerate(zip(names, tforms), start=1):
        hdr.set(f"TTYPE{i}", cname)
        hdr.set(f"TFORM{i}", tform)
        if cname in tdims:
            hdr.set(f"TDIM{i}", tdims[cname])
    hdr.set("EXTNAME", name)
    for key, value, comment in (extra_header or []):
        hdr.set(key, value, comment)
    hdu = HDU(hdr, dict(zip(names, (columns[n] for n in names))), name)
    hdu._table = table
    return hdu


def write_fits(path, hdus):
    """Write HDUs (primary first; BINTABLEs built by write_bintable_hdu)."""
    out = []
    primary = hdus[0]
    if "SIMPLE" not in primary.header:
        hdr = Header()
        hdr.set("SIMPLE", True, "file conforms to FITS standard")
        hdr.set("BITPIX", 8)
        hdr.set("NAXIS", 0)
        hdr.set("EXTEND", True)
        for key in primary.header.order:
            hdr.set(key, primary.header[key],
                    primary.header.comments.get(key, ""))
        primary = HDU(hdr)
    out.append(primary.header.to_bytes())
    for hdu in hdus[1:]:
        out.append(hdu.header.to_bytes())
        table = getattr(hdu, "_table", None)
        if table is not None:
            raw = table.tobytes()
            out.append(raw + b"\x00" * ((-len(raw)) % BLOCK))
    with open(path, "wb") as f:
        f.write(b"".join(out))
