"""Survey planning: cheap header scans + shape-bucketed batch grouping.

The PyTorch port of the JAX package's ``runner/plan.py`` (where each
distinct ``(nchan, nbin)`` archive shape costs its own compiled program
set).  The planner reads each archive's shape from its FITS *headers
only* — no DATA payload is decoded, so planning a thousand-archive
survey costs file-open + seek, not gigabytes of IO — and groups
archives into **shape buckets**: the canonical grid pads
``nchan``/``nbin`` up to the next power of two, so every archive in a
bucket fits at the same shapes (one set of cuFFT plans and allocator
blocks per bucket on the card).  The plan.json is the reference's, so
either package runs a plan the other wrote.

Padding semantics (docs/RUNNER.md):

* ``nchan`` — appended channels carry **zero weight** (excluded from
  every weighted reduction and from the fit), frequencies extrapolated
  on the native channel spacing, noise padded with the per-subint
  median so the guess stage's median-noise estimate is unbiased.
* ``nbin`` — the profile is **Fourier-resampled** (harmonic zero-pad)
  to the canonical bin count: an exact bandlimited representation of
  the same periodic signal, so fitted phases (in rotations) are
  unchanged.  Per-bin noise is rescaled by sqrt(nbin/nbin_pad) to keep
  the harmonic-domain noise level — and hence reduced chi-squared —
  consistent.

Archives whose headers cannot be read (truncated, not FITS, no SUBINT
HDU) are recorded on the plan as *unreadable* with the reason, and the
work queue quarantines them up front instead of crashing mid-survey.
"""

import json
import os

import numpy as np

from ..io.fits import BLOCK, CARD, Header
from ..testing import faults

__all__ = ["ArchiveInfo", "ShapeBucket", "SurveyPlan", "canonical_shape",
           "estimate_archive_bytes", "load_bucketed_databunch",
           "pad_databunch", "plan_survey", "scan_archive_header"]

PLAN_SCHEMA = "pptpu-survey-plan-v1"

# canonical-grid floors: padding below these wastes more in padded rows
# than a tiny program is worth saving in compiles
MIN_NCHAN = 8
MIN_NBIN = 64


def _next_pow2(n, lo):
    n = int(n)
    if n <= lo:
        return lo
    return 1 << (n - 1).bit_length()


def canonical_shape(nchan, nbin):
    """(nchan_pad, nbin_pad): the shape bucket an archive lands in."""
    return _next_pow2(nchan, MIN_NCHAN), _next_pow2(nbin, MIN_NBIN)


class ArchiveInfo:
    """Header-derived facts about one archive (no data decoded)."""

    __slots__ = ("path", "nsub", "npol", "nchan", "nbin", "source",
                 "nu0", "bw")

    def __init__(self, path, nsub, npol, nchan, nbin, source="unknown",
                 nu0=0.0, bw=0.0):
        self.path = path
        self.nsub = int(nsub)
        self.npol = int(npol)
        self.nchan = int(nchan)
        self.nbin = int(nbin)
        self.source = source
        self.nu0 = float(nu0)
        self.bw = float(bw)

    @property
    def bucket(self):
        return canonical_shape(self.nchan, self.nbin)

    def to_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def _has_end_card(block):
    for i in range(0, BLOCK, CARD):
        if block[i:i + 8].rstrip() == b"END":
            return True
    return False


def _iter_headers(f, path):
    """Yield FITS HDU headers from an open file, seeking past every
    data payload (the whole point: shapes come from headers alone)."""
    first = True
    while True:
        buf = b""
        while True:
            block = f.read(BLOCK)
            if first and block and not block.startswith(b"SIMPLE"):
                raise ValueError(f"{path}: not a FITS file")
            if len(block) < BLOCK:
                if buf or (first and block):
                    raise ValueError(
                        f"{path}: truncated FITS header "
                        f"({len(buf) + len(block)} bytes)")
                return
            buf += block
            if _has_end_card(block):
                break
        first = False
        hdr, _ = Header.from_bytes(buf)
        yield hdr
        if str(hdr.get("XTENSION", "")).strip() == "BINTABLE":
            nbytes = int(hdr["NAXIS1"]) * int(hdr["NAXIS2"]) \
                + int(hdr.get("PCOUNT", 0))
        elif hdr.get("NAXIS", 0) > 0:
            nbytes = abs(int(hdr.get("BITPIX", 8))) // 8
            for i in range(1, int(hdr["NAXIS"]) + 1):
                nbytes *= int(hdr[f"NAXIS{i}"])
        else:
            nbytes = 0
        f.seek(((nbytes + BLOCK - 1) // BLOCK) * BLOCK, os.SEEK_CUR)


def scan_archive_header(path):
    """ArchiveInfo from FITS headers only; raises ValueError when the
    file is not a readable PSRFITS archive (the quarantine trigger)."""
    faults.check("header_scan", key=path)
    primary = None
    with open(path, "rb") as f:
        for hdr in _iter_headers(f, path):
            if primary is None:
                primary = hdr
                continue
            if str(hdr.get("EXTNAME", "")).strip() != "SUBINT":
                continue
            nsub = int(hdr["NAXIS2"])
            npol = int(hdr.get("NPOL", 1))
            nchan = int(hdr.get("NCHAN", primary.get("OBSNCHAN", 0)))
            nbin = int(hdr.get("NBIN", 0))
            if nsub <= 0 or nchan <= 0 or nbin <= 0:
                raise ValueError(
                    f"{path}: SUBINT HDU with degenerate shape "
                    f"nsub={nsub} nchan={nchan} nbin={nbin}")
            return ArchiveInfo(
                path, nsub, npol, nchan, nbin,
                source=str(primary.get("SRC_NAME", "unknown")).strip(),
                nu0=float(primary.get("OBSFREQ", 0.0)),
                bw=float(primary.get("OBSBW", 0.0)))
    raise ValueError(f"{path}: no SUBINT HDU found")


# -- analytical footprint model (obs/memory.py regression gates) ----------
#
# Per-archive device bytes of one bucketed fit, from shapes and dtypes
# alone: the data-domain arrays (subints, masks, model portrait, noise
# working copy) are f64 [nsub, npol, nchan, nbin]; the harmonic-domain
# arrays (data FT, model FT, residual) are c128 [nsub, nchan,
# nbin//2+1]; the solver multiplies that by a temporaries factor
# (jacobian rows, line-search copies).  It is a *planning* estimate —
# checked against measured peaks by tools/memory_smoke.py (within 2x),
# not a buffer-assignment readback.
_DTYPE_BYTES = 8        # f64 data-domain arrays
_COMPLEX_BYTES = 16     # c128 harmonic-domain arrays
_DATA_ARRAYS = 4        # subints, masks, model, noise working copy
_HARMONIC_ARRAYS = 3    # data FT, model FT, solver residual
_SOLVER_OVERHEAD = 1.5  # solver temporaries (jacobian, line search)


def estimate_archive_bytes(nchan, nbin, nsub=1, npol=1):
    """Estimated peak device bytes to fit one archive at the canonical
    shape its ``(nchan, nbin)`` pads up to."""
    nchan, nbin = canonical_shape(nchan, nbin)
    nsub = max(1, int(nsub))
    npol = max(1, int(npol))
    data = nsub * npol * nchan * nbin * _DTYPE_BYTES * _DATA_ARRAYS
    harm = nsub * nchan * (nbin // 2 + 1) * _COMPLEX_BYTES \
        * _HARMONIC_ARRAYS
    return int(_SOLVER_OVERHEAD * (data + harm))


class ShapeBucket:
    """One canonical (nchan_pad, nbin_pad) group of archives."""

    def __init__(self, nchan, nbin, archives=None):
        self.nchan = int(nchan)
        self.nbin = int(nbin)
        self.archives = list(archives or [])

    @property
    def key(self):
        return (self.nchan, self.nbin)

    def est_bytes(self):
        """Estimated peak device bytes of this bucket's costliest
        archive (the admission/regression-gate number)."""
        nsub = max((a.nsub for a in self.archives), default=1)
        npol = max((a.npol for a in self.archives), default=1)
        return estimate_archive_bytes(self.nchan, self.nbin,
                                      nsub=nsub, npol=npol)

    def to_dict(self):
        return {"nchan": self.nchan, "nbin": self.nbin,
                "est_bytes": self.est_bytes(),
                "archives": [a.to_dict() for a in self.archives]}

    @classmethod
    def from_dict(cls, d):
        # tolerate plans written without ``est_bytes``: it is recomputed
        # from shapes, so its absence (or staleness) never breaks a load
        return cls(d["nchan"], d["nbin"],
                   [ArchiveInfo.from_dict(a) for a in d["archives"]])


class SurveyPlan:
    """Buckets + unreadable archives + the model the survey fits with.

    ``archives()`` yields (info, bucket) in a deterministic order —
    bucket-major, then metafile order within a bucket — which is also
    the order processes partition over (execute.py), so every process
    of a multihost run derives the same assignment from the same plan.
    """

    def __init__(self, buckets, unreadable, modelfile=None):
        self.buckets = sorted(buckets, key=lambda b: b.key)
        self.unreadable = list(unreadable)  # (path, reason)
        self.modelfile = modelfile

    def archives(self):
        for bucket in self.buckets:
            for info in bucket.archives:
                yield info, bucket

    @property
    def n_archives(self):
        return sum(len(b.archives) for b in self.buckets)

    def to_dict(self):
        return {"schema": PLAN_SCHEMA,
                "modelfile": self.modelfile,
                "n_archives": self.n_archives,
                "buckets": [b.to_dict() for b in self.buckets],
                "unreadable": [{"path": p, "reason": r}
                               for p, r in self.unreadable]}

    @classmethod
    def from_dict(cls, d):
        if d.get("schema") != PLAN_SCHEMA:
            raise ValueError(f"not a survey plan: schema="
                             f"{d.get('schema')!r}")
        return cls([ShapeBucket.from_dict(b) for b in d["buckets"]],
                   [(u["path"], u["reason"]) for u in d["unreadable"]],
                   modelfile=d.get("modelfile"))

    def save(self, path):
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, indent=1)
            fh.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path):
        with open(path, encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))


def plan_survey(datafiles, modelfile=None, quiet=True):
    """Scan archives (list of paths or a metafile path) into a
    SurveyPlan: shape buckets + unreadable files with reasons."""
    if isinstance(datafiles, str):
        from ..io.archive import file_is_type, parse_metafile

        try:
            kind = file_is_type(datafiles)
        except OSError as e:
            raise ValueError(f"cannot read {datafiles}: {e}")
        paths = parse_metafile(datafiles) if kind == "ASCII" \
            else [datafiles]
    else:
        paths = list(datafiles)
    buckets = {}
    unreadable = []
    for path in paths:
        try:
            info = scan_archive_header(path)
        except (OSError, ValueError, KeyError,
                faults.InjectedFault) as e:
            unreadable.append((path, str(e)))
            if not quiet:
                print(f"plan: unreadable archive {path}: {e}")
            continue
        key = info.bucket
        if key not in buckets:
            buckets[key] = ShapeBucket(*key)
        buckets[key].archives.append(info)
    plan = SurveyPlan(buckets.values(), unreadable, modelfile=modelfile)
    if not quiet:
        print(f"plan: {plan.n_archives} archives in "
              f"{len(plan.buckets)} shape buckets, "
              f"{len(unreadable)} unreadable")
    return plan


def _resample_nbin(x, nbin_pad):
    """Bandlimited (harmonic zero-pad) resample of [..., nbin] profiles
    to nbin_pad bins; amplitude-preserving.

    Samples live at BIN CENTERS ((k+0.5)/nbin, ops.fourier.
    get_bin_centers), not at the DFT's k/nbin grid — a naive zero-pad
    would therefore shift every profile by half the bin-width
    difference (0.5/nbin - 0.5/nbin_pad rotations; exactly 1/768 rot
    for 96->128, ~40x a typical TOA error).  The harmonic phase ramp
    below re-centers the resampled samples on the new grid's bin
    centers.
    """
    nbin = x.shape[-1]
    if nbin == nbin_pad:
        return x
    FT = np.fft.rfft(x, axis=-1)
    k = np.arange(FT.shape[-1])
    delta = 0.5 / nbin - 0.5 / nbin_pad
    FT = FT * np.exp(-2j * np.pi * k * delta)
    return np.fft.irfft(FT, nbin_pad, axis=-1) * (nbin_pad / nbin)


# the DataBunch fields pad_databunch reads or rewrites
_PAD_FIELDS = ("subints", "prof", "noise_stds", "prof_noise", "freqs",
               "weights", "SNRs", "phases", "masks")


def pad_databunch(d, nchan_pad, nbin_pad):
    """Pad a loaded archive DataBunch to the bucket's canonical shape.

    Mutates and returns ``d``: subints [nsub, npol, nchan_pad,
    nbin_pad], padded channels zero-weight (median-noise, zero-SNR),
    profiles Fourier-resampled along the bin axis with noise rescaled
    (module docstring).  Native shape is recorded as ``nchan_native``/
    ``nbin_native``; bw scales with nchan so the per-channel bandwidth
    stays the native value.  No-op when already canonical.  Array
    fields held as (CPU) torch tensors are padded as float64 numpy, the
    arithmetic of the reference's numpy path.  A padded bunch no longer
    carries the load's device cube (io.archive.take_device_cube): the fit
    uploads its padded host cube.
    """
    faults.check("archive_pad", key=getattr(d, "filename", None))
    for name in _PAD_FIELDS:
        v = getattr(d, name, None)
        if hasattr(v, "detach"):
            setattr(d, name, v.detach().cpu().numpy())
    nsub, npol, nchan, nbin = d.subints.shape
    if nchan == nchan_pad and nbin == nbin_pad:
        return d
    if nchan_pad < nchan or nbin_pad < nbin:
        raise ValueError(f"pad {nchan}x{nbin} -> {nchan_pad}x{nbin_pad}"
                         " shrinks the archive")
    from ..io.archive import take_device_cube

    take_device_cube(d)  # its shape is the native one
    d.nchan_native, d.nbin_native = nchan, nbin
    if nbin != nbin_pad:
        d.subints = _resample_nbin(d.subints, nbin_pad)
        d.prof = _resample_nbin(d.prof, nbin_pad)
        # keep the harmonic-domain noise (and red chi2) consistent:
        # the resampled profile carries the same harmonic amplitudes
        # over more bins
        scale = np.sqrt(nbin / nbin_pad)
        d.noise_stds = d.noise_stds * scale
        d.prof_noise = d.prof_noise * scale
        d.nbin = nbin_pad
        d.phases = (np.arange(nbin_pad) + 0.5) / nbin_pad
    if nchan != nchan_pad:
        extra = nchan_pad - nchan
        # extrapolate channel frequencies on the native spacing (sign
        # preserved for descending bands)
        step = (d.freqs[:, -1] - d.freqs[:, 0]) / max(nchan - 1, 1)
        step = np.where(step == 0.0, 1.0, step)
        pad_freqs = d.freqs[:, -1:] + step[:, None] * \
            np.arange(1, extra + 1)
        d.freqs = np.concatenate([d.freqs, pad_freqs], axis=1)
        d.subints = np.concatenate(
            [d.subints, np.zeros((nsub, npol, extra, d.nbin))], axis=2)
        d.weights = np.concatenate(
            [d.weights, np.zeros((nsub, extra))], axis=1)
        # median-noise padding keeps the guess stage's median-over-
        # channels noise estimate unbiased (zero would divide, and a
        # constant could dominate the median when extra ~ nchan)
        med = np.median(d.noise_stds, axis=2, keepdims=True)
        med = np.where(med > 0.0, med, 1.0)
        d.noise_stds = np.concatenate(
            [d.noise_stds, np.broadcast_to(med, (nsub, npol, extra))],
            axis=2)
        d.SNRs = np.concatenate(
            [d.SNRs, np.zeros((nsub, npol, extra))], axis=2)
        d.bw = d.bw * nchan_pad / nchan
        d.nchan = nchan_pad
        # ok_isubs is weight-derived and unchanged (padded channels are
        # dead); ok_ichans stays the native live set per subint
    weights_norm = np.where(d.weights == 0.0, 0.0, 1.0)
    d.masks = np.broadcast_to(
        weights_norm[:, None, :, None],
        (nsub, npol, d.nchan, d.nbin)).copy()
    return d


def load_bucketed_databunch(datafile, bucket_shape, tscrunch=False,
                            quiet=True, device=None):
    """The complete load of one bucketed archive: FITS read, the decode
    and the load's statistics on ``device`` (config.resolve_device) with
    the dmc-reload fallback (pipelines.toas.load_archive_data) + pad to
    the bucket's canonical shape on the host.

    This is THE load path of the bucketed fit loop
    (execute._BucketedGetTOAs) and of the host prefetch stage
    (runner/prefetch.py) — one implementation, so a prefetched buffer
    is bit-identical to a serial load and the ``archive_read`` /
    ``archive_pad`` fault sites fire on whichever thread actually runs
    the load.  Returns the padded DataBunch, or None when the archive
    is unloadable or its header lied about the shape (bucket smaller
    than the decoded data); anything pad_databunch raises beyond
    ValueError (e.g. an injected RuntimeError) propagates so it travels
    the fit loop's fault-isolation path unchanged.
    """
    from ..pipelines.toas import load_archive_data

    bucket_shape = tuple(bucket_shape)
    data = load_archive_data(datafile, tscrunch=tscrunch, quiet=quiet,
                             device=device)
    if data is None:
        return None
    try:
        return pad_databunch(data, *bucket_shape)
    except ValueError as e:
        if not quiet:
            print(f"Cannot pad {datafile} to bucket "
                  f"{bucket_shape}: {e}; skipping it.")
        return None
