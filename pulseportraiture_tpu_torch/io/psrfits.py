"""PSRFITS fold-mode archives: in-memory model + read/write.

In-repo replacement for the PSRCHIVE L0 boundary (SURVEY.md §1 L0): the
``Archive`` class holds the folded data cube and metadata and provides
the manipulations of an archive (state conversion, de/dedispersion,
scrunches, unload) in numpy instead of C++ calls; ``load_data`` runs the
same steps on the device (io/archive.py) and takes only the metadata
updates from here.

File layout written/read: primary HDU with PSRFITS observation keywords;
a PSRPARAM table carrying the ephemeris text; a SUBINT BINTABLE with
TSUBINT, OFFS_SUB, PERIOD, DAT_FREQ, DAT_WTS, DAT_SCL, DAT_OFFS and
int16 DATA (TDIM (nbin, nchan, npol)), physical = DATA*SCL + OFFS.  This
matches the fold-mode PSRFITS core used by PSRCHIVE (scale/offset
semantics and column names per the PSRFITS definition).

Folding periods: real fold-mode archives carry a POLYCO or T2PREDICT
HDU and the period drifts across subints (the reference reads
``get_folding_period()`` per Integration, pplib.py:2733,
:3343).  The reader resolves per-subint periods in priority order:
explicit PERIOD column > POLYCO HDU evaluated at each epoch > T2PREDICT
HDU > single-F0 ephemeris fallback (with a warning).  The writer emits
a POLYCO HDU whenever ``Archive.polyco`` is set.
"""

import sys

import numpy as np

from ..utils.mjd import MJD
from .fits import HDU, read_fits, write_bintable_hdu, write_fits
from .polyco import Polyco, PolycoSegment, parse_t2predict_text

__all__ = ["Archive", "read_archive", "write_archive_file",
           "convert_state_data", "tscrunch_data", "fscrunch_data",
           "scrunched_weights"]

Dconst = 0.000241 ** -1  # traditional dispersion constant, as config


def _np_stack(parts):
    return np.stack(parts, axis=1)


def convert_state_data(data, state, new_state, basis, stack):
    """The cube [nsub, npol, nchan, nbin] (numpy or torch) converted from
    polarization state ``state`` to ``new_state`` like PSRCHIVE's
    convert_state (Archive.convert_state's arithmetic; ``stack`` joins
    the new pols along axis 1).  Supported: any -> 'Intensity' (I, or
    AA+BB from Coherence), and the 4-pol linear maps Coherence <->
    Stokes in the receptor basis (FD_POLN): for 'LIN' feeds I=AA+BB,
    Q=AA-BB, U=2CR, V=2CI; for 'CIRC' feeds the roles of Q/U and V rotate
    (I=AA+BB, V=AA-BB, Q=2CR, U=2CI)."""
    npol = data.shape[1]
    circ = basis.startswith("CIRC")
    if new_state == "Intensity":
        if state == "Coherence" and npol >= 2:
            return data[:, 0:1] + data[:, 1:2]
        return data[:, 0:1]  # Stokes: first pol is I
    if state == "Coherence" and new_state == "Stokes" and npol == 4:
        AA, BB = data[:, 0], data[:, 1]
        CR, CI = data[:, 2], data[:, 3]
        I, D = AA + BB, AA - BB
        if circ:
            return stack([I, 2.0 * CR, 2.0 * CI, D])
        return stack([I, D, 2.0 * CR, 2.0 * CI])  # LIN (the default)
    if state == "Stokes" and new_state == "Coherence" and npol == 4:
        I, Q = data[:, 0], data[:, 1]
        U, V = data[:, 2], data[:, 3]
        if circ:
            return stack([(I + V) / 2.0, (I - V) / 2.0, Q / 2.0, U / 2.0])
        return stack([(I + Q) / 2.0, (I - Q) / 2.0, U / 2.0, V / 2.0])
    raise NotImplementedError(
        f"State conversion {state} (npol={npol}) -> "
        f"{new_state} not supported; supported: -> 'Intensity', and "
        f"4-pol Coherence <-> Stokes.")


def _scrunch(data, weights, axis):
    """The cube's weighted sum over weights' ``axis`` (0: subints, 1:
    channels; the cube's 0 and 2) over the weights' sum there, 1 where
    that sum is 0.  Array methods only: one definition for numpy arrays
    and torch tensors."""
    wsum = weights.sum(axis=axis, keepdims=True)
    norm = wsum * 1.0
    norm[~(wsum > 0.0)] = 1.0
    data = (data * weights[:, None, :, None]).sum(axis=2 * axis,
                                                  keepdims=True)
    return data / norm[:, None, :, None]


def tscrunch_data(data, weights):
    """Archive.tscrunch's arithmetic: the cube [nsub, npol, nchan, nbin]
    summed over subints with weights [nsub, nchan] (both numpy or both
    torch) over their sum; one subint is left as it is."""
    return data if data.shape[0] == 1 else _scrunch(data, weights, 0)


def fscrunch_data(data, weights):
    """Archive.fscrunch's arithmetic on a dedispersed cube: summed over
    channels with weights [nsub, nchan] over their sum; one channel is
    left as it is."""
    return data if data.shape[2] == 1 else _scrunch(data, weights, 1)


def scrunched_weights(weights, axis):
    """The weights [nsub, nchan] (numpy) after a scrunch over ``axis`` (0:
    tscrunch, 1: fscrunch): 1 where any weight was positive, else 0."""
    return np.where(weights.sum(axis=axis, keepdims=True) > 0.0, 1.0, 0.0)


def _rotate_np(data, shifts):
    """Host-side Fourier rotation of [..., nbin] by per-row shifts [rot].

    Positive shifts rotate to earlier phases (same convention as
    ops.fourier.rotate_data); NumPy here because Archive manipulation is
    host-side I/O territory.
    """
    FT = np.fft.rfft(data, axis=-1)
    k = np.arange(FT.shape[-1])
    FT *= np.exp(2j * np.pi * shifts[..., None] * k)
    return np.fft.irfft(FT, data.shape[-1], axis=-1)


class Archive:
    """In-memory fold-mode archive.

    data: [nsub, npol, nchan, nbin] float64 (physical units); an archive
    read from a file holds its DATA column as stored (``stored``: the
    file's big-endian int16 view, DAT_SCL and DAT_OFFS) and expands it on
    the host only when ``data`` is first read, so ``load_data`` can
    decode it on the card instead;
    freqs: [nsub, nchan] MHz; weights: [nsub, nchan];
    Ps: [nsub] folding periods [sec]; epochs: list of MJD (subint
    centers); durations: [nsub] sec; state: 'Intensity'|'Stokes'|
    'Coherence'; dedispersed: bool ("dmc" in the reference).
    """

    def __init__(self, data, freqs, weights, Ps, epochs, durations,
                 DM=0.0, state="Intensity", dedispersed=False,
                 source="FAKE", telescope="GBT", frontend="unknown",
                 backend="unknown", backend_delay=0.0, nu0=None, bw=None,
                 ephemeris_text="", doppler_factors=None,
                 parallactic_angles=None, filename="", polyco=None,
                 doppler_degraded=False, basis="LIN", encoded=None):
        if encoded is not None:
            self._data, self._stored = None, tuple(encoded)
            shape = self._stored[0].shape
        else:
            self.data = data
            shape = self._data.shape
        self.nsub, self.npol, self.nchan, self.nbin = shape
        self.freqs = np.asarray(freqs, dtype=np.float64)
        if self.freqs.ndim == 1:
            self.freqs = np.tile(self.freqs, (self.nsub, 1))
        self.weights = np.asarray(weights, dtype=np.float64)
        self.Ps = np.asarray(Ps, dtype=np.float64)
        self.epochs = list(epochs)
        self.durations = np.asarray(durations, dtype=np.float64)
        self.DM = float(DM)
        self.state = state
        self.basis = str(basis).strip().upper() or "LIN"
        self.dedispersed = bool(dedispersed)
        self.source = source
        self.telescope = telescope
        self.frontend = frontend
        self.backend = backend
        self.backend_delay = float(backend_delay)
        chan_bw = (self.freqs[0, 1] - self.freqs[0, 0]) \
            if self.nchan > 1 else 0.0
        self.bw = float(bw if bw is not None else chan_bw * self.nchan)
        self.nu0 = float(nu0 if nu0 is not None
                         else self.freqs[0].mean())
        self.ephemeris_text = ephemeris_text
        # When not stored, compute Doppler factors / parallactic angles
        # from the observatory + source geometry (the reference gets
        # them from PSRCHIVE, pplib.py:2697-2708); unity/zero fallback
        # when the coordinates are unknown.
        # True when the factors are the fabricated unity fallback (set
        # below, or propagated by a caller copying a degraded archive)
        self.doppler_degraded = bool(doppler_degraded)
        if doppler_factors is None or parallactic_angles is None:
            from ..utils.ephem import doppler_parangle_for_archive

            # only warn when the Doppler factors themselves (the
            # barycentric-correction input) are the missing quantity
            dfs, pas = doppler_parangle_for_archive(
                self.epochs, ephemeris_text, telescope,
                warn=doppler_factors is None)
            if doppler_factors is None:
                if dfs is None:
                    # unity fallback: downstream bary=True corrections
                    # silently become topocentric — record it so TOAs
                    # can carry a -pp_topo flag
                    self.doppler_degraded = True
                    doppler_factors = np.ones(self.nsub)
                else:
                    doppler_factors = dfs
            if parallactic_angles is None:
                parallactic_angles = pas if pas is not None \
                    else np.zeros(self.nsub)
        self.doppler_factors = np.asarray(doppler_factors)
        self.parallactic_angles = np.asarray(parallactic_angles)
        self.filename = filename
        self.polyco = polyco  # Polyco predictor the data was folded with

    @property
    def data(self):
        """The cube [nsub, npol, nchan, nbin] float64, expanded from
        ``stored`` at first read: raw * scl + offs in numpy."""
        if self._data is None:
            raw, scl, offs = self._stored
            self._data = raw.astype(np.float64) * scl[..., None] \
                + offs[..., None]
            self._stored = None
        return self._data

    @data.setter
    def data(self, value):
        self._data = np.asarray(value, dtype=np.float64)
        self._stored = None

    @property
    def stored(self):
        """(raw [nsub, npol, nchan, nbin] int16 as the file stores it, a
        big-endian view of its bytes with the record's strides, scl, offs
        [nsub, npol, nchan] float64) while the cube has not been expanded,
        else None."""
        return self._stored

    @property
    def encoded(self):
        """``stored`` with raw in native byte order (a copy), else None."""
        if self._stored is None:
            return None
        raw, scl, offs = self._stored
        return raw.astype(raw.dtype.newbyteorder("=")), scl, offs

    def copy(self):
        if self._stored is not None:  # the stored arrays are never written
            return Archive(None, self.freqs.copy(), self.weights.copy(),
                           self.Ps.copy(), list(self.epochs),
                           self.durations.copy(), encoded=self._stored,
                           **self._copy_kw())
        return Archive(self.data.copy(), self.freqs.copy(),
                       self.weights.copy(), self.Ps.copy(),
                       list(self.epochs), self.durations.copy(),
                       **self._copy_kw())

    def _copy_kw(self):
        return dict(DM=self.DM, state=self.state,
                    dedispersed=self.dedispersed, source=self.source,
                    telescope=self.telescope, frontend=self.frontend,
                    backend=self.backend, backend_delay=self.backend_delay,
                    nu0=self.nu0, bw=self.bw,
                    ephemeris_text=self.ephemeris_text,
                    doppler_factors=self.doppler_factors.copy(),
                    parallactic_angles=self.parallactic_angles.copy(),
                    filename=self.filename, polyco=self.polyco,
                    doppler_degraded=self.doppler_degraded,
                    basis=self.basis)

    # -- state ----------------------------------------------------------
    def convert_state(self, state):
        """Convert polarization state like PSRCHIVE's convert_state
        (the reference reaches it through load_data's ``state`` kwarg,
        pplib.py:2678-2684).

        Supported: any -> 'Intensity' (total intensity, I or AA+BB),
        and the 4-pol linear maps Coherence <-> Stokes in the
        receptor basis ``self.basis`` (FD_POLN): for 'LIN' feeds
        I=AA+BB, Q=AA-BB, U=2CR, V=2CI; for 'CIRC' feeds the roles of
        Q/U and V rotate (I=AA+BB, V=AA-BB, Q=2CR, U=2CI).
        """
        if state == self.state:
            return
        self.data = convert_state_data(self.data, self.state, state,
                                       self.basis, _np_stack)
        self.npol = self.data.shape[1]
        self.state = state

    def pscrunch(self):
        self.convert_state("Intensity")

    # -- dispersion -----------------------------------------------------
    def _dispersion_shifts(self):
        """Per (sub, chan) phase shifts [rot] that dedisperse to nu0."""
        return (Dconst * self.DM / self.Ps[:, None]) * \
            (self.freqs ** -2 - self.nu0 ** -2)

    def dedisperse(self):
        if not self.dedispersed:
            self.data = _rotate_np(self.data,
                                   self._dispersion_shifts()[:, None, :])
            self.dedispersed = True

    def dededisperse(self):
        if self.dedispersed:
            self.data = _rotate_np(self.data,
                                   -self._dispersion_shifts()[:, None, :])
            self.dedispersed = False

    # -- scrunches ------------------------------------------------------
    def tscrunch(self):
        if self.nsub == 1:
            return
        self.data = tscrunch_data(self.data, self.weights)
        self.tscrunch_metadata()

    def tscrunch_metadata(self):
        """tscrunch's change to everything but the data (nsub > 1)."""
        mid = self.epochs[0] + \
            (self.epochs[-1] - self.epochs[0]) / 2.0 / 86400.0
        self.epochs = [mid]
        self.Ps = self.Ps[:1]
        self.freqs = self.freqs.mean(axis=0, keepdims=True)
        self.weights = scrunched_weights(self.weights, 0)
        self.durations = np.array([self.durations.sum()])
        self.doppler_factors = self.doppler_factors[:1]
        self.parallactic_angles = self.parallactic_angles[:1]
        self.nsub = 1

    def fscrunch(self):
        if self.nchan == 1:
            return
        if not self.dedispersed:
            self.dedisperse()
        self.data = fscrunch_data(self.data, self.weights)
        self.fscrunch_metadata()

    def fscrunch_metadata(self):
        """fscrunch's change to everything but the data (nchan > 1, the
        data dedispersed)."""
        self.freqs = np.full((self.nsub, 1), self.nu0)
        self.weights = scrunched_weights(self.weights, 1)
        self.nchan = 1

    # -- unload ---------------------------------------------------------
    def unload(self, filename, quiet=True):
        write_archive_file(self, filename, quiet=quiet)
        self.filename = filename


def write_archive_file(arch, filename, nbits=16, quiet=True,
                       period_column=True):
    """Encode an Archive to a PSRFITS file (int16 + per-profile scale).

    ``period_column=False`` omits the explicit PERIOD column, as
    psrchive/dspsr-produced archives do — per-subint periods must then
    come from the POLYCO HDU (written when ``arch.polyco`` is set) or
    the ephemeris.
    """
    nsub, npol, nchan, nbin = arch.data.shape
    start = arch.epochs[0] - float(arch.durations[0]) / 2.0 / 86400.0

    primary = HDU()
    h = primary.header
    h.set("HDRVER", "6.1", "Header version")
    h.set("FITSTYPE", "PSRFITS", "FITS definition for pulsar data files")
    h.set("OBS_MODE", "PSR", "(PSR, CAL, SEARCH)")
    h.set("TELESCOP", arch.telescope)
    h.set("FRONTEND", arch.frontend)
    h.set("BACKEND", arch.backend)
    h.set("BE_DELAY", arch.backend_delay, "Backend propn delay [s]")
    h.set("FD_POLN", getattr(arch, "basis", "LIN"),
          "LIN or CIRC (receptor basis)")
    h.set("OBSFREQ", arch.nu0, "[MHz] Centre frequency")
    h.set("OBSBW", arch.bw, "[MHz] Bandwidth")
    h.set("OBSNCHAN", nchan, "Number of frequency channels")
    h.set("SRC_NAME", arch.source)
    h.set("STT_IMJD", start.intday(), "Start MJD (UTC days)")
    h.set("STT_SMJD", int(start.secs), "[s] Start time")
    h.set("STT_OFFS", start.secs - int(start.secs), "[s] Start offset")

    hdus = [primary]
    if arch.ephemeris_text:
        lines = [ln for ln in arch.ephemeris_text.splitlines() if ln]
        width = max(len(ln) for ln in lines)
        param = np.array([ln.ljust(width) for ln in lines],
                         dtype="S%d" % width)
        hdus.append(write_bintable_hdu("PSRPARAM", {"PARAM": param}))

    # int-encode: physical = DATA*scl + offs per (sub, pol, chan)
    data = arch.data
    dmax = data.max(axis=-1)
    dmin = data.min(axis=-1)
    span = np.where(dmax > dmin, dmax - dmin, 1.0)
    scl = span / (2 ** (nbits - 1) - 2)  # int16 range with margin
    offs = (dmax + dmin) / 2.0
    q = np.rint((data - offs[..., None]) / scl[..., None])
    q = np.clip(q, -(2 ** (nbits - 1) - 1), 2 ** (nbits - 1) - 1)
    enc = q.astype(np.int16)

    if getattr(arch, "polyco", None) is not None:
        segs = arch.polyco.segments
        ncoef = max(len(s.coeffs) for s in segs)
        hdus.append(write_bintable_hdu("POLYCO", {
            "NSPAN": np.array([s.nspan for s in segs], np.float64),
            "NCOEF": np.array([len(s.coeffs) for s in segs], np.int16),
            "NSITE": np.array([s.site.ljust(8)[:8] for s in segs], "S8"),
            "REF_FREQ": np.array([s.ref_freq for s in segs], np.float64),
            "REF_MJD": np.array([s.tmid for s in segs], np.float64),
            "REF_PHS": np.array([s.rphase for s in segs], np.float64),
            "REF_F0": np.array([s.f0ref for s in segs], np.float64),
            "LGFITERR": np.array([s.log10_fit_err for s in segs],
                                 np.float64),
            "COEFF": np.stack([np.pad(s.coeffs,
                                      (0, ncoef - len(s.coeffs)))
                               for s in segs]).astype(np.float64),
        }))

    offs_sub = np.array([ep - start for ep in arch.epochs])  # seconds
    columns = {
        "TSUBINT": arch.durations.astype(np.float64),
        "OFFS_SUB": offs_sub.astype(np.float64),
    }
    if period_column:
        columns["PERIOD"] = arch.Ps.astype(np.float64)
    if not getattr(arch, "doppler_degraded", False):
        # never persist the fabricated unity/zero fallback as if it were
        # measured: a degraded archive re-reads as degraded (and flags
        # its bary TOAs) instead of laundering ones into the file
        columns.update({
            "DOPPLER": arch.doppler_factors.astype(np.float64),
            "PAR_ANG": arch.parallactic_angles.astype(np.float64),
        })
    columns.update({
        "DAT_FREQ": arch.freqs.astype(np.float64),
        "DAT_WTS": arch.weights.astype(np.float32),
        "DAT_OFFS": offs.reshape(nsub, npol * nchan).astype(np.float32),
        "DAT_SCL": scl.reshape(nsub, npol * nchan).astype(np.float32),
        # FITS TDIM is reversed relative to the numpy shape:
        # (nbin, nchan, npol) in the header
        "DATA": enc,
    })
    extra = [
        ("INT_TYPE", "TIME", "Time axis"),
        ("INT_UNIT", "SEC", ""),
        ("SCALE", "FluxDen", ""),
        ("POL_TYPE", {"Intensity": "AA+BB", "Stokes": "IQUV",
                      "Coherence": "AABBCRCI"}[arch.state], ""),
        ("STATE", arch.state, "Polarization state"),
        ("NPOL", npol, "Nr of polarisations"),
        ("TBIN", float(arch.Ps[0] / nbin), "[s] Time per bin or sample"),
        ("NBIN", nbin, "Nr of bins"),
        ("NCHAN", nchan, "Number of channels"),
        ("CHAN_BW", arch.bw / nchan, "[MHz] Channel bandwidth"),
        ("DM", arch.DM, "[cm-3 pc] DM used for dedispersion"),
        ("DEDISP", arch.dedispersed, "Data dedispersed"),
        ("NBITS", 1, "Nr of bits/datum (unused for fold data)"),
        ("NSBLK", 1, "Samples/row"),
        ("EPOCHS", "MIDTIME", "Epoch convention"),
    ]
    hdus.append(write_bintable_hdu("SUBINT", columns, extra))
    write_fits(filename, hdus)
    if not quiet:
        print("Unloaded %s." % filename)


def _polyco_from_hdu(hdu):
    """POLYCO BINTABLE -> Polyco (one segment per row)."""
    cols = hdu.columns
    nseg = hdu.header["NAXIS2"]
    coeff = np.asarray(cols["COEFF"], dtype=np.float64).reshape(nseg, -1)
    ncoef = np.asarray(cols.get("NCOEF", [coeff.shape[1]] * nseg),
                       dtype=np.int64).reshape(nseg)
    sites = cols.get("NSITE", [b"@"] * nseg)
    segs = []
    for i in range(nseg):
        site = sites[i]
        site = site.decode() if isinstance(site, bytes) else str(site)
        segs.append(PolycoSegment(
            float(np.ravel(cols["REF_MJD"])[i]),
            float(np.ravel(cols["REF_PHS"])[i]),
            float(np.ravel(cols["REF_F0"])[i]),
            coeff[i, :ncoef[i]],
            nspan=float(np.ravel(cols.get("NSPAN", [1440] * nseg))[i]),
            ref_freq=float(np.ravel(cols.get("REF_FREQ",
                                             [0.0] * nseg))[i]),
            site=site.strip(),
            log10_fit_err=float(np.ravel(cols.get("LGFITERR",
                                                  [0.0] * nseg))[i])))
    return Polyco(segs)


def _t2predict_from_hdu(hdu):
    """T2PREDICT BINTABLE (text rows) -> ChebyModelSet."""
    col = hdu.columns.get("PREDICT")
    if col is None:
        return None
    text = "\n".join(v.decode() if isinstance(v, bytes) else str(v)
                     for v in np.ravel(col))
    return parse_t2predict_text(text)


def read_archive(filename):
    """Decode a PSRFITS file into an Archive."""
    hdus = read_fits(filename)
    primary = hdus[0].header
    subint = None
    ephemeris_text = ""
    polyco = None
    t2pred = None
    for hdu in hdus[1:]:
        name = str(hdu.header.get("EXTNAME", "")).strip()
        if name == "SUBINT":
            subint = hdu
        elif name in ("PSRPARAM", "PSREPHEM"):
            col = hdu.columns.get("PARAM")
            if col is not None:
                ephemeris_text = "\n".join(
                    v.decode() if isinstance(v, bytes) else str(v)
                    for v in col)
        elif name == "POLYCO":
            polyco = _polyco_from_hdu(hdu)
        elif name in ("T2PREDICT", "T2PRED"):
            t2pred = _t2predict_from_hdu(hdu)
    if subint is None:
        raise ValueError(f"{filename}: no SUBINT HDU found.")
    sh = subint.header
    cols = subint.columns
    nsub = sh["NAXIS2"]
    npol = int(sh.get("NPOL", 1))
    nchan = int(sh.get("NCHAN", primary.get("OBSNCHAN", 1)))
    raw = cols["DATA"]
    nbin = int(sh.get("NBIN", raw.shape[-1]))
    # the DATA column as stored (big-endian, io.fits); physical = raw * scl
    # + offs (Archive.data expands it at first read, load_data on the card)
    raw = raw.reshape(nsub, npol, nchan, nbin)
    scl = np.asarray(cols.get("DAT_SCL",
                              np.ones((nsub, npol * nchan))),
                     dtype=np.float64).reshape(nsub, npol, nchan)
    offs = np.asarray(cols.get("DAT_OFFS",
                               np.zeros((nsub, npol * nchan))),
                      dtype=np.float64).reshape(nsub, npol, nchan)

    freqs = np.asarray(cols["DAT_FREQ"], dtype=np.float64)
    if freqs.ndim == 1:
        freqs = freqs.reshape(nsub, nchan)
    weights = np.asarray(cols.get("DAT_WTS", np.ones((nsub, nchan))),
                         dtype=np.float64).reshape(nsub, nchan)
    durations = np.asarray(cols.get("TSUBINT", np.zeros(nsub)),
                           dtype=np.float64)
    start = MJD.from_imjd_smjd(primary.get("STT_IMJD", 0),
                               primary.get("STT_SMJD", 0),
                               primary.get("STT_OFFS", 0.0))
    offs_sub = np.asarray(cols.get("OFFS_SUB", np.zeros(nsub)),
                          dtype=np.float64)
    epochs = [start.add_seconds(float(o)) for o in offs_sub]
    # folding periods, in priority order: explicit PERIOD column >
    # POLYCO evaluated at each subint epoch > T2PREDICT > single-F0
    # ephemeris fallback (warned: real periods drift across subints,
    # ref pplib.py:2733)
    if "PERIOD" in cols:
        Ps = np.asarray(cols["PERIOD"], dtype=np.float64).reshape(nsub)
    elif polyco is not None:
        Ps = polyco.periods([ep.mjd() for ep in epochs])
    elif t2pred is not None:
        # evaluate the predictor per subint at that subint's weighted
        # center frequency (the reference's get_folding_period asks
        # each Integration for its own frequency; DAT_FREQ can drift)
        wsum = weights.sum(axis=1)
        has_w = wsum > 0.0
        nu_sub = np.where(
            has_w,
            (freqs * weights).sum(axis=1) / np.where(has_w, wsum, 1.0),
            freqs.mean(axis=1))
        Ps = np.array([float(t2pred.period(ep.mjd(), float(nu_sub[i])))
                       for i, ep in enumerate(epochs)])
    else:
        print(f"Warning: {filename} has no PERIOD column and no "
              "POLYCO/T2PREDICT HDU; folding all subints at the "
              "ephemeris F0 (periods do not drift).", file=sys.stderr)
        Ps = np.full(nsub, _period_from_ephemeris(ephemeris_text))
    pol_type = str(sh.get("POL_TYPE", "AA+BB")).strip()
    state = str(sh.get("STATE", "")).strip() or \
        {"IQUV": "Stokes", "AABBCRCI": "Coherence"}.get(pol_type,
                                                        "Intensity")
    # absent columns -> None so Archive computes them from geometry
    dop = cols.get("DOPPLER")
    if dop is not None:
        dop = np.asarray(dop, dtype=np.float64).reshape(nsub)
    par = cols.get("PAR_ANG")
    if par is not None:
        par = np.asarray(par, dtype=np.float64).reshape(nsub)
    return Archive(
        None, freqs, weights, Ps, epochs, durations, encoded=(raw, scl, offs),
        DM=float(sh.get("DM", 0.0)),
        state=state, dedispersed=bool(sh.get("DEDISP", False)),
        source=str(primary.get("SRC_NAME", "unknown")).strip(),
        telescope=str(primary.get("TELESCOP", "unknown")).strip(),
        frontend=str(primary.get("FRONTEND", "unknown")).strip(),
        backend=str(primary.get("BACKEND", "unknown")).strip(),
        backend_delay=float(primary.get("BE_DELAY", 0.0)),
        nu0=float(primary.get("OBSFREQ", freqs.mean())),
        bw=float(primary.get("OBSBW", 0.0)) or None,
        ephemeris_text=ephemeris_text, doppler_factors=dop,
        parallactic_angles=par, filename=filename, polyco=polyco,
        basis=str(primary.get("FD_POLN", "LIN")).strip() or "LIN")


def _period_from_ephemeris(text):
    for line in text.splitlines():
        toks = line.split()
        if len(toks) >= 2 and toks[0] == "F0":
            return 1.0 / float(toks[1])
        if len(toks) >= 2 and toks[0] == "P0":
            return float(toks[1])
    return 1.0
