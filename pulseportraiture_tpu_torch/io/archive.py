"""Archive loading with the reference's load_data schema + fake archives.

Port of the JAX package's ``io/archive.py`` (reference
pplib.py:2650-2820 load_data and :3189-3384
make_fake_pulsar) on the in-repo PSRFITS layer (io.psrfits).

Placement: ``load_data`` runs on the device it is given (CUDA unless
``device="cpu"``; no CUDA device and no ``"cpu"`` raises).  The host
reads the FITS bytes; the DATA column goes up once as the file stores it
(big-endian int16: one host copy packs its rows into a pinned buffer) and
every pass over the cube runs on the device, in the reference's order: K5
swaps its bytes, decodes it and removes the baseline (one
launch when nothing lies between the two), a state conversion and the
(de)dedispersion (cuFFT with K7's phasor pass) and the scrunches (the
Archive's arithmetic, io.psrfits.tscrunch_data and fscrunch_data) run
as torch, then in chunks of subints cuFFT's rFFT feeds K6 (each row's
noise and S/N), and the work copy (pscrunched, dedispersed through K7,
tscrunched and fscrunched) gives the profile.  The subints come back
once, into pinned host memory; the DataBunch keeps its numpy schema.
With ``keep_cube`` the final cube also stays on the device, outside that
schema (``LoadedBunch.device_cube``), for the fit to index there instead
of uploading ``subints`` again; the fit takes it (``take_device_cube``)
and drops it after the archive.  On the CPU the same steps run the
kernels' plain versions (_kernels).

Hooks, as in the JAX module: the ``archive_read`` fault-injection site
(testing/faults.py) at the top of ``load_data``, and its decode seconds
observed into the ``pps_phase_seconds`` histogram (``phase="decode"``)
of an open obs run.
"""

import os
import time

import numpy as np
import torch

from .. import _kernels
from ..config import resolve_device
from ..obs import metrics
from ..obs.metrics import PHASE_HISTOGRAM
from ..ops.fourier import get_bin_centers, rotate_data
from ..ops.noise import get_noise_fit
from ..testing import faults
from ..utils.databunch import DataBunch
from ..utils.mjd import MJD
from ..utils.telescopes import telescope_code_dict
from .gmodel import read_model
from .polyco import polyco_from_spin
from .psrfits import (Archive, convert_state_data, fscrunch_data,
                      read_archive, scrunched_weights, tscrunch_data)

__all__ = ["load_data", "unload_new_archive", "make_fake_pulsar",
           "file_is_type", "parse_metafile", "LOAD_CHUNK_BYTES",
           "LOAD_STEPS", "LoadedBunch", "take_device_cube", "stored_rows"]

# the rFFT of the subints for K6 runs in chunks of whole subints of at
# most this many bytes of spectrum (at least one subint)
LOAD_CHUNK_BYTES = 1 << 28
# load_data's ``split`` keys, in the order the steps run ("K7": the work
# copy's pscrunch and dedispersion through cuFFT and K7; "profile": its
# scrunches and the profile's noise and S/N)
LOAD_STEPS = ("read", "upload", "K5", "rotate", "scrunch", "cuFFT", "K6",
              "K7", "profile", "download", "host")


def file_is_type(filename):
    """'FITS' | 'ASCII' | 'data' dispatch without shelling out to `file`
    (reference pplib.py:3021-3037): FITS files start with 'SIMPLE  =';
    metafiles are small text lists."""
    with open(filename, "rb") as f:
        head = f.read(160)
    if head.startswith(b"SIMPLE"):
        return "FITS"
    try:
        head.decode("ascii")
        return "ASCII"
    except UnicodeDecodeError:
        return "data"


class _Split:
    """Seconds per load step into ``split`` (a dict) when one is given:
    each mark synchronises the device, so the steps do not overlap.
    Without ``split`` a mark does nothing."""

    def __init__(self, split, device):
        self.split, self.device = split, device
        self.t = time.perf_counter()

    def mark(self, step):
        if self.split is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.split[step] = self.split.get(step, 0.0) + (t - self.t)
        self.t = t


class LoadedBunch(DataBunch):
    """load_data's DataBunch: the reference's numpy schema, and besides it,
    in a slot outside the dict (no key: no comparison of fields, writer of
    a .tim or figure sees it), ``device_cube``: with ``keep_cube`` the final
    cube [nsub, npol, nchan, nbin] float64 on the load's device, whose
    values ``subints`` holds, else None."""

    __slots__ = ("device_cube",)

    def __init__(self, device_cube=None, **kwds):
        super().__init__(**kwds)
        self.device_cube = device_cube


def take_device_cube(d):
    """The device cube a load left on the bunch ``d``, taken off it (so the
    bunch holds no device memory after), or None when it has none."""
    cube = getattr(d, "device_cube", None) if isinstance(d, LoadedBunch) \
        else None
    if cube is not None:
        d.device_cube = None
    return cube


def stored_rows(raw, device):
    """The stored DATA column raw [nsub, npol, nchan, nbin] int16 (either
    byte order; from a file a big-endian view of its bytes, with the
    record's strides) as K5 takes it: [rows, nbin] int16 holding the
    big-endian bytes, packed by one copy into a pinned buffer for the
    card (a plain one for the CPU).  The record's stride and the column's
    offset in it, whatever their alignment, end here."""
    nbin = raw.shape[-1]
    buf = torch.empty((raw.size // nbin, nbin), dtype=torch.int16,
                      pin_memory=device.type == "cuda")
    buf.numpy().view(">i2").reshape(raw.shape)[...] = raw
    return buf


def _upload(arr, device, copy):
    """A numpy array as a tensor on ``device``: through a pinned buffer to
    the card; on the CPU its own memory (a copy when ``copy``)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.clone() if copy else t
    pinned = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    pinned.copy_(t)
    return pinned.to(device, non_blocking=True)


def _download(t):
    """A device tensor as a numpy array: through pinned host memory from
    the card (the array lives in it)."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def _decode(arch, device, frac, steps):
    """The archive's cube [nsub, npol, nchan, nbin] float64 on ``device``:
    K5 decodes the stored column there (removing the baseline of windows
    of ``frac`` in the same launch unless frac is None); an archive whose
    cube is already expanded (or stored other than as int16) is uploaded
    as float64, its baseline removed by K5 when asked."""
    st = arch.stored
    shape = (arch.nsub, arch.npol, arch.nchan, arch.nbin)
    if st is not None and st[0].dtype.kind == "i" \
            and st[0].dtype.itemsize == 2:
        raw = stored_rows(st[0], device)
        if device.type == "cuda":
            raw = raw.to(device, non_blocking=True)
        scl, offs = (_upload(a.reshape(-1), device, False) for a in st[1:])
        steps.mark("upload")
        return _kernels.unpack(raw, scl, offs, frac).reshape(shape)
    x = _upload(arch.data, device, True)
    steps.mark("upload")
    return x if frac is None else _baseline(x, frac)


def _baseline(x, frac=0.125):
    """The cube x less K5's baseline of each row (in place when x is
    contiguous)."""
    rows = x.contiguous().reshape(-1, x.shape[-1])
    return _kernels.baseline(rows, frac, out=rows).reshape(x.shape)


def _dedisperse(x, arch, sign):
    """The cube rotated by ``sign`` times the archive's dispersion shifts
    (ops.fourier.rotate_data: cuFFT and K7's phasor pass)."""
    dev = x.device
    Ps = torch.as_tensor(arch.Ps, dtype=torch.float64, device=dev)
    freqs = torch.as_tensor(arch.freqs, dtype=torch.float64, device=dev)
    return rotate_data(x, 0.0, sign * arch.DM, Ps, freqs[:, None, :],
                       arch.nu0)


def _tscrunch(x, arch):
    """Archive.tscrunch on the cube x and the archive's metadata."""
    if arch.nsub == 1:
        return x
    x = tscrunch_data(x, torch.as_tensor(arch.weights, device=x.device))
    arch.tscrunch_metadata()
    return x


def _fscrunch(x, arch):
    """Archive.fscrunch on the cube x (dedispersed first if it is not)
    and the archive's metadata."""
    if arch.nchan == 1:
        return x
    if not arch.dedispersed:
        x = _dedisperse(x, arch, 1.0)
        arch.dedispersed = True
    x = fscrunch_data(x, torch.as_tensor(arch.weights, device=x.device))
    arch.fscrunch_metadata()
    return x


def _statistics(x, get_SNRs, steps):
    """K6 over the final cube x [nsub, npol, nchan, nbin], cuFFT's rFFT
    taken in chunks of subints: (noise [rows], SNR [rows] or None) on x's
    device, rows in (subint, pol, channel) order."""
    nsub, nbin = x.shape[0], x.shape[-1]
    per_sub = x.shape[1] * x.shape[2]
    rows = x.reshape(nsub * per_sub, nbin)
    noise = torch.empty(rows.shape[0], dtype=torch.float64, device=x.device)
    snr = torch.empty_like(noise) if get_SNRs else None
    chunk = per_sub * max(1, LOAD_CHUNK_BYTES // max(
        1, per_sub * (nbin // 2 + 1) * 16))
    for r0 in range(0, rows.shape[0], chunk):
        r = slice(r0, r0 + chunk)
        X = torch.fft.rfft(rows[r], dim=-1)
        steps.mark("cuFFT")
        _kernels.load_stats(rows[r], X, noise[r],
                            None if snr is None else snr[r])
        steps.mark("K6")
        del X
    return noise, snr


def _work_profile(x, arch, flux_prof, steps):
    """The reference's work copy of the final cube x (io/archive.py:
    135-146 there): pscrunched, dedispersed (cuFFT and K7), tscrunched
    and fscrunched by the Archive's own arithmetic: (prof [nbin], the
    flux profile [nchan], each channel's mean after the tscrunch, or
    None).  Its peak is about two cubes of the pscrunched size."""
    work = x
    if arch.state != "Intensity":
        work = convert_state_data(x, arch.state, "Intensity", arch.basis,
                                  None)
    if not arch.dedispersed:
        work = _dedisperse(work, arch, 1.0)
    steps.mark("K7")
    w = arch.weights
    work = tscrunch_data(work, torch.as_tensor(w, device=x.device))
    if arch.nsub > 1:
        w = scrunched_weights(w, 0)
    flux = work.mean(axis=3)[0, 0] if flux_prof else None
    work = fscrunch_data(work, torch.as_tensor(w, device=x.device))
    return work[0, 0, 0].contiguous(), flux


def load_data(filename, state=None, dedisperse=False, dededisperse=False,
              tscrunch=False, pscrunch=False, fscrunch=False,
              rm_baseline=True, flux_prof=False, refresh_arch=True,
              return_arch=True, quiet=True, get_SNRs=True,
              noise_method="PS", device=None, split=None, keep_cube=False):
    """Load a PSRFITS archive into the canonical DataBunch schema.

    Field-for-field equivalent of the reference's load_data
    (pplib.py:2650-2820): subints
    [nsub, npol, nchan, nbin], freqs [nsub, nchan], weights, masks,
    noise_stds [nsub, npol, nchan], SNRs, ok_isubs, ok_ichans, Ps,
    epochs, phases, prof, flux_prof, plus observation metadata — all
    numpy.  The passes over the cube run on ``device`` (module
    docstring).  ``split``, a dict, receives the seconds of each step
    (LOAD_STEPS), each ended by a device synchronise: a diagnostic that
    serialises the load.  ``keep_cube`` leaves the final cube on the
    device as the returned LoadedBunch's ``device_cube`` (module
    docstring).
    """
    # chaos site: an injected read fault surfaces exactly like a
    # truncated payload or NFS blip (testing/faults.py)
    faults.check("archive_read", key=getattr(filename, "filename",
                                             None) or str(filename))
    device = resolve_device(device)
    t_decode0 = time.perf_counter()
    steps = _Split(split, device)
    given = filename if isinstance(filename, Archive) else None
    arch = given if given is not None else read_archive(filename)
    if refresh_arch:
        arch = arch.copy()  # manipulations below stay local
    steps.mark("read")
    source = arch.source
    telescope = arch.telescope
    try:
        telescope_code = telescope_code_dict[telescope.upper()][0]
    except KeyError:
        telescope_code = telescope

    convert = state is not None and state != arch.state
    rotate = (dedisperse and not arch.dedispersed) or (
        dededisperse and (dedisperse or arch.dedispersed))
    frac = 0.125 if rm_baseline else None
    # decode, with the baseline in the same launch when nothing lies
    # between the two
    x = _decode(arch, device, None if convert or rotate else frac, steps)
    steps.mark("K5")
    if convert:
        x = convert_state_data(x, arch.state, state, arch.basis,
                               lambda parts: torch.stack(parts, dim=1))
        arch.npol, arch.state = x.shape[1], state
    if dedisperse and not arch.dedispersed:
        x = _dedisperse(x, arch, 1.0)
        arch.dedispersed = True
    if dededisperse and arch.dedispersed:
        x = _dedisperse(x, arch, -1.0)
        arch.dedispersed = False
    steps.mark("rotate")
    DM = arch.DM
    dmc = arch.dedispersed
    if rm_baseline and (convert or rotate):
        x = _baseline(x)
        steps.mark("K5")
    if tscrunch:
        x = _tscrunch(x, arch)
    nsub = arch.nsub
    integration_length = float(arch.durations.sum())
    doppler_factors = arch.doppler_factors.copy()
    parallactic_angles = arch.parallactic_angles.copy()
    if pscrunch and arch.state != "Intensity":
        x = convert_state_data(x, arch.state, "Intensity", arch.basis, None)
        arch.npol, arch.state = 1, "Intensity"
    state = arch.state
    npol = arch.npol
    if fscrunch:
        x = _fscrunch(x, arch)
    x = x.contiguous()
    steps.mark("scrunch")
    nu0 = arch.nu0
    bw = arch.bw
    nchan = arch.nchan
    freqs = arch.freqs.copy()
    nbin = arch.nbin
    phases = get_bin_centers(nbin).numpy()
    Ps = arch.Ps.copy()
    if len(Ps) < nsub:  # tscrunch keeps one
        Ps = np.resize(Ps, nsub)
    epochs = list(arch.epochs)
    subtimes = list(arch.durations)
    weights = arch.weights.copy()
    weights_norm = np.where(weights == 0.0, 0.0, 1.0)

    if noise_method not in ("PS", "fit"):
        raise ValueError(f"Unknown get_noise method '{noise_method}'.")
    noise, snr = _statistics(x, get_SNRs, steps)
    if noise_method == "fit":  # B10, torch on the device
        noise = get_noise_fit(x)
        steps.mark("K6")
    prof, flux = _work_profile(x, arch, flux_prof, steps)
    prof_stats = torch.empty(2, dtype=torch.float64, device=device)
    _kernels.load_stats(prof[None], torch.fft.rfft(prof)[None],
                        prof_stats[:1], prof_stats[1:])
    steps.mark("profile")

    subints = _download(x)
    shape = (arch.nsub, npol, nchan)
    noise_stds = noise.reshape(shape).cpu().numpy()
    SNRs = snr.reshape(shape).cpu().numpy() if get_SNRs \
        else np.zeros(shape)
    prof = prof.cpu().numpy()
    prof_noise, prof_SNR = (float(v) for v in prof_stats.cpu())
    flux_profile = flux.cpu().numpy() if flux_prof else np.array([])
    steps.mark("download")
    if given is not None and not refresh_arch or return_arch:
        arch.data = subints.copy()
    ok_isubs = np.compress(weights_norm.mean(axis=1),
                           range(arch.nsub))
    ok_ichans = [np.compress(weights_norm[isub], range(nchan))
                 for isub in range(arch.nsub)]
    masks = np.empty((arch.nsub, npol, nchan, nbin))
    masks[...] = weights_norm[:, None, :, None]
    steps.mark("host")

    metrics.observe(PHASE_HISTOGRAM, time.perf_counter() - t_decode0,
                    phase="decode")
    return LoadedBunch(
        device_cube=x if keep_cube else None,
        arch=arch if return_arch else None, backend=arch.backend,
        backend_delay=arch.backend_delay, bw=bw,
        doppler_factors=doppler_factors,
        doppler_degraded=getattr(arch, "doppler_degraded", False),
        DM=DM, dmc=dmc, epochs=epochs,
        filename=getattr(arch, "filename", str(filename)),
        flux_prof=flux_profile, freqs=freqs, frontend=arch.frontend,
        integration_length=integration_length, masks=masks, nbin=nbin,
        nchan=nchan, noise_stds=noise_stds, npol=npol, nsub=arch.nsub,
        nu0=nu0, ok_ichans=ok_ichans, ok_isubs=ok_isubs,
        parallactic_angles=parallactic_angles, phases=phases, prof=prof,
        prof_noise=prof_noise, prof_SNR=prof_SNR, Ps=Ps, SNRs=SNRs,
        source=source, state=state, subints=subints, subtimes=subtimes,
        telescope=telescope, telescope_code=telescope_code,
        weights=weights)


def unload_new_archive(data, arch, outfile, DM=None, dmc=0, weights=None,
                       quiet=True):
    """Write ``data`` into a copy of an existing Archive (or the archive
    at that path) and unload it (reference pplib.py:3039-3075).
    ``dmc=0`` stores the archive dispersed (dedispersed=False)."""
    new = arch.copy() if isinstance(arch, Archive) else \
        read_archive(arch).copy()
    new.data = np.asarray(data, dtype=np.float64).reshape(
        new.nsub, new.npol, new.nchan, new.nbin)
    if DM is not None:
        new.DM = float(DM)
    new.dedispersed = bool(dmc)
    if weights is not None:
        new.weights = np.asarray(weights, dtype=np.float64)
    new.unload(outfile, quiet=quiet)
    return new


def make_fake_pulsar(modelfile, ephemeris, outfile="fake_pulsar.fits",
                     nsub=1, npol=1, nchan=512, nbin=2048, nu0=1500.0,
                     bw=800.0, tsub=300.0, phase=0.0, dDM=0.0,
                     start_MJD=None, weights=None, noise_stds=1.0,
                     scales=1.0, dedispersed=False, t_scat=0.0,
                     alpha=-4.0, scint=False, xs=None, Cs=None,
                     nu_DM=np.inf, state="Stokes", telescope="GBT",
                     frontend="unknown", seed=0, quiet=True):
    """Generate a fake-pulsar PSRFITS archive from a .gmodel file.

    File-producing equivalent of pplib.py:3189-3384.  ``scint`` True
    scintillates each subint with three random triplets (amax 1, wmax 5);
    a list gives the flat triplets for every subint.  ``xs`` (with
    ``Cs``, which must then be given, as in the JAX package) injects the
    (phase, dDM) rotation through the power-law dispersion law of
    ``add_DM_nu`` referred to ``nu_DM``, in place of the nu**-2 rotation.
    The random numbers come from ``numpy.random.default_rng(seed)``: per
    subint in order, the scintillation triplets (with ``scint=True``),
    then one (npol, nchan, nbin) noise draw — so the first n subints of
    an archive do not depend on ``nsub``, and the files differ from the
    JAX package's (which draws from jax.random).  The array math runs on
    CPU tensors.
    """
    from ..config import Dconst
    from ..ops.fourier import add_DM_nu
    from ..ops.scattering import scattering_portrait_FT, scattering_times
    from ..pipelines.synth import add_scintillation, scintillation_params
    from .parfile import read_par

    chanwidth = bw / nchan
    lofreq = nu0 - bw / 2
    freqs = np.linspace(lofreq + chanwidth / 2, lofreq + bw - chanwidth / 2,
                        nchan)
    phases_arr = get_bin_centers(nbin).numpy()
    noise_stds = np.broadcast_to(np.asarray(noise_stds, dtype=np.float64),
                                 (nchan,))
    scales = np.broadcast_to(np.asarray(scales, dtype=np.float64),
                             (nchan,))
    par = read_par(ephemeris)
    P0 = float(par.P0)
    F0 = float(par.F0)
    F1 = float(par.get("F1", 0.0))
    DM = float(par.get("DM", 0.0))
    PEPOCH = float(par.get("PEPOCH", 56000.0))
    if start_MJD is None:
        start_MJD = MJD.from_mjd(PEPOCH)
    epochs = [start_MJD.add_seconds(tsub / 2.0 + isub * tsub)
              for isub in range(nsub)]
    # per-subint folding periods from the (F0, F1) spin model, with a
    # matching POLYCO predictor attached (reference pplib.py:2733, :3343)
    if F1 != 0.0:
        polyco = polyco_from_spin(F0, F1, PEPOCH, psr=str(
            par.get("PSR", par.get("PSRJ", "FAKE"))))
        Ps_sub = polyco.periods([ep.mjd() for ep in epochs])
    else:
        polyco = None
        Ps_sub = np.full(nsub, P0)
    # phase-align each subint epoch to the spin model, as folding with a
    # predictor does (bin 0 of every subint is pulse-phase zero)
    pe_day = int(PEPOCH)
    pe_sec = (PEPOCH - pe_day) * 86400.0
    dts = np.array([(ep.day - pe_day) * 86400.0 + (ep.secs - pe_sec)
                    for ep in epochs])
    spin_phase = F0 * dts + 0.5 * F1 * dts * dts
    epochs = [ep.add_seconds(-float((spin_phase[i] % 1.0) * Ps_sub[i]))
              for i, ep in enumerate(epochs)]
    if polyco is not None:  # periods exactly at the (shifted) epochs
        Ps_sub = polyco.periods([ep.mjd() for ep in epochs])
    if weights is None:
        weights = np.ones([nsub, nchan])

    if xs is not None and Cs is None:
        # the JAX package fails here too (jnp.asarray(None))
        raise ValueError("xs needs Cs: give the coefficient of each "
                         "exponent")
    rng = np.random.default_rng(seed)
    data = np.zeros([nsub, npol, nchan, nbin])
    models = {}
    for isub in range(nsub):
        P = float(Ps_sub[isub])
        if P not in models:
            _, _, model = read_model(modelfile, phases_arr, freqs, P,
                                     quiet=True)
            if xs is not None:
                ph = phase + Dconst * (DM + dDM) * \
                    (nu_DM ** -2 - nu0 ** -2) / P
                model = add_DM_nu(model, -ph, -dDM, P, freqs, xs=xs, Cs=Cs,
                                  nu_ref=nu_DM)
            model = model.numpy()
            if t_scat:
                taus = scattering_times(t_scat / P, alpha, freqs, nu0)
                sp_FT = scattering_portrait_FT(taus, nbin).numpy()
                model = np.fft.irfft(sp_FT * np.fft.rfft(model, axis=-1),
                                     nbin, axis=-1)
            models[P] = model
        model = models[P]
        if scint is not False:
            params = scintillation_params(rng, nsin=3, amax=1.0, wmax=5.0) \
                if scint is True else scint
            model = add_scintillation(torch.as_tensor(model),
                                      params=params).numpy()
        noise = rng.standard_normal((npol, nchan, nbin))
        data[isub] = scales[:, None] * model[None] + \
            noise * noise_stds[:, None]

    with open(ephemeris) as f:
        ephem_text = f.read()
    arch = Archive(data, freqs, weights, Ps_sub, epochs,
                   np.full(nsub, tsub), DM=DM,
                   state=("Intensity" if npol == 1 else state),
                   dedispersed=True, source=str(par.get("PSR", "FAKE")),
                   telescope=telescope, frontend=frontend, nu0=nu0,
                   bw=bw, ephemeris_text=ephem_text, polyco=polyco)
    # the model is built at its intrinsic (aligned) phases = the
    # dedispersed frame; inject the (phase, dDM) rotation one subint at
    # a time (bounded memory; with xs it is in the model already), then
    # store dispersed or dedispersed
    if (phase != 0.0 or dDM != 0.0) and xs is None:
        for isub in range(nsub):
            arch.data[isub] = rotate_data(
                torch.as_tensor(arch.data[isub]), -phase, -dDM,
                float(Ps_sub[isub]), torch.as_tensor(freqs), nu0).numpy()
    if not dedispersed:
        arch.dededisperse()
    arch.unload(outfile, quiet=quiet)
    if not quiet:
        print("Unloaded %s." % outfile)
    return outfile


def parse_metafile(metafile):
    """List of archive paths from a newline-separated metafile
    (reference pptoas.py:92-96)."""
    with open(metafile) as f:
        return [line.strip() for line in f
                if line.strip() and not line.startswith("#")
                and os.path.basename(line.strip()) != ""]
