"""Archive loading with the reference's load_data schema + fake archives.

Port of the JAX package's ``io/archive.py`` (reference
pplib.py:2650-2820 load_data and :3189-3384
make_fake_pulsar) on the in-repo PSRFITS layer (io.psrfits).

Placement: ``load_data`` is host I/O.  Its per-archive noise and S/N
estimates are computed on explicit CPU tensors — a stated placement
(the load path never touches the accelerator), not a fallback.

Hooks, as in the JAX module: the ``archive_read`` fault-injection site
(testing/faults.py) at the top of ``load_data``, and its decode seconds
observed into the ``pps_phase_seconds`` histogram (``phase="decode"``)
of an open obs run.
"""

import os
import time

import numpy as np
import torch

from ..obs import metrics
from ..obs.metrics import PHASE_HISTOGRAM
from ..ops.fourier import get_bin_centers, rotate_data
from ..ops.noise import get_SNR, get_noise
from ..testing import faults
from ..utils.databunch import DataBunch
from ..utils.mjd import MJD
from ..utils.telescopes import telescope_code_dict
from .gmodel import read_model
from .polyco import polyco_from_spin
from .psrfits import Archive, read_archive

__all__ = ["load_data", "unload_new_archive", "make_fake_pulsar",
           "file_is_type", "parse_metafile"]

_HOST = torch.device("cpu")


def _host_stat(fn, x, **kw):
    """Evaluate a statistic of a numpy array on CPU tensors -> numpy."""
    return fn(torch.as_tensor(np.asarray(x), device=_HOST), **kw).numpy()


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


def load_data(filename, state=None, dedisperse=False, dededisperse=False,
              tscrunch=False, pscrunch=False, fscrunch=False,
              rm_baseline=True, flux_prof=False, refresh_arch=True,
              return_arch=True, quiet=True, get_SNRs=True,
              noise_method="PS"):
    """Load a PSRFITS archive into the canonical DataBunch schema.

    Field-for-field equivalent of the reference's load_data
    (pplib.py:2650-2820): subints
    [nsub, npol, nchan, nbin], freqs [nsub, nchan], weights, masks,
    noise_stds [nsub, npol, nchan], SNRs, ok_isubs, ok_ichans, Ps,
    epochs, phases, prof, flux_prof, plus observation metadata — all
    numpy.
    """
    # chaos site: an injected read fault surfaces exactly like a
    # truncated payload or NFS blip (testing/faults.py)
    faults.check("archive_read", key=getattr(filename, "filename",
                                             None) or str(filename))
    t_decode0 = time.perf_counter()
    arch = filename if isinstance(filename, Archive) \
        else read_archive(filename)
    if refresh_arch:
        arch = arch.copy()  # manipulations below stay local
    source = arch.source
    telescope = arch.telescope
    try:
        telescope_code = telescope_code_dict[telescope.upper()][0]
    except KeyError:
        telescope_code = telescope

    if state is not None and state != arch.state:
        arch.convert_state(state)
    if dedisperse:
        arch.dedisperse()
    if dededisperse:
        arch.dededisperse()
    DM = arch.DM
    dmc = arch.dedispersed
    if rm_baseline:
        arch.remove_baseline()
    if tscrunch:
        arch.tscrunch()
    nsub = arch.nsub
    integration_length = float(arch.durations.sum())
    doppler_factors = arch.doppler_factors.copy()
    parallactic_angles = arch.parallactic_angles.copy()
    if pscrunch:
        arch.pscrunch()
    state = arch.state
    npol = arch.npol
    if fscrunch:
        arch.fscrunch()
    nu0 = arch.nu0
    bw = arch.bw
    nchan = arch.nchan
    freqs = arch.freqs.copy()
    nbin = arch.nbin
    phases = get_bin_centers(nbin).numpy()
    subints = arch.data.copy()
    Ps = arch.Ps.copy()
    if len(Ps) < nsub:  # tscrunch keeps one
        Ps = np.resize(Ps, nsub)
    epochs = list(arch.epochs)
    subtimes = list(arch.durations)
    weights = arch.weights.copy()
    weights_norm = np.where(weights == 0.0, 0.0, 1.0)

    noise_stds = _host_stat(get_noise, subints, method=noise_method)
    ok_isubs = np.compress(weights_norm.mean(axis=1),
                           range(arch.nsub))
    ok_ichans = [np.compress(weights_norm[isub], range(nchan))
                 for isub in range(arch.nsub)]
    masks = np.einsum("ij,k->ijk", weights_norm, np.ones(nbin))
    masks = np.einsum("j,ikl->ijkl", np.ones(npol), masks)
    if get_SNRs:
        SNRs = _host_stat(get_SNR, subints)
    else:
        SNRs = np.zeros([arch.nsub, npol, nchan])

    work = arch.copy()
    work.pscrunch()
    if flux_prof:
        fa = work.copy()
        fa.dedisperse()
        fa.tscrunch()
        flux_profile = fa.data.mean(axis=3)[0][0]
    else:
        flux_profile = np.array([])
    work.dedisperse()
    work.tscrunch()
    work.fscrunch()
    prof = work.data[0, 0, 0]
    prof_noise = float(_host_stat(get_noise, prof))
    prof_SNR = float(_host_stat(get_SNR, prof))

    metrics.observe(PHASE_HISTOGRAM, time.perf_counter() - t_decode0,
                    phase="decode")
    return DataBunch(
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
    new.data = np.asarray(data, dtype=np.float64).reshape(new.data.shape)
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
