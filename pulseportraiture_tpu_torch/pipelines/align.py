"""Iterative align-and-average pipeline (ppalign equivalent).

Port of the JAX package's ``pipelines/align.py`` (reference
ppalign.py:54-243 ``align_archives`` and the psradd/psrsmooth wrappers
it calls).  Per iteration, each channelization's subints stream into
blocks of up to 128 rows; a block is uploaded once and fit, rotated and
accumulated on the device: band-average profiles of the dedispersed
block seed the phases (FFTFIT, kernel K2), the batched (phase, DM)
portrait fit runs through kernel K1, one batched rFFT -> phasor -> irFFT
(``_rotate_batch``, cuFFT) rotates every subint by its fit, and the
scale/noise**2-weighted sum builds the next template.  The template and
the sums stay on the device until the iteration ends; archives are
decoded on the host (numpy), and the output is written there.
"""

import math
import sys

import numpy as np
import torch

from ..config import real_dtype, resolve_device
from ..fit.phase_shift import fit_phase_shift
from ..fit.portrait import fit_portrait_full_batch
from ..io.archive import load_data, parse_metafile
from ..ops.fourier import apply_phasor, phase_shifts, rotate_data
from ..ops.normalize import normalize_portrait
from ..ops.profiles import gaussian_profile
from ..ops.stats import median

__all__ = ["align_archives", "average_archives", "make_constant_portrait",
           "psrsmooth_archive"]


def _np(t):
    return t.detach().cpu().numpy()


def make_constant_portrait(archive, outfile, profile=None, DM=0.0,
                           dmc=False, weights=None, quiet=True):
    """Fill a copy of ``archive`` with one profile in every channel
    (reference pplib.py:958-994, without the PSRCHIVE round trip); the
    profile defaults to the archive's full-scrunch average.  Host."""
    from ..io.archive import unload_new_archive
    from ..io.psrfits import read_archive

    arch = read_archive(archive)
    nsub, npol, nchan, nbin = arch.data.shape
    if profile is None:
        sc = arch.copy()
        sc.tscrunch()
        sc.pscrunch()
        sc.dedisperse()
        sc.fscrunch()
        profile = sc.data[0, 0, 0]
    profile = np.asarray(profile)
    if len(profile) != nbin:
        raise ValueError("len(profile) != number of bins in dummy archive")
    if weights is None:
        weights = np.ones([nsub, nchan])
    data = np.broadcast_to(profile, (nsub, npol, nchan, nbin))
    unload_new_archive(data, arch, outfile, DM=DM, dmc=int(dmc),
                       weights=weights, quiet=quiet)
    return outfile


def psrsmooth_archive(archive, options="-W", outfile=None, quiet=True,
                      device=None):
    """Wavelet-smooth an archive's profiles and write '<archive>.sm'
    (the reference's psrsmooth -W wrapper, ppalign.py:40-52): each
    subint's and polarization's [nchan, nbin] portrait goes through
    ops.wavelet.smart_smooth on ``device`` (None = the CUDA device)."""
    from ..io.psrfits import read_archive
    from ..ops.wavelet import smart_smooth

    device = resolve_device(device)
    arch = read_archive(archive)
    sm = arch.copy()
    nsub, npol = sm.data.shape[:2]
    for isub in range(nsub):
        for ipol in range(npol):
            sm.data[isub, ipol] = _np(smart_smooth(
                torch.as_tensor(sm.data[isub, ipol], device=device),
                fallback="raw"))
    if outfile is None:
        outfile = archive + ".sm"
    sm.unload(outfile, quiet=quiet)
    return outfile


def average_archives(datafiles, outfile, palign=False, tscrunch=True,
                     pscrunch=True, quiet=True, device=None):
    """Native psradd: load archives, optionally phase-align their
    band-average profiles against the first one's (psradd -P: FFTFIT,
    kernel K2, and the rotation on ``device``), and average them into one
    archive written to ``outfile``.

    ``pscrunch=False`` keeps all four polarizations (ppalign -p's psradd
    call), averaging in the Stokes basis; the shift is measured on total
    intensity and applied to every pol (reference ppalign.py:21-38).
    """
    device = resolve_device(device)
    if isinstance(datafiles, str):
        datafiles = parse_metafile(datafiles)
    state = "Intensity" if pscrunch else "Stokes"
    total = None
    template_arch = None
    nused = 0
    ref_prof = None
    for f in datafiles:
        try:
            d = load_data(f, state=state, dedisperse=True, tscrunch=True,
                          pscrunch=pscrunch, rm_baseline=True, quiet=True)
        except NotImplementedError as e:
            # e.g. -p on an already-pscrunched archive: skipped, like the
            # reference's ppalign ("converted or skipped")
            print(f"Skipping {f}: cannot convert to {state} ({e})",
                  file=sys.stderr)
            continue
        except (OSError, ValueError, RuntimeError):
            continue
        port = (d.masks * d.subints)[0]            # [npol, nchan, nbin]
        if palign:
            prof = port[0].mean(axis=0)            # Stokes I / intensity
            if ref_prof is None:
                ref_prof = torch.as_tensor(prof, device=device)
            else:
                shift = fit_phase_shift(torch.as_tensor(prof, device=device),
                                        ref_prof, Ns=d.nbin,
                                        device=device).phase
                port = _np(rotate_data(torch.as_tensor(port, device=device),
                                       shift))
        if total is None:
            total = np.zeros_like(port)
            template_arch = d.arch
        if port.shape == total.shape:
            total += port
            nused += 1
    if nused == 0:
        raise ValueError("No loadable archives to average.")
    avg = total / nused
    arch = template_arch.copy()
    arch.tscrunch()
    if pscrunch:
        arch.pscrunch()
    # pscrunch=False: arch came through load_data(state="Stokes"), so it
    # is already Stokes (inconvertible files were skipped above)
    arch.data = avg[None]
    arch.unload(outfile, quiet=quiet)
    return outfile


def _rotate_batch(data, phis, DMs, Ps, freqs, nu_refs):
    """Rotate [B, (npol,) nchan, nbin] by per-subint (phi, DM) about
    per-subint reference frequencies: one batched rFFT -> phasor ->
    irFFT on the device of ``data`` (every argument a tensor there)."""
    shifts = phase_shifts(phis[:, None], DMs[:, None], 0.0, freqs,
                          nu_refs[:, None], math.inf, Ps[:, None])
    if data.ndim == 4:
        shifts = shifts[:, None, :]
    FT = torch.fft.rfft(data, dim=-1)
    return torch.fft.irfft(apply_phasor(FT, shifts), n=data.shape[-1],
                           dim=-1)


def _guess_fit_freqs_np(freqs, SNRs, mask):
    """Masked SNR*nu^-2-weighted frequency per subint (a numpy batch of
    fit.transforms.guess_fit_freq; host-side, it feeds the device
    calls).  Rows with no valid channels fall back to the unmasked mean
    frequency (their weights are zero everywhere downstream)."""
    any_ok = (mask > 0).any(axis=-1)
    big = np.where(mask > 0, freqs, np.nan)
    with np.errstate(all="ignore"):
        nu0 = np.where(
            any_ok,
            0.5 * (np.nanmin(np.where(any_ok[:, None], big, 0.0), axis=-1)
                   + np.nanmax(np.where(any_ok[:, None], big, 0.0),
                               axis=-1)),
            freqs.mean(axis=-1))
    w = np.where(mask > 0, SNRs * freqs ** -2.0, 0.0)
    nu = nu0 + np.sum((freqs - nu0[:, None]) * w, axis=-1) / \
        np.maximum(w.sum(axis=-1), 1e-300)
    return np.where(any_ok, nu, freqs.mean(axis=-1))


def _pad_rows(nrows, chunk_max):
    """Block size for ``nrows`` live rows: the next power of two (>= 8),
    capped at chunk_max."""
    b = 8
    while b < nrows:
        b *= 2
    return min(b, chunk_max)


def _assemble_block(rows, dnchan, nchan, nbin, npol, chunk_max):
    """One padded block from a list of (entry, j) subint rows: host
    arrays, and per row the template channel of each data channel.

    Padding rows carry zero data, zero weights, and the template as
    their model (so the fit stays finite); their zero weights drop them
    from the accumulation."""
    B = _pad_rows(len(rows), chunk_max)
    full = np.zeros((B, npol, dnchan, nbin))
    tmpl_chans = np.broadcast_to(np.arange(dnchan) % nchan,
                                 (B, dnchan)).copy()
    freqs_b = np.ones((B, dnchan))
    errs_b = np.ones((B, dnchan))
    SNRs_b = np.zeros((B, dnchan))
    Ps_b = np.ones(B)
    wok = np.zeros((B, dnchan))
    DMg = np.zeros(B)
    chan_maps = []
    for r, (e, j) in enumerate(rows):
        full[r] = e["full"][j]
        cm = e["chan_map"]
        if cm is not None:
            tmpl_chans[r] = cm
        freqs_b[r] = e["freqs"][j]
        errs_b[r] = e["errs"][j]
        SNRs_b[r] = e["SNRs"][j]
        Ps_b[r] = e["Ps"][j]
        wok[r] = e["wok"][j]
        DMg[r] = e["DM"]
        chan_maps.append(cm)
    return (full, tmpl_chans, freqs_b, errs_b, SNRs_b, Ps_b, wok,
            DMg), chan_maps


def _align_fit_accumulate(full, model_b, freqs_b, errs_b, nu_fit, Ps_b,
                          wok, DMg, chan_maps, fit_dm, max_iter, nbin, npol,
                          aligned_port, total_weights):
    """One batched align pass over a [B, npol, nchan, nbin] block of
    device tensors: seed (dedisperse + band-average FFTFIT, K2), the
    (phi, DM) portrait fit (K1), rotate, and accumulate into the device
    tensors aligned_port/total_weights (in place).  ``model_b`` is the
    template [nchan, nbin] shared by every row, or one [B, nchan, nbin]
    model per row; ``nu_fit`` [B] the rows' fit frequencies."""
    dev = full.device
    ports = full[:, 0]
    rot = _rotate_batch(ports, torch.zeros_like(Ps_b), DMg, Ps_b, freqs_b,
                        nu_fit)
    denom = torch.clamp(wok.sum(-1), min=1.0)[:, None]
    rot_profs = (rot * wok[..., None]).sum(1) / denom
    del rot
    model_profs = (model_b * wok[..., None]).sum(-2) / denom
    g = fit_phase_shift(rot_profs, model_profs, noise=median(errs_b),
                        Ns=nbin, device=dev)
    init = torch.zeros((len(Ps_b), 5), dtype=real_dtype, device=dev)
    init[:, 0] = torch.nan_to_num(g.phase)
    init[:, 1] = DMg
    out = fit_portrait_full_batch(
        ports, model_b, init, Ps_b, freqs_b, errs=errs_b, weights=wok,
        fit_flags=(1, int(bool(fit_dm)), 0, 0, 0),
        nu_fits=torch.stack([nu_fit] * 3, dim=1), log10_tau=False,
        max_iter=max_iter, device=dev)
    # padded / fully-zapped rows can carry non-finite fit results; their
    # weights are zero, but 0*nan would still poison the accumulation
    phi_f = torch.nan_to_num(out.phi)
    DM_f = torch.nan_to_num(out.DM)
    nu_f = torch.nan_to_num(out.nu_DM, nan=1.0)
    rotated = torch.nan_to_num(_rotate_batch(full, phi_f, DM_f, Ps_b,
                                             freqs_b, nu_f))
    okw = wok > 0
    errs_safe = torch.where(okw, errs_b, torch.ones_like(errs_b))
    w_bc = torch.nan_to_num(torch.where(
        okw, out.scales / errs_safe ** 2, torch.zeros_like(errs_b)))
    if all(cm is None for cm in chan_maps):
        aligned_port += torch.einsum("bc,bpcn->pcn", w_bc, rotated)
        total_weights += w_bc.sum(0)[:, None]
    else:
        # row by row in the reference's order: each live channel adds to
        # its template channel (its own, or the nearest in frequency)
        tchan = torch.as_tensor(np.concatenate([
            np.arange(wok.shape[1]) if cm is None else cm
            for cm in chan_maps]), device=dev)
        rows = torch.arange(len(chan_maps), device=dev)
        sel = okw[rows].reshape(-1)
        tchan = tchan[sel]
        wcol = w_bc[rows].reshape(-1)[sel]                  # [n]
        vals = rotated[rows].transpose(1, 2).reshape(-1, npol, nbin)[sel]
        aligned_port.index_add_(1, tchan,
                                (wcol[:, None, None] * vals).transpose(0, 1))
        total_weights.index_add_(0, tchan, wcol[:, None].expand(-1, nbin))


def align_archives(metafile, initial_guess, fit_dm=True, tscrunch=False,
                   pscrunch=True, SNR_cutoff=0.0, outfile=None, norm=None,
                   rot_phase=0.0, place=None, niter=1, quiet=True,
                   max_iter=30, device=None):
    """Iteratively align + average archives against a template.

    metafile: metafile path or list of archive paths; initial_guess: a
    PSRFITS archive giving the starting template.  Behavior follows
    ppalign.py:54-243: per subint, (phase, DM) is fit against the
    template, subints are rotated and accumulated weighted by
    scales/noise**2, the average becomes the next template; the output
    archive gets DM=0 and dmc=0.  Runs on ``device`` (None = the CUDA
    device).

    Returns (outfile, aligned_port [npol, nchan, nbin], total_weights
    [nchan, nbin]) with the arrays as host numpy.
    """
    device = resolve_device(device)
    if isinstance(metafile, str):
        datafiles = parse_metafile(metafile)
        if outfile is None:
            outfile = metafile + ".algnd.fits"
    else:
        datafiles = list(metafile)
        if outfile is None:
            outfile = "aligned.fits"
    state = "Intensity" if pscrunch else "Stokes"
    npol = 1 if pscrunch else 4

    model_data = load_data(initial_guess, state=state, dedisperse=True,
                           tscrunch=True, pscrunch=pscrunch,
                           rm_baseline=True, refresh_arch=True,
                           return_arch=True, quiet=True)
    nchan, nbin = model_data.nchan, model_data.nbin
    model_port = torch.as_tensor(
        (model_data.masks * model_data.subints)[0, 0], device=device)

    def dev(x):
        return torch.as_tensor(x, dtype=real_dtype, device=device)

    skip_these = set()
    aligned_port = torch.zeros((npol, nchan, nbin), dtype=real_dtype,
                               device=device)
    total_weights = torch.zeros((nchan, nbin), dtype=real_dtype,
                                device=device)
    model_mask = np.zeros(nchan)
    model_mask[model_data.ok_ichans[0]] = 1.0
    chunk_max = 128
    for count in range(1, niter + 1):
        if not quiet:
            print(f"Doing iteration {count}...")
        aligned_port.zero_()
        total_weights.zero_()
        use_files = [f for f in datafiles if f not in skip_these]
        # streaming assembly: rows queue per channelization and full
        # blocks flush as soon as chunk_max rows are pending, so memory
        # holds ~chunk_max subints + the archive being loaded
        pending = {}

        def flush(dnchan, force=False):
            rows = pending.get(dnchan, [])
            while len(rows) >= chunk_max or (force and rows):
                take, rows = rows[:chunk_max], rows[chunk_max:]
                block, cmaps = _assemble_block(take, dnchan, nchan, nbin,
                                               npol, chunk_max)
                full, tmpl_chans, freqs_b, errs_b, SNRs_b, Ps_b, wok_b, \
                    DMg = block
                if dnchan == nchan and all(cm is None for cm in cmaps):
                    model_b = model_port      # one template for every row
                else:
                    model_b = model_port[torch.as_tensor(tmpl_chans,
                                                         device=device)]
                nu_fit = _guess_fit_freqs_np(freqs_b, SNRs_b, wok_b)
                _align_fit_accumulate(
                    dev(full), model_b, *(dev(a) for a in (
                        freqs_b, errs_b, nu_fit, Ps_b, wok_b, DMg)),
                    chan_maps=cmaps, fit_dm=fit_dm, max_iter=max_iter,
                    nbin=nbin, npol=npol, aligned_port=aligned_port,
                    total_weights=total_weights)
            pending[dnchan] = rows

        for datafile in use_files:
            try:
                d = load_data(datafile, state=state, dedisperse=False,
                              tscrunch=tscrunch, pscrunch=pscrunch,
                              rm_baseline=True, refresh_arch=False,
                              return_arch=False, quiet=True)
            except NotImplementedError as e:
                print(f"Skipping {datafile}: cannot convert to {state} "
                      f"({e})", file=sys.stderr)
                skip_these.add(datafile)
                continue
            except (OSError, ValueError, RuntimeError):
                skip_these.add(datafile)
                continue
            if d.nbin != nbin or d.prof_SNR < SNR_cutoff:
                skip_these.add(datafile)
                continue
            same_freqs = d.freqs.shape[-1] == nchan and \
                np.allclose(d.freqs[0], model_data.freqs[0])
            ok = np.asarray(d.ok_isubs)
            if not len(ok):
                continue
            wok = (d.weights[ok] > 0.0).astype(float)
            if same_freqs:
                wok = wok * model_mask[None, :]
                chan_map = None
            else:
                # nearest-frequency template channels (ppalign.py:165-172)
                chan_map = np.argmin(np.abs(
                    model_data.freqs[0][None, :]
                    - d.freqs[0][:, None]), axis=1)
            entry = dict(
                full=d.subints[ok], freqs=d.freqs[ok],
                errs=d.noise_stds[ok, 0], SNRs=d.SNRs[ok, 0],
                Ps=d.Ps[ok], wok=wok, chan_map=chan_map, DM=float(d.DM))
            dnchan = d.freqs.shape[-1]
            pending.setdefault(dnchan, []).extend(
                (entry, j) for j in range(len(ok)))
            flush(dnchan)

        for dnchan in list(pending):
            flush(dnchan, force=True)
        nz = total_weights > 0
        aligned_port = torch.where(
            nz, aligned_port / torch.where(nz, total_weights,
                                           torch.ones_like(total_weights)),
            aligned_port)
        model_port = aligned_port[0].clone()

    if norm in ("mean", "max", "prof", "rms", "abs"):
        aligned_port = torch.stack([normalize_portrait(aligned_port[ipol],
                                                       norm)
                                    for ipol in range(npol)])
    if rot_phase:
        aligned_port = rotate_data(aligned_port, rot_phase)
    if place is not None:
        prof = aligned_port[0].mean(dim=0)
        delta = prof.max() * gaussian_profile(nbin, place, 0.0001,
                                              device=device)
        phase = fit_phase_shift(prof, delta, Ns=nbin, device=device).phase
        aligned_port = rotate_data(aligned_port, phase)

    aligned_port, total_weights = _np(aligned_port), _np(total_weights)
    arch = model_data.arch.copy()
    arch.tscrunch()
    if pscrunch:
        arch.pscrunch()
    arch.DM = 0.0
    arch.dedispersed = False
    arch.data = aligned_port[None]
    arch.weights = np.where(total_weights.sum(axis=-1) > 0.0, 1.0,
                            0.0)[None, :]
    arch.unload(outfile, quiet=quiet)
    return outfile, aligned_port, total_weights
