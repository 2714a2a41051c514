"""Wideband and narrowband TOA measurement pipeline (pptoas equivalent).

Port of the JAX package's ``pipelines/toas.py`` (reference
pptoas.py:75-1278).  Per archive, every subint is fit in one batched
call per fit-flag group on the pipeline's device — the FFTFIT phase
guesses through kernel K2, the portrait fits through kernel K1 (B = 1)
or K3 (scattering) — with zapped channels handled as dense weight masks.
Narrowband TOAs fit every live (subint, channel) profile in one FFTFIT
call (K2), or with ``fit_scat`` as one-channel portraits through K3.
Templates are .gmodel files, spline containers (npz or legacy pickle)
or FITS archives; the model portrait is built on the device and stays
there.  Result attributes keep the reference's names and per-archive
list structure.  ``checkpoint`` appends each archive's TOAs to a .tim
file with a ``C pp_done`` marker, the JAX package's crash-resume format.

Not ported yet: PSRCHIVE cross-check TOAs, plots, and the JAX package's
observability, fault-injection and prefetch hooks.  Device errors are
not caught per archive: a kernel fault surfaces.
"""

import os
import threading
import time

import numpy as np
import torch

from ..config import resolve_device, scattering_alpha
from ..fit.phase_shift import fit_phase_shift
from ..fit.portrait import fit_portrait_full_batch
from ..fit.transforms import guess_fit_freq, phase_transform
from ..io.archive import file_is_type, load_data, parse_metafile
from ..io.gmodel import read_model
from ..io.splmodel import read_spline_model
from ..io.timfile import TOA, filter_TOAs, format_toa_line, write_TOAs
from ..ops.fourier import rotate_data
from ..ops.instrumental import instrumental_response_port_FT
from ..ops.profiles import gen_gaussian_portrait
from ..ops.scattering import scattering_portrait_FT, scattering_times
from ..ops.stats import weighted_mean
from ..utils.databunch import DataBunch

__all__ = ["GetTOAs", "drop_checkpoint_blocks", "checkpoint_traces",
           "load_archive_data"]

# one lock per checkpoint file: block + marker appends, the resume
# validation (which may rewrite the file) and block drops must not
# interleave when several threads share a checkpoint
_CKPT_LOCKS = {}
_CKPT_LOCKS_GUARD = threading.Lock()


def _not_ported(what):
    return NotImplementedError(
        "%s is not yet ported to pulseportraiture_tpu_torch." % what)


def _checkpoint_lock(checkpoint):
    key = os.path.realpath(checkpoint)
    with _CKPT_LOCKS_GUARD:
        lock = _CKPT_LOCKS.get(key)
        if lock is None:
            lock = _CKPT_LOCKS[key] = threading.RLock()
    return lock


def _is_marker(tok):
    return len(tok) >= 4 and tok[0] == "C" and tok[1] == "pp_done"


def checkpoint_traces(checkpoint):
    """{realpath(archive): trace_id} for every marked block of a
    checkpoint whose marker carries a ``trace=`` token (markers the JAX
    package writes under an ambient trace; the port writes none)."""
    out = {}
    try:
        with open(checkpoint) as cf:
            for ln in cf:
                tok = ln.split()
                if _is_marker(tok) and len(tok) >= 5 \
                        and tok[4].startswith("trace="):
                    out[os.path.realpath(tok[2])] = tok[4][6:]
    except OSError:
        pass
    return out


def _rewrite(checkpoint, lines):
    """Replace the checkpoint's contents atomically."""
    tmp = checkpoint + ".tmp"
    with open(tmp, "w") as tf:
        tf.writelines(lines)
    os.replace(tmp, checkpoint)


def _resume_checkpoint(checkpoint, quiet=True):
    """Validate a crash-resume .tim checkpoint; return the archives done.

    Each archive's TOA block ends with a ``C pp_done <archive> <nlines>``
    marker written in the same append, so a crash mid-write leaves an
    unterminated (or count-mismatched) block: such partial blocks are
    dropped — the file rewritten without them — and their archives refit.
    A checkpoint without any marker (written before the format had them)
    keeps every block but the trailing one and is rewritten with markers.
    Returns os.path.realpath-normalized archive names."""
    with _checkpoint_lock(checkpoint):
        return _resume_checkpoint_locked(checkpoint, quiet)


def _resume_checkpoint_locked(checkpoint, quiet):
    with open(checkpoint) as cf:
        lines = cf.readlines()
    if not any(_is_marker(ln.split()) for ln in lines):
        return _resume_markerless_checkpoint(checkpoint, lines, quiet)
    done, kept = set(), []
    buf_arch, buf = None, []
    dirty = False
    for ln in lines:
        tok = ln.split()
        if _is_marker(tok):
            arch, n = tok[2], tok[3]
            # buf_arch is None for a zero-TOA archive (all its TOAs
            # culled): a 0-count marker is then valid, not partial
            if (arch == buf_arch or buf_arch is None) and \
                    n.isdigit() and len(buf) == int(n):
                kept.extend(buf)
                kept.append(ln)
                done.add(os.path.realpath(arch))
            else:  # marker without its (complete) block: drop both
                dirty = True
            buf_arch, buf = None, []
        elif not tok or tok[0] in ("FORMAT", "C", "#"):
            kept.append(ln)
        else:  # a TOA line; its first token is the archive name
            if buf_arch is not None and tok[0] != buf_arch:
                dirty = True  # interleaved block: treat as partial
                buf = []
            buf_arch = tok[0]
            buf.append(ln)
    if buf:  # trailing block with no marker: crash mid-archive
        dirty = True
    if dirty:
        _rewrite(checkpoint, kept)
        if not quiet:
            print(f"checkpoint {checkpoint}: dropped partial archive "
                  "blocks; they will be refit.")
    return done


def _resume_markerless_checkpoint(checkpoint, lines, quiet=True):
    """Legacy (pre-marker) checkpoint: accept every archive block but
    the trailing one, which a crash may have truncated; rewrite the file
    with pp_done markers so later resumes read the current format."""
    done, kept = set(), []
    buf_arch, buf = None, []

    def flush():
        if buf:
            kept.extend(buf)
            kept.append(f"C pp_done {buf_arch} {len(buf)}\n")
            done.add(os.path.realpath(buf_arch))

    for ln in lines:
        tok = ln.split()
        if not tok or tok[0] in ("FORMAT", "C", "#"):
            kept.append(ln)
        else:
            if buf_arch is not None and tok[0] != buf_arch:
                flush()
                buf = []
            buf_arch = tok[0]
            buf.append(ln)
    # the trailing block is dropped (not flushed): with no marker there
    # is no telling a complete block from a mid-write crash
    _rewrite(checkpoint, kept)
    if not quiet:
        print(f"checkpoint {checkpoint}: no pp_done markers (legacy "
              f"file, or a crash before the first marker); accepted "
              f"{len(done)} archives, refitting the trailing block "
              f"({len(buf)} TOA lines).")
    return done


def drop_checkpoint_blocks(checkpoint, archives):
    """Remove the TOA blocks (and their ``pp_done`` markers) of the given
    archives from a checkpoint .tim file, atomically, so those archives
    refit instead of being skipped.  Archives match by
    ``os.path.realpath``.  Returns the number of markers dropped."""
    targets = {os.path.realpath(a) for a in archives}
    if not targets or not os.path.isfile(checkpoint):
        return 0
    with _checkpoint_lock(checkpoint):
        with open(checkpoint) as cf:
            lines = cf.readlines()
        kept, dropped = [], 0
        for ln in lines:
            tok = ln.split()
            if _is_marker(tok):
                if os.path.realpath(tok[2]) in targets:
                    dropped += 1
                    continue
            elif tok and tok[0] not in ("FORMAT", "C", "#") and \
                    os.path.realpath(tok[0]) in targets:
                continue
            kept.append(ln)
        if dropped or len(kept) != len(lines):
            _rewrite(checkpoint, kept)
        return dropped


def _append_checkpoint(checkpoint, toas, datafile):
    """Append one archive's TOA lines (S/N-flagged ones, as the JAX
    package writes) and their ``pp_done`` marker in one write."""
    arch_toas = filter_TOAs([t for t in toas if t.archive == datafile],
                            "snr", 0.0, ">=", pass_unflagged=False)
    blk = [format_toa_line(t) for t in arch_toas]
    blk.append("C pp_done %s %d" % (datafile, len(blk)))
    with _checkpoint_lock(checkpoint):
        with open(checkpoint, "a") as cf:
            cf.write("".join(line + "\n" for line in blk))


def _detect_model_type(modelfile):
    """'FITS' | 'spline' | 'gmodel' for a model file path."""
    kind = file_is_type(modelfile)
    if kind == "FITS":
        return "FITS"
    if kind == "ASCII":
        return "gmodel"
    return "spline"  # npz or legacy pickle container


def _nonfinite_guard(ports, errs_b, weights_b):
    """Zero-weight every live channel whose data or noise estimate is
    non-finite (NaN * 0 == NaN, so weights alone cannot contain it).

    Returns ``(ports, errs_b, weights_b, bad_chan, n_zap, n_live)``:
    scrubbed copies, the [B, nchan] bad-channel mask, the number of
    channels zapped and the number that were live going in."""
    wok = weights_b > 0.0
    bad = (~np.isfinite(ports).all(axis=-1)
           | ~np.isfinite(errs_b)) & wok
    n_zap = int(bad.sum())
    if n_zap == 0:
        return ports, errs_b, weights_b, bad, 0, int(wok.sum())
    ports = np.where(bad[..., None], 0.0, ports)
    errs_b = np.where(bad, 1.0, errs_b)
    weights_b = np.where(bad, 0.0, weights_b)
    return ports, errs_b, weights_b, bad, n_zap, int(wok.sum())


def _load(datafile, tscrunch, quiet):
    """load_data with the reference's dmc-reload (pptoas.py:216-233)."""
    data = load_data(datafile, dedisperse=False, dededisperse=False,
                     tscrunch=tscrunch, pscrunch=True, rm_baseline=True,
                     refresh_arch=False, return_arch=False, quiet=quiet)
    if data.dmc:
        data = load_data(datafile, dedisperse=False, dededisperse=True,
                         tscrunch=tscrunch, pscrunch=True, rm_baseline=True,
                         refresh_arch=False, return_arch=False, quiet=quiet)
    return data


def load_archive_data(datafile, tscrunch=False, quiet=True):
    """load_data with the reference's dmc-reload; returns the DataBunch,
    or None when the archive cannot be used."""
    try:
        data = _load(datafile, tscrunch, quiet)
        if not len(data.ok_isubs):
            if not quiet:
                print(f"No subints to fit for {datafile}; skipping it.")
            return None
        return data
    except (RuntimeError, ValueError, OSError) as e:
        if not quiet:
            print(f"Cannot load_data({datafile}): {e}; skipping it.")
        return None


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _convolve(port, resp_FT):
    """irfft(resp_FT * rfft(port)) along the last axis."""
    nbin = port.shape[-1]
    return torch.fft.irfft(resp_FT * torch.fft.rfft(port, dim=-1), n=nbin,
                           dim=-1)


def _scatter(port, taus):
    """``port`` [..., nbin] scattered by the times ``taus`` [...] [rot]."""
    return _convolve(port, scattering_portrait_FT(taus, port.shape[-1]))


class GetTOAs:
    """Measure wideband TOAs/DMs (or narrowband TOAs) from archives.

    datafiles: archive path, list of paths, or metafile; modelfile: a
    .gmodel file, a spline container or a FITS template archive; device:
    where the fits run (None = the CUDA device; raises when there is
    none — pass "cpu" to run on the CPU).  API and result attributes
    follow pptoas.py:75-148.  ``ird`` (= instrumental_response_dict)
    holds the DM-smearing switch and the response widths/types that
    ``add_instrumental_response`` convolves the model with.
    """

    RESULT_ATTRS = (
        "order", "obs", "doppler_fs", "nu0s", "nu_fits",
        "nu_refs", "ok_idatafiles", "ok_isubs", "epochs",
        "MJDs", "Ps", "phis", "phi_errs", "TOAs", "TOA_errs",
        "DM0s", "DMs", "DM_errs", "DeltaDM_means",
        "DeltaDM_errs", "GMs", "GM_errs", "taus", "tau_errs",
        "alphas", "alpha_errs", "scales", "scale_errs",
        "snrs", "channel_snrs", "profile_fluxes",
        "profile_flux_errs", "fluxes", "flux_errs",
        "flux_freqs", "covariances", "red_chi2s", "nfevals",
        "rcs", "fit_durations", "n_nonfinite_zapped")

    def __init__(self, datafiles, modelfile, quiet=True, device=None):
        self.device = resolve_device(device)
        if isinstance(datafiles, str):
            if file_is_type(datafiles) == "ASCII":
                self.datafiles = parse_metafile(datafiles)
            else:
                self.datafiles = [datafiles]
        else:
            self.datafiles = list(datafiles)
        self.modelfile = modelfile
        self.model_type = _detect_model_type(modelfile)
        self.is_FITS_model = self.model_type == "FITS"
        self.quiet = quiet
        self.instrumental_response_dict = self.ird = \
            {"DM": 0.0, "wids": [], "irf_types": []}
        # archives the non-finite guard refused to fit: (datafile, reason)
        self.poisoned_datafiles = []
        for attr in self.RESULT_ATTRS:
            setattr(self, attr, [])
        self.TOA_list = []

    # -- model construction --------------------------------------------
    def _build_model(self, freqs, phases, P, fit_scat):
        """Model portrait [nchan, nbin], a tensor on the pipeline's
        device, at the given channel frequencies.  For fit_scat with a
        .gmodel the model's own scattering is stripped — the fit measures
        it — and its TAU/ALPHA kept for the guesses (pptoas.py:355-374)."""
        nbin = len(phases)
        if self.model_type == "gmodel":
            if not fit_scat:
                self.model_name, self.ngauss, model = read_model(
                    self.modelfile, phases, freqs, P, quiet=True,
                    device=self.device)
                return model
            (self.model_name, self.model_code, self.model_nu_ref,
             self.ngauss, self.gparams, _, self.alpha, _) = read_model(
                 self.modelfile, quiet=True)
            unscat = np.copy(self.gparams)
            unscat[1] = 0.0
            return gen_gaussian_portrait(self.model_code, unscat, 0.0,
                                         phases, freqs, self.model_nu_ref,
                                         device=self.device)
        if self.model_type == "spline":
            self.model_name, model = read_spline_model(
                self.modelfile, freqs, nbin, quiet=True, device=self.device)
            return model
        # FITS template archive
        model_data = load_data(self.modelfile, dedisperse=False,
                               tscrunch=True, pscrunch=True,
                               rm_baseline=True, quiet=True)
        self.model_name = model_data.source
        model = (model_data.masks * model_data.subints)[0, 0]
        if model_data.nchan == 1:
            model = np.tile(model[0], (len(freqs), 1))
        return torch.as_tensor(model).to(self.device)

    def _prepare_models(self, d, shape, freqs_b, Ps_b, fit_scat,
                        add_instrumental_response, datafile):
        """(models, same_freqs) for one archive's batch of ``shape`` [B,
        nchan, nbin], on the device: one model [nchan, nbin] for the batch
        when every subint has the same channel frequencies, else one per
        subint [B, nchan, nbin].  Checks a FITS template's nbin and applies
        the optional instrumental response.  models is None when the
        archive must be skipped."""
        nbin = shape[-1]
        same_freqs = np.allclose(freqs_b, freqs_b[0])
        if same_freqs:
            models = self._build_model(freqs_b[0], d.phases,
                                       float(Ps_b[0]), fit_scat)
        else:
            models = torch.stack([
                self._build_model(freqs_b[i], d.phases, float(Ps_b[i]),
                                  fit_scat) for i in range(shape[0])])
        if self.is_FITS_model and models.shape[-1] != nbin:
            print(f"Model nbin != data nbin for {datafile}; skipping it.")
            return None, same_freqs
        if add_instrumental_response and (self.ird["DM"]
                                          or len(self.ird["wids"])):
            models = _convolve(models, self._instrumental_FT(
                nbin, freqs_b[0], float(Ps_b[0])))
        return models, same_freqs

    def _instrumental_FT(self, nbin, freqs, P):
        return instrumental_response_port_FT(
            nbin, torch.as_tensor(freqs).to(self.device), self.ird["DM"], P,
            self.ird["wids"], self.ird["irf_types"])

    def _checked_batch(self, d, datafile, nonfinite_max_frac, quiet):
        """The archive's fit batch after the non-finite guard:
        (ok, ports, freqs_b, weights_b, errs_b, SNRs_b, Ps_b, bad_chan,
        n_zap), or None when the archive is refused."""
        ok = np.asarray(d.ok_isubs)
        ports, errs_b, weights_b, bad_chan, n_zap, n_live = \
            _nonfinite_guard(d.subints[ok, 0], d.noise_stds[ok, 0],
                             d.weights[ok])
        if n_zap and n_zap / max(n_live, 1) > nonfinite_max_frac:
            reason = ("non-finite data: %d/%d live channels NaN/Inf "
                      "(> nonfinite_max_frac=%.2f)"
                      % (n_zap, n_live, nonfinite_max_frac))
            self.poisoned_datafiles.append((datafile, reason))
            if not quiet:
                print(f"{datafile}: {reason}; not fitting it.")
            return None
        return (ok, ports, d.freqs[ok], weights_b, errs_b, d.SNRs[ok, 0],
                d.Ps[ok], bad_chan, n_zap)

    def _fluxes(self, models, freqs_b, wok, scales, scale_errs, taus=None,
                scat_rows=None):
        """Profile fluxes [B, nchan] of the scaled template (scattered by
        ``taus`` [B, nchan] in the subints ``scat_rows`` [B] marks), their
        errors, and each subint's weighted mean flux, its error and its
        flux-weighted frequency [B]: the JAX package's per-subint formula
        (toas.py:853-877) in one batched pass on the device; models is
        [nchan, nbin] (shared) or [B, nchan, nbin].  Host numpy out."""
        dev = self.device
        okc = torch.as_tensor(wok > 0.0, device=dev)
        if models.ndim == 2:
            models = models.expand(len(wok), *models.shape)
        if taus is not None:
            rows = torch.as_tensor(scat_rows, device=dev)[:, None, None]
            models = torch.where(rows, _scatter(models, taus.to(dev)),
                                 models)
        means = models.mean(dim=-1)
        scales = torch.as_tensor(scales).to(dev)
        scale_errs = torch.as_tensor(scale_errs).to(dev)
        zero = torch.zeros_like(means)
        pf = torch.where(okc, means * scales, zero)
        pfe = torch.where(okc, torch.abs(means) * scale_errs, zero)
        flux, flux_err = weighted_mean(pf, pfe, dim=-1)
        freqs = torch.where(okc, torch.as_tensor(freqs_b).to(dev), zero)
        flux_freq, _ = weighted_mean(freqs, pfe, dim=-1)
        return tuple(_host(x) for x in (pf, pfe, flux, flux_err, flux_freq))

    # -- the wideband pipeline -----------------------------------------
    def get_TOAs(self, datafile=None, tscrunch=False, nu_refs=None,
                 DM0=None, bary=True, fit_DM=True, fit_GM=False,
                 fit_scat=False, log10_tau=True, scat_guess=None,
                 fix_alpha=False, print_phase=False, print_flux=False,
                 print_parangle=False, add_instrumental_response=False,
                 addtnl_toa_flags=None, method="trust-ncg", bounds=None,
                 nu_fits=None, show_plot=False, quiet=None,
                 max_iter=50, checkpoint=None, nonfinite_max_frac=0.5):
        """Measure wideband TOAs; results accumulate on self
        (reference-named).  Equivalent of pptoas.py:150-738;
        ``method`` is accepted for API parity.

        fit_GM adds a nu**-4 delay (GM) to the fit; fit_scat fits the
        scattering time (log10 of it unless ``log10_tau`` is False) and
        index (held at the model's or ``scat_guess``'s when
        ``fix_alpha``); ``scat_guess`` = (tau [s], reference frequency
        [MHz], alpha); ``nu_refs`` = (nu_ref_DM, nu_ref_tau) output
        reference frequencies (None = zero-covariance ones).
        ``print_flux`` adds flux estimates (``fluxes``, ``flux_errs``,
        ``flux_freqs``, ``profile_fluxes``) and TOA flags.
        ``checkpoint``: a .tim file that each archive's TOAs are appended
        to as soon as it is done; archives already in it are skipped, so a
        killed run resumes where it stopped."""
        if show_plot:
            raise _not_ported("plotting")
        if quiet is None:
            quiet = self.quiet
        self.nfit = 1 + int(fit_DM) + int(fit_GM) + \
            (2 if fit_scat else 0) - int(fit_scat and fix_alpha)
        self.fit_flags = [1, int(fit_DM), int(fit_GM), int(fit_scat),
                          int(fit_scat and not fix_alpha)]
        if not fit_scat:
            log10_tau = False
        self.log10_tau = log10_tau
        self.scat_guess = scat_guess
        self.DM0 = DM0
        self.bary = bary
        self.tscrunch = tscrunch
        self.add_instrumental_response = add_instrumental_response
        nu_ref_tuple = nu_refs
        nu_fit_tuple = nu_fits
        start = time.time()
        dev = self.device

        datafiles = self.datafiles if datafile is None else [datafile]
        done_archives = set()
        if checkpoint is not None and os.path.isfile(checkpoint):
            done_archives = _resume_checkpoint(checkpoint, quiet)
        for iarch, datafile in enumerate(datafiles):
            if os.path.realpath(datafile) in done_archives:
                if not quiet:
                    print(f"{datafile} already in checkpoint "
                          f"{checkpoint}; skipping it.")
                continue
            n_toa0 = len(self.TOA_list)
            d = load_archive_data(datafile, tscrunch, quiet)
            if d is None:
                continue
            nsub, nchan, nbin = d.nsub, d.nchan, d.nbin
            fit_start = time.time()
            DM_stored = d.DM
            DM0_arch = DM_stored if self.DM0 is None else self.DM0
            batch = self._checked_batch(d, datafile, nonfinite_max_frac,
                                        quiet)
            if batch is None:
                continue
            ok, ports, freqs_b, weights_b, errs_b, SNRs_b, Ps_b, bad_chan, \
                n_zap = batch
            if n_zap:
                SNRs_b = np.where(bad_chan, 0.0, SNRs_b)
            wok = (weights_b > 0.0).astype(np.float64)
            if n_zap:
                keep = wok.sum(-1) > 0
                if not keep.all():  # subints with no live channel left
                    ok, ports, freqs_b, weights_b, errs_b, SNRs_b, \
                        Ps_b, wok = (a[keep] for a in (
                            ok, ports, freqs_b, weights_b, errs_b,
                            SNRs_b, Ps_b, wok))
                    if len(ok) == 0:
                        self.poisoned_datafiles.append(
                            (datafile, "non-finite data: every subint "
                                       "lost all live channels"))
                        continue
            B = len(ok)

            models, same_freqs = self._prepare_models(
                d, ports.shape, freqs_b, Ps_b, fit_scat,
                add_instrumental_response, datafile)
            if models is None:
                continue
            self.ok_idatafiles.append(iarch)

            # reference frequencies for fit and output
            nu_means = (freqs_b * wok).sum(-1) / wok.sum(-1)
            if nu_fit_tuple is None:
                nu_fit = np.array([
                    float(guess_fit_freq(freqs_b[i][wok[i] > 0],
                                         SNRs_b[i][wok[i] > 0]))
                    for i in range(B)])
                nu_fits_b = np.stack([nu_fit, nu_fit, nu_fit], axis=1)
            else:
                nu_fits_b = np.tile([nu_fit_tuple[0], nu_fit_tuple[0],
                                     nu_fit_tuple[-1]], (B, 1))
            if nu_ref_tuple is None:
                nu_outs_b = None
            else:
                nu_ref_DM = nu_ref_tuple[0]
                nu_ref_tau = nu_ref_tuple[-1]
                # bary: the requested (barycentric) tau reference maps to
                # a per-subint topocentric one (pptoas.py:410-415)
                if bary and nu_ref_tau:
                    taus_ref = nu_ref_tau / d.doppler_factors[ok]
                else:
                    taus_ref = np.full(B, np.nan if nu_ref_tau is None
                                       else nu_ref_tau)
                col = np.full(B, np.nan if nu_ref_DM is None else nu_ref_DM)
                nu_outs_b = (None if nu_ref_DM is None else col,
                             None if nu_ref_DM is None else col,
                             None if nu_ref_tau is None else taus_ref)

            # -- initial guesses (batched, on the device) ---------------
            # the data go to the device once; the fits below index them
            ports_dev = torch.as_tensor(ports).to(dev)
            wok_dev = torch.as_tensor(wok).to(dev)
            wsum = wok_dev.sum(-1)[:, None]
            DM_guess = DM_stored
            rot_ports = rotate_data(ports_dev, 0.0, DM_guess, Ps_b, freqs_b,
                                    nu_means[:, None])
            # weighted band-average profiles
            rot_profs = (rot_ports * wok_dev[..., None]).sum(1) / wsum
            del rot_ports
            # (a product: no [B, nchan, nbin] copy of a shared model)
            model_profs = (wok_dev @ models if same_freqs else torch.matmul(
                wok_dev[:, None, :], models)[:, 0]) / wsum
            tau_guess = np.zeros(B)
            alpha_guess = np.zeros(B)
            if fit_scat:
                if self.scat_guess is not None:
                    tg_s, tg_ref, ag = self.scat_guess
                    tau_guess[:] = (tg_s / Ps_b) * \
                        (nu_fits_b[:, 2] / tg_ref) ** ag
                    alpha_guess[:] = ag
                else:
                    alpha_guess[:] = getattr(self, "alpha", scattering_alpha)
                    if hasattr(self, "gparams"):
                        tau_guess[:] = (self.gparams[1] / Ps_b) * \
                            (nu_fits_b[:, 2] / self.model_nu_ref) \
                            ** alpha_guess
                # scatter the model mean profile for the phase guess
                nu_tau = torch.as_tensor(nu_fits_b[:, 2]).to(dev)
                model_profs = _scatter(model_profs, scattering_times(
                    torch.as_tensor(tau_guess).to(dev),
                    torch.as_tensor(alpha_guess).to(dev), nu_tau, nu_tau))
                if log10_tau:
                    tau_guess = np.log10(np.where(tau_guess == 0.0,
                                                  1.0 / nbin, tau_guess))
            guess = fit_phase_shift(rot_profs, model_profs,
                                    noise=np.median(errs_b, axis=-1),
                                    Ns=100, device=dev)
            phi_guess = np.asarray(phase_transform(
                _host(guess.phase), DM_guess, nu_means, nu_fits_b[:, 0],
                Ps_b, mod=True))
            init = np.stack([phi_guess, np.full(B, DM_guess), np.zeros(B),
                             tau_guess, alpha_guess], axis=1)

            if bounds is None:
                tau_lo = np.log10(1.0 / (10 * nbin)) if log10_tau else 0.0
                bounds_eff = [(None, None), (None, None), (None, None),
                              (tau_lo, None), (-10.0, 10.0)] \
                    if fit_scat else None
            else:
                bounds_eff = bounds

            # -- degraded modes: group subints by effective fit flags ---
            nchanx = wok.sum(-1).astype(int)
            flags_groups = {}
            flags_used = [None] * B
            for i in range(B):
                if nchanx[i] == 1:
                    fl = (1, 0, 0, 0, 0)
                elif nchanx[i] == 2 and fit_DM and fit_GM:
                    fl = (1, 1, 0, self.fit_flags[3], self.fit_flags[4])
                else:
                    fl = tuple(self.fit_flags)
                flags_used[i] = fl
                flags_groups.setdefault(fl, []).append(i)

            results = [None] * B
            for fl, idxs in flags_groups.items():
                sel = np.asarray(idxs)
                sel_dev = torch.as_tensor(sel, device=dev)
                out = fit_portrait_full_batch(
                    ports_dev[sel_dev],
                    models if same_freqs else models[sel_dev],
                    init[sel], Ps_b[sel], freqs_b[sel], errs=errs_b[sel],
                    weights=weights_b[sel], fit_flags=fl,
                    nu_fits=nu_fits_b[sel],
                    nu_outs=None if nu_outs_b is None else tuple(
                        None if col is None else col[sel]
                        for col in nu_outs_b),
                    bounds=bounds_eff, log10_tau=log10_tau,
                    max_iter=max_iter, device=dev)
                out = {key: _host(val) for key, val in out.items()}
                for j, i in enumerate(idxs):
                    results[i] = {key: val[j] for key, val in out.items()}
            fit_duration = time.time() - fit_start

            # -- assemble per-archive outputs ---------------------------
            nu_refs_arr = np.zeros([nsub, 3])
            nu_fits_arr = np.zeros([nsub, 3])
            phis = np.zeros(nsub)
            phi_errs = np.zeros(nsub)
            TOAs_arr = np.zeros(nsub, dtype=object)
            TOA_errs_arr = np.zeros(nsub, dtype=object)
            DMs = np.zeros(nsub)
            DM_errs = np.zeros(nsub)
            GMs = np.zeros(nsub)
            GM_errs = np.zeros(nsub)
            taus_a = np.zeros(nsub)
            tau_errs = np.zeros(nsub)
            alphas = np.zeros(nsub)
            alpha_errs = np.zeros(nsub)
            scales_a = np.zeros([nsub, nchan])
            scale_errs_a = np.zeros([nsub, nchan])
            snrs = np.zeros(nsub)
            channel_snrs = np.zeros([nsub, nchan])
            profile_fluxes = np.zeros([nsub, nchan])
            profile_flux_errs = np.zeros([nsub, nchan])
            fluxes = np.zeros(nsub)
            flux_errs = np.zeros(nsub)
            flux_freqs = np.zeros(nsub)
            red_chi2s = np.zeros(nsub)
            covariances = np.zeros([nsub, 5, 5])
            nfevals = np.zeros(nsub, dtype=int)
            rcs = np.zeros(nsub, dtype=int)
            MJDs = np.array([d.epochs[isub].mjd() for isub in range(nsub)])

            if print_flux:
                def stacked(key):
                    return np.stack([np.asarray(r[key]) for r in results])

                taus_flux = None
                tau_lin = stacked("tau")
                if log10_tau:
                    tau_lin = 10 ** tau_lin
                # a subint whose tau is 0 keeps its template unscattered
                scat_rows = (tau_lin != 0.0) & fit_scat
                if scat_rows.any():
                    taus_flux = scattering_times(
                        torch.as_tensor(tau_lin)[:, None],
                        torch.as_tensor(stacked("alpha"))[:, None],
                        torch.as_tensor(freqs_b),
                        torch.as_tensor(stacked("nu_tau"))[:, None])
                pf_b, pfe_b, flux_b, flux_err_b, flux_freq_b = self._fluxes(
                    models, freqs_b, wok, stacked("scales"),
                    stacked("scale_errs"), taus_flux, scat_rows)
                profile_fluxes[ok] = pf_b
                profile_flux_errs[ok] = pfe_b
                fluxes[ok] = flux_b
                flux_errs[ok] = flux_err_b
                flux_freqs[ok] = flux_freq_b

            for j, isub in enumerate(ok):
                r = results[j]
                P = float(Ps_b[j])
                epoch = d.epochs[isub]
                TOA_epoch = epoch.add_seconds(
                    float(r["phi"]) * P + d.backend_delay)
                TOA_err_us = float(r["phi_err"]) * P * 1e6
                DM_fit = float(r["DM"])
                GM_fit = float(r["GM"])
                df = float(d.doppler_factors[isub]) if bary else 1.0
                fl = list(flags_used[j])
                if bary:
                    if fl[1]:
                        DM_fit *= df  # barycentric DM
                    if fl[2]:
                        GM_fit *= df ** 3

                nu_refs_arr[isub] = [float(r["nu_DM"]), float(r["nu_GM"]),
                                     float(r["nu_tau"])]
                nu_fits_arr[isub] = nu_fits_b[j]
                phis[isub] = float(r["phi"])
                phi_errs[isub] = float(r["phi_err"])
                TOAs_arr[isub] = TOA_epoch
                TOA_errs_arr[isub] = TOA_err_us
                DMs[isub] = DM_fit
                DM_errs[isub] = float(r["DM_err"])
                GMs[isub] = GM_fit
                GM_errs[isub] = float(r["GM_err"])
                taus_a[isub] = float(r["tau"])
                tau_errs[isub] = float(r["tau_err"])
                alphas[isub] = float(r["alpha"])
                alpha_errs[isub] = float(r["alpha_err"])
                okc = wok[j] > 0
                scales_a[isub][okc] = np.asarray(r["scales"])[okc]
                scale_errs_a[isub][okc] = np.asarray(r["scale_errs"])[okc]
                snrs[isub] = float(r["snr"])
                channel_snrs[isub][okc] = np.asarray(
                    r["channel_snrs"])[okc]
                cov = np.asarray(r["covariance_matrix"])
                ifit = np.flatnonzero(fl)
                covariances[isub][np.ix_(ifit, ifit)] = \
                    cov[:len(ifit)][:, :len(ifit)]
                red_chi2s[isub] = float(r["red_chi2"])
                nfevals[isub] = int(r["nfeval"])
                rcs[isub] = int(r["return_code"])

                toa_flags = {}
                DM_out, DM_err_out = DM_fit, float(r["DM_err"])
                if not fl[1]:
                    DM_out = DM_err_out = None
                if fl[2]:
                    toa_flags["gm"] = GM_fit
                    toa_flags["gm_err"] = float(r["GM_err"])
                if fl[3]:
                    if log10_tau:
                        toa_flags["scat_time"] = \
                            10 ** float(r["tau"]) * P / df * 1e6
                        toa_flags["log10_scat_time"] = float(r["tau"]) + \
                            np.log10(P / df)
                        toa_flags["log10_scat_time_err"] = \
                            float(r["tau_err"])
                    else:
                        toa_flags["scat_time"] = \
                            float(r["tau"]) * P / df * 1e6
                        toa_flags["scat_time_err"] = \
                            float(r["tau_err"]) * P / df * 1e6
                    toa_flags["scat_ref_freq"] = float(r["nu_tau"]) * df
                    toa_flags["scat_ind"] = float(r["alpha"])
                if fl[4]:
                    toa_flags["scat_ind_err"] = float(r["alpha_err"])
                freqsx = freqs_b[j][okc]
                toa_flags.update(
                    be=d.backend, fe=d.frontend,
                    f=f"{d.frontend}_{d.backend}", nbin=nbin, nch=nchan,
                    nchx=int(nchanx[j]),
                    bw=float(freqsx.max() - freqsx.min()),
                    chbw=abs(d.bw) / nchan, subint=int(isub),
                    tobs=float(d.subtimes[isub]),
                    fratio=float(freqsx.max() / freqsx.min()),
                    tmplt=self.modelfile, snr=float(r["snr"]))
                if nu_ref_tuple is not None and fl[0] and fl[1]:
                    toa_flags["phi_DM_cov"] = float(cov[0, 1])
                if bary and getattr(d, "doppler_degraded", False):
                    # the unity-Doppler fallback made the requested
                    # barycentric quantities topocentric
                    toa_flags["pp_topo"] = 1
                toa_flags["gof"] = float(r["red_chi2"])
                if print_phase:
                    toa_flags["phs"] = float(r["phi"])
                    toa_flags["phs_err"] = float(r["phi_err"])
                if print_flux:
                    toa_flags["flux"] = fluxes[isub]
                    toa_flags["flux_err"] = flux_errs[isub]
                    toa_flags["flux_ref_freq"] = flux_freqs[isub]
                if print_parangle:
                    toa_flags["par_angle"] = \
                        float(d.parallactic_angles[isub])
                toa_flags.update(addtnl_toa_flags or {})
                self.TOA_list.append(TOA(
                    datafile, float(r["nu_DM"]), TOA_epoch, TOA_err_us,
                    d.telescope, d.telescope_code, DM_out, DM_err_out,
                    toa_flags))

            # per-archive weighted DeltaDM with red-chi2 error inflation
            DeltaDMs = DMs[ok] - DM0_arch
            dm_errs_ok = DM_errs[ok]
            if np.all(dm_errs_ok):
                DM_weights = dm_errs_ok ** -2
            else:
                DM_weights = np.ones(len(dm_errs_ok))
            DeltaDM_mean = np.average(DeltaDMs, weights=DM_weights)
            DeltaDM_var = 1.0 / DM_weights.sum()
            if len(ok) > 1:
                DeltaDM_var *= np.sum(
                    (DeltaDMs - DeltaDM_mean) ** 2 * DM_weights) / \
                    (len(DeltaDMs) - 1)
            self.order.append(datafile)
            self.obs.append(DataBunch(telescope=d.telescope,
                                      backend=d.backend,
                                      frontend=d.frontend))
            self.doppler_fs.append(d.doppler_factors)
            self.nu0s.append(d.nu0)
            self.nu_fits.append(nu_fits_arr)
            self.nu_refs.append(nu_refs_arr)
            self.ok_isubs.append(ok)
            self.epochs.append(d.epochs)
            self.MJDs.append(MJDs)
            self.Ps.append(d.Ps)
            self.phis.append(phis)
            self.phi_errs.append(phi_errs)
            self.TOAs.append(TOAs_arr)
            self.TOA_errs.append(TOA_errs_arr)
            self.DM0s.append(DM0_arch)
            self.DMs.append(DMs)
            self.DM_errs.append(DM_errs)
            self.DeltaDM_means.append(DeltaDM_mean)
            self.DeltaDM_errs.append(DeltaDM_var ** 0.5)
            self.GMs.append(GMs)
            self.GM_errs.append(GM_errs)
            self.taus.append(taus_a)
            self.tau_errs.append(tau_errs)
            self.alphas.append(alphas)
            self.alpha_errs.append(alpha_errs)
            self.scales.append(scales_a)
            self.scale_errs.append(scale_errs_a)
            self.snrs.append(snrs)
            self.channel_snrs.append(channel_snrs)
            self.profile_fluxes.append(profile_fluxes)
            self.profile_flux_errs.append(profile_flux_errs)
            self.fluxes.append(fluxes)
            self.flux_errs.append(flux_errs)
            self.flux_freqs.append(flux_freqs)
            self.covariances.append(covariances)
            self.red_chi2s.append(red_chi2s)
            self.nfevals.append(nfevals)
            self.rcs.append(rcs)
            self.fit_durations.append(fit_duration)
            self.n_nonfinite_zapped.append(n_zap)
            if checkpoint is not None:
                # block + marker in one append; only this call's TOAs
                _append_checkpoint(checkpoint, self.TOA_list[n_toa0:],
                                   datafile)
            if not quiet:
                print("--------------------------")
                print(datafile)
                print("~%.4f sec/TOA" % (fit_duration / len(ok)))
                print("Med. TOA error is %.3f us"
                      % np.median(phi_errs[ok] * d.Ps.mean() * 1e6))
        if not quiet and len(self.ok_isubs):
            tot = time.time() - start
            ntoa = sum(len(o) for o in self.ok_isubs)
            print("--------------------------")
            print("Total time: %.2f sec, ~%.4f sec/TOA"
                  % (tot, tot / max(ntoa, 1)))

    # -- narrowband (per-channel) TOAs ----------------------------------
    def get_narrowband_TOAs(self, datafile=None, tscrunch=False,
                            fit_scat=False, log10_tau=True,
                            scat_guess=None, print_phase=False,
                            print_flux=False, print_parangle=False,
                            add_instrumental_response=False,
                            addtnl_toa_flags=None, method="trust-ncg",
                            bounds=None, show_plot=False, quiet=None,
                            max_iter=50, checkpoint=None,
                            nonfinite_max_frac=0.5):
        """Measure per-channel (narrowband) TOAs (reference
        pptoas.py:740-1125).  Every live (subint, channel) profile of an
        archive is fit in one FFTFIT call (kernel K2) with the phase
        ``bounds[0]`` (default (-0.5, 0.5)).

        fit_scat=True fits each channel's scattering time with its phase:
        every channel is a one-channel portrait through the portrait fit
        (kernel K3) with flags (phi, tau), from per-channel tau guesses
        and an FFTFIT phase guess against the scattered model; alpha and
        DM stay fixed.  ``checkpoint``: the crash-resume .tim protocol of
        :meth:`get_TOAs`."""
        if show_plot:
            raise _not_ported("plotting")
        if quiet is None:
            quiet = self.quiet
        self.nfit = 1 + 2 * int(fit_scat)
        self.fit_phi = True
        self.fit_tau = fit_scat
        self.fit_flags = [1, int(fit_scat)]
        if not fit_scat:
            log10_tau = False
        self.log10_tau = log10_tau
        self.scat_guess = scat_guess
        self.tscrunch = tscrunch
        self.add_instrumental_response = add_instrumental_response
        start = time.time()

        datafiles = self.datafiles if datafile is None else [datafile]
        done_archives = set()
        if checkpoint is not None and os.path.isfile(checkpoint):
            done_archives = _resume_checkpoint(checkpoint, quiet)
        for iarch, datafile in enumerate(datafiles):
            if os.path.realpath(datafile) in done_archives:
                if not quiet:
                    print(f"{datafile} already in checkpoint "
                          f"{checkpoint}; skipping it.")
                continue
            n_toa0 = len(self.TOA_list)
            d = load_archive_data(datafile, tscrunch, quiet)
            if d is None:
                continue
            nsub, nchan = d.nsub, d.nchan
            fit_start = time.time()
            batch = self._checked_batch(d, datafile, nonfinite_max_frac,
                                        quiet)
            if batch is None:
                continue
            ok, ports, freqs_b, weights_b, errs_b, _, Ps_b, _, n_zap = batch
            wok = (weights_b > 0.0).astype(np.float64)

            models, same_freqs = self._prepare_models(
                d, ports.shape, freqs_b, Ps_b, fit_scat,
                add_instrumental_response, datafile)
            if models is None:
                continue
            # flatten live (subint, channel) pairs into one fit batch
            jj, cc = np.nonzero(wok)                      # [M], [M]
            if len(jj) == 0:  # the guard zapped every live channel
                self.poisoned_datafiles.append(
                    (datafile, "non-finite data: every live channel "
                               "zapped"))
                continue
            self.ok_idatafiles.append(iarch)
            fit = self._narrowband_fit(ports, models, same_freqs, jj, cc,
                                       errs_b, freqs_b, Ps_b, d.DM,
                                       fit_scat, log10_tau, bounds,
                                       max_iter, print_flux)
            fit_duration = time.time() - fit_start
            fit.update(sub_idx=ok[jj], cc=cc, nusx=freqs_b[jj, cc],
                       Psx=Ps_b[jj])
            arrays = self._narrowband_arrays(fit, nsub, nchan, fit_scat)
            self._narrowband_toas(d, datafile, fit, arrays, fit_scat,
                                  log10_tau, print_phase, print_flux,
                                  print_parangle, addtnl_toa_flags)

            self.order.append(datafile)
            self.obs.append(DataBunch(telescope=d.telescope,
                                      backend=d.backend,
                                      frontend=d.frontend))
            self.doppler_fs.append(d.doppler_factors)
            self.ok_isubs.append(ok)
            self.epochs.append(d.epochs)
            self.MJDs.append(np.array([d.epochs[isub].mjd()
                                       for isub in range(nsub)]))
            self.Ps.append(d.Ps)
            for attr in ("phis", "phi_errs", "TOAs", "TOA_errs", "taus",
                         "tau_errs", "scales", "scale_errs", "channel_snrs",
                         "profile_fluxes", "profile_flux_errs",
                         "covariances", "nfevals", "rcs"):
                getattr(self, attr).append(arrays[attr])
            if not hasattr(self, "channel_red_chi2s"):
                self.channel_red_chi2s = []
            self.channel_red_chi2s.append(arrays["channel_red_chi2s"])
            self.fit_durations.append(fit_duration)
            self.n_nonfinite_zapped.append(n_zap)
            if checkpoint is not None:
                _append_checkpoint(checkpoint, self.TOA_list[n_toa0:],
                                   datafile)
            if not quiet:
                M = len(jj)
                print("--------------------------")
                print(datafile)
                print("~%.4f sec/TOA" % (fit_duration / max(M, 1)))
                print("Med. TOA error is %.3f us"
                      % np.median(fit["phi_errs"] * fit["Psx"] * 1e6))
        if not quiet and len(self.ok_isubs):
            tot = time.time() - start
            print("--------------------------")
            print("Total time: %.2f sec, ~%.4f sec/TOA"
                  % (tot, tot / max(len(self.TOA_list), 1)))

    def _narrowband_fit(self, ports, models, same_freqs, jj, cc, errs_b,
                        freqs_b, Ps_b, DM, fit_scat, log10_tau, bounds,
                        max_iter, print_flux):
        """Fit the live (subint, channel) profiles ``ports[jj, cc]``, on
        the device: the data and the model rows are gathered there
        (``models[cc]``; no host copy of the broadcast model).  Returns a
        dict of host arrays [M] (phis, phi_errs, taus, tau_errs, scales,
        scale_errs, snrs, red_chi2s, and for fit_scat covs [M, 2, 2],
        nfevals, rcs; with print_flux the profile fluxes and errors)."""
        dev = self.device
        M = len(jj)
        nbin = ports.shape[-1]
        jj_dev = torch.as_tensor(jj, device=dev)
        cc_dev = torch.as_tensor(cc, device=dev)
        profs = torch.as_tensor(ports).to(dev)[jj_dev, cc_dev]   # [M, nbin]
        mods = models[cc_dev] if same_freqs else models[jj_dev, cc_dev]
        errsx = errs_b[jj, cc]
        nusx = freqs_b[jj, cc]
        Psx = Ps_b[jj]
        out = dict(taus=np.zeros(M), tau_errs=np.zeros(M))
        # caller bounds follow the reference's [(phi), (tau)] contract
        phi_bounds = (-0.5, 0.5)
        if bounds is not None and bounds[0] is not None \
                and None not in bounds[0]:
            phi_bounds = tuple(bounds[0])
        if not fit_scat:
            r = fit_phase_shift(profs, mods, noise=errsx, bounds=phi_bounds,
                                Ns=100, device=dev)
            out.update(phis=r.phase, phi_errs=r.phase_err, scales=r.scale,
                       scale_errs=r.scale_err, snrs=r.snr,
                       red_chi2s=r.red_chi2)
        else:
            # per-channel tau guess at each channel's frequency
            alpha_guess = getattr(self, "alpha", scattering_alpha)
            if self.scat_guess is not None:
                tg_s, tg_ref, alpha_guess = self.scat_guess
                tau_g = (tg_s / Psx) * (nusx / tg_ref) ** alpha_guess
            elif hasattr(self, "gparams"):
                tau_g = (self.gparams[1] / Psx) * \
                    (nusx / self.model_nu_ref) ** alpha_guess
            else:
                tau_g = np.zeros(M)
            # phase guess against the scattered model
            nus_dev = torch.as_tensor(nusx).to(dev)
            mods_scat = _scatter(mods, scattering_times(
                torch.as_tensor(tau_g).to(dev), alpha_guess, nus_dev,
                nus_dev))
            guess = fit_phase_shift(profs, mods_scat, noise=errsx, Ns=100,
                                    device=dev)
            del mods_scat
            if log10_tau:
                tau_g = np.log10(np.where(tau_g == 0.0, 1.0 / nbin, tau_g))
            init = np.stack([_host(guess.phase), np.full(M, DM),
                             np.zeros(M), tau_g, np.full(M, alpha_guess)],
                            axis=1)
            if bounds is None:
                tau_lo = np.log10(1.0 / (10 * nbin)) if log10_tau else 0.0
                bounds_eff = [(None, None), (None, None), (None, None),
                              (tau_lo, None), (-10.0, 10.0)]
            else:
                bounds_eff = [tuple(bounds[0]), (None, None), (None, None),
                              tuple(bounds[1]), (-10.0, 10.0)]
            r = fit_portrait_full_batch(
                profs[:, None, :], mods[:, None, :], init, Psx,
                nusx[:, None], errs=errsx[:, None], fit_flags=(1, 0, 0, 1, 0),
                nu_fits=np.stack([nusx] * 3, axis=1), bounds=bounds_eff,
                log10_tau=log10_tau, max_iter=max_iter, device=dev)
            out.update(phis=r.phi, phi_errs=r.phi_err, taus=r.tau,
                       tau_errs=r.tau_err, scales=r.scales[:, 0],
                       scale_errs=r.scale_errs[:, 0], snrs=r.snr,
                       red_chi2s=r.red_chi2,
                       covs=r.covariance_matrix[:, :2, :2],
                       nfevals=r.nfeval, rcs=r.return_code)
        if print_flux:
            # per-channel flux of the (scattered) scaled template
            taus_flux = None
            if fit_scat:
                tau_lin = 10 ** out["taus"] if log10_tau else out["taus"]
                nus_dev = torch.as_tensor(nusx).to(dev)
                taus_flux = scattering_times(tau_lin, scattering_alpha,
                                             nus_dev, nus_dev)
            means = (mods if taus_flux is None else
                     _scatter(mods, taus_flux)).mean(dim=-1)
            out.update(profile_fluxes=means * out["scales"],
                       profile_flux_errs=torch.abs(means)
                       * out["scale_errs"])
        return {key: _host(val) for key, val in out.items()}

    @staticmethod
    def _narrowband_arrays(fit, nsub, nchan, fit_scat):
        """The per-archive [nsub, nchan] result arrays of a narrowband
        fit (reference-named), TOAs and TOA errors left empty."""
        sub_idx, cc = fit["sub_idx"], fit["cc"]
        nfit = 1 + 2 * int(fit_scat)
        arrays = dict(
            TOAs=np.zeros([nsub, nchan], dtype=object),
            TOA_errs=np.zeros([nsub, nchan], dtype=object),
            covariances=np.zeros([nsub, nchan, nfit, nfit]),
            nfevals=np.zeros([nsub, nchan], dtype=int),
            rcs=np.zeros([nsub, nchan], dtype=int))
        for attr, key in (("phis", "phis"), ("phi_errs", "phi_errs"),
                          ("taus", "taus"), ("tau_errs", "tau_errs"),
                          ("scales", "scales"), ("scale_errs", "scale_errs"),
                          ("channel_snrs", "snrs"),
                          ("profile_fluxes", "profile_fluxes"),
                          ("profile_flux_errs", "profile_flux_errs"),
                          ("channel_red_chi2s", "red_chi2s")):
            arrays[attr] = np.zeros([nsub, nchan])
            if key in fit:
                arrays[attr][sub_idx, cc] = fit[key]
        if fit_scat:
            # the (phi, tau) block of the fit's [nfit, nfit] covariance
            arrays["covariances"][sub_idx, cc, :2, :2] = fit["covs"]
            arrays["nfevals"][sub_idx, cc] = fit["nfevals"]
            arrays["rcs"][sub_idx, cc] = fit["rcs"]
        return arrays

    def _narrowband_toas(self, d, datafile, fit, arrays, fit_scat,
                         log10_tau, print_phase, print_flux, print_parangle,
                         addtnl_toa_flags):
        """One TOA per fitted (subint, channel), appended to TOA_list; the
        TOA epochs and errors also go into ``arrays``."""
        nbin, nchan = d.nbin, d.nchan
        for m in range(len(fit["cc"])):
            isub = int(fit["sub_idx"][m])
            ichan = int(fit["cc"][m])
            P = float(fit["Psx"][m])
            TOA_epoch = d.epochs[isub].add_seconds(
                float(fit["phis"][m]) * P + d.backend_delay)
            TOA_err_us = float(fit["phi_errs"][m]) * P * 1e6
            arrays["TOAs"][isub, ichan] = TOA_epoch
            arrays["TOA_errs"][isub, ichan] = TOA_err_us

            toa_flags = {}
            if fit_scat:
                df = float(d.doppler_factors[isub])
                tau, tau_err = float(fit["taus"][m]), \
                    float(fit["tau_errs"][m])
                if log10_tau:
                    toa_flags["scat_time"] = 10 ** tau * P / df * 1e6
                    toa_flags["log10_scat_time"] = tau + np.log10(P / df)
                    toa_flags["log10_scat_time_err"] = tau_err
                else:
                    toa_flags["scat_time"] = tau * P / df * 1e6
                    toa_flags["scat_time_err"] = tau_err * P / df * 1e6
                toa_flags["phi_tau_cov"] = \
                    float(arrays["covariances"][isub, ichan, 0, 1])
                if getattr(d, "doppler_degraded", False):
                    toa_flags["pp_topo"] = 1  # unity-Doppler fallback
            toa_flags.update(
                be=d.backend, fe=d.frontend,
                f=f"{d.frontend}_{d.backend}", nbin=nbin,
                bw=abs(d.bw) / nchan, subint=isub, chan=ichan,
                tobs=float(d.subtimes[isub]), tmplt=self.modelfile,
                snr=float(fit["snrs"][m]),
                gof=float(fit["red_chi2s"][m]))
            if print_phase:
                toa_flags["phs"] = float(fit["phis"][m])
                toa_flags["phs_err"] = float(fit["phi_errs"][m])
            if print_flux:
                toa_flags["flux"] = float(arrays["profile_fluxes"][isub,
                                                                  ichan])
                toa_flags["flux_err"] = \
                    float(arrays["profile_flux_errs"][isub, ichan])
            if print_parangle:
                toa_flags["par_angle"] = float(d.parallactic_angles[isub])
            toa_flags.update(addtnl_toa_flags or {})
            self.TOA_list.append(TOA(
                datafile, float(fit["nusx"][m]), TOA_epoch, TOA_err_us,
                d.telescope, d.telescope_code, None, None, toa_flags))

    def write_TOAs(self, outfile=None, nu_ref=None, format="tempo2",
                   SNR_cutoff=0.0, append=True):
        """Write the accumulated TOA_list to a .tim file."""
        write_TOAs(self.TOA_list, SNR_cutoff=SNR_cutoff, outfile=outfile,
                   append=append)

    def write_princeton_TOAs(self, outfile=None, one_DM=False,
                             dmerrfile=None):
        """Write the accumulated TOAs in Princeton/tempo format, with the
        dDM column from the per-subint fit (or the per-archive mean when
        ``one_DM``); ``dmerrfile`` appends the matching DM errors."""
        from ..io.timfile import write_princeton_TOA

        dm_err_lines = []
        for toa in self.TOA_list:
            ifile = self.order.index(toa.archive)
            DM0 = self.DM0s[ifile] if ifile < len(self.DM0s) else 0.0
            if one_DM and ifile < len(self.DeltaDM_means):
                dDM = float(self.DeltaDM_means[ifile])
                dDM_err = float(self.DeltaDM_errs[ifile])
            elif toa.DM is not None:
                dDM = float(toa.DM) - DM0
                dDM_err = float(toa.DM_error)
            else:  # narrowband TOAs carry no DM measurement
                dDM = dDM_err = 0.0
            write_princeton_TOA(toa.MJD.intday(), toa.MJD.fracday(),
                                toa.TOA_error, toa.frequency, dDM,
                                obs=toa.telescope_code, outfile=outfile)
            dm_err_lines.append("%.5e" % dDM_err)
        if dmerrfile is not None:
            with open(dmerrfile, "a") as f:
                f.write("\n".join(dm_err_lines) + "\n")

    # -- post-fit channel zapping (reference pptoas.py:1201-1278) -------
    def _fitted_subint(self, ifile, isub):
        """(rotated port, scaled model [nchan, nbin] on the device,
        ok_ichans, freqs, noise_stds) of one fitted subint; the archive
        is loaded once and kept in ``_data_cache``."""
        datafile = self.order[ifile]
        if not hasattr(self, "_data_cache"):
            self._data_cache = {}
        if datafile not in self._data_cache:
            self._data_cache[datafile] = _load(datafile, self.tscrunch,
                                               quiet=True)
        d = self._data_cache[datafile]
        dev = self.device
        P = float(d.Ps[isub])
        freqs = d.freqs[isub]
        model = self._build_model(freqs, d.phases, P,
                                  bool(self.fit_flags[3]))
        if self.fit_flags[3]:
            tau = self.taus[ifile][isub]
            tau_lin = 10 ** tau if self.log10_tau else tau
            model = _scatter(model, scattering_times(
                tau_lin, self.alphas[ifile][isub],
                torch.as_tensor(freqs).to(dev),
                self.nu_refs[ifile][isub][2]))
        if self.add_instrumental_response and (self.ird["DM"]
                                               or len(self.ird["wids"])):
            model = _convolve(model, self._instrumental_FT(d.nbin, freqs, P))
        model = torch.as_tensor(self.scales[ifile][isub]).to(dev)[:, None] \
            * model
        df = float(d.doppler_factors[isub]) if self.bary else 1.0
        DM_topo = self.DMs[ifile][isub] / df  # undo the bary correction
        rot_port = rotate_data(torch.as_tensor(d.subints[isub, 0]).to(dev),
                               self.phis[ifile][isub], DM_topo, P, freqs,
                               self.nu_refs[ifile][isub][0])
        return rot_port, model, d.ok_ichans[isub], freqs, \
            d.noise_stds[isub, 0]

    def return_fit(self, ifile, isub):
        """(rotated port, scaled model, ok_ichans, freqs, noise_stds) for
        one fitted subint, as numpy — the return_fit payload of the
        reference's show_fit (pptoas.py:1280-1412)."""
        rot_port, model, ok_ichans, freqs, noise_stds = \
            self._fitted_subint(ifile, isub)
        return _host(rot_port), _host(model), ok_ichans, freqs, noise_stds

    def get_channels_to_zap(self, SNR_threshold=8.0, rchi2_threshold=1.3,
                            iterate=True, show=False):
        """Flag channels for zapping from post-fit per-channel reduced
        chi2 (> rchi2_threshold or NaN) and channel S/N below the
        effective per-channel threshold (SNR_threshold^2/nchx)^0.5,
        iterating the S/N cut to convergence.  Fills
        self.channel_red_chi2s and self.zap_channels, one entry per
        ARCHIVE subint (empty for subints the fit skipped).  Reference
        pptoas.py:1201-1278.  Each subint's reduced chi2s are one
        reduction on the device (dof = nbin - 2 per channel) and one copy
        to the host.  ``show`` is accepted and ignored, as by the JAX
        package."""
        self.channel_red_chi2s = []
        self.zap_channels = []
        for ifile in range(len(self.order)):
            nsub_arch = len(self.Ps[ifile])
            channel_red_chi2s = [[] for _ in range(nsub_arch)]
            zap_channels = [[] for _ in range(nsub_arch)]
            for isub in self.ok_isubs[ifile]:
                port, model, ok_ichans, _, noise_stds = \
                    self._fitted_subint(ifile, isub)
                ichans = torch.as_tensor(ok_ichans, device=port.device)
                errs = torch.as_tensor(noise_stds).to(port.device)[ichans]
                rc2_all = torch.sum(((port[ichans] - model[ichans])
                                     / errs[:, None]) ** 2, dim=-1) \
                    / (port.shape[-1] - 2)
                red_chi2s = [float(x) for x in _host(rc2_all)]
                channel_snrs = self.channel_snrs[ifile][isub]
                thresh = (SNR_threshold ** 2.0 / len(ok_ichans)) ** 0.5
                bad_ichans = []
                for ok_ichan, rc2 in zip(ok_ichans, red_chi2s):
                    if rc2 > rchi2_threshold or np.isnan(rc2):
                        bad_ichans.append(ok_ichan)
                    elif SNR_threshold and \
                            channel_snrs[ok_ichan] < thresh:
                        bad_ichans.append(ok_ichan)
                if iterate and SNR_threshold and len(bad_ichans):
                    old_len = len(bad_ichans)
                    added_new = True
                    while added_new and (len(ok_ichans) - len(bad_ichans)):
                        thresh = (SNR_threshold ** 2.0 /
                                  (len(ok_ichans) - len(bad_ichans))) ** 0.5
                        for ok_ichan in ok_ichans:
                            if ok_ichan in bad_ichans:
                                continue
                            if channel_snrs[ok_ichan] < thresh:
                                bad_ichans.append(ok_ichan)
                        added_new = bool(len(bad_ichans) - old_len)
                        old_len = len(bad_ichans)
                channel_red_chi2s[int(isub)] = red_chi2s
                zap_channels[int(isub)] = bad_ichans
            self.channel_red_chi2s.append(channel_red_chi2s)
            self.zap_channels.append(zap_channels)
        return self.zap_channels
