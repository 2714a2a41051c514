"""Wideband TOA measurement pipeline (pptoas equivalent).

Port of the JAX package's ``pipelines/toas.py`` (reference
pptoas.py:75-738) for wideband TOAs from .gmodel templates, with DM, GM
(nu**-4) and scattering (tau, alpha) fits: per archive, every subint is
fit in one batched call per fit-flag group on the pipeline's device —
the FFTFIT phase guesses through kernel K2, the portrait fits through
kernel K1 (B = 1) or K3 (scattering) — with zapped channels handled as
dense weight masks.  Result attributes keep the reference's names and
per-archive list structure.

Not ported yet: narrowband TOAs, spline/FITS templates, instrumental
responses, flux estimates, plots, and the JAX package's observability,
fault-injection, prefetch and checkpoint hooks.  Device errors are not
caught per archive: a kernel fault surfaces.
"""

import time

import numpy as np
import torch

from ..config import resolve_device, scattering_alpha
from ..fit.phase_shift import fit_phase_shift
from ..fit.portrait import fit_portrait_full_batch
from ..fit.transforms import guess_fit_freq, phase_transform
from ..io.archive import file_is_type, load_data, parse_metafile
from ..io.gmodel import read_model
from ..io.timfile import TOA, write_TOAs
from ..ops.fourier import rotate_data
from ..ops.profiles import gen_gaussian_portrait
from ..ops.scattering import scattering_portrait_FT, scattering_times
from ..utils.databunch import DataBunch

__all__ = ["GetTOAs", "load_archive_data"]


def _not_ported(what):
    return NotImplementedError(
        "%s is not yet ported to pulseportraiture_tpu_torch." % what)


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


def load_archive_data(datafile, tscrunch=False, quiet=True):
    """load_data with the reference's dmc-reload (pptoas.py:216-233);
    returns the DataBunch, or None when the archive cannot be used."""
    try:
        data = load_data(datafile, dedisperse=False,
                         dededisperse=False, tscrunch=tscrunch,
                         pscrunch=True, rm_baseline=True,
                         refresh_arch=False, return_arch=False,
                         quiet=quiet)
        if data.dmc:
            data = load_data(datafile, dedisperse=False,
                             dededisperse=True, tscrunch=tscrunch,
                             pscrunch=True, rm_baseline=True,
                             refresh_arch=False, return_arch=False,
                             quiet=quiet)
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


class GetTOAs:
    """Measure wideband TOAs/DMs from archives with a .gmodel template.

    datafiles: archive path, list of paths, or metafile; modelfile: a
    .gmodel file; device: where the fits run (None = the CUDA device;
    raises when there is none — pass "cpu" to run on the CPU).  API and
    result attributes follow pptoas.py:75-148.
    """

    RESULT_ATTRS = (
        "order", "obs", "doppler_fs", "nu0s", "nu_fits",
        "nu_refs", "ok_idatafiles", "ok_isubs", "epochs",
        "MJDs", "Ps", "phis", "phi_errs", "TOAs", "TOA_errs",
        "DM0s", "DMs", "DM_errs", "DeltaDM_means",
        "DeltaDM_errs", "GMs", "GM_errs", "taus", "tau_errs",
        "alphas", "alpha_errs", "scales", "scale_errs",
        "snrs", "channel_snrs", "covariances", "red_chi2s", "nfevals",
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
        if file_is_type(modelfile) != "ASCII":
            raise _not_ported("spline and FITS-archive templates "
                              "(only .gmodel files)")
        self.model_type = "gmodel"
        self.quiet = quiet
        # archives the non-finite guard refused to fit: (datafile, reason)
        self.poisoned_datafiles = []
        for attr in self.RESULT_ATTRS:
            setattr(self, attr, [])
        self.TOA_list = []

    # -- model construction --------------------------------------------
    def _build_model(self, freqs, phases, P, fit_scat):
        """Model portrait [nchan, nbin] (numpy) at the given channel
        frequencies, built on the pipeline's device.  For fit_scat the
        model's own scattering is stripped — the fit measures it — and
        its TAU/ALPHA kept for the guesses (reference pptoas.py:355-374)."""
        if not fit_scat:
            name, ngauss, model = read_model(self.modelfile, phases, freqs,
                                             P, quiet=True,
                                             device=self.device)
            self.model_name, self.ngauss = name, ngauss
            return _host(model)
        (self.model_name, self.model_code, self.model_nu_ref, self.ngauss,
         self.gparams, _, self.alpha, _) = read_model(self.modelfile,
                                                      quiet=True)
        unscat = np.copy(self.gparams)
        unscat[1] = 0.0
        return _host(gen_gaussian_portrait(self.model_code, unscat, 0.0,
                                           phases, freqs, self.model_nu_ref,
                                           device=self.device))

    def _prepare_models(self, d, ports, freqs_b, Ps_b, fit_scat):
        """(models_b [B, nchan, nbin], same_freqs): one model broadcast
        over the batch when every subint has the same channel
        frequencies, else one model per subint."""
        same_freqs = np.allclose(freqs_b, freqs_b[0])
        if same_freqs:
            model = self._build_model(freqs_b[0], d.phases, float(Ps_b[0]),
                                      fit_scat)
            models_b = np.broadcast_to(model, ports.shape)
        else:
            models_b = np.stack([
                self._build_model(freqs_b[i], d.phases, float(Ps_b[i]),
                                  fit_scat)
                for i in range(len(ports))])
        return models_b, same_freqs

    # -- the wideband pipeline -----------------------------------------
    def get_TOAs(self, datafile=None, tscrunch=False, nu_refs=None,
                 DM0=None, bary=True, fit_DM=True, fit_GM=False,
                 fit_scat=False, log10_tau=True, scat_guess=None,
                 fix_alpha=False, print_phase=False, print_flux=False,
                 print_parangle=False, add_instrumental_response=False,
                 addtnl_toa_flags=None, method="trust-ncg", bounds=None,
                 nu_fits=None, show_plot=False, quiet=None,
                 max_iter=50, nonfinite_max_frac=0.5):
        """Measure wideband TOAs; results accumulate on self
        (reference-named).  Equivalent of pptoas.py:150-738;
        ``method`` is accepted for API parity.

        fit_GM adds a nu**-4 delay (GM) to the fit; fit_scat fits the
        scattering time (log10 of it unless ``log10_tau`` is False) and
        index (held at the model's or ``scat_guess``'s when
        ``fix_alpha``); ``scat_guess`` = (tau [s], reference frequency
        [MHz], alpha); ``nu_refs`` = (nu_ref_DM, nu_ref_tau) output
        reference frequencies (None = zero-covariance ones)."""
        if print_flux:
            raise _not_ported("flux estimates (print_flux)")
        if add_instrumental_response:
            raise _not_ported("instrumental responses")
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
        nu_ref_tuple = nu_refs
        nu_fit_tuple = nu_fits
        start = time.time()

        datafiles = self.datafiles if datafile is None else [datafile]
        for iarch, datafile in enumerate(datafiles):
            d = load_archive_data(datafile, tscrunch, quiet)
            if d is None:
                continue
            nsub, nchan, nbin = d.nsub, d.nchan, d.nbin
            fit_start = time.time()
            ok = np.asarray(d.ok_isubs)
            B = len(ok)
            DM_stored = d.DM
            DM0_arch = DM_stored if self.DM0 is None else self.DM0

            # dense per-subint views over the fit batch
            ports = d.subints[ok, 0]                      # [B, nchan, nbin]
            freqs_b = d.freqs[ok]                         # [B, nchan]
            weights_b = d.weights[ok]
            errs_b = d.noise_stds[ok, 0]
            SNRs_b = d.SNRs[ok, 0]
            Ps_b = d.Ps[ok]

            ports, errs_b, weights_b, bad_chan, n_zap, n_live = \
                _nonfinite_guard(ports, errs_b, weights_b)
            if n_zap:
                frac = n_zap / max(n_live, 1)
                if frac > nonfinite_max_frac:
                    reason = ("non-finite data: %d/%d live channels "
                              "NaN/Inf (> nonfinite_max_frac=%.2f)"
                              % (n_zap, n_live, nonfinite_max_frac))
                    self.poisoned_datafiles.append((datafile, reason))
                    if not quiet:
                        print(f"{datafile}: {reason}; not fitting it.")
                    continue
                SNRs_b = np.where(bad_chan, 0.0, SNRs_b)
            wok = (weights_b > 0.0).astype(np.float64)
            if n_zap:
                keep = wok.sum(-1) > 0
                if not keep.all():  # subints with no live channel left
                    ok, ports, freqs_b, weights_b, errs_b, SNRs_b, \
                        Ps_b, wok = (a[keep] for a in (
                            ok, ports, freqs_b, weights_b, errs_b,
                            SNRs_b, Ps_b, wok))
                    B = len(ok)
                    if B == 0:
                        self.poisoned_datafiles.append(
                            (datafile, "non-finite data: every subint "
                                       "lost all live channels"))
                        continue

            models_b, same_freqs = self._prepare_models(d, ports, freqs_b,
                                                        Ps_b, fit_scat)
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
            ports_dev = torch.as_tensor(ports).to(self.device)
            wok_dev = torch.as_tensor(wok).to(self.device)
            DM_guess = DM_stored
            rot_ports = rotate_data(ports_dev, 0.0, DM_guess, Ps_b, freqs_b,
                                    nu_means[:, None])
            # weighted band-average profiles
            rot_profs = (rot_ports * wok_dev[..., None]).sum(1) / \
                wok_dev.sum(-1)[:, None]
            del rot_ports
            # (einsum: no [B, nchan, nbin] product of the broadcast model)
            model_profs = np.einsum("bc,bcn->bn", wok, models_b) / \
                wok.sum(-1)[:, None]
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
                # scatter the model mean profile for the phase guess (host)
                taus_g = _host(scattering_times(
                    torch.as_tensor(tau_guess), torch.as_tensor(alpha_guess),
                    nu_fits_b[:, 2], torch.as_tensor(nu_fits_b[:, 2])))
                spFT = _host(scattering_portrait_FT(taus_g, nbin))
                model_profs = np.fft.irfft(
                    spFT * np.fft.rfft(model_profs, axis=-1), nbin, axis=-1)
                if log10_tau:
                    tau_guess = np.log10(np.where(tau_guess == 0.0,
                                                  1.0 / nbin, tau_guess))
            guess = fit_phase_shift(rot_profs, model_profs,
                                    noise=np.median(errs_b, axis=-1),
                                    Ns=100, device=self.device)
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
                out = fit_portrait_full_batch(
                    ports_dev[torch.as_tensor(sel, device=self.device)],
                    models_b[0] if same_freqs else models_b[sel],
                    init[sel], Ps_b[sel], freqs_b[sel], errs=errs_b[sel],
                    weights=weights_b[sel], fit_flags=fl,
                    nu_fits=nu_fits_b[sel],
                    nu_outs=None if nu_outs_b is None else tuple(
                        None if col is None else col[sel]
                        for col in nu_outs_b),
                    bounds=bounds_eff, log10_tau=log10_tau,
                    max_iter=max_iter, device=self.device)
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
            red_chi2s = np.zeros(nsub)
            covariances = np.zeros([nsub, 5, 5])
            nfevals = np.zeros(nsub, dtype=int)
            rcs = np.zeros(nsub, dtype=int)
            MJDs = np.array([d.epochs[isub].mjd() for isub in range(nsub)])

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
            self.covariances.append(covariances)
            self.red_chi2s.append(red_chi2s)
            self.nfevals.append(nfevals)
            self.rcs.append(rcs)
            self.fit_durations.append(fit_duration)
            self.n_nonfinite_zapped.append(n_zap)
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
            else:
                dDM = dDM_err = 0.0
            write_princeton_TOA(toa.MJD.intday(), toa.MJD.fracday(),
                                toa.TOA_error, toa.frequency, dDM,
                                obs=toa.telescope_code, outfile=outfile)
            dm_err_lines.append("%.5e" % dDM_err)
        if dmerrfile is not None:
            with open(dmerrfile, "a") as f:
                f.write("\n".join(dm_err_lines) + "\n")
