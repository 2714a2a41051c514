"""ppgauss-equivalent model builder: iterated evolving-Gaussian fits.

Port of the JAX package's ``models/gauss.py`` (reference
ppgauss.py:55-372 ``make_gaussian_model``/``model_iteration``/
``check_convergence``/``write_model``/``write_errfile``).  Seeding is
non-interactive (fit.gauss ``auto_gauss_seed`` with FFTFIT, kernel K2,
or ``peak_pick_seed``); the portrait fit is the port's Levenberg-Marquardt
with ``torch.func.jacfwd`` Jacobians on the device; the convergence check
is the (phase, DM) portrait fit (kernel K1) seeded by FFTFIT (K2).  The
interactive GaussianSelector (viz) is not ported yet.
"""

import numpy as np

from ..config import default_model, scattering_alpha
from ..dataportrait import DataPortrait
from ..fit.gauss import (auto_gauss_seed, fit_gaussian_portrait,
                         peak_pick_seed)
from ..fit.phase_shift import fit_phase_shift
from ..fit.portrait import fit_portrait
from ..fit.transforms import guess_fit_freq
from ..io.gmodel import read_model, write_model
from ..ops.profiles import gen_gaussian_portrait

__all__ = ["GaussianModelPortrait", "make_gaussian_model"]


class GaussianModelPortrait(DataPortrait):
    """DataPortrait with Gaussian-modeling methods, mirroring the
    reference's ppgauss.DataPortrait subclass surface."""

    def fit_profile(self, profile, errs=None, tau=0.0, fixscat=True,
                    auto_gauss=0.0, max_ngauss=6, interactive=False,
                    quiet=True):
        """Seed Gaussian components from an averaged profile:
        ``auto_gauss`` != 0 fits one component of that width guess,
        otherwise iterative peak-pick-fit-subtract finds up to
        ``max_ngauss`` components (ref ppgauss.py:28-53)."""
        if interactive:
            raise NotImplementedError(
                "the interactive Gaussian selector is not yet ported.")
        if errs is None:
            errs = float(np.median(self.noise_stdsxs))
        if auto_gauss:
            fit = auto_gauss_seed(profile, errs, wid_guess=auto_gauss,
                                  tau=tau, fit_scattering=not fixscat,
                                  device=self.device)
        else:
            fit = peak_pick_seed(profile, errs, max_ngauss=max_ngauss,
                                 tau=tau, fit_scattering=not fixscat,
                                 quiet=quiet, device=self.device)
        self.init_params = list(fit.fitted_params)
        self.ngauss = (len(fit.fitted_params) - 2) // 3
        return fit

    def make_gaussian_model(self, modelfile=None, ref_prof=(None, None),
                            tau=0.0, fixloc=False, fixwid=False,
                            fixamp=False, fixscat=True, fixalpha=True,
                            scattering_index=scattering_alpha,
                            model_code=default_model, niter=0,
                            fiducial_gaussian=False, auto_gauss=0.0,
                            max_ngauss=6, interactive=False,
                            writemodel=False, outfile=None,
                            writeerrfile=False, errfile=None,
                            model_name=None, quiet=True):
        """Iterate evolving-Gaussian portrait fits to convergence.

        Behavioral equivalent of ppgauss.py:55-238: seed from a modelfile
        (improve mode) or a profile fit; then fit the full portrait,
        measure the residual (phase, DM) of the data against the fitted
        model, rotate the data by it, and repeat until the offsets are
        within their uncertainties or ``niter`` runs out.  Writes the
        model each iteration when ``writemodel``.
        """
        if modelfile:
            if outfile is None:
                outfile = modelfile
            (self.model_name, self.model_code, self.nu_ref, self.ngauss,
             self.init_model_params, self.fit_flags,
             self.scattering_index, fitalpha) = read_model(modelfile)
            self.fixalpha = not fitalpha
            if model_name is not None:
                self.model_name = model_name
            # TAU in the file is seconds; the fit works in bins
            self.init_model_params[1] *= self.nbin / self.Ps[0]
        else:
            self.model_code = model_code
            self.scattering_index = scattering_index
            self.fixalpha = fixalpha
            self.model_name = model_name if model_name is not None \
                else self.source
            if not len(self.init_params):
                nu_ref, bw_ref = ref_prof
                self.nu_ref = self.nu0 if nu_ref is None else nu_ref
                bw_ref = abs(self.bw) if bw_ref is None else bw_ref
                inband = (self.freqs[0] > self.nu_ref - bw_ref / 2) & \
                    (self.freqs[0] < self.nu_ref + bw_ref / 2) & \
                    (self.masks[0, 0].mean(axis=1) > 0)
                # align the bands with the seed join parameters for the
                # seeding profile; rotate a local copy, never the state
                iband = np.flatnonzero(inband)
                band_port = np.array(self.port[iband])
                for ij in range(self.njoin):
                    sel = np.isin(iband, self.join_ichans[ij])
                    if sel.any():
                        band_port[sel] = self._rotate(
                            band_port[sel], -self.join_params[2 * ij],
                            -self.join_params[2 * ij + 1], self.Ps[0],
                            self.freqs[0, iband[sel]], self.nu_ref)
                profile = band_port.mean(axis=0)
                self.fit_profile(profile, tau=tau, fixscat=fixscat,
                                 auto_gauss=auto_gauss,
                                 max_ngauss=max_ngauss,
                                 interactive=interactive, quiet=quiet)
            else:
                self.nu_ref = ref_prof[0] or self.nu0
                self.ngauss = (len(self.init_params) - 2) // 3
            # expand [dc, tau, (loc, wid, amp)*n] to the evolving form
            # with zero slopes/spectral indices
            mp = np.empty([self.ngauss, 6])
            for ig in range(self.ngauss):
                mp[ig] = [self.init_params[2::3][ig], 0.0,
                          self.init_params[3::3][ig], 0.0,
                          self.init_params[4::3][ig], 0.0]
            self.init_model_params = np.array(
                [self.init_params[0], self.init_params[1]]
                + list(mp.ravel()))
            self.fit_flags = np.ones(len(self.init_model_params))
            self.fit_flags[1] *= not fixscat
            self.fit_flags[3::6] *= not fixloc
            self.fit_flags[5::6] *= not fixwid
            self.fit_flags[7::6] *= not fixamp
            if fiducial_gaussian:
                # free every component's loc slope except the first's
                # (ref ppgauss.py:155-159)
                self.fit_flags[3::6] = 1
                self.fit_flags[3] = 0
        if errfile is None and outfile is not None:
            errfile = outfile + "_errs"

        self.portx_noise = np.outer(self.noise_stdsxs, np.ones(self.nbin))
        self.nu_fit = float(guess_fit_freq(self.freqsxs[0], self.SNRsxs))
        niter = max(niter, 0)
        self.niter = self.itern = niter
        self.model_params = np.copy(self.init_model_params)

        self._model_iteration(quiet=quiet)
        self.cnvrgnc = self.check_convergence(quiet=quiet)
        if writemodel:
            self.write_model(outfile=outfile, quiet=quiet)
        if writeerrfile:
            self.write_errfile(errfile=errfile, quiet=quiet)
        while self.niter and not self.cnvrgnc:
            if not self.njoin:
                # rotate the data into the fitted frame and refit
                self.port = self._rotate(self.port, self.phi, self.DM,
                                         self.Ps[0], self.freqs[0],
                                         self.nu_fit)
                self.portx = self._rotate(self.portx, self.phi, self.DM,
                                          self.Ps[0], self.freqsxs[0],
                                          self.nu_fit)
            self._model_iteration(quiet=quiet)
            self.niter -= 1
            self.cnvrgnc = self.check_convergence(quiet=quiet)
            if writemodel:  # for safety, write after each iteration
                self.write_model(outfile=outfile, quiet=quiet)
            if writeerrfile:
                self.write_errfile(errfile=errfile, quiet=quiet)
        # rotate the joined bands (and model) back to native frames
        for ii in range(self.njoin):
            phi = self.join_params[0::2][ii]
            DM = self.join_params[1::2][ii]
            jic = self.join_ichans[ii]
            jicx = self.join_ichanxs[ii]
            self.port[jic] = self._rotate(self.port[jic], -phi, -DM,
                                          self.Ps[0], self.freqs[0, jic],
                                          self.nu_ref)
            self.portx[jicx] = self._rotate(self.portx[jicx], -phi, -DM,
                                            self.Ps[0],
                                            self.freqsxs[0][jicx],
                                            self.nu_ref)
            self.model[jic] = self._rotate(self.model[jic], -phi, -DM,
                                           self.Ps[0], self.freqs[0, jic],
                                           self.nu_ref)
        if self.njoin:
            self.model_masked = self.model * self.masks[0, 0]
            self.modelx = self.model[self.ok_ichans[0]]
        if not quiet:
            print("Residuals std: %.2e (data std %.2e)"
                  % ((self.portx - self.modelx).std(),
                     np.median(self.noise_stdsxs)))
        return self.model

    def _model_iteration(self, quiet=True):
        """One full-portrait Gaussian fit (ref ppgauss.py:240-276)."""
        fgp = fit_gaussian_portrait(
            self.model_code, self.portx, self.model_params,
            self.scattering_index, self.portx_noise, self.fit_flags,
            not self.fixalpha, self.phases, self.freqsxs[0], self.nu_ref,
            self.all_join_params, self.Ps[0], quiet=quiet,
            device=self.device)
        self.fgp = fgp
        self.chi2, self.dof = fgp.chi2, fgp.dof
        self.scattering_index = fgp.scattering_index
        self.scattering_index_err = fgp.scattering_index_err
        if self.njoin:
            self.model_params = fgp.fitted_params[:-self.njoin * 2]
            self.model_param_errs = fgp.fit_errs[:-self.njoin * 2]
            self.join_params = fgp.fitted_params[-self.njoin * 2:]
            self.join_param_errs = fgp.fit_errs[-self.njoin * 2:]
            self.all_join_params[1] = self.join_params
        else:
            self.model_params = fgp.fitted_params[:]
            self.model_param_errs = fgp.fit_errs[:]
        full_params = np.concatenate(
            [self.model_params,
             self.join_params if self.njoin else np.array([])])
        self.model = gen_gaussian_portrait(
            self.model_code, full_params, self.scattering_index,
            self.phases, self.freqs[0], self.nu_ref, self.join_ichans,
            self.Ps[0], device=self.device).cpu().numpy()
        self.model_masked = self.model * self.masks[0, 0]
        self.modelx = self.model[self.ok_ichans[0]]

    def check_convergence(self, efac=1.0, quiet=True):
        """(phase, DM) of the data vs the fitted model within errors?
        FFTFIT (K2) seeds the (phase, DM) portrait fit (K1)
        (ref ppgauss.py:278-334)."""
        if self.njoin:
            portx = np.zeros_like(self.portx)
            modelx = np.zeros_like(self.modelx)
            for ii in range(self.njoin):
                phi = self.join_params[0::2][ii]
                DM = self.join_params[1::2][ii]
                jicx = self.join_ichanxs[ii]
                portx[jicx] = self._rotate(self.portx[jicx], -phi, -DM,
                                           self.Ps[0],
                                           self.freqsxs[0][jicx],
                                           self.nu_ref)
                modelx[jicx] = self._rotate(self.modelx[jicx], -phi, -DM,
                                            self.Ps[0],
                                            self.freqsxs[0][jicx],
                                            self.nu_ref)
        else:
            portx, modelx = self.portx, self.modelx
        phase_guess = float(fit_phase_shift(
            self._t(portx.mean(axis=0)), self._t(modelx.mean(axis=0)),
            device=self.device).phase)
        phase_guess = (phase_guess + 0.5) % 1.0 - 0.5
        fp = fit_portrait(portx, modelx, [phase_guess, 0.0], self.Ps[0],
                          self.freqsxs[0], nu_fit=self.nu_fit, quiet=True,
                          device=self.device)
        self.fp_results = fp
        self.phi = float(fp.phase)
        self.phierr = float(fp.phase_err)
        self.DM = float(fp.DM)
        self.DMerr = float(fp.DM_err)
        self.red_chi2 = float(fp.red_chi2)
        if not quiet:
            print("Iter %d: phase %.2e +/- %.2e rot, DM %.6e +/- %.2e, "
                  "red chi2 %.2f" % (self.itern - self.niter, self.phi,
                                     self.phierr, self.DM, self.DMerr,
                                     self.red_chi2))
        converged = (min(abs(self.phi), abs(1 - self.phi))
                     < abs(self.phierr) * efac
                     and abs(self.DM) < abs(self.DMerr) * efac)
        return int(converged)

    def write_model(self, outfile=None, append=False, quiet=True):
        """Write the fitted model, TAU bins -> seconds
        (ref ppgauss.py:336-352)."""
        if outfile is None:
            outfile = self.model_name + ".gmodel"
        params = np.copy(self.model_params)
        # wrap component locations back into [0, 1) (ref ppgauss.py:345)
        params[2::6] = np.where(params[2::6] >= 1.0, params[2::6] % 1.0,
                                params[2::6])
        params[1] *= self.Ps[0] / self.nbin
        write_model(outfile, self.model_name, self.model_code, self.nu_ref,
                    params, self.fit_flags.astype(int),
                    self.scattering_index, int(not self.fixalpha),
                    append=append, quiet=quiet)
        return outfile

    def write_errfile(self, errfile=None, quiet=True):
        """Write parameter uncertainties in model-file format
        (ref ppgauss.py:354-372)."""
        if errfile is None:
            errfile = self.model_name + ".gmodel_errs"
        errs = np.copy(self.model_param_errs)
        errs[1] *= self.Ps[0] / self.nbin
        write_model(errfile, self.model_name + "_errs", self.model_code,
                    self.nu_ref, errs, self.fit_flags.astype(int),
                    self.scattering_index_err, int(not self.fixalpha),
                    quiet=quiet)
        return errfile


def make_gaussian_model(datafile, quiet=True, device=None, **kwargs):
    """Convenience wrapper: datafile/metafile -> fitted
    GaussianModelPortrait on ``device`` (the ppgauss CLI's core path)."""
    dp = GaussianModelPortrait(datafile, quiet=quiet, device=device)
    dp.make_gaussian_model(quiet=quiet, **kwargs)
    return dp
