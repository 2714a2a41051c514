"""DataPortrait: the t/p-scrunched portrait container for model building.

Port of the JAX package's ``dataportrait.py`` (reference
pplib.py:138-649), including the multi-archive "join" machinery
(:163-305).  As in the JAX package the portrait state is host numpy (the
PSRFITS decode, the spline fit and the file writes stay on the host);
every array computation — rotations, normalization (kernel K2 for
'prof'), wavelet smoothing, the flux power-law fit and the join seeds
(K2) — runs on ``device`` (None = the CUDA device) on an upload of the
arrays it needs, and its result comes back to the host state.
"""

import numpy as np
import torch

from .config import resolve_device
from .fit.phase_shift import fit_phase_shift
from .io.archive import file_is_type, load_data, parse_metafile
from .ops.fourier import rotate_data
from .ops.noise import get_noise
from .ops.normalize import normalize_portrait
from .ops.wavelet import smart_smooth, wavelet_smooth

__all__ = ["DataPortrait"]


def _np(t):
    return t.detach().cpu().numpy()


class DataPortrait:
    """One (tscrunched, pscrunched) portrait + condensed views + metadata.

    datafile: a PSRFITS archive path, or a metafile listing several
    archives — the latter activates "join" mode, concatenating the bands
    in frequency order with per-band (phase, DM) alignment parameters.
    joinfile: optional persisted join parameters (write_join_parameters).
    device: where the array work runs (None = the CUDA device).
    """

    def __init__(self, datafile=None, joinfile=None, quiet=True,
                 device=None, **load_data_kwargs):
        self.device = resolve_device(device)
        self.init_params = []
        self.joinfile = joinfile
        self.datafile = datafile
        if file_is_type(datafile) == "ASCII":
            self._init_join(datafile, quiet, **load_data_kwargs)
        else:
            self._init_single(datafile, quiet, **load_data_kwargs)

    def _t(self, x):
        """A float64 tensor of ``x`` on the portrait's device."""
        return torch.as_tensor(np.asarray(x, dtype=np.float64),
                               device=self.device)

    def _rotate(self, data, phase=0.0, DM=0.0, Ps=None, freqs=None,
                nu_ref=np.inf):
        """rotate_data on the device, back to numpy."""
        return _np(rotate_data(self._t(data), phase, DM, Ps,
                               None if freqs is None else self._t(freqs),
                               nu_ref))

    # -- construction -----------------------------------------------------

    def _init_single(self, datafile, quiet, **load_data_kwargs):
        self.njoin = 0
        self.join_params = np.array([])
        self.join_param_errs = np.array([])
        self.join_fit_flags = np.array([])
        self.join_ichans = []
        self.join_ichanxs = []
        self.all_join_params = []
        self.datafiles = [datafile]
        d = self.data = load_data(
            datafile, dedisperse=True, dededisperse=False, tscrunch=True,
            pscrunch=True, fscrunch=False, flux_prof=True,
            refresh_arch=True, return_arch=True, quiet=quiet,
            **load_data_kwargs)
        for key in ("source", "arch", "nbin", "nchan", "nu0", "bw", "Ps",
                    "freqs", "weights", "masks", "ok_ichans", "ok_isubs",
                    "noise_stds", "SNRs", "phases", "prof", "flux_prof",
                    "DM", "epochs", "telescope", "telescope_code"):
            setattr(self, key, d[key])
        self.noise_stds = np.array(self.noise_stds)
        if self.source is None:
            self.source = "noname"
        ok = self.ok_ichans[0]
        self.port = (self.masks * d.subints)[0, 0]
        self.portx = self.port[ok]
        self.flux_profx = self.flux_prof[ok]
        self.freqsxs = [self.freqs[0, ok]]
        self.noise_stdsxs = self.noise_stds[0, 0, ok]
        self.SNRsxs = self.SNRs[0, 0, ok]
        self.weightsxs = np.array([self.weights[0, ok]])

    def _init_join(self, metafile, quiet, **load_data_kwargs):
        """Concatenate several single-receiver archives in frequency order
        with per-band alignment parameters (ref pplib.py:163-305); each
        band after the first is seeded by an FFTFIT (K2) of its profile
        against the first band's."""
        self.metafile = metafile
        self.datafiles = parse_metafile(metafile)
        self.njoin = len(self.datafiles)
        join_params, join_fit_flags = [], []
        join_nchans, join_nchanxs = [0], [0]
        freqs, freqsxs, masks, port, portx = [], [], [], [], []
        flux_prof, flux_profx = [], []
        noise_stds, noise_stdsxs, SNRs, SNRsxs = [], [], [], []
        weights, weightsxs = [], []
        Psum, nchan, nchanx = 0.0, 0, 0
        lofreq, hifreq = np.inf, 0.0
        refprof = None
        d = None
        for ifile, fname in enumerate(self.datafiles):
            d = load_data(fname, dedisperse=True, tscrunch=True,
                          pscrunch=True, fscrunch=False, flux_prof=True,
                          return_arch=True, quiet=quiet, **load_data_kwargs)
            nchan += d.nchan
            nchanx += len(d.ok_ichans[0])
            join_nchans.append(nchan)
            join_nchanxs.append(nchanx)
            if ifile == 0:
                # first band anchors the frame: phase fixed, DM offset fit
                join_params.extend([0.0, 0.0])
                join_fit_flags.extend([0, 1])
                self.nbin = d.nbin
                self.phases = d.phases
                refprof = d.prof
                self.source = d.source
                self.arch = d.arch
            else:
                phi = -float(fit_phase_shift(
                    self._t(d.prof), self._t(refprof), Ns=self.nbin,
                    device=self.device).phase)
                join_params.extend([phi, 0.0])
                join_fit_flags.extend([1, 1])
            Psum += d.Ps.mean()
            lofreq = min(lofreq, d.freqs.min() - abs(d.bw) / (2 * d.nchan))
            hifreq = max(hifreq, d.freqs.max() + abs(d.bw) / (2 * d.nchan))
            ok = d.ok_ichans[0]
            freqs.extend(d.freqs[0])
            freqsxs.extend(d.freqs[0, ok])
            masks.extend(d.masks[0, 0])
            port.extend(d.subints[0, 0] * d.masks[0, 0])
            portx.extend(d.subints[0, 0, ok])
            flux_prof.extend(d.flux_prof)
            flux_profx.extend(d.flux_prof[ok])
            noise_stds.extend(d.noise_stds[0, 0])
            noise_stdsxs.extend(d.noise_stds[0, 0, ok])
            SNRs.extend(d.SNRs[0, 0])
            SNRsxs.extend(d.SNRs[0, 0, ok])
            weights.extend(d.weights[0])
            weightsxs.extend(d.weights[0, ok])
        self.data = d
        self.DM = d.DM
        self.nchan, self.nchanx = nchan, nchanx
        self.Ps = np.array([Psum / self.njoin])
        self.lofreq, self.hifreq = lofreq, hifreq
        self.bw = hifreq - lofreq
        freqs = np.asarray(freqs)
        freqsxs = np.asarray(freqsxs)
        self.nu0 = freqs.mean()
        isort = np.argsort(freqs)
        isortx = np.argsort(freqsxs)
        self.isort, self.isortx = isort, isortx
        self.join_ichans = []
        self.join_ichanxs = []
        for ij in range(self.njoin):
            self.join_ichans.append(np.flatnonzero(
                (isort >= join_nchans[ij]) & (isort < join_nchans[ij + 1])))
            self.join_ichanxs.append(np.flatnonzero(
                (isortx >= join_nchanxs[ij])
                & (isortx < join_nchanxs[ij + 1])))
        self.masks = np.asarray(masks)[isort][None, None]
        self.port = np.asarray(port)[isort]
        self.portx = np.asarray(portx)[isortx]
        self.flux_prof = np.asarray(flux_prof)[isort]
        self.flux_profx = np.asarray(flux_profx)[isortx]
        self.noise_stds = np.asarray(noise_stds)[isort][None, None]
        self.noise_stdsxs = np.asarray(noise_stdsxs)[isortx]
        self.SNRs = np.asarray(SNRs)[isort][None, None]
        self.SNRsxs = np.asarray(SNRsxs)[isortx]
        self.weights = np.asarray(weights)[isort][None]
        self.weightsxs = np.asarray(weightsxs)[isortx][None]
        self.freqs = np.sort(freqs)[None]
        self.freqsxs = [np.sort(freqsxs)]
        self.ok_ichans = [np.flatnonzero(self.weights[0] > 0.0)]
        self.join_params = np.asarray(join_params, dtype=np.float64)
        self.join_param_errs = np.zeros_like(self.join_params)
        self.join_fit_flags = np.asarray(join_fit_flags, dtype=int)
        if self.joinfile:
            self._read_joinfile(self.joinfile)
        self.all_join_params = [self.join_ichanxs, self.join_params,
                                self.join_fit_flags]

    def _read_joinfile(self, joinfile):
        """Re-seed join parameters from a persisted joinfile
        (ref pplib.py:282-299)."""
        with open(joinfile) as f:
            lines = [ln.split() for ln in f
                     if ln.strip() and not ln.startswith("#")]
        for parts in lines[-len(self.datafiles):]:
            try:
                ij = self.datafiles.index(parts[0])
            except ValueError:
                continue
            phi = float(parts[1])
            DM = float(parts[3]) if len(parts) > 3 else float(parts[2])
            self.join_params[ij * 2] = phi
            self.join_params[ij * 2 + 1] = DM

    # -- manipulation ------------------------------------------------------

    def apply_joinfile(self, nu_ref, undo=False):
        """Rotate each band by its join (phase, DM) parameters
        (ref pplib.py:329-355)."""
        sign = -1.0 if undo else 1.0
        for ij in range(self.njoin):
            phi = sign * self.join_params[2 * ij]
            DM = sign * self.join_params[2 * ij + 1]
            jic = self.join_ichans[ij]
            self.port[jic] = self._rotate(self.port[jic], -phi, -DM,
                                          self.Ps[0], self.freqs[0, jic],
                                          nu_ref)
            jicx = self.join_ichanxs[ij]
            self.portx[jicx] = self._rotate(self.portx[jicx], -phi, -DM,
                                            self.Ps[0],
                                            self.freqsxs[0][jicx], nu_ref)

    def normalize_portrait(self, method="rms"):
        """Per-channel normalization of port and portx
        (ref pplib.py:357-382)."""
        weights = self.weights[0] if method == "prof" else None
        weightsx = self.weights[self.weights > 0.0] \
            if method == "prof" else None
        self.unnorm_noise_stds = np.copy(self.noise_stds)
        port, norms = normalize_portrait(
            self._t(self.port), method,
            weights=None if weights is None else self._t(weights),
            return_norms=True)
        self.port = _np(port)
        self.norm_values = _np(norms)
        self.noise_stds[0, 0] = _np(get_noise(port))
        self.flux_prof = self.port.mean(axis=1)
        self.unnorm_noise_stdsxs = np.copy(self.noise_stdsxs)
        portx = normalize_portrait(
            self._t(self.portx), method,
            weights=None if weightsx is None else self._t(weightsx))
        self.portx = _np(portx)
        self.noise_stdsxs = _np(get_noise(portx))
        self.flux_profx = self.portx.mean(axis=1)

    def unnormalize_portrait(self):
        """Undo normalize_portrait (ref pplib.py:384-398)."""
        if not hasattr(self, "unnorm_noise_stds"):
            return
        self.port = self.norm_values[:, None] * self.port
        self.noise_stds = np.copy(self.unnorm_noise_stds)
        del self.unnorm_noise_stds
        self.flux_prof = self.port.mean(axis=1)
        self.portx = self.norm_values[self.ok_ichans[0]][:, None] * \
            self.portx
        self.noise_stdsxs = np.copy(self.unnorm_noise_stdsxs)
        del self.unnorm_noise_stdsxs
        self.flux_profx = self.portx.mean(axis=1)
        self.norm_values = np.ones(len(self.port))

    def smooth_portrait(self, smart=False, **kwargs):
        """Wavelet-smooth port/portx in place (ref pplib.py:400-424)."""
        if smart:
            kwargs.setdefault("try_nlevels",
                              min(8, int(np.log2(self.nbin))))
            port = smart_smooth(self._t(self.port), **kwargs)
            portx = smart_smooth(self._t(self.portx), **kwargs)
        else:
            port = wavelet_smooth(self._t(self.port), **kwargs)
            portx = wavelet_smooth(self._t(self.portx), **kwargs)
        self.port, self.portx = _np(port), _np(portx)
        self.noise_stds[0, 0] = _np(get_noise(port))
        self.noise_stdsxs = _np(get_noise(portx))
        self.flux_prof = self.port.mean(axis=1)
        self.flux_profx = self.portx.mean(axis=1)

    def fit_flux_profile(self, channel_errs=None, nu_ref=None, guessA=1.0,
                         guessalpha=0.0, quiet=True):
        """Power-law fit to the phase-averaged flux spectrum
        (ref pplib.py:426-485, without the plot)."""
        from .fit.powlaw import fit_powlaw

        if nu_ref is None:
            nu_ref = self.nu0
        if channel_errs is None:
            channel_errs = np.ones(len(self.freqsxs[0]))
        fp = fit_powlaw(self.flux_profx, np.array([guessA, guessalpha]),
                        channel_errs, self.freqsxs[0], nu_ref,
                        device=self.device)
        if not quiet:
            print("Flux power law: A = %.3f +/- %.3f at %.2f MHz, "
                  "alpha = %.3f +/- %.3f" % (fp.amp, fp.amp_err, fp.nu_ref,
                                             fp.alpha, fp.alpha_err))
        self.flux_fit = fp
        self.spect_A, self.spect_A_err = fp.amp, fp.amp_err
        self.spect_A_ref = fp.nu_ref
        self.spect_index, self.spect_index_err = fp.alpha, fp.alpha_err
        return fp

    def rotate_stuff(self, phase=0.0, DM=0.0, ichans=None, ichanxs=None,
                     nu_ref=None, model=False):
        """Rotate port/portx (optionally the model) by (phase, DM), and —
        when rotating the full band — keep the stored model-building
        attributes (prof, mean_prof, eigenprofiles) aligned in lockstep
        (ref pplib.py:523-570)."""
        P = self.Ps[0]
        if nu_ref is None:
            nu_ref = self.nu0
        all_chans = ichans is None and ichanxs is None
        if ichans is None:
            ichans = np.arange(self.port.shape[0])
        if ichanxs is None:
            ichanxs = np.arange(self.portx.shape[0])
        self.port[ichans] = self._rotate(self.port[ichans], phase, DM, P,
                                         self.freqs[0, ichans], nu_ref)
        self.portx[ichanxs] = self._rotate(self.portx[ichanxs], phase, DM,
                                           P, self.freqsxs[0][ichanxs],
                                           nu_ref)
        if all_chans:
            # achromatic companions rotate by the phase term only
            for attr in ("prof", "mean_prof", "smooth_mean_prof"):
                if getattr(self, attr, None) is not None:
                    setattr(self, attr, self._rotate(getattr(self, attr),
                                                     phase))
            for attr in ("eigvec", "smooth_eigvec"):
                ev = getattr(self, attr, None)
                if ev is not None and np.size(ev):
                    setattr(self, attr,
                            self._rotate(np.asarray(ev).T, phase).T)
        if model and hasattr(self, "model"):
            self.model[ichans] = self._rotate(self.model[ichans], phase, DM,
                                              P, self.freqs[0, ichans],
                                              nu_ref)
            self.model_masked = self.model * self.masks[0, 0]
            self.modelx = self.model[self.ok_ichans[0]]

    # -- visualization (ref pplib.py:617-649; the viz slice) ---------------

    def show_data_portrait(self, **kwargs):
        raise NotImplementedError("show_data_portrait is not yet ported.")

    def show_model_portrait(self, **kwargs):
        raise NotImplementedError("show_model_portrait is not yet ported.")

    def show_model_fit(self, **kwargs):
        raise NotImplementedError("show_model_fit is not yet ported.")

    # -- output ------------------------------------------------------------

    def write_join_parameters(self, joinfile=None):
        """Persist join parameters (ref pplib.py:486-521)."""
        if joinfile is None:
            joinfile = self.joinfile or \
                (getattr(self, "model_name", self.datafile) + ".join")
        errs = self.join_param_errs if len(self.join_param_errs) else \
            np.zeros_like(self.join_params)
        with open(joinfile, "a") as jf:
            jf.write("# archive name" + " " * 32
                     + "-phase offset & err [rot]" + " " * 2
                     + "-delta-DM & err [cm**-3 pc]\n")
            for ifile, datafile in enumerate(self.datafiles):
                jf.write("%s%s% .10f %.10f  % .6f %.6f\n" % (
                    datafile, " " * abs(45 - len(datafile)),
                    self.join_params[2 * ifile], errs[2 * ifile],
                    self.join_params[2 * ifile + 1], errs[2 * ifile + 1]))
        return joinfile

    def unload_archive(self, outfile=None, quiet=True):
        """Write the (possibly modified) portrait back to PSRFITS
        (ref pplib.py:572-595)."""
        from .io.archive import unload_new_archive

        if outfile is None:
            outfile = self.datafile + ".port.fits"
        unload_new_archive(self.port[None, None], self.arch, outfile,
                           DM=self.DM, dmc=0, weights=self.weights,
                           quiet=quiet)
        return outfile

    def write_model_archive(self, outfile, quiet=True):
        """Write the current model portrait to PSRFITS
        (ref pplib.py:597-615)."""
        from .io.archive import unload_new_archive

        if not hasattr(self, "model"):
            raise AttributeError("no model built yet")
        unload_new_archive(np.asarray(self.model)[None, None], self.arch,
                           outfile, DM=0.0, dmc=0, weights=self.weights,
                           quiet=quiet)
        return outfile
