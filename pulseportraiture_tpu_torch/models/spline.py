"""ppspline-equivalent model builder: PCA + B-spline profile evolution.

Port of the JAX package's ``models/spline.py`` (reference
ppspline.py:34-274 ``make_spline_model``/``write_model``): the portrait
is decomposed into a weighted-mean profile plus principal components
(``torch.linalg.eigh`` on the device), significant eigenvectors are
selected by smoothed Fourier S/N (the batched wavelet search, on the
device), the per-channel projections are fit with a parametric B-spline
over frequency (host FITPACK ``splprep``, once per model), and the model
is evaluated on the device (de Boor, ops.splines) and written to the npz
spline container that both packages read.
"""

import numpy as np
import scipy.interpolate as si
import torch

from ..dataportrait import DataPortrait
from ..io.splmodel import write_spline_model
from ..ops.pca import find_significant_eigvec, pca, reconstruct_portrait
from ..ops.splines import gen_spline_portrait
from ..ops.wavelet import smart_smooth
from ..utils.databunch import DataBunch

__all__ = ["make_spline_model", "write_model", "SplineModelPortrait"]


def _np(t):
    return t.detach().cpu().numpy()


def make_spline_model(dp, max_ncomp=10, smooth=True, snr_cutoff=150.0,
                      rchi2_tol=0.1, k=3, sfac=1.0, max_nbreak=None,
                      model_name=None, quiet=True, device=None, **kwargs):
    """Build a PCA/B-spline portrait model from a DataPortrait.

    dp: a DataPortrait (or the path of an archive/metafile, loaded here
    on ``device``; a DataPortrait brings its own device).  Behavioral
    equivalent of ppspline.py:34-204; returns a DataBunch with
    (model_name, source, datafile, mean_prof, eigvec [nbin, ncomp], tck,
    ieig, ncomp, eigval, proj_port, model, modelx, fp, ier) — host numpy —
    and stores the same attributes on ``dp``.  Smoothing parameter:
    s = sfac * nprof * sum((SNR*sigma)**2)/sum(SNR)**2 (the reference's
    formula, ppspline.py:135-146).  Eigenvector signs are the
    eigensolver's: the model portrait does not depend on them.
    """
    if isinstance(dp, str):
        dp = DataPortrait(dp, quiet=quiet, device=device)
    dev = dp.device

    port = dp.portx
    pca_weights = dp.SNRsxs / np.sum(dp.SNRsxs)
    mean_prof = (port * pca_weights[:, None]).sum(axis=0) / \
        pca_weights.sum()
    freqs = dp.freqsxs[0]
    nu_lo, nu_hi = freqs.min(), freqs.max()
    nbin = port.shape[1]
    if nbin % 2 != 0:
        if not quiet:
            print("nbin = %d is odd; cannot wavelet-smooth." % nbin)
        smooth = False

    port_t = torch.as_tensor(port, device=dev)
    mean_t = torch.as_tensor(mean_prof, device=dev)
    eigval, eigvec = pca(port_t, mean_t, torch.as_tensor(pca_weights,
                                                         device=dev))
    return_max = 10 if max_ncomp is None else min(max_ncomp, 10)
    if smooth:
        ieig, smooth_eigvec = find_significant_eigvec(
            eigvec, check_max=10, return_max=return_max,
            snr_cutoff=snr_cutoff, return_smooth=True,
            rchi2_tol=rchi2_tol, **kwargs)
        smooth_mean_prof = smart_smooth(mean_t, rchi2_tol=rchi2_tol,
                                        fallback="raw")
        use_mean, use_eigvec = smooth_mean_prof, smooth_eigvec
    else:
        ieig = find_significant_eigvec(
            eigvec, check_max=10, return_max=return_max,
            snr_cutoff=snr_cutoff, return_smooth=False,
            rchi2_tol=rchi2_tol, **kwargs)
        smooth_mean_prof = smooth_eigvec = None
        use_mean, use_eigvec = mean_t, eigvec
    ncomp = len(ieig)
    ieig_t = torch.as_tensor(ieig, dtype=torch.long, device=dev)

    nchan_all = dp.freqs.shape[-1]
    if ncomp == 0:
        # constant-profile model
        proj_port = port[:, :0]
        modelx = np.tile(_np(use_mean), (len(freqs), 1))
        model = np.tile(_np(use_mean), (nchan_all, 1))
        tck = [np.array([]), np.array([]).reshape(0, 0), 0]
        u, fp, ier, msg = np.array([]), None, None, None
    else:
        proj_port = _np((port_t - mean_t) @ use_eigvec[:, ieig_t])
        # FITPACK parametric spline of the projections over frequency
        spl_weights = pca_weights
        s = sfac * len(proj_port) * \
            np.sum((dp.SNRsxs * dp.noise_stdsxs) ** 2) / \
            np.sum(dp.SNRsxs) ** 2
        flip = -1 if dp.bw < 0 else 1   # u must be increasing
        (tck, u), fp, ier, msg = si.splprep(
            proj_port[::flip].T, w=spl_weights[::flip], u=freqs[::flip],
            ub=nu_lo, ue=nu_hi, k=min(k, len(freqs) - 1), task=0, s=s,
            t=None, full_output=1, nest=None, per=0, quiet=int(quiet))
        if max_nbreak is not None and \
                len(np.unique(tck[0])) > max_nbreak:
            max_nbreak = max(max_nbreak, 2)
            if max_nbreak == 2:
                s = np.inf
            (tck, u), fp, ier, msg = si.splprep(
                proj_port[::flip].T, w=spl_weights[::flip],
                u=freqs[::flip], ub=nu_lo, ue=nu_hi,
                k=min(k, len(freqs) - 1), task=0, s=s, t=None,
                full_output=1, nest=max_nbreak + 2 * k, per=0,
                quiet=int(quiet))
        if ier is not None and ier > 1 and not quiet:
            print("splprep trouble for %s:\n%s" % (dp.source, msg))
        tck = [np.asarray(tck[0]), np.asarray(tck[1]), tck[2]]
        modelx = _np(gen_spline_portrait(use_mean, freqs,
                                         use_eigvec[:, ieig_t], tck,
                                         device=dev))
        model = _np(gen_spline_portrait(use_mean, dp.freqs[0],
                                        use_eigvec[:, ieig_t], tck,
                                        device=dev))

    reconst_port = _np(reconstruct_portrait(
        port_t, mean_t, use_eigvec[:, ieig_t])) if ncomp else modelx.copy()

    if model_name is None:
        model_name = str(dp.datafile) + ".spl"
    use_mean = _np(use_mean)
    sel_eigvec = _np(use_eigvec[:, ieig_t]) if ncomp \
        else np.zeros((nbin, 0))
    # mirror the reference's attribute surface on the DataPortrait
    dp.ieig, dp.ncomp = ieig, ncomp
    dp.eigval, dp.eigvec = _np(eigval), _np(eigvec)
    dp.mean_prof = mean_prof
    if smooth:
        dp.smooth_mean_prof = use_mean
        dp.smooth_eigvec = _np(smooth_eigvec)
    dp.proj_port, dp.reconst_port = proj_port, reconst_port
    dp.tck, dp.u, dp.fp, dp.ier = tck, u, fp, ier
    dp.model_name = model_name
    dp.model, dp.modelx = model, modelx
    dp.model_masked = model * dp.masks[0, 0]

    if not quiet:
        if ncomp:
            print("B-spline model %s: %d components, %d breakpoints "
                  "(k=%d)." % (model_name, ncomp,
                               len(np.unique(tck[0])), tck[2]))
        else:
            print("B-spline model %s: 0 components (mean profile only)."
                  % model_name)
    return DataBunch(model_name=model_name, source=dp.source,
                     datafile=str(dp.datafile), mean_prof=use_mean,
                     eigvec=sel_eigvec, tck=tck, ieig=ieig, ncomp=ncomp,
                     eigval=dp.eigval, proj_port=proj_port, model=model,
                     modelx=modelx, fp=fp, ier=ier)


def write_model(outfile, built, quiet=True):
    """Write a built spline model (make_spline_model's return) to the npz
    container (the reference's ppspline.py:206-230 pickles instead)."""
    write_spline_model(outfile, built.model_name, built.source,
                       built.datafile, built.mean_prof, built.eigvec,
                       built.tck, quiet=quiet)
    return outfile


class SplineModelPortrait(DataPortrait):
    """DataPortrait with spline-modeling methods, mirroring the
    reference's ppspline.DataPortrait subclass surface."""

    def make_spline_model(self, **kwargs):
        self.spline_model = make_spline_model(self, **kwargs)
        return self.spline_model

    def write_model(self, outfile, quiet=True):
        if not hasattr(self, "spline_model"):
            raise AttributeError("call make_spline_model first")
        return write_model(outfile, self.spline_model, quiet=quiet)
