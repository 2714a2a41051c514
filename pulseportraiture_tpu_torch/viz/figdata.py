"""The numbers behind the figures, without matplotlib.

The figures of ``viz`` draw on the host, but some of what they show is
device work: the fitted subint of ``show_fit`` / ``show_subint`` (the
rotation and the scaled model after a K1/K2 fit), every live channel's
reduced chi2 for the residual histogram, and the FFTFIT of each stacked
profile against its model (K2).  These functions compute it on the
device of their tensor inputs and return tensors there, so the numbers
can be made and checked where matplotlib is not installed.
"""

import numpy as np
import torch

from ..config import real_dtype
from ..fit.phase_shift import fit_phase_shift
from ..ops.fourier import rotate_data
from ..ops.noise import get_noise
from ..utils.databunch import DataBunch

__all__ = ["fitted_subint", "residual_payload", "stacked_fits",
           "zap_hist", "RCHI2_BINS"]

# the residual plot's histogram edges (the JAX package's viz)
RCHI2_BINS = (list(np.linspace(0.0, 2.0, 21))
              + list(np.linspace(3.0, 10.0, 8))
              + list(np.linspace(20.0, 100.0, 9))
              + list(np.linspace(200.0, 1000.0, 9)) + [np.inf])


def fitted_subint(gt, ifile=0, isub=0, rotate=0.0):
    """One fitted subint of a GetTOAs run on its device: DataBunch(port,
    model [nchan, nbin], ok_ichans, freqs, noise_stds [nchan]), the
    payload of ``gt.return_fit`` kept on the device; ``rotate`` [rot]
    turns port and model by that phase."""
    port, model, ok_ichans, freqs, noise_stds = gt._fitted_subint(ifile,
                                                                  isub)
    if rotate:
        port = rotate_data(port, rotate)
        model = rotate_data(model, rotate)
    return DataBunch(port=port, model=model, ok_ichans=ok_ichans,
                     freqs=freqs, noise_stds=torch.as_tensor(
                         noise_stds, dtype=real_dtype).to(port.device))


def residual_payload(port, model, noise_stds=None, nfit=0):
    """The residual plot's channel statistics of ``port`` against
    ``model`` [nchan, nbin] (tensors on one device): DataBunch(live
    [nchan] bool, the channels whose mean is not 0; noise_stds [nlive],
    the given ones or get_noise of each live row; rchi2 [nlive], each
    live channel's reduced chi2 with dof = nbin - nfit), in one batched
    reduction."""
    live = port.mean(dim=1) != 0.0
    portx, modelx = port[live], model[live]
    noise = get_noise(portx) if noise_stds is None else noise_stds[live]
    rchi2 = torch.sum(((portx - modelx) / noise[:, None]) ** 2, dim=-1) \
        / (port.shape[-1] - nfit)
    return DataBunch(live=live, noise_stds=noise, rchi2=rchi2)


def stacked_fits(data_profiles, model_profiles):
    """The stacked-profile view's fitted models: every row of
    ``model_profiles`` whose data row differs from it is scaled and
    rotated onto the data by FFTFIT (Ns 100), all such rows in one call
    (one K2 launch on the card).  Tensors [nprof, nbin] on one device;
    returns DataBunch(models [nprof, nbin], fitted [nprof] bool, phase
    and scale [nfitted])."""
    fitted = (data_profiles - model_profiles != 0.0).any(dim=-1)
    models = model_profiles.clone()
    idx = torch.nonzero(fitted)[:, 0]
    phase = scale = models.new_zeros(0)
    if len(idx):
        r = fit_phase_shift(data_profiles[idx], model_profiles[idx],
                            Ns=100, device=data_profiles.device)
        phase, scale = r.phase, r.scale
        models[idx] = scale[:, None] * rotate_data(model_profiles[idx],
                                                   -phase)
    return DataBunch(models=models, fitted=fitted, phase=phase, scale=scale)


def zap_hist(channel_red_chi2s, rchi2_threshold):
    """``ppzap --hist``'s numbers from GetTOAs.channel_red_chi2s (host
    lists): the flattened reduced chi2s with NaN as 0, and how many
    exceed ``rchi2_threshold``."""
    red_chi2s = np.nan_to_num(np.array(
        [c for arch in channel_red_chi2s for s in arch for c in s]))
    return red_chi2s, int(np.sum(red_chi2s > rchi2_threshold))
