"""Instrumental response Fourier kernels (smearing / binning / averaging).

Port of the JAX package's ``ops/instrumental.py`` (reference
pptoaslib.py:112-179), in complex128 on the device of the frequencies.
"""

import torch

from ..config import real_dtype
from .profiles import gaussian_profile_FT

__all__ = ["instrumental_response_FT", "instrumental_response_port_FT"]


def instrumental_response_FT(nbin, wid=0.0, irf_type="rect", device="cpu"):
    """rFFT [nbin/2+1] of a unit-area instrumental response of width
    ``wid`` [rot]: 'rect' gives sinc(k wid), 'gauss' a Gaussian FT
    normalized to 1 at k = 0; wid = 0 gives ones (reference
    pptoaslib.py:112-143)."""
    nharm = nbin // 2 + 1
    k = torch.arange(nharm, dtype=real_dtype, device=device)
    if irf_type == "rect":
        resp = torch.sinc(k * wid).to(torch.complex128)
    elif irf_type == "gauss":
        gp_FT = gaussian_profile_FT(nbin, 0.0, wid, 1.0, device=device)
        resp = gp_FT / gp_FT[0]
    else:
        raise ValueError(f"Unrecognized instrumental response type "
                         f"'{irf_type}'.")
    if wid == 0.0:
        return torch.ones(nharm, dtype=torch.complex128, device=device)
    return resp


def instrumental_response_port_FT(nbin, freqs, DM=0.0, P=1.0, wids=(),
                                  irf_types=()):
    """Combined per-channel instrumental response FT [nchan, nbin/2+1]:
    the constant-width responses in ``wids``/``irf_types`` times, when DM
    is nonzero, the DM-smearing rectangle of width 8.3e-6 * chan_bw *
    (nu/GHz)**-3 / P [rot] per channel (reference pptoaslib.py:145-179).

    As in the reference (and the JAX package), DM only switches the
    smearing on: the width omits the factor of DM that Bhat et al. (2003)
    have.  Callers wanting the physical width fold DM into ``wids``."""
    freqs = torch.as_tensor(freqs, dtype=real_dtype)
    dev = freqs.device
    nchan = freqs.shape[0]
    nharm = nbin // 2 + 1
    out = torch.ones((nchan, nharm), dtype=torch.complex128, device=dev)
    for wid, irf_type in zip(wids, irf_types):
        out = out * instrumental_response_FT(nbin, wid, irf_type,
                                             device=dev)[None, :]
    if DM:
        # one channel: the reference's freqs[1] reads freqs[0] (a clamped
        # index), so the width is 0
        chan_bw = torch.abs(freqs[min(1, nchan - 1)] - freqs[0])
        smear_wids = 8.3e-6 * chan_bw / (freqs / 1e3) ** 3 / P
        k = torch.arange(nharm, dtype=real_dtype, device=dev)
        out = out * torch.sinc(k[None, :] * smear_wids[:, None])
    return out
