"""B-spline evaluation (de Boor) and spline portrait generation.

Port of the JAX package's ``ops/splines.py`` (reference pplib.py:932-956,
which calls FITPACK's ``si.splev``).  Spline construction stays on the
host (scipy, at model-build time); evaluation is a de Boor recursion in
torch — ``torch.searchsorted`` for the knot intervals and gathers for
the coefficients — so a spline model's portrait is built on the device
of the frequencies it is evaluated at.
"""

import numpy as np
import torch

from ..config import real_dtype
from .fourier import rotate_data

__all__ = ["splev", "gen_spline_portrait", "fft_resample"]


def _f64(a, device):
    """numpy / list / tensor -> float64 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=real_dtype)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)


def _deboor(x, t, c, k):
    """de Boor evaluation of a 1-D B-spline at points x.

    t: knots [n+k+1], c: coefficients (FITPACK zero-pads them to len(t);
    only the first len(t)-k-1 are used), k: degree.  Outside [t[k], t[n]]
    the end polynomial is extrapolated (splev's ext=0)."""
    n = t.shape[0] - k - 1
    # interval index i: t[i] <= x < t[i+1], clamped to [k, n-1]
    i = torch.clamp(torch.searchsorted(t, x, right=True) - 1, k, n - 1)
    d = [c[i - k + j] for j in range(k + 1)]
    for r in range(1, k + 1):
        for j in range(k, r - 1, -1):
            t_lo = t[i - k + j]
            denom = t[i + j - r + 1] - t_lo
            nz = denom != 0.0
            alpha = torch.where(
                nz, (x - t_lo) / torch.where(nz, denom,
                                             torch.ones_like(denom)),
                torch.zeros_like(denom))
            d[j] = (1.0 - alpha) * d[j - 1] + alpha * d[j]
    return d[k]


def splev(x, tck, device=None):
    """Evaluate a (possibly parametric) spline like scipy's si.splev.

    tck = (t, c, k) with c one coefficient array (a scalar spline) or a
    list / 2-D array of per-dimension ones (a parametric curve, as
    si.splprep makes).  Returns [ndim, len(x)] for parametric input,
    else [len(x)], on ``device`` (None: x's device, else the CPU)."""
    t, c, k = tck
    if device is None:
        device = x.device if isinstance(x, torch.Tensor) else "cpu"
    x = torch.atleast_1d(_f64(x, device))
    t, k = _f64(t, device), int(k)
    if isinstance(c, (list, tuple)) or c.ndim == 2:
        return torch.stack([_deboor(x, t, _f64(ci, device), k) for ci in c])
    return _deboor(x, t, _f64(c, device), k)


def fft_resample(port, nbin):
    """Fourier resampling along the last axis (scipy.signal.resample's
    semantics for real input)."""
    port = torch.as_tensor(port, dtype=real_dtype)
    n = port.shape[-1]
    X = torch.fft.rfft(port, dim=-1)
    nh_out = nbin // 2 + 1
    if nbin < n:
        Xr = X[..., :nh_out].clone()
        if nbin % 2 == 0:  # halve the new Nyquist bin: keep its real part
            Xr[..., -1] = Xr[..., -1].real.to(Xr.dtype)
    else:
        Xr = torch.nn.functional.pad(X, (0, nh_out - X.shape[-1]))
    return torch.fft.irfft(Xr, n=nbin, dim=-1) * (nbin / n)


def gen_spline_portrait(mean_prof, freqs, eigvec, tck, nbin=None,
                        device=None):
    """Portrait [nchan, nbin] from the mean profile, eigenprofiles and
    B-spline coefficients: proj = splev(freqs, tck) gives the eigenbasis
    coordinates over frequency and port = proj . eigvec^T + mean_prof.
    A change of nbin resamples with the reference's half-bin shift
    (pplib.py:932-956).  Built on ``device`` (None: freqs' device, else
    the CPU)."""
    if device is None:
        device = freqs.device if isinstance(freqs, torch.Tensor) else "cpu"
    mean_prof = _f64(mean_prof, device)
    freqs = torch.atleast_1d(_f64(freqs, device))
    eigvec = _f64(eigvec, device)
    if eigvec.shape[1] == 0:
        port = mean_prof.repeat(freqs.shape[0], 1)
    else:
        proj_port = splev(freqs, tck).T          # [nchan, neig]
        port = proj_port @ eigvec.T + mean_prof
    if nbin is not None and nbin != mean_prof.shape[-1]:
        shift = 0.5 * (1.0 / nbin - 1.0 / mean_prof.shape[-1])
        port = rotate_data(fft_resample(port, nbin), shift)
    return port
