"""Weighted statistics helpers.

Port of the JAX package's ``ops/stats.py`` (reference pplib.py:686-750:
``count_crossings``, ``weighted_mean``, ``get_WRMS``, ``get_red_chi2``).
Every function is mask-based (errs <= 0 excludes a point), so it stays
dense over a batch instead of compressing indices, and runs on the
device of its input.
"""

import torch

from ..config import real_dtype
from .noise import get_noise

__all__ = ["count_crossings", "weighted_mean", "get_WRMS", "get_red_chi2",
           "median"]


def _tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(real_dtype)
    return torch.as_tensor(x, dtype=real_dtype, device=device)


def _weights(data, errs):
    errs = torch.broadcast_to(_tensor(errs, data.device).to(data.dtype),
                              data.shape)
    ok = errs > 0.0
    return torch.where(ok, torch.where(ok, errs, torch.ones_like(errs))
                       ** -2.0, torch.zeros_like(errs))


def count_crossings(x, x0):
    """Number of crossings of 1-D array x across threshold x0
    (reference pplib.py:686-694)."""
    d = _tensor(x) - x0
    return (torch.diff(torch.sign(d)) != 0).sum() - (d == 0).sum()


def weighted_mean(data, errs=1.0, dim=None):
    """Weighted mean and its standard error; weights are errs**-2, and
    points with errs <= 0 are excluded (reference pplib.py:696-709).
    ``dim``: reduce along that axis only (a batch of weighted means);
    None reduces everything, as the reference does."""
    data = _tensor(data)
    w = _weights(data, errs)
    if dim is None:
        wsum = w.sum()
        return (data * w).sum() / wsum, wsum ** -0.5
    wsum = w.sum(dim=dim)
    return (data * w).sum(dim=dim) / wsum, wsum ** -0.5


def get_WRMS(data, errs=1.0):
    """Weighted root-mean-square (reference pplib.py:711-725)."""
    data = _tensor(data)
    w = _weights(data, errs)
    mean = (data * w).sum() / w.sum()
    return torch.sqrt(((data - mean) ** 2 * w).sum() / w.sum())


def get_red_chi2(data, model, errs=None, dof=None):
    """Reduced chi-squared of data vs model [..., nbin] (1- or 2-D);
    errs broadcast per channel, estimated with get_noise when None; dof
    defaults to sum(data.shape), as the reference's (pplib.py:727-750)."""
    data = _tensor(data)
    resids = data - _tensor(model, data.device)
    errs = get_noise(data) if errs is None else _tensor(errs, data.device)
    if dof is None:
        dof = sum(data.shape)
    if data.ndim == 1:
        return torch.sum((resids / errs) ** 2) / dof
    return torch.sum((resids / errs[..., None]) ** 2) / dof


def median(x):
    """Median over the last axis as numpy (and the JAX package) take it:
    the mean of the two middle values for an even count (torch.median
    returns the lower one)."""
    x = _tensor(x)
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    if n % 2:
        return s[..., n // 2]
    return (s[..., n // 2 - 1] + s[..., n // 2]) * 0.5
