"""Per-channel portrait normalization.

Port of the JAX package's ``ops/normalize.py`` (reference
pplib.py:2462-2507): methods 'mean', 'max', 'prof', 'rms', 'abs'.
All-zero channels pass through unscaled with norm 1 (the reference's
``port[ichan].any()`` guard, as a mask).  Runs on the device of the
portrait; 'prof' fits each channel's scale through FFTFIT (kernel K2 on
the card).
"""

import torch

from ..config import real_dtype

__all__ = ["normalize_portrait", "unnormalize_portrait"]


def normalize_portrait(port, method="rms", weights=None, return_norms=False,
                       noise_method="PS"):
    """Normalize each channel profile of port [..., nchan, nbin].

    'mean': by the profile mean; 'max': by its maximum; 'prof': by the
    fitted scale against the (weighted) mean profile; 'rms': by the noise
    level (get_noise(profile) == 1 after); 'abs': by the 2-norm."""
    from ..fit.phase_shift import fit_phase_shift  # avoid an import cycle
    from .noise import get_noise

    port = torch.as_tensor(port, dtype=real_dtype)
    if method == "mean":
        norms = port.mean(dim=-1)
    elif method == "max":
        norms = port.max(dim=-1).values
    elif method == "rms":
        norms = get_noise(port, method=noise_method)
    elif method == "abs":
        norms = torch.sqrt((port ** 2).sum(dim=-1))
    elif method == "prof":
        nonzero = torch.any(port != 0.0, dim=-1)                # [..., nchan]
        if weights is None:
            w = nonzero.to(port.dtype)
        else:
            w = torch.as_tensor(weights, dtype=real_dtype,
                                device=port.device) * nonzero
        wsum = w.sum(dim=-1)
        mean_prof = ((port * w[..., None]).sum(dim=-2)
                     / torch.where(wsum > 0.0, wsum,
                                   torch.ones_like(wsum))[..., None])
        norms = fit_phase_shift(port, mean_prof[..., None, :],
                                device=port.device).scale
    else:
        raise ValueError(f"Unknown normalize_portrait method '{method}'.")
    ok = torch.any(port != 0.0, dim=-1) & (norms != 0.0)
    safe = torch.where(ok, norms, torch.ones_like(norms))
    norm_port = port / safe[..., None]
    if return_norms:
        return norm_port, safe
    return norm_port


def unnormalize_portrait(norm_port, norm_vals):
    """Invert normalize_portrait given its returned norms (reference
    pplib.py:384-398)."""
    norm_vals = torch.as_tensor(norm_vals, dtype=real_dtype,
                                device=norm_port.device)
    return norm_port * norm_vals[..., None]
