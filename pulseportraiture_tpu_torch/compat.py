"""Carry the JAX reference package's numpy outputs into the port.

The port's only "parameters" are the model portrait and the fit inputs,
so moving state across is a matter of turning arrays into tensors:
``from_reference`` takes a load_data DataBunch, a result dict, a model
portrait or an init_params array — as numpy (the reference's arrays go
through ``np.asarray`` first) — and returns the same structure with every
numeric array a tensor on ``device``.  Lists, MJDs, strings and scalars
pass through unchanged.  This module imports nothing of the JAX package.
"""

import numpy as np
import torch

from .config import resolve_device
from .utils.databunch import DataBunch

__all__ = ["from_reference"]


def _convert(value, device):
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, np.ndarray) and value.dtype.kind in "biufc":
        value = np.ascontiguousarray(value)
        if not value.flags.writeable:
            value = value.copy()
        return torch.from_numpy(value).to(device)
    return value


def from_reference(bunch_or_dict, device=None):
    """numpy arrays -> tensors on ``device`` (None = the CUDA device).

    A plain dict comes back as a dict and any other mapping (the
    reference's DataBunch) as the port's DataBunch, converted field by
    field; anything else is converted as one value."""
    device = resolve_device(device)
    obj = bunch_or_dict
    if isinstance(obj, dict):
        out = {k: _convert(v, device) for k, v in obj.items()}
        return out if type(obj) is dict else DataBunch(**out)
    return _convert(np.asarray(obj) if isinstance(obj, (list, tuple))
                    else obj, device)
