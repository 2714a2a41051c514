"""Sharded batched portrait fits over a device mesh (port of the JAX
package's ``parallel/sharded_fit.py``).

The batched 5-parameter fit (fit/portrait.py) scales out by placing its
inputs on a ('subint', 'chan', 'bin') mesh (parallel/mesh.py): each
subint group is solved on its lead device, the hand kernels K1 / K3 run
on every channel shard, and their per-channel outputs are gathered before
the channel sums, so a sharded fit gives the unsharded fit's numbers.
The reference partitions one XLA program with GSPMD; the port keeps one
controller and makes the gathers explicit.  The TPU-only ``pair`` path
has no counterpart.
"""

import numpy as np
import torch

from ..fit.portrait import fit_portrait_full_batch
from .mesh import make_mesh

__all__ = ["sharded_fit_portrait_batch", "ipta_sweep_fit"]


def _shape(x):
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _broadcast(x, shape):
    """``x`` (tensor or array-like) broadcast to ``shape``, a view."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x, shape)
    return np.broadcast_to(np.asarray(x), shape)


def sharded_fit_portrait_batch(mesh, data_ports, model_ports, init_params,
                               Ps, freqs, errs=None, weights=None,
                               fit_flags=(1, 1, 0, 0, 0), nu_fits=None,
                               nu_outs=None, bounds=None, log10_tau=False,
                               max_iter=50, kmax=None):
    """Run fit_portrait_full_batch with inputs sharded on ``mesh``.

    data_ports [B, nchan, nbin] is split over ('subint', 'chan', 'bin');
    the batch size B must divide by the mesh's subint axis, nchan by its
    chan axis, and nbin by its bin axis (ValueError otherwise).  The model
    is broadcast to the data's shape, init_params to [B, 5], Ps to [B],
    freqs [nchan] to [B, nchan], errs and weights to [B, nchan].  Returns
    the DataBunch of the whole batch on the mesh's first device; the
    per-channel fields (scales, scale_errs, channel_snrs) are assembled
    along channels.
    """
    shape = _shape(data_ports)
    B = shape[0]
    model_ports = _broadcast(model_ports, shape)
    if not isinstance(init_params, torch.Tensor):
        init_params = np.asarray(init_params, np.float64)
    init_params = _broadcast(init_params, (B, 5))
    Ps = _broadcast(Ps, (B,))
    if len(_shape(freqs)) == 1:
        freqs = _broadcast(freqs, (B, _shape(freqs)[0]))
    if errs is not None:
        errs = _broadcast(errs, shape[:-1])
    if weights is not None:
        weights = _broadcast(weights, shape[:-1])
    return fit_portrait_full_batch(
        data_ports, model_ports, init_params, Ps, freqs, errs=errs,
        weights=weights, fit_flags=fit_flags, nu_fits=nu_fits,
        nu_outs=nu_outs, bounds=bounds, log10_tau=log10_tau,
        max_iter=max_iter, kmax=kmax, mesh=mesh)


def ipta_sweep_fit(data_ports, model_ports, init_params, Ps, freqs,
                   errs=None, weights=None, fit_flags=(1, 1, 0, 0, 0),
                   n_chan_shards=1, n_bin_shards=1, devices=None, **kw):
    """IPTA-scale sweep: [npulsar, nepoch, ..., nchan, nbin] batch sharded
    over ``devices`` (every visible CUDA device by default; BASELINE.md's
    '20 pulsars x 10 epochs' configuration).

    Flattens any leading (pulsar, epoch) structure into the subint axis;
    callers reshape the stacked outputs back.
    """
    mesh = make_mesh(n_chan=n_chan_shards, n_bin=n_bin_shards,
                     devices=devices)
    data = data_ports if isinstance(data_ports, torch.Tensor) \
        else np.asarray(data_ports)
    B = int(np.prod(data.shape[:-2]))
    data = data.reshape((B,) + tuple(data.shape[-2:]))

    def rows(x):
        if x is None:
            return None
        return (x if isinstance(x, torch.Tensor) else np.asarray(x)
                ).reshape(B, -1)

    return sharded_fit_portrait_batch(
        mesh, data, model_ports, init_params, Ps, freqs, errs=rows(errs),
        weights=rows(weights), fit_flags=fit_flags, **kw)
