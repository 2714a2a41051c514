"""Synthetic data factory: fake-pulsar portraits in memory, on a device.

Port of the JAX package's ``pipelines/synth.py`` (reference
pplib.py:1146-1174 ``add_scintillation`` and the per-subint synthesis
loop of ``make_fake_pulsar``, pplib.py:3330-3384).  Every random draw
comes from an explicit generator, never a global one:

* the white noise, and the phases and dDMs that are not given, from a
  ``torch.Generator`` on the portraits' device;
* the scintillation triplets (amplitude ~ U[0, amax], frequency ~
  chi2(wmax), phase ~ U[0, 1]; 3 nsin scalars per portrait) from a numpy
  ``Generator`` — ``torch.distributions.Gamma`` takes no generator, and
  the port's ``make_fake_pulsar`` draws its noise from numpy as well.

The draws therefore differ from the JAX package's ``jax.random`` ones;
with explicit scintillation triplets and no noise the portraits are the
same.
"""

import math

import numpy as np
import torch

from ..config import Dconst, real_dtype, resolve_device, scattering_alpha
from ..ops.fourier import get_bin_centers, rotate_data
from ..ops.profiles import gen_gaussian_portrait
from ..ops.scattering import scattering_portrait_FT, scattering_times
from ..utils.databunch import DataBunch

__all__ = ["scintillation_params", "add_scintillation", "make_fake_portrait",
           "make_fake_dataset"]

# bytes of one block of subints made at a time by make_fake_dataset: the
# rotation's and the noise's transients are ~5 blocks, so the peak stays
# near the output's size plus ~1.5 GB
BLOCK_BYTES = 1 << 28


def _linspace(start, stop, num, device):
    """jnp.linspace's arithmetic: start (1 - i/div) + stop i/div, the
    endpoint set exactly (one point: ``start``)."""
    if num == 1:
        return torch.full((1,), start, dtype=real_dtype, device=device)
    step = torch.arange(num - 1, dtype=real_dtype, device=device) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step,
                      torch.full((1,), stop, dtype=real_dtype,
                                 device=device)])


def scintillation_params(rng, nsin=2, amax=1.0, wmax=3.0, size=()):
    """Random scintillation triplets from the numpy Generator ``rng``:
    [*size, 3 nsin] flat (amp, freq [cycles], phase [cycles]) triplets,
    amp ~ U[0, amax], freq ~ chi2(wmax), phase ~ U[0, 1]."""
    shape = tuple(size) + (nsin,)
    a = rng.uniform(0.0, amax, shape)
    w = rng.chisquare(wmax, shape)
    p = rng.uniform(0.0, 1.0, shape)
    return np.stack([a, w, p], axis=-1).reshape(tuple(size) + (3 * nsin,))


def add_scintillation(port, params=None, rng=None, nsin=2, amax=1.0,
                      wmax=3.0):
    """Multiply the channels of ``port`` [..., nchan, nbin] by a sum of
    sin^2 fake scintillation pattern (reference pplib.py:1146-1174).

    ``params``: flat triplets (amp, freq [cycles], phase [cycles]),
    [3 nsin] or one row per leading index of ``port``; if None, the numpy
    Generator ``rng`` draws nsin triplets (scintillation_params); with
    neither, ``port`` is returned as it is."""
    port = torch.as_tensor(port, dtype=real_dtype)
    if params is None:
        if rng is None:
            return port
        params = scintillation_params(rng, nsin, amax, wmax)
    trip = torch.as_tensor(np.asarray(params), dtype=real_dtype,
                           device=port.device)
    trip = trip.reshape(trip.shape[:-1] + (-1, 3))
    a, w, p = trip[..., 0, None], trip[..., 1, None], trip[..., 2, None]
    x = _linspace(0.0, math.pi, port.shape[-2], port.device)
    pattern = torch.sum(a * torch.sin(w * x + p * math.pi) ** 2, dim=-2)
    return port * pattern[..., :, None]


def _synthesize(model, freqs, P, phases, DMs, nu_dm, scat_FT, scint_params,
                scales, noise_std, generator, weights):
    """Portraits [B, nchan, nbin] of ``model`` rotated by -phases, -DMs
    [B] (a delayed, dispersed pulse), scattered by ``scat_FT``,
    scintillated by ``scint_params`` [B, 3 nsin], scaled, with white noise
    from ``generator`` and weighted — the reference's per-subint loop."""
    B = phases.shape[0]
    nchan, nbin = model.shape
    port = rotate_data(model.expand(B, nchan, nbin), -phases[:, None],
                       -DMs[:, None], P, freqs, nu_dm)
    if scat_FT is not None:
        port = torch.fft.irfft(scat_FT * torch.fft.rfft(port, dim=-1),
                               n=nbin, dim=-1)
    if scint_params is not None:
        port = add_scintillation(port, params=scint_params)
    port = port * scales[:, None]
    if generator is not None:
        port = port + noise_std[:, None] * torch.randn(
            port.shape, generator=generator, dtype=real_dtype,
            device=port.device)
    if weights is not None:
        port = port * weights[:, None]
    return port


def _per_channel(x, nchan, device):
    return torch.broadcast_to(torch.as_tensor(x, dtype=real_dtype,
                                              device=device), (nchan,))


def make_fake_portrait(model_params, nchan, nbin, freqs, P, *,
                       model_code="000", nu_ref=None,
                       scattering_index=scattering_alpha, phase=0.0, DM=0.0,
                       t_scat=0.0, scint=False, scint_params=None,
                       noise_std=0.0, scales=1.0, weights=None,
                       generator=None, rng=None, nu_dm=math.inf,
                       device=None):
    """One synthetic [nchan, nbin] portrait with injected parameters
    (the JAX package's make_fake_portrait; reference pplib.py:3330-3384).

    model_params: the Gaussian portrait vector of gen_gaussian_portrait.
    phase [rot] and DM inject a rotation referred to ``nu_dm``; t_scat
    [s] scatters (power law ``scattering_index``, referred to nu_ref);
    ``scint`` True draws three triplets (amax 1, wmax 5) from the numpy
    Generator ``rng``, any other value but False applies
    ``scint_params``; scales multiplies the channels (scalar or
    [nchan]); white noise of ``noise_std`` (scalar or [nchan]) is drawn
    from ``generator`` when one is given; ``weights`` [nchan] multiplies
    last.  Runs on ``device`` (CUDA unless "cpu" is asked for)."""
    device = resolve_device(device)
    freqs = torch.as_tensor(freqs, dtype=real_dtype, device=device)
    if nu_ref is None:
        nu_ref = float(freqs.mean())
    model = gen_gaussian_portrait(model_code, model_params,
                                  scattering_index, get_bin_centers(nbin),
                                  freqs, nu_ref, device=device)
    scat_FT = None
    if t_scat:
        scat_FT = scattering_portrait_FT(scattering_times(
            t_scat / P, scattering_index, freqs, nu_ref), nbin)
    params = None
    if scint is True:
        if rng is None:
            raise ValueError("scint=True draws from rng: pass a numpy "
                             "Generator")
        params = scintillation_params(rng, nsin=3, amax=1.0, wmax=5.0)[None]
    elif scint is not False:
        params = np.asarray(scint_params)[None]
    one = torch.ones(1, dtype=real_dtype, device=device)
    return _synthesize(
        model, freqs, P, one * phase, one * DM, nu_dm, scat_FT, params,
        _per_channel(scales, nchan, device), _per_channel(noise_std, nchan,
                                                          device),
        generator, None if weights is None else torch.as_tensor(
            weights, dtype=real_dtype, device=device))[0]


def make_fake_dataset(generator, model_params, *, nsub=10, nchan=64,
                      nbin=512, lofreq=1300.0, bw=800.0, P=0.005,
                      model_code="000", scattering_index=scattering_alpha,
                      nu_ref=None, phases=None, dDMs=None, DM0=30.0,
                      noise_std=0.1, t_scat=0.0, scint=False, device=None):
    """A batch of synthetic subints with known injected (phase, dDM)
    (the JAX package's make_fake_dataset).

    ``generator``: a torch.Generator on ``device`` (CUDA unless "cpu" is
    asked for); it draws the phases (U[-0.4, 0.4)) and dDMs (normal, a
    5e-4 rot spread across the band) that are not given, then each
    block's noise.  ``scint=True`` draws three triplets per subint from
    a numpy Generator seeded with the generator's seed.  Channel centres
    span [lofreq, lofreq + bw] (reference examples/example.py:18-28).
    Subints are made in blocks of about 256 MB, so the peak device memory
    is the result plus ~1.5 GB.

    Returns a DataBunch with the JAX package's fields: subints [nsub,
    nchan, nbin], freqs, weights, noise_stds, Ps, nu_ref, nbin,
    phases_inj, dDMs_inj, DM0, model_code, model_params."""
    device = resolve_device(device)
    if torch.device(generator.device).type != device.type:
        raise ValueError("generator is on %s, the data on %s"
                         % (generator.device, device))
    chan_bw = bw / nchan
    freqs = lofreq + chan_bw * (torch.arange(nchan, dtype=real_dtype,
                                             device=device) + 0.5)
    if nu_ref is None:
        nu_ref = float(freqs.mean())
    if phases is None:
        phases = torch.rand(nsub, generator=generator, dtype=real_dtype,
                            device=device) * 0.8 - 0.4
    else:
        phases = torch.broadcast_to(torch.as_tensor(
            phases, dtype=real_dtype, device=device), (nsub,))
    if dDMs is None:
        fmin, fmax = float(freqs.min()), float(freqs.max())
        dDMs = torch.randn(nsub, generator=generator, dtype=real_dtype,
                           device=device) * (
            5e-4 * P / (Dconst * (fmin ** -2 - fmax ** -2)))
    else:
        dDMs = torch.broadcast_to(torch.as_tensor(
            dDMs, dtype=real_dtype, device=device), (nsub,))
    scint_params = None
    if scint is True:
        scint_params = scintillation_params(
            np.random.default_rng(generator.initial_seed()), nsin=3,
            amax=1.0, wmax=5.0, size=(nsub,))
    model = gen_gaussian_portrait(model_code, model_params,
                                  scattering_index, get_bin_centers(nbin),
                                  freqs, nu_ref, device=device)
    scat_FT = None
    if t_scat:
        scat_FT = scattering_portrait_FT(scattering_times(
            t_scat / P, scattering_index, freqs, nu_ref), nbin)
    scales = torch.ones(nchan, dtype=real_dtype, device=device)
    noise = torch.full((nchan,), noise_std, dtype=real_dtype, device=device)
    subints = torch.empty((nsub, nchan, nbin), dtype=real_dtype,
                          device=device)
    block = max(1, BLOCK_BYTES // (nchan * nbin * 8))
    for i in range(0, nsub, block):
        s = slice(i, i + block)
        subints[s] = _synthesize(
            model, freqs, P, phases[s], dDMs[s], nu_ref, scat_FT,
            None if scint_params is None else scint_params[s], scales,
            noise, generator, None)
    return DataBunch(
        subints=subints, freqs=freqs,
        weights=torch.ones((nsub, nchan), dtype=real_dtype, device=device),
        noise_stds=torch.full((nsub, nchan), noise_std, dtype=real_dtype,
                              device=device),
        Ps=torch.full((nsub,), P, dtype=real_dtype, device=device),
        nu_ref=nu_ref, nbin=nbin, phases_inj=phases, dDMs_inj=dDMs, DM0=DM0,
        model_code=model_code,
        model_params=torch.as_tensor(model_params, dtype=real_dtype,
                                     device=device))
