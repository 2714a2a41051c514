"""Plotting suite: portrait/model/residual/eigenprofile visualization.

Port of the JAX package's ``viz`` (reference pplib.py:3511-4052,
ppspline.py:232-275, pptoas.py:1280-1412): the portrait image with
profile/spectrum side panels, the data/model/residual triptych with the
channel reduced-chi2 histogram, eigenprofile stacks and spline-curve
coordinate projections, with the JAX package's layouts, titles, labels
and bins.

The numbers a figure needs from the device — the fitted subint, the
channel reduced chi2s, the stacked profiles' FFTFIT — come from
``viz.figdata`` on the device of the tensors given (or ``device``; None
= the CUDA device for host arrays, as everywhere in the port); arrays go
to host numpy only to be drawn, so tensors on the card may be handed in
directly.  matplotlib is imported at the first draw, not with this
module, and with no display the Agg backend renders straight to PNG.
"""

import functools
import os

import numpy as np
import torch

from ..config import real_dtype, resolve_device
from . import figdata

__all__ = ["set_colormap", "show_portrait", "show_profiles",
           "show_stacked_profiles", "show_residual_plot",
           "show_eigenprofiles", "show_spline_curve_projections",
           "show_model_fit", "show_data_portrait", "show_subint",
           "show_fit"]


@functools.cache
def _pyplot():
    """matplotlib.pyplot, after the JAX package's import-time backend
    choice (made once, at the first draw): Agg when no display is set."""
    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device(device, x):
    """Where a figure's numbers are computed: ``device`` if given, else
    the device of ``x`` if it is a tensor, else the CUDA device."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def _tensor(x, device):
    return torch.as_tensor(x, dtype=real_dtype).to(device)


def set_colormap(colormap):
    """Set the default image colormap and recolor the current image, if
    any (ref pplib.py:656-669).  Validates before mutating state."""
    plt = _pyplot()
    plt.set_cmap(colormap)  # validates the name, sets rcParams + gci
    return plt.get_cmap(colormap)


def _finish(fig, savefig, show):
    plt = _pyplot()
    if savefig:
        fig.savefig(savefig, format="png", dpi=110,
                    bbox_inches="tight")
        plt.close(fig)
        return savefig
    if show:
        plt.show()
    return fig


def show_portrait(port, phases=None, freqs=None, title=None, prof=True,
                  fluxprof=True, rvrsd=False, colorbar=True, savefig=False,
                  show=True, aspect="auto", interpolation="none",
                  origin="lower", extent=None, **kwargs):
    """Portrait image with optional average-profile and flux-spectrum
    side panels (ref pplib.py:3511-3616)."""
    plt = _pyplot()
    port = _host(port)
    if freqs is None:
        freqs = np.arange(len(port))
        ylabel = "Channel Number"
    else:
        freqs = _host(freqs)
        ylabel = "Frequency [MHz]"
    if phases is None:
        phases = np.arange(port.shape[-1])
        xlabel = "Bin Number"
    else:
        phases = _host(phases)
        xlabel = "Phase [rot]"
    if rvrsd:
        freqs = freqs[::-1]
        port = port[::-1]
    if extent is None:
        extent = (phases[0], phases[-1], freqs[0], freqs[-1])
    weights = port.mean(axis=1)
    live = weights != 0.0

    nrows = 1 + int(bool(prof))
    ncols = 1 + int(bool(fluxprof))
    fig, axes = plt.subplots(
        nrows, ncols, squeeze=False, figsize=(8.0, 6.0),
        gridspec_kw=dict(
            height_ratios=([1, 4] if prof else [1]),
            width_ratios=([1, 4] if fluxprof else [1])),
        constrained_layout=True)
    ax_im = axes[-1, -1]
    im = ax_im.imshow(port, aspect=aspect, origin=origin, extent=extent,
                      interpolation=interpolation, **kwargs)
    if colorbar:
        fig.colorbar(im, ax=ax_im)
    ax_im.set_xlabel(xlabel)
    if prof:
        axes[0, -1].plot(phases, port[live].mean(axis=0), "k-")
        axes[0, -1].set_xlim(phases.min(), phases.max())
        axes[0, -1].set_ylabel("Flux Units")
        axes[0, -1].set_xticklabels(())
    if fluxprof:
        axes[-1, 0].plot(weights[live], freqs[live], "kx")
        axes[-1, 0].set_ylim(ax_im.get_ylim())
        axes[-1, 0].invert_xaxis()
        axes[-1, 0].set_xlabel("Flux Units")
        axes[-1, 0].set_ylabel(ylabel)
        ax_im.set_yticklabels(())
    else:
        ax_im.set_ylabel(ylabel)
    if prof and fluxprof:
        axes[0, 0].axis("off")
    if title:
        fig.suptitle(title)
    return _finish(fig, savefig, show)


def show_profiles(model, phases=None, cmap=None, s=1, offset=None, ax=None,
                  **kwargs):
    """Stacked profiles colored by amplitude — 'joy division' model view
    (ref pplib.py:3683-3706)."""
    plt = _pyplot()
    model = _host(model)
    if cmap is None:
        cmap = plt.cm.Spectral
    if phases is None:
        phases = (np.arange(model.shape[-1]) + 0.5) / model.shape[-1]
    else:
        phases = _host(phases)
    rng = model.max() - model.min()
    if offset is None:
        offset = rng / float(len(model))
    if ax is None:
        ax = plt.gca()
    for iprof, p in enumerate(model):
        c = cmap((p - model.min()) / rng)
        ax.scatter(phases, p + offset * iprof, c=c, edgecolor="none", s=s,
                   **kwargs)
    return ax


def show_stacked_profiles(data_profiles, model_profiles=None, phases=None,
                          freqs=None, rvrsd=False, fit=False, title=None,
                          fact=0.25, savefig=False, show=True, device=None):
    """Stacked, offset data profiles with optional overlaid models
    (ref pplib.py:3618-3681).  With ``fit``, each model that differs
    from its data is scaled and rotated onto it by FFTFIT, every such
    profile in one call (figdata.stacked_fits) on ``device``."""
    plt = _pyplot()
    if model_profiles is None:
        model_profiles = data_profiles
    elif fit:
        dev = _device(device, data_profiles)
        model_profiles = figdata.stacked_fits(
            _tensor(data_profiles, dev),
            _tensor(model_profiles, dev)).models
    data_profiles = _host(data_profiles)
    model_profiles = _host(model_profiles)
    if phases is None:
        phases = np.arange(data_profiles.shape[-1])
        xlabel = "Bin Number"
    else:
        phases = _host(phases)
        xlabel = "Phase [rot]"
    if freqs is None:
        freqs = np.arange(len(data_profiles))
        ylabel = "Approx. Channel Number"
    else:
        ylabel = "Approx. Frequency [MHz]"
    freqs = _host(freqs)
    if rvrsd:
        freqs = freqs[::-1]
        data_profiles = data_profiles[::-1]
        model_profiles = model_profiles[::-1]
    fig, ax = plt.subplots()
    off = (data_profiles.max() - data_profiles.min()) * fact
    for iprof, dprof in enumerate(data_profiles):
        m, = ax.plot(phases, model_profiles[iprof] + iprof * off, lw=2,
                     ls="dashed")
        ax.plot(phases, dprof + iprof * off, lw=2, ls="solid",
                color=m.get_color())
    ax.set_xlabel(xlabel)
    ax.set_yticks(np.arange(len(data_profiles))[::10] * off)
    ax.set_yticklabels([str(int(round(f))) for f in freqs[::10]])
    ax.set_ylabel(ylabel)
    if title is not None:
        ax.set_title(title)
    return _finish(fig, savefig, show)


def show_residual_plot(port, model, resids=None, phases=None, freqs=None,
                       noise_stds=None, nfit=0, titles=(None, None, None),
                       rvrsd=False, colorbar=True, savefig=False, show=True,
                       aspect="auto", interpolation="none", origin="lower",
                       extent=None, device=None, **kwargs):
    """Data/model/residual triptych + channel reduced-chi2 histogram
    (ref pplib.py:3708-3829).  The live channels' noise (get_noise of
    each, unless ``noise_stds`` is given) and reduced chi2s are one
    batched reduction (figdata.residual_payload) on ``device``; the
    figure keeps the chi2s as ``fig.pp_rchi2`` (numpy)."""
    plt = _pyplot()
    dev = _device(device, port)
    port_t, model_t = _tensor(port, dev), _tensor(model, dev)
    noise_t = None if noise_stds is None else _tensor(noise_stds, dev)
    port, model = _host(port), _host(model)
    if freqs is None:
        freqs = np.arange(len(port))
        ylabel = "Channel Number"
    else:
        freqs = _host(freqs)
        ylabel = "Frequency [MHz]"
    if phases is None:
        phases = np.arange(port.shape[-1])
        xlabel = "Bin Number"
    else:
        phases = _host(phases)
        xlabel = "Phase [rot]"
    if resids is None:
        resids = port - model
    else:
        resids = _host(resids)
    if rvrsd:
        freqs = freqs[::-1]
        port, model, resids = port[::-1], model[::-1], resids[::-1]
        port_t, model_t = port_t.flip(0), model_t.flip(0)
        if noise_t is not None:
            noise_t = noise_t.flip(0)
    if extent is None:
        extent = (phases[0], phases[-1], freqs[0], freqs[-1])

    fig, axes = plt.subplots(2, 2, figsize=(8.5, 6.67),
                             constrained_layout=True)
    panels = [(axes[0, 0], port, titles[0] or "Data"),
              (axes[0, 1], model, titles[1] or "Model"),
              (axes[1, 0], resids, titles[2] or "Residuals")]
    clim = None
    for ax, arr, ttl in panels:
        im = ax.imshow(arr, aspect=aspect, origin=origin, extent=extent,
                       interpolation=interpolation,
                       **(dict(kwargs, vmin=clim[0], vmax=clim[1])
                          if clim else kwargs))
        if clim is None:
            clim = im.get_clim()
        if colorbar:
            fig.colorbar(im, ax=ax)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_title(ttl)

    ax4 = axes[1, 1]
    rchi2 = _host(figdata.residual_payload(port_t, model_t, noise_t,
                                           nfit).rchi2)
    fig.pp_rchi2 = rchi2  # numerical payload, for tests/inspection
    ax4.hist(rchi2, bins=figdata.RCHI2_BINS, histtype="step", color="k")
    if len(rchi2) and rchi2.min() > 0 and \
            np.log10(rchi2.max() / rchi2.min()) > 2:
        ax4.semilogx()
    ax4.set_xlim(0.9 * rchi2.min(), 1.1 * rchi2.max())
    ax4.set_xlabel(r"Red. $\chi^2$")
    ax4.set_ylabel("# chans. (total = %d)" % len(rchi2))
    ax4.set_title(r"Channel Reduced $\chi^2$")
    return _finish(fig, savefig, show)


def show_eigenprofiles(eigprofs=None, smooth_eigprofs=None, mean_prof=None,
                       smooth_mean_prof=None, ncomp=None, title=None,
                       savefig=False, show=True):
    """Stack of mean profile + eigenprofiles, raw and smoothed
    (ref pplib.py:3970-4052; ppspline.py:232-258).  The first argument
    may also be a DataPortrait with a built spline model."""
    plt = _pyplot()
    if hasattr(eigprofs, "spline_model"):  # a (Spline)DataPortrait
        sm = eigprofs.spline_model
        eigprofs = _host(sm.eigvec).T
        mean_prof = _host(sm.mean_prof)
        smooth_eigprofs = smooth_mean_prof = None
    rows = []
    if mean_prof is not None:
        rows.append(("Mean profile", np.atleast_2d(_host(mean_prof)),
                     None if smooth_mean_prof is None
                     else np.atleast_2d(_host(smooth_mean_prof))))
    if eigprofs is not None:
        eigprofs = np.atleast_2d(_host(eigprofs))
        if ncomp is not None:
            eigprofs = eigprofs[:ncomp]
        sm = None if smooth_eigprofs is None else \
            np.atleast_2d(_host(smooth_eigprofs))[:len(eigprofs)]
        for i, e in enumerate(eigprofs):
            rows.append(("Eigenprofile %d" % (i + 1), e[None],
                         None if sm is None else sm[i][None]))
    fig, axes = plt.subplots(len(rows), 1, sharex=True, squeeze=False,
                             figsize=(6.0, 1.8 * len(rows)),
                             constrained_layout=True)
    for iax, (label, raw, smooth) in enumerate(rows):
        ax = axes[iax, 0]
        nbin = raw.shape[-1]
        x = (np.arange(nbin) + 0.5) / nbin
        ax.plot(x, raw[0], "k-", lw=1, alpha=0.7)
        if smooth is not None:
            ax.plot(x, smooth[0], "r-", lw=1.5)
        ax.set_ylabel(label, fontsize=8)
    axes[-1, 0].set_xlabel("Phase [rot]")
    if title:
        fig.suptitle(title)
    return _finish(fig, savefig, show)


def show_spline_curve_projections(projected_port, tck=None, freqs=None,
                                  weights=None, ncoord=None, icoord=None,
                                  title=None, savefig=False, show=True):
    """Projected-coordinate-vs-frequency panels with the fitted B-spline
    curve overlaid (ref pplib.py:3831-3968, the per-frequency view).
    The first argument may also be a DataPortrait with a built spline
    model."""
    from scipy import interpolate as si

    plt = _pyplot()
    if hasattr(projected_port, "spline_model"):  # a (Spline)DataPortrait
        dp = projected_port
        sm = dp.spline_model
        projected_port = sm.proj_port
        tck = sm.tck
        freqs = dp.freqsxs[0]
    projected_port = np.atleast_2d(_host(projected_port))
    freqs = _host(freqs)
    nprof, ndim = projected_port.shape
    coords = [icoord] if icoord is not None else \
        list(range(min(ncoord or ndim, ndim)))
    interp_freqs = np.linspace(freqs.min(), freqs.max(), nprof * 10)
    curve = np.atleast_2d(np.array(si.splev(interp_freqs, tck, der=0,
                                            ext=0)))
    knots = np.atleast_2d(np.array(si.splev(tck[0], tck, der=0, ext=0)))
    if weights is None:
        ms = np.full(nprof, 4.0)
    else:
        w = np.asarray(_host(weights), dtype=float)
        ms = 5.0 + 10.0 * (w - w.min()) / max(np.ptp(w), 1e-30)
    fig, axes = plt.subplots(len(coords), 1, sharex=True, squeeze=False,
                             figsize=(6.0, 2.2 * len(coords)),
                             constrained_layout=True)
    for iax, ic in enumerate(coords):
        ax = axes[iax, 0]
        for iprof in range(nprof):
            ax.plot(freqs[iprof], projected_port[iprof, ic], "o",
                    color="purple", ms=ms[iprof],
                    alpha=0.25 + 0.75 * iprof / max(nprof - 1, 1),
                    mew=0.0)
        ax.plot(freqs, projected_port[:, ic], "k-", lw=1)
        ax.plot(interp_freqs, curve[ic], "g-", lw=2)
        ax.plot(np.asarray(tck[0]), knots[ic], "k*", ms=10)
        ax.set_ylabel("Coordinate %d" % (ic + 1))
    axes[-1, 0].set_xlabel("Frequency [MHz]")
    if title:
        fig.suptitle(title)
    return _finish(fig, savefig, show)


def show_model_fit(dp, savefig=False, show=True, **kwargs):
    """Data/model/residual view of a DataPortrait with a built model
    (ref pplib.py:638-649), its statistics on the DataPortrait's
    device."""
    return show_residual_plot(
        dp.portx, dp.modelx, phases=dp.phases, freqs=dp.freqsxs[0],
        noise_stds=dp.noise_stdsxs, titles=("Data", "Model", "Residuals"),
        savefig=savefig, show=show, device=dp.device, **kwargs)


def show_data_portrait(dp, savefig=False, show=True, **kwargs):
    """Portrait view of a DataPortrait (ref pplib.py:617-626)."""
    return show_portrait(dp.portx, phases=dp.phases, freqs=dp.freqsxs[0],
                         title=getattr(dp, "source", None),
                         savefig=savefig, show=show, **kwargs)


def show_subint(gt, ifile=0, isub=0, rotate=0.0, savefig=False, show=True,
                **kwargs):
    """Show one fitted subintegration's portrait
    (ref pptoas.py:1280-1308), fitted on the GetTOAs run's device."""
    f = figdata.fitted_subint(gt, ifile, isub, rotate)
    title = "%s subint %d" % (gt.order[ifile], isub)
    return show_portrait(f.port, freqs=f.freqs, title=title,
                         savefig=savefig, show=show, **kwargs)


def show_fit(gt, ifile=0, isub=0, rotate=0.0, savefig=False, show=True,
             **kwargs):
    """Show one subintegration's fitted data/model/residuals
    (ref pptoas.py:1310-1412), fitted and reduced on the GetTOAs run's
    device."""
    f = figdata.fitted_subint(gt, ifile, isub, rotate)
    return show_residual_plot(
        f.port, f.model, freqs=f.freqs, noise_stds=f.noise_stds,
        nfit=gt.nfit,
        titles=("%s subint %d" % (gt.order[ifile], isub), "Model",
                "Residuals"),
        savefig=savefig, show=show, **kwargs)
