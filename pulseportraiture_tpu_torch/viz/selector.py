"""Interactive Gaussian-component picker (optional matplotlib GUI).

Port of the JAX package's ``viz/selector.py`` (the reference's
hand-fitting GaussianSelector, ppgauss.py:374-655): left-drag sketches a
component (span -> location/width, height -> amplitude), middle-click
fits all sketched components to the profile, right-click removes the
last one, and 'q' (or closing the window) finishes.  All state
transitions live in plain methods (``add_from_drag`` / ``fit`` /
``remove_last`` / ``result`` / ``finish``) that the event handlers call,
so the selector is drivable without a display.  ``fit`` is the port's
bounded Levenberg-Marquardt profile fit (fit.gauss.fit_gaussian_profile)
on ``device`` (None = the CUDA device); the drawing is host numpy, and
matplotlib is imported only when a selector is made.
"""

import numpy as np

from ..config import resolve_device
from ..fit.gauss import dc_seed, fit_gaussian_profile
from ..ops.profiles import gaussian_profile, gen_gaussian_profile
from . import _host, _pyplot

__all__ = ["GaussianSelector", "select_gaussians"]

# matplotlib backends that draw no window
_HEADLESS = ("agg", "pdf", "ps", "svg", "pgf", "cairo", "template")


class GaussianSelector:
    """Two-panel component picker: profile + components on top,
    data-minus-fit residuals below.

    Parameters mirror the non-interactive seeders: ``profile`` is the
    averaged profile to model, ``errs`` its per-bin (or scalar) noise,
    ``tau`` a scattering-timescale guess in bins, ``fixscat`` whether
    tau is held fixed, ``fit_flags`` optional per-parameter fit mask
    for the non-scattering parameters, ``device`` where the fits run.

    After the session, ``result()`` returns the last profile fit (a
    DataBunch from fit.gauss.fit_gaussian_profile) or, if no fit was
    run, a fit of whatever components were sketched.
    """

    def __init__(self, profile, errs, tau=0.0, fixscat=True,
                 fit_flags=None, fig=None, show_instructions=True,
                 device=None):
        plt = _pyplot()
        self.device = resolve_device(device)
        self.profile = np.asarray(_host(profile), dtype=np.float64)
        self.nbin = len(self.profile)
        self.phases = (np.arange(self.nbin) + 0.5) / self.nbin
        err = np.atleast_1d(np.asarray(_host(errs), dtype=np.float64))
        self.errs = np.broadcast_to(err, self.profile.shape).copy()
        self.fit_scattering = not fixscat
        self.tau = float(tau)
        if self.fit_scattering and self.tau == 0.0:
            self.tau = 0.1  # a zero seed pins tau at its bound
        self.fit_flags = fit_flags
        self.dc = dc_seed(self.profile)
        self.components = []        # [(loc, wid, amp), ...]
        self.last_fit = None
        self.done = False

        self._drag_start = None
        self._span = None
        if fig is None:
            fig, (self.ax_prof, self.ax_resid) = plt.subplots(
                2, 1, sharex=True, figsize=(8, 6),
                gridspec_kw={"height_ratios": [2, 1]})
        else:
            self.ax_prof, self.ax_resid = fig.subplots(
                2, 1, sharex=True, gridspec_kw={"height_ratios": [2, 1]})
        self.fig = fig
        self.canvas = fig.canvas
        self._cids = [
            self.canvas.mpl_connect("button_press_event", self._on_press),
            self.canvas.mpl_connect("motion_notify_event", self._on_move),
            self.canvas.mpl_connect("button_release_event",
                                    self._on_release),
            self.canvas.mpl_connect("key_press_event", self._on_key),
            self.canvas.mpl_connect("close_event", self._on_close),
        ]
        if show_instructions:
            print("=============================================")
            print("Left-drag to sketch a Gaussian component")
            print("Middle-click to fit components to the data")
            print("Right-click to remove the last component")
            print("Press 'q' or close the window when done")
            print("=============================================")
        self.redraw()

    # -- state transitions (GUI-independent, unit-testable) -------------

    @property
    def ngauss(self):
        return len(self.components)

    @property
    def init_params(self):
        """[dc, tau_bins, (loc, wid, amp) * ngauss] seed vector."""
        return [self.dc, self.tau] + [v for c in self.components
                                      for v in c]

    def add_from_drag(self, x0, x1, ytop):
        """Add a component sketched by a horizontal drag: location at
        the span center, width = |span|, amplitude from the drag height
        above the DC level (slightly inflated, since a by-eye sketch
        tends to under-reach the peak)."""
        loc = 0.5 * (x0 + x1) % 1.0
        wid = max(abs(x1 - x0), 1.5 / self.nbin)
        amp = max(1.05 * abs(ytop - self.dc), 0.0)
        self.components.append((loc, wid, amp))
        self.last_fit = None
        return self.components[-1]

    def remove_last(self):
        if self.components:
            self.components.pop()
            self.last_fit = None

    def fit(self, quiet=True):
        """Fit all sketched components (fit.gauss.fit_gaussian_profile:
        the same bounded LM the automatic path uses) on the selector's
        device."""
        if not self.components:
            return None
        self.last_fit = fit_gaussian_profile(
            self.profile, self.init_params, self.errs,
            fit_flags=self.fit_flags,
            fit_scattering=self.fit_scattering, quiet=quiet,
            device=self.device)
        fp = self.last_fit.fitted_params
        self.dc, self.tau = float(fp[0]), float(fp[1])
        self.components = [(float(fp[2 + 3 * i] % 1.0),
                            float(fp[3 + 3 * i]), float(fp[4 + 3 * i]))
                           for i in range(self.ngauss)]
        return self.last_fit

    def result(self, quiet=True):
        """The final profile fit (running one if none has been)."""
        if self.last_fit is None and self.components:
            self.fit(quiet=quiet)
        return self.last_fit

    def finish(self):
        if self.done:
            return
        self.done = True
        for cid in self._cids:
            self.canvas.mpl_disconnect(cid)
        _pyplot().close(self.fig)

    # -- drawing ---------------------------------------------------------

    def redraw(self):
        ax = self.ax_prof
        ax.cla()
        ax.axhline(0.0, color="k", lw=1, alpha=0.3, ls=":")
        ax.plot(self.phases, self.profile, c="k", lw=3, alpha=0.3)
        ax.set_ylabel("Pulse Amplitude")
        for ig, (loc, wid, amp) in enumerate(self.components):
            comp = self.dc + amp * gaussian_profile(self.nbin, loc,
                                                    wid).numpy()
            ax.plot(self.phases, comp, lw=1,
                    color="C%d" % (ig % 10))
        self.ax_resid.cla()
        self.ax_resid.set_xlabel("Pulse Phase")
        self.ax_resid.set_ylabel("Data-Fit Residuals")
        if self.last_fit is not None:
            prof = gen_gaussian_profile(self.last_fit.fitted_params,
                                        self.nbin).numpy()
            ax.plot(self.phases, prof, c="k", lw=1)
            self.ax_resid.plot(self.phases, self.profile - prof, "k")
        self.ax_prof.set_xlim(0.0, 1.0)
        self.canvas.draw_idle()

    # -- matplotlib event wiring -----------------------------------------

    def _on_press(self, event):
        if self.done or event.inaxes is not self.ax_prof:
            return
        if event.button == 1:
            self._drag_start = (event.xdata, event.ydata)
            self._span = self.ax_prof.axvspan(event.xdata, event.xdata,
                                              color="0.5", alpha=0.3)
        elif event.button == 2:
            self.fit()
            self.redraw()
        elif event.button == 3:
            self.remove_last()
            self.redraw()

    def _on_move(self, event):
        if self._drag_start is None or event.inaxes is not self.ax_prof:
            return
        x0 = self._drag_start[0]
        x1 = event.xdata
        self._span.set_x(min(x0, x1))
        self._span.set_width(abs(x1 - x0))
        self.canvas.draw_idle()

    def _on_release(self, event):
        if self._drag_start is None or event.button != 1:
            return
        x0, _ = self._drag_start
        self._drag_start = None
        if self._span is not None:
            self._span.remove()
            self._span = None
        if event.inaxes is self.ax_prof:
            self.add_from_drag(x0, event.xdata, event.ydata)
        self.redraw()

    def _on_key(self, event):
        if event.key == "q":
            self.finish()

    def _on_close(self, event):
        self.done = True


def select_gaussians(profile, errs, tau=0.0, fixscat=True, fit_flags=None,
                     quiet=True, device=None):
    """Run an interactive selector session (blocking) and return the
    resulting profile fit — the interactive counterpart of
    fit.gauss.auto_gauss_seed / peak_pick_seed.  Raises RuntimeError on
    a headless matplotlib backend, and when the session ends with no
    component sketched."""
    import matplotlib

    plt = _pyplot()
    if matplotlib.get_backend().lower() in _HEADLESS:
        raise RuntimeError(
            "The interactive GaussianSelector needs a GUI matplotlib "
            "backend, but the current backend is %r (headless).  Set "
            "MPLBACKEND (e.g. TkAgg/QtAgg) and a display, or use the "
            "automatic seeding instead (auto_gauss / peak-pick)."
            % matplotlib.get_backend())
    sel = GaussianSelector(profile, errs, tau=tau, fixscat=fixscat,
                           fit_flags=fit_flags, device=device)
    plt.show(block=True)
    fit = sel.result(quiet=quiet)
    if fit is None:
        raise RuntimeError(
            "GaussianSelector session ended with no components sketched.")
    return fit
