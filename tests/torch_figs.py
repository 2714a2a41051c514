"""Comparison of two matplotlib figures by what they show, not their pixels.

Shared by the port's plotting tests (tests/test_torch_viz*.py): each
axes' titles, labels, scales, tick labels and limits, image arrays with
their extent, origin and color limits, line and scatter data with their
styles and colors, patches (histogram bars and outlines) in data
coordinates, the suptitle and ``fig.pp_rchi2``.
"""

import numpy as np


def figure_data(fig):
    """What a figure shows, per axes, as comparable numbers and text."""
    axes = []
    for ax in fig.axes:
        axes.append(dict(
            text=(ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
                  ax.get_xscale(), ax.get_yscale(),
                  [t.get_text() for t in ax.get_xticklabels()]
                  if ax.images or ax.get_lines() else None,
                  [t.get_text() for t in ax.get_yticklabels()]),
            limits=(ax.get_xlim(), ax.get_ylim()),
            images=[(np.asarray(im.get_array()), tuple(im.get_extent()),
                     im.origin, im.get_clim()) for im in ax.images],
            lines=[(np.asarray(ln.get_xdata(), float),
                    np.asarray(ln.get_ydata(), float), ln.get_linestyle(),
                    ln.get_color(), ln.get_marker())
                   for ln in ax.get_lines()],
            scatter=[(np.asarray(c.get_offsets()),
                      np.asarray(c.get_facecolor()))
                     for c in ax.collections
                     if type(c).__name__ == "PathCollection"],
            patches=[p.get_patch_transform().transform(
                p.get_path().vertices) for p in ax.patches]))
    suptitle = fig._suptitle.get_text() if fig._suptitle else None
    return suptitle, axes, getattr(fig, "pp_rchi2", None)


def assert_near(a, b, rtol, what):
    """``a`` equals ``b`` (``rtol`` = 0) or lies within ``rtol`` of
    ``b``'s largest finite magnitude; infinities must match."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape, what
    if rtol == 0:
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        scale = max(np.abs(b[np.isfinite(b)]).max(initial=0.0), 1e-300)
        np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale,
                                   err_msg=what)


def assert_same_figure(port_fig, ref_fig, rtol=0.0):
    """The port's figure shows what the JAX package's shows: text and
    styles equal, numbers equal (``rtol`` = 0) or within ``rtol`` of
    each array's largest magnitude."""
    t_sup, t_axes, t_rchi2 = figure_data(port_fig)
    r_sup, r_axes, r_rchi2 = figure_data(ref_fig)
    assert t_sup == r_sup
    assert len(t_axes) == len(r_axes)
    for i, (t, r) in enumerate(zip(t_axes, r_axes)):
        assert t["text"] == r["text"], i
        assert_near(t["limits"], r["limits"], rtol, "limits %d" % i)
        assert len(t["images"]) == len(r["images"])
        for (ta, te, to, tc), (ra, re, ro, rc) in zip(t["images"],
                                                      r["images"]):
            assert_near(ta, ra, rtol, "image %d" % i)
            assert te == re and to == ro
            assert_near(tc, rc, rtol, "clim %d" % i)
        assert len(t["lines"]) == len(r["lines"]), i
        for j, (tl, rl) in enumerate(zip(t["lines"], r["lines"])):
            assert tl[2:] == rl[2:], (i, j)
            assert_near(tl[0], rl[0], rtol, "line x %d.%d" % (i, j))
            assert_near(tl[1], rl[1], rtol, "line y %d.%d" % (i, j))
        assert len(t["scatter"]) == len(r["scatter"])
        for (to_, tf), (ro_, rf) in zip(t["scatter"], r["scatter"]):
            assert_near(to_, ro_, rtol, "scatter %d" % i)
            assert_near(tf, rf, rtol, "scatter colors %d" % i)
        assert len(t["patches"]) == len(r["patches"])
        for tp, rp in zip(t["patches"], r["patches"]):
            assert_near(tp, rp, rtol, "patch %d" % i)
    assert (t_rchi2 is None) == (r_rchi2 is None)
    if r_rchi2 is not None:
        assert isinstance(t_rchi2, np.ndarray)
        np.testing.assert_allclose(t_rchi2, r_rchi2, rtol=max(rtol, 1e-12))
