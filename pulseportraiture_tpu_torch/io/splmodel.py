"""Spline portrait model container: npz-based, with legacy pickle reads.

Port of the JAX package's ``io/splmodel.py`` (reference
ppspline.py:206-230 and pplib.py:2961-3019).  The reference pickles
``[modelname, source, datafile, mean_prof, eigvec, tck]`` into a ``.spl``
file; the native container is a plain ``.npz`` of the same contents,
and ``read_spline_model`` loads either (legacy pickles read-only).  The
file format is the JAX package's, so a model written by one package
reads in the other.  Host code; the portrait is built by
``ops.splines.gen_spline_portrait`` on the caller's device.
"""

import pickle

import numpy as np

from ..ops.splines import gen_spline_portrait, splev

__all__ = ["write_spline_model", "read_spline_model",
           "get_spline_model_coords"]


def write_spline_model(modelfile, modelname, source, datafile, mean_prof,
                       eigvec, tck, quiet=True):
    """Write a spline model as .npz (tck = (t, c, k); c [ndim, ncoef])."""
    t, c, k = tck
    # np.savez appends '.npz' to bare paths; writing through a file object
    # puts the model at exactly ``modelfile`` (the .spl convention)
    with open(modelfile, "wb") as f:
        np.savez(
            f,
            modelname=np.str_(modelname), source=np.str_(source),
            datafile=np.str_(datafile),
            mean_prof=np.asarray(mean_prof, dtype=np.float64),
            eigvec=np.asarray(eigvec, dtype=np.float64),
            tck_t=np.asarray(t, dtype=np.float64),
            tck_c=np.asarray(c, dtype=np.float64),
            tck_k=np.int64(k))
    if not quiet:
        print("%s written." % modelfile)


def _load_container(modelfile):
    """(modelname, source, datafile, mean_prof, eigvec, tck) from either
    the npz container or a legacy reference pickle."""
    try:
        with np.load(modelfile, allow_pickle=False) as z:
            return (str(z["modelname"]), str(z["source"]),
                    str(z["datafile"]), z["mean_prof"], z["eigvec"],
                    (z["tck_t"], z["tck_c"], int(z["tck_k"])))
    except (ValueError, OSError, KeyError):
        with open(modelfile, "rb") as f:
            modelname, source, datafile, mean_prof, eigvec, tck = \
                pickle.load(f, encoding="latin1")
        t, c, k = tck
        return (modelname, source, datafile, np.asarray(mean_prof),
                np.asarray(eigvec), (np.asarray(t), np.asarray(c), int(k)))


def read_spline_model(modelfile, freqs=None, nbin=None, quiet=True,
                      device=None):
    """Read a spline model; with ``freqs``, also build its portrait.

    Without freqs returns the 6-tuple contents; with them (modelname,
    port [nchan, nbin]), the portrait a tensor on ``device`` (None:
    freqs' device, else the CPU).  Reference pplib.py:2961-2993."""
    contents = _load_container(modelfile)
    if freqs is None:
        return contents
    modelname, _, _, mean_prof, eigvec, tck = contents
    return (modelname, gen_spline_portrait(mean_prof, freqs, eigvec, tck,
                                           nbin, device=device))


def get_spline_model_coords(modelfile, nfreq=1000, lo_freq=None,
                            hi_freq=None):
    """(model_freqs [nfreq], proj_port [nfreq, neig]): the spline curve's
    coordinates sampled over frequency, as numpy (reference
    pplib.py:2995-3019, without its pickle side-dump)."""
    _, _, _, _, _, tck = _load_container(modelfile)
    t = np.asarray(tck[0])
    lo = t.min() if lo_freq is None else lo_freq
    hi = t.max() if hi_freq is None else hi_freq
    model_freqs = np.linspace(lo, hi, nfreq)
    return model_freqs, splev(model_freqs, tck).T.numpy()
