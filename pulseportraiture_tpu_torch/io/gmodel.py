"""`.gmodel` Gaussian-model text files, bit-compatible with the reference.

Format (reference ``write_model``/``read_model``,
pplib.py:2834-2959; documented example at
examples/example.gmodel):

    MODEL   <name>
    CODE    <3-digit evolution code>
    FREQ    <nu_ref MHz>
    DC      <value> <fit>
    TAU     <value sec> <fit>
    ALPHA   <value>      <fit>
    COMPnn  <loc> <fit>  <dloc> <fit>  <wid> <fit>  <dwid> <fit> \
            <amp> <fit>  <damp> <fit>

TAU is stored in seconds; ``read_model`` converts to bins (tau *= nbin/P)
when building a portrait.
"""

import numpy as np

from ..ops.profiles import gen_gaussian_portrait

__all__ = ["write_model", "read_model"]


def write_model(filename, name, model_code, nu_ref, model_params, fit_flags,
                alpha, fit_alpha, append=False, quiet=False):
    """Write a Gaussian-component model file (pplib.py:2834-2872)."""
    mode = "a" if append else "w"
    model_params = np.asarray(model_params, dtype=np.float64)
    fit_flags = np.asarray(fit_flags, dtype=int)
    with open(filename, mode) as outfile:
        outfile.write("MODEL   %s\n" % name)
        outfile.write("CODE    %s\n" % model_code)
        outfile.write("FREQ    %.5f\n" % nu_ref)
        outfile.write("DC     % .8f %d\n" % (model_params[0], fit_flags[0]))
        outfile.write("TAU    % .8f %d\n" % (model_params[1], fit_flags[1]))
        outfile.write("ALPHA  % .3f      %d\n" % (alpha, fit_alpha))
        ngauss = (len(model_params) - 2) // 6
        for igauss in range(ngauss):
            comp = model_params[2 + igauss * 6: 8 + igauss * 6]
            fit_comp = fit_flags[2 + igauss * 6: 8 + igauss * 6]
            pairs = tuple(np.stack([comp, fit_comp], axis=1).ravel())
            outfile.write(
                "COMP%02d % .8f %d  % .8f %d  % .8f %d  % .8f %d  "
                "% .8f %d  % .8f %d\n"
                % ((igauss + 1,) + pairs))
    if not quiet:
        print("%s written." % filename)


def read_model(modelfile, phases=None, freqs=None, P=None, quiet=True,
               device="cpu"):
    """Read a `.gmodel` file; optionally build the portrait.

    Read-only call (phases/freqs None) returns (name, model_code, nu_ref,
    ngauss, params, fit_flags, alpha, fit_alpha); otherwise returns
    (name, ngauss, model [nchan, nbin]) with TAU converted from seconds
    to bins and the model a float64 tensor on ``device``.  Equivalent of
    pplib.py:2873-2959.
    """
    read_only = phases is None and freqs is None
    comps = []
    modelname = model_code = None
    nu_ref = dc = tau = alpha = 0.0
    fit_dc = fit_tau = fit_alpha = 0
    with open(modelfile) as f:
        for line in f:
            info = line.split()
            if not info:
                continue
            key = info[0]
            try:
                if key == "MODEL":
                    modelname = info[1]
                elif key == "CODE":
                    model_code = info[1]
                elif key == "FREQ":
                    nu_ref = float(info[1])
                elif key == "DC":
                    dc, fit_dc = float(info[1]), int(info[2])
                elif key == "TAU":
                    tau, fit_tau = float(info[1]), int(info[2])
                elif key == "ALPHA":
                    alpha, fit_alpha = float(info[1]), int(info[2])
                elif key.startswith("COMP"):
                    comps.append(line)
            except IndexError:
                pass
    ngauss = len(comps)
    params = np.zeros(ngauss * 6 + 2)
    fit_flags = np.zeros(len(params), dtype=int)
    params[0], params[1] = dc, tau
    fit_flags[0], fit_flags[1] = fit_dc, fit_tau
    for igauss, comp_line in enumerate(comps):
        toks = comp_line.split()
        params[2 + igauss * 6: 8 + igauss * 6] = \
            [float(v) for v in toks[1::2]]
        fit_flags[2 + igauss * 6: 8 + igauss * 6] = \
            [int(v) for v in toks[2::2]]
    if read_only:
        return (modelname, model_code, nu_ref, ngauss, params, fit_flags,
                alpha, fit_alpha)
    nbin = len(phases)
    if params[1] != 0.0:
        if P is None:
            raise ValueError("Need period P for non-zero scattering TAU.")
        params = params.copy()
        params[1] *= nbin / P
    model = gen_gaussian_portrait(model_code, params, alpha,
                                  np.asarray(phases), np.asarray(freqs),
                                  nu_ref, device=device)
    if not quiet:
        print("Model Name: %s" % modelname)
        print("Made %d component model with %d profile bins."
              % (ngauss, nbin))
    return (modelname, ngauss, model)
