"""ppgauss command-line tool: build Gaussian-component portrait models.

Port of the JAX package's ``cli/ppgauss.py`` (reference
ppgauss.py:658-800).  Seeding is automatic (peak-pick, or --autogauss
for one component); the fits run on the CUDA device unless
``--device cpu`` is given.  ``--interactive`` (the matplotlib
GaussianSelector) and ``--figure`` are not ported yet and fail.
Run as ``python -m pulseportraiture_tpu_torch.cli.ppgauss``.
"""

import argparse
import sys

import numpy as np


def build_parser():
    from ..config import default_model

    p = argparse.ArgumentParser(
        prog="ppgauss",
        description="Generate a Gaussian-component model pulse portrait.")
    p.add_argument("-d", "--datafile", default=None, metavar="archive",
                   help="PSRFITS archive to model.")
    p.add_argument("-M", "--metafile", default=None,
                   help="Metafile of archives from different bands; the "
                        "first must contain nu_ref.")
    p.add_argument("-I", "--improve", metavar="modelfile",
                   dest="modelfile", default=None,
                   help="Improve/iterate on an existing .gmodel given "
                        "input data.")
    p.add_argument("-o", "--outfile", default=None,
                   help="Output model file. [default=archive.gmodel]")
    p.add_argument("-e", "--errfile", default=None,
                   help="Parameter error file. [default=outfile_errs]")
    p.add_argument("-j", "--joinfile", default=None,
                   help="File of join parameters aligning the metafile "
                        "archives.")
    p.add_argument("-m", "--model_name", default=None,
                   help="Name given to the model. [default=source name]")
    p.add_argument("--nu_ref", default=None,
                   help="Reference frequency [MHz] for the model.")
    p.add_argument("--bw", dest="bw_ref", default=None,
                   help="Bandwidth [MHz] about nu_ref averaged for the "
                        "initial profile fit.")
    p.add_argument("--tau", default=0.0, type=float,
                   help="Scattering timescale [s] at nu_ref.")
    p.add_argument("--fitloc", dest="fixloc", action="store_false",
                   help="Let component locations drift with frequency.")
    p.add_argument("--fixwid", action="store_true",
                   help="Fix widths across frequency.")
    p.add_argument("--fixamp", action="store_true",
                   help="Fix amplitudes across frequency.")
    p.add_argument("--fitscat", dest="fixscat", action="store_false",
                   help="Fit the scattering timescale.")
    p.add_argument("--fitalpha", dest="fixalpha", action="store_false",
                   help="Fit the scattering index (implies --fitscat).")
    p.add_argument("--mcode", dest="model_code", default=default_model,
                   metavar="###",
                   help="Three-digit evolution code for (loc,wid,amp).")
    p.add_argument("--niter", default=0, type=int,
                   help="Max number of refinement iterations.")
    p.add_argument("--fgauss", action="store_true",
                   help="Fiducial Gaussian: fit all component location "
                        "slopes except the first's.")
    seed_mode = p.add_mutually_exclusive_group()
    seed_mode.add_argument("--autogauss", dest="auto_gauss", default=0.0,
                           type=float, metavar="wid",
                           help="Fit one automatic Gaussian with this "
                                "initial width [rot].")
    seed_mode.add_argument("--interactive", action="store_true",
                           help="Hand-fit the seed components (not yet "
                                "ported).")
    p.add_argument("--norm", dest="normalize", default=None,
                   help="Per-channel normalization: 'mean', 'max', "
                        "'prof', 'rms', or 'abs'.")
    p.add_argument("--figure", default=False, metavar="figurename",
                   help="Save a PNG of the final fit (not yet ported).")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device the fits run on. [default=cuda]")
    p.add_argument("--verbose", dest="quiet", action="store_false",
                   help="More to stdout.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.datafile is None and args.metafile is None:
        build_parser().print_help()
        return 1
    for flag, on in (("--interactive", args.interactive),
                     ("--figure", args.figure)):
        if on:
            print("ppgauss: %s: not yet ported to "
                  "pulseportraiture_tpu_torch." % flag, file=sys.stderr)
            return 2

    from ..config import resolve_device
    from ..models.gauss import GaussianModelPortrait

    device = resolve_device(args.device)  # no CUDA device: fail here
    datafile = args.metafile if args.metafile is not None else \
        args.datafile
    fixscat = args.fixscat and args.fixalpha  # --fitalpha implies fitscat

    dp = GaussianModelPortrait(datafile=datafile, joinfile=args.joinfile,
                               quiet=args.quiet, device=device)
    if args.normalize in ("mean", "max", "prof", "rms", "abs"):
        dp.normalize_portrait(args.normalize)
    elif args.normalize is not None:
        print("Unknown normalization choice, '%s'." % args.normalize)
        return 1
    nu_ref = np.float64(args.nu_ref) if args.nu_ref else None
    bw_ref = np.float64(args.bw_ref) if args.bw_ref else None
    if args.modelfile is not None:
        dp.make_gaussian_model(modelfile=args.modelfile,
                               fixalpha=args.fixalpha,
                               model_code=args.model_code,
                               niter=args.niter, writemodel=True,
                               outfile=args.outfile, writeerrfile=True,
                               errfile=args.errfile,
                               model_name=args.model_name,
                               quiet=args.quiet)
    else:
        tau = args.tau * dp.nbin / dp.Ps[0]
        outfile = args.outfile
        if outfile is None:
            outfile = datafile + ".gmodel"
        dp.make_gaussian_model(modelfile=None, ref_prof=(nu_ref, bw_ref),
                               tau=tau, fixloc=args.fixloc,
                               fixwid=args.fixwid, fixamp=args.fixamp,
                               fixscat=fixscat, fixalpha=args.fixalpha,
                               model_code=args.model_code,
                               niter=args.niter,
                               fiducial_gaussian=args.fgauss,
                               auto_gauss=args.auto_gauss,
                               writemodel=True, outfile=outfile,
                               writeerrfile=True, errfile=args.errfile,
                               model_name=args.model_name,
                               quiet=args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
