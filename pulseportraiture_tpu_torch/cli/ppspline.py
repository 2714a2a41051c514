"""ppspline command-line tool: build PCA/B-spline portrait models.

Port of the JAX package's ``cli/ppspline.py`` (reference
ppspline.py:277-381).  The PCA, the eigenvector smoothing and the model
evaluation run on the CUDA device unless ``--device cpu`` is given; the
spline fit and the writes are host.  ``--plots`` saves the eigenprofile,
spline-projection and residual figures (viz) under the model name.
Run as ``python -m pulseportraiture_tpu_torch.cli.ppspline``.
"""

import argparse
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppspline",
        description="Make a pulse portrait model using PCA & B-spline "
                    "interpolation.")
    p.add_argument("-d", "--datafile", metavar="archive",
                   help="PSRFITS archive to model, or a metafile of "
                        "(aligned) archives.")
    p.add_argument("-o", "--modelfile", default=None,
                   help="Output model file. [default=datafile.spl]")
    p.add_argument("-l", "--model_name", default=None,
                   help="Optional model name. [default=datafile.spl]")
    p.add_argument("-a", "--archive", default=None,
                   help="Optional output PSRFITS archive of the model "
                        "(single input archive only).")
    p.add_argument("-N", "--norm", default="prof",
                   help="Per-channel normalization: 'None', 'mean', "
                        "'max', 'rms', 'prof' [default], or 'abs'.")
    p.add_argument("-s", "--smooth", action="store_true",
                   help="Wavelet-smooth the eigenvectors and mean "
                        "profile [recommended].")
    p.add_argument("-n", "--max_ncomp", default=10, type=int,
                   help="Max principal components in the "
                        "reconstruction (<=10).")
    p.add_argument("-S", "--snr", dest="snr_cutoff", default=150.0,
                   type=float,
                   help="S/N cutoff for significant eigenprofiles. "
                        "[default=150]")
    p.add_argument("-T", "--rchi2_tol", default=0.1, type=float,
                   help="Smoothing chi2 tolerance in [0, 0.1].")
    p.add_argument("-k", "--degree", dest="k", default=3, type=int,
                   help="Spline degree, 1 <= k <= 5. [default=3 (cubic)]")
    p.add_argument("-f", "--sfac", default=1.0, type=float,
                   help="Spline smoothness factor; 0 interpolates.")
    p.add_argument("-t", "--knots", dest="max_nbreak", default=None,
                   help="Maximum number of unique knots.")
    p.add_argument("--plots", dest="make_plots", action="store_true",
                   help="Save model-related plots (basename -l).")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device the model build runs on. [default=cuda]")
    p.add_argument("--quiet", action="store_true", help="Suppress output.")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.datafile is None:
        build_parser().print_help()
        return 1
    from ..config import resolve_device
    from ..models.spline import SplineModelPortrait

    device = resolve_device(args.device)  # no CUDA device: fail here
    dp = SplineModelPortrait(args.datafile, quiet=args.quiet, device=device)
    if args.norm in ("mean", "max", "prof", "rms", "abs"):
        dp.normalize_portrait(args.norm)
    max_nbreak = int(args.max_nbreak) if args.max_nbreak is not None \
        else None
    dp.make_spline_model(max_ncomp=args.max_ncomp, smooth=args.smooth,
                         snr_cutoff=args.snr_cutoff,
                         rchi2_tol=args.rchi2_tol, k=args.k,
                         sfac=args.sfac, max_nbreak=max_nbreak,
                         model_name=args.model_name, quiet=args.quiet)
    modelfile = args.modelfile
    if modelfile is None:
        modelfile = args.datafile + ".spl"
    dp.write_model(modelfile, quiet=args.quiet)
    if args.archive is not None and len(dp.datafiles) == 1:
        dp.write_model_archive(args.archive, quiet=args.quiet)
    if args.make_plots:
        from ..viz import (show_eigenprofiles, show_model_fit,
                           show_spline_curve_projections)

        name = dp.spline_model.model_name
        show_eigenprofiles(dp, title=name, savefig=name + ".eigs.png")
        show_spline_curve_projections(dp, title=name,
                                      savefig=name + ".proj.png")
        show_model_fit(dp, savefig=name + ".resids.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
