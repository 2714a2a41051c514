"""ppalign command-line tool: align and average archives.

Port of the JAX package's ``cli/ppalign.py`` (reference
ppalign.py:245-380), every option included: the psradd/psrsmooth
subprocess plumbing is the native average_archives /
make_constant_portrait / psrsmooth_archive.  The fits, rotations and
smoothing run on the CUDA device unless ``--device cpu`` is given; with
no CUDA device and no ``--device cpu`` the tool fails.
Run as ``python -m pulseportraiture_tpu_torch.cli.ppalign``.
"""

import argparse
import os
import sys
import tempfile

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppalign",
        description="Align and average homogeneous archives by fitting "
                    "DMs and phases.")
    p.add_argument("-M", "--metafile", metavar="metafile",
                   help="Metafile of archives to average together.")
    p.add_argument("-I", "--init", metavar="initial_guess",
                   dest="initial_guess", default=None,
                   help="Archive containing the initial alignment guess. "
                        "A native psradd-equivalent average is used "
                        "otherwise.")
    p.add_argument("-g", "--width", metavar="fwhm", dest="fwhm",
                   default=None,
                   help="Align against a single Gaussian component of "
                        "this FWHM. Overrides -I.")
    p.add_argument("-D", "--no_DM", dest="fit_dm", action="store_false",
                   help="Fit for phase only when aligning.")
    p.add_argument("-T", "--tscr", dest="tscrunch", action="store_true",
                   help="Tscrunch archives for the iterations.")
    p.add_argument("-p", "--poln", dest="pscrunch", action="store_false",
                   help="Output average Stokes portraits, not just total "
                        "intensity.")
    p.add_argument("-C", "--cutoff", metavar="SNR_cutoff",
                   dest="SNR_cutoff", default=0.0, type=float,
                   help="S/N cutoff applied to input archives.")
    p.add_argument("-o", "--outfile", default=None,
                   help="Averaged output archive. "
                        "[default=metafile.algnd.fits]")
    p.add_argument("-P", "--palign", action="store_true",
                   help="Phase-align archives in the initial average.")
    p.add_argument("-N", "--norm", default=None,
                   help="Normalize the averaged data by channel: 'mean', "
                        "'max', 'prof', 'rms', or 'abs'.")
    p.add_argument("-s", "--smooth", action="store_true",
                   help="Also output a wavelet-smoothed averaged archive "
                        "(psrsmooth -W equivalent).")
    p.add_argument("-r", "--rot", metavar="phase", dest="rot_phase",
                   default=0.0, type=float,
                   help="Additional rotation for the averaged archive.")
    p.add_argument("--place", default=None,
                   help="Roughly place the pulse at this phase. "
                        "Overrides --rot.")
    p.add_argument("--niter", default=1, type=int,
                   help="Number of iterations. [default=1]")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device the fits run on. [default=cuda]")
    p.add_argument("--verbose", dest="quiet", action="store_false",
                   help="More to stdout.")
    return p


def _tmpfits():
    fd, path = tempfile.mkstemp(prefix="ppalign.", suffix=".fits")
    os.close(fd)
    return path


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.metafile is None or not args.niter:
        build_parser().print_help()
        return 1

    from ..config import resolve_device
    from ..io.archive import parse_metafile
    from ..io.psrfits import read_archive
    from ..ops.profiles import gaussian_profile
    from ..pipelines.align import (align_archives, average_archives,
                                   make_constant_portrait,
                                   psrsmooth_archive)

    device = resolve_device(args.device)  # no CUDA device: fail here
    rot_phase = args.rot_phase
    place = None
    if args.place is not None:
        rot_phase = 0.0
        place = np.float64(args.place)

    initial_guess = args.initial_guess
    tmp_file = None
    if initial_guess is None and args.fwhm is None:
        tmp_file = _tmpfits()
        average_archives(args.metafile, outfile=tmp_file,
                         palign=args.palign, pscrunch=args.pscrunch,
                         quiet=args.quiet, device=device)
        initial_guess = tmp_file
    elif args.fwhm:
        tmp_file = _tmpfits()
        first = parse_metafile(args.metafile)[0]
        nbin = read_archive(first).nbin
        profile = gaussian_profile(nbin, 0.5, float(args.fwhm)).numpy()
        make_constant_portrait(first, tmp_file, profile=profile, DM=0.0,
                               dmc=False, quiet=args.quiet)
        initial_guess = tmp_file
    elif read_archive(initial_guess).nchan == 1:
        tmp_file = _tmpfits()
        first = parse_metafile(args.metafile)[0]
        make_constant_portrait(first, tmp_file, profile=None, DM=0.0,
                               dmc=False, quiet=args.quiet)
        initial_guess = tmp_file

    outfile = args.outfile
    align_archives(args.metafile, initial_guess=initial_guess,
                   fit_dm=args.fit_dm, tscrunch=args.tscrunch,
                   pscrunch=args.pscrunch, SNR_cutoff=args.SNR_cutoff,
                   outfile=outfile, norm=args.norm, rot_phase=rot_phase,
                   place=place, niter=args.niter, quiet=args.quiet,
                   device=device)
    if args.smooth:
        if outfile is None:
            outfile = args.metafile + ".algnd.fits"
        psrsmooth_archive(outfile, options="-W", quiet=args.quiet,
                          device=device)
    if tmp_file is not None and os.path.exists(tmp_file):
        os.remove(tmp_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
