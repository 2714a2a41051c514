"""pptoas command-line tool: measure wideband TOAs and DMs, or
narrowband (per-channel) TOAs.

Port of the JAX package's ``cli/pptoas.py`` (reference
pptoas.py:1415-1618): wideband TOAs with DM, nu**-4 (GM) and scattering
fits, narrowband TOAs, flux estimates and crash-resume checkpoints, from
.gmodel, spline or FITS templates.  ``--showplot`` is accepted and draws
nothing, as in the JAX CLI; ``--psrchive`` (PSRCHIVE's Python bindings)
is not ported and fails.
Run as ``python -m pulseportraiture_tpu_torch.cli.pptoas``.  The fits
run on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no ``--device cpu`` the tool fails.  ``PPTPU_OBS_DIR``,
``PPTPU_TRACE_DIR`` and ``PPTPU_FAULTS`` act as for the JAX CLI: one obs
run spans the invocation.
"""

import argparse
import os
import sys

import numpy as np

def build_parser():
    p = argparse.ArgumentParser(
        prog="pptoas",
        description="Simultaneously measure TOAs, DMs, and scattering "
                    "in broadband data.")
    p.add_argument("-d", "--datafiles", metavar="archive",
                   help="PSRFITS archive to measure TOAs/DMs from, or a "
                        "metafile listing archive filenames. Recommended: "
                        "files should not be dedispersed.")
    p.add_argument("-m", "--modelfile", metavar="model",
                   help="Model file from ppgauss/ppspline, or PSRFITS "
                        "template archive.")
    p.add_argument("-o", "--outfile", metavar="timfile", default=None,
                   help="Output .tim file (appends). [default=stdout]")
    p.add_argument("--narrowband", action="store_true",
                   help="Make narrowband (per-channel) TOAs instead.")
    p.add_argument("--errfile", metavar="errfile", default=None,
                   help="Write fitted DM errors to this file (for "
                        "princeton-format TOAs). Appends.")
    p.add_argument("-T", "--tscrunch", action="store_true",
                   help="tscrunch archives before measurement.")
    p.add_argument("-f", "--format", default=None,
                   help="Output format: 'princeton' or 'ipta' "
                        "[default=IPTA-like].")
    p.add_argument("--nu_ref", dest="nu_ref_DM", default=None,
                   help="Topocentric frequency [MHz] the output TOAs are "
                        "referenced to ('inf' allowed). [default="
                        "zero-covariance frequency]")
    p.add_argument("--DM", dest="DM0", default=None,
                   help="Nominal DM [cm**-3 pc] to reference DM offsets "
                        "from. [default=archive DM]")
    p.add_argument("--no_bary", dest="bary", action="store_false",
                   help="Do not Doppler-correct DMs/GMs/taus/nu_tau.")
    p.add_argument("--one_DM", action="store_true",
                   help="Write one DM (the epoch mean) per archive in the "
                        "output .tim file.")
    p.add_argument("--fix_DM", dest="fit_DM", action="store_false",
                   help="Do not fit for DM.")
    p.add_argument("--fit_dt4", dest="fit_GM", action="store_true",
                   help="Fit for nu**-4 delays (GM parameters).")
    p.add_argument("--fit_scat", action="store_true",
                   help="Fit scattering timescale and index per TOA.")
    p.add_argument("--no_logscat", dest="log10_tau", action="store_false",
                   help="Fit tau linearly instead of log10(tau).")
    p.add_argument("--scat_guess", metavar="tau,freq,alpha", default=None,
                   help="Initial guess triplet: tau [s], reference freq "
                        "[MHz], alpha.")
    p.add_argument("--fix_alpha", action="store_true",
                   help="Fix the scattering index to the config/.gmodel "
                        "value.")
    p.add_argument("--nu_tau", dest="nu_ref_tau", default=None,
                   help="Frequency [MHz] the output scattering times are "
                        "referenced to.")
    p.add_argument("--print_phase", action="store_true",
                   help="Write the fitted phase (-phs flag) on TOA lines.")
    p.add_argument("--print_flux", action="store_true",
                   help="Write a flux-density estimate on TOA lines.")
    p.add_argument("--print_parangle", action="store_true",
                   help="Write the parallactic angle on TOA lines.")
    p.add_argument("--flags", dest="toa_flags", default="",
                   help="Comma-separated key,value pairs added to all "
                        "TOA lines, e.g. pta,NANOGrav,version,0.1")
    p.add_argument("--snr_cut", dest="snr_cutoff", default=0.0, type=float,
                   help="S/N cutoff for written TOAs.")
    p.add_argument("--checkpoint", metavar="timfile", default=None,
                   help="Crash-resume mode: append TOAs to this .tim "
                        "file after EVERY archive and skip archives "
                        "already in it on a re-run.  The checkpoint "
                        "file IS the output (-o is ignored); "
                        "incompatible with --snr_cut/--one_DM/"
                        "-f princeton/--narrowband, which post-process "
                        "the full TOA list.")
    p.add_argument("--showplot", dest="show_plot", action="store_true",
                   help="Show fitted data/model/residual plots.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device the fits run on. [default=cuda]")
    p.add_argument("--quiet", action="store_true", help="Suppress output.")
    # accepted so that it fails loudly instead of being misparsed
    p.add_argument("--psrchive", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.datafiles is None or args.modelfile is None:
        build_parser().print_help()
        return 1
    if args.psrchive:
        print("pptoas: --psrchive: not yet ported to "
              "pulseportraiture_tpu_torch.", file=sys.stderr)
        return 2
    if args.narrowband and args.one_DM:
        print("--one_DM applies to wideband (per-subint DM) TOAs only.")
        return 1
    if args.checkpoint is not None:
        incompatible = [flag for flag, on in [
            ("--narrowband", args.narrowband),
            ("--snr_cut", args.snr_cutoff > 0.0),
            ("--one_DM", args.one_DM),
            ("-f princeton", args.format == "princeton")] if on]
        if incompatible:
            print("--checkpoint writes raw TOA lines incrementally and "
                  "cannot be combined with post-processing flags: "
                  + ", ".join(incompatible), file=sys.stderr)
            return 1
        if args.outfile is not None and \
                os.path.realpath(args.outfile) != \
                os.path.realpath(args.checkpoint):
            print("--checkpoint supersedes -o: TOAs go to %s only."
                  % args.checkpoint, file=sys.stderr)

    from .. import obs

    # one observability run spans the whole invocation (fit AND the
    # final .tim write); the pipeline's own @obs.scoped_run joins it
    with obs.run("pptoas"):
        return _run_pipeline(args)


def _run_pipeline(args):
    from .. import obs
    from ..io.timfile import write_TOAs
    from ..pipelines.toas import GetTOAs

    nu_refs = None
    nu_ref_DM = args.nu_ref_DM
    if nu_ref_DM is not None:
        nu_ref_DM = np.inf if nu_ref_DM == "inf" else np.float64(nu_ref_DM)
    if args.nu_ref_tau is not None or nu_ref_DM is not None:
        nu_ref_tau = None if args.nu_ref_tau is None \
            else np.float64(args.nu_ref_tau)
        nu_refs = (nu_ref_DM, nu_ref_tau)
    DM0 = np.float64(args.DM0) if args.DM0 is not None else None
    scat_guess = None
    if args.scat_guess:
        scat_guess = [float(s) for s in args.scat_guess.split(",")]
    kv = args.toa_flags.split(",")
    addtnl_toa_flags = dict(zip(kv[::2], kv[1::2])) if args.toa_flags \
        else {}

    gt = GetTOAs(datafiles=args.datafiles, modelfile=args.modelfile,
                 quiet=args.quiet, device=args.device)
    if not args.narrowband:
        gt.get_TOAs(tscrunch=args.tscrunch, nu_refs=nu_refs, DM0=DM0,
                    bary=args.bary, fit_DM=args.fit_DM, fit_GM=args.fit_GM,
                    fit_scat=args.fit_scat, log10_tau=args.log10_tau,
                    scat_guess=scat_guess, fix_alpha=args.fix_alpha,
                    print_phase=args.print_phase,
                    print_flux=args.print_flux,
                    print_parangle=args.print_parangle,
                    addtnl_toa_flags=addtnl_toa_flags,
                    show_plot=args.show_plot, quiet=args.quiet,
                    checkpoint=args.checkpoint)
        if args.checkpoint is not None:
            return 0  # the checkpoint file is the output
    else:
        gt.get_narrowband_TOAs(tscrunch=args.tscrunch,
                               fit_scat=args.fit_scat,
                               log10_tau=args.log10_tau,
                               scat_guess=scat_guess,
                               print_phase=args.print_phase,
                               print_flux=args.print_flux,
                               print_parangle=args.print_parangle,
                               addtnl_toa_flags=addtnl_toa_flags,
                               quiet=args.quiet)

    if args.format == "princeton":
        with obs.span("write", outfile=args.outfile, format="princeton"):
            gt.write_princeton_TOAs(outfile=args.outfile,
                                    one_DM=args.one_DM,
                                    dmerrfile=args.errfile)
        return 0
    if args.one_DM:
        for toa in gt.TOA_list:
            ifile = gt.order.index(toa.archive)
            toa.DM = gt.DeltaDM_means[ifile] + gt.DM0s[ifile]
            toa.DM_error = gt.DeltaDM_errs[ifile]
            toa.flags["DM_mean"] = True
    with obs.span("write", outfile=args.outfile, n_toas=len(gt.TOA_list)):
        write_TOAs(gt.TOA_list, inf_is_zero=True,
                   SNR_cutoff=args.snr_cutoff, outfile=args.outfile,
                   append=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
