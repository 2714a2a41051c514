"""ppzap command-line tool: identify bad channels to zap.

Port of the JAX package's ``cli/ppzap.py`` (reference ppzap.py:98-241):
the model-free median-noise cut, or — with -m — the post-fit
reduced-chi2/S-N cut through the TOA pipeline.  The fits (and -N's
normalization) run on the CUDA device unless ``--device cpu`` is given.
With -m, ``--hist`` saves the histogram of the channel reduced chi2s
(viz.figdata.zap_hist) as ``<datafiles>_ppzap_hist.png``.
Run as ``python -m pulseportraiture_tpu_torch.cli.ppzap``.
"""

import argparse
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppzap", description="Identify bad channels to zap.")
    p.add_argument("-d", "--datafiles", metavar="archive",
                   help="PSRFITS archive or metafile to examine. Files "
                        "should NOT be dedispersed.")
    p.add_argument("-n", "--num_std", dest="nstd", default=5.0, type=float,
                   help="Flag channels whose noise exceeds the median by "
                        "this many standard deviations (iterated). "
                        "Ignored with -m. [default=5]")
    p.add_argument("-N", "--norm", default=None,
                   help="With -n: normalize data first ('mean', 'max', "
                        "'prof', 'rms', or 'abs').")
    p.add_argument("-m", "--modelfile", default=None,
                   help="Model file: switches to the post-fit "
                        "chi2/S-N zap through the TOA pipeline.")
    p.add_argument("-T", "--tscrunch", action="store_true",
                   help="Examine tscrunched archives; apply zaps to all "
                        "subints.")
    p.add_argument("-S", "--SNR-threshold", dest="SNR_threshold",
                   default=8.0, type=float,
                   help="TOA S/N threshold for flagging low-S/N "
                        "channels. [default=8]")
    p.add_argument("-R", "--rchi2-threshold", dest="rchi2_threshold",
                   default=1.3, type=float,
                   help="Reduced-chi2 threshold for flagging bad "
                        "channels. [default=1.3]")
    p.add_argument("-o", "--outfile", default=None,
                   help="Output paz command file (appends). "
                        "[default=stdout]")
    p.add_argument("--modify", action="store_true",
                   help="paz commands modify the original datafiles; "
                        "with --apply, rewrite them in place.")
    p.add_argument("--apply", action="store_true",
                   help="Apply the zaps natively (no psrchive needed): "
                        "zero the flagged channel weights and rewrite "
                        "the archives with the built-in PSRFITS writer "
                        "instead of emitting paz commands. Without "
                        "--modify, writes '.zap' copies like paz -e "
                        "zap.")
    p.add_argument("--hist", action="store_true",
                   help="Save a histogram of channel reduced-chi2 "
                        "values.")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Device the fits run on. [default=cuda]")
    p.add_argument("--quiet", action="store_true", help="Suppress output.")
    return p


def _normalize(data, method, device):
    """The -N normalization of every fitted subint, on ``device``; the
    noise levels are re-estimated per channel afterwards."""
    import torch

    from ..ops.noise import get_noise
    from ..ops.normalize import normalize_portrait

    for isub in data.ok_isubs:
        port = normalize_portrait(
            torch.as_tensor(data.subints[isub, 0]).to(device),
            method=method, weights=data.weights[isub], return_norms=False)
        data.subints[isub, 0] = port.cpu().numpy()
        data.noise_stds[isub, 0] = get_noise(port).cpu().numpy()


def _save_hist(args, channel_red_chi2s, nchan):
    """The JAX CLI's histogram of the channel reduced chi2s, saved as
    ``<datafiles>_ppzap_hist.png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..viz.figdata import zap_hist

    red_chi2s, nzap_rchi2 = zap_hist(channel_red_chi2s, args.rchi2_threshold)
    plt.hist(red_chi2s, bins=min(50, max(len(red_chi2s), 1)), log=True)
    ymin, ymax = plt.ylim()
    plt.vlines(args.rchi2_threshold, ymin, ymax, linestyles="dashed")
    plt.ylim(ymin, ymax)
    plt.xlabel(r"Reduced $\chi^2$")
    plt.ylabel("#")
    plt.title("%s\n" % args.datafiles +
              r"%d / %d channels w/ $\chi^2_{red}$ > %.1f"
              % (nzap_rchi2, nchan, args.rchi2_threshold))
    plt.savefig(args.datafiles + "_ppzap_hist.png")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.datafiles is None:
        build_parser().print_help()
        return 1
    if args.apply and args.outfile is not None:
        print("ppzap: --apply applies zaps natively and emits no paz "
              "command file; -o/--outfile cannot be combined with it.",
              file=sys.stderr)
        return 1

    from ..config import resolve_device
    from ..io.archive import file_is_type, load_data, parse_metafile
    from ..pipelines.zap import (apply_zaps, get_zap_channels,
                                 print_paz_cmds)

    device = resolve_device(args.device)  # no CUDA device: fail here
    if args.modelfile is not None:
        from ..pipelines.toas import GetTOAs

        gt = GetTOAs(datafiles=args.datafiles, modelfile=args.modelfile,
                     quiet=True, device=device)
        gt.get_TOAs(tscrunch=args.tscrunch, quiet=True)
        gt.get_channels_to_zap(SNR_threshold=args.SNR_threshold,
                               rchi2_threshold=args.rchi2_threshold,
                               iterate=True, show=False)
        ok_datafiles = [gt.datafiles[i] for i in gt.ok_idatafiles]
        if args.apply:
            apply_zaps(ok_datafiles, gt.zap_channels,
                       all_subs=args.tscrunch, modify=args.modify,
                       quiet=args.quiet)
        else:
            print_paz_cmds(ok_datafiles, gt.zap_channels,
                           all_subs=args.tscrunch, modify=args.modify,
                           outfile=args.outfile, quiet=args.quiet)
        nchan = sum(len(s) for arch in gt.channel_red_chi2s for s in arch)
        nzap = sum(len(s) for arch in gt.zap_channels for s in arch)
        if args.hist:
            _save_hist(args, gt.channel_red_chi2s, nchan)
    else:
        if file_is_type(args.datafiles) == "ASCII":
            all_datafiles = parse_metafile(args.datafiles)
        else:
            all_datafiles = [args.datafiles]
        nchan = 0
        nzap = 0
        zap_channels = []
        for datafile in all_datafiles:
            try:
                data = load_data(datafile, dedisperse=False,
                                 dededisperse=False,
                                 tscrunch=args.tscrunch, pscrunch=True,
                                 rm_baseline=True, refresh_arch=False,
                                 return_arch=False, quiet=True,
                                 device=device)
            except (RuntimeError, ValueError, OSError):
                if not args.quiet:
                    print("Cannot load_data(%s).  Skipping it."
                          % datafile)
                # a placeholder keeps zap_channels aligned with
                # all_datafiles: the zap writers pair the lists by index
                zap_channels.append([])
                continue
            nchan += int(np.sum([len(ic) for ic in data.ok_ichans]))
            if args.norm is not None:
                _normalize(data, args.norm, device)
            zaps = get_zap_channels(data, nstd=args.nstd)
            zap_channels.append(zaps)
            nzap += sum(len(s) for s in zaps)
        if args.apply:
            apply_zaps(all_datafiles, zap_channels,
                       all_subs=args.tscrunch, modify=args.modify,
                       quiet=args.quiet)
        else:
            print_paz_cmds(all_datafiles, zap_channels,
                           all_subs=args.tscrunch, modify=args.modify,
                           outfile=args.outfile, quiet=args.quiet)
    if not args.quiet and nchan:
        print("ppzap found %d channels to zap out of a total %d "
              "channels (=%.2f%%) in %s."
              % (nzap, nchan, 100.0 * nzap / nchan, args.datafiles))
    return 0


if __name__ == "__main__":
    sys.exit(main())
