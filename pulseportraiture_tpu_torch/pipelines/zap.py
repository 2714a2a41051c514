"""Standalone channel-zapping heuristics + paz command emission.

Port of the JAX package's ``pipelines/zap.py`` (reference
ppzap.py:18-95): the model-free median-noise cut (``get_zap_channels``),
the paz shell-command writer (``print_paz_cmds``) and the native zap
writer (``apply_zaps``), all host numpy.  The model-based path lives on
``GetTOAs.get_channels_to_zap`` (pipelines/toas.py), as in the
reference.

The median cut here is vectorized across a subintegration's channels
(boolean masks instead of the reference's list.pop loop) but iterates to
the same fixed point: a channel is zapped when its noise level exceeds
the median of the surviving channels by ``nstd`` standard deviations.
"""

import sys

import numpy as np

__all__ = ["get_zap_channels", "print_paz_cmds", "apply_zaps"]


def get_zap_channels(data, nstd=3):
    """Propose channels to zap via the iterated median-noise algorithm.

    data: DataBunch from load_data (or DataPortrait); uses
    data.ok_isubs / data.ok_ichans / data.noise_stds.
    Returns one sorted channel-index list per ARCHIVE subint (list
    position == absolute subint index; excluded subints get an empty
    list), so consumers that address subints by position — paz ``-w``
    emission and ``apply_zaps`` — stay aligned on archives with
    dead subints (reference ppzap.py:18-48).
    """
    zap_channels = [[] for _ in range(data.nsub)]
    for isub in data.ok_isubs:
        ichans = np.asarray(data.ok_ichans[isub], dtype=int)
        alive = np.ones(len(ichans), dtype=bool)
        noise = np.asarray(data.noise_stds[isub, 0, ichans])
        while alive.any():
            ns = noise[alive]
            bad = noise > np.median(ns) + nstd * np.std(ns)
            bad &= alive
            if not bad.any():
                break
            alive &= ~bad
        zap_channels[int(isub)] = sorted(ichans[~alive].tolist())
    return zap_channels


def print_paz_cmds(datafiles, zap_list, all_subs=False, modify=True,
                   outfile=None, quiet=False):
    """Emit paz shell commands for a zap list.

    zap_list[iarch][isub] -> channel indices to zap; all_subs applies a
    channel's zap to every subint (deduplicated); modify=True emits
    in-place ('-m') commands, else a '-e zap' copy first.  outfile
    appends to a file instead of stdout.  Returns the emitted lines
    (reference ppzap.py:50-95).
    """
    if not len(datafiles) or not len(zap_list):
        if not quiet:
            print("Nothing to zap.")
        return []
    lines = []
    for iarch, datafile in enumerate(datafiles):
        count = sum(len(z) for z in zap_list[iarch])
        if count:
            if modify:
                paz_outfile = datafile
            else:
                paz_outfile = _zap_outfile_name(datafile)
                lines.append("paz -e zap %s" % datafile)
        last_line = ""
        for isub, bad_ichans in enumerate(zap_list[iarch]):
            for bad_ichan in bad_ichans:
                if not all_subs:
                    lines.append("paz -m -I -z %d -w %d %s"
                                 % (bad_ichan, isub, paz_outfile))
                else:
                    line = "paz -m -z %d %s" % (bad_ichan, paz_outfile)
                    if line != last_line:
                        lines.append(line)
                    last_line = line
    out = open(outfile, "a") if outfile is not None else sys.stdout
    for line in lines:
        print(line, file=out)
    if outfile is not None:
        out.close()
        if not quiet:
            print("Wrote %s." % outfile)
    return lines


def _zap_outfile_name(datafile):
    """paz '-e zap' naming: replace the final extension with 'zap'
    (append '.zap' when the name has no extension) — the same names
    print_paz_cmds puts in its emitted commands."""
    ii = datafile[::-1].find(".")
    return datafile + ".zap" if ii < 0 else datafile[:-ii] + "zap"


def apply_zaps(datafiles, zap_list, all_subs=False, modify=True,
               quiet=False):
    """Natively apply a zap list: zero weights and rewrite the archives.

    The reference (and `print_paz_cmds`) can only *emit* paz shell
    commands, leaving the actual zapping to psrchive's C++ paz tool.
    This applies the same semantics with the in-repo PSRFITS writer
    (io/psrfits.py), so the zap path works end-to-end in a
    psrchive-free environment (reference ppzap.py:50-95 for
    the command set; pplib.py:3039-3075 for the
    unload-a-modified-archive pattern this replaces).

    zap_list[iarch][isub] -> channel indices to zap in that subint;
    all_subs zaps each listed channel in EVERY subint (paz ``-z`` vs
    ``-z -w``); modify=True rewrites the datafile in place (paz
    ``-m``), else writes a copy named like paz ``-e zap``.

    Returns [(outfile, n_weights_zeroed), ...] for the rewritten
    archives (archives with nothing to zap are left untouched).
    """
    from ..io.psrfits import read_archive

    if len(zap_list) != len(datafiles):
        # strict: a shifted pairing would silently zap the wrong
        # archives (and --modify rewrites them in place)
        raise ValueError(
            "apply_zaps got %d zap list(s) for %d datafile(s); the "
            "lists pair by index and must align exactly"
            % (len(zap_list), len(datafiles)))
    results = []
    for iarch, datafile in enumerate(datafiles):
        zaps = zap_list[iarch]
        if not sum(len(z) for z in zaps):
            continue
        arch = read_archive(datafile)
        weights = np.asarray(arch.weights, dtype=np.float64).copy()
        before = int(np.count_nonzero(weights))
        if all_subs:
            chans = sorted({c for z in zaps for c in z})
            weights[:, chans] = 0.0
        else:
            for isub, bad_ichans in enumerate(zaps):
                if isub >= weights.shape[0]:
                    raise IndexError(
                        "zap_list for %s names subint %d but the "
                        "archive has %d subints"
                        % (datafile, isub, weights.shape[0]))
                weights[isub, list(bad_ichans)] = 0.0
        arch.weights = weights
        outfile = datafile if modify else _zap_outfile_name(datafile)
        arch.unload(outfile, quiet=True)
        nzapped = before - int(np.count_nonzero(weights))
        results.append((outfile, nzapped))
        if not quiet:
            print("Zapped %d channel weight(s) -> %s."
                  % (nzapped, outfile))
    return results
