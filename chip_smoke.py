#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pulseportraiture_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each on stdout; any failure exits non-zero:

  gpu         nvidia-smi name and power limit of the card
  build       nvcc build of every kernel in pulseportraiture_tpu_torch/csrc
  kernels     each hand kernel against its plain PyTorch version on the
              same inputs (error, tolerance, kernel / plain / bound /
              library times): K1 at the main path's width, K2 at
              [256, 1025] (the pptoas archive's guess), [1000, 1025] and
              [131072, 1025] with Ns 100 and [1000, 1025] with Ns 2048,
              grid-argmin mismatches, its time split
              by stage and its first call (phasor table built); K3 at
              [1000, 512, 128] with one shared |m|^2, at [64, 512, 128]
              with per-subint |m|^2 and a lane subset, and at
              [7636, 1, 128] (narrowband --fit_scat: one channel and one
              |m|^2 per lane).  Kernel
              and library times are device times from CUDA-graph replay;
              ``call_ms`` is the wrapper's time per call, host included
              (back-to-back CUDA events)
  pptoas      the port's pptoas CLI on a 256-subint x 512-channel x 2048-bin
              archive (written by the port's make_fake_pulsar from
              examples/; subint 3 has one live channel, so both fit-flag
              groups run): 256 TOAs, injected phase and dDM recovered
              within 5 sigma, K1 and K2 launched; a 16-subint subset
              re-run with the plain versions swapped in agrees within 1 ns
  pptoas_scat the same archive with --fit_scat (the model scatters with
              TAU = 20 us at 1500 MHz, alpha -4): 256 TOAs, phase, dDM
              and the scattering time at scat_ref_freq recovered within
              5 sigma, K2 and K3 launched (the one-channel subint fits phase
              alone at the model's fixed tau: K3 too); the 16-subint
              subset against the plain versions (1 ns; tau and alpha
              within 5e-7 / 1e-5 plus the printed digit); then --fit_dt4
              on the 16-subint archive, kernels against plain (the
              (1,1,1,0,0) roots path, K1 and K2 launched)
  narrowband  pptoas --narrowband --print_phase --print_flux on the
              256-subint archive: one TOA per live (subint, channel)
              (129,796, all in one K2 launch), the injected phase
              dispersed to each channel recovered (max |z| < 6, |mean z|
              < 0.05), K2 launched; CLI wall, fit and TOA-assembly seconds,
              K2 device time at this M (torch.profiler on the fit), peak
              device memory; the 16-subint archive through GetTOAs with
              the plain versions swapped in (1 ns, fluxes 1e-9 relative)
  narrowband_scat  --narrowband --fit_scat on the 16-subint archive (one
              one-channel K3 fit per live channel): K2 and K3 launched,
              every rc a code of the JAX package, kernels against plain
              (1 ns; log10 tau within 5e-7 plus the printed digit), the
              median z of log10 tau against the injected tau
  templates   wideband pptoas --print_flux on the 16-subint archive with a
              spline template (the .gmodel portrait: numpy SVD to six
              eigenprofiles, scipy splprep, the port's write_spline_model)
              and a FITS template (the port's make_fake_pulsar, one
              subint, no noise): phase and DM within 5 sigma, K1 and K2
              launched, kernels against plain (1 ns)
  ppzap       ppzap -m -R 1.05 on the 16-subint archive: kernel and plain
              runs list the same channels; --apply (no --modify) zeroes
              exactly the listed weights in the .zap copy
  ppalign     the port's ppalign --niter 2 on 8 epochs of 16 x 512 x 2048
              (make_fake_pulsar, noise 0.5, each with its own seed, phase
              in +-0.3 rot and dDM in +-3e-3) against the noiseless
              one-subint FITS template: one 128-row block per iteration;
              K1 and K2 launched and held against their plain versions on
              the inputs the path gave them; the aligned portrait against
              the noiseless model (one amplitude per channel, DC left
              out: residual rms within 1.5 x noise/sqrt(rows)); load and
              fit seconds; one block's device time (torch.profiler) and
              its rotation's (B8, with its bound); a 2-epoch subset with
              the plain versions swapped in (within 1e-9 of the peak)
  ppspline    ppspline -s on the aligned archive: eigenprofiles, the
              eigensolve and smart_smooth at its shapes (B9, with their
              bounds); pptoas with the .spl on the 16-subint archive:
              phase and DM within 5 sigma, plain vs kernel 1 ns
  ppgauss     ppgauss --autogauss 0.05 --niter 2 on the aligned archive:
              components, LM nfev and rc, the Jacobian pass's device time
              (B9), a plain-versions run (parameters within 1e-6 of their
              errors); pptoas with the .gmodel: plain vs kernel 1 ns,
              phase and DM within 5 sigma once referred to the initial
              template's phase zero and DM reference (the model's own
              offsets against the template, a fit of one noiseless
              portrait to the other, are added to each TOA)
  walkthrough examples/example.py through the port at full width: 5
              scintillated, dispersed epochs of 10 x 512 x 2048 (noise
              1.5, own seeds, dDM ~ N(3e-4, 2e-4), the spin perturbation
              dF0 2e-9 Hz, dF1 4e-17 Hz/s injected as phase) -> align
              (niter 1) -> spline model -> wideband TOAs -> .tim -> the
              DMDATA 1 + DMX GLS fit of F0 and F1: example.py's own DM
              and GLS criteria, K1 and K2 launched, the pptoas step rerun
              with the plain versions (1 ns); seconds per step and in
              load_data, the GLS's wrms and reduced chi2
  synth       make_fake_dataset (B11) making the throughput data on the
              card: seconds, bound, peak device memory
  throughput  fit_portrait_full_batch(init_params=None) at 1000 x 512 x
              2048 (data made on the card by the port's make_fake_dataset
              at phases and dDMs from a seeded torch.Generator; the
              phases seeded through K2): TOAs/s, K1 launches, K1 ms
              per launch (torch.profiler, a separate run), peak device
              memory
  noise_fit   get_noise_fit (B10) on the first 256 subints of the
              throughput data (131,072 channels, three zeroed in every
              subint): ms, bound, extra peak memory; the Wiener and
              brickwall smoothing of one subint's 512 profiles; that
              subint against the port on the CPU (k_crit and brickwall
              cutoffs equal, noise within 1e-12 relative, zeroed
              channels 0)
  throughput_scat  the north-star scattering fit at 1000 x 512 x 2048:
              tau 3e-3 rot at nu0, alpha -4, started at 1.5 x tau,
              flags (1,1,0,1,1), log10 tau, nu_fits = nu_outs = nu0,
              max_iter 30: TOAs/s, K3 launches and ms per launch, nfeval,
              return codes, tau recovery, peak device memory

Then a ``kernels`` line (every hand kernel with its launches on its
paths — K1 and K2 on pptoas, K3 on pptoas_scat, each plus the narrowband,
narrowband_scat, templates and ppzap runs, K1 and K2 also on ppalign,
ppspline, ppgauss and the walkthrough, with ``launches_by_path`` —
errors and times; K2 with
its [1000, 1025] numbers and K3 with its [1000, 512, 128] ones, each with a
``shapes`` list of all its cases), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when no CUDA device is available or the package is missing.

Option (a diagnostic; the smoke itself takes none):
  --profile DIR  also profile the pptoas CLI (cProfile for host time,
                 torch.profiler for device time); the tables go to
                 DIR/pptoas_profile.txt, a summary to stdout
"""

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# published peaks of one H100 SXM (NVIDIA H100 data sheet, 700 W): HBM3
# bandwidth, FP64 outside the tensor cores (trig, FMAs) and FP64 on the
# tensor cores (a float64 matrix product)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP64_PER_S = 34e12
PEAK_FP64_TENSOR_PER_S = 67e12

# model and north-star injections of the repo's benchmark configuration
MODEL_PARAMS = [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]
P0, NOISE = 0.005, 0.05
TAU_INJ = 3e-3  # the scattering configuration's tau [rot] at nu0

# K3's FP64 operations per harmonic (sincospi counted as 2, the division
# as 1), counted from csrc/moments_scat.cu
K3_OPS = 81


def emit(phase, **kw):
    print(json.dumps(dict(phase=phase, **kw)), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warm=3):
    """Mean device time [ms] of fn() over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps=20):
    """Device time [ms] per fn() call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's time to launch them is left out."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph
    return a.elapsed_time(b) / reps


def bound_ms(nbytes, *work):
    """Least time [ms] for moving ``nbytes`` or doing ``work``, a list of
    (operations, peak rate per second); and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / rate for n, rate in work) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def phase_kernels(dev, kern, K=128):
    """K1 at [100, 512, K] and K2 at each of K2_CASES against their plain
    versions, with times and bounds (``kern`` is the _kernels module)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = {}

    # K1: moments.  ~18 FP64 operations per harmonic (incl. sincospi as 2)
    n, nchan = 100, 512
    cross = torch.complex(torch.randn((n, nchan, K), generator=gen,
                                      device=dev, dtype=torch.float64),
                          torch.randn((n, nchan, K), generator=gen,
                                      device=dev, dtype=torch.float64))
    shifts = (torch.rand((n, nchan), generator=gen, device=dev,
                         dtype=torch.float64) - 0.5) * 4000.0
    inv_err2 = torch.rand((n, nchan), generator=gen, device=dev,
                          dtype=torch.float64) + 0.5
    got = kern.moments(cross, shifts, inv_err2)
    want = kern.moments_plain(cross, shifts, inv_err2)
    torch.cuda.synchronize()
    err = max(rel_err(got[..., i], want[..., i]) for i in range(3))
    tol = 1e-12
    nb = cross.numel() * 16 + shifts.numel() * 8 * 2 + got.numel() * 8
    bms, by = bound_ms(nb, (cross.numel() * 18, PEAK_FP64_PER_S))
    rows["moments"] = dict(
        shape=[n, nchan, K], max_rel_err=err, tol=tol,
        max_abs_err=float((got - want).abs().max()),
        ms=graph_ms(lambda: kern.moments(cross, shifts, inv_err2)),
        call_ms=cuda_ms(lambda: kern.moments(cross, shifts, inv_err2)),
        plain_ms=cuda_ms(lambda: kern.moments_plain(cross, shifts, inv_err2),
                         reps=5),
        bound_ms=bms, bound_by=by, library_ms=None)
    emit("kernels", kernel="moments", **rows["moments"])
    if not err <= tol:
        raise AssertionError("moments kernel disagrees: %g > %g"
                             % (err, tol))
    del cross, shifts, inv_err2, got, want

    rows["fftfit"] = [phase_k2(dev, kern, gen, N, Ns, lo, hi,
                               time_plain=N <= 1000)
                      for N, Ns, lo, hi in K2_CASES]
    rows["moments_scat"] = [phase_k3(dev, kern, gen, *case)
                            for case in K3_CASES]
    return rows


# K3 cases: (subints, channels, harmonics, one |m|^2 shared by the batch,
# rows evaluated: a lane subset of that many subints, or all when None)
K3_CASES = [
    (1000, 512, 128, True, None),   # throughput_scat: the batch, one model
    (64, 512, 128, False, 40),      # pptoas chunks: per-subint models, lanes
    (7636, 1, 128, False, None),    # narrowband --fit_scat, 16 subints:
                                    # one channel and one model per lane
]
K3_MAIN = 0


def phase_k3(dev, kern, gen, n, nchan, K, shared, nlanes):
    """K3 against moments_scat_plain: each sum's error relative to its
    largest magnitude over the rows, device times, bound."""
    import torch

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float64)

    cross = torch.complex(torch.randn((n, nchan, K), generator=gen,
                                      device=dev, dtype=torch.float64),
                          torch.randn((n, nchan, K), generator=gen,
                                      device=dev, dtype=torch.float64))
    abs_m2 = rand(1 if shared else n, nchan, K) * 2.0
    inv_err2 = rand(n, nchan) + 0.5
    m = n if nlanes is None else nlanes
    lanes = None if nlanes is None else torch.sort(torch.randperm(
        n, generator=gen, device=dev)[:nlanes]).values
    shifts = (rand(m, nchan) - 0.5) * 4000.0
    taus = rand(m, nchan) * 0.02  # up to ~40 bins of 2048

    def k3():
        return kern.moments_scat(cross, abs_m2, shifts, taus, inv_err2, lanes)

    def plain():
        return kern.moments_scat_plain(cross, abs_m2, shifts, taus, inv_err2,
                                       lanes)

    got, want = k3(), plain()
    torch.cuda.synchronize()
    errs = {name: rel_err(got[..., j], want[..., j])
            for j, name in enumerate(kern.MOMENTS_SCAT_SUMS)}
    err, tol = max(errs.values()), 1e-12
    # bytes: the rows' cross (and per-subint |m|^2) read once, the shared
    # |m|^2 once, shifts/taus/inv_err2 per row, nine sums out
    nb = m * nchan * K * 16 + (nchan * K if shared else m * nchan * K) * 8 \
        + m * nchan * 8 * 3 + got.numel() * 8
    bms, by = bound_ms(nb, (m * nchan * K * K3_OPS, PEAK_FP64_PER_S))
    row = dict(shape=[n, nchan, K], shared_abs_m2=shared, lanes=nlanes,
               max_rel_err=err, rel_err_by_sum=errs, tol=tol,
               max_abs_err=float((got - want).abs().max()),
               ms=graph_ms(k3), call_ms=cuda_ms(k3),
               plain_ms=cuda_ms(plain, reps=3, warm=1),
               bound_ms=bms, bound_by=by, library_ms=None)
    row["share_of_bound"] = bms / row["ms"]
    emit("kernels", kernel="moments_scat", **row)
    if not err <= tol:
        raise AssertionError("moments_scat kernel disagrees at %s: %s"
                             % ([n, nchan, K], errs))
    return row


# K2 cases: (N profiles, Ns grid points, bounds); nharm 1025 (nbin 2048)
K2_CASES = [
    (256, 100, -0.5, 0.5),     # the pptoas archive's guess (main path)
    (1000, 100, -0.5, 0.5),    # the north-star seed
    (131072, 100, -0.5, 0.5),  # one profile per (subint, channel)
    (1000, 2048, -0.5, 0.5),   # the Ns = nbin callers (align)
]
K2_MAIN = 1  # the case whose numbers stand in the kernels line


def k2_inputs(dev, gen, N, nbin=2048, chunk=16384):
    """Cross-spectra [N, nbin/2+1] of a pulse + noise at random phases,
    made on the card in chunks, and inv_err2 [N]."""
    import torch

    from pulseportraiture_tpu_torch.fit.phase_shift import cross_spectrum
    from pulseportraiture_tpu_torch.ops.fourier import rotate_profile

    x = (torch.arange(nbin, dtype=torch.float64, device=dev) + 0.5) / nbin
    prof = torch.exp(-0.5 * ((x - 0.35) / 0.02) ** 2)
    cr = torch.empty((N, nbin // 2 + 1), dtype=torch.complex128, device=dev)
    for i in range(0, N, chunk):
        n = min(chunk, N - i)
        ph = (torch.rand(n, generator=gen, device=dev,
                         dtype=torch.float64) - 0.5) * 0.9
        data = rotate_profile(prof.expand(n, nbin), -ph) + 0.05 * torch.randn(
            (n, nbin), generator=gen, device=dev, dtype=torch.float64)
        cr[i:i + n] = cross_spectrum(data, prof.expand(n, nbin))[0]
    w = torch.full((N,), 1.0 / (0.05 ** 2 * nbin / 2), dtype=torch.float64,
                   device=dev)
    return cr, w


def k2_grid_argmin(kern, cr, w, lo, hi, Ns):
    """The kernel's grid argmin [N]: its per-group partials merged by the
    first-minimum rule (a NaN first, then the least value, then the
    lowest index)."""
    import torch

    _, scratch = kern._fftfit_launch(cr, w, lo, hi, Ns, 0, stages=1,
                                     count=False)
    pval, pidx = kern.fftfit_partials(scratch, cr.shape[0], Ns)
    pidx = pidx.long()
    nan = torch.isnan(pval)
    big = torch.iinfo(torch.int64).max
    m = torch.where(nan, math.inf, pval).amin(dim=1, keepdim=True)
    return torch.where(nan.any(dim=1),
                       torch.where(nan, pidx, big).amin(dim=1),
                       torch.where(pval == m, pidx, big).amin(dim=1))


def phase_k2(dev, kern, gen, N, Ns, lo, hi, newton=6, time_plain=True):
    """K2 at [N, 1025] against fftfit_plain: errors, grid-argmin
    mismatches, device times by stage (CUDA graphs), the wrapper's time
    per call, bound, library."""
    import torch

    cr, w = k2_inputs(dev, gen, N)
    nharm = cr.shape[-1]
    kern._TABLES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = kern.fftfit(cr, w, lo, hi, Ns, newton)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    want = kern.fftfit_plain(cr, w, lo, hi, Ns, newton)
    torch.cuda.synchronize()
    tol_phase, tol = 1e-9, 1e-12
    dphase = float((got[0] - want[0]).abs().max())
    err = max(rel_err(got[1], want[1]), rel_err(got[2], want[2]))
    cg, _ = kern.fftfit_grid_plain(cr, lo, hi, Ns)
    ip, ik = torch.argmin(cg, dim=-1), k2_grid_argmin(kern, cr, w, lo, hi, Ns)
    diff = ip != ik
    rows = torch.arange(N, device=dev)
    gap = ((cg[rows, ik] - cg[rows, ip]).abs()
           / cg.abs().amax(dim=1).clamp_min(1e-300))[diff]
    n_mismatch = int(diff.sum())
    max_gap = float(gap.max()) if n_mismatch else 0.0
    del cg

    # device time of each stage alone (the table already cached)
    T = kern.fftfit_table(nharm, lo, hi, Ns, dev)
    _, scratch = kern._fftfit_launch(cr, w, lo, hi, Ns, newton, stages=1,
                                     count=False)

    def stage(stages):
        return graph_ms(lambda: kern._fftfit_launch(
            cr, w, lo, hi, Ns, newton, stages=stages, scratch=scratch,
            count=False))

    stage_ms = dict(
        table=graph_ms(lambda: kern._launch(
            "fftfit", dev, T.data_ptr(), nharm, Ns, lo, hi,
            symbol="pp_fftfit_table", count=False)),
        grid=stage(1), newton=stage(2))
    del T, scratch
    ms = graph_ms(lambda: kern.fftfit(cr, w, lo, hi, Ns, newton))
    call_ms = cuda_ms(lambda: kern.fftfit(cr, w, lo, hi, Ns, newton))
    plain_ms = cuda_ms(lambda: kern.fftfit_plain(cr, w, lo, hi, Ns, newton),
                       reps=3, warm=1) if time_plain else None
    grid = lo + (hi - lo) * torch.arange(Ns, dtype=torch.float64,
                                         device=dev) / Ns
    k = torch.arange(nharm, dtype=torch.float64, device=dev)
    table = torch.polar(torch.ones(nharm, Ns, dtype=torch.float64,
                                   device=dev),
                        2 * math.pi * torch.remainder(k[:, None] * grid, 1.0))
    library_ms = graph_ms(lambda: torch.matmul(cr, table))
    del table
    # the grid stage is one float64 product [N, 2 nharm] x [2 nharm, Ns]
    # with a table the profiles share (4 operations per complex term, FP64
    # tensor cores); each Newton step and the final objective take ~18 FP64
    # operations (sincospi as 2) per harmonic
    bms, by = bound_ms(cr.numel() * 16 + N * 8 + 3 * N * 8,
                       (4 * N * nharm * Ns, PEAK_FP64_TENSOR_PER_S),
                       (18 * N * nharm * (newton + 1), PEAK_FP64_PER_S))
    row = dict(
        shape=[N, nharm], Ns=Ns, bounds=[lo, hi], newton_iter=newton,
        max_phase_err=dphase, tol_phase=tol_phase, max_rel_err=err, tol=tol,
        max_abs_err=max(dphase, float((got[1] - want[1]).abs().max()),
                        float((got[2] - want[2]).abs().max())),
        argmin_mismatches=n_mismatch, argmin_max_rel_gap=max_gap,
        ms=ms, call_ms=call_ms, first_call_ms=first_ms, stage_ms=stage_ms,
        plain_ms=plain_ms,
        plain_note=None if time_plain else "plain timing skipped for time",
        bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
        library_ms=library_ms)
    emit("kernels", kernel="fftfit", **row)
    if not (dphase <= tol_phase and err <= tol):
        raise AssertionError("fftfit kernel disagrees at %s: phase %g, rel %g"
                             % ([N, nharm, Ns], dphase, err))
    if not max_gap <= tol:
        raise AssertionError("fftfit grid argmin differs at %s by %g of the "
                             "row's |Cgrid|" % ([N, nharm, Ns], max_gap))
    return row


def read_tim(path):
    """[(mjd_day, mjd_frac_str, freq, flags dict, pp_dm, pp_dme)]."""
    out = []
    for ln in open(path):
        tok = ln.split()
        if not tok or tok[0] in ("FORMAT", "C"):
            continue
        flags = {}
        i = 5
        while i + 1 < len(tok):
            flags[tok[i][1:]] = tok[i + 1]
            i += 2
        day, frac = tok[2].split(".")
        out.append(dict(day=int(day), frac="0." + frac, freq=float(tok[1]),
                        err_us=float(tok[3]), flags=flags))
    return out


@contextlib.contextmanager
def plain_kernels(K):
    """Swap the plain versions in for the kernels (the comparison run)."""
    saved = K.moments, K.fftfit, K.moments_scat
    K.moments, K.fftfit, K.moments_scat = (K.moments_plain, K.fftfit_plain,
                                           K.moments_scat_plain)
    try:
        yield
    finally:
        K.moments, K.fftfit, K.moments_scat = saved


def run_cli(K, argv):
    """The port's pptoas CLI with every launch count set to 0 just before
    it: (TOA lines, wall seconds, launches of that run)."""
    from pulseportraiture_tpu_torch.cli import pptoas

    K.reset_launches()
    t0 = time.perf_counter()
    rc = pptoas.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError("pptoas %s exited %d" % (" ".join(argv), rc))
    return read_tim(argv[argv.index("-o") + 1]), wall, launches


def max_dt_ns(a_toas, b_toas):
    return max(abs((a["day"] - b["day"]) * 86400e9
                   + (float(a["frac"]) - float(b["frac"])) * 86400e9)
               for a, b in zip(a_toas, b_toas))


def flag_gap(a_toas, b_toas, key):
    """Largest difference of a printed flag between two .tim files."""
    return max(abs(float(a["flags"][key]) - float(b["flags"][key]))
               for a, b in zip(a_toas, b_toas) if key in b["flags"])


# the pptoas archives' injection (at nu0 = 1500 MHz)
PHASE_INJ, DDM_INJ, NU0 = 0.1234, 3.1e-3, 1500.0


def smoke_weights(nsub, nchan):
    """The pptoas archives' channel weights: three channels zapped, and
    subint 3 with one live channel (fitted with flags (1,0,0,0,0))."""
    import numpy as np

    weights = np.ones((nsub, nchan))
    weights[:, [7, nchan // 5, nchan * 2 // 3]] = 0.0
    weights[3] = 0.0
    weights[3, nchan // 2] = 1.0
    return weights


def phase_pptoas(root, work, K, shape=(256, 512, 2048), subset=16,
                 extra=(), profile_dir=None):
    """The port's pptoas CLI on a ``shape`` (nsub, nchan, nbin) archive;
    ``extra`` CLI arguments are appended to both runs.  Returns the
    launches of the main run and the two archives' paths."""
    import numpy as np

    from pulseportraiture_tpu_torch.config import Dconst
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
    from pulseportraiture_tpu_torch.io.parfile import read_par

    gm = os.path.join(root, "examples", "example.gmodel")
    par = os.path.join(root, "examples", "example.par")
    (nsub, nchan, nbin), nu0 = shape, 1500.0
    phase_inj, dDM_inj = PHASE_INJ, DDM_INJ
    weights = smoke_weights(nsub, nchan)
    kw = dict(nchan=nchan, nbin=nbin, nu0=nu0, bw=800.0, tsub=60.0,
              phase=phase_inj, dDM=dDM_inj, noise_stds=0.5, seed=11)
    t0 = time.perf_counter()
    big = make_fake_pulsar(gm, par, os.path.join(work, "smoke256.fits"),
                           nsub=nsub, weights=weights, **kw)
    small = make_fake_pulsar(gm, par, os.path.join(work, "smoke16.fits"),
                             nsub=subset, weights=weights[:subset], **kw)
    t_make = time.perf_counter() - t0

    argv = ["-d", big, "-m", gm, "--no_bary", "--print_phase", *extra,
            "--quiet", "-o", os.path.join(work, "smoke256.tim")]
    toas, t_cli, launches = run_cli(K, argv)
    if len(toas) != nsub:
        raise AssertionError("%d TOA lines, want %d" % (len(toas), nsub))
    DM = float(read_par(par).get("DM")) + dDM_inj
    P = 1.0 / float(read_par(par).F0)
    zDM, zphi, no_dm = [], [], []
    for isub, t in enumerate(toas):
        f = t["flags"]
        if "pp_dm" in f:
            zDM.append((float(f["pp_dm"]) - DM) / float(f["pp_dme"]))
        else:  # DM not fitted
            no_dm.append(isub)
        nu = t["freq"]
        want = phase_inj + Dconst * DM * (nu ** -2 - nu0 ** -2) / P
        d = (float(f["phs"]) - want + 0.5) % 1.0 - 0.5
        zphi.append(d / float(f["phs_err"]))
    if no_dm != [3]:
        raise AssertionError("TOAs without a fitted DM: %s, want only the "
                             "one-channel subint 3" % no_dm)
    zDM, zphi = np.abs(zDM), np.abs(zphi)
    if not (zDM.max() < 5 and zphi.max() < 5):
        raise AssertionError("injection not recovered: max |z| DM %.2f, "
                             "phase %.2f" % (zDM.max(), zphi.max()))
    missing = [name for name in ("moments", "fftfit") if launches[name] == 0]
    if missing:
        raise AssertionError("kernels never launched on the pptoas path: %s"
                             % missing)

    with plain_kernels(K):
        plain, _, _ = run_cli(K, ["-d", small] + argv[2:-1] + [
            os.path.join(work, "smoke16_plain.tim")])
    dt_ns = max_dt_ns(toas[:subset], plain)
    if len(plain) != subset or not dt_ns < 1.0:
        raise AssertionError("plain vs kernel TOAs differ by %.3g ns"
                             % dt_ns)
    if profile_dir is not None:
        profile_cli(argv[:-2] + ["-o", os.path.join(work, "prof.tim")],
                    profile_dir)
    emit("pptoas", archive=[nsub, nchan, nbin], n_toas=len(toas),
         make_s=t_make, cli_s=t_cli, toas_per_s=nsub / t_cli,
         launches=launches, max_abs_z_DM=float(zDM.max()),
         max_abs_z_phase=float(zphi.max()),
         median_toa_err_us=float(np.median([t["err_us"] for t in toas])),
         plain_vs_kernel_max_ns=dt_ns)
    return launches, big, small


def phase_pptoas_scat(root, work, K, big, small, shape=(256, 512, 2048),
                      subset=16, nu0=1500.0):
    """--fit_scat on the pptoas archive (recovery, K2 + K3 launched), the
    16-subint one against the plain versions, then --fit_dt4 on it,
    kernels against plain.  Returns the launches of the --fit_scat run."""
    import numpy as np

    from pulseportraiture_tpu_torch.config import Dconst
    from pulseportraiture_tpu_torch.io.gmodel import read_model
    from pulseportraiture_tpu_torch.io.parfile import read_par

    gm = os.path.join(root, "examples", "example.gmodel")
    par = os.path.join(root, "examples", "example.par")
    nsub = shape[0]
    _, _, nu_tau0, _, gparams, _, alpha0, _ = read_model(gm)
    tau0 = float(gparams[1])  # [s] at nu_tau0: what make_fake_pulsar injected
    DM = float(read_par(par).get("DM")) + 3.1e-3
    P = 1.0 / float(read_par(par).F0)
    phase_inj = 0.1234
    base = ["-m", gm, "--no_bary", "--print_phase", "--quiet"]

    toas, t_cli, launches = run_cli(K, ["-d", big, "--fit_scat"] + base
                                    + ["-o", os.path.join(work, "s256.tim")])
    if len(toas) != nsub:
        raise AssertionError("%d scattering TOA lines, want %d"
                             % (len(toas), nsub))
    z = dict(DM=[], phase=[], tau=[], alpha=[])
    for t in toas:
        f = t["flags"]
        if "pp_dm" in f:
            z["DM"].append((float(f["pp_dm"]) - DM) / float(f["pp_dme"]))
        want = phase_inj + Dconst * DM * (t["freq"] ** -2 - nu0 ** -2) / P
        d = (float(f["phs"]) - want + 0.5) % 1.0 - 0.5
        z["phase"].append(d / float(f["phs_err"]))
        if "log10_scat_time_err" in f:
            nu = float(f["scat_ref_freq"])
            inj = math.log10(tau0 * (nu / nu_tau0) ** alpha0)
            z["tau"].append((float(f["log10_scat_time"]) - inj)
                            / float(f["log10_scat_time_err"]))
            z["alpha"].append((float(f["scat_ind"]) - alpha0)
                              / float(f["scat_ind_err"]))
    zmax = {k: float(np.abs(v).max()) for k, v in z.items()}
    if len(z["tau"]) != nsub - 1 or not max(zmax.values()) < 5:
        raise AssertionError("scattering injection not recovered: max |z| "
                             "%s over %d tau fits" % (zmax, len(z["tau"])))
    missing = [n for n in ("fftfit", "moments_scat") if launches[n] == 0]
    if missing:
        raise AssertionError("kernels never launched on the --fit_scat path:"
                             " %s" % missing)

    # the 16-subint archive: kernels, then plain versions
    def pair(flags, tag):
        argv = ["-d", small] + flags + base
        kern, _, kl = run_cli(K, argv + ["-o", os.path.join(
            work, tag + "_k.tim")])
        with plain_kernels(K):
            plain, _, _ = run_cli(K, argv + ["-o", os.path.join(
                work, tag + "_p.tim")])
        return kern, plain, kl

    kern, plain, _ = pair(["--fit_scat"], "s16")
    scat_dt = max_dt_ns(kern, plain)
    gaps = {key: flag_gap(kern, plain, key) for key in (
        "log10_scat_time", "scat_ind", "scat_ind_err")}
    # printed with 3 decimals: the printed digit plus the tau/alpha bounds
    if not (scat_dt < 1.0 and gaps["log10_scat_time"] <= 1e-3 + 5e-7
            and gaps["scat_ind"] <= 1e-3 + 1e-5):
        raise AssertionError("--fit_scat plain vs kernel: %.3g ns, %s"
                             % (scat_dt, gaps))
    kern, plain, dt4_launches = pair(["--fit_dt4"], "g16")
    dt4_dt = max_dt_ns(kern, plain)
    if not dt4_dt < 1.0:
        raise AssertionError("--fit_dt4 plain vs kernel: %.3g ns" % dt4_dt)
    missing = [n for n in ("moments", "fftfit") if dt4_launches[n] == 0]
    if missing:
        raise AssertionError("kernels never launched on the --fit_dt4 path:"
                             " %s" % missing)
    emit("pptoas_scat", archive=list(shape), n_toas=len(toas),
         cli_s=t_cli, toas_per_s=len(toas) / t_cli, launches=launches,
         max_abs_z=zmax, n_tau_fits=len(z["tau"]),
         median_toa_err_us=float(np.median([t["err_us"] for t in toas])),
         plain_vs_kernel_max_ns=scat_dt, plain_vs_kernel_flag_gaps=gaps,
         fit_dt4=dict(archive=[subset] + list(shape[1:]),
                      launches=dt4_launches,
                      plain_vs_kernel_max_ns=dt4_dt,
                      gm_gap=flag_gap(kern, plain, "gm")))
    return launches


@contextlib.contextmanager
def clocked(owner, names, profiled=(), keep_args=(), keep_out=()):
    """Wrap functions of ``owner`` (a class's methods or a module's
    functions) for the block: each call's wall seconds (after a device
    synchronize) go to clock[name], and for a class the instance it ran
    on to clock["self"]; the functions in ``profiled`` run under
    torch.profiler, whose runs go to clock["prof"]; the arguments of the
    first call of each function in ``keep_args`` go to
    clock[name + "_args"], the results of those in ``keep_out`` to
    clock[name + "_out"]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    clock = dict(self=[], prof=[], **{n: [] for n in names})
    clock.update({n + "_out": [] for n in keep_out})
    saved = {n: getattr(owner, n) for n in names}

    def wrap(name, fn):
        def timed(*a, **kw):
            if isinstance(owner, type):
                clock["self"].append(a[0])
            if name in keep_args and name + "_args" not in clock:
                clock[name + "_args"] = (a, kw)
            ctx = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) \
                if name in profiled else contextlib.nullcontext()
            with ctx as prof:
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                clock[name].append(time.perf_counter() - t0)
            if prof is not None:
                clock["prof"].append(prof)
            if name in keep_out:
                clock[name + "_out"].append(out)
            return out
        return timed

    for n, fn in saved.items():
        setattr(owner, n, wrap(n, fn))
    try:
        yield clock
    finally:
        for n, fn in saved.items():
            setattr(owner, n, fn)


def max_dt_ns_list(a, b):
    """Largest TOA difference [ns] between two TOA_lists of one order."""
    if len(a) != len(b):
        raise AssertionError("%d TOAs against %d" % (len(a), len(b)))
    return max(abs((x.MJD.day - y.MJD.day) * 86400.0 + x.MJD.secs
                   - y.MJD.secs) * 1e9 for x, y in zip(a, b))


def gettoas_pair(K, datafile, model, method, **kw):
    """GetTOAs.<method> on the card with the kernels, then with the plain
    versions swapped in: (kernel run, plain run)."""
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    runs = []
    for plain in (False, True):
        gt = GetTOAs(datafile, model, quiet=True, device="cuda")
        with plain_kernels(K) if plain else contextlib.nullcontext():
            getattr(gt, method)(**kw)
        runs.append(gt)
    return runs


def z_phase(toas, DM, P, nu0=NU0):
    """(phs - injected phase dispersed to each TOA's frequency) / phs_err
    of .tim TOAs with phs flags."""
    import numpy as np

    from pulseportraiture_tpu_torch.config import Dconst

    z = []
    for t in toas:
        f = t["flags"]
        want = PHASE_INJ + Dconst * DM * (t["freq"] ** -2 - nu0 ** -2) / P
        z.append(((float(f["phs"]) - want + 0.5) % 1.0 - 0.5)
                 / float(f["phs_err"]))
    return np.array(z)


def phase_narrowband(root, work, K, big, small, shape=(256, 512, 2048),
                     subset=16):
    """pptoas --narrowband --print_phase --print_flux on the pptoas
    archive: one TOA per live (subint, channel), the injected phase
    dispersed to each channel recovered (max |z| < 6 over ~130k draws,
    |mean z| < 0.05), K2 launched; wall, fit and TOA-assembly seconds,
    the device-busy seconds of the run and K2's device time at this M
    (torch.profiler over get_narrowband_TOAs), peak device memory; the
    16-subint archive against the plain versions (1 ns, fluxes 1e-9).
    Returns the launches of the main run."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.io.parfile import read_par
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    gm = os.path.join(root, "examples", "example.gmodel")
    par = os.path.join(root, "examples", "example.par")
    nsub, nchan, _ = shape
    n_live = int((smoke_weights(nsub, nchan) > 0).sum())
    argv = ["-d", big, "-m", gm, "--narrowband", "--print_phase",
            "--print_flux", "--quiet", "-o", os.path.join(work, "nb.tim")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with clocked(GetTOAs, ("get_narrowband_TOAs", "_narrowband_fit",
                           "_narrowband_toas"),
                 profiled=("get_narrowband_TOAs",)) as clock:
        toas, t_cli, launches = run_cli(K, argv)
    peak = torch.cuda.max_memory_allocated()
    if len(toas) != n_live:
        raise AssertionError("%d narrowband TOAs, want %d live channels"
                             % (len(toas), n_live))
    DM = float(read_par(par).get("DM")) + DDM_INJ
    P = 1.0 / float(read_par(par).F0)
    z = z_phase(toas, DM, P)
    if not (np.abs(z).max() < 6.0 and abs(z.mean()) < 0.05):
        raise AssertionError("narrowband phases not recovered: max |z| %.2f,"
                             " mean z %.4f" % (np.abs(z).max(), z.mean()))
    if launches["fftfit"] == 0:
        raise AssertionError("K2 never launched on the narrowband path")
    k2 = kernel_times(clock["prof"][0], K).get("fftfit")
    # every device operation of the CLI runs inside get_narrowband_TOAs
    # (outside it: argument parsing and the .tim write, on the host)
    rows = device_rows(clock["prof"][0])
    busy = sum(r[1] for r in rows)

    kern, plain = gettoas_pair(K, small, gm, "get_narrowband_TOAs",
                               print_flux=True)
    dt_ns = max_dt_ns_list(kern.TOA_list, plain.TOA_list)
    f, g = kern.profile_fluxes[0], plain.profile_fluxes[0]
    flux_rel = float(np.abs(f - g).max() / np.abs(g).max())
    if not (dt_ns < 1.0 and flux_rel <= 1e-9):
        raise AssertionError("narrowband plain vs kernel: %.3g ns, flux "
                             "%.3g" % (dt_ns, flux_rel))
    emit("narrowband", archive=list(shape), n_toas=len(toas),
         n_live_channels=n_live, cli_s=t_cli, toas_per_s=len(toas) / t_cli,
         fit_s=clock["_narrowband_fit"][0],
         toa_assembly_s=clock["_narrowband_toas"][0],
         method_s=clock["get_narrowband_TOAs"][0], profiled=True,
         device_busy_s=busy, device_idle_share=1.0 - busy / t_cli,
         device_top=[[key[:60], dev_s * 1e3, n] for key, dev_s, n in
                     sorted(rows, key=lambda r: -r[1])[:8]],
         launches=launches,
         k2_device_ms=k2[1] / k2[0] if k2 else None,
         k2_launches_profiled=k2[0] if k2 else 0,
         peak_device_bytes=int(peak), max_abs_z_phase=float(np.abs(z).max()),
         mean_z_phase=float(z.mean()), std_z_phase=float(z.std()),
         median_toa_err_us=float(np.median([t["err_us"] for t in toas])),
         plain_vs_kernel=dict(archive=[subset] + list(shape[1:]),
                              max_ns=dt_ns, flux_max_rel=flux_rel))
    return launches


def phase_narrowband_scat(root, work, K, small, shape=(256, 512, 2048),
                          subset=16):
    """pptoas --narrowband --fit_scat on the 16-subint archive (one K3
    fit per live channel): K2 and K3 launched, every rc one of the JAX
    package's codes, kernels against plain versions (1 ns; log10 tau
    within 5e-7 plus the printed digit), the median z of log10 tau
    against the injected tau at each channel's frequency; the fit's
    device-busy seconds from a second, profiled kernel run.  Returns the
    launches of the kernel run."""
    import numpy as np

    from pulseportraiture_tpu_torch.config import RCSTRINGS
    from pulseportraiture_tpu_torch.io.gmodel import read_model
    from pulseportraiture_tpu_torch.io.psrfits import read_archive
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    gm = os.path.join(root, "examples", "example.gmodel")
    _, _, nu_tau0, _, gparams, _, alpha0, _ = read_model(gm)
    tau0 = float(gparams[1])
    base = ["-d", small, "-m", gm, "--narrowband", "--fit_scat",
            "--print_phase", "--quiet"]
    with clocked(GetTOAs, ("_narrowband_fit",)) as clock:
        kern, t_cli, launches = run_cli(
            K, base + ["-o", os.path.join(work, "nbs_k.tim")])
    gt = clock["self"][0]
    with plain_kernels(K):
        plain, _, _ = run_cli(K, base + ["-o", os.path.join(work,
                                                            "nbs_p.tim")])
    # a second kernel run with the fit under torch.profiler: where the
    # fit's wall goes (the first run's fit_s is unprofiled)
    with clocked(GetTOAs, ("_narrowband_fit",),
                 profiled=("_narrowband_fit",)) as pclock:
        run_cli(K, base + ["-o", os.path.join(work, "nbs_prof.tim")])
    rows = device_rows(pclock["prof"][0])
    k3 = kernel_times(pclock["prof"][0], K).get("moments_scat")
    dt_ns = max_dt_ns(kern, plain)
    gap = flag_gap(kern, plain, "log10_scat_time")
    rcs = gt.rcs[0][np.asarray(gt.TOA_errs[0] != 0)]
    codes = sorted(int(c) for c in np.unique(rcs))
    bad = [c for c in codes if str(c) not in RCSTRINGS]
    missing = [n for n in ("fftfit", "moments_scat") if launches[n] == 0]
    if missing or bad or len(kern) != len(plain) or \
            not (dt_ns < 1.0 and gap <= 1e-3 + 5e-7):
        raise AssertionError("narrowband --fit_scat: launches %s, rc %s, "
                             "plain vs kernel %.3g ns, log10 tau gap %.3g"
                             % (launches, codes, dt_ns, gap))
    dfs = read_archive(small).doppler_factors
    ztau = [(float(t["flags"]["log10_scat_time"]) - math.log10(
        tau0 * (t["freq"] / nu_tau0) ** alpha0
        / dfs[int(t["flags"]["subint"])]))
        / float(t["flags"]["log10_scat_time_err"]) for t in kern]
    emit("narrowband_scat", archive=[subset] + list(shape[1:]),
         n_toas=len(kern),
         cli_s=t_cli, fit_s=clock["_narrowband_fit"][0], launches=launches,
         fit_profiled_s=pclock["_narrowband_fit"][0],
         fit_device_busy_s=sum(r[1] for r in rows),
         k3_device_ms_total=k3[1] if k3 else None,
         k3_launches_profiled=k3[0] if k3 else 0,
         fit_device_top=[[key[:60], dev_s * 1e3, n] for key, dev_s, n in
                         sorted(rows, key=lambda r: -r[1])[:8]],
         rc_counts={c: int((rcs == c).sum()) for c in codes},
         nfev_max=int(gt.nfevals[0].max()),
         median_z_log10_tau=float(np.median(ztau)),
         plain_vs_kernel_max_ns=dt_ns, log10_tau_gap=gap)
    return launches


def spline_template(path, gm, P, nbin=2048, nchan=128, neig=6,
                    band=(1100.0, 1900.0)):
    """A spline model of the .gmodel: its portrait at ``nchan``
    frequencies over the band, a numpy SVD to ``neig`` eigenprofiles,
    their coordinates fit by scipy's splprep, written by the port's
    write_spline_model."""
    import numpy as np
    from scipy.interpolate import splprep

    from pulseportraiture_tpu_torch.io.gmodel import read_model
    from pulseportraiture_tpu_torch.io.splmodel import write_spline_model
    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers

    freqs = np.linspace(band[0], band[1], nchan)
    _, _, port = read_model(gm, get_bin_centers(nbin).numpy(), freqs, P)
    port = port.numpy()
    mean_prof = port.mean(axis=0)
    _, _, vt = np.linalg.svd(port - mean_prof, full_matrices=False)
    eigvec = vt[:neig].T
    tck, _ = splprep(((port - mean_prof) @ eigvec).T, u=freqs, k=3, s=0.0)
    write_spline_model(path, "example", "FAKE", gm, mean_prof, eigvec, tck)
    return path


def phase_templates(root, work, K, small, shape=(256, 512, 2048),
                    subset=16):
    """Wideband pptoas --print_flux on the 16-subint archive with a spline
    template built from the .gmodel and with a FITS template (the port's
    make_fake_pulsar, one subint, no noise): phase and DM recovered
    within 5 sigma, K1 and K2 launched, kernels against plain (1 ns).
    Returns the launches of the kernel runs, summed."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
    from pulseportraiture_tpu_torch.io.parfile import read_par

    gm = os.path.join(root, "examples", "example.gmodel")
    par = os.path.join(root, "examples", "example.par")
    P = 1.0 / float(read_par(par).F0)
    DM = float(read_par(par).get("DM")) + DDM_INJ
    _, nchan, nbin = shape
    templates = dict(
        spline=spline_template(os.path.join(work, "example.spl"), gm, P,
                               nbin=nbin),
        fits=make_fake_pulsar(gm, par, os.path.join(work, "tmpl.fits"),
                              nsub=1, nchan=nchan, nbin=nbin, nu0=NU0,
                              bw=800.0, tsub=60.0, noise_stds=0.0,
                              dedispersed=True, seed=0))
    total = {name: 0 for name in K.KERNELS}
    rows = {}
    for kind, model in templates.items():
        argv = ["-d", small, "-m", model, "--no_bary", "--print_phase",
                "--print_flux", "--quiet"]
        kern, t_cli, launches = run_cli(
            K, argv + ["-o", os.path.join(work, kind + "_k.tim")])
        with plain_kernels(K):
            plain, _, _ = run_cli(K, argv + ["-o", os.path.join(
                work, kind + "_p.tim")])
        dt_ns = max_dt_ns(kern, plain)
        zphi = np.abs(z_phase(kern, DM, P))
        zDM = np.abs([(float(t["flags"]["pp_dm"]) - DM)
                      / float(t["flags"]["pp_dme"]) for t in kern
                      if "pp_dm" in t["flags"]])
        missing = [n for n in ("moments", "fftfit") if launches[n] == 0]
        if len(kern) != subset or missing or not (
                dt_ns < 1.0 and zphi.max() < 5 and zDM.max() < 5):
            raise AssertionError(
                "%s template: %d TOAs, launches %s, plain vs kernel %.3g "
                "ns, max |z| phase %.2f DM %.2f" % (
                    kind, len(kern), launches, dt_ns, zphi.max(),
                    zDM.max()))
        for name in total:
            total[name] += launches[name]
        rows[kind] = dict(cli_s=t_cli, launches=launches,
                          max_abs_z_phase=float(zphi.max()),
                          max_abs_z_DM=float(zDM.max()),
                          flux_median=float(np.median(
                              [float(t["flags"]["flux"]) for t in kern])),
                          plain_vs_kernel_max_ns=dt_ns)
    emit("templates", archive=[subset] + list(shape[1:]), **rows)
    return total


def run_ppzap(K, argv):
    """The port's ppzap CLI, counts zeroed just before it: launches."""
    from pulseportraiture_tpu_torch.cli import ppzap

    K.reset_launches()
    rc = ppzap.main(argv)
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError("ppzap %s exited %d" % (" ".join(argv), rc))
    return launches


def phase_ppzap(root, work, K, small, shape=(256, 512, 2048), subset=16):
    """ppzap -m on the 16-subint archive: identical paz commands from
    the kernel and plain runs; --apply (no --modify) zero-weights exactly
    the (channel, subint) pairs listed.  Returns the kernel run's
    launches."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.psrfits import read_archive
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    gm = os.path.join(root, "examples", "example.gmodel")
    # a clean archive: -R 1.05 (reduced chi2 above 1.05) gives it channels
    # to zap, about 28% of them: its reduced chi2 reads ~1.02 with a 5%
    # spread (the stats emitted below)
    base = ["-d", small, "-m", gm, "-R", "1.05", "--quiet"]
    cmds = [os.path.join(work, "zap_k.cmds"), os.path.join(work,
                                                           "zap_p.cmds")]
    t0 = time.perf_counter()
    with clocked(GetTOAs, ("get_channels_to_zap",)) as clock:
        launches = run_ppzap(K, base + ["-o", cmds[0], "--device", "cuda"])
    t_zap = time.perf_counter() - t0
    rchi2 = rchi2_stats(clock["self"][0], 1.05)
    with plain_kernels(K):
        run_ppzap(K, base + ["-o", cmds[1]])
    text = [open(c).read() for c in cmds]
    listed = {(int(t[4]), int(t[6])) for t in (
        ln.split() for ln in text[0].splitlines()) if t[:4] == [
            "paz", "-m", "-I", "-z"]}
    run_ppzap(K, base + ["--apply"])
    before = read_archive(small).weights
    after = read_archive(small[:-len("fits")] + "zap").weights
    zeroed = {(int(c), int(i)) for i, c in zip(*np.nonzero(
        (before > 0) & (after == 0)))}
    missing = [n for n in ("moments", "fftfit") if launches[n] == 0]
    if text[0] != text[1] or zeroed != listed or missing or not listed:
        raise AssertionError("ppzap -m: kernel and plain lists %s, %d "
                             "listed, %d zeroed, launches %s" % (
                                 "agree" if text[0] == text[1] else
                                 "differ", len(listed), len(zeroed),
                                 launches))
    emit("ppzap", archive=[subset] + list(shape[1:]), cli_s=t_zap,
         launches=launches,
         n_zapped=len(listed), lists_identical=True,
         apply_zeroed_exactly_listed=True, channel_red_chi2=rchi2)
    return launches


def rchi2_stats(gt, threshold):
    """The post-fit channel reduced chi2s of a GetTOAs run after
    get_channels_to_zap: mean, spread, share above ``threshold``; the
    residual's mean per channel over the same noise estimate (its DC,
    which the fit leaves free) and the mean reduced chi2 without it."""
    import numpy as np
    import torch

    rc2 = np.array([c for s in gt.channel_red_chi2s[0] for c in s])
    dc, rc2_dc = [], []
    for isub in gt.ok_isubs[0]:
        port, model, ok, _, noise = gt._fitted_subint(0, isub)
        ok = torch.as_tensor(ok, device=port.device)
        r = (port[ok] - model[ok]) / torch.as_tensor(noise).to(
            port.device)[ok][:, None]
        mean = r.mean(dim=-1, keepdim=True)
        dc.append(mean[:, 0].cpu().numpy())
        rc2_dc.append((((r - mean) ** 2).sum(-1)
                       / (r.shape[-1] - 2)).cpu().numpy())
    dc = np.concatenate(dc)
    return dict(n=int(rc2.size), mean=float(rc2.mean()),
                std=float(rc2.std()),
                share_above=float((rc2 > threshold).mean()),
                resid_dc_over_noise=float(dc.mean()),
                mean_without_dc=float(np.concatenate(rc2_dc).mean()))



# -- the template-building paths: ppalign, ppspline, ppgauss --------------

ALIGN_ARCHIVES = 8          # epochs aligned; 16 subints each: 128 rows


@contextlib.contextmanager
def first_kernel_inputs(K):
    """Copies of the tensor arguments of the first K1 and K2 calls in the
    block (the shapes the path gives them): name -> (args, kwargs)."""
    import torch

    seen = {}
    saved = K.moments, K.fftfit

    def keep(name, fn):
        def call(*a, **kw):
            if name not in seen:
                seen[name] = (tuple(x.clone() if isinstance(
                    x, torch.Tensor) else x for x in a), dict(kw))
            return fn(*a, **kw)
        return call

    K.moments, K.fftfit = keep("moments", saved[0]), keep("fftfit", saved[1])
    try:
        yield seen
    finally:
        K.moments, K.fftfit = saved


def path_kernels_vs_plain(K, seen):
    """K1 and K2 on the inputs a path gave them, against their plain
    versions (not counted): {name: dict(shape, max_rel_err,
    max_abs_err)}; raises beyond 1e-12 relative (K2's phase: 1e-9 rot)."""
    import torch

    rows = {}
    for name, plain in (("moments", K.moments_plain),
                        ("fftfit", K.fftfit_plain)):
        if name not in seen:
            raise AssertionError("%s was never called on this path" % name)
        a, kw = seen[name]
        n0 = K.LAUNCHES[name]
        got = getattr(K, name)(*a, **kw)
        K.LAUNCHES[name] = n0               # a comparison launch: not counted
        want = plain(*a, **kw)
        torch.cuda.synchronize()
        if name == "moments":
            err = max(rel_err(got[..., i], want[..., i]) for i in range(3))
            abs_err, ok = float((got - want).abs().max()), err <= 1e-12
            shape = list(a[0].shape)
        else:
            ph = float((got[0] - want[0]).abs().max())
            err = max(rel_err(got[1], want[1]), rel_err(got[2], want[2]))
            abs_err = max(ph, float((got[1] - want[1]).abs().max()))
            ok = ph <= 1e-9 and err <= 1e-12
            shape = list(a[0].shape) + [a[4]]        # [N, nharm] and Ns
        rows[name] = dict(shape=shape, max_rel_err=err, max_abs_err=abs_err)
        if not ok:
            raise AssertionError("%s disagrees with its plain version on "
                                 "the path's inputs: %s" % (name, rows[name]))
    return rows


def align_inputs(root, work, shape, narch=ALIGN_ARCHIVES, nu0=NU0):
    """``narch`` epochs of ``shape`` (nsub, nchan, nbin) written by the
    port's make_fake_pulsar (noise 0.5, own seed, phase in +-0.3 rot, dDM
    in +-3e-3) and the noiseless one-subint FITS template: (metafile,
    archive paths, template path, injections)."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar

    gm = os.path.join(root, "examples", "example.gmodel")
    par = os.path.join(root, "examples", "example.par")
    nsub, nchan, nbin = shape
    rng = np.random.default_rng(2024)
    inj = [(float(rng.uniform(-0.3, 0.3)), float(rng.uniform(-3e-3, 3e-3)))
           for _ in range(narch)]
    files = [make_fake_pulsar(
        gm, par, os.path.join(work, "epoch%d.fits" % i), nsub=nsub,
        nchan=nchan, nbin=nbin, nu0=nu0, bw=800.0, tsub=60.0, phase=ph,
        dDM=dDM, noise_stds=0.5, seed=500 + i) for i, (ph, dDM) in
        enumerate(inj)]
    # the templates phase's FITS template, at this shape
    tmpl = make_fake_pulsar(gm, par, os.path.join(work, "tmpl.fits"),
                            nsub=1, nchan=nchan, nbin=nbin, nu0=nu0,
                            bw=800.0, tsub=60.0, noise_stds=0.0,
                            dedispersed=True, seed=0)
    meta = os.path.join(work, "epochs.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    return meta, files, tmpl, inj


def run_tool(K, module, argv):
    """A port CLI (``module.main``) with every launch count set to 0 just
    before it: (wall seconds, launches of that run)."""
    K.reset_launches()
    t0 = time.perf_counter()
    rc = module.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if rc != 0:
        raise AssertionError("%s %s exited %d" % (module.__name__,
                                                  " ".join(argv), rc))
    return wall, launches


def rotate_bound_ms(B, npol, nchan, nbin):
    """B8's least time: the block read once and written once (float64);
    the rFFT and irFFT at 2.5 N log2 N FP64 operations each per row."""
    rows = B * npol * nchan
    return bound_ms(2 * rows * nbin * 8 + 4 * B * 8,
                    (2 * 2.5 * rows * nbin * math.log2(nbin),
                     PEAK_FP64_PER_S))


def fit_shift_gap(a, b, freqs, P):
    """Largest difference [rot] between the rotations two (phi, DM) fit
    results apply, phi + Dconst DM (nu^-2 - nu_DM^-2) / P, over the band
    edges and the subints with finite fits."""
    import torch

    from pulseportraiture_tpu_torch.config import Dconst

    nu = torch.stack([freqs.min(), freqs.max()])[None]

    def shift(r):
        return r.phi[:, None] + Dconst * r.DM[:, None] / P * (
            nu ** -2 - r.nu_DM[:, None] ** -2)

    d = (shift(a) - shift(b)).abs()
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def phase_ppalign(root, work, K, dev, shape=(16, 512, 2048), niter=2,
                  subset=2):
    """The port's ppalign CLI on ALIGN_ARCHIVES epochs against the
    noiseless FITS template: K1 and K2 launched (and held against their
    plain versions on the inputs the path gave them), the aligned
    portrait against the noiseless model, the device time of one block
    (torch.profiler) and of its rotation; then a ``subset``-archive run
    with the kernels and with the plain versions.  Returns the main run's
    launches and the aligned archive."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.cli import ppalign
    from pulseportraiture_tpu_torch.io.archive import load_data
    from pulseportraiture_tpu_torch.pipelines import align

    nsub, nchan, nbin = shape
    t0 = time.perf_counter()
    meta, files, tmpl, _ = align_inputs(root, work, shape)
    t_make = time.perf_counter() - t0
    avg = os.path.join(work, "aligned.fits")
    torch.cuda.reset_peak_memory_stats()
    with clocked(align, ("load_data", "_align_fit_accumulate"),
                           keep_args=("_align_fit_accumulate",)) as clock, \
            first_kernel_inputs(K) as seen:
        wall, launches = run_tool(K, ppalign, [
            "-M", meta, "-I", tmpl, "-o", avg, "--niter", str(niter),
            "--device", str(dev)])
    peak = torch.cuda.max_memory_allocated()
    missing = [n for n in ("moments", "fftfit") if launches[n] == 0]
    if missing:
        raise AssertionError("kernels never launched on the ppalign path: "
                             "%s" % missing)
    vs_plain = path_kernels_vs_plain(K, seen)
    del seen

    # the aligned portrait against the noiseless model: one amplitude per
    # channel, the DC left out (the fits weight harmonic 0 by F0_fact = 0)
    rows = ALIGN_ARCHIVES * nsub
    port = load_data(avg, quiet=True).subints[0, 0]
    model = load_data(tmpl, quiet=True).subints[0, 0]
    port = port - port.mean(-1, keepdims=True)
    model = model - model.mean(-1, keepdims=True)
    amp = (port * model).sum(-1) / (model * model).sum(-1)
    resid_rms = float(np.sqrt(((port - amp[:, None] * model) ** 2).mean()))
    want_rms = 0.5 / math.sqrt(rows)

    # one block again under the profiler; its rotation alone (B8)
    (full, model_b, freqs_b, errs_b, nu_fit, Ps_b, wok, DMg), kw = \
        clock.pop("_align_fit_accumulate_args")
    npol = full.shape[1]

    def block():
        align._align_fit_accumulate(
            full, model_b, freqs_b, errs_b, nu_fit, Ps_b, wok, DMg,
            **dict(kw, aligned_port=torch.zeros_like(kw["aligned_port"]),
                   total_weights=torch.zeros_like(kw["total_weights"])))

    n0 = dict(K.LAUNCHES)
    ktimes, prof = kernel_device_ms(block, K)
    K.LAUNCHES.update(n0)                   # a measurement: not counted
    phis = torch.zeros_like(Ps_b)
    rot_ms = cuda_ms(lambda: align._rotate_batch(full, phis, DMg, Ps_b,
                                                 freqs_b, nu_fit), reps=5)
    rot_bound, rot_by = rotate_bound_ms(*full.shape[:3], nbin)
    freqs_b, Ps_b = freqs_b[0], Ps_b[0]     # every subint's: one band, P
    del full, model_b, kw

    # the kernels against their plain versions, end to end on a subset:
    # the fits stop at the f64 floor of their objective, so the two runs'
    # subint rotations differ by ~1e-9 rot, which moves the portrait by
    # ~1e-8 of its peak; they are held to the bound of the CPU parity
    # tests against the JAX package (tests/test_torch_align.py)
    outs, fits = [], []
    for plain in (False, True):
        with plain_kernels(K) if plain else contextlib.nullcontext(), \
                clocked(align, ("fit_portrait_full_batch",),
                                  keep_out=("fit_portrait_full_batch",)) \
                as fclock:
            outs.append(align.align_archives(
                files[:subset], tmpl, niter=niter, device=dev,
                outfile=os.path.join(work, "subset%d.fits" % plain))[1])
        fits.append(fclock["fit_portrait_full_batch_out"])
    gap = float(np.abs(outs[0] - outs[1]).max() / np.abs(outs[1]).max())
    shift_gap = max(fit_shift_gap(a, b, freqs_b, Ps_b)
                    for a, b in zip(*fits))
    emit("ppalign", archives=ALIGN_ARCHIVES, archive=list(shape),
         rows=rows, niter=niter, make_s=t_make, cli_s=wall,
         load_s=sum(clock["load_data"]), n_loads=len(clock["load_data"]),
         fit_s=sum(clock["_align_fit_accumulate"]),
         n_blocks=len(clock["_align_fit_accumulate"]), launches=launches,
         kernels_vs_plain=vs_plain, peak_device_bytes=peak,
         resid_rms=resid_rms, noise_over_sqrt_rows=want_rms,
         b8_block=dict(shape=[int(x) for x in (rows, npol, nchan, nbin)],
                       kernels={n: list(v) for n, v in ktimes.items()},
                       **prof),
         b8_rotate=dict(ms=rot_ms, bound_ms=rot_bound, bound_by=rot_by,
                        share_of_bound=rot_bound / rot_ms),
         plain_vs_kernel_subset=dict(archives=subset, max_rel_gap=gap,
                                     max_shift_gap_rot=shift_gap))
    if not (np.isfinite(port).all() and resid_rms <= 1.5 * want_rms):
        raise AssertionError("aligned portrait: residual rms %.4g against "
                             "noise/sqrt(rows) %.4g" % (resid_rms, want_rms))
    if not gap <= 5e-8:
        raise AssertionError("ppalign subset: plain vs kernel portraits "
                             "differ by %.3g of the peak" % gap)
    return launches, avg


def recovery(toas, DM, P, frame=(0.0, 0.0, NU0)):
    """(max |z| of phase, of DM) of .tim TOAs against the pptoas
    archives' injection; ``frame`` = (phase, DM, frequency) of the
    timing model against the initial template, added to each TOA's phase
    and DM so that they are referred to the template's phase zero and DM
    reference."""
    import numpy as np

    from pulseportraiture_tpu_torch.config import Dconst

    phi_m, DM_m, nu_m = frame
    zphi, zDM = [], []
    for t in toas:
        f, nu = t["flags"], t["freq"]
        phs = float(f["phs"]) + phi_m + Dconst * DM_m * (
            nu ** -2 - nu_m ** -2) / P
        want = PHASE_INJ + Dconst * DM * (nu ** -2 - NU0 ** -2) / P
        zphi.append(((phs - want + 0.5) % 1.0 - 0.5) / float(f["phs_err"]))
        if "pp_dm" in f:
            zDM.append((float(f["pp_dm"]) + DM_m - DM) / float(f["pp_dme"]))
    return float(np.abs(zphi).max()), float(np.abs(zDM).max())


def template_frame(model, tmpl, dev):
    """(phase, DM, frequency) of a .gmodel's portrait against the FITS
    template it was built from, at the template's channels: the (phase,
    DM) fit of one noiseless portrait to the other (K1; the model was
    rotated by its builder's convergence iterations)."""
    import numpy as np

    from pulseportraiture_tpu_torch.fit.portrait import fit_portrait
    from pulseportraiture_tpu_torch.io.archive import load_data
    from pulseportraiture_tpu_torch.io.gmodel import read_model

    t = load_data(tmpl, quiet=True)
    P = float(t.Ps[0])
    port = read_model(model, t.phases, t.freqs[0], P, device=dev)[2]
    r = fit_portrait(port, t.subints[0, 0], [0.0, 0.0], P, t.freqs[0],
                     errs=np.ones(t.nchan), device=dev)
    return float(r.phase), float(r.DM), float(r.nu_ref)


def time_with_template(K, dev, work, small, model, tag, subset=16,
                       gate=True, frame=(0.0, 0.0, NU0)):
    """pptoas on the 16-subint archive with ``model``: kernels, then the
    plain versions (1 ns); the injection recovered within 5 sigma, in the
    initial template's ``frame`` (see recovery), when ``gate``.  Returns
    a dict of the run's numbers."""
    from pulseportraiture_tpu_torch.io.parfile import read_par

    par = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "example.par")
    P = 1.0 / float(read_par(par).F0)
    DM = float(read_par(par).get("DM")) + DDM_INJ
    argv = ["-d", small, "-m", model, "--no_bary", "--print_phase",
            "--quiet", "--device", str(dev)]
    kern, t_cli, launches = run_cli(K, argv + ["-o", os.path.join(
        work, tag + "_k.tim")])
    with plain_kernels(K):
        plain, _, _ = run_cli(K, argv + ["-o", os.path.join(
            work, tag + "_p.tim")])
    dt_ns = max_dt_ns(kern, plain)
    zphi, zDM = recovery(kern, DM, P, frame)
    missing = [n for n in ("moments", "fftfit") if launches[n] == 0]
    if len(kern) != subset or missing or not dt_ns < 1.0 or (
            gate and not (zphi < 5 and zDM < 5)):
        raise AssertionError("pptoas with the %s template: %d TOAs, "
                             "launches %s, plain vs kernel %.3g ns, max |z| "
                             "phase %.2f DM %.2f" % (tag, len(kern),
                                                     launches, dt_ns, zphi,
                                                     zDM))
    return dict(cli_s=t_cli, launches=launches, max_abs_z_phase=zphi,
                max_abs_z_DM=zDM, plain_vs_kernel_max_ns=dt_ns)


def phase_ppspline(root, work, K, dev, avg, small):
    """The port's ppspline -s on the aligned archive; B9's eigh and
    smart_smooth at the path's shapes; pptoas with the .spl on the
    16-subint archive (5 sigma, 1 ns).  Returns the launches of the
    ppspline and pptoas runs, summed."""
    import torch

    from pulseportraiture_tpu_torch.cli import ppspline
    from pulseportraiture_tpu_torch.dataportrait import DataPortrait
    from pulseportraiture_tpu_torch.io.splmodel import read_spline_model
    from pulseportraiture_tpu_torch.ops.pca import pca
    from pulseportraiture_tpu_torch.ops.wavelet import smart_smooth

    spl = os.path.join(work, "aligned.spl")
    wall, launches = run_tool(K, ppspline, ["-d", avg, "-o", spl, "-s",
                                            "--quiet", "--device", str(dev)])
    if launches["fftfit"] == 0:
        raise AssertionError("K2 never launched by ppspline -N prof")
    ncomp = read_spline_model(spl)[4].shape[1]

    # B9 at this path's shapes: the eigensolve of the [nbin, nbin]
    # covariance and the smoothing of the ten candidate eigenvectors
    dp = DataPortrait(avg, quiet=True, device=dev)
    dp.normalize_portrait("prof")
    port = torch.as_tensor(dp.portx, device=dev)
    w = torch.as_tensor(dp.SNRsxs / dp.SNRsxs.sum(), device=dev)
    mean = (port * w[:, None]).sum(0) / w.sum()
    d = port - mean
    d = d - (d * w[:, None]).sum(0) / w.sum()
    cov = torch.einsum("i,ij,ik->jk", w, d, d)
    n = cov.shape[0]
    eigh_ms = cuda_ms(lambda: torch.linalg.eigh(cov), reps=3, warm=1)
    # symmetric eigendecomposition with vectors, ~9 n^3 (Golub & Van Loan)
    eigh_bound, eigh_by = bound_ms(2 * n * n * 8 + n * 8,
                                   (9 * n ** 3, PEAK_FP64_PER_S))
    cand = pca(port, mean, w)[1][:, :10].T.contiguous()
    nbin = cand.shape[-1]
    nlev = int(math.log2(nbin))
    ss_ms = cuda_ms(lambda: smart_smooth(cand), reps=3, warm=1)
    # per level l: l+3 complex FFTs (and a real one) of nfact x 10 rows
    ffts = sum(l + 4 for l in range(1, nlev + 1)) * 30 * cand.shape[0]
    ss_bound, ss_by = bound_ms(2 * cand.numel() * 8,
                               (ffts * 5 * nbin * math.log2(nbin),
                                PEAK_FP64_PER_S))
    del dp, port, d, cov, cand

    toas = time_with_template(K, dev, work, small, spl, "spline_built")
    total = {name: launches[name] + toas["launches"][name]
             for name in launches}
    emit("ppspline", cli_s=wall, launches=launches, n_eigenprofiles=ncomp,
         b9_eigh=dict(shape=[n, n], ms=eigh_ms, bound_ms=eigh_bound,
                      bound_by=eigh_by),
         b9_smart_smooth=dict(shape=[10, nbin], nlevels=nlev, nfact=30,
                              ms=ss_ms, bound_ms=ss_bound, bound_by=ss_by),
         pptoas=toas)
    return total


def jacobian_pass(dp, dev):
    """One forward-mode Jacobian of the Gaussian portrait fit's residual
    at its solution, as fit_gaussian_portrait's lm_solve takes it:
    (device ms, bound ms, bound_by, shape [N, nparam])."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    data = torch.as_tensor(dp.portx, device=dev)
    errs = torch.as_tensor(dp.portx_noise, device=dev)
    freqs = torch.as_tensor(dp.freqsxs[0], device=dev)
    x = torch.as_tensor(np.concatenate([dp.model_params,
                                        [dp.scattering_index]]),
                        device=dev)
    nparam = len(dp.model_params)

    def residual(v):
        model = gen_gaussian_portrait(dp.model_code, v[:nparam], v[nparam],
                                      dp.phases, freqs, dp.nu_ref,
                                      device=dev)
        return ((data - model) / errs).reshape(-1)

    jac = torch.func.jacfwd(residual)
    ms = cuda_ms(lambda: jac(x), reps=3, warm=1)
    N, npar = data.numel(), x.numel()
    nchan, nbin = data.shape
    ngauss = (nparam - 2) // 6
    # data and errs read, J written; per tangent the components over the
    # portrait (~30 operations per bin and component) and the scattered
    # branch's rFFT and irFFT (2.5 N log2 nbin each)
    flops = npar * (30 * ngauss * N + 5 * N * math.log2(nbin))
    bms, by = bound_ms(2 * N * 8 + N * npar * 8, (flops, PEAK_FP64_PER_S))
    return ms, bms, by, [N, npar]


def phase_ppgauss(root, work, K, dev, avg, small):
    """The port's ppgauss --autogauss 0.05 --niter 2 on the aligned
    archive: components, LM nfev and rc, wall, the Jacobian pass's device
    ms; a run with the plain versions (parameters within 1e-6 of their
    errors); pptoas with the .gmodel on the 16-subint archive (1 ns
    against plain; the injection within 5 sigma, referred to the initial
    template's phase zero and DM reference).  Returns the launches of the
    ppgauss and pptoas runs, summed."""
    import numpy as np

    from pulseportraiture_tpu_torch.cli import ppgauss
    from pulseportraiture_tpu_torch.io.gmodel import read_model
    from pulseportraiture_tpu_torch.models import gauss

    out = os.path.join(work, "aligned.gmodel")
    argv = ["-d", avg, "--autogauss", "0.05", "--niter", "2", "--device",
            str(dev)]
    with clocked(gauss, ("fit_gaussian_portrait",),
                 keep_out=("fit_gaussian_portrait",)) as clock, \
            clocked(gauss.GaussianModelPortrait,
                    ("check_convergence",)) as conv:
        wall, launches = run_tool(K, ppgauss, argv + ["-o", out])
    fits = clock["fit_gaussian_portrait_out"]
    dp = conv["self"][-1]
    _, _, _, ngauss, params, _, _, _ = read_model(out)
    errs = read_model(out + "_errs")[4]
    jms, jb, jby, jshape = jacobian_pass(dp, dev)

    plain_out = os.path.join(work, "aligned_plain.gmodel")
    with plain_kernels(K):
        run_tool(K, ppgauss, argv + ["-o", plain_out])
    fin = np.isfinite(errs) & (errs > 0)
    gap = float(np.max(np.abs(read_model(plain_out)[4] - params)[fin]
                       / errs[fin]))
    # the builder rotates the data by its convergence fits, so its model's
    # phase zero and DM reference are referred back to the initial
    # template's before the injection is compared
    frame = template_frame(out, os.path.join(work, "tmpl.fits"), dev)
    toas = time_with_template(K, dev, work, small, out, "gmodel_built",
                              frame=frame)
    emit("ppgauss", cli_s=wall, launches=launches, n_components=ngauss,
         fit_s=clock["fit_gaussian_portrait"],
         lm_nfev=[f.nfev for f in fits], lm_rc=[f.return_code for f in fits],
         red_chi2=fits[-1].chi2 / fits[-1].dof, converged=int(dp.cnvrgnc),
         jacobian=dict(shape=jshape, ms=jms, bound_ms=jb, bound_by=jby),
         plain_vs_kernel_params_over_errs=gap,
         template_frame=dict(zip(("phase", "DM", "nu"), frame)),
         pptoas=toas)
    if launches["moments"] == 0 or launches["fftfit"] == 0:
        raise AssertionError("ppgauss launched %s" % launches)
    if not (np.isfinite(params).all() and fits[-1].return_code in (1, 2)):
        raise AssertionError("ppgauss: params %s, rc %d"
                             % (params, fits[-1].return_code))
    if not gap <= 1e-6:
        raise AssertionError("ppgauss: plain vs kernel parameters differ "
                             "by %.3g of their errors" % gap)
    return {name: launches[name] + toas["launches"][name]
            for name in launches}


# examples/example.py's walkthrough: epochs, their first MJD and spacing,
# the injected spin perturbation (dF0 [Hz], dF1 [Hz/s], referred to the
# par's PEPOCH) and the DMX range of its GLS fit [days]
WALK_EPOCHS, WALK_MJD0, WALK_DAYS = 5, 57202.0, 20.0
WALK_DF0, WALK_DF1, WALK_DMX = 2e-9, 4e-17, 6.5


def walkthrough_inputs(root, work, shape):
    """examples/example.py's fake epochs, written by the port's
    make_fake_pulsar: WALK_EPOCHS epochs of ``shape`` (nsub, nchan,
    nbin), scintillated, dispersed, noise 1.5, each with its own seed,
    dDM ~ N(3e-4, 2e-4) from default_rng(42) and the spin perturbation
    injected as phase.  Returns (metafile, archive paths, injected
    dDMs)."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
    from pulseportraiture_tpu_torch.io.parfile import read_par
    from pulseportraiture_tpu_torch.utils.mjd import MJD

    gm = os.path.join(root, "examples", "example.gmodel")
    par = os.path.join(root, "examples", "example.par")
    nsub, nchan, nbin = shape
    dDMs = np.random.default_rng(42).normal(3e-4, 2e-4, WALK_EPOCHS)
    dts = (WALK_MJD0 + np.arange(WALK_EPOCHS) * WALK_DAYS
           - float(read_par(par).PEPOCH)) * 86400.0
    phases = WALK_DF0 * dts + 0.5 * WALK_DF1 * dts ** 2
    files = [make_fake_pulsar(
        gm, par, os.path.join(work, "walk-%d.fits" % (i + 1)), nsub=nsub,
        nchan=nchan, nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
        phase=float(phases[i] % 1.0), dDM=float(dDMs[i]),
        start_MJD=MJD.from_mjd(WALK_MJD0 + i * WALK_DAYS),
        noise_stds=1.5, dedispersed=False, scint=True, seed=i)
        for i in range(WALK_EPOCHS)]
    meta = os.path.join(work, "walk.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    return meta, files, dDMs


def walkthrough_run(root, work, meta, files, device):
    """examples/example.py through the port, step for step: align (niter
    1, tscrunch, pscrunch) -> spline model (max_ncomp 3, smooth,
    snr_cutoff 150, rchi2_tol 0.1, k 3, sfac 1) -> wideband TOAs (DM0 the
    par's, no barycentring) -> .tim -> GLS on the ephemeris with DMDATA 1,
    DMX and F0/F1 fitted (walk-fit.par).
    Returns dict(walls per step, gt, tim, spl, gls)."""
    from pulseportraiture_tpu_torch.io.parfile import read_par, write_par
    from pulseportraiture_tpu_torch.io.timfile import write_TOAs
    from pulseportraiture_tpu_torch.models.spline import SplineModelPortrait
    from pulseportraiture_tpu_torch.pipelines.align import align_archives
    from pulseportraiture_tpu_torch.pipelines.timing import (
        parse_tim, wideband_gls_fit)
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    par = os.path.join(root, "examples", "example.par")
    avg = os.path.join(work, "walk.port")
    spl = os.path.join(work, "walk-fit.spl")
    tim = os.path.join(work, "walk.tim")
    walls = {}
    t0 = time.perf_counter()
    align_archives(meta, initial_guess=files[0], tscrunch=True,
                   pscrunch=True, outfile=avg, niter=1, quiet=True,
                   device=device)
    walls["align"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp = SplineModelPortrait(avg, quiet=True, device=device)
    dp.normalize_portrait("prof")
    dp.make_spline_model(max_ncomp=3, smooth=True, snr_cutoff=150.0,
                         rchi2_tol=0.1, k=3, sfac=1.0, quiet=True)
    dp.write_model(spl, quiet=True)
    walls["spline"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gt = GetTOAs(meta, spl, quiet=True, device=device)
    gt.get_TOAs(DM0=float(read_par(par).DM), bary=False)
    write_TOAs(gt.TOA_list, SNR_cutoff=0.0, outfile=tim, append=False)
    walls["toas"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fields = dict(read_par(par).items())
    fields.pop("fit_flags", None)
    fields.pop("uncertainties", None)
    fields.update(DMDATA=1, DMX=WALK_DMX)
    fields.setdefault("F1", 0.0)
    fit_par = os.path.join(work, "walk-fit.par")
    write_par(fit_par, fields, fit_flags={"F0": 1, "F1": 1}, quiet=True)
    gls = wideband_gls_fit(parse_tim(tim), fit_par)
    walls["gls"] = time.perf_counter() - t0
    return dict(walls=walls, gt=gt, tim=tim, spl=spl, gls=gls)


def walkthrough_criteria(gt, gls, dDMs):
    """example.py's own pass criteria: the DM offsets relative to their
    mean within 5 sigma + 1e-5 of the injections; the GLS's dF0 and dF1
    within 5 sigma of theirs and its DMX wander within 5 sigma + 2e-5.
    Returns (dict of the compared values, passed)."""
    import numpy as np

    dDM_fit = np.array(gt.DeltaDM_means)
    dDM_err = np.array(gt.DeltaDM_errs)
    diff = dDMs[np.asarray(gt.ok_idatafiles)] - dDM_fit
    rel = diff - diff.mean()
    ok_dm = bool(np.all(np.abs(rel) < 5 * dDM_err + 1e-5))
    p, e = gls["params"], gls["errors"]
    ok_spin = bool(abs(p["dF0_hz"] - WALK_DF0) < 5 * e["dF0_hz"]
                   and abs(p["dF1_hz_s"] - WALK_DF1) < 5 * e["dF1_hz_s"])
    dmx = np.array([d["dDM"] for d in gls["dmx"]])
    dmx_err = np.array([d["err"] for d in gls["dmx"]])
    ok_dmx = len(dmx) == len(dDMs) and bool(np.all(
        np.abs((dmx - dmx.mean()) - (dDMs - dDMs.mean()))
        < 5 * dmx_err + 2e-5))
    out = dict(
        dDM_injected=dDMs.tolist(), dDM_fit=dDM_fit.tolist(),
        dDM_err=dDM_err.tolist(),
        max_abs_rel_dDM_over_err=float(np.max(np.abs(rel) / dDM_err)),
        dF0=[p["dF0_hz"], e["dF0_hz"], WALK_DF0],
        dF1=[p["dF1_hz_s"], e["dF1_hz_s"], WALK_DF1],
        dmx_rel_fit=(dmx - dmx.mean()).tolist(),
        dmx_rel_injected=(dDMs - dDMs.mean()).tolist(),
        dmx_err=dmx_err.tolist(), ok_dm=ok_dm, ok_spin=ok_spin,
        ok_dmx=ok_dmx)
    return out, ok_dm and ok_spin and ok_dmx


def phase_walkthrough(root, work, K, dev, shape=(10, 512, 2048)):
    """examples/example.py end to end through the port at full width
    (WALK_EPOCHS epochs of ``shape``): its DM and GLS criteria, K1 and K2
    launched and held against their plain versions on the first inputs
    the path gave them, the pptoas step rerun with the plain versions
    (1 ns).  Returns the launches of the walkthrough's run."""
    import numpy as np

    from pulseportraiture_tpu_torch import dataportrait
    from pulseportraiture_tpu_torch.io.timfile import write_TOAs
    from pulseportraiture_tpu_torch.io.parfile import read_par
    from pulseportraiture_tpu_torch.pipelines import align, toas
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    t0 = time.perf_counter()
    meta, files, dDMs = walkthrough_inputs(root, work, shape)
    t_make = time.perf_counter() - t0
    K.reset_launches()
    with clocked(align, ("load_data",)) as c1, \
            clocked(dataportrait, ("load_data",)) as c2, \
            clocked(toas, ("load_data",)) as c3, \
            first_kernel_inputs(K) as seen:
        run = walkthrough_run(root, work, meta, files, dev)
    launches = dict(K.LAUNCHES)
    vs_plain = path_kernels_vs_plain(K, seen)
    del seen
    loads = c1["load_data"] + c2["load_data"] + c3["load_data"]
    gls, gt = run["gls"], run["gt"]
    crit, ok = walkthrough_criteria(gt, gls, dDMs)

    plain_tim = os.path.join(work, "walk_plain.tim")
    with plain_kernels(K):
        gp = GetTOAs(meta, run["spl"], quiet=True, device=dev)
        gp.get_TOAs(DM0=float(read_par(os.path.join(
            root, "examples", "example.par")).DM), bary=False)
    write_TOAs(gp.TOA_list, SNR_cutoff=0.0, outfile=plain_tim, append=False)
    kern, plain = read_tim(run["tim"]), read_tim(plain_tim)
    dt_ns = max_dt_ns(kern, plain)
    emit("walkthrough", epochs=len(files), archive=list(shape),
         make_s=t_make, step_s=run["walls"],
         load_data_s=sum(loads), n_loads=len(loads), launches=launches,
         n_toas=len(kern), gls=dict(
             ntoa=gls["ntoa"], n_dmx=len(gls["dmx"]),
             prefit_wrms_us=gls["prefit_wrms_us"],
             postfit_wrms_us=gls["postfit_wrms_us"],
             red_chi2=gls["red_chi2"]),
         criteria=crit, kernels_vs_plain=vs_plain,
         plain_vs_kernel_max_ns=dt_ns)
    if len(kern) != len(files) * shape[0] or len(plain) != len(kern):
        raise AssertionError("walkthrough: %d TOAs (plain run %d), want %d"
                             % (len(kern), len(plain),
                                len(files) * shape[0]))
    if not ok:
        raise AssertionError("walkthrough: example.py's criteria failed: "
                             "DM %s, spin %s, DMX %s" % (
                                 crit["ok_dm"], crit["ok_spin"],
                                 crit["ok_dmx"]))
    if not dt_ns < 1.0:
        raise AssertionError("walkthrough: plain vs kernel TOAs differ by "
                             "%.3g ns" % dt_ns)
    if launches["moments"] == 0 or launches["fftfit"] == 0:
        raise AssertionError("walkthrough launched %s" % launches)
    if not np.isfinite([gls["postfit_wrms_us"], gls["red_chi2"]]).all():
        raise AssertionError("walkthrough: GLS %s" % gls)
    return launches


def profile_cli(argv, outdir):
    """Where the pptoas CLI's wall time goes: host functions (cProfile,
    one run) and device time by kernel (torch.profiler, another run).
    Emits a summary; writes the tables to ``outdir``."""
    import cProfile
    import io
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pulseportraiture_tpu_torch.cli import pptoas

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    pptoas.main(argv)
    pr.disable()
    host_wall = time.perf_counter() - t0
    st = pstats.Stats(pr)
    host = sorted(((f"{fn[0].split('/')[-1]}:{fn[1]}({fn[2]})", v[3])
                   for fn, v in st.stats.items()
                   if "pulseportraiture_tpu_torch" in fn[0]),
                  key=lambda r: -r[1])[:25]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pptoas.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((key[:80], s, n) for key, s, n in device_rows(prof)),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    os.makedirs(outdir, exist_ok=True)
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(40)
    with open(os.path.join(outdir, "pptoas_profile.txt"), "w") as f:
        f.write(buf.getvalue())
        f.write("\n" + prof.key_averages().table(
            sort_by="cpu_time_total", row_limit=40))
    emit("profile", cprofile_wall_s=host_wall, wall_s=wall,
         device_busy_s=busy, device_idle_share=1.0 - busy / wall,
         host_cumulative_s=host[:15],
         device_top=[list(r) for r in rows[:10]])


def device_rows(prof):
    """(name, device seconds, count) of every device-side event (kernels,
    copies) in a torch.profiler run."""
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            rows.append((e.key, dev_us / 1e6, e.count))
    return rows


def kernel_times(prof, K):
    """{kernel name: (launches, device ms in all)} of a torch.profiler
    run.  A launch of K2 runs two CUDA kernels: its launches are the
    larger count of the two; a kernel the profiler shows no device time
    for is left out."""
    out = {}
    for key, dev_s, count in device_rows(prof):
        for name in K.KERNELS:  # moments(_scat)_kernel; fftfit_*_kernel
            hit = (name + "_kernel" in key) if name.startswith("moments") \
                else (name + "_" in key and "_kernel" in key)
            if hit and dev_s > 0:
                n, ms = out.get(name, (0, 0.0))
                out[name] = (max(n, count), ms + dev_s * 1e3)
    return out


def kernel_device_ms(fn, K):
    """({kernel name: (launches, device ms in all)}, device profile) of
    one call of fn(), from torch.profiler.  The device profile holds the
    wall, the device-busy seconds and the eight device rows that took
    longest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = device_rows(prof)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    busy = sum(r[1] for r in rows)
    profile_ = dict(wall_s=wall, device_busy_s=busy,
                    device_top=[[key[:60], dev_s * 1e3, n]
                                for key, dev_s, n in top])
    return kernel_times(prof, K), profile_


def north_star_data(dev, seed, nsub=1000, nchan=512, nbin=2048,
                    t_scat=0.0):
    """The north-star data, made on the card by the port's
    make_fake_dataset (B11): ``nsub`` subints of MODEL_PARAMS across
    1300-1700 MHz at phases and dDMs drawn from a seeded generator,
    noise NOISE, scattered by ``t_scat`` [s].  Returns (subints, freqs,
    nu_ref, injected phases, injected dDMs, the model portrait, make
    seconds, peak device bytes while making, of them above what was
    allocated before)."""
    import torch

    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait
    from pulseportraiture_tpu_torch.pipelines.synth import make_fake_dataset

    gen = torch.Generator(device=dev).manual_seed(seed)
    phis = (torch.rand(nsub, generator=gen, device=dev,
                       dtype=torch.float64) - 0.5) * 0.8
    dDMs = (torch.rand(nsub, generator=gen, device=dev,
                       dtype=torch.float64) - 0.5) * 4e-3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ds = make_fake_dataset(gen, MODEL_PARAMS, nsub=nsub, nchan=nchan,
                           nbin=nbin, lofreq=1300.0, bw=400.0, P=P0,
                           phases=phis, dDMs=dDMs, noise_std=NOISE,
                           t_scat=t_scat, device=dev)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = gen_gaussian_portrait("000", MODEL_PARAMS, -4.0,
                                  get_bin_centers(nbin), ds.freqs, ds.nu_ref,
                                  device=dev)
    out = (ds.subints, ds.freqs, ds.nu_ref, ds.phases_inj, ds.dDMs_inj,
           model, t_make, peak, peak - base)
    # a DataBunch refers to itself (attribute access), so only the cyclic
    # collector would free it: empty it, and the 8.4 GB go with the caller
    ds.clear()
    return out


def synth_bound_ms(nsub, nchan, nbin):
    """make_fake_dataset's least time: its output written once, against
    one rFFT and one irFFT (2.5 n log2 n each) and the phasor per
    (subint, channel) row."""
    rows = nsub * nchan
    ops = rows * (5.0 * nbin * math.log2(nbin) + 8.0 * (nbin // 2 + 1))
    return bound_ms(rows * nbin * 8, (ops, PEAK_FP64_PER_S))


def phase_throughput(dev, K):
    """fit_portrait_full_batch at the north-star 1000 x 512 x 2048, the
    phases seeded in the fit (init_params=None)."""
    import torch

    from pulseportraiture_tpu_torch.config import Dconst
    from pulseportraiture_tpu_torch.fit.portrait import (
        fit_portrait_full_batch, model_kmax)

    nsub, nchan, nbin = 1000, 512, 2048
    data, freqs, nu0, phis, dDMs, model, t_make, make_peak, make_extra = \
        north_star_data(dev, 0, nsub, nchan, nbin)
    kmax = model_kmax(model)
    errs = torch.full((nsub, nchan), NOISE, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    b11_bound, b11_by = synth_bound_ms(nsub, nchan, nbin)
    emit("synth", shape=[nsub, nchan, nbin], make_s=t_make,
         ms=t_make * 1e3, bound_ms=b11_bound, bound_by=b11_by,
         share_of_bound=b11_bound / (t_make * 1e3),
         peak_device_bytes=int(make_peak),
         peak_above_prior_bytes=int(make_extra),
         output_bytes=int(data.numel() * 8))

    def run():
        return fit_portrait_full_batch(
            data, model, None, P0, freqs, errs=errs,
            fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30,
            kmax=kmax, device=dev)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # another run, under the profiler
    per_kernel, device = kernel_device_ms(run, K)
    # phi is reported at nu_DM; the injection is referenced to nu0
    z = ((out.phi - phis - Dconst * dDMs * (out.nu_DM ** -2 - nu0 ** -2)
          / P0) + 0.5) % 1.0 - 0.5
    zphi = (z / out.phi_err).abs()
    zDM = ((out.DM - dDMs) / out.DM_err).abs()
    finite = bool(torch.isfinite(out.phi).all()
                  and torch.isfinite(out.phi_err).all())
    k1, k2 = per_kernel.get("moments"), per_kernel.get("fftfit")
    res = dict(shape=[nsub, nchan, nbin], kmax=kmax, first_s=t_first,
               steady_s=t_steady, toas_per_s=nsub / t_steady,
               launches=launches,
               k1_ms_per_launch=k1[1] / k1[0] if k1 else None,
               k1_ms_total=k1[1] if k1 else None,
               k2_ms=k2[1] / k2[0] if k2 else None,
               peak_device_bytes=int(peak),
               rc_counts={int(c): int((out.return_code == c).sum())
                          for c in out.return_code.unique()},
               nfev_max=int(out.nfeval.max()),
               frac_phase_within_5sigma=float((zphi < 5).double().mean()),
               frac_DM_within_5sigma=float((zDM < 5).double().mean()),
               finite=finite, profiled=device)
    emit("throughput", **res)
    if not (finite and res["frac_phase_within_5sigma"] > 0.99
            and res["frac_DM_within_5sigma"] > 0.99):
        raise AssertionError("north-star fit did not recover the injection")
    if launches["moments"] == 0 or launches["fftfit"] == 0:
        raise AssertionError("throughput fit launched %s" % launches)
    del out, errs
    phase_noise_fit(data[:256])
    return res


NOISE_ZEROED = (7, 102, 341)   # channels zeroed in the noise_fit cube


def noise_fit_bound_ms(rows, nbin, Ns=20):
    """get_noise_fit's least time over ``rows`` profiles of ``nbin``: the
    cube read once, against per row one rFFT (2.5 n log2 n), the power,
    the [nharm] x [nharm, Ns] shape product and the Ns^3 grid (3 adds and
    a compare per point)."""
    nharm = nbin // 2 + 1
    ops = rows * (2.5 * nbin * math.log2(nbin) + 3 * nharm
                  + 2 * nharm * Ns + 4 * Ns ** 3)
    return bound_ms(rows * nbin * 8 + rows * 8, (ops, PEAK_FP64_PER_S))


def phase_noise_fit(cube):
    """The "fit" noise estimators on the card (B10): get_noise_fit on the
    channels of ``cube`` [nsub, nchan, nbin] with NOISE_ZEROED zeroed in
    every subint (time, peak memory, bound), the Wiener and brickwall
    filters on one subint's profiles; the first subint held against the
    port on the CPU (k_crit equal, noise within 1e-12 relative, the
    filters within 1e-12 of their peak, zeroed channels 0)."""
    import torch

    from pulseportraiture_tpu_torch import _kernels as K
    from pulseportraiture_tpu_torch.ops import noise

    nsub, nchan, nbin = cube.shape
    cube[:, list(NOISE_ZEROED)] = 0.0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sig = noise.get_noise_fit(cube)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    ms = cuda_ms(lambda: noise.get_noise_fit(cube), reps=3, warm=0)
    bound, by = noise_fit_bound_ms(nsub * nchan, nbin)
    _, profiled = kernel_device_ms(lambda: noise.get_noise_fit(cube), K)

    sub = cube[0]
    host = sub.cpu()
    pows = noise._power(sub)[1]
    kc_card = noise.find_kc(pows).cpu()
    kc_cpu = noise.find_kc(noise._power(host)[1])
    n_card, n_cpu = sig[0].cpu(), noise.get_noise_fit(host)
    ok = n_cpu != 0
    noise_rel = float(((n_card - n_cpu).abs()[ok] / n_cpu[ok]).max())
    ps = noise.get_noise(sub)[:, None]
    wiener_ms = cuda_ms(lambda: noise.wiener_smooth(sub, ps), reps=5)
    brick_ms = cuda_ms(lambda: noise.wiener_smooth(sub, ps, brickwall=True),
                       reps=5)
    smooth = noise.wiener_smooth(sub, ps, brickwall=True).cpu()
    smooth_cpu = noise.wiener_smooth(host, ps.cpu(), brickwall=True)
    smooth_gap = rel_err(smooth, smooth_cpu)
    bw_card = noise.fit_brickwall(sub, ps).cpu()
    bw_cpu = noise.fit_brickwall(host, ps.cpu())
    wb_bound, wb_by = bound_ms(2 * sub.numel() * 8, (
        nchan * 5.0 * nbin * math.log2(nbin), PEAK_FP64_PER_S))
    kc_counts = torch.unique(kc_card, return_counts=True)
    res = dict(shape=[nsub, nchan, nbin], channels=nsub * nchan,
               zeroed_channels=list(NOISE_ZEROED), first_call_s=first_s,
               ms=ms, bound_ms=bound, bound_by=by, share_of_bound=bound / ms,
               peak_extra_device_bytes=int(peak),
               k_crit_counts={int(k): int(c) for k, c in zip(*kc_counts)},
               cpu_check=dict(
                   channels=nchan,
                   k_crit_mismatches=int((kc_card != kc_cpu).sum()),
                   noise_max_rel_err=noise_rel,
                   zeroed_noise=n_card[list(NOISE_ZEROED)].tolist(),
                   brickwall_kc_mismatches=int((bw_card != bw_cpu).sum()),
                   wiener_brickwall_smooth_rel_err=smooth_gap),
               wiener_smooth_ms=wiener_ms, brickwall_smooth_ms=brick_ms,
               filters_bound_ms=wb_bound, filters_bound_by=wb_by,
               filters_shape=[nchan, nbin], profiled=profiled)
    emit("noise_fit", **res)
    c = res["cpu_check"]
    if c["k_crit_mismatches"] or c["brickwall_kc_mismatches"] or \
            not noise_rel <= 1e-12 or not smooth_gap <= 1e-12 or \
            any(v != 0.0 for v in c["zeroed_noise"]) or \
            not bool(torch.isfinite(sig).all()):
        raise AssertionError("noise_fit: the card disagrees with the CPU: "
                             "%s" % c)
    return res


def phase_throughput_scat(dev, K):
    """The north-star scattering fit (bench_common.py's fit_scat) at
    1000 x 512 x 2048: tau TAU_INJ at nu0, alpha -4, flags (1,1,0,1,1)."""
    import torch

    from pulseportraiture_tpu_torch.fit.portrait import (
        fit_portrait_full_batch, model_kmax)

    nsub, nchan, nbin = 1000, 512, 2048
    data, freqs, nu0, phis, dDMs, model = north_star_data(
        dev, 3, nsub, nchan, nbin, t_scat=TAU_INJ * P0)[:6]
    kmax = model_kmax(model)
    errs = torch.full((nsub, nchan), NOISE, dtype=torch.float64, device=dev)
    init = torch.zeros((nsub, 5), dtype=torch.float64, device=dev)
    init[:, 0], init[:, 1] = phis, dDMs
    init[:, 3], init[:, 4] = math.log10(TAU_INJ * 1.5), -4.0
    nus = torch.full((nsub,), nu0, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()

    def run():
        return fit_portrait_full_batch(
            data, model, init, P0, freqs, errs=errs,
            fit_flags=(1, 1, 0, 1, 1), nu_fits=(nus, nus, nus),
            nu_outs=(nus, nus, nus), log10_tau=True, max_iter=30, kmax=kmax,
            device=dev)

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_kernel, device = kernel_device_ms(run, K)
    zphi = ((((out.phi - phis) + 0.5) % 1.0 - 0.5) / out.phi_err).abs()
    zDM = ((out.DM - dDMs) / out.DM_err).abs()
    ztau = ((out.tau - math.log10(TAU_INJ)) / out.tau_err).abs()
    zalpha = ((out.alpha + 4.0) / out.alpha_err).abs()
    finite = bool(torch.isfinite(out.params).all()
                  and torch.isfinite(out.param_errs).all())
    k3 = per_kernel.get("moments_scat")
    nfev = out.nfeval.double()

    def within(z):
        return float((z < 5).double().mean())

    res = dict(shape=[nsub, nchan, nbin], kmax=kmax, first_s=t_first,
               steady_s=t_steady, toas_per_s=nsub / t_steady,
               launches=launches,
               k3_ms_per_launch=k3[1] / k3[0] if k3 else None,
               k3_ms_total=k3[1] if k3 else None,
               peak_device_bytes=int(peak),
               rc_counts={int(c): int((out.return_code == c).sum())
                          for c in out.return_code.unique()},
               nfev_max=int(nfev.max()), nfev_median=float(nfev.median()),
               frac_phase_within_5sigma=within(zphi),
               frac_DM_within_5sigma=within(zDM),
               frac_tau_within_5sigma=within(ztau),
               frac_alpha_within_5sigma=within(zalpha),
               median_tau_err=float(out.tau_err.median()), finite=finite,
               profiled=device)
    emit("throughput_scat", **res)
    if not (finite and min(res[k] for k in res if k.startswith("frac_"))
            > 0.99):
        raise AssertionError("north-star scattering fit did not recover the "
                             "injection")
    if launches["moments_scat"] == 0:
        raise AssertionError("scattering fit launched %s" % launches)
    return res


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from pulseportraiture_tpu_torch import _kernels as K

    profile_dir = argv[argv.index("--profile") + 1] \
        if "--profile" in argv else None
    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu, flush=True)
    emit("gpu", nvidia_smi=gpu, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    K.build()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: [ln for ln in log.splitlines() if "Used" in ln
                       or "spill" in ln] for name, log in
                K.BUILD_LOG.items()})

    rows = phase_kernels(dev, K)
    work = tempfile.mkdtemp(prefix="pp_smoke_")
    # each path's launches, from its main run (counts zeroed just before)
    by_path = {}
    try:
        by_path["pptoas"], big, small = phase_pptoas(
            root, work, K, profile_dir=profile_dir)
        by_path["pptoas_scat"] = phase_pptoas_scat(root, work, K, big, small)
        by_path["narrowband"] = phase_narrowband(root, work, K, big, small)
        by_path["narrowband_scat"] = phase_narrowband_scat(root, work, K,
                                                           small)
        by_path["templates"] = phase_templates(root, work, K, small)
        by_path["ppzap"] = phase_ppzap(root, work, K, small)
        by_path["ppalign"], avg = phase_ppalign(root, work, K, dev)
        by_path["ppspline"] = phase_ppspline(root, work, K, dev, avg, small)
        by_path["ppgauss"] = phase_ppgauss(root, work, K, dev, avg, small)
        by_path["walkthrough"] = phase_walkthrough(root, work, K, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_throughput(dev, K)
    phase_throughput_scat(dev, K)
    # K1's and K2's main path is pptoas, K3's pptoas_scat (their own
    # fit-flag groups), each with the later paths; K1 and K2 also with the
    # template builders and the walkthrough
    own = dict(moments="pptoas", fftfit="pptoas",
               moments_scat="pptoas_scat")
    paths = {name: [own[name], "narrowband", "narrowband_scat",
                    "templates", "ppzap"] for name in own}
    for name in ("moments", "fftfit"):
        paths[name] += ["ppalign", "ppspline", "ppgauss", "walkthrough"]
    launches = {name: sum(by_path[p][name] for p in paths[name])
                for name in own}

    kernels = []
    for name, (src, _, replaces) in K.KERNELS.items():
        r = rows[name]
        extra = {}
        if name == "fftfit":
            r, extra = r[K2_MAIN], dict(shapes=[
                {key: c[key] for key in (
                    "shape", "Ns", "ms", "call_ms", "first_call_ms", "stage_ms",
                    "bound_ms", "share_of_bound", "library_ms", "plain_ms",
                    "argmin_mismatches", "max_abs_err")} for c in r])
        elif name == "moments_scat":
            r, extra = r[K3_MAIN], dict(shapes=[
                {key: c[key] for key in (
                    "shape", "shared_abs_m2", "lanes", "ms", "call_ms",
                    "bound_ms", "share_of_bound", "plain_ms", "max_rel_err",
                    "max_abs_err")} for c in r])
        kernels.append(dict(
            name=name, route="cuda",
            source="pulseportraiture_tpu_torch/csrc/" + src,
            replaces=replaces, launches=launches[name],
            launches_by_path={p: by_path[p][name] for p in paths[name]},
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], **extra))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
