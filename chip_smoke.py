#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pulseportraiture_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each on stdout; any failure exits non-zero (synth,
throughput, noise_fit and throughput_scat run right after kernels, while
the profiler's clock conversion is fresh):

  gpu         nvidia-smi name and power limit of the card
  build       nvcc build of every kernel in pulseportraiture_tpu_torch/csrc
  kernels     each hand kernel against its plain PyTorch version on the
              same inputs (error, tolerance, kernel / plain / bound /
              library times): K1's two epilogues (the three sums, and
              the per-row f, g and H terms) at [1000, 512, 128] (the
              throughput batch), [48, 512, 128] and [16, 256, 128] (serve),
              [1, 512, 128] (the mesh's groups of one) and [64, 512, 128]
              with 40 lanes (pptoas chunks), each beside the launch
              floor of an empty kernel at the same geometry; K2 at
              [256, 1025] (a 256-subint archive's guess), [1000, 1025] and
              [131072, 1025] with Ns 100 and [1000, 1025] with Ns 2048,
              grid-argmin mismatches, its time split
              by stage and its first call (phasor table built); K3 at
              [1000, 512, 128] with one shared |m|^2, at [64, 512, 128]
              with per-subint |m|^2 and a lane subset, and at
              [7636, 1, 128] (narrowband --fit_scat: one channel and one
              |m|^2 per lane); K4's two epilogues (the fit's spectra
              set-up, with the errors given and with the noise measured)
              on the rFFT of [64, 512, 2048] (a throughput chunk),
              [16, 512, 2048] and [16, 256, 1024] (serve and survey),
              [7636, 1, 2048] (one-channel lanes) and [64, 512, 2048]
              with a model per row (ppalign), K 128; K9's two epilogues
              (the Gaussian portrait fit's f, g and J^T J; its f alone)
              at [512, 2048] with 1, 2, 3, 4 and 19 components in one
              lane (both sides of the warp / mma layouts' crossover) and
              1 in three lanes (NaNs alike, the same bits twice), beside
              epilogue B its layout, the torch route it replaces
              (vmap(jacfwd) of the residual and its two einsums) and, at
              4 and 19 components, cuBLAS's Gram alone (bmm of a
              materialised basis); K10's two epilogues (the scattered and
              joined portrait fit's f, g and J^T J; its f alone) at [512,
              2048] with 1, 4 and 19 components in one lane, each at tau
              > 0, tau = 0 with tau fitted (its and the scattering
              index's rows and columns exactly 0), two join groups, and
              joined with tau > 0, beside epilogue B the bytes it stages,
              the library's rfft of the basis and Gram of the packed rows
              (torch.fft.rfft + torch.bmm) and, up to four components,
              the torch jacfwd route it replaces.  Kernel
              and library times are device times from CUDA-graph replay;
              ``call_ms`` is the wrapper's time per call, host included
              (back-to-back CUDA events); a K4 case whose inputs fit in
              the L2 cache (``l2_resident``) also has ``cold_ms``, with
              L2 flushed before each call
  pptoas      the port's pptoas CLI on a 128-subint x 512-channel x 2048-bin
              archive (written by the port's make_fake_pulsar from
              examples/; subint 3 has one live channel, so both fit-flag
              groups run): 128 TOAs, injected phase and dDM recovered
              within 5 sigma, K1 (both epilogues) and K2 launched; a
              16-subint subset
              re-run with the plain versions swapped in agrees within 1 ns
  load        load_data on the card on the pptoas archive: the main path
              (pptoas's load flags, then ppalign's: dedisperse, tscrunch,
              pscrunch) with K5 (csrc/unpack.cu: decode, baseline), K6
              (csrc/loadstats.cu: noise, S/N) and K7 (csrc/rotate.cu:
              the phasor pass, the work copy's dedispersion) launched; its
              wall over three runs, the seconds of each step (FITS read,
              upload, K5, cuFFT, K6, K7, download: io.archive.LOAD_STEPS)
              and the same load on the CPU; the card's bunch against the
              plain versions on the card (subints within 1e-12 of each
              row's range, noise 1e-13 and S/N 1e-12 relative, prof
              1e-12 of its peak, masks equal) and the CPU's (reported);
              pptoas's TOAs (GetTOAs, fed the load's device cube) from
              the card load against those from the plain load (1 ns, rc
              and nfeval equal), the fit's host-to-device copies (none of
              a portrait from pageable memory: the cube is not uploaded
              again); K5-K7 against their plain versions at the load's
              shapes (K5 on the whole stored big-endian column, 65,536
              rows of 2048 bins: with the baseline, the baseline alone,
              and the decode alone, bit-equal, beside torch.addcmul; K6
              on one chunk of subints, K7 on the whole spectrum), with
              times and bounds
  pptoas_scat the same archive with --fit_scat (the model scatters with
              TAU = 20 us at 1500 MHz, alpha -4): 128 TOAs, phase, dDM
              and the scattering time at scat_ref_freq recovered within
              5 sigma, K2 and K3 launched (the one-channel subint fits phase
              alone at the model's fixed tau: K3 too); the 16-subint
              subset against the plain versions (1 ns; tau and alpha
              within 5e-7 / 1e-5 plus the printed digit); then --fit_dt4
              on the 16-subint archive, kernels against plain (the
              (1,1,1,0,0) roots path, K1 and K2 launched)
  narrowband  pptoas --narrowband --print_phase --print_flux on the
              128-subint archive: one TOA per live (subint, channel)
              (64,644, all in one K2 launch), the injected phase
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
  viz         the plotting layer's device numbers on the 16-subint archive
              (viz and viz.figdata only: no matplotlib): GetTOAs with
              show_plot=True, then for every subint show_fit's numbers
              (the fitted subint on the card, each live channel's
              reduced chi2 in one reduction), show_stacked_profiles
              (fit=True)'s FFTFIT of subint 0's fitted channels (one K2
              launch at [nchan, 1025], Ns 100) and ppzap --hist's
              numbers: K1 and K2 launched; the reduction against the
              CPU on the same fitted subints (1e-12 relative); against
              the same path with the plain versions (TOAs 1 ns, reduced
              chi2 2e-9 relative, stacked-fit phases 1e-9 rot) and the
              port on the CPU (TOAs 1 ns, reduced chi2 2e-9 relative);
              the figure numbers' wall and CUDA-event ms; K1 and K2
              against plain and timed at the path's shapes
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
  ppalign_s   ppalign -s on the aligned archive (its one epoch aligned
              to itself, --niter 1, then psrsmooth -W of the output:
              K8 on its 512 x 2048 profiles, its plain version made to
              raise meanwhile): CLI wall, K1, K2 and K8 launched (its
              scan among them), K8's rows by tier (certified by the scan,
              redecided by the route), K8 held against its plain version
              on the rows the path gave it (the same (level, factor) per
              row, each smooth within 1e-10 of its peak), its scan
              against the scan's plain version (S/N and chi2 within
              1e-12 relative, the repeat flags equal) and the
              certification's premise there (the scan's noise, signal
              power and chi2 within their bounds of the route's), timed
              there (its device time by CUDA-graph replay of the scan
              with its certification and of the route over the uncertain
              rows, the call by CUDA events, the route alone over every
              row both ways) beside its bound and the plain version's
              time; K8 at a width its
              scan does not take (16 rows of 2000 bins: every row through
              the route, counted, as plain); the .sm archive
              against psrsmooth with the plain versions (one count of
              each row's int16 encoding)
  ppspline    ppspline -s on the aligned archive: eigenprofiles, K8 at the
              path's shapes (the ten candidate eigenprofiles, [10, 2048],
              and the mean profile, [1, 2048]) held against its plain
              version and timed as on ppalign_s, B9's eigensolve with its
              bound; pptoas with the .spl on the 16-subint archive: phase
              and DM within 5 sigma, plain vs kernel 1 ns
  ppgauss     ppgauss --autogauss 0.05 --niter 2 on the aligned archive:
              components, LM nfev and rc, its portrait fits through K9
              (gauss_normal and gauss_sse launched, held against their
              plain versions on the path's first inputs and timed there;
              no fit took the jacfwd route), the torch route K9 replaces
              timed at the solution (the Jacobian pass, with and without
              its einsums), a plain-versions run (parameters within 1e-6
              of their errors); pptoas with the .gmodel: plain vs kernel 1 ns,
              phase and DM within 5 sigma once referred to the initial
              template's phase zero and DM reference (the model's own
              offsets against the template, a fit of one noiseless
              portrait to the other, are added to each TOA)
  ppgauss_scat the portrait fits K9 does not take, each through K10:
              ppgauss --autogauss 0.05 --niter 2 --fitscat on the same
              archive (tau fitted from 0, where it stays), a joined fit of
              its portrait in two join groups of channels through
              fit.gauss.fit_gaussian_portrait, ppgauss --fitscat
              --fitalpha --tau on a scattered archive (make_fake_pulsar's
              t_scat, 40 us; tau > 0 at the solution) and a joined fit
              with tau > 0 of that portrait: K10's two epilogues launched
              and no fit on jacfwd or K9 (FIT_ROUTES), K10 held against
              its plain version on each run's first inputs and timed
              there, each run again with the plain versions (parameters
              within 1e-6 of their errors); each fit's wall, nfev, rc,
              routes and the device ms of one jacfwd pass at its
              solution (the route K10 replaces; with its einsums) beside
              its bound
  walkthrough examples/example.py through the port at full width: 5
              scintillated, dispersed epochs of 10 x 512 x 2048 (noise
              1.5, own seeds, dDM ~ N(3e-4, 2e-4), the spin perturbation
              dF0 2e-9 Hz, dF1 4e-17 Hz/s injected as phase) -> align
              (niter 1) -> spline model -> wideband TOAs -> .tim -> the
              DMDATA 1 + DMX GLS fit of F0 and F1: example.py's own DM
              and GLS criteria, K1, K2 and K8 launched (and held against
              their plain versions), the pptoas step rerun with the plain
              versions (1 ns); seconds per step and in
              load_data, the GLS's wrms and reduced chi2
  synth       make_fake_dataset making the throughput data on the card
              through K12 (csrc/synth.cu; the counts zeroed just before:
              one launch a block, no block on the torch route): seconds,
              bound, peak device memory; one block [32, 512, 2048], with
              and without the scattering spectrum, by CUDA-graph replay
              beside its bound, its plain version's time and
              torch.randn's for the block's noise, held against its plain
              version on the same noise from one generator state (every
              row within 1e-13 of its peak); make_fake_dataset's kernel and
              torch routes from one seed (the same draws: 1e-13 of each
              row's peak); 1000 bins through the counted torch route, held
              to the CPU's make (1e-12 of the peak)
  throughput  fit_portrait_full_batch(init_params=None) at 1000 x 512 x
              2048 (data made on the card by the port's make_fake_dataset
              at phases and dDMs from a seeded torch.Generator; the
              phases seeded through K2): TOAs/s, K1 launches (the
              solver's evaluations through epilogue B, the finish's sums
              through A), K4 launches (the spectra, one a chunk of 64
              subints), K1 and K4 ms per launch, device events and
              device-busy ms per fit (torch.profiler, a separate run),
              peak device memory
  noise_fit   get_noise_fit through K11 (csrc/noisefit.cu) on the first
              256 subints of the throughput data (131,072 channels, three
              zeroed in every subint; the counts zeroed just before): its
              ms, bound, extra peak memory; K11 alone over every
              channel's spectrum by CUDA-graph replay (cuFFT's rFFT
              apart) beside its bound and its plain version's time, and
              against its plain version on the card (k_crit mismatches,
              ties within the chi2 rounding bound, none a fault; noise
              within 1e-12 relative); the Wiener and brickwall smoothing
              of one subint's 512 profiles; that subint against the port
              on the CPU (k_crit and brickwall cutoffs equal, noise within
              1e-12 relative, zeroed channels 0)
  obs         the observability layer (obs/, testing/faults): pptoas on
              the 16-subint archive with PPTPU_OBS_DIR and PPTPU_TRACE_DIR
              (CLI walls with obs on and off, in turns), --fit_scat, ppalign
              --niter 1 over two of the ppalign epochs (obs only), the
              seeded throughput fit (1000 x 512 x 2048) without errs (the
              noise from K4's second epilogue) captured in an obs
              run (its time with obs on and off): every run directory and
              its manifest (platform gpu, the card), one devtime event per
              captured fit region (device total > 0 and within the
              region's wall), each hand kernel's rows in the traces equal
              to its launches over the region and the event's
              ``complete`` saying so, the pp_seed / pp_solve /
              pp_scatter stages, pps_device_peak_bytes equal to
              max_memory_allocated, tools/obs_report.py on every run, and
              a PPTPU_FAULTS="site:dispatch@nth=1" run raising the port's
              InjectedFault
  throughput_scat  the north-star scattering fit at 1000 x 512 x 2048:
              tau 3e-3 rot at nu0, alpha -4, started at 1.5 x tau,
              flags (1,1,0,1,1), log10 tau, nu_fits = nu_outs = nu0,
              max_iter 30: TOAs/s, K3 and K4 launches and ms per launch,
              nfeval,
              return codes, tau recovery, peak device memory
  survey      the survey runner, ppsurvey, over a metafile of 8 archives
              of 16 x 512 x 2048, 2 of 16 x 500 x 2000 (padded into the
              512 x 2048 bucket), 2 of 16 x 256 x 1024 and a truncated
              file (make_fake_pulsar, noise 0.5, own seeds): plan; warm
              on a fresh kernel build directory (a process of its own:
              nvcc builds one library per source; every warm program
              ran);
              run --prefetch 2, then again with --trace-bucket (walls,
              the load / fit / write split from the obs spans, per-bucket
              archive seconds, device busy from the bucket traces, the
              capture's cost) and once under torch.profiler (its
              host-to-device copies, pageable and pinned, and its peak
              device memory); run
              --max_archives 4 --prefetch 0 (serial loads) then resume
              over 6 archives of both buckets; --fit_scat on 4 archives
              of the 512 x 2048 bucket (K3); supervise with two worker processes sharing the
              card; the zap -> align -> toas chain on 4 archives of 4 x
              512 x 2048.  Every good archive done once per workdir with
              one checkpoint block, the truncated one quarantined with a
              reason; -pp_grid 512x2048 on the padded archives' TOAs
              only; canonical archives' TOAs equal to the port's pptoas
              (1 ns, the error and DM columns within a printed unit),
              padded ones within 5 sigma and DM 5e-4 of their native
              fit; one archive through the plain versions with and
              without --fit_scat (1 ns, every other number 1e-9
              relative, 1e-6 with --fit_scat); K1, K2 and K3 against
              their plain versions on the inputs the survey gave them at
              each shape; K1, K2 and K3 launched
  serve       the TOA service on the survey's archives (8 of 16 x 512 x
              2048, 2 of 16 x 256 x 1024): an in-process TOAService
              (batch_max 4, window 0.25 s, the plan warmed with coalesce
              2..4) behind its socket, driven by pploadgen's closed loop
              (24 requests from two tenants on fresh spooled copies,
              concurrency 4: requests/s, client p50/p90/p99 and each
              latency, the server's queue_wait / park / dispatch / fit
              p50s), then over the
              socket the 256 x 1024 archives, a fit_scat request (K3), a
              duplicate (replayed, no launch) and two requests under
              PPTPU_FAULTS="site:dispatch@nth=1" (one retries, its
              sibling completes), and a traced closed loop of 8 (device
              busy; its host-to-device copies, none of a portrait from
              pageable memory); at least one coalesced dispatch; every served
              archive once in its tenant's toas.tim and within 1 ns of
              the port's pptoas on the same archive; no kernel built
              after warm (request manifests: backend_compiles 0); K1, K2
              and K3 against their plain versions and timed (with their
              bounds) at every shape the path gave them; peak memory.
              Then ppserve start as a process (--plan --warm on the
              survey's primed kernel build directory: 0 builds, a hit
              per source),
              ppserve submit --wait and status, SIGTERM -> exit 0; and
              pprouter start with 2 spawned daemons, 4 requests over
              both buckets through the router (each once, pptoas's
              TOAs), each daemon's device memory (its allocator, and
              the card memory the daemons added by nvidia-smi, their
              CUDA contexts included), SIGTERM -> exit 0
  mesh        the device-mesh layer on the one card named repeatedly: the
              north-star fit (1000 x 512 x 2048, made by B11) on meshes
              (1,1,1), (2,1,1), (1,2,1), (1,1,2) and (2,2,2) with a given
              init (TOAs bit-equal to the unsharded kernel fit, every other
              field within 1e-12 relative, rc and nfeval equal) and seeded
              (TOAs within 1 ns): wall, device busy (torch.profiler; None
              with the rows lost counted where a hand kernel's rows fall
              short of its launches, as in every profiled phase), peak
              memory and launches per mesh; single-process
              distributed_sweep_fit; the throughput_scat fit on (1,2,1)
              (K3 per channel shard, equal to the unsharded fit);
              run_survey(use_mesh=True) over a (2,2,1) mesh and ppsurvey
              run --mesh (1,1,1) on 4 of the survey's 512 x 2048 archives
              (each once, TOAs within 1 ns and the printed columns of the
              survey's unmeshed run); two processes on gloo sharing the
              card, each fitting half the batch through
              distributed_sweep_fit (rows reassembled: equal given init,
              1 ns seeded); K1, K2 and K3 against their plain versions and
              timed at every shape the phase gave them
  obs_late    a known-fault check of obs in this process after the mesh:
              pptoas on the 16-subint archive with PPTPU_OBS_DIR and
              PPTPU_TRACE_DIR; so late the profiler may lose a region's
              first rows, and each devtime event must state its rows,
              launches, ``complete`` and ``lost_rows`` as its trace holds
              them
  failed_datafiles  no archive of any GetTOAs run failed on a device error

Then a ``kernels`` line (every hand kernel with its launches on its
paths — K1 (``moments``, ``moments_grad_hess``) and K2 on pptoas, K3
(``moments_scat``, ``moments_scat_grad_hess``) on pptoas_scat, each plus
the narrowband,
narrowband_scat, templates, ppzap, obs, survey, serve and mesh runs, K1
and K2 also on viz, ppalign, ppalign_s, ppspline, ppgauss and the
walkthrough, K4
(``spectra``, ``spectra_noise``) on every path, the throughput and
throughput_scat fits included, K5-K7 (``unpack``, ``baseline``,
``load_stats``, ``rotate``) on every path that loads an
archive, the load phase's own run first, K8 (``smooth_search``, counted
once a chunk decided, its ``symbols`` and ``rows_by_path``: rows by
tier) on ppspline, ppalign_s and the walkthrough, K9 (``gauss_normal``,
``gauss_sse``) on ppgauss, K10 (``gauss_ft_normal``, ``gauss_ft_sse``)
on ppgauss_scat, K11 (``noise_fit``) on noise_fit, K12
(``synth_rows``) on synth, with
``launches_by_path`` —
errors and times; K2 with
its [1000, 1025] numbers, K1 and K3 with their [1000, 512, 128] ones and
K4 with its [64, 512, 2048] ones,
K5-K7 with the load phase's, K8 with ppalign_s's [512, 2048] ones, K9
with its one-lane, one-component [512, 2048] ones, K10 with its
one-lane, one-component, tau > 0 [512, 2048] ones, K11 with its
[131072, 1025] ones, K12 with its unscattered block's,
each with a ``shapes`` list of all its cases), the card's name and power
limit, and
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

# K3's FP64 operations per harmonic: the reference's arithmetic as the SASS
# of a loop taking a sincospi at every harmonic shows it (k3_compare.py's
# count for the one-warp-per-row csrc/moments_scat.cu before the current
# design: 43 DFMA, 29 DMUL, 8 DADD, the sincospi and the division
# included), an FMA counted as 2 FLOP against the FP64 peak.  The bound keeps this count
# whatever the kernel does; the current loop's phasor recurrence needs
# 2 * 31 + 28 + 7 between its anchors.
K3_FLOPS = 2 * 43 + 29 + 8
# K3 epilogue B's operations per row: the chain rule, dC and dS, f, g and the
# 15 Hessian entries of _kernels.grad_hess_rows_plain, a division as one
K3_GH_OPS = 306
# epilogue B against its plain version: each of its 21 columns within this
# of the column's largest magnitude (tests/test_torch_moments_scat.py GH_TOL:
# the sums agree to 1e-12; f, g and H divide by C and S and cancel)
K3_GH_TOL = 1e-10
K3_NAMES = ("moments_scat", "moments_scat_grad_hess")
# K1's FP64 operations per harmonic: the SASS of its harmonic loop
# (k3_compare.py --k1: csrc/moments.cu, a sincospi at every harmonic;
# a body of four harmonics, one 16-byte load each) shows 21 DFMA, 9 DMUL
# and 3 DADD per harmonic (with 1 DSETP and 3 FRND, 108 instructions in
# all), an FMA counted as 2 FLOP against the FP64 peak; the bound before
# counted ~18 operations (sincospi as 2)
K1_FLOPS = 2 * 21 + 9 + 3
# K1 epilogue B's operations per row: dC[3], f, g[3] and the six Hessian
# entries of _kernels.moments_grad_hess_plain, a division as one
K1_GH_OPS = 56
# epilogue B against its plain version, each of its 10 columns within
# this of the column's largest magnitude (as K3's: the sums agree to
# 1e-12; f, g and H divide by C and S and cancel)
K1_GH_TOL = 1e-10
K1_NAMES = ("moments", "moments_grad_hess")
# K1's two epilogues (the finish's sums, the solver's evaluations) and K2
# (the guess)
K1_K2_NAMES = K1_NAMES + ("fftfit",)
# the kernels every scattering-free path launches: K1, K2 and K4's first
# epilogue (the fit's spectra set-up)
PHASE_DM_KERNELS = K1_K2_NAMES + ("spectra",)
# the kernels a scattering fit from a given start launches: K4's first
# epilogue and K3's two
SCAT_FIT_KERNELS = ("spectra",) + K3_NAMES
# the kernels every path with --fit_scat launches: K2 and those
SCAT_KERNELS = ("fftfit",) + SCAT_FIT_KERNELS
# K4's epilogues: the set-up with given errors, and with the noise
# measured in the same pass (fits without errs: the mesh's)
K4_NAMES = ("spectra", "spectra_noise")
# K4 against its plain version: the cross and |m|^2 elementwise (the
# same rounded operations: bit-equal expected), each within 1e-14 of
# |d_k| |m_k| (|m_k|^2); the per-row sums (Sd, the noise and its
# inv_err2) within 1e-13 relative: sums of nharm positive terms taken in
# another order (a recursive sum's bound is (n - 1) eps, 1.1e-13 at 1025)
K4_ELEM_TOL, K4_SUM_TOL = 1e-14, 1e-13
# the load's kernels: K5 (the decode, with the baseline in the same
# launch, and the baseline alone), K6 (noise and S/N) and K7 (the phasor
# pass of every rotation, the load's dedispersion among them)
LOAD_NAMES = ("unpack", "baseline", "load_stats", "rotate")
# the ones every path that loads an archive launches (K5's baseline alone
# runs only after a state conversion or a rotation)
LOAD_PATH_KERNELS = ("unpack", "load_stats", "rotate")
# K5-K7 against their plain versions: the decode bit-equal; the baseline
# within 1e-12 of each row's range (the kernel's window sums err by
# <= 2.8e-14 of it, the plain FFT convolution's by ~log2(nbin) eps of
# the row's largest magnitude); noise within 1e-13 and S/N within 1e-12
# relative (sums of ~nbin terms in another order); the work copy's
# profile within 1e-12 of its peak; K7 within 1e-13 of each row's
# largest harmonic (one sincos and a complex product an element)
LOAD_TOL = dict(baseline=1e-12, noise=1e-13, snr=1e-12, prof=1e-12,
                rotate=1e-13)
# FP64 operations of K7 per harmonic: the floor-mod (2), the angle (1),
# a sincos (~20) and the complex product (6)
K7_OPS = 29
# K8, smart_smooth's search (every path that smooths: ppspline -s,
# ppalign -s, the walkthrough's spline model)
SMOOTH_KERNELS = ("smooth_search",)
# K8 against its plain version: the same (level, factor) on every row and
# each smooth within this of its row's peak (tests/test_torch_wavelet_*;
# the route hands cuFFT the plain version's bits, the scan's rows are
# certified, and the smooths differ by rounding: the plain's are
# wavelet_smooth's)
SMOOTH_TOL = 1e-10
# FP64 operations of K8 per half-spectrum bin per candidate, beside the
# candidates' forward transforms: forming its spectrum S from the tables
# and reading its S/N and chi2 from it, ~24 a bin
K8_OPS = 24
# K8's rows by tier on each path that smooths (K.SMOOTH_ROWS over the
# path's main run): scanned (the scan, certified or not), redecided (of
# those, the uncertain rows the route took), unscanned
SMOOTH_TIERS = {}
# K9, the Gaussian portrait fit's normal equations (ppgauss's portrait fits
# with tau frozen at 0 and no join groups): epilogue B the fit's f, g and
# J^T J, epilogue A its f alone (the trial steps)
K9_NAMES = ("gauss_normal", "gauss_sse")
# K9 against its plain version: f, g and J^T J within this of each output's
# largest magnitude, lane by lane (tests/test_torch_cuda_paths.py
# GAUSS_TOL: sums of ~1e6 terms in another order, the Gram per channel then
# the chain rule over channels), and the same NaNs
K9_TOL = 1e-12
# K9 cases at ppgauss's aligned portrait, [512, 2048]: (components, lanes);
# ppgauss --autogauss fits one component in one lane; 2 and 3 components
# sit on the two sides of the layouts' crossover (the warp layout up to
# _kernels.GAUSS_WARP_NGAUSS, the FP64 tensor cores beyond); 19 fill the
# mma layout's one 64-row panel, 21 take its three panels (two row
# blocks), each a pass over the bins
K9_CASES = [(1, 1), (2, 1), (3, 1), (4, 1), (1, 3), (19, 1), (21, 1)]
K9_MAIN = 0
# the most components at which the kernels phase times the torch route K9
# replaces (its forward-mode tangents at 19 components would hold ~19 GB
# an intermediate)
K9_ROUTE_MAX_NGAUSS = 4
# the components at which the kernels phase times cuBLAS's Gram alone
K9_GRAM_NGAUSS = (4, 19)
# K10, the scattered and joined Gaussian portrait fit's normal equations
# (ppgauss --fitscat / --fitalpha / --tau and joined fits): epilogue B the
# fit's f, g and J^T J, epilogue A its f alone
K10_NAMES = ("gauss_ft_normal", "gauss_ft_sse")
# K10 against its plain version: f, g and J^T J within this of each
# output's largest magnitude, lane by lane, as K9_TOL
# (tests/test_torch_cuda_paths.py GAUSS_FT_TOL), and the same NaNs
K10_TOL = 1e-12
# K10 cases at ppgauss's aligned portrait, [512, 2048], one lane:
# (components, kind): tau 2 bins ("tau"), tau 0 with tau fitted ("tau0":
# its rows and columns exactly 0), two join groups ("joined"), both
# ("joined_tau"); epilogue B on chip at one and four components (clusters
# of one and two blocks), staged at 19; then 19 components over 8192 bins,
# staged (lanes, channels, bins after the kind)
K10_KINDS = ("tau", "tau0", "joined", "joined_tau")
K10_CASES = [(ng, kind) for ng in (1, 4, 19) for kind in K10_KINDS] + [
    (19, "tau", 1, 512, 8192)]
K10_MAIN = 0
# the scattered archive of ppgauss_scat's --fitscat --fitalpha --tau run:
# its scattering time at nu0 [s] (the fit starts at 3/4 of it), index
# and noise
K10_T_SCAT, K10_ALPHA, K10_NOISE = 4e-5, -4.0, 0.05
# K11, the "fit" noise estimator (get_noise_fit, find_kc; load_data,
# normalize_portrait and get_SNR with noise_method="fit"), against its plain
# version over every channel of the noise_fit cube: the cutoffs equal (a
# mismatch is a tie only where the plain chi2 at the two cutoffs' best grid
# points lie within the rounding bound of k11_ties, else a fault), the noise
# within this relative where the cutoffs agree (sums of ~nbin terms in
# another order)
K11_NOISE_TOL = 1e-12
# K11 off the main path's shape, against its plain version on the card:
# (rows, nbin, fn, Ns, fact) — an a grid wider than 20 (the second pass run
# twice), rows whose power does not fit shared memory (re-read from device
# memory), and both at once
K11_WIDE_CASES = ((4096, 2048, "half_tri", 27, 2.0),
                  (96, 65536, "exp_dc", 20, 1.1),
                  (32, 131072, "half_tri", 23, 1.5))
# K12, the synthetic-data writer (make_fake_dataset, make_fake_portrait):
# every row within this of its peak of the plain version's on the same
# noise (one sincos and two complex products a harmonic, then K8's inverse
# transform against cuFFT's; tests/test_torch_cuda_paths.py)
K12_TOL = 1e-13
# a width K12's onchip path does not take: its cufft path (K12's harmonics
# kernel, cuFFT's inverse, K12's epilogue), counted in SYNTH_PATHS
K12_NARROW_BINS = 1000
# K11 and K12: no TOA path runs them (the paths' noise is "PS"; K12 makes
# the synthetic data some phases fit), so those paths neither watch nor
# require them
K11_K12_NAMES = ("noise_fit", "synth_rows")


def toa_path_kernels(K):
    """The hand kernels a TOA path (survey, serve, mesh) is held to."""
    return tuple(n for n in K.KERNELS if n not in K11_K12_NAMES)


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


def graph_ms(fn, reps=20, keep=None):
    """Device time [ms] per fn() call: ``reps`` calls captured in one CUDA
    graph and replayed, so the host's time to launch them is left out.
    With a list ``keep``, a copy of what the last call of the timed
    replay returned (a tensor or a tuple of them) is appended to it."""
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
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    if keep is not None:
        keep.append(tuple(t.clone() for t in out) if isinstance(out, tuple)
                    else out.clone())
    del graph
    return a.elapsed_time(b) / reps


def l2_bytes():
    """The card's L2 cache in bytes (50 MiB on the H100 where torch does
    not say)."""
    import torch

    return int(getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                       0) or 50 * 2 ** 20)


def l2_cold_ms(fn, reps=20):
    """Device time [ms] per fn() call with the L2 cache flushed before
    each: graph_ms of a write of twice the L2's bytes and fn(), less
    graph_ms of the write alone.  For inputs that fit in L2, which
    graph_ms's replays keep there."""
    import torch

    flush = torch.empty(2 * l2_bytes() // 4, dtype=torch.float32,
                        device="cuda")
    both = graph_ms(lambda: (flush.zero_(), fn()), reps)
    alone = graph_ms(flush.zero_, reps)
    del flush
    return both - alone


def bound_ms(nbytes, *work):
    """Least time [ms] for moving ``nbytes`` or doing ``work``, a list of
    (operations, peak rate per second); and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / rate for n, rate in work) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def moments_bound_ms(n, nchan, K, grad_hess=False):
    """K1's least time for ``n`` evaluated rows of [nchan, K]: their
    cross read once, shifts and inv_err2 per row, three sums out
    (float64); K1_FLOPS per harmonic.  With ``grad_hess`` (epilogue B)
    also pd (3) and S per row in, 10 columns out instead of three, and
    K1_GH_OPS per row."""
    rows = n * nchan
    nbytes = rows * K * 16 + rows * 8 * 2
    ops = rows * K * K1_FLOPS
    if grad_hess:
        nbytes += rows * 8 * 4 + rows * 10 * 8
        ops += rows * K1_GH_OPS
    else:
        nbytes += rows * 3 * 8
    return bound_ms(nbytes, (ops, PEAK_FP64_PER_S))


def moments_scat_bound_ms(n, nchan, K, shared, grad_hess=False):
    """K3's least time for ``n`` evaluated rows: their cross (and, unless
    ``shared``, their |m|^2) read once, a shared |m|^2 once, shifts /
    taus / inv_err2 per row, nine sums out; K3_FLOPS per harmonic.  With
    ``grad_hess`` (epilogue B) also pd (3) and lnf per row and tau per
    subint in, 21 columns out instead of nine, and K3_GH_OPS per row."""
    rows = n * nchan
    nbytes = rows * K * 16 + (nchan if shared else rows) * K * 8 \
        + rows * 8 * 3
    ops = rows * K * K3_FLOPS
    if grad_hess:
        nbytes += rows * 8 * 4 + n * 8 + rows * 21 * 8
        ops += rows * K3_GH_OPS
    else:
        nbytes += rows * 9 * 8
    return bound_ms(nbytes, (ops, PEAK_FP64_PER_S))


def fftfit_bound_ms(N, nharm, Ns, newton):
    """K2's least time at [N, nharm]: cross and inv_err2 read once,
    (phase, C, d2C) written; the grid stage is one float64 product [N,
    2 nharm] x [2 nharm, Ns] with a table the profiles share (4
    operations per complex term, FP64 tensor cores), and each Newton
    step and the final objective take ~18 FP64 operations (sincospi as
    2) per harmonic."""
    return bound_ms(N * nharm * 16 + N * 8 + 3 * N * 8,
                    (4 * N * nharm * Ns, PEAK_FP64_TENSOR_PER_S),
                    (18 * N * nharm * (newton + 1), PEAK_FP64_PER_S))


def spectra_bound_ms(r, nchan, nharm, kmax, m_per_row, absm2, noise):
    """K4's least time for r x nchan rows of nharm harmonics: the data
    spectra read once, the model's first kmax harmonics (shared: once for
    the batch), inv_err2 or the weights per row; the cross written, |m|^2
    when asked, sd (and, with ``noise``, the noise and inv_err2) per row;
    |d|^2 (3 FP64 operations) at every harmonic and the product (6) and
    |m|^2 (3) below kmax."""
    rows = r * nchan
    nbytes = rows * nharm * 16 + (rows if m_per_row else nchan) * kmax * 16 \
        + rows * kmax * 16 + rows * 8 * (2 + 2 * bool(noise))
    ops = rows * (3 * nharm + 6 * kmax)
    if absm2:
        nbytes += rows * kmax * 8
        ops += rows * 3 * kmax
    return bound_ms(nbytes, (ops, PEAK_FP64_PER_S))


def gauss_ops_per_bin(ngauss, normal):
    """K9's FP64 operations per bin and lane, from csrc/gauss.cu, as
    (vector operations, the Gram's multiply-adds counted 2 each): per live
    component the wrap (2), x / sigma, z^2 and its half, the exp (~20),
    amp e and its sum (27 in all), and in epilogue B its four basis values
    (8); per bin 1 / err (B), r and m (3), and then r^2 and its sum (A, 2);
    in B 2 for each of the (Q + 1)(Q + 2) / 2 Gram entries, Q + 1 = 3
    ngauss + 2, a float64 product sum_bins v v^T that the FP64 tensor cores
    can take."""
    if not normal:
        return 3 + 27 * ngauss + 2, 0
    q1 = 3 * ngauss + 2
    return 4 + 35 * ngauss, q1 * (q1 + 1)


def k9_err_values(errs):
    """The error values K9 must read: one a channel where errs is
    per-channel noise broadcast over the bins (stride 0 along them, as
    ppgauss gives it), else one a bin."""
    return errs.shape[0] if errs.stride(1) == 0 else errs.numel()


def gauss_bound_ms(B, nchan, nbin, ngauss, normal, err_values):
    """K9's least time for B lanes of [nchan, nbin] at ``ngauss``
    components: the params, data, ``err_values`` errors (k9_err_values),
    bin centres and freqs read once (the lanes share the data), f (and g
    and J^T J) written once; gauss_ops_per_bin per bin and lane, its Gram
    multiply-adds at the FP64 tensor cores' peak and the rest at the FP64
    peak, and for epilogue B the chain rule (4 operations per channel for
    each of J^T J's upper triangle and g)."""
    P = 6 * ngauss + 3
    N = nchan * nbin
    nbytes = B * P * 8 + (N + err_values) * 8 + (nbin + nchan) * 8 + \
        B * 8 * ((1 + P + P * P) if normal else 1)
    vector, gram = gauss_ops_per_bin(ngauss, normal)
    ops = B * N * vector
    if normal:
        ops += B * nchan * 4 * (P * (P + 1) // 2 + P)
    return bound_ms(nbytes, (ops, PEAK_FP64_PER_S),
                    (B * N * gram, PEAK_FP64_TENSOR_PER_S))


def k9_errors(got, want):
    """K9's outputs (f, or (f, g, J^T J)) against its plain version's:
    ({output: the largest gap over the lanes, each relative to its lane's
    largest magnitude}, the largest absolute gap, whether the NaNs fall
    alike)."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs, abs_err, same_nan = {}, 0.0, True
    for key, a, b in zip(("f", "g", "JtJ"), got, want):
        a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        same_nan &= bool(torch.equal(torch.isnan(a), torch.isnan(b)))
        gap = (a - b).nan_to_num(0.0).abs().amax(-1)
        scale = b.nan_to_num(0.0).abs().amax(-1).clamp_min(1e-300)
        errs[key] = float((gap / scale).max())
        abs_err = max(abs_err, float(gap.max()))
    return errs, abs_err, same_nan


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


# K4's output arguments, by name in its wrappers' signatures
K4_OUTS = ("cross_out", "sd_out", "noise_out", "inv_err2_out", "absm2_out")


def k4_arguments(fn, args, kw=None):
    """The arguments of the K4 call fn(*args, **kw) by parameter name."""
    import inspect

    return inspect.signature(fn).bind(*args, **(kw or {}))


def k4_call(fn, args, kw=None):
    """fn (K4's wrapper or its plain version) on ``args`` with fresh
    output tensors in place of those given; returns {output name:
    tensor}."""
    import torch

    bound = k4_arguments(fn, args, kw)
    outs = {key: torch.empty_like(bound.arguments[key]) for key in K4_OUTS
            if isinstance(bound.arguments.get(key), torch.Tensor)}
    bound.arguments.update(outs)
    fn(*bound.args, **bound.kwargs)
    return outs


def k4_errors(K, arguments, got, want):
    """K4 kernel outputs ``got`` against the plain version's ``want`` (by
    output name) on the call's ``arguments`` (k4_arguments): the cross
    (and |m|^2) elementwise relative to |d_k| |m_k| (|m_k|^2), each row
    sum relative to itself; (errors by output, the largest absolute
    error, whether within K4_ELEM_TOL / K4_SUM_TOL)."""
    import torch

    dfft, mfft, kmax = (arguments.arguments[key]
                        for key in ("dfft", "mfft", "kmax"))
    f0 = torch.ones(kmax, dtype=torch.float64, device=dfft.device)
    f0[0] = abs(K.F0_fact)
    m = (mfft if mfft.ndim == 3 else mfft[None])[..., :kmax].abs() * f0
    scale = (dfft[..., :kmax].abs() * f0 * m).clamp_min(1e-300)
    errs, ok, abs_err = {}, True, 0.0
    for key, g in got.items():
        w = want[key]
        name = "abs_m2" if key == "absm2_out" else key[:-len("_out")]
        gap = (g - w).abs()
        abs_err = max(abs_err, float(gap.max()) if gap.numel() else 0.0)
        if key == "cross_out":
            errs[name] = float((gap / scale).max())
            errs["cross_bit_equal"] = bool(torch.equal(g, w))
            ok &= errs[name] <= K4_ELEM_TOL
        elif key == "absm2_out":
            errs[name] = float((gap / (m * m).expand_as(g).clamp_min(
                1e-300)).max())
            ok &= errs[name] <= K4_ELEM_TOL
        else:
            errs[name] = float((gap / w.abs().clamp_min(1e-300)).max())
            ok &= errs[name] <= K4_SUM_TOL
    return errs, abs_err, ok


def phase_kernels(dev, kern):
    """K1 at each of K1_CASES, K2 at each of K2_CASES and K3 at each of
    K3_CASES against their plain versions, with times and bounds
    (``kern`` is the _kernels module)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = {}
    k1 = [phase_k1(dev, kern, gen, *case) for case in K1_CASES]
    for j, name in enumerate(K1_NAMES):
        rows[name] = [pair[j] for pair in k1]
    rows["fftfit"] = [phase_k2(dev, kern, gen, N, Ns, lo, hi,
                               time_plain=N <= 1000)
                      for N, Ns, lo, hi in K2_CASES]
    k3 = [phase_k3(dev, kern, gen, *case) for case in K3_CASES]
    for j, name in enumerate(K3_NAMES):
        rows[name] = [pair[j] for pair in k3]
    k4 = [phase_k4(dev, kern, gen, *case) for case in K4_CASES]
    for j, name in enumerate(K4_NAMES):
        rows[name] = [pair[j] for pair in k4]
    k9 = [phase_k9(dev, kern, *case) for case in K9_CASES]
    for j, name in enumerate(K9_NAMES):
        rows[name] = [pair[j] for pair in k9]
    k10 = [phase_k10(dev, kern, *case) for case in K10_CASES]
    for j, name in enumerate(K10_NAMES):
        rows[name] = [pair[j] for pair in k10]
    return rows


def k9_inputs(dev, ngauss, B, nchan=512, nbin=2048, seed=9):
    """K9's arguments at [nchan, nbin]: B lanes of ngauss power-law
    components (model code "000", tau 0), data the first lane's model
    plus noise (numpy, seeded), per-channel errors broadcast over the bins
    as ppgauss gives them, the band of the smoke's archives (k10_inputs
    with neither scattering nor join groups)."""
    return k10_inputs(dev, ngauss, "tau0", B, nchan, nbin, seed)[0][:7]


def jacfwd_pass_ms(residual, x, reps=3):
    """The jacfwd route fit.lm takes for ``residual`` at lanes x [B,
    nparam]: (device ms of one vmap(jacfwd) pass, ms of that pass with
    the two einsums forming J^T r and J^T J) by CUDA events."""
    import torch

    def res_twice(p):
        r = residual(p)
        return r, r

    jac_b = torch.func.vmap(torch.func.jacfwd(res_twice, has_aux=True))

    def step():
        J, r = jac_b(x)
        return (torch.einsum("bnp,bn->bp", J, r),
                torch.einsum("bnp,bnq->bpq", J, J))

    jac = cuda_ms(lambda: jac_b(x), reps=reps, warm=1)
    both = cuda_ms(step, reps=reps, warm=1)
    torch.cuda.empty_cache()
    return jac, both


def portrait_residual(code, data, errs, bins, freqs, nu_ref, joins=(),
                      P=None):
    """fit.gauss.fit_gaussian_portrait's residual of a parameter vector
    (the model's, the scattering index, then each join group's pair)."""
    import torch

    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    def residual(p):
        n = p.shape[0] - 1 - 2 * len(joins)
        mpar = torch.cat([p[:n], p[n + 1:]]) if len(joins) else p[:n]
        model = gen_gaussian_portrait(code, mpar, p[n], bins, freqs, nu_ref,
                                      join_ichans=joins, P=P,
                                      device=data.device)
        return ((data - model) / errs).reshape(-1)

    return residual


def torch_route_ms(args, reps=3):
    """The torch route K9 replaces on K9's arguments, as fit.lm takes it
    (jacfwd_pass_ms of the unscattered residual)."""
    x, data, errs, bins, freqs, nu_ref, code = args
    return jacfwd_pass_ms(portrait_residual(code, data, errs, bins, freqs,
                                            nu_ref), x, reps)


def gram_cublas_ms(dev, ngauss, B, nchan, nbin):
    """cuBLAS's time for K9's Gram alone: torch.bmm(V.mT, V) of a
    materialised basis V [B nchan, nbin, 3 ngauss + 2] float64 (values
    drawn at random: the product's time does not depend on them), by
    graph replay.  No PyTorch call computes K9's whole function."""
    import torch

    V = torch.randn((B * nchan, nbin, 3 * ngauss + 2), dtype=torch.float64,
                    device=dev)
    ms = graph_ms(lambda: torch.bmm(V.mT, V))
    del V
    return ms


def phase_k9(dev, kern, ngauss, B, nchan=512, nbin=2048):
    """K9's two epilogues against their plain versions at [nchan, nbin]
    with ``ngauss`` components and B lanes: f (and g and J^T J) within
    K9_TOL, the same NaNs, two calls the same bits; device times by graph
    replay through a GaussWork (the fit's route: no allocation in the
    launch), the wrapper's per call with and without one, the plain
    version's, the bound; the work's outputs of the timed replay and of a
    call after the timed ones the first call's bits; beside epilogue B
    its layout, the torch route it replaces (torch_route_ms) and, at
    K9_GRAM_NGAUSS, cuBLAS's Gram alone (gram_cublas_ms).  Returns the
    two rows."""
    import torch

    args = k9_inputs(dev, ngauss, B, nchan, nbin)
    work = kern.GaussWork(*args[1:])
    route = torch_route_ms(args) if ngauss <= K9_ROUTE_MAX_NGAUSS else \
        (None, None)
    out = []
    for name in K9_NAMES:
        fn, plain = getattr(kern, name), getattr(kern, name + "_plain")
        got, again, want = fn(*args), fn(*args), plain(*args)
        torch.cuda.synchronize()
        errs, abs_err, same_nan = k9_errors(got, want)
        repeat = all(torch.equal(a, b) for a, b in zip(
            *(v if isinstance(v, tuple) else (v,) for v in (got, again))))
        err = max(errs.values())
        bms, by = gauss_bound_ms(B, nchan, nbin, ngauss, name == "gauss_normal",
                                 k9_err_values(args[2]))
        replayed = []
        row = dict(shape=[B, nchan, nbin], ngauss=ngauss, max_rel_err=err,
                   errors=errs, tol=K9_TOL, same_nan=same_nan,
                   repeat_bit_equal=repeat, max_abs_err=abs_err,
                   ms=graph_ms(lambda: fn(*args, work=work), keep=replayed),
                   call_ms=cuda_ms(lambda: fn(*args)),
                   work_call_ms=cuda_ms(lambda: fn(*args, work=work)),
                   plain_ms=cuda_ms(lambda: plain(*args), reps=3, warm=1),
                   bound_ms=bms, bound_by=by, library_ms=None)
        row["share_of_bound"] = bms / row["ms"]
        # the timed work route (graph replays, then calls) against the
        # first call: the same bits, so within K9_TOL of plain too
        later = fn(*args, work=work)
        torch.cuda.synchronize()
        work_same = all(torch.equal(a, b) for v in (replayed[0], later)
                        for a, b in zip(v if isinstance(v, tuple) else (v,),
                                        got if isinstance(got, tuple)
                                        else (got,)))
        work_err = max(max(k9_errors(v, want)[0].values())
                       for v in (replayed[0], later))
        row.update(work_bit_equal=work_same, work_max_rel_err=work_err)
        if name == "gauss_normal":
            row["layout"] = kern.gauss_layout(ngauss)
            row["torch_route_jac_ms"], row["torch_route_ms"] = route
            if ngauss in K9_GRAM_NGAUSS:
                row["gram_cublas_ms"] = gram_cublas_ms(dev, ngauss, B, nchan,
                                                       nbin)
        emit("kernels", kernel=name, **row)
        if not (err <= K9_TOL and same_nan and repeat and work_same
                and work_err <= K9_TOL):
            raise AssertionError("%s kernel disagrees at %s: %s"
                                 % (name, row["shape"], row))
        out.append(row)
    torch.cuda.empty_cache()
    return out


def k10_inputs(dev, ngauss, kind, B=1, nchan=512, nbin=2048, seed=10):
    """K10's arguments at [nchan, nbin] and its join groups: B lanes of
    ngauss power-law components (model code "000"), tau 2 bins where
    ``kind`` (K10_KINDS) scatters (else 0) and two join groups splitting
    the band where it joins (the second's phase and DM off the first's),
    data the first lane's model plus noise (numpy, seeded), per-channel
    errors broadcast over the bins as ppgauss gives them, the band of the
    smoke's archives, each channel's group and the period."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    rng = np.random.default_rng(seed)
    freqs = np.linspace(NU0 - 400.0, NU0 + 400.0, nchan)
    comps = []
    for c in range(ngauss):
        comps += [0.2 + 0.6 * c / ngauss, -0.05, 0.03 + 0.01 * c, 0.1,
                  1.0 / (c + 1), -1.2]
    joined = kind.startswith("joined")
    tau = 2.0 if kind in ("tau", "joined_tau") else 0.0
    jp = [0.0, 0.0, 0.013, -1e-3] if joined else []
    joins = [np.arange(0, nchan // 2), np.arange(nchan // 2, nchan)] \
        if joined else []
    base = np.concatenate([[0.02, tau], comps, [-4.0], jp])
    x = np.stack([base * (1.0 + 0.002 * k) for k in range(B)])
    x[:, 1] = tau
    npar = 2 + 6 * ngauss
    P = 0.005
    model = gen_gaussian_portrait(
        "000", np.concatenate([base[:npar], jp]), -4.0,
        np.arange(nbin) / nbin, freqs, NU0, join_ichans=joins, P=P).numpy()
    noise = rng.uniform(0.02, 0.08, nchan)
    data = model + rng.normal(0.0, 1.0, (nchan, nbin)) * noise[:, None]
    groups = np.full(nchan, -1, dtype=np.int32)
    for j, ichans in enumerate(joins):
        groups[ichans] = j
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (t(x), t(data), t(noise[:, None]).expand(nchan, nbin),
            get_bin_centers(nbin, device=dev), t(freqs), NU0, "000",
            t(groups), len(joins), P), joins


def real_fft_ops(nbin):
    """FP64 operations of one real FFT of nbin points as K10 takes it: a
    complex FFT of nbin / 2 points (5 n log2 n) and the split (~12 an
    output harmonic)."""
    n = nbin // 2
    return 5 * n * math.log2(n) + 12 * (n + 1)


def gauss_ft_bound_ms(B, nchan, nbin, ngauss, njoin, normal):
    """K10's least time for B lanes of [nchan, nbin] at ``ngauss``
    components and ``njoin`` join groups: the params, the data's packed
    spectrum, the channels' errors, bins, freqs and groups read once, f
    (and g and J^T J) written once (the staged rows are the design's, not
    the function's: gauss_ft_staged_bytes); per lane and channel the
    component basis at K9's count (gauss_ops_per_bin), its 3 ngauss + 1
    real FFTs (real_fft_ops; 1 in epilogue A), ~10 operations a harmonic
    and row for the scattering and join factors and the packing (the
    residual's ~6 a harmonic in A), at the FP64 peak; in B the Gram of the
    q1 = 3 ngauss + 4 packed rows, (q1 + 1) q1 multiply-adds counted 2
    each a packed real, at the FP64 tensor cores' peak, and the chain rule
    (4 operations a channel for each of J^T J's upper triangle and g)."""
    P = 6 * ngauss + 3 + 2 * njoin
    N = nchan * nbin
    nbytes = B * P * 8 + N * 8 + nchan * (8 + 8 + 4) + nbin * 8 + \
        B * 8 * ((1 + P + P * P) if normal else 1)
    vector, _ = gauss_ops_per_bin(ngauss, normal)
    K = nbin // 2 + 1
    if normal:
        rows = 3 * ngauss + 1
        ops = B * (N * vector + nchan * rows * (real_fft_ops(nbin) + 10 * K)
                   + nchan * 4 * (P * (P + 1) // 2 + P))
        q1 = 3 * ngauss + 4
        gram = B * N * q1 * (q1 + 1)
    else:
        ops = B * (N * vector + nchan * (real_fft_ops(nbin) + 16 * K))
        gram = 0
    return bound_ms(nbytes, (ops, PEAK_FP64_PER_S),
                    (gram, PEAK_FP64_TENSOR_PER_S))


def gauss_ft_staged_bytes(B, nchan, nbin, ngauss, staged=True):
    """The bytes K10's epilogue B stages in device memory on its staged
    path, written once and read once by the Gram (read once a panel pair
    beyond 20 components): [B, nchan, 3 ngauss + 3, nbin] float64, twice
    over; 0 on its on-chip path (``staged`` false)."""
    return 2 * B * nchan * (3 * ngauss + 3) * nbin * 8 if staged else 0


def rfft_bmm_ms(dev, ngauss, B, nchan, nbin):
    """The library's time for K10's two halves: torch.fft.rfft of a
    materialised basis [B nchan, 3 ngauss + 1, nbin] (the rows K10
    transforms) and torch.bmm of packed rows [B nchan, 3 ngauss + 4,
    nbin] by their transpose (its Gram), by graph replay (values drawn at
    random: the times do not depend on them).  No PyTorch call computes
    K10's whole function."""
    import torch

    V = torch.randn((B * nchan, 3 * ngauss + 1, nbin), dtype=torch.float64,
                    device=dev)
    W = torch.randn((B * nchan, 3 * ngauss + 4, nbin), dtype=torch.float64,
                    device=dev)
    ms = graph_ms(lambda: (torch.fft.rfft(V), torch.bmm(W, W.mT)))
    del V, W
    torch.cuda.empty_cache()
    return ms


def k10_split_ms(fn, reps=5):
    """Epilogue B's device ms a call split by kernel, from torch.profiler
    over ``reps`` calls: {"cluster": gauss_ft_gram_cluster_kernel (the
    on-chip path's one launch), "rows": gauss_ft_rows_kernel, "gram":
    gauss_ft_gram_kernel (the staged path's two)} for the kernels the
    calls ran, with "kernels_per_call", their launches a call; None where
    the trace holds no device rows."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out, count = {}, 0
    for ev in prof.key_averages():
        for part in ("cluster", "rows", "gram"):
            name = "gauss_ft_gram_cluster_kernel" if part == "cluster" else \
                "gauss_ft_%s_kernel" % part
            if name in ev.key:
                us = getattr(ev, "device_time_total", None)
                if us is None:
                    us = ev.cuda_time_total
                out[part] = us / 1e3 / reps
                count += ev.count
    if not out:
        return None
    out["kernels_per_call"] = count / reps
    return out


def phase_k10(dev, kern, ngauss, kind, B=1, nchan=512, nbin=2048):
    """K10's two epilogues against their plain versions at [nchan, nbin]
    with ``ngauss`` components of ``kind`` (K10_KINDS) and B lanes: f, g
    and J^T J within K10_TOL, the same NaNs, two calls the same bits, the
    tau and scattering-index rows and columns exactly 0 at tau = 0;
    device times by graph replay through a GaussFtWork, the wrapper's per
    call with and without one, the plain version's, the bound, epilogue
    B's path (on chip: its cluster size, rows a transform batch and the
    clusters the card holds at once; staged) and staged rows' bytes (0 and
    no staged tensor on chip), its split by kernel (k10_split_ms: one
    launch a call on chip); the work's
    outputs of the timed replay and of a later call the first call's
    bits; beside epilogue B the
    library's rfft and Gram (rfft_bmm_ms) and, up to K9_ROUTE_MAX_NGAUSS
    components, the torch jacfwd route K10 replaces.  Returns the two
    rows."""
    import torch

    args, joins = k10_inputs(dev, ngauss, kind, B, nchan, nbin)
    work = kern.GaussFtWork(*args[1:])
    route = (None, None)
    if ngauss <= K9_ROUTE_MAX_NGAUSS:
        x, data, errs, bins, freqs, nu_ref, code = args[:7]
        route = jacfwd_pass_ms(portrait_residual(
            code, data, errs, bins, freqs, nu_ref, joins,
            args[9] if joins else None), x)
    out = []
    for name in K10_NAMES:
        fn, plain = getattr(kern, name), getattr(kern, name + "_plain")
        got, again, want = fn(*args), fn(*args), plain(*args)
        torch.cuda.synchronize()
        errs, abs_err, same_nan = k9_errors(got, want)
        repeat = all(torch.equal(a, b) for a, b in zip(
            *(v if isinstance(v, tuple) else (v,) for v in (got, again))))
        normal = name == "gauss_ft_normal"
        bms, by = gauss_ft_bound_ms(B, nchan, nbin, ngauss, len(joins),
                                    normal)
        replayed = []
        row = dict(shape=[B, nchan, nbin], ngauss=ngauss, kind=kind,
                   njoin=len(joins), max_rel_err=max(errs.values()),
                   errors=errs, tol=K10_TOL,
                   same_nan=same_nan, repeat_bit_equal=repeat,
                   max_abs_err=abs_err,
                   ms=graph_ms(lambda: fn(*args, work=work), keep=replayed),
                   call_ms=cuda_ms(lambda: fn(*args)),
                   work_call_ms=cuda_ms(lambda: fn(*args, work=work)),
                   plain_ms=cuda_ms(lambda: plain(*args), reps=3, warm=1),
                   bound_ms=bms, bound_by=by, library_ms=None)
        row["share_of_bound"] = bms / row["ms"]
        later = fn(*args, work=work)
        torch.cuda.synchronize()
        tup = lambda v: v if isinstance(v, tuple) else (v,)  # noqa: E731
        work_same = all(torch.equal(a, b) for v in (replayed[0], later)
                        for a, b in zip(tup(v), tup(got)))
        zeros = True
        if normal:
            sz = kern.gauss_ft_sizes(ngauss, len(joins), nchan, nbin)
            row["path"] = "onchip" if sz["cluster"] else "staged"
            row["cluster"], row["batch"] = sz["cluster"], sz["batch"]
            row["active_clusters"] = kern.gauss_ft_active_clusters(
                ngauss, len(joins), nchan, nbin)
            staged = work.buffers(B, ngauss, True).staged is not None
            row["staged_bytes"] = gauss_ft_staged_bytes(
                B, nchan, nbin, ngauss, staged)
            row["staged_ms_at_hbm"] = row["staged_bytes"] / \
                PEAK_BYTES_PER_S * 1e3
            row["rfft_bmm_ms"] = rfft_bmm_ms(dev, ngauss, B, nchan, nbin)
            row["split_ms"] = k10_split_ms(lambda: fn(*args, work=work))
            split = row["split_ms"] or {}
            if staged == bool(sz["cluster"]) or (
                    split and split["kernels_per_call"] != (
                        2 if staged else 1)):
                raise AssertionError(
                    "gauss_ft_normal at %s: path %s, staged tensor %s, "
                    "split %s" % (row["shape"], row["path"], staged, split))
            row["torch_route_jac_ms"], row["torch_route_ms"] = route
            if kind == "tau0":
                ia = args[0].shape[1] - 1 - 2 * len(joins)
                zeros = not any(bool(t.any()) for i in (1, ia) for t in (
                    got[1][:, i], got[2][:, i, :], got[2][:, :, i]))
                row["tau_alpha_exactly_zero"] = zeros
        row["work_bit_equal"] = work_same
        emit("kernels", kernel=name, **row)
        if not (row["max_rel_err"] <= K10_TOL and same_nan and repeat
                and work_same and zeros):
            raise AssertionError("%s kernel disagrees at %s %s: %s"
                                 % (name, row["shape"], kind, row))
        out.append(row)
    del work
    torch.cuda.empty_cache()
    return out


# K1 cases: (subints, channels, harmonics, rows evaluated: a lane subset of
# that many subints, or all when None)
K1_CASES = [
    (1000, 512, 128, None),   # throughput: the batch
    (48, 512, 128, None),     # serve: a coalesced dispatch
    (16, 256, 128, None),     # serve: a 256 x 1024 request
    (1, 512, 128, None),      # mesh: a group of one subint
    (64, 512, 128, 40),       # pptoas chunks: the solver's active lanes
]
K1_MAIN = 0


def phase_k1(dev, kern, gen, n, nchan, K, nlanes):
    """K1's two epilogues against their plain versions: each sum's (each
    of epilogue B's 10 columns') error relative to its largest magnitude
    over the rows; device times, the launch floor (an empty kernel at the
    same geometry), bound.  Returns the two rows."""
    import torch

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float64)

    cross = torch.complex(torch.randn((n, nchan, K), generator=gen,
                                      device=dev, dtype=torch.float64),
                          torch.randn((n, nchan, K), generator=gen,
                                      device=dev, dtype=torch.float64))
    inv_err2 = rand(n, nchan) + 0.5
    S = (rand(n, nchan) + 0.1) * inv_err2
    m = n if nlanes is None else nlanes
    lanes = None if nlanes is None else torch.sort(torch.randperm(
        n, generator=gen, device=dev)[:nlanes]).values
    shifts = (rand(m, nchan) - 0.5) * 4000.0
    # epilogue B's d shift / d(phi, DM, GM) at the north star's scale
    pd = torch.stack([torch.ones((m, nchan), dtype=torch.float64,
                                 device=dev), (rand(m, nchan) - 0.5) * 0.4,
                      (rand(m, nchan) - 0.5) * 2e-3], dim=1).contiguous()
    floor_ms = graph_ms(lambda: kern.moments_launch_floor(m, nchan, dev))
    out = []
    for name in K1_NAMES:
        args = (cross, shifts, inv_err2, lanes) if name == "moments" else \
            (cross, shifts, pd, S, inv_err2, lanes)
        fn, plain = getattr(kern, name), getattr(kern, name + "_plain")
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        if name == "moments":
            cols, tol = ("C", "T1", "T2"), 1e-12
            errs = {c: rel_err(got[..., j], want[..., j])
                    for j, c in enumerate(cols)}
        else:
            cols, tol = kern.MOMENTS_GRAD_HESS_COLUMNS, K1_GH_TOL
            errs = {c: rel_err(got[:, j], want[:, j])
                    for j, c in enumerate(cols)}
        err = max(errs.values())
        bms, by = moments_bound_ms(m, nchan, K,
                                   grad_hess=name != "moments")
        row = dict(shape=[n, nchan, K], lanes=nlanes, max_rel_err=err,
                   rel_err_by_column=errs, tol=tol,
                   max_abs_err=float((got - want).abs().max()),
                   ms=graph_ms(lambda: fn(*args)),
                   floor_ms=floor_ms,
                   call_ms=cuda_ms(lambda: fn(*args)),
                   plain_ms=cuda_ms(lambda: plain(*args), reps=3, warm=1),
                   bound_ms=bms, bound_by=by, library_ms=None)
        row["share_of_bound"] = bms / row["ms"]
        emit("kernels", kernel=name, **row)
        if not err <= tol:
            raise AssertionError("%s kernel disagrees at %s: %s"
                                 % (name, [n, nchan, K], errs))
        out.append(row)
    return out


# K3 cases: (subints, channels, harmonics, one |m|^2 shared by the batch,
# rows evaluated: a lane subset of that many subints, or all when None)
K3_CASES = [
    (1000, 512, 128, True, None),   # throughput_scat: the batch, one model
    (64, 512, 128, False, 40),      # pptoas chunks: per-subint models, lanes
    (16, 512, 128, True, None),     # serve: one fit_scat request
    (7636, 1, 128, False, None),    # narrowband --fit_scat, 16 subints:
                                    # one channel and one model per lane
    (1000, 256, 128, True, None),   # the mesh's (1, 2, 1) channel shard
]
K3_MAIN = 0


def phase_k3(dev, kern, gen, n, nchan, K, shared, nlanes):
    """K3's two epilogues against their plain versions: each sum's (each
    of epilogue B's 21 columns') error relative to its largest magnitude
    over the rows, device times, bound.  Returns the two rows."""
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
    # epilogue B's chain-rule inputs at the north star's scale: d shift /
    # d(phi, DM, GM), ln(freq / nu_tau) over 1300-1700 MHz, tau [rot]
    pd = torch.stack([torch.ones((m, nchan), dtype=torch.float64,
                                 device=dev), (rand(m, nchan) - 0.5) * 0.4,
                      (rand(m, nchan) - 0.5) * 2e-3], dim=1).contiguous()
    lnf = (rand(m, nchan) - 0.5) * 0.4
    tau = rand(m) * 4e-3 + 1e-3
    out = []
    for name in K3_NAMES:
        extra = () if name == "moments_scat" else (pd, lnf, tau, True)
        args = (cross, abs_m2, shifts, taus, inv_err2) + extra + (lanes,)
        fn, plain = getattr(kern, name), getattr(kern, name + "_plain")
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        if name == "moments_scat":
            cols, tol = kern.MOMENTS_SCAT_SUMS, 1e-12
            errs = {c: rel_err(got[..., j], want[..., j])
                    for j, c in enumerate(cols)}
        else:
            cols, tol = kern.GRAD_HESS_COLUMNS, K3_GH_TOL
            errs = {c: rel_err(got[:, j], want[:, j])
                    for j, c in enumerate(cols)}
        err = max(errs.values())
        bms, by = moments_scat_bound_ms(m, nchan, K, shared,
                                        grad_hess=name != "moments_scat")
        row = dict(shape=[n, nchan, K], shared_abs_m2=shared, lanes=nlanes,
                   max_rel_err=err, rel_err_by_column=errs, tol=tol,
                   max_abs_err=float((got - want).abs().max()),
                   ms=graph_ms(lambda: fn(*args)),
                   call_ms=cuda_ms(lambda: fn(*args)),
                   plain_ms=cuda_ms(lambda: plain(*args), reps=3, warm=1),
                   bound_ms=bms, bound_by=by, library_ms=None)
        row["share_of_bound"] = bms / row["ms"]
        emit("kernels", kernel=name, **row)
        if not err <= tol:
            raise AssertionError("%s kernel disagrees at %s: %s"
                                 % (name, [n, nchan, K], errs))
        out.append(row)
    return out


# K4 cases: (subints, channels, nbin, kmax, a model per row): the rows of
# one launch, a chunk of _spectra (fit/portrait.py SPECTRA_ROWS)
K4_CASES = [
    (64, 512, 2048, 128, False),   # throughput: a chunk of the 1000 subints
    (16, 512, 2048, 128, False),   # serve and survey: a 16 x 512 x 2048
                                   # archive
    (16, 256, 1024, 128, False),   # serve and survey: the 256 x 1024 bucket
    (7636, 1, 2048, 128, True),    # narrowband --fit_scat: one-channel
                                   # lanes, a model each
    (64, 512, 2048, 128, True),    # ppalign: a model per row (its 128-row
                                   # block in chunks of 64)
]
K4_MAIN = 0


def phase_k4(dev, kern, gen, r, nchan, nbin, kmax, per_row):
    """K4's two epilogues against their plain versions on the rFFT of
    random profiles (a baseline, noise) and of a pulse model, inv_err2
    and weights with zeros: errors (k4_errors), device times (graph
    replay), the wrapper's time per call, the plain version's, the
    bound and the launches one call counts.  Returns the two rows."""
    import torch

    nharm = nbin // 2 + 1
    x = (torch.arange(nbin, dtype=torch.float64, device=dev) + 0.5) / nbin
    pulse = torch.exp(-0.5 * ((x - 0.4) / 0.03) ** 2)
    dfft = torch.fft.rfft(torch.randn((r, nchan, nbin), generator=gen,
                                      device=dev, dtype=torch.float64)
                          + 2.0 + pulse, dim=-1)
    mshape = (r, nchan, nbin) if per_row else (nchan, nbin)
    mfft = torch.fft.rfft(pulse + 0.01 * torch.randn(
        mshape, generator=gen, device=dev, dtype=torch.float64), dim=-1)
    inv_err2 = torch.rand((r, nchan), generator=gen, device=dev,
                          dtype=torch.float64) + 0.5
    inv_err2[:, nchan // 2] = 0.0
    weights = (inv_err2 > 0.0).to(torch.float64)
    cross = torch.empty((r, nchan, kmax), dtype=torch.complex128, device=dev)
    vec = torch.empty((r, nchan), dtype=torch.float64, device=dev)
    absm2 = torch.empty((r, nchan, kmax), dtype=torch.float64,
                        device=dev) if per_row else None
    out = []
    for name in K4_NAMES:
        if name == "spectra":
            args = (dfft, mfft, inv_err2, kmax, cross, vec, absm2)
        else:
            args = (dfft, mfft, weights, nbin, kmax, cross, vec,
                    vec.clone(), vec.clone(), absm2)
        fn, plain = getattr(kern, name), getattr(kern, name + "_plain")
        n0 = kern.LAUNCHES[name]
        got = k4_call(fn, args)
        launches = kern.LAUNCHES[name] - n0
        want = k4_call(plain, args)
        torch.cuda.synchronize()
        errs, abs_err, ok = k4_errors(kern, k4_arguments(fn, args), got,
                                      want)
        del got, want
        bms, by = spectra_bound_ms(r, nchan, nharm, kmax, per_row, per_row,
                                   name == "spectra_noise")
        row = dict(shape=[r, nchan, nbin], nharm=nharm, kmax=kmax,
                   model_per_row=per_row, errors=errs,
                   tol=dict(elementwise=K4_ELEM_TOL, sums=K4_SUM_TOL),
                   max_abs_err=abs_err, launches_per_call=launches,
                   ms=graph_ms(lambda: fn(*args)),
                   call_ms=cuda_ms(lambda: fn(*args)),
                   plain_ms=cuda_ms(lambda: plain(*args), reps=3, warm=1),
                   bound_ms=bms, bound_by=by, library_ms=None)
        row["share_of_bound"] = bms / row["ms"]
        # inputs that fit in L2 stay there across graph_ms's replays: the
        # time with L2 flushed before each call is the one against HBM
        inputs = (dfft.numel() + mfft.numel()) * 16
        row["l2_resident"] = inputs <= l2_bytes()
        if row["l2_resident"]:
            row["cold_ms"] = l2_cold_ms(lambda: fn(*args))
            row["cold_share_of_bound"] = bms / row["cold_ms"]
        emit("kernels", kernel=name, **row)
        if not (ok and launches == 1):
            raise AssertionError("%s kernel disagrees at %s (or launched %d "
                                 "times): %s" % (name, [r, nchan, nbin],
                                                 launches, errs))
        out.append(row)
    return out


# K2 cases: (N profiles, Ns grid points, bounds); nharm 1025 (nbin 2048)
K2_CASES = [
    (256, 100, -0.5, 0.5),     # a 256-subint archive's guess
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
    bms, by = fftfit_bound_ms(N, nharm, Ns, newton)
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
def plain_kernels(K, names=None):
    """Swap the plain versions in for the kernels (all, or ``names``):
    the comparison run."""
    names = tuple(K.KERNELS) if names is None else tuple(names)
    saved = {name: getattr(K, name) for name in names}
    for name in names:
        setattr(K, name, getattr(K, name + "_plain"))
    try:
        yield
    finally:
        for name in names:
            setattr(K, name, saved[name])


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
# the pptoas archive (nsub, nchan, nbin): its depth cut to 128 subints
# (from 256) to keep the smoke within half its time limit
PPTOAS_SHAPE = (128, 512, 2048)


def smoke_weights(nsub, nchan):
    """The pptoas archives' channel weights: three channels zapped, and
    subint 3 with one live channel (fitted with flags (1,0,0,0,0))."""
    import numpy as np

    weights = np.ones((nsub, nchan))
    weights[:, [7, nchan // 5, nchan * 2 // 3]] = 0.0
    weights[3] = 0.0
    weights[3, nchan // 2] = 1.0
    return weights


def phase_pptoas(root, work, K, shape=PPTOAS_SHAPE, subset=16,
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
    big = make_fake_pulsar(gm, par, os.path.join(work, "smoke_big.fits"),
                           nsub=nsub, weights=weights, **kw)
    small = make_fake_pulsar(gm, par, os.path.join(work, "smoke16.fits"),
                             nsub=subset, weights=weights[:subset], **kw)
    t_make = time.perf_counter() - t0

    argv = ["-d", big, "-m", gm, "--no_bary", "--print_phase", *extra,
            "--quiet", "-o", os.path.join(work, "smoke_big.tim")]
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
    missing = [name for name in PHASE_DM_KERNELS if launches[name] == 0]
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
                    profile_dir, K)
    emit("pptoas", archive=[nsub, nchan, nbin], n_toas=len(toas),
         make_s=t_make, cli_s=t_cli, toas_per_s=nsub / t_cli,
         launches=launches, max_abs_z_DM=float(zDM.max()),
         max_abs_z_phase=float(zphi.max()),
         median_toa_err_us=float(np.median([t["err_us"] for t in toas])),
         plain_vs_kernel_max_ns=dt_ns)
    return launches, big, small


def load_bound_ms(name, rows, nbin):
    """The least time of load kernel ``name`` over ``rows`` profiles of
    ``nbin`` bins: each input read once, each output written once (K6
    needs only the top quarter of each spectrum, the harmonics of the
    noise mean), and its FP64 operations (K7_OPS per harmonic for K7,
    ~6 a bin for K5's decode and window sums, 3 a harmonic of the
    noise's quarter and 2 a bin of the S/N for K6)."""
    nharm = nbin // 2 + 1
    if name == "unpack":      # int16 in, float64 out, scl and offs
        return bound_ms(rows * nbin * 10 + rows * 16,
                        (rows * nbin * 6, PEAK_FP64_PER_S))
    if name == "decode":      # the same bytes, a product and a sum a bin
        return bound_ms(rows * nbin * 10 + rows * 16,
                        (rows * nbin * 2, PEAK_FP64_PER_S))
    if name == "baseline":
        return bound_ms(rows * nbin * 16, (rows * nbin * 4, PEAK_FP64_PER_S))
    if name == "load_stats":  # rows and spectra in, noise and S/N out
        top = nharm - int(0.75 * nharm)
        return bound_ms(rows * (nbin * 8 + top * 16 + 16),
                        (rows * (3 * top + 2 * nbin), PEAK_FP64_PER_S))
    # rotate: spectra in and out, a shift a row
    return bound_ms(rows * (nharm * 32 + 8),
                    (rows * nharm * K7_OPS, PEAK_FP64_PER_S))


def load_gaps(got, want):
    """The card's load ``got`` against ``want`` (DataBunches): subints
    relative to each row's range, noise and S/N relative, the profile
    relative to its peak, prof_noise and prof_SNR relative."""
    import numpy as np

    s = want.subints
    spread = np.maximum(np.ptp(s, axis=-1, keepdims=True), 1e-300)

    def rel(a, b):
        """Largest relative gap; NaN in both (0/0 S/N of a zapped
        channel) is no gap, NaN in one is an infinite one."""
        a, b = np.atleast_1d(np.asarray(a, float)), np.atleast_1d(
            np.asarray(b, float))
        if not b.size:
            return 0.0
        gap = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
        nan_a, nan_b = np.isnan(a), np.isnan(b)
        gap[nan_a & nan_b] = 0.0
        gap[nan_a ^ nan_b] = np.inf
        return float(gap.max())

    return dict(
        baseline=float(np.max(np.abs(got.subints - s) / spread)),
        noise=rel(got.noise_stds, want.noise_stds),
        snr=rel(got.SNRs, want.SNRs),
        prof=float(np.max(np.abs(got.prof - want.prof))
                   / np.abs(want.prof).max()),
        prof_noise=rel(got.prof_noise, want.prof_noise),
        prof_SNR=rel(got.prof_SNR, want.prof_SNR),
        masks_equal=bool(np.array_equal(got.masks, want.masks)))


def load_errors(K, name, a, kw):
    """Load kernel ``name`` (K5-K7) on the arguments ``a`` against its
    plain version, with fresh outputs and not counted: (errors,
    max_abs_err, ok at LOAD_TOL).  The decode bit-equal (with a baseline
    too: K5's decode alone on the same column); the baseline within
    each row's range; K6's noise and S/N relative; K7 relative to each
    row's largest harmonic."""
    import torch

    n0 = dict(K.LAUNCHES)
    fn, plain = getattr(K, name), getattr(K, name + "_plain")
    kw = {k: v for k, v in kw.items() if k != "out"}
    if name == "load_stats":
        x, X = a[0], a[1]
        snr = len(a) > 3 and a[3] is not None
        outs = [torch.empty(x.shape[0], dtype=torch.float64, device=x.device)
                for _ in range(4)]
        fn(x, X, outs[0], outs[1] if snr else None, *a[4:], **kw)
        plain(x, X, outs[2], outs[3] if snr else None, *a[4:], **kw)
        errs = dict(noise=float(((outs[0] - outs[2]).abs()
                                 / outs[2].abs()).max()))
        abs_err = float((outs[0] - outs[2]).abs().max())
        if snr:
            errs["snr"] = float(((outs[1] - outs[3]).abs() / outs[3].abs(
            ).clamp_min(1e-300)).max())
            abs_err = max(abs_err, float((outs[1] - outs[3]).abs().max()))
        ok = all(errs[k] <= LOAD_TOL[k] for k in errs)
    elif name == "rotate":
        got, want = fn(*a, **kw), plain(*a, **kw)
        scale = a[0].abs().amax(-1, keepdim=True).clamp_min(1e-300)
        errs = dict(rotate=float(((got - want).abs() / scale).max()))
        abs_err = float((got - want).abs().max())
        ok = errs["rotate"] <= LOAD_TOL["rotate"]
    else:
        got, want = fn(*a, **kw), plain(*a, **kw)
        frac = (a[3] if len(a) > 3 else kw.get("frac")) \
            if name == "unpack" else 0.125
        abs_err = float((got - want).abs().max())
        errs = {}
        if name == "unpack":
            errs["decode_bit_equal"] = bool(torch.equal(
                fn(*a[:3]), plain(*a[:3]))) if frac is not None \
                else bool(torch.equal(got, want))
        if frac is not None:
            spread = (want.amax(-1, keepdim=True) - want.amin(
                -1, keepdim=True)).clamp_min(1e-300)
            errs["baseline"] = float(((got - want).abs() / spread).max())
        ok = errs.get("decode_bit_equal", True) \
            and errs.get("baseline", 0.0) <= LOAD_TOL["baseline"]
    torch.cuda.synchronize()
    K.LAUNCHES.update(n0)
    return errs, abs_err, ok


def load_kernel_rows(K, dev, big):
    """K5, K6 and K7 against their plain versions at the shapes the load
    of ``big`` gives them: K5 on the whole stored column (the file's
    big-endian int16, packed by io.archive.stored_rows as the load packs
    it), with the baseline, alone on the decoded rows, and the decode
    alone (its library_ms: torch.addcmul of the native column, which the
    port never calls); K6 on one chunk of subints
    (io.archive.LOAD_CHUNK_BYTES), K7 on the whole cube's spectrum (the
    dedispersion and the pptoas guess).  Each row: errors (load_errors),
    device time (graph replay), the wrapper's time per call, the plain
    version's, the bound and the launches one call counts."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.io import archive as A
    from pulseportraiture_tpu_torch.io.psrfits import read_archive

    arch = read_archive(big)
    stored, scl, offs = arch.stored
    nbin = stored.shape[-1]
    rows = stored.size // nbin
    per_sub = arch.npol * arch.nchan
    nharm = nbin // 2 + 1
    chunk = per_sub * max(1, A.LOAD_CHUNK_BYTES // (per_sub * nharm * 16))
    shifts = np.broadcast_to(arch._dispersion_shifts()[:, None, :],
                             (arch.nsub, arch.npol, arch.nchan))
    raw = A.stored_rows(stored, dev).to(dev)
    scl = torch.from_numpy(scl.reshape(rows)).to(dev)
    offs = torch.from_numpy(offs.reshape(rows)).to(dev)
    native = K.stored_values(raw).to(torch.int16)
    sh = torch.as_tensor(shifts.reshape(-1).copy(), device=dev)
    x = K.unpack_plain(raw, scl, offs)
    base = K.baseline_plain(x)
    xc = base[:chunk].contiguous()
    X = torch.fft.rfft(xc, dim=-1)
    Xall = torch.fft.rfft(base, dim=-1)
    out, out_c = torch.empty_like(x), torch.empty_like(Xall)
    vecs = [torch.empty(chunk, dtype=torch.float64, device=dev)
            for _ in range(2)]
    # (kernel, mode, arguments, keywords, rows, one PyTorch call of the
    # same function or None)
    cases = [
        ("unpack", "decode+baseline", (raw, scl, offs, 0.125),
         dict(out=out), rows, None),
        ("baseline", "baseline", (x,), dict(out=out), rows, None),
        ("unpack", "decode", (raw, scl, offs), dict(out=out), rows,
         lambda: torch.addcmul(offs[:, None], native, scl[:, None])),
        ("load_stats", "noise+snr", (xc, X, vecs[0], vecs[1]), {}, chunk,
         None),
        ("rotate", "rotate", (Xall, sh), dict(out=out_c), rows, None)]
    result = {}
    for name, mode, a, kw, n, library in cases:
        fn, plain = getattr(K, name), getattr(K, name + "_plain")
        errs, abs_err, ok = load_errors(K, name, a, kw)
        n0 = K.LAUNCHES[name]
        fn(*a, **kw)
        launches = K.LAUNCHES[name] - n0
        torch.cuda.synchronize()
        bms, by = load_bound_ms("decode" if mode == "decode" else name, n,
                                nbin)
        row = dict(shape=[n, nharm if name == "rotate" else nbin],
                   mode=mode, errors=errs, tol=LOAD_TOL,
                   max_abs_err=abs_err, launches_per_call=launches,
                   ms=graph_ms(lambda: fn(*a, **kw)),
                   call_ms=cuda_ms(lambda: fn(*a, **kw)),
                   plain_ms=cuda_ms(lambda: plain(*a, **kw), reps=3, warm=1),
                   bound_ms=bms, bound_by=by,
                   library_ms=None if library is None else graph_ms(library))
        row["share_of_bound"] = bms / row["ms"]
        emit("kernels", kernel=name, **row)
        if not (ok and launches == 1):
            raise AssertionError("%s kernel disagrees at %s (or launched %d "
                                 "times): %s" % (name, [n, nbin], launches,
                                                 errs))
        result.setdefault(name, []).append(row)
    del x, base, Xall, out, out_c, X, cases, native
    torch.cuda.empty_cache()
    return result


# the load's flags on its main path: pptoas's (pipelines/toas.py _load),
# then ppalign's (the dedispersed, tscrunched average of an epoch)
PPTOAS_LOAD = dict(dedisperse=False, dededisperse=False, pscrunch=True,
                   rm_baseline=True, refresh_arch=False, return_arch=False,
                   quiet=True, keep_cube=True)
PPALIGN_LOAD = dict(state="Intensity", dedisperse=True, tscrunch=True,
                    pscrunch=True, rm_baseline=True, quiet=True)


def phase_load(root, work, K, dev, big, reps=3):
    """load_data on the card on the pptoas archive (nsub x nchan x nbin
    of PPTOAS_SHAPE): the main path's run (pptoas's load, then ppalign's
    flags; counts zeroed just before), its wall over ``reps`` runs, the
    seconds of each step (io.archive.LOAD_STEPS), the CPU's load and the
    card's with the plain versions of K5-K7 (each held to the kernels'
    LOAD_TOL); pptoas's TOAs from the card load against those from the
    plain load (1 ns, rc and nfeval equal); K5-K7's rows.  Returns
    (the main run's launches, the kernels' rows)."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.io.archive import load_data
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    def timed(**kw):
        t0 = time.perf_counter()
        d = load_data(big, **kw)
        if kw.get("device") != "cpu":
            torch.cuda.synchronize()
        return d, time.perf_counter() - t0

    timed(device=dev, **PPTOAS_LOAD)   # cuFFT plans, pinned buffers
    K.reset_launches()
    got, t_main = timed(device=dev, **PPTOAS_LOAD)
    aligned, t_align = timed(device=dev, **PPALIGN_LOAD)
    launches = dict(K.LAUNCHES)
    missing = [n for n in LOAD_NAMES if launches[n] == 0]
    if missing:
        raise AssertionError("kernels never launched on the load path: %s"
                             % missing)
    walls = [t_main] + [timed(device=dev, **PPTOAS_LOAD)[1]
                        for _ in range(reps - 1)]
    split = {}
    load_data(big, device=dev, split=split, **PPTOAS_LOAD)
    with plain_kernels(K, LOAD_NAMES):
        plain, t_plain = timed(device=dev, **PPTOAS_LOAD)
        plain_aligned, _ = timed(device=dev, **PPALIGN_LOAD)
    host_split = {}  # on the CPU a step's mark waits for nothing
    host, t_cpu = timed(device="cpu", split=host_split, **PPTOAS_LOAD)
    gaps = dict(pptoas=load_gaps(got, plain),
                ppalign=load_gaps(aligned, plain_aligned),
                cpu=load_gaps(got, host))
    bad = {k: v for k, v in list(gaps["pptoas"].items())
           + list(gaps["ppalign"].items())
           if k in LOAD_TOL and not v <= LOAD_TOL[k]}
    bad.update({k: False for k in ("pptoas", "ppalign")
                if not gaps[k]["masks_equal"]})

    gm = os.path.join(root, "examples", "example.gmodel")
    toas = []
    for bunch in (got, plain):
        if bunch.device_cube is None or not bunch.device_cube.is_cuda:
            raise AssertionError("the load left no cube on the card")
        gt = GetTOAs([big], gm, quiet=True, device=dev)
        gt.preload(big, ("data", bunch))
        if bunch is got:   # the fit of the card's bunch: its copies
            _, fit_profile = kernel_device_ms(
                lambda: gt.get_TOAs(bary=False, quiet=True), K, copies=True)
        else:
            gt.get_TOAs(bary=False, quiet=True)
        if bunch.device_cube is not None:
            raise AssertionError("GetTOAs left the cube on the bunch")
        toas.append(gt)
    copies = fit_profile["h2d"]
    nsub, npol, nchan, nbin = got.subints.shape
    if copies["largest_pageable_bytes"] >= nchan * nbin * 8:
        raise AssertionError("GetTOAs copied portraits from pageable memory "
                             "to the card: %s" % copies)
    dt_ns = max_dt_ns_list(toas[0].TOA_list, toas[1].TOA_list)
    same_rc = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                  zip(toas[0].rcs, toas[1].rcs))
    same_nfev = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b
                    in zip(toas[0].nfevals, toas[1].nfevals))
    rows = load_kernel_rows(K, dev, big)
    emit("load", archive=list(got.subints.shape), launches=launches,
         wall_s=walls, wall_median_s=float(np.median(walls)),
         align_flags_s=t_align, split_s=split, cpu_s=t_cpu,
         cpu_split_s=host_split, plain_s=t_plain, gaps=gaps, tol=LOAD_TOL,
         toas_card_vs_plain_load_ns=dt_ns, rc_equal=same_rc,
         nfeval_equal=same_nfev, n_toas=len(toas[0].TOA_list),
         fit_h2d=copies, fit_wall_s=fit_profile["wall_s"],
         fit_peak_bytes=fit_profile["peak_bytes"])
    if bad:
        raise AssertionError("the card's load disagrees with the plain "
                             "versions: %s" % bad)
    if not (dt_ns < 1.0 and same_rc and same_nfev):
        raise AssertionError("TOAs from the card load differ from the plain "
                             "load's: %.3g ns, rc equal %s, nfeval equal %s"
                             % (dt_ns, same_rc, same_nfev))
    return launches, rows


def phase_pptoas_scat(root, work, K, big, small, shape=PPTOAS_SHAPE,
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
                                    + ["-o", os.path.join(work, "s_big.tim")])
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
    missing = [n for n in SCAT_KERNELS if launches[n] == 0]
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
    missing = [n for n in PHASE_DM_KERNELS if dt4_launches[n] == 0]
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
    torch.profiler, whose runs go to clock["prof"] (and the hand kernels'
    launches in each to clock["prof_launches"]); the arguments of the
    first call of each function in ``keep_args`` go to
    clock[name + "_args"], the results of those in ``keep_out`` to
    clock[name + "_out"]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pulseportraiture_tpu_torch import _kernels as K

    clock = dict(self=[], prof=[], prof_launches=[],
                 **{n: [] for n in names})
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
            n0 = dict(K.LAUNCHES)
            with ctx as prof:
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                clock[name].append(time.perf_counter() - t0)
            if prof is not None:
                clock["prof"].append(prof)
                clock["prof_launches"].append(
                    {k: K.LAUNCHES[k] - n0[k] for k in n0})
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


def phase_narrowband(root, work, K, big, small, shape=PPTOAS_SHAPE,
                     subset=16):
    """pptoas --narrowband --print_phase --print_flux on the pptoas
    archive: one TOA per live (subint, channel), the injected phase
    dispersed to each channel recovered (max |z| < 6 over ~65k draws,
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
    busy = device_busy(rows, clock["prof_launches"][0], K)

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
         method_s=clock["get_narrowband_TOAs"][0], profiled=True, **busy,
         device_idle_share=None if busy["device_busy_s"] is None
         else 1.0 - busy["device_busy_s"] / t_cli,
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


def phase_narrowband_scat(root, work, K, small, shape=PPTOAS_SHAPE,
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
    k3 = kernel_times(pclock["prof"][0], K)
    k3, k3b = k3.get("moments_scat"), k3.get("moments_scat_grad_hess")
    dt_ns = max_dt_ns(kern, plain)
    gap = flag_gap(kern, plain, "log10_scat_time")
    rcs = gt.rcs[0][np.asarray(gt.TOA_errs[0] != 0)]
    codes = sorted(int(c) for c in np.unique(rcs))
    bad = [c for c in codes if str(c) not in RCSTRINGS]
    missing = [n for n in SCAT_KERNELS if launches[n] == 0]
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
         fit_device_busy=device_busy(rows, pclock["prof_launches"][0], K),
         k3_device_ms_total=k3[1] if k3 else None,
         k3_launches_profiled=k3[0] if k3 else 0,
         k3_grad_hess_device_ms_total=k3b[1] if k3b else None,
         k3_grad_hess_launches_profiled=k3b[0] if k3b else 0,
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


def phase_templates(root, work, K, small, shape=PPTOAS_SHAPE,
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
        missing = [n for n in PHASE_DM_KERNELS if launches[n] == 0]
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


def phase_ppzap(root, work, K, small, shape=PPTOAS_SHAPE, subset=16):
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
    missing = [n for n in PHASE_DM_KERNELS if launches[n] == 0]
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



# -- the plotting layer's numbers (viz, viz.figdata) -----------------------

def viz_path(small, gm, device):
    """The numbers of the port's figures, once on ``device``: GetTOAs
    with show_plot=True (which draws nothing), then show_fit's numbers
    for every fitted subint (figdata.fitted_subint: the rotated port and
    scaled model, return_fit kept on the device; residual_payload: each
    live channel's reduced chi2 in one reduction), show_stacked_profiles
    (fit=True)'s FFTFIT over subint 0's fitted channels (one K2 launch)
    and ppzap --hist's (get_channels_to_zap, figdata.zap_hist).  No
    matplotlib: the card's machine has none.  Returns host results and
    the figure numbers' wall and CUDA-event milliseconds."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch import viz  # noqa: F401 (no matplotlib)
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
    from pulseportraiture_tpu_torch.viz import figdata

    gt = GetTOAs(small, gm, quiet=True, device=device)
    gt.get_TOAs(bary=False, show_plot=True, quiet=True)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
    t0 = time.perf_counter()
    rchi2, live = [], 0
    for isub in gt.ok_isubs[0]:
        f = figdata.fitted_subint(gt, 0, isub)
        pay = figdata.residual_payload(f.port, f.model, f.noise_stds,
                                       gt.nfit)
        rchi2.append(pay.rchi2.cpu().numpy())
        live += int(pay.live.sum())
        if len(rchi2) == 1:     # the archive is read again for the first
            t_first = time.perf_counter() - t0
    f = figdata.fitted_subint(gt, 0, 0)
    ok = list(f.ok_ichans)
    fits = figdata.stacked_fits(f.port[ok], f.model[ok])
    phase = fits.phase.cpu().numpy()
    gt.get_channels_to_zap()
    hist, nzap = figdata.zap_hist(gt.channel_red_chi2s, 1.3)
    ms = None
    if cuda:
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1])
    return dict(gt=gt, rchi2=np.concatenate(rchi2), n_live=live,
                n_fitted=int(fits.fitted.sum()), nchan_stacked=len(ok),
                phase=phase, hist=hist, nzap=nzap,
                figdata_s=time.perf_counter() - t0, first_subint_s=t_first,
                figdata_event_ms=ms)


def phase_viz(root, work, K, small, shape=PPTOAS_SHAPE, subset=16):
    """The plotting layer's device numbers on the 16-subint archive (see
    ``viz_path``), every count set to 0 just before it: K1 and K2
    launched, the subints' channel reduced chi2s finite; the reduction
    on the card against the CPU on the same fitted subints (1e-12
    relative); the path against the same path through the plain
    versions (TOAs within 1 ns, reduced chi2 2e-9 relative, stacked-fit
    phases 1e-9 rot, the --hist counts equal) and against the port on
    the CPU (TOAs 1 ns, reduced chi2 2e-9 relative); K1 (its first call)
    and K2 (each shape) against their plain versions on the inputs the
    path gave them, timed with their bounds.  Returns the launches.

    A channel's reduced chi2 moves to first order with the fitted phase,
    DM and scales, which two converged fits leave ~1e-11 apart: it is
    held to 2e-9 between runs, as tests/test_torch_cuda_paths.py holds
    the post-fit channel reduced chi2s (1e-10 does not hold: 2.1e-10
    against the plain versions, 6.7e-10 against the CPU on the H100)."""
    import numpy as np

    from pulseportraiture_tpu_torch.viz import figdata

    gm = os.path.join(root, "examples", "example.gmodel")
    t_phase = t0 = time.perf_counter()
    with first_kernel_inputs(K, names=K1_NAMES) as k1, \
            first_kernel_inputs(K, names=("fftfit", "spectra"),
                                per_shape=True) as k2:
        K.reset_launches()
        run = viz_path(small, gm, "cuda")
        launches = dict(K.LAUNCHES)
    wall = time.perf_counter() - t0
    # K1 on its first call's inputs, as on the pptoas and ppzap paths: the
    # one-live-channel subint's first evaluation is at its FFTFIT optimum,
    # where its gradient sum cancels to ~1e-9 of its terms, so a bound
    # relative to that sum reads float64 rounding as error (1e-3 of it,
    # 1.1e-12 absolute, on the H100); K2 and K4 at every shape
    seen = dict(k2)
    for name in K1_NAMES:
        seen[name, tuple(k1[name][0][0].shape)] = k1[name]
    path_rows = path_kernels_vs_plain(K, seen)
    times = path_kernel_times(K, seen)
    del seen
    same = 0.0          # the reduction alone: card and CPU, same inputs
    for isub in run["gt"].ok_isubs[0]:
        f = figdata.fitted_subint(run["gt"], 0, isub)
        got = figdata.residual_payload(f.port, f.model, f.noise_stds,
                                       run["gt"].nfit).rchi2.cpu()
        want = figdata.residual_payload(f.port.cpu(), f.model.cpu(),
                                        f.noise_stds.cpu(),
                                        run["gt"].nfit).rchi2
        same = max(same, float(((got - want) / want).abs().max()))
    del f
    with plain_kernels(K):
        plain = viz_path(small, gm, "cuda")
    t_cpu = time.perf_counter()
    cpu = viz_path(small, gm, "cpu")
    t_cpu = time.perf_counter() - t_cpu

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))

    res = dict(
        archive=[subset] + list(shape[1:]), wall_s=wall,
        figdata_s=run["figdata_s"], first_subint_s=run["first_subint_s"],
        figdata_event_ms=run["figdata_event_ms"],
        same_inputs_rchi2_max_rel=same,
        cpu_wall_s=t_cpu, launches=launches, n_toas=len(run["gt"].TOA_list),
        n_live_channels=run["n_live"], nchan_stacked=run["nchan_stacked"],
        n_stacked_fitted=run["n_fitted"], nzap_hist=run["nzap"],
        rchi2_mean=float(run["rchi2"].mean()),
        plain_max_dt_ns=max_dt_ns_list(run["gt"].TOA_list,
                                       plain["gt"].TOA_list),
        plain_rchi2_max_rel=rel(run["rchi2"], plain["rchi2"]),
        plain_phase_max_abs=float(np.abs(run["phase"]
                                         - plain["phase"]).max()),
        plain_hist_max_rel=rel(run["hist"], plain["hist"]),
        cpu_rchi2_max_rel=rel(run["rchi2"], cpu["rchi2"]),
        cpu_max_dt_ns=max_dt_ns_list(run["gt"].TOA_list,
                                     cpu["gt"].TOA_list),
        path_kernels_vs_plain=path_rows, path_kernel_times=times,
        phase_s=time.perf_counter() - t_phase)
    emit("viz", **res)
    missing = [n for n in PHASE_DM_KERNELS if launches[n] == 0]
    ok = (not missing and np.isfinite(run["rchi2"]).all()
          and run["n_fitted"] == run["nchan_stacked"] > 0
          and len(run["rchi2"]) == run["n_live"] > 0
          and same <= 1e-12
          and res["plain_max_dt_ns"] < 1.0
          and res["plain_rchi2_max_rel"] <= 2e-9
          and res["plain_phase_max_abs"] <= 1e-9
          and res["plain_hist_max_rel"] <= 2e-9
          and run["nzap"] == plain["nzap"]
          and res["cpu_max_dt_ns"] < 1.0
          and res["cpu_rchi2_max_rel"] <= 2e-9)
    if not ok:
        raise AssertionError("the viz path's numbers disagree or a kernel "
                             "never launched (the viz line above; missing "
                             "%s)" % missing)
    return launches


# -- the template-building paths: ppalign, ppspline, ppgauss --------------

ALIGN_ARCHIVES = 8          # epochs aligned; 16 subints each: 128 rows


@contextlib.contextmanager
def first_kernel_inputs(K, names=PHASE_DM_KERNELS, per_shape=False):
    """Copies of the tensor arguments of the first call of each kernel in
    ``names`` in the block (the shapes the path gives them): key -> (args,
    kwargs).  The key is the kernel's name, or with ``per_shape`` the pair
    (name, shape): the first argument's shape, and K2's grid size, so each
    shape a path gives a kernel is kept once."""
    import torch

    seen = {}
    saved = {name: getattr(K, name) for name in names}

    def copy(x):
        # a broadcast dimension (stride 0, as K9's per-channel errs) stays
        # broadcast: a copy of one slice, expanded
        flat = tuple(slice(0, 1) if x.stride(d) == 0 else slice(None)
                     for d in range(x.ndim))
        return x[flat].clone().expand(x.shape)

    def keep(name, fn):
        def call(*a, **kw):
            key = name
            if per_shape:
                key = (name, tuple(a[0].shape) + (
                    (a[4],) if name == "fftfit" else ()))
            if key not in seen:
                seen[key] = (tuple(copy(x) if isinstance(
                    x, torch.Tensor) else x for x in a), dict(kw))
            return fn(*a, **kw)
        return call

    for name in names:
        setattr(K, name, keep(name, saved[name]))
    try:
        yield seen
    finally:
        for name in names:
            setattr(K, name, saved[name])


def path_kernels_vs_plain(K, seen, required=PHASE_DM_KERNELS):
    """Each kernel on the inputs a path gave it (``first_kernel_inputs``),
    against its plain version (not counted): {key: dict(shape,
    max_rel_err, max_abs_err)}, the key the kernel's name or
    "name@shape".  Raises when a ``required`` kernel was never called, or
    beyond 1e-12 of each sum's largest magnitude (K2's phase: 1e-9
    rot; K1's and K3's f, g and H terms: K1_GH_TOL, K3_GH_TOL; K5-K7 at
    LOAD_TOL, load_errors; K9's and K10's f, g and J^T J at K9_TOL and
    K10_TOL, k9_errors)."""
    import torch

    plains = {name: getattr(K, name + "_plain") for name in K.KERNELS}
    called = {key if isinstance(key, str) else key[0] for key in seen}
    missing = [name for name in required if name not in called]
    if missing:
        raise AssertionError("%s never called on this path" % missing)
    rows = {}
    for key, (a, kw) in seen.items():
        name = key if isinstance(key, str) else key[0]
        shape = list(a[0].shape)
        row_key = name if isinstance(key, str) else "%s@%s" % (
            name, "x".join(map(str, shape)))
        if name in LOAD_NAMES:
            errs, abs_err, ok = load_errors(K, name, a, kw)
            rows[row_key] = dict(shape=shape, max_rel_err=max(
                [v for v in errs.values() if not isinstance(v, bool)],
                default=0.0), max_abs_err=abs_err, errors=errs)
            if not ok:
                raise AssertionError("%s disagrees with its plain version "
                                     "on the path's inputs: %s"
                                     % (name, rows[row_key]))
            continue
        n0 = K.LAUNCHES[name]
        if name in K4_NAMES:                # outputs written into its args
            got = k4_call(getattr(K, name), a, kw)
            want = k4_call(plains[name], a, kw)
        else:
            got = getattr(K, name)(*a, **kw)
            want = plains[name](*a, **kw)
        K.LAUNCHES[name] = n0               # a comparison launch: not counted
        torch.cuda.synchronize()
        if name in K4_NAMES:
            err, abs_err, ok = k4_errors(
                K, k4_arguments(getattr(K, name), a, kw), got, want)
        elif name == "fftfit":
            ph = float((got[0] - want[0]).abs().max())
            err = max(rel_err(got[1], want[1]), rel_err(got[2], want[2]))
            abs_err = max(ph, float((got[1] - want[1]).abs().max()))
            ok = ph <= 1e-9 and err <= 1e-12
            shape.append(a[4])                      # [N, nharm] and Ns
        elif name in ("moments_grad_hess", "moments_scat_grad_hess"):
            err = max(rel_err(got[:, i], want[:, i])
                      for i in range(got.shape[1]))
            abs_err = float((got - want).abs().max())
            ok = err <= (K1_GH_TOL if name == "moments_grad_hess"
                         else K3_GH_TOL)
        elif name == "smooth_search":
            abs_err, err, mismatches = smooth_errors(got, want)
            ok = mismatches == 0 and err <= SMOOTH_TOL
        elif name in K9_NAMES + K10_NAMES:
            errs, abs_err, same_nan = k9_errors(got, want)
            err = max(errs.values())
            ok = err <= (K9_TOL if name in K9_NAMES else K10_TOL) \
                and same_nan
            shape = [a[0].shape[0]] + list(a[1].shape)   # lanes, data
        else:
            err = max(rel_err(got[..., i], want[..., i])
                      for i in range(got.shape[-1]))
            abs_err, ok = float((got - want).abs().max()), err <= 1e-12
        row_key = name if isinstance(key, str) else "%s@%s" % (
            name, "x".join(map(str, shape)))
        rows[row_key] = dict(shape=shape, max_rel_err=err,
                             max_abs_err=abs_err)
        if name == "smooth_search":
            rows[row_key]["choice_mismatches"] = mismatches
        if not ok:
            raise AssertionError("%s disagrees with its plain version on "
                                 "the path's inputs: %s" % (name, rows[row_key]))
    return rows


def smooth_errors(got, want):
    """K8's (out, choice) against its plain version's: (largest |out
    gap|, largest gap over its row's peak, rows whose (level, factor)
    differ)."""
    (out, choice), (pout, pchoice) = got, want
    if not out.numel():
        return 0.0, 0.0, 0
    peak = pout.abs().max(dim=-1).values.clamp(min=1e-300)
    gap = (out - pout).abs().max(dim=-1).values
    return (float(gap.max()), float((gap / peak).max()),
            int((choice != pchoice).any(dim=-1).sum()))


def smooth_bound_ms(rows, nbin, nlevel, nfact):
    """K8's least time: each candidate's thresholded arrays' real forward
    transform (2.5 nbin log2 nbin FP64 operations) and K8_OPS per
    half-spectrum bin to form and read its spectrum, for rows x nlevel x
    nfact candidates, against the FP64 peak; the rows read and the result
    written once."""
    ops = rows * nlevel * nfact * (2.5 * nbin * math.log2(nbin)
                                   + K8_OPS * (nbin // 2 + 1))
    return bound_ms(2 * rows * nbin * 8, (ops, PEAK_FP64_PER_S))


def smooth_grid_bound_ms(rows, nbin, nlevel, nfact):
    """The least time of the torch grid K8 replaced, by that grid's own
    transforms: per level l, l + 3 complex FFTs and a real one of nfact x
    rows profiles, 5 nbin log2 nbin FP64 operations each."""
    ffts = sum(lev + 4 for lev in range(1, nlevel + 1)) * nfact * rows
    return bound_ms(2 * rows * nbin * 8,
                    (ffts * 5 * nbin * math.log2(nbin), PEAK_FP64_PER_S))


def smooth_scan_errors(K, a):
    """K8's scan kernel (smooth_scan) against its plain version on the
    inputs ``a`` of a smooth_search call, and the certification's premise
    there: (largest relative gap of the S/N and chi2 over the candidates
    with both positive and finite, the repeat flags equal, {the largest
    gap between the scan kernel's value and the route's (cuFFT's round
    trips, the plain stages on the card) over its bound: noise over En,
    the square root of the signal power over G, of the chi2 over delta
    (_kernels._cert_bounds_plain)}, the rows whose cuFFT transforms fail
    the certification's check)."""
    import torch

    from pulseportraiture_tpu_torch.ops.wavelet import (scan_twiddles,
                                                        search_maxima,
                                                        search_tables)

    port, wavelet, nlevel, facts, _, mode = a[:6]
    r, nbin = port.shape
    st, same = K.smooth_scan(port, wavelet, nlevel, facts, mode)
    sp, samep = K.smooth_scan_plain(port, wavelet, nlevel, facts, mode)
    ok = torch.isfinite(sp[..., :2]).all(-1) & (sp[..., :2] > 0).all(-1)
    rel = ((st[..., :2] - sp[..., :2]).abs() / sp[..., :2].abs().clamp(
        min=1e-300))[ok]
    nh = nbin // 2 + 1
    kc = K.noise_kc(nh)
    tables = search_tables(wavelet, nbin, nlevel, port.device)
    t = torch.empty((r, nlevel, facts.shape[0], nbin), dtype=torch.float64,
                    device=port.device)
    d = torch.empty((r, nlevel, facts.shape[0], nh), dtype=torch.complex128,
                    device=port.device)
    _, _, chi2, _ = K._route_candidates_plain(port, tables, facts,
                                              mode == "soft", t, d)
    pw = K._power(d)
    noise = torch.sqrt(pw[..., kc:].sum(-1) / nbin / (nh - kc))
    sig = pw[..., 1:].sum(-1)
    del t, d, pw
    X, cD, errs, _ = K._setup_plain(port, tables[0], facts)
    G, En, delta, bad = K._cert_bounds_plain(
        port, X, cD, errs, st, tables[0][0],
        search_maxima(wavelet, nbin, nlevel, port.device),
        scan_twiddles(nbin, port.device))

    def over(gap, bound):
        return float(torch.where(bound > 0.0, gap / bound, gap * math.inf
                                 ).nan_to_num(0.0).max())

    gaps = dict(noise=over((st[..., 2] - noise).abs(), En),
                sqrt_sig=over((st[..., 3].sqrt() - sig.sqrt()).abs(), G),
                sqrt_chi2=over((st[..., 1].sqrt() - chi2.sqrt()).abs(),
                               delta))
    torch.cuda.synchronize()
    return (float(rel.max()) if rel.numel() else 0.0,
            bool(torch.equal(same, samep)), gaps, int(bad.sum()))


def smooth_rows(K, seen, vs_plain, path):
    """K8 at each shape a path gave it (``seen``, from first_kernel_inputs
    per shape) with its errors against plain (``vs_plain``): its rows by
    tier (certified by the scan, redecided by the route, unscanned), its
    device ms by CUDA-graph replay (``ms``: the set-up, the scan and the
    certification, plus the route over this input's uncertain rows,
    gathered with their set-up; each part alone, ``scan_certify_ms`` and
    ``route_ms``, and the set-up and scan alone, ``scan_ms``), the
    wrapper's ms per call (CUDA events over calls back to back,
    ``call_ms``: a call syncs the host once, for its uncertain rows'
    count; ``call_synced_ms`` with each call's result awaited, as its
    callers read it), the route alone over every row (the design before
    the scan, on the same input in the same process: ``route_all_ms`` by
    graph replay, ``route_all_call_ms`` and ``route_all_call_synced_ms``
    by CUDA events), the plain version's (CUDA events: it syncs the host), the
    bound, the torch grid's bound, one call's device profile
    (kernel_device_ms: its longest device rows), the scan kernel against
    smooth_scan_plain and the certification's premise
    (smooth_scan_errors).  Timing launches are not counted."""
    import torch

    from pulseportraiture_tpu_torch.ops.wavelet import (search_maxima,
                                                        search_tables)

    rows = []
    for key, (a, kw) in sorted(seen.items(), key=lambda kv: kv[0][1]):
        if key[0] != "smooth_search":
            continue
        port, wavelet, nlevel, facts, tol, mode = a[:6]
        r, nbin = port.shape
        nfact = facts.shape[0]
        soft = mode == "soft"
        n0 = K.LAUNCHES["smooth_search"]
        tiers0 = dict(K.SMOOTH_ROWS)
        scanned = K.scannable(nbin)
        reps = 5 if r > 64 else 20
        tables = search_tables(wavelet, nbin, nlevel, port.device)

        def new_out(n):
            return (torch.empty((n, nbin), dtype=torch.float64,
                                device=port.device),
                    torch.empty((n, 2), dtype=torch.int64,
                                device=port.device))

        call_ms = cuda_ms(lambda: K.smooth_search(*a, **kw), reps=reps,
                          warm=1)
        # as its callers make it: each call's result read before the next
        call_synced_ms = cuda_ms(lambda: (K.smooth_search(*a, **kw),
                                          torch.cuda.synchronize()),
                                 reps=reps, warm=1)
        o, c = new_out(r)
        route_all_ms = graph_ms(lambda: K._route(
            port, tables, facts, tol, soft, o, c, card=True), reps=reps)
        route_all_call_ms = cuda_ms(lambda: K._route(
            port, tables, facts, tol, soft, *new_out(r), card=True),
            reps=reps, warm=1)
        route_all_call_synced_ms = cuda_ms(lambda: (K._route(
            port, tables, facts, tol, soft, *new_out(r), card=True),
            torch.cuda.synchronize()), reps=reps, warm=1)
        if scanned:
            # the first two tiers, then the route over the uncertain rows,
            # gathered as smooth_search gathers them
            maxima = search_maxima(wavelet, nbin, nlevel, port.device)
            flags, setup = K._scan_certify(port, tables, maxima, facts, tol,
                                           soft, o, c)
            unc = torch.nonzero(flags)[:, 0]
            tiers = dict(certified=r - len(unc), redecided=len(unc),
                         unscanned=0)
            scan_ms = graph_ms(lambda: K.smooth_scan(
                port, wavelet, nlevel, facts, mode), reps=reps)
            scan_certify_ms = graph_ms(lambda: K._scan_certify(
                port, tables, maxima, facts, tol, soft, o, c), reps=reps)
            xu = port.index_select(0, unc)
            su = None if setup is None else tuple(
                t.index_select(0, unc) for t in setup)
            ou, cu = new_out(len(unc))
            route_ms = graph_ms(lambda: K._route(
                xu, tables, facts, tol, soft, ou, cu, card=True, setup=su),
                reps=reps) if len(unc) else 0.0
            device_ms = scan_certify_ms + route_ms
        else:
            tiers = dict(certified=0, redecided=0, unscanned=r)
            scan_ms = scan_certify_ms = None
            # every row through the route: no host sync
            route_ms = device_ms = graph_ms(
                lambda: K.smooth_search(*a, **kw), reps=reps)
        plain_ms = cuda_ms(lambda: K.smooth_search_plain(*a, **kw), reps=2,
                           warm=1)
        # where a call's device time goes: the set-up, the scan and its
        # certification, the route's kernels and cuFFT
        _, prof = kernel_device_ms(lambda: K.smooth_search(*a, **kw), K)
        scan_rel, same_eq, gaps, check_failed = smooth_scan_errors(K, a) \
            if scanned else (None, None, None, None)
        K.LAUNCHES["smooth_search"] = n0
        K.SMOOTH_ROWS.update(tiers0)
        bms, by = smooth_bound_ms(r, nbin, nlevel, nfact)
        err = vs_plain["smooth_search@%dx%d" % (r, nbin)]
        rows.append(dict(
            path=path, shape=[r, nbin], nlevels=nlevel, nfact=nfact,
            ms=device_ms, call_ms=call_ms, call_synced_ms=call_synced_ms,
            scan_ms=scan_ms, scan_certify_ms=scan_certify_ms,
            route_ms=route_ms, route_all_ms=route_all_ms,
            route_all_call_ms=route_all_call_ms,
            route_all_call_synced_ms=route_all_call_synced_ms,
            rows=tiers, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            share_of_bound=bms / device_ms,
            grid_bound_ms=smooth_grid_bound_ms(r, nbin, nlevel, nfact)[0],
            library_ms=None, max_abs_err=err["max_abs_err"],
            max_rel_err=err["max_rel_err"],
            choice_mismatches=err["choice_mismatches"],
            scan_vs_plain_max_rel_err=scan_rel, scan_same_equal=same_eq,
            gap_over_bound=gaps, rows_failing_fft_check=check_failed,
            profile=prof))
        if scanned and not (scan_rel <= 1e-12 and same_eq
                            and max(gaps.values()) <= 1.0):
            raise AssertionError("K8's scan on %s %s: %s" % (
                path, [r, nbin], rows[-1]))
    return rows


def smooth_width_check(K, port, nbin=2000):
    """K8 on rows of a width its scan does not take (the path's first 16
    rows cut to ``nbin`` bins): every row through the route, counted as
    unscanned, and the same (level, factor) as plain.  Returns the
    check's numbers."""
    import torch

    rows = port[:16, :nbin].contiguous()
    facts = torch.linspace(0.0, 3.0, 30, dtype=torch.float64,
                           device=rows.device)
    n0 = K.LAUNCHES["smooth_search"]
    tiers0 = dict(K.SMOOTH_ROWS)
    got, choice = K.smooth_search(rows, "db8", 1, facts, 0.1)
    want, wchoice = K.smooth_search_plain(rows, "db8", 1, facts, 0.1)
    torch.cuda.synchronize()
    out = dict(shape=list(rows.shape), launches=K.LAUNCHES["smooth_search"]
               - n0, rows={t: K.SMOOTH_ROWS[t] - tiers0[t] for t in tiers0},
               choice_mismatches=int((choice != wchoice).any(-1).sum()),
               max_rel_err=float(((got - want).abs().amax(-1) / want.abs(
               ).amax(-1).clamp(min=1e-300)).max()))
    K.LAUNCHES["smooth_search"] = n0
    K.SMOOTH_ROWS.update(tiers0)
    if out["rows"]["unscanned"] != rows.shape[0] or out["launches"] < 1 \
            or out["choice_mismatches"] or not out["max_rel_err"] <= \
            SMOOTH_TOL:
        raise AssertionError("K8 at a width the scan does not take: %s"
                             % out)
    return out


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
    missing = [n for n in PHASE_DM_KERNELS if launches[n] == 0]
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
    missing = [n for n in PHASE_DM_KERNELS if launches[n] == 0]
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
    """The port's ppspline -s on the aligned archive: K2 and K8 launched,
    K8 held against its plain version on the inputs the path gave it (the
    ten candidate eigenprofiles [10, 2048] and the mean profile [1, 2048])
    and timed there; B9's eigh at the path's shape; pptoas with the .spl
    on the 16-subint archive (5 sigma, 1 ns).  Returns the launches of the
    ppspline and pptoas runs, summed, and K8's rows."""
    import torch

    from pulseportraiture_tpu_torch.cli import ppspline
    from pulseportraiture_tpu_torch.dataportrait import DataPortrait
    from pulseportraiture_tpu_torch.io.splmodel import read_spline_model

    spl = os.path.join(work, "aligned.spl")
    with first_kernel_inputs(K, SMOOTH_KERNELS, per_shape=True) as seen:
        wall, launches = run_tool(K, ppspline, [
            "-d", avg, "-o", spl, "-s", "--quiet", "--device", str(dev)])
    SMOOTH_TIERS["ppspline"] = tiers = dict(K.SMOOTH_ROWS)
    if launches["fftfit"] == 0 or launches["smooth_search"] == 0 or \
            tiers["scanned"] == 0:
        raise AssertionError("ppspline -N prof -s launched %s, K8's rows %s"
                             % (launches, tiers))
    ncomp = read_spline_model(spl)[4].shape[1]
    vs_plain = path_kernels_vs_plain(K, seen, SMOOTH_KERNELS)
    k8 = smooth_rows(K, seen, vs_plain, "ppspline")
    del seen

    # B9 at this path's shape: the eigensolve of the [nbin, nbin]
    # covariance
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
    del dp, port, d, cov

    toas = time_with_template(K, dev, work, small, spl, "spline_built")
    total = {name: launches[name] + toas["launches"][name]
             for name in launches}
    emit("ppspline", cli_s=wall, launches=launches, n_eigenprofiles=ncomp,
         kernels_vs_plain=vs_plain, k8=k8, k8_rows=tiers,
         b9_eigh=dict(shape=[n, n], ms=eigh_ms, bound_ms=eigh_bound,
                      bound_by=eigh_by),
         pptoas=toas)
    return total, k8


def phase_ppalign_smooth(root, work, K, dev, avg):
    """The port's ppalign -s (psrsmooth -W) on the ppalign phase's aligned
    archive (one epoch, aligned to itself, --niter 1, then every profile
    of the output smoothed): CLI wall, K8 launched (its plain version
    made to raise meanwhile), held against its plain version on the
    [nchan, nbin] rows it was given and timed there; the .sm archive
    against psrsmooth_archive with the plain versions swapped in (each
    row within one count of its int16 encoding).  Returns the run's
    launches and K8's rows."""
    import numpy as np

    from pulseportraiture_tpu_torch.cli import ppalign
    from pulseportraiture_tpu_torch.io.psrfits import read_archive
    from pulseportraiture_tpu_torch.pipelines.align import psrsmooth_archive

    meta = os.path.join(work, "aligned.meta")
    with open(meta, "w") as f:
        f.write(avg + "\n")
    out = os.path.join(work, "realigned.fits")

    def refuse(*a, **k):
        raise AssertionError("K8 fell back to its plain version")

    plain = K.smooth_search_plain
    K.smooth_search_plain = refuse
    try:
        with first_kernel_inputs(K, SMOOTH_KERNELS, per_shape=True) as seen:
            wall, launches = run_tool(K, ppalign, [
                "-M", meta, "-I", avg, "-o", out, "--niter", "1", "-s",
                "--device", str(dev)])
        SMOOTH_TIERS["ppalign_s"] = tiers = dict(K.SMOOTH_ROWS)
    finally:
        K.smooth_search_plain = plain
    missing = [n for n in PHASE_DM_KERNELS + SMOOTH_KERNELS
               if launches[n] == 0]
    if missing or tiers["scanned"] == 0:
        raise AssertionError("kernels never launched on ppalign -s: %s; "
                             "K8's rows %s" % (missing, tiers))
    vs_plain = path_kernels_vs_plain(K, seen, SMOOTH_KERNELS)
    k8 = smooth_rows(K, seen, vs_plain, "ppalign_s")
    widths = smooth_width_check(K, max(
        (a[0] for key, (a, _) in seen.items() if key[0] == "smooth_search"),
        key=lambda t: t.shape[0]))
    del seen

    with plain_kernels(K):
        psm = psrsmooth_archive(out, outfile=out + ".plain.sm", device=dev)
    got, want, raw = (read_archive(path) for path in (out + ".sm", psm, out))
    scl = want.encoded[1]
    counts = np.abs(got.data - want.data) / scl[..., None]
    smoothed = np.any(got.data != raw.data, axis=-1)
    emit("ppalign_s", archive=list(got.data.shape), cli_s=wall,
         launches=launches, kernels_vs_plain=vs_plain, k8=k8, k8_rows=tiers,
         k8_unscanned_width=widths,
         rows_smoothed=int(smoothed.sum()), rows=int(smoothed.size),
         sm_vs_plain=dict(max_counts=float(counts.max()),
                          rows_differing=int(np.any(counts > 0,
                                                    axis=-1).sum())))
    if got.data.shape != raw.data.shape or not counts.max() <= 1.01:
        raise AssertionError("ppalign -s: the .sm archive against the plain "
                             "versions' differs by %.3g counts"
                             % counts.max())
    return launches, k8


def jacobian_bound_ms(N, npar, nbin, ngauss):
    """A Gaussian portrait's Jacobian pass's least time: data and errs
    read, J written; per tangent the components over the portrait (~30
    operations per bin and component) and the scattered branch's rFFT and
    irFFT (2.5 N log2 nbin each; gen_gaussian_portrait computes that
    branch whatever tau)."""
    flops = npar * (30 * ngauss * N + 5 * N * math.log2(nbin))
    return bound_ms(2 * N * 8 + N * npar * 8, (flops, PEAK_FP64_PER_S))


def jacobian_pass(dp, dev, joins=(), x=None):
    """The torch route K9 replaces (the jacfwd route fit.lm takes for a
    fit K9 does not take), at a Gaussian portrait fit's solution: the
    portrait of ``dp`` (a GaussianModelPortrait) and x [nparam] where
    given, else its parameters and scattering index; jacfwd_pass_ms of
    its residual and its bound: (ms of the Jacobian, of the Jacobian
    with its einsums, bound ms, bound_by, shape [N, nparam])."""
    import numpy as np
    import torch

    data = torch.as_tensor(dp.portx, device=dev)
    if x is None:
        x = np.concatenate([dp.model_params, [dp.scattering_index]])
    x = torch.as_tensor(x, device=dev)
    residual = portrait_residual(
        dp.model_code, data, torch.as_tensor(dp.portx_noise, device=dev),
        torch.as_tensor(dp.phases, device=dev),
        torch.as_tensor(dp.freqsxs[0], device=dev), dp.nu_ref, joins,
        dp.Ps[0] if len(joins) else None)
    ms, route_ms = jacfwd_pass_ms(residual, x[None])
    N, npar = data.numel(), x.numel()
    bms, by = jacobian_bound_ms(N, npar, data.shape[1],
                                (len(dp.model_params) - 2) // 6)
    return ms, route_ms, bms, by, [N, npar]


def phase_ppgauss(root, work, K, dev, avg, small):
    """The port's ppgauss --autogauss 0.05 --niter 2 on the aligned
    archive: components, LM nfev and rc, wall, its portrait fits through
    K9 (both epilogues launched, the jacfwd route not taken: fit.gauss's
    FIT_ROUTES), K9 held against its plain version on the first inputs
    the path gave each epilogue and timed there; the torch route K9
    replaces (jacobian_pass) at the solution; a run with the plain
    versions (parameters within 1e-6 of their errors); pptoas with the
    .gmodel on the 16-subint archive (1 ns against plain; the injection
    within 5 sigma, referred to the initial template's phase zero and DM
    reference).  Returns the launches of the ppgauss and pptoas runs,
    summed."""
    import numpy as np

    from pulseportraiture_tpu_torch.cli import ppgauss
    from pulseportraiture_tpu_torch.fit import gauss as fit_gauss
    from pulseportraiture_tpu_torch.io.gmodel import read_model
    from pulseportraiture_tpu_torch.models import gauss

    out = os.path.join(work, "aligned.gmodel")
    argv = ["-d", avg, "--autogauss", "0.05", "--niter", "2", "--device",
            str(dev)]
    routes = dict(fit_gauss.FIT_ROUTES)
    with clocked(gauss, ("fit_gaussian_portrait",),
                 keep_out=("fit_gaussian_portrait",)) as clock, \
            clocked(gauss.GaussianModelPortrait,
                    ("check_convergence",)) as conv, \
            first_kernel_inputs(K, K9_NAMES) as seen:
        wall, launches = run_tool(K, ppgauss, argv + ["-o", out])
    routes = {k: fit_gauss.FIT_ROUTES[k] - routes[k] for k in routes}
    k9_vs_plain = path_kernels_vs_plain(K, seen, required=K9_NAMES)
    k9_times = path_kernel_times(K, {(k, None): v for k, v in seen.items()})
    fits = clock["fit_gaussian_portrait_out"]
    dp = conv["self"][-1]
    _, _, _, ngauss, params, _, _, _ = read_model(out)
    errs = read_model(out + "_errs")[4]
    jms, route_ms, jb, jby, jshape = jacobian_pass(dp, dev)

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
         fit_routes=routes, k9_vs_plain=k9_vs_plain, k9_times=k9_times,
         jacobian=dict(shape=jshape, ms=jms, torch_route_ms=route_ms,
                       bound_ms=jb, bound_by=jby),
         plain_vs_kernel_params_over_errs=gap,
         template_frame=dict(zip(("phase", "DM", "nu"), frame)),
         pptoas=toas)
    # ppgauss's convergence fits measure their own noise: K4's second
    # epilogue, not its first; its portrait fits go through K9 alone
    if any(launches[n] == 0 for n in K1_NAMES + ("fftfit", "spectra_noise")
           + K9_NAMES) or routes["jacfwd"] or not routes["normal"]:
        raise AssertionError("ppgauss launched %s, fit routes %s"
                             % (launches, routes))
    if not (np.isfinite(params).all() and fits[-1].return_code in (1, 2)):
        raise AssertionError("ppgauss: params %s, rc %d"
                             % (params, fits[-1].return_code))
    if not gap <= 1e-6:
        raise AssertionError("ppgauss: plain vs kernel parameters differ "
                             "by %.3g of their errors" % gap)
    return {name: launches[name] + toas["launches"][name]
            for name in launches}


def k10_path_rows(K, seen):
    """K10 on the inputs a path first gave it: against its plain version
    (path_kernels_vs_plain at K10_TOL) and timed there
    (path_kernel_times)."""
    return (path_kernels_vs_plain(K, seen, required=K10_NAMES),
            path_kernel_times(K, {(k, None): v for k, v in seen.items()}))


def params_gap(a, b, errs):
    """max |a - b| / errs over the parameters with a finite, nonzero
    error."""
    import numpy as np

    fin = np.isfinite(errs) & (errs > 0)
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))[fin]
                        / errs[fin]))


def ppgauss_scat_cli(K, dev, work, tag, argv):
    """One scattered ppgauss run through K10 (its first inputs held against
    the plain version and timed), then the same run with the plain
    versions: (its row, its launches, its last GaussianModelPortrait)."""
    from pulseportraiture_tpu_torch.cli import ppgauss
    from pulseportraiture_tpu_torch.fit import gauss as fit_gauss
    from pulseportraiture_tpu_torch.io.gmodel import read_model
    from pulseportraiture_tpu_torch.models import gauss

    out = os.path.join(work, tag + ".gmodel")
    routes = dict(fit_gauss.FIT_ROUTES)
    with clocked(gauss, ("fit_gaussian_portrait",),
                 keep_out=("fit_gaussian_portrait",)) as clock, \
            clocked(gauss.GaussianModelPortrait,
                    ("check_convergence",)) as conv, \
            first_kernel_inputs(K, K10_NAMES) as seen:
        wall, launches = run_tool(K, ppgauss, argv + ["-o", out])
    routes = {k: fit_gauss.FIT_ROUTES[k] - routes[k] for k in routes}
    vs_plain, times = k10_path_rows(K, seen)
    fits = clock["fit_gaussian_portrait_out"]
    dp = conv["self"][-1]
    params = read_model(out)[4]
    plain_out = os.path.join(work, tag + "_plain.gmodel")
    with plain_kernels(K):
        run_tool(K, ppgauss, argv + ["-o", plain_out])
    gap = params_gap(read_model(plain_out)[4], params,
                     read_model(out + "_errs")[4])
    jms, route_ms, jb, jby, jshape = jacobian_pass(dp, dev)
    row = dict(cli_s=wall, fit_s=clock["fit_gaussian_portrait"],
               lm_nfev=[f.nfev for f in fits],
               lm_rc=[f.return_code for f in fits], fit_routes=routes,
               tau_bins=float(dp.model_params[1]),
               scattering_index=float(dp.scattering_index),
               red_chi2=fits[-1].chi2 / fits[-1].dof,
               k10_vs_plain=vs_plain, k10_times=times,
               plain_vs_kernel_params_over_errs=gap,
               jacobian=dict(shape=jshape, ms=jms, torch_route_ms=route_ms,
                             bound_ms=jb, bound_by=jby))
    return row, launches, dp


def ppgauss_scat_joined(K, dev, dp, tau):
    """A joined fit of ``dp``'s portrait in two join groups of channels
    (the second's phase and DM fitted) through fit_gaussian_portrait,
    tau starting at ``tau`` and fitted where nonzero: through K10 (its
    first inputs held against the plain version and timed), then with
    the plain versions; the torch jacfwd pass at its solution: (its row,
    its launches)."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.fit import gauss as fit_gauss

    nparam = len(dp.model_params)
    nchan = dp.portx.shape[0]
    half = nchan // 2
    joins = [np.arange(0, half), np.arange(half, nchan)]
    init = np.array(dp.model_params, dtype=np.float64)
    init[1] = tau
    flags = np.ones(nparam)
    flags[1] = float(tau != 0.0)
    jargs = (dp.model_code, dp.portx, init, dp.scattering_index,
             dp.portx_noise, flags, False, dp.phases, dp.freqsxs[0],
             dp.nu_ref, [joins, np.zeros(4), np.array([0, 0, 1, 1])],
             dp.Ps[0])
    routes = dict(fit_gauss.FIT_ROUTES)
    K.reset_launches()
    with first_kernel_inputs(K, K10_NAMES) as seen:
        t0 = time.perf_counter()
        jfit = fit_gauss.fit_gaussian_portrait(*jargs, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    routes = {k: fit_gauss.FIT_ROUTES[k] - routes[k] for k in routes}
    vs_plain, times = k10_path_rows(K, seen)
    with plain_kernels(K):
        pfit = fit_gauss.fit_gaussian_portrait(*jargs, device=dev)
    gap = params_gap(pfit.fitted_params, jfit.fitted_params, jfit.fit_errs)
    jx = np.concatenate([jfit.fitted_params[:nparam],
                         [jfit.scattering_index],
                         jfit.fitted_params[nparam:]])
    jms, route_ms, jb, jby, jshape = jacobian_pass(dp, dev, joins, jx)
    row = dict(fit_s=wall, lm_nfev=int(jfit.nfev),
               lm_rc=int(jfit.return_code), fit_routes=routes,
               tau_bins=float(jfit.fitted_params[1]),
               join_params=[float(v) for v in jfit.fitted_params[nparam:]],
               red_chi2=jfit.chi2 / jfit.dof, k10_vs_plain=vs_plain,
               k10_times=times, plain_vs_kernel_params_over_errs=gap,
               params_finite=bool(np.isfinite(jx).all()
                                  and np.isfinite(jfit.chi2)),
               jacobian=dict(shape=jshape, ms=jms, torch_route_ms=route_ms,
                             bound_ms=jb, bound_by=jby))
    return row, launches


def phase_ppgauss_scat(root, work, K, dev, avg):
    """The Gaussian portrait fits K9 does not take, each through K10:
    ppgauss --autogauss 0.05 --niter 2 --fitscat on the aligned archive
    (tau fitted from 0, where its column is exactly 0, so it stays there);
    a joined fit of that portrait in two join groups of channels (the
    second group's phase and DM fitted) through
    fit.gauss.fit_gaussian_portrait (the smoke's archives share one band,
    so no metafile of bands is made for ppgauss -j); ppgauss --autogauss
    0.05 --niter 2 --fitscat --fitalpha --tau on a scattered archive (the
    port's make_fake_pulsar with t_scat K10_T_SCAT on a one-component
    model), tau > 0 at its solution; and a joined fit with tau > 0 on that
    portrait.  Each: K10's two epilogues launched, no fit on jacfwd or
    K9 (FIT_ROUTES), K10 held against its plain version on the first
    inputs the path gave it (K10_TOL) and timed there, the run again with
    the plain versions (parameters within 1e-6 of their errors), wall,
    nfev, rc, and the device time of one jacfwd pass (the route K10
    replaces) at its solution beside its bound.  Returns the launches of
    the four runs, summed."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
    from pulseportraiture_tpu_torch.io.gmodel import write_model

    base = ["--autogauss", "0.05", "--niter", "2", "--fitscat", "--device",
            str(dev)]
    rows, runs = {}, {}
    rows["scattered"], runs["scattered"], dp = ppgauss_scat_cli(
        K, dev, work, "aligned_scat", ["-d", avg] + base)
    rows["joined"], runs["joined"] = ppgauss_scat_joined(K, dev, dp, 0.0)
    # a one-component model scattered by make_fake_pulsar, fitted from
    # 3/4 of its tau with the scattering index fitted too
    gm = os.path.join(work, "unscattered.gmodel")
    write_model(gm, "k10", "000", NU0, MODEL_PARAMS, np.ones(8, int), -4.0,
                0, quiet=True)
    scat = make_fake_pulsar(
        gm, os.path.join(root, "examples", "example.par"),
        os.path.join(work, "scat.fits"), nsub=1, nchan=512, nbin=2048,
        nu0=NU0, bw=800.0, tsub=60.0, noise_stds=K10_NOISE,
        dedispersed=True, t_scat=K10_T_SCAT, alpha=K10_ALPHA, seed=31)
    rows["scattered_tau"], runs["scattered_tau"], dps = ppgauss_scat_cli(
        K, dev, work, "scat",
        ["-d", scat, "--fitalpha", "--tau", repr(0.75 * K10_T_SCAT)] + base)
    rows["scattered_tau"]["injected_tau_bins"] = \
        K10_T_SCAT * dps.nbin / dps.Ps[0]
    rows["joined_tau"], runs["joined_tau"] = ppgauss_scat_joined(
        K, dev, dps, float(dps.model_params[1]))
    emit("ppgauss_scat", launches=runs, **rows)
    for tag, row in rows.items():
        launched = runs[tag]
        r = row["fit_routes"]
        if r["jacfwd"] or r["normal"] or not r["spectral"] or any(
                launched[n] == 0 for n in K10_NAMES) or any(
                launched[n] for n in K9_NAMES):
            raise AssertionError("ppgauss_scat %s: fit routes %s, launches "
                                 "%s" % (tag, r, launched))
        if not row["plain_vs_kernel_params_over_errs"] <= 1e-6:
            raise AssertionError("ppgauss_scat %s: plain vs kernel "
                                 "parameters differ by %.3g of their errors"
                                 % (tag, row["plain_vs_kernel_params_over_"
                                             "errs"]))
    if not (np.isfinite(dp.model_params).all() and np.isfinite(
            dps.model_params).all() and rows["joined"]["params_finite"]
            and rows["joined_tau"]["params_finite"]):
        raise AssertionError("ppgauss_scat: params %s, %s" % (
            dp.model_params, dps.model_params))
    if not (rows["scattered_tau"]["tau_bins"] > 0.0
            and rows["joined_tau"]["tau_bins"] > 0.0):
        raise AssertionError("ppgauss_scat: tau %r, joined %r at the "
                             "solution" % (rows["scattered_tau"]["tau_bins"],
                                           rows["joined_tau"]["tau_bins"]))
    return {name: sum(run[name] for run in runs.values())
            for name in K.LAUNCHES}


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
    (WALK_EPOCHS epochs of ``shape``): its DM and GLS criteria, K1, K2 and
    K8 (the spline model's smoothing) launched and held against their
    plain versions on the first inputs the path gave them, the pptoas
    step rerun with the plain versions (1 ns).  Returns the launches of
    the walkthrough's run."""
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
            first_kernel_inputs(K, PHASE_DM_KERNELS + SMOOTH_KERNELS) \
            as seen:
        run = walkthrough_run(root, work, meta, files, dev)
    launches = dict(K.LAUNCHES)
    SMOOTH_TIERS["walkthrough"] = tiers = dict(K.SMOOTH_ROWS)
    vs_plain = path_kernels_vs_plain(K, seen,
                                     PHASE_DM_KERNELS + SMOOTH_KERNELS)
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
         criteria=crit, kernels_vs_plain=vs_plain, k8_rows=tiers,
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
    if any(launches[n] == 0 for n in PHASE_DM_KERNELS + SMOOTH_KERNELS) \
            or tiers["scanned"] == 0:
        raise AssertionError("walkthrough launched %s, K8's rows %s"
                             % (launches, tiers))
    if not np.isfinite([gls["postfit_wrms_us"], gls["red_chi2"]]).all():
        raise AssertionError("walkthrough: GLS %s" % gls)
    return launches


def profile_cli(argv, outdir, K):
    """Where the pptoas CLI's wall time goes: host functions (cProfile,
    one run) and device time by kernel (torch.profiler, another run;
    device_busy).  Emits a summary; writes the tables to ``outdir``."""
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
    n0 = dict(K.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pptoas.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy(device_rows(prof), {
        k: K.LAUNCHES[k] - n0[k] for k in n0}, K)
    rows = sorted(((key[:80], s, n) for key, s, n in device_rows(prof)),
                  key=lambda r: -r[1])
    os.makedirs(outdir, exist_ok=True)
    buf = io.StringIO()
    pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(40)
    with open(os.path.join(outdir, "pptoas_profile.txt"), "w") as f:
        f.write(buf.getvalue())
        f.write("\n" + prof.key_averages().table(
            sort_by="cpu_time_total", row_limit=40))
    emit("profile", cprofile_wall_s=host_wall, wall_s=wall, **busy,
         device_idle_share=None if busy["device_busy_s"] is None
         else 1.0 - busy["device_busy_s"] / wall,
         host_cumulative_s=host[:15],
         device_top=[list(r) for r in rows[:10]])


def device_rows(prof):
    """(name, device seconds, count) of every device-side event (kernels,
    copies) in a torch.profiler run.  The solver's pp_* record_function
    ranges (obs/devtime.py) show as device rows spanning their kernels:
    they are not device work and are left out."""
    from pulseportraiture_tpu_torch.obs.devtime import SCOPE_PREFIX

    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and \
                not e.key.startswith(SCOPE_PREFIX):
            dev_us = getattr(e, "self_device_time_total", None)
            if dev_us is None:
                dev_us = e.self_cuda_time_total
            rows.append((e.key, dev_us / 1e6, e.count))
    return rows


def device_busy(rows, launched, K):
    """Device-busy seconds of a torch.profiler run's ``rows``
    (device_rows), held to the hand kernels' ``launched`` counts over the
    run: in a process that has run for minutes the profiler drops a
    region's first rows (PERF.md section 7), and a hand kernel with fewer
    rows than launches shows it.  Returns dict(device_busy_s: the rows'
    sum, None where rows were lost; device_busy_s_undercount: the sum
    then; rows_complete; lost_rows)."""
    busy = sum(r[1] for r in rows)
    seen = {name: sum(n for key, _, n in rows if fn in key)
            for name, fn in K.TRACE_NAMES.items()}
    complete = all(seen[k] == launched.get(k, 0) for k in seen)
    return dict(device_busy_s=busy if complete else None,
                device_busy_s_undercount=None if complete else busy,
                rows_complete=complete,
                lost_rows=sum(max(0, launched.get(k, 0) - seen[k])
                              for k in seen))


def kernel_times(prof, K):
    """{kernel name: (launches, device ms in all)} of a torch.profiler
    run.  A launch of K2 runs two CUDA kernels: its launches are the
    larger count of the two; a kernel the profiler shows no device time
    for is left out."""
    out = {}
    for key, dev_s, count in device_rows(prof):
        for name in K.KERNELS:  # K.TRACE_NAMES; K2's fftfit_*_kernel
            hit = (name + "_" in key and "_kernel" in key) \
                if name == "fftfit" else K.TRACE_NAMES[name] in key
            if hit and dev_s > 0:
                n, ms = out.get(name, (0, 0.0))
                out[name] = (max(n, count), ms + dev_s * 1e3)
    return out


def h2d_copies(prof):
    """The host-to-device copies of a torch.profiler run, read from its
    Chrome trace (each copy's size is in its ``bytes`` argument): their
    count, bytes and device ms, the same of those from pageable memory,
    and the five largest as [bytes, source memory]."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out = dict(count=0, bytes=0, ms=0.0, pageable_count=0,
               pageable_bytes=0, pageable_ms=0.0)
    sizes = []
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") != "X" or not name.startswith("Memcpy HtoD"):
            continue
        nbytes = int((e.get("args") or {}).get("bytes", 0))
        ms = float(e.get("dur", 0.0)) / 1e3
        pageable = "Pageable" in name
        out["count"] += 1
        out["bytes"] += nbytes
        out["ms"] += ms
        if pageable:
            out["pageable_count"] += 1
            out["pageable_bytes"] += nbytes
            out["pageable_ms"] += ms
        sizes.append([nbytes, "pageable" if pageable else "pinned"])
    out["largest"] = sorted(sizes, reverse=True)[:5]
    out["largest_pageable_bytes"] = max(
        [b for b, kind in sizes if kind == "pageable"], default=0)
    return out


def kernel_device_ms(fn, K, copies=False):
    """({kernel name: (launches, device ms in all)}, device profile) of
    one call of fn(), from torch.profiler.  The device profile holds the
    wall, the device-busy seconds (None where the profiler lost rows:
    device_busy), the device events (kernels, copies, fills) and of them
    those not of a hand kernel (torch's), and the eight device rows that
    took longest; with ``copies`` also its host-to-device copies
    (h2d_copies) and the peak device memory over the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n0 = dict(K.LAUNCHES)
    if copies:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: K.LAUNCHES[k] - n0[k] for k in n0}
    rows = device_rows(prof)
    top = sorted(rows, key=lambda r: -r[1])[:8]
    hand = tuple(K.TRACE_NAMES.values()) + ("fftfit_",)
    events = sum(n for _, _, n in rows)
    profile_ = dict(wall_s=wall, **device_busy(rows, launched, K),
                    device_events=events,
                    torch_device_events=events - sum(
                        n for key, _, n in rows
                        if any(h in key for h in hand)),
                    device_top=[[key[:60], dev_s * 1e3, n]
                                for key, dev_s, n in top])
    if copies:
        profile_.update(h2d=h2d_copies(prof),
                        peak_bytes=torch.cuda.max_memory_allocated())
    return kernel_times(prof, K), profile_


def north_star_draw(dev, seed, nsub=1000, nchan=512, nbin=2048, t_scat=0.0):
    """The north-star dataset, made on ``dev`` by the port's
    make_fake_dataset (B11): ``nsub`` subints of MODEL_PARAMS across
    1300-1700 MHz at phases and dDMs drawn from a generator seeded with
    ``seed``, noise NOISE, scattered by ``t_scat`` [s]; the same on every
    process that draws it.  Returns (the DataBunch, injected phases,
    injected dDMs)."""
    import torch

    from pulseportraiture_tpu_torch.pipelines.synth import make_fake_dataset

    gen = torch.Generator(device=dev).manual_seed(seed)
    phis = (torch.rand(nsub, generator=gen, device=dev,
                       dtype=torch.float64) - 0.5) * 0.8
    dDMs = (torch.rand(nsub, generator=gen, device=dev,
                       dtype=torch.float64) - 0.5) * 4e-3
    ds = make_fake_dataset(gen, MODEL_PARAMS, nsub=nsub, nchan=nchan,
                           nbin=nbin, lofreq=1300.0, bw=400.0, P=P0,
                           phases=phis, dDMs=dDMs, noise_std=NOISE,
                           t_scat=t_scat, device=dev)
    return ds, phis, dDMs


def north_star_model(dev, ds):
    """The model portrait of a north-star DataBunch ``ds``."""
    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait

    return gen_gaussian_portrait("000", MODEL_PARAMS, -4.0,
                                 get_bin_centers(ds.nbin), ds.freqs,
                                 ds.nu_ref, device=dev)


def north_star_data(dev, seed, nsub=1000, nchan=512, nbin=2048,
                    t_scat=0.0):
    """The north-star data (:func:`north_star_draw`), with the make's
    seconds and memory.  Returns (subints, freqs, nu_ref, injected
    phases, injected dDMs, the model portrait, make seconds, peak device
    bytes while making, of them above what was allocated before)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ds, phis, dDMs = north_star_draw(dev, seed, nsub, nchan, nbin, t_scat)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    model = north_star_model(dev, ds)
    out = (ds.subints, ds.freqs, ds.nu_ref, phis, dDMs, model, t_make, peak,
           peak - base)
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
    # the synth path (K12): the north-star data, counts zeroed just before
    K.reset_launches()
    paths0 = dict(K.SYNTH_PATHS)
    data, freqs, nu0, phis, dDMs, model, t_make, make_peak, make_extra = \
        north_star_data(dev, 0, nsub, nchan, nbin)
    synth_launches = dict(K.LAUNCHES)
    paths = {r: K.SYNTH_PATHS[r] - paths0[r] for r in paths0}
    kmax = model_kmax(model)
    errs = torch.full((nsub, nchan), NOISE, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    b11_bound, b11_by = synth_bound_ms(nsub, nchan, nbin)
    k12 = phase_synth_rows(dev, K, model, freqs, nu0)
    emit("synth", shape=[nsub, nchan, nbin], make_s=t_make,
         ms=t_make * 1e3, bound_ms=b11_bound, bound_by=b11_by,
         share_of_bound=b11_bound / (t_make * 1e3),
         peak_device_bytes=int(make_peak),
         peak_above_prior_bytes=int(make_extra),
         output_bytes=int(data.numel() * 8), paths=paths,
         launches={n: synth_launches[n] for n in synth_launches
                   if synth_launches[n]}, k12=k12)
    if synth_launches["synth_rows"] == 0 or paths["cufft"] or \
            paths["onchip"] != synth_launches["synth_rows"]:
        raise AssertionError("synth: the north-star data did not go "
                             "through K12's onchip path: %s" % paths)

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
    k1, k1_gh, k2, k4 = (per_kernel.get(name) for name in (
        "moments", "moments_grad_hess", "fftfit", "spectra"))
    res = dict(shape=[nsub, nchan, nbin], kmax=kmax, first_s=t_first,
               steady_s=t_steady, toas_per_s=nsub / t_steady,
               launches=launches,
               k1_ms_per_launch=k1[1] / k1[0] if k1 else None,
               k1_ms_total=k1[1] if k1 else None,
               k1_grad_hess_ms_per_launch=k1_gh[1] / k1_gh[0] if k1_gh
               else None,
               k1_grad_hess_ms_total=k1_gh[1] if k1_gh else None,
               k2_ms=k2[1] / k2[0] if k2 else None,
               k4_ms_per_launch=k4[1] / k4[0] if k4 else None,
               k4_ms_total=k4[1] if k4 else None,
               device_busy_ms=None if device["device_busy_s"] is None
               else device["device_busy_s"] * 1e3,
               device_events=device["device_events"],
               torch_device_events=device["torch_device_events"],
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
    if any(launches[n] == 0 for n in PHASE_DM_KERNELS):
        raise AssertionError("throughput fit launched %s" % launches)
    del out, errs
    noise_fit = phase_noise_fit(data[:256])
    return res, dict(synth=(synth_launches, k12), noise_fit=noise_fit)


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


def k11_bound_ms(rows, nharm, nshapes, Ns=20):
    """K11's least time over ``rows`` spectra of ``nharm`` harmonics: the
    spectrum read once and the noise and cutoff written once, against per
    harmonic the power (3), its log (counted as 1), y and its two sums (4),
    the dot products with the ``nshapes`` distinct shapes (2 each) and the
    noise sum (1), and per grid point 7 operations."""
    ops = rows * (nharm * (9 + 2 * nshapes) + 7 * Ns ** 3)
    return bound_ms(rows * (nharm * 16 + 16), (ops, PEAK_FP64_PER_S))


def k11_chi2_bound(spec, nbin, fn, Ns, flat):
    """The "fit" grid's chi2 at one flat (a, b, dc) index a row (flat [R]
    int64 >= 0) of spec's rows (noise_fit's spec and nbin), evaluated at
    that point alone in the order of ops.noise._chi2_grid, and a bound on
    the gap between any two evaluations of it by that formula whose sums
    run in other orders and whose log powers differ by a few units in the
    last place (as K11's and its plain version's do on the card).  Returns
    (chi2 [R], bound [R]).

    The bound: chi2 = sum_k r_k^2, r_k = y_k - b s_k - d (the mean cancels
    between y and d), is evaluated from N-term sums and a few products and
    sums after them, so each evaluation lies within gamma_{N+8} M of the
    exact value of its inputs (M = Syy + b^2 S2 + 2 |b| sum |y| s + N d^2 +
    2 |d| sum |y| + 2 |b| |d| S1: every term's magnitude; gamma_n = n u /
    (1 - n u), u = 2^-53); y and d are rounded (u (|y| + |d|) each), which
    moves chi2 by at most 2 u (max |y| + |d|) sum |r_k|.  So two
    evaluations from the same log powers differ by at most twice the sum of
    those.  Log powers that differ by at most dl = 4 u (1 + max |log p|)
    move each r_k by at most 4 dl (l_k by dl, lmin and lmax, hence the
    grid's b and dc, by dl each), chi2 by at most 8 dl sum |r_k|: the
    bound returned is the sum.  Two grid points whose chi2 differ by less
    than the sum of their bounds can be ordered either way."""
    import torch

    from pulseportraiture_tpu_torch.ops import noise

    pows = (spec * torch.conj(spec)).real / nbin if spec.is_complex() \
        else spec
    N = pows.shape[-1]
    grid = noise._kc_grid(N, fn, Ns, pows.device)
    logp = torch.log10(pows)
    lmin, lmax = logp.amin(dim=-1), logp.amax(dim=-1)
    mean = logp.mean(dim=-1)
    y = logp - mean[:, None]
    ia, rest = flat // (Ns * Ns), flat % (Ns * Ns)
    ib, idc = rest // Ns, rest % Ns
    b = noise._linspace_rows(torch.zeros_like(lmin), lmax - lmin, Ns).gather(
        1, ib[:, None])[:, 0]
    d = noise._linspace_rows(lmin, lmax, Ns).gather(1, idc[:, None])[:, 0] \
        - mean
    s = grid.uniq[grid.inverse[ia]]
    S1, S2 = grid.S1[ia], grid.S2[ia]
    Syy, Sy, Ya = (y * y).sum(dim=-1), y.sum(dim=-1), (y * s).sum(dim=-1)
    chi2 = ((Syy + (b * b * S2 - 2.0 * b * Ya)) + (N * d * d - 2.0 * d * Sy)) \
        + 2.0 * b * d * S1
    u = 2.0 ** -53
    ay = y.abs()
    M = Syy + b * b * S2 + 2.0 * b.abs() * (ay * s).sum(dim=-1) \
        + N * d * d + 2.0 * d.abs() * ay.sum(dim=-1) \
        + 2.0 * b.abs() * d.abs() * S1
    gam = (N + 8) * u / (1.0 - (N + 8) * u)
    dl = 4.0 * u * (1.0 + logp.abs().amax(dim=-1))
    r = (y - b[:, None] * s - d[:, None]).abs().sum(dim=-1)
    return chi2, 2.0 * (gam * M + 2.0 * u * (ay.amax(dim=-1) + d.abs()) * r) \
        + 8.0 * dl * r


def k11_ties(spec, nbin, fn, Ns, kc_a, kc_b):
    """Rows of spec whose cutoffs kc_a and kc_b (two evaluations of
    noise_fit) differ, split into ties — the row's log power finite, each
    cutoff some a's, and the chi2 at each cutoff's best grid point (the
    least of ops.noise._chi2_grid over the points of the a's with that
    cutoff) within the sum of their k11_chi2_bound bounds, an order
    rounding may flip — and faults (any other mismatch).  Returns (ties,
    faults) as counts."""
    import torch

    from pulseportraiture_tpu_torch.ops import noise

    rows = (kc_a != kc_b).nonzero()[:, 0]
    if not len(rows):
        return 0, 0
    sub = spec[rows]
    pows = (sub * torch.conj(sub)).real / nbin if sub.is_complex() else sub
    grid = noise._kc_grid(pows.shape[-1], fn, Ns, pows.device)
    chi2, finite = noise._chi2_grid(torch.log10(pows), grid, Ns)
    kc_of = grid.kc.repeat_interleave(Ns * Ns)      # each flat point's cutoff
    ok, flats = finite, []
    for kc in (kc_a[rows], kc_b[rows]):
        on = kc_of[None, :] == kc[:, None]
        ok = ok & on.any(dim=-1)
        flats.append(torch.argmin(torch.where(on, chi2, math.inf), dim=-1))
    (ea, ba), (eb, bb) = (k11_chi2_bound(sub, nbin, fn, Ns, f) for f in flats)
    tie = ok & ((ea - eb).abs() <= ba + bb)
    return int(tie.sum()), int((~tie).sum())


def k11_wide(dev):
    """K11 against its plain version on the card at K11_WIDE_CASES: for
    each, whether a row's power is kept in shared memory (csrc/noisefit.cu
    geometry), the cutoff mismatches (ties and faults, k11_ties) and the
    noise's largest relative error where the cutoffs agree."""
    import torch

    from pulseportraiture_tpu_torch import _kernels as K
    from pulseportraiture_tpu_torch.ops import noise

    res = []
    for rows, nbin, fn, Ns, fact in K11_WIDE_CASES:
        g = torch.Generator(device=dev).manual_seed(rows + nbin)
        x = torch.randn((rows, nbin), generator=g, dtype=torch.float64,
                        device=dev)
        ph = (torch.arange(nbin, dtype=torch.float64, device=dev) + 0.5) \
            / nbin
        width = torch.linspace(0.002, 0.05, rows, dtype=torch.float64,
                               device=dev)[:, None]
        x[::2] += 30.0 * torch.exp(-0.5 * ((ph - 0.4) / width[::2]) ** 2)
        x[1] = 0.0                                  # a zeroed channel
        X = torch.fft.rfft(x, dim=-1)
        del x
        N = nbin // 2 + 1
        nu = int(noise._kc_grid(N, fn, Ns, dev).uniq.shape[0])
        got = K.noise_fit(X, nbin, fn, fact, Ns,
                          torch.empty(rows, dtype=torch.float64, device=dev))
        want = K.noise_fit_plain(X, nbin, fn, fact, Ns, torch.empty(
            rows, dtype=torch.float64, device=dev))
        ties, faults = k11_ties(X, nbin, fn, Ns, got[1], want[1])
        same = (got[1] == want[1]) & (want[0] != 0)
        rel = float(((got[0] - want[0]).abs()[same] / want[0][same]).max())
        res.append(dict(rows=rows, nbin=nbin, fn=fn, Ns=Ns, fact=fact,
                        nshapes=nu, power_in_shared_memory=8 * (
                            3 * Ns + nu + N) <= 232448,
                        k_crit_mismatches=ties + faults, ties=ties,
                        faults=faults, noise_max_rel_err=rel,
                        zeroed_equal=bool(torch.equal(got[0] == 0,
                                                      want[0] == 0))))
        del X
    return res


def phase_noise_fit(cube):
    """The "fit" noise estimators on the card through K11: get_noise_fit
    on the channels of ``cube`` [nsub, nchan, nbin] with NOISE_ZEROED
    zeroed in every subint (the path's run with the counts zeroed just
    before; its time, peak memory, bound), K11 alone over every channel's
    spectrum by CUDA-graph replay (cuFFT's rFFT timed apart), beside its
    bound and the plain version's time; K11 against its plain version on
    the card over every channel (cutoff mismatches, ties by the chi2
    rounding bound, the noise's largest relative error), and at
    K11_WIDE_CASES (k11_wide); the Wiener and
    brickwall filters on one subint's profiles; the first subint held
    against the port on the CPU (k_crit equal, noise within 1e-12
    relative, the filters within 1e-12 of their peak, zeroed channels 0).
    Returns (the path's launches, K11's kernels-line row)."""
    import torch

    from pulseportraiture_tpu_torch import _kernels as K
    from pulseportraiture_tpu_torch.ops import noise

    nsub, nchan, nbin = cube.shape
    nharm = nbin // 2 + 1
    rows = nsub * nchan
    cube[:, list(NOISE_ZEROED)] = 0.0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    sig = noise.get_noise_fit(cube)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    call_ms = cuda_ms(lambda: noise.get_noise_fit(cube), reps=3, warm=0)
    bound, by = noise_fit_bound_ms(rows, nbin)
    _, profiled = kernel_device_ms(lambda: noise.get_noise_fit(cube), K)

    # K11 alone over every channel's spectrum, and its plain version
    flat = cube.reshape(rows, nbin)
    X = torch.fft.rfft(flat, dim=-1)
    cufft_ms = graph_ms(lambda: torch.fft.rfft(flat, dim=-1), reps=5)
    grid = noise._kc_grid(nharm, "exp_dc", 20, cube.device)

    def outs():
        return tuple(torch.empty(rows, dtype=dt, device=cube.device)
                     for dt in (torch.float64, torch.int64))

    got, want = outs(), outs()
    ms = graph_ms(lambda: K.noise_fit(X, nbin, "exp_dc", 1.1, 20, *got),
                  reps=10)
    K.noise_fit(X, nbin, "exp_dc", 1.1, 20, *got)
    step = noise.GRID_ROWS_CUDA

    def plain():
        for i in range(0, rows, step):
            s = slice(i, i + step)
            K.noise_fit_plain(X[s], nbin, "exp_dc", 1.1, 20,
                              *(o[s] for o in want))

    plain_ms = cuda_ms(plain, reps=2, warm=1)
    k11_bound, k11_by = k11_bound_ms(rows, nharm, grid.uniq.shape[0])
    ties, faults = k11_ties(X, nbin, "exp_dc", 20, got[1], want[1])
    same = (got[1] == want[1]) & (want[0] != 0)
    k11_rel = float(((got[0] - want[0]).abs()[same] / want[0][same]).max())
    k11_abs = float((got[0] - want[0]).abs()[same].max())
    zeroed_equal = bool(torch.equal(got[0] == 0, want[0] == 0))
    path_equal = bool(torch.equal(got[0].reshape(nsub, nchan), sig))
    del X
    wide = k11_wide(cube.device)

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
    row = dict(shape=[rows, nharm], ms=ms, call_ms=call_ms,
               cufft_ms=cufft_ms, plain_ms=plain_ms, bound_ms=k11_bound,
               bound_by=k11_by, share_of_bound=k11_bound / ms,
               library_ms=None, max_abs_err=k11_abs,
               noise_max_rel_err=k11_rel, k_crit_mismatches=ties + faults,
               ties=ties, faults=faults, zeroed_equal=zeroed_equal,
               path_equal=path_equal, nshapes=int(grid.uniq.shape[0]),
               wide=wide)
    res = dict(shape=[nsub, nchan, nbin], channels=rows,
               zeroed_channels=list(NOISE_ZEROED), first_call_s=first_s,
               call_ms=call_ms, bound_ms=bound, bound_by=by,
               share_of_bound=bound / call_ms,
               peak_extra_device_bytes=int(peak),
               launches={n: launches[n] for n in launches if launches[n]},
               k11=row,
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
    if faults or not k11_rel <= K11_NOISE_TOL or not zeroed_equal or \
            not path_equal or launches["noise_fit"] == 0 or any(
                w["faults"] or not w["noise_max_rel_err"] <= K11_NOISE_TOL
                or not w["zeroed_equal"] for w in wide):
        raise AssertionError("noise_fit: K11 disagrees with its plain "
                             "version or did not launch: %s, launches %s"
                             % (row, launches["noise_fit"]))
    return launches, row


def k12_bound_ms(B, nchan, nbin, scat):
    """K12's least time over one block [B, nchan, nbin]: the noise read
    and the output written once (and the model's and scattering spectra,
    the shifts and the pattern read once), against per row the inverse
    real transform (2.5 nbin log2 nbin), the phasor (K7_OPS a harmonic),
    the scattering product (6 a harmonic) and 5 operations a bin."""
    nharm = nbin // 2 + 1
    nbytes = 2 * B * nchan * nbin * 8 + (1 + scat) * nchan * nharm * 16 \
        + 2 * B * nchan * 8
    ops = B * nchan * (2.5 * nbin * math.log2(nbin)
                       + (K7_OPS + 6 * scat) * nharm + 5 * nbin)
    return bound_ms(nbytes, (ops, PEAK_FP64_PER_S))


def k12_block(dev, model, freqs, nu0, gen, B, scat):
    """One make_fake_dataset block's arguments for K12 at the north star:
    the model's spectrum, the shifts of B drawn (phase, dDM), the
    scattering spectrum of TAU_INJ at nu0 (scat), a scintillation pattern
    of three drawn triplets a subint, scales 1, sigma NOISE, weights none,
    and out holding the block's noise from ``gen``."""
    import numpy as np
    import torch

    from pulseportraiture_tpu_torch.ops.fourier import data_shifts
    from pulseportraiture_tpu_torch.ops.scattering import (
        scattering_portrait_FT, scattering_times)
    from pulseportraiture_tpu_torch.pipelines import synth

    nchan, nbin = model.shape
    f64 = dict(dtype=torch.float64, device=dev)
    M = torch.fft.rfft(model, dim=-1)
    phis = torch.rand(B, generator=gen, **f64) * 0.8 - 0.4
    dDMs = (torch.rand(B, generator=gen, **f64) - 0.5) * 4e-3
    shifts = data_shifts((B, nchan), -phis[:, None], -dDMs[:, None], P0,
                         freqs, nu0, dev).contiguous()
    T = scattering_portrait_FT(scattering_times(TAU_INJ, -4.0, freqs, nu0),
                               nbin).contiguous() if scat else None
    pattern = synth.scintillation_pattern(synth.scintillation_params(
        np.random.default_rng(B), 3, 1.0, 5.0, (B,)), nchan, dev)
    out = torch.empty((B, nchan, nbin), **f64).normal_(generator=gen)
    return [M, shifts, T, pattern, torch.ones(nchan, **f64),
            torch.full((nchan,), NOISE, **f64), None, out]


def phase_synth_rows(dev, K, model, freqs, nu0):
    """K12 on the card at the north star: one make_fake_dataset block
    [32, 512, 2048] (BLOCK_BYTES) by CUDA-graph replay, without and with
    the scattering spectrum, against its bound, its plain version's time
    and torch.randn's for the block's noise; K12 against its plain version
    on the same noise from one generator state (every row within K12_TOL of
    its peak); make_fake_dataset through K12 and through its plain version
    from one seed (the same noise draws: within K12_TOL of each row's
    peak); a width the onchip path does not take (K12_NARROW_BINS) through
    the counted cufft path: the make held to the CPU's (noiseless, 1e-12 of
    the peak), and one scattered block held to the plain version on the
    same noise, timed beside it and its bound.  Returns K12's kernels-line
    row (the unscattered block first in ``shapes``)."""
    import torch

    from pulseportraiture_tpu_torch.ops.fourier import get_bin_centers
    from pulseportraiture_tpu_torch.ops.profiles import gen_gaussian_portrait
    from pulseportraiture_tpu_torch.pipelines import synth

    nchan, nbin = model.shape
    B = max(1, synth.BLOCK_BYTES // (nchan * nbin * 8))
    # the whole make again, warm (the first call also builds cuFFT's plan
    # and the twiddle table): its wall and K12's launches in it
    torch.cuda.synchronize()
    n0 = K.LAUNCHES["synth_rows"]
    t0 = time.perf_counter()
    ds, _, _ = north_star_draw(dev, 0)
    torch.cuda.synchronize()
    make_warm_s = time.perf_counter() - t0
    make_launches = K.LAUNCHES["synth_rows"] - n0
    ds.clear()
    del ds
    cases = []
    for scat in (False, True):
        gen = torch.Generator(device=dev).manual_seed(24)
        state = gen.get_state()
        a = k12_block(dev, model, freqs, nu0, gen, B, scat)
        gen.set_state(state)
        b = k12_block(dev, model, freqs, nu0, gen, B, scat)
        draws_equal = bool(torch.equal(a[-1], b[-1]))
        K.synth_rows(*a)
        K.synth_rows_plain(*b)
        peak = b[-1].abs().amax(dim=-1, keepdim=True)
        gap = float(((a[-1] - b[-1]).abs() / peak).max())
        max_abs = float((a[-1] - b[-1]).abs().max())
        ms = graph_ms(lambda: K.synth_rows(*a), reps=10)
        plain_ms = cuda_ms(lambda: K.synth_rows_plain(*b), reps=3, warm=1)
        randn_ms = cuda_ms(lambda: a[-1].normal_(generator=gen), reps=10)
        bound, by = k12_bound_ms(B, nchan, nbin, scat)
        cases.append(dict(shape=[B, nchan, nbin], scattered=scat, ms=ms,
                          plain_ms=plain_ms, randn_ms=randn_ms,
                          bound_ms=bound, bound_by=by,
                          share_of_bound=bound / ms, library_ms=None,
                          max_abs_err=max_abs, max_gap_over_peak=gap,
                          draws_equal=draws_equal))
        del a, b
    # make_fake_dataset on its two routes from one seed: the same draws
    nsub = B + 3
    kw = dict(nsub=nsub, nchan=64, nbin=nbin, P=P0, t_scat=1e-4,
              scint=True, noise_std=NOISE, device=dev,
              phases=[0.6 * i / nsub - 0.3 for i in range(nsub)],
              dDMs=[2e-3 * i / nsub - 1e-3 for i in range(nsub)])

    def make(**extra):
        return synth.make_fake_dataset(
            torch.Generator(device=dev).manual_seed(5), MODEL_PARAMS,
            **dict(kw, **extra)).subints

    kernel_route = make()
    with plain_kernels(K, ["synth_rows"]):
        plain_route = make()
    peak = plain_route.abs().amax(dim=-1, keepdim=True)
    route_gap = float(((kernel_route - plain_route).abs() / peak).max())
    # a width the onchip path does not take: the cufft path, counted, one
    # block held to the plain version on the same noise (timed beside it)
    # and the make held to the CPU's
    nb = K12_NARROW_BINS
    n0, p0 = K.LAUNCHES["synth_rows"], dict(K.SYNTH_PATHS)
    narrow = make(nbin=nb, noise_std=0.0)
    narrow_launches = K.LAUNCHES["synth_rows"] - n0
    narrow_paths = {r: K.SYNTH_PATHS[r] - p0[r] for r in p0}
    cpu = synth.make_fake_dataset(
        torch.Generator().manual_seed(5), MODEL_PARAMS,
        **dict(kw, nbin=nb, noise_std=0.0, device="cpu")).subints
    narrow_gap = rel_err(narrow.cpu(), cpu)
    del narrow, cpu
    model_nb = gen_gaussian_portrait("000", MODEL_PARAMS, -4.0,
                                     get_bin_centers(nb), freqs, nu0,
                                     device=dev)
    Bn = max(1, synth.BLOCK_BYTES // (nchan * nb * 8))
    gen = torch.Generator(device=dev).manual_seed(25)
    state = gen.get_state()
    a = k12_block(dev, model_nb, freqs, nu0, gen, Bn, True)
    gen.set_state(state)
    b = k12_block(dev, model_nb, freqs, nu0, gen, Bn, True)
    K.synth_rows(*a)
    K.synth_rows_plain(*b)
    peak = b[-1].abs().amax(dim=-1, keepdim=True)
    cufft_gap = float(((a[-1] - b[-1]).abs() / peak).max())
    cufft_ms = cuda_ms(lambda: K.synth_rows(*a), reps=5, warm=1)
    cufft_plain_ms = cuda_ms(lambda: K.synth_rows_plain(*b), reps=3, warm=1)
    cufft_bound, cufft_by = k12_bound_ms(Bn, nchan, nb, True)
    del a, b
    row = dict(cases[0], shapes=cases, make_warm_s=make_warm_s,
               make_launches=make_launches, route_gap_over_peak=route_gap,
               narrow=dict(nbin=nb, paths=narrow_paths,
                           launches=narrow_launches, gap_to_cpu=narrow_gap,
                           block=[Bn, nchan, nb], scattered=True,
                           ms=cufft_ms, plain_ms=cufft_plain_ms,
                           bound_ms=cufft_bound, bound_by=cufft_by,
                           share_of_bound=cufft_bound / cufft_ms,
                           max_gap_over_peak=cufft_gap))
    if any(c["max_gap_over_peak"] > K12_TOL or not c["draws_equal"]
           for c in cases) or not route_gap <= K12_TOL or \
            narrow_launches != 1 or narrow_paths["cufft"] != 1 or \
            narrow_paths["onchip"] or not narrow_gap <= 1e-12 or \
            not cufft_gap <= K12_TOL:
        raise AssertionError("synth: K12 disagrees with its plain version, "
                             "or the paths: %s" % row)
    return row


def phase_throughput_scat(dev, K):
    """The north-star scattering fit (bench_common.py's fit_scat) at
    1000 x 512 x 2048: tau TAU_INJ at nu0, alpha -4, flags (1,1,0,1,1).
    Recovery, the per-fit wall, device busy, device events (torch's and
    the hand kernels'), peak memory; then the same fit with the plain
    versions on the card: each lane's TOA within 1 ns, and the lanes
    whose rc or nfeval differ, counted."""
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
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
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
    nfev = out.nfeval.double()
    # the same fit through the plain versions on the card
    with plain_kernels(K):
        t0 = time.perf_counter()
        ref = run()
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    dt_ns = (((out.phi - ref.phi) + 0.5) % 1.0 - 0.5).abs() * P0 * 1e9
    rc_diff = torch.nonzero(out.return_code != ref.return_code).flatten()
    nfev_diff = torch.nonzero(out.nfeval != ref.nfeval).flatten()

    def within(z):
        return float((z < 5).double().mean())

    def per_launch(name):
        hit = per_kernel.get(name)
        return (hit[1] / hit[0], hit[1]) if hit else (None, None)

    k3_ms, k3_total = per_launch("moments_scat")
    gh_ms, gh_total = per_launch("moments_scat_grad_hess")
    k4_ms, k4_total = per_launch("spectra")
    res = dict(shape=[nsub, nchan, nbin], kmax=kmax, first_s=t_first,
               steady_s=t_steady, toas_per_s=nsub / t_steady,
               launches=launches,
               k3_ms_per_launch=k3_ms, k3_ms_total=k3_total,
               k3_grad_hess_ms_per_launch=gh_ms,
               k3_grad_hess_ms_total=gh_total,
               k4_ms_per_launch=k4_ms, k4_ms_total=k4_total,
               device_busy_ms=None if device["device_busy_s"] is None
               else device["device_busy_s"] * 1e3,
               device_events=device["device_events"],
               torch_device_events=device["torch_device_events"],
               peak_device_bytes=int(peak),
               peak_above_prior_bytes=int(peak - base),
               rc_counts={int(c): int((out.return_code == c).sum())
                          for c in out.return_code.unique()},
               nfev_max=int(nfev.max()), nfev_median=float(nfev.median()),
               frac_phase_within_5sigma=within(zphi),
               frac_DM_within_5sigma=within(zDM),
               frac_tau_within_5sigma=within(ztau),
               frac_alpha_within_5sigma=within(zalpha),
               median_tau_err=float(out.tau_err.median()), finite=finite,
               plain_fit_s=t_plain,
               plain_vs_kernel_max_ns=float(dt_ns.max()),
               rc_differ=[int(i) for i in rc_diff],
               nfev_differ=[int(i) for i in nfev_diff],
               n_rc_differ=int(rc_diff.numel()),
               n_nfev_differ=int(nfev_diff.numel()),
               profiled=device)
    emit("throughput_scat", **res)
    if not (finite and min(res[k] for k in res if k.startswith("frac_"))
            > 0.99):
        raise AssertionError("north-star scattering fit did not recover the "
                             "injection")
    if not res["plain_vs_kernel_max_ns"] <= 1.0:
        raise AssertionError("scattering fit: kernels vs plain %.3g ns"
                             % res["plain_vs_kernel_max_ns"])
    if any(launches[name] == 0 for name in SCAT_FIT_KERNELS):
        raise AssertionError("scattering fit launched %s" % launches)
    return res


# -- the observability layer (obs/, testing/faults) -------------------------

def track_failed_datafiles():
    """Keep the ``failed_datafiles`` list of every GetTOAs made from now
    on (the CLIs' too); returns the list of those lists."""
    from pulseportraiture_tpu_torch.pipelines import toas

    lists = []
    init = toas.GetTOAs.__init__

    def tracked(self, *args, **kw):
        init(self, *args, **kw)
        lists.append(self.failed_datafiles)

    toas.GetTOAs.__init__ = tracked
    return lists


# tools/obs_report.py reads a run through helpers of the JAX package's obs
# layer (pulseportraiture_tpu.obs: list_event_files, quality, metrics,
# flight, usage).  The smoke imports nothing of the JAX package, so its
# subprocess serves those imports from the port's copies of the same
# modules, then runs the unchanged script's main() on each run directory
# and prints its exit code after the report.
OBS_REPORT = """
import runpy, sys
sys.path.insert(0, %r)
import pulseportraiture_tpu_torch as port
import pulseportraiture_tpu_torch.obs
sys.modules["pulseportraiture_tpu"] = port
for name, mod in list(sys.modules.items()):
    if name.startswith("pulseportraiture_tpu_torch.obs"):
        sys.modules["pulseportraiture_tpu" + name[len(port.__name__):]] = mod
tool = runpy.run_path(%r, run_name="obs_report")
for run_dir in sys.argv[1:]:
    rc = tool["main"]([run_dir])
    print("%s %%s %%d" %% (run_dir, rc), flush=True)
"""
OBS_REPORT_RC = "obs_report exit code:"


OBS_WORKER = r"""
import json, sys
root, work, small = sys.argv[1:4]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from pulseportraiture_tpu_torch import _kernels as K
K.build()
made = cs.track_failed_datafiles()
launches = cs.phase_obs(root, work, K, torch.device("cuda"), small)
failed = [f for lists in made for f in lists]
if failed:
    raise AssertionError("archives failed on the card: %s" % failed)
print(json.dumps(launches), flush=True)
"""


def phase_obs_fresh(root, work, small):
    """phase_obs in a process of its own (OBS_WORKER), its lines passed
    on: torch.profiler maps the card's timestamps to the host clock with
    a conversion that drifts over a process's life and drops the rows it
    places before a capture's start, minutes in (PERF.md section 7); the
    obs phase holds every captured region's hand-kernel rows to its
    launches, and a fit region's first rows are K4's.  Returns the
    phase's launches."""
    import torch

    torch.cuda.empty_cache()
    r = subprocess.run([sys.executable, "-c", OBS_WORKER, root, work, small],
                       capture_output=True, text=True, cwd=root,
                       env=dict(os.environ, PYTHONPATH=root), timeout=900)
    lines = r.stdout.strip().splitlines()
    for ln in lines[:-1] if r.returncode == 0 else lines:
        print(ln, flush=True)
    if r.returncode != 0:
        raise AssertionError("the obs phase's process exited %d: %s"
                             % (r.returncode, r.stderr[-3000:]))
    return json.loads(lines[-1])


def phase_obs_late(root, work, K, small):
    """A known-fault check of the obs layer, in this process after every
    other phase: pptoas on the 16-subint archive with PPTPU_OBS_DIR and
    PPTPU_TRACE_DIR.  So late in a process torch.profiler may lose a
    region's first rows (PERF.md section 7); whether it did or not, each
    devtime event must say so truly (obs_completeness_problems).  Emits
    each region's completeness and lost rows."""
    gm = os.path.join(root, "examples", "example.gmodel")
    sub = os.path.join(work, "obs_late")
    regions = []
    with environ(PPTPU_OBS_DIR=sub,
                 PPTPU_TRACE_DIR=os.path.join(work, "trace_late")), \
            counted_captures(K, regions):
        toas, wall, launches = run_cli(K, [
            "-d", small, "-m", gm, "--no_bary", "--quiet",
            "-o", os.path.join(work, "obs_late.tim")])
    run = obs_run_dir(sub)
    events = [e for e in obs_events(run) if e["kind"] == "devtime"]
    problems = [] if len(events) == len(regions) and regions else [
        "%d devtime events for %d captured regions" % (len(events),
                                                       len(regions))]
    rows = []
    for e, reg in zip(events, regions):
        counts = trace_kernel_counts(K, e["trace"])
        problems += obs_completeness_problems(e["region"], e, counts, reg)
        rows.append(dict(region=e["region"], complete=e.get("complete"),
                         lost_rows=e.get("lost_rows"),
                         kernel_rows=e.get("kernel_rows"),
                         launches=reg["launches"],
                         device_total_s=e["device_total_s"],
                         wall_s=reg["wall_s"]))
    with open(os.path.join(run, "manifest.json")) as f:
        counters = json.load(f).get("counters", {})
    incomplete = sum(1 for r in rows if r["complete"] is False)
    if int(counters.get("devtime_incomplete", 0)) != incomplete:
        problems.append("devtime_incomplete %s for %d incomplete regions"
                        % (counters.get("devtime_incomplete"), incomplete))
    emit("obs_late", n_toas=len(toas), cli_s=wall, launches=launches,
         regions=rows, incomplete_regions=incomplete, problems=problems)
    if problems or len(toas) != 16:
        raise AssertionError("obs_late: %d TOAs; %s"
                             % (len(toas), "; ".join(problems)))


def obs_reports(root, run_dirs):
    """{run dir: (exit code, report text)} of tools/obs_report.py, one
    subprocess for all of them (exit code None where none was printed)."""
    proc = subprocess.run(
        [sys.executable, "-c", OBS_REPORT % (
            root, os.path.join(root, "tools", "obs_report.py"),
            OBS_REPORT_RC)] + list(run_dirs),
        capture_output=True, text=True, timeout=600, cwd=root)
    out, text = {}, []
    for ln in proc.stdout.splitlines():
        tok = ln.split()
        if ln.startswith(OBS_REPORT_RC) and len(tok) >= 2:
            out[tok[-2]] = (int(tok[-1]), "\n".join(text))
            text = []
        else:
            text.append(ln)
    for rd in run_dirs:
        out.setdefault(rd, (None, "\n".join(text) + proc.stderr[-2000:]))
    return out


def obs_run_dir(base):
    """The one run directory under an obs base directory."""
    runs = [os.path.join(base, d) for d in sorted(os.listdir(base))]
    if len(runs) != 1:
        raise AssertionError("%d obs runs under %s, want 1" % (len(runs),
                                                                base))
    return runs[0]


def obs_events(run_dir):
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@contextlib.contextmanager
def counted_captures(K, regions):
    """Record, per obs.trace_capture region, the wall of its body and the
    rise of every launch count over it (appended to ``regions``)."""
    from pulseportraiture_tpu_torch import obs

    capture = obs.trace_capture

    @contextlib.contextmanager
    def counted(name, base_dir=None):
        with capture(name, base_dir=base_dir) as path:
            before = dict(K.LAUNCHES)
            t0 = time.perf_counter()
            yield path
            regions.append(dict(
                region=name, wall_s=time.perf_counter() - t0,
                launches={k: K.LAUNCHES[k] - before[k] for k in before}))

    obs.trace_capture = counted
    try:
        yield
    finally:
        obs.trace_capture = capture


def trace_kernel_counts(K, trace):
    """{kernel name: its rows in a Chrome trace} for the hand kernels."""
    from pulseportraiture_tpu_torch.obs import devtime

    rows = [e["name"] for e in devtime.parse_chrome_trace(trace)
            if e["cat"] == "kernel"]
    return {name: sum(1 for r in rows if fn in r)
            for name, fn in K.TRACE_NAMES.items()}


def obs_completeness_problems(key, event, counts, region):
    """Where the devtime ``event`` of a captured ``region``
    (counted_captures) misstates its own completeness: its kernel rows
    against ``counts`` (trace_kernel_counts), its launches against the
    region's, ``complete`` and ``lost_rows`` against the two."""
    launched = region["launches"]
    want = dict(kernel_rows=counts, kernel_launches=launched,
                complete=counts == launched,
                lost_rows=sum(max(0, n - counts[k])
                              for k, n in launched.items()))
    return ["%s: devtime %s %s, the trace %s" % (key, field, event.get(
        field), value) for field, value in want.items()
        if event.get(field) != value]


@contextlib.contextmanager
def environ(**kw):
    """Set (str) or unset (None) environment variables for a block."""
    saved = {k: os.environ.get(k) for k in kw}
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_obs(root, work, K, dev, small, fit_shape=(1000, 512, 2048)):
    """The observability layer on the card: pptoas on the 16-subint
    archive with PPTPU_OBS_DIR and PPTPU_TRACE_DIR (walls with obs on and
    off, in turns), then --fit_scat, then ppalign --niter 1 over two
    epochs (obs only), then the seeded throughput fit without errs
    captured inside an obs run (its time with obs on and off), then a
    PPTPU_FAULTS run.  Run in a process of its own (phase_obs_fresh).
    Checks every run directory, one devtime event per captured fit region
    (device total > 0 and within the region's wall), each hand kernel's
    rows in the traces against its launches over the region, the pp_*
    stages, pps_device_peak_bytes against max_memory_allocated, the
    manifest's platform, tools/obs_report.py and the injected fault.
    Returns the launches of its runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pulseportraiture_tpu_torch import obs
    from pulseportraiture_tpu_torch.cli import ppalign
    from pulseportraiture_tpu_torch.fit.portrait import (
        fit_portrait_full_batch, model_kmax)
    from pulseportraiture_tpu_torch.testing import faults

    gm = os.path.join(root, "examples", "example.gmodel")
    base = os.path.join(work, "obs")
    trace = os.path.join(work, "trace")
    argv = ["-d", small, "-m", gm, "--no_bary", "--print_phase", "--quiet"]
    # CUPTI's first start takes seconds: outside every timed region
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=dev).sum().item()
    launches = {name: 0 for name in K.LAUNCHES}
    step_s = {}  # seconds of each step of the phase
    t_step = time.perf_counter()

    def lap(step):
        nonlocal t_step
        now = time.perf_counter()
        step_s[step] = now - t_step
        t_step = now

    def add(run_launches):
        for k, v in run_launches.items():
            launches[k] += v

    # wideband: obs off / on / on / off (the first "on" is the run checked)
    walls = {"off": [], "on": []}
    regions, runs = [], {}
    peak = None
    for i, mode in enumerate(("off", "on", "on", "off")):
        tim = os.path.join(work, "obs_wb%d.tim" % i)
        on = mode == "on"
        sub = os.path.join(base, "wb%d" % i)
        with environ(PPTPU_OBS_DIR=sub if on else None,
                     PPTPU_TRACE_DIR=trace if on else None), \
                counted_captures(K, regions if i == 1 else []):
            torch.cuda.reset_peak_memory_stats()
            toas, wall, run_launches = run_cli(K, argv + ["-o", tim])
            if i == 1:
                peak = torch.cuda.max_memory_allocated()
        walls[mode].append(wall)
        add(run_launches)
        if len(toas) != 16:
            raise AssertionError("obs %s run: %d TOAs" % (mode, len(toas)))
        if on and i == 1:
            runs["pptoas"] = obs_run_dir(sub)
    n_wb = len(regions)
    lap("wideband_x4")
    # --fit_scat, obs and trace on
    sub = os.path.join(base, "scat")
    with environ(PPTPU_OBS_DIR=sub, PPTPU_TRACE_DIR=trace), \
            counted_captures(K, regions):
        toas, _, run_launches = run_cli(
            K, argv + ["--fit_scat", "-o", os.path.join(work, "obs_sc.tim")])
    add(run_launches)
    runs["pptoas_scat"] = obs_run_dir(sub)
    lap("fit_scat")
    # ppalign --niter 1 over two epochs, obs only
    meta = os.path.join(work, "obs_epochs.meta")
    with open(meta, "w") as f:
        f.write("\n".join(os.path.join(work, "epoch%d.fits" % i)
                          for i in range(2)) + "\n")
    sub = os.path.join(base, "align")
    with environ(PPTPU_OBS_DIR=sub, PPTPU_TRACE_DIR=None):
        _, run_launches = run_tool(K, ppalign, [
            "-M", meta, "-I", os.path.join(work, "tmpl.fits"),
            "-o", os.path.join(work, "obs_aligned.fits"), "--niter", "1"])
    add(run_launches)
    runs["ppalign"] = obs_run_dir(sub)
    lap("ppalign")

    # the seeded throughput fit (1000 x 512 x 2048), obs off and on; no
    # errs: the noise measured in the spectra pass (K4's second epilogue)
    nsub, nchan, nbin = fit_shape
    data, freqs, _, _, _, model, _, _, _ = north_star_data(dev, 0, nsub,
                                                            nchan, nbin)
    kmax = model_kmax(model)

    def fit():
        out = fit_portrait_full_batch(
            data, model, None, P0, freqs, fit_flags=(1, 1, 0, 0, 0),
            log10_tau=False, max_iter=30, kmax=kmax, device=dev)
        torch.cuda.synchronize()
        return out

    fit()  # warm
    # the fit's seconds with obs off, and under the capture (the capture's
    # own start, stop, export and ingestion in capture_s)
    fit_s = {"off": [], "on": [], "capture_s": []}
    sub = os.path.join(base, "throughput")
    for mode in ("off", "on", "off"):
        K.reset_launches()
        if mode == "on":
            with environ(PPTPU_OBS_DIR=sub, PPTPU_TRACE_DIR=trace), \
                    counted_captures(K, regions), obs.run("throughput"):
                t0 = time.perf_counter()
                with obs.trace_capture("throughput"):
                    fit()
                fit_s["capture_s"].append(time.perf_counter() - t0)
                fit_s["on"].append(regions[-1]["wall_s"])
        else:
            t0 = time.perf_counter()
            fit()
            fit_s["off"].append(time.perf_counter() - t0)
        add(dict(K.LAUNCHES))
    runs["throughput"] = obs_run_dir(sub)
    del data, model
    lap("throughput")

    # every run directory, its manifest and its devtime events
    name = torch.cuda.get_device_name(0)
    devtimes, problems = [], []
    for key, rd in runs.items():
        for f in ("events.jsonl", "manifest.json"):
            if not os.path.isfile(os.path.join(rd, f)):
                problems.append("%s: no %s" % (key, f))
        with open(os.path.join(rd, "manifest.json")) as f:
            man = json.load(f)
        if man.get("platform") != "gpu" or man.get("device_kind") != name:
            problems.append("%s: manifest says %s / %s" % (
                key, man.get("platform"), man.get("device_kind")))
        devtimes += [(key, e) for e in obs_events(rd)
                     if e["kind"] == "devtime"]
    if len(devtimes) != len(regions):
        problems.append("%d devtime events for %d captured regions"
                        % (len(devtimes), len(regions)))
    rows, stages = [], {}
    for (key, e), reg in zip(devtimes, regions):
        counts = trace_kernel_counts(K, e["trace"])
        rows.append(dict(run=key, region=e["region"],
                         device_total_s=e["device_total_s"],
                         unattributed_s=e["unattributed_s"],
                         wall_s=reg["wall_s"], scopes=e["scopes"],
                         phases=e["phases"], n_ops=e["n_ops"],
                         trace_kernel_rows=counts,
                         launches=reg["launches"]))
        stages.setdefault(key, set()).update(
            seg for path in e["scopes"] for seg in path.split("/"))
        if not 0 < e["device_total_s"] <= reg["wall_s"]:
            problems.append("%s: device %.6f s against a %.6f s region"
                            % (key, e["device_total_s"], reg["wall_s"]))
        if counts != reg["launches"]:
            problems.append("%s: kernel rows %s, launches %s"
                            % (key, counts, reg["launches"]))
        problems += obs_completeness_problems(key, e, counts, reg)
    # the captures are fit regions: every fit kernel shows in one; the
    # load's (K5-K7) run before them, and no captured path smooths (K8),
    # fits a Gaussian model (K9, K10), measures the "fit" noise (K11) or
    # makes synthetic data (K12)
    seen = {k: sum(r["trace_kernel_rows"][k] for r in rows)
            for k in K.TRACE_NAMES
            if k not in LOAD_NAMES + SMOOTH_KERNELS + K9_NAMES + K10_NAMES
            + ("noise_fit", "synth_rows")}
    if not all(seen.values()):
        problems.append("kernels absent from every trace: %s" % seen)
    all_stages = set().union(*stages.values()) if stages else set()
    if not {"pp_seed", "pp_solve"} <= all_stages or \
            "pp_scatter" not in stages.get("pptoas_scat", ()):
        problems.append("stages %s" % {k: sorted(v)
                                       for k, v in stages.items()})

    # the allocator's peak, read by the obs gauge and by the caller
    with open(os.path.join(runs["pptoas"], "metrics.jsonl")) as f:
        gauges = json.loads(f.read().splitlines()[-1])["gauges"]
    gauge_peak = gauges.get("pps_device_peak_bytes")
    if gauge_peak != peak:
        problems.append("pps_device_peak_bytes %s, max_memory_allocated %s"
                        % (gauge_peak, peak))

    lap("checks")
    # tools/obs_report.py on every run
    report = {}
    done = obs_reports(root, list(runs.values()))
    for key, rd in runs.items():
        rc, text = done[rd]
        report[key] = [rc] + [ln for ln in text.splitlines()
                              if ln.startswith("## ")]
        if rc != 0:
            problems.append("obs_report %s exited %s: %s" % (key, rc,
                                                              text[-500:]))
    lap("obs_report")

    # an injected dispatch fault raises the port's InjectedFault
    fault = None
    faults.reset()
    try:
        with environ(PPTPU_FAULTS="site:dispatch@nth=1"):
            run_cli(K, argv + ["-o", os.path.join(work, "obs_fault.tim")])
    except faults.InjectedFault as e:
        fault = dict(error=str(e), fired=[
            (r["site"], os.path.basename(str(r["key"])), r["action"])
            for r in faults.fired()])
    finally:
        faults.reset()
    if fault is None or fault["fired"] != [
            ("dispatch", os.path.basename(small), "fail")]:
        problems.append("dispatch fault: %s" % fault)
    lap("fault")

    emit("obs", runs={k: os.path.basename(v) for k, v in runs.items()},
         wideband_wall_s=walls, throughput_fit_s=fit_s,
         wideband_overhead=min(walls["on"]) / min(walls["off"]) - 1.0,
         throughput_overhead=min(fit_s["on"]) / min(fit_s["off"]) - 1.0,
         regions=rows, stages={k: sorted(v) for k, v in stages.items()},
         pps_device_peak_bytes=gauge_peak, max_memory_allocated=peak,
         obs_report=report, fault=fault, step_s=step_s, problems=problems)
    if problems:
        raise AssertionError("obs: " + "; ".join(problems))
    return launches


# -- the survey runner (ppsurvey) ------------------------------------------

SURVEY_CANON = 8           # archives of the canonical 16 x 512 x 2048 shape
SURVEY_SHAPES = [(16, 512, 2048)] * SURVEY_CANON + [(16, 500, 2000)] * 2 \
    + [(16, 256, 1024)] * 2
SURVEY_CHAIN = (4, 512, 2048)  # the zap -> align -> toas chain's archives


def survey_inputs(root, work):
    """The survey's archives, written by the port's make_fake_pulsar
    (noise 0.5, own seeds, phase in +-0.3 rot, dDM in +-3e-3): 8 of 16 x
    512 x 2048, 2 of 16 x 500 x 2000 (padded into the 512 x 2048 bucket),
    2 of 16 x 256 x 1024 (a second bucket) and one truncated file; their
    metafile; the chain's 4 x 512 x 2048 archives and its noiseless
    template.  Returns a dict of paths."""
    import numpy as np

    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar

    gm = os.path.join(root, "examples", "example.gmodel")
    par = os.path.join(root, "examples", "example.par")
    rng = np.random.default_rng(4096)
    files = []
    for i, (nsub, nchan, nbin) in enumerate(SURVEY_SHAPES):
        files.append(make_fake_pulsar(
            gm, par, os.path.join(work, "survey%02d.fits" % i), nsub=nsub,
            nchan=nchan, nbin=nbin, nu0=NU0, bw=800.0, tsub=60.0,
            phase=float(rng.uniform(-0.3, 0.3)),
            dDM=float(rng.uniform(-3e-3, 3e-3)), noise_stds=0.5,
            seed=900 + i))
    bad = os.path.join(work, "truncated.fits")
    with open(files[0], "rb") as f:
        head = f.read(10000)              # cut inside the SUBINT header
    with open(bad, "wb") as f:
        f.write(head)
    meta = os.path.join(work, "survey.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files + [bad]) + "\n")
    nsub, nchan, nbin = SURVEY_CHAIN
    chain = [make_fake_pulsar(
        gm, par, os.path.join(work, "chain%d.fits" % i), nsub=nsub,
        nchan=nchan, nbin=nbin, nu0=NU0, bw=800.0, tsub=60.0,
        phase=float(rng.uniform(-0.3, 0.3)),
        dDM=float(rng.uniform(-3e-3, 3e-3)), noise_stds=0.5, seed=950 + i)
        for i in range(4)]
    tmpl = make_fake_pulsar(gm, par, os.path.join(work, "chain_tmpl.fits"),
                            nsub=1, nchan=nchan, nbin=nbin, nu0=NU0,
                            bw=800.0, tsub=60.0, noise_stds=0.0,
                            dedispersed=True, seed=0)
    chain_meta = os.path.join(work, "chain.meta")
    with open(chain_meta, "w") as f:
        f.write("\n".join(chain) + "\n")
    return dict(gm=gm, par=par, files=files, bad=bad, meta=meta,
                chain=chain, chain_meta=chain_meta, tmpl=tmpl)


def survey_cli(K, argv):
    """The port's ppsurvey CLI in this process with every launch count set
    to 0 just before it: (exit code, wall s, launches, its JSON output)."""
    import io

    from pulseportraiture_tpu_torch.cli import ppsurvey

    buf = io.StringIO()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ppsurvey.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    out = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if rc != 0:
        raise AssertionError("ppsurvey %s exited %d: %s"
                             % (" ".join(argv), rc, buf.getvalue()[-2000:]))
    return wall, launches, json.loads(out[-1]) if out else None


def survey_subprocess(root, argv, timeout=600):
    """``python -m pulseportraiture_tpu_torch.cli.ppsurvey argv`` in a new
    process: (wall s, its last JSON line)."""
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pulseportraiture_tpu_torch.cli.ppsurvey"]
        + argv, capture_output=True, text=True, timeout=timeout, cwd=root,
        env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("ppsurvey %s exited %d: %s" % (
            " ".join(argv), proc.returncode, proc.stderr[-3000:]))
    out = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return wall, json.loads(out[-1])


def survey_ledger(wd):
    """Every ledger record of a workdir (all shards)."""
    recs = []
    for name in sorted(os.listdir(wd)):
        if name.startswith("ledger.") and name.endswith(".jsonl"):
            with open(os.path.join(wd, name)) as fh:
                recs.extend(json.loads(ln) for ln in fh if ln.strip())
    return recs


def survey_toas(wd):
    """{archive: [TOA line tokens]} over every toas.*.tim of a workdir,
    and {archive: number of C pp_done blocks}."""
    toas, blocks = {}, {}
    for name in sorted(os.listdir(wd)):
        if not (name.startswith("toas.") and name.endswith(".tim")):
            continue
        for ln in open(os.path.join(wd, name)):
            tok = ln.split()
            if not tok or tok[0] == "FORMAT":
                continue
            if tok[:2] == ["C", "pp_done"]:
                blocks[tok[2]] = blocks.get(tok[2], 0) + 1
            elif tok[0] != "C":
                toas.setdefault(tok[0], []).append(tok)
    return toas, blocks


def survey_exactly_once(wd, good, bad=None, workload="toas", nsub=None):
    """Every good archive done once on the ledger (and, for toas, one
    checkpoint block of ``nsub`` TOAs); ``bad`` quarantined with a
    reason.  Raises otherwise; returns the quarantine reason."""
    done = {}
    for r in survey_ledger(wd):
        if r.get("workload", "toas") == workload and r["state"] == "done":
            done[r["archive"]] = done.get(r["archive"], 0) + 1
    want = {os.path.realpath(f): 1 for f in good}
    if done != want:
        raise AssertionError("%s: %s done records %s, want one each of %s"
                             % (wd, workload, done, sorted(want)))
    if workload == "toas":
        toas, blocks = survey_toas(wd)
        if blocks != {f: 1 for f in good}:
            raise AssertionError("%s: checkpoint blocks %s" % (wd, blocks))
        if nsub is not None and any(len(toas.get(f, ())) != nsub
                                    for f in good):
            raise AssertionError("%s: TOA lines per archive %s" % (
                wd, {f: len(v) for f, v in toas.items()}))
    if bad is None:
        return None
    from pulseportraiture_tpu_torch.runner.queue import WorkQueue

    q = WorkQueue(None, readonly=True, union_dir=wd, workload=workload)
    try:
        quarantined = dict(q.quarantined())
    finally:
        q.close()
    reason = quarantined.get(bad)
    if not reason or list(quarantined) != [bad]:
        raise AssertionError("%s: quarantined %s, want only %s with a "
                             "reason" % (wd, quarantined, bad))
    return reason


def survey_split(wd):
    """The survey run's seconds from its obs run (the one run under
    <wd>/obs): load (the GetTOAs load spans, or the prefetch worker's
    prefetch_load spans), fit (guess + solve + polish), write (.tim and
    checkpoint), the runner's per-archive fit span, each bucket's
    archive spans (claim to checkpoint; they overlap under prefetch),
    and the device busy seconds the bucket traces attributed
    (device_total_s; None without --trace-bucket, or where a bucket's
    capture lost rows: then device_busy_s_undercount, with the count of
    such captures)."""
    (run,) = [os.path.join(wd, "obs", d) for d in
              sorted(os.listdir(os.path.join(wd, "obs")))]
    tot, buckets = {}, {}
    for ln in open(os.path.join(run, "events.jsonl")):
        e = json.loads(ln)
        if e.get("kind") == "span":
            tot[e["name"]] = tot.get(e["name"], 0.0) + e.get("dur_s", 0.0)
            if e["name"] == "archive":
                b = buckets.setdefault(e.get("bucket"), [0, 0.0])
                b[0] += 1
                b[1] += e.get("dur_s", 0.0)
    man = json.load(open(os.path.join(run, "manifest.json")))
    gauges = man.get("gauges") or {}
    lost = gauges.get("device_total_incomplete_regions")
    return dict(load_s=tot.get("load", 0.0) + tot.get("prefetch_load", 0.0),
                prefetch_load_s=tot.get("prefetch_load", 0.0),
                fit_s=sum(tot.get(k, 0.0) for k in ("guess", "solve",
                                                    "polish")),
                write_s=tot.get("write", 0.0),
                archive_fit_span_s=tot.get("fit", 0.0),
                archive_s_by_bucket={k: dict(archives=n, archive_s=t)
                                     for k, (n, t) in buckets.items()},
                device_busy_s=None if lost else gauges.get("device_total_s"),
                device_busy_s_undercount=gauges.get("device_total_s")
                if lost else None,
                device_busy_incomplete_regions=lost,
                device_utilization=None if lost
                else gauges.get("device_utilization"))


def survey_tim_gap_ns(a, b):
    """Largest MJD difference [ns] between two lists of TOA tokens."""
    if len(a) != len(b):
        raise AssertionError("%d against %d TOAs" % (len(a), len(b)))
    out = 0.0
    for x, y in zip(a, b):
        dx, fx = x[2].split(".")
        dy, fy = y[2].split(".")
        out = max(out, abs((int(dx) - int(dy)) + float("0." + fx)
                           - float("0." + fy)) * 86400e9)
    return out


def survey_padding_gap(pad, nat, P):
    """The reference's padding bar on TOA lines: the padded fit's TOA,
    moved to the native fit's reference frequency with its own DM,
    against the native TOA in units of the native TOA error (max |z|),
    and the largest DM difference."""
    from pulseportraiture_tpu_torch.config import Dconst

    if len(pad) != len(nat):
        raise AssertionError("%d against %d TOAs" % (len(pad), len(nat)))
    zmax = dmax = 0.0
    for p, n in zip(pad, nat):
        fp = dict(zip(p[5::2], p[6::2]))
        fn = dict(zip(n[5::2], n[6::2]))
        dp, xp = p[2].split(".")
        dn, xn = n[2].split(".")
        dt = ((int(dp) - int(dn)) + float("0." + xp)
              - float("0." + xn)) * 86400.0
        dm_p = float(fp["-pp_dm"])
        dt += Dconst * dm_p * (float(n[1]) ** -2 - float(p[1]) ** -2)
        dphi = (dt / P + 0.5) % 1.0 - 0.5
        zmax = max(zmax, abs(dphi) / (float(n[3]) * 1e-6 / P))
        dmax = max(dmax, abs(dm_p - float(fn["-pp_dm"])))
    return zmax, dmax


@contextlib.contextmanager
def survey_toa_objects():
    """The TOA objects (full precision) the GetTOAs.get_TOAs calls in the
    block made, the survey's bucketed driver's included: {archive: [TOA]}."""
    from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs

    made = {}
    orig = GetTOAs.get_TOAs

    def get_TOAs(self, *a, **kw):
        n0 = len(self.TOA_list)
        try:
            return orig(self, *a, **kw)
        finally:
            for t in self.TOA_list[n0:]:
                made.setdefault(t.archive, []).append(t)

    GetTOAs.get_TOAs = get_TOAs
    try:
        yield made
    finally:
        GetTOAs.get_TOAs = orig


def survey_result_gaps(a, b):
    """Two runs' TOA objects of one archive: the largest MJD difference
    [ns] and {field: largest relative difference} over the TOA error, DM,
    DM error and every float flag (a NaN against a number counts inf)."""
    if len(a) != len(b):
        raise AssertionError("%d against %d TOAs" % (len(a), len(b)))
    mjd_ns, rel = 0.0, {}

    def gap(key, x, y):
        if x is None and y is None or x != x and y != y:
            d = 0.0
        elif x is None or y is None or x != x or y != y:
            d = math.inf
        else:
            d = abs(x - y) / max(abs(x), abs(y), 1e-300)
        rel[key] = max(rel.get(key, 0.0), d)

    for x, y in zip(a, b):
        mjd_ns = max(mjd_ns, abs(x.MJD - y.MJD) * 1e9)
        for key in ("TOA_error", "DM", "DM_error"):
            gap(key, getattr(x, key), getattr(y, key))
        for key, v in x.flags.items():
            if isinstance(v, float):
                gap(key, v, y.flags.get(key))
    return mjd_ns, rel


def survey_column_gaps(a, b):
    """Largest differences of the printed TOA error [us], -pp_dm and
    -pp_dme between two lists of TOA tokens."""
    if len(a) != len(b):
        raise AssertionError("%d against %d TOAs" % (len(a), len(b)))
    out = dict(err_us=0.0, pp_dm=0.0, pp_dme=0.0)
    for x, y in zip(a, b):
        fx, fy = dict(zip(x[5::2], x[6::2])), dict(zip(y[5::2], y[6::2]))
        out["err_us"] = max(out["err_us"], abs(float(x[3]) - float(y[3])))
        for key in ("pp_dm", "pp_dme"):
            out[key] = max(out[key], abs(float(fx["-" + key])
                                         - float(fy["-" + key])))
    return out


def phase_survey(root, work, K, device="cuda"):
    """The survey runner (ppsurvey) at full width: plan and warm (a fresh
    kernel build directory, in its own process); run with --prefetch 2
    untraced (walls, the load / fit / write split), then with
    --trace-bucket (device busy); run
    --max_archives 4 --prefetch 0 (serial loads) then resume; --fit_scat on four archives of the 512
    x 2048 bucket (K3); supervise with two worker processes sharing the
    card; the zap -> align -> toas chain at 4 subints.  Every good
    archive done once per workdir, the truncated one quarantined with a
    reason; the padded archives' TOAs flagged -pp_grid 512x2048 and no
    other's; each canonical archive's TOAs equal to the port's pptoas
    (MJD within 1 ns, the printed error and DM columns within one printed
    unit), each padded one within the reference's padding bar (5 sigma,
    DM 5e-4); one archive's survey through the plain versions, without
    and with --fit_scat, within 1 ns and 1e-9 (1e-6 with --fit_scat)
    relative on every other number; K1, K2 and K3 held against their plain versions on the
    inputs the main and --fit_scat runs gave them at each shape.
    Returns the survey path's launches (the main run's and the
    --fit_scat run's) and what the serve phase reuses (the archives,
    pptoas's TOAs of the 512 x 2048 bucket, the kernel build directory).
    ``device`` "cpu" rehearses the phase at a small ``SURVEY_SHAPES`` on
    the CPU (no kernel builds there)."""
    from pulseportraiture_tpu_torch.cli import pptoas
    from pulseportraiture_tpu_torch.io.parfile import read_par
    from pulseportraiture_tpu_torch.runner.execute import run_survey
    from pulseportraiture_tpu_torch.runner.plan import (canonical_shape,
                                                        plan_survey)
    from pulseportraiture_tpu_torch.runner.warm import program_specs

    t_phase = time.perf_counter()
    work = os.path.join(work, "survey")
    os.makedirs(work)
    t0 = time.perf_counter()
    inp = survey_inputs(root, work)
    make_s = time.perf_counter() - t0
    gm, files, bad = inp["gm"], inp["files"], inp["bad"]
    canon = files[:SURVEY_CANON]
    padded = files[SURVEY_CANON:SURVEY_CANON + 2]
    bucket512 = files[:SURVEY_CANON + 2]       # the 512 x 2048 bucket
    nsub = SURVEY_SHAPES[0][0]

    def wd(name):
        return os.path.join(work, name)

    def plan(name, meta=inp["meta"], model=gm):
        return survey_cli(K, ["plan", "-d", meta, "-m", model,
                              "-w", wd(name)])[2]

    out = {}
    want = {}
    for _, nchan, nbin in SURVEY_SHAPES:
        key = "%dx%d" % canonical_shape(nchan, nbin)
        want[key] = want.get(key, 0) + 1
    p = plan("warm")
    if p["n_archives"] != len(files) or p["unreadable"] != 1 \
            or p["buckets"] != want:
        raise AssertionError("plan: %s, want buckets %s" % (p, want))
    out["plan"] = p
    # warm on a fresh kernel build directory, in a process of its own
    # (nvcc runs there); the serve phase's ppserve daemon warms on the
    # primed directory (no build, a hit per kernel)
    kdir = os.path.join(work, "kernels")
    wall, w = survey_subprocess(root, ["warm", "-w", wd("warm"),
                                       "--no_bary", "--compile-cache",
                                       kdir, "--device", device, "--quiet"])
    warm = dict(fresh=dict(w, process_s=wall))
    progs = [e for d in sorted(os.listdir(os.path.join(wd("warm"), "obs")))
             for e in map(json.loads, open(os.path.join(
                 wd("warm"), "obs", d, "events.jsonl")))
             if e.get("name") == "warm_program"]
    n_specs = len(program_specs(os.path.join(wd("warm"), "plan.json")))
    if len(progs) != n_specs or not all(e["ok"] for e in progs):
        raise AssertionError("warm programs: %s" % progs)
    if device == "cuda" and \
            warm["fresh"]["backend_compiles"] != len(K.SOURCES):
        raise AssertionError("warm did not build the kernels: %s" % warm)
    out["warm"] = warm

    # the survey with --prefetch 2 untraced (the wall, the load / fit /
    # write split), then again with --trace-bucket (device busy; the
    # capture's own cost against the untraced run).  The untraced run is
    # the main path's: its launches, each kernel's first inputs at each
    # shape it was given (both buckets), and its TOAs at full precision.
    # (One depth: --prefetch 0 and 2 ran 0.99-1.00x of each other,
    # load-bound; the serial branch runs in the --max_archives pass.)
    runs = {}
    for depth, traced in ((2, False), (2, True)):
        name = "prefetch%d%s" % (depth, "_traced" if traced else "")
        plan(name)
        argv = ["run", "-w", wd(name), "--no_bary", "--prefetch",
                str(depth), "--device", device, "--quiet"] + (
                    ["--trace-bucket"] if traced else [])
        if name == "prefetch2":
            with first_kernel_inputs(K, toa_path_kernels(K), True) \
                    as seen, survey_toa_objects() as main_objs:
                wall, launches, res = survey_cli(K, argv)
        else:
            wall, launches, res = survey_cli(K, argv)
        reason = survey_exactly_once(wd(name), files, bad, nsub=nsub)
        runs[name] = dict(wall_s=wall, launches=launches,
                          counts=res["counts"], quarantine_reason=reason,
                          **survey_split(wd(name)))
        runs[name]["toas_per_s"] = len(files) * nsub / wall
    # once more under torch.profiler: the run's copies to the card (the
    # padded archives' host cubes go up from pageable memory, the others'
    # stored columns pinned) and its peak device memory (the load's cubes
    # held by the prefetch tickets and the fit)
    profiled = None
    if device == "cuda":
        plan("prefetch2_profiled")
        argv = ["run", "-w", wd("prefetch2_profiled"), "--no_bary",
                "--prefetch", "2", "--device", device, "--quiet"]
        K.reset_launches()
        _, prof = kernel_device_ms(lambda: survey_cli(K, argv), K,
                                   copies=True)
        survey_exactly_once(wd("prefetch2_profiled"), files, bad, nsub=nsub)
        profiled = dict(wall_s=prof["wall_s"], h2d=prof["h2d"],
                        peak_bytes=prof["peak_bytes"],
                        device_busy_s=prof["device_busy_s"])
    main_launches = runs["prefetch2"]["launches"]
    missing = [n for n in PHASE_DM_KERNELS + LOAD_PATH_KERNELS
               if main_launches[n] == 0]
    if missing:
        raise AssertionError("kernels never launched on the survey: %s"
                             % missing)
    path_rows = path_kernels_vs_plain(
        K, seen, required=PHASE_DM_KERNELS + LOAD_PATH_KERNELS)
    # both buckets' widths reached K1 (nchan) and K2 (nharm)
    widths = {name: sorted({key[1][1] for key in seen if key[0] == name})
              for name in ("moments", "fftfit")}
    buckets = {canonical_shape(c, b) for _, c, b in SURVEY_SHAPES}
    want_w = dict(moments=sorted({c for c, _ in buckets}),
                  fftfit=sorted({b // 2 + 1 for _, b in buckets}))
    if widths != want_w:
        raise AssertionError("kernels compared at widths %s, want %s"
                             % (widths, want_w))
    main_toas, _ = survey_toas(wd("prefetch2"))
    cols = {}

    def same_toas(tag, other, names):
        """MJDs within 1 ns and the printed error/DM columns within one
        printed unit of the main run's; returns the largest MJD gap."""
        gap = max(survey_tim_gap_ns(main_toas[f], other[f]) for f in names)
        c = {k: max(v) for k, v in zip(("err_us", "pp_dm", "pp_dme"), zip(
            *(survey_column_gaps(main_toas[f], other[f]).values()
              for f in names)))}
        cols[tag] = c
        if not (gap < 1.0 and c["err_us"] <= 1.0005e-3
                and c["pp_dm"] <= 1.0005e-7 and c["pp_dme"] <= 1.0005e-7):
            raise AssertionError("%s TOAs differ from the main run's: "
                                 "%.3g ns, %s" % (tag, gap, c))
        return gap

    prefetch_gap = max(same_toas(name, survey_toas(wd(name))[0], files)
                       for name in runs)
    # the padded archives were fit on the 512 x 2048 grid, the others
    # at their own (canonical) shape
    grid = {f: sorted({dict(zip(t[5::2], t[6::2])).get("-pp_grid")
                       for t in main_toas[f]}) for f in files}
    pad_grid = [grid[f] for f in padded]
    want_grid = "%dx%d" % canonical_shape(*SURVEY_SHAPES[SURVEY_CANON][1:])
    if any(g != [want_grid] for g in pad_grid) \
            or any(grid[f] != [None] for f in files if f not in padded):
        raise AssertionError("-pp_grid flags: %s" % grid)

    # the port's pptoas on the 512 x 2048 bucket's archives, natively
    meta512 = os.path.join(work, "bucket512.meta")
    with open(meta512, "w") as f:
        f.write("\n".join(bucket512) + "\n")
    tim = os.path.join(work, "pptoas.tim")
    K.reset_launches()
    if pptoas.main(["-d", meta512, "-m", gm, "--no_bary", "--quiet",
                    "--device", device, "-o", tim]) != 0:
        raise AssertionError("pptoas on the survey archives failed")
    native = {}
    for ln in open(tim):
        tok = ln.split()
        if tok and tok[0] not in ("FORMAT", "C"):
            native.setdefault(tok[0], []).append(tok)
    canon_gap = same_toas("pptoas", native, canon)
    P = 1.0 / float(read_par(inp["par"]).F0)
    pad_gap = [survey_padding_gap(main_toas[f], native[f], P)
               for f in padded]
    if not all(z < 5.0 and d < 5e-4 for z, d in pad_gap):
        raise AssertionError("padded archives off the padding bar "
                             "(max |z|, max |dDM|): %s" % pad_gap)

    # stop after 4 archives (both of the small bucket, 2 of the large
    # one), then resume the rest: 6 archives and the truncated file.  The
    # first pass loads serially (--prefetch 0: run_survey's serial load
    # branch on the card), the resume with the default prefetch
    resumed = canon[:4] + files[-2:]
    meta_resume = os.path.join(work, "resume.meta")
    with open(meta_resume, "w") as f:
        f.write("\n".join(resumed + [bad]) + "\n")
    plan("resume", meta=meta_resume)
    w1, _, r1 = survey_cli(K, ["run", "-w", wd("resume"), "--no_bary",
                               "--max_archives", "4", "--prefetch", "0",
                               "--device", device, "--quiet"])
    w2, _, r2 = survey_cli(K, ["resume", "-w", wd("resume"), "--no_bary",
                               "--device", device, "--quiet"])
    if r1["counts"]["done"] != 4:
        raise AssertionError("--max_archives 4: %s" % r1["counts"])
    survey_exactly_once(wd("resume"), resumed, bad, nsub=nsub)
    resume_gap = same_toas("resume", survey_toas(wd("resume"))[0], resumed)

    # --fit_scat (K3) on four archives of the 512 x 2048 bucket, two of
    # them padded; K2's and K3's inputs at each shape, TOAs at full
    # precision
    scat_files = canon[:2] + padded
    meta_scat = os.path.join(work, "scat.meta")
    with open(meta_scat, "w") as f:
        f.write("\n".join(scat_files) + "\n")
    plan("scat", meta=meta_scat)
    with first_kernel_inputs(K, toa_path_kernels(K), True) \
            as seen_scat, survey_toa_objects() as scat_objs:
        ws, scat_launches, rs = survey_cli(K, [
            "run", "-w", wd("scat"), "--no_bary", "--fit_scat", "--device",
            device, "--quiet"])
    survey_exactly_once(wd("scat"), scat_files, nsub=nsub)
    if any(scat_launches[n] == 0 for n in SCAT_KERNELS):
        raise AssertionError("--fit_scat survey launches %s"
                             % scat_launches)
    scat_rows = path_kernels_vs_plain(K, seen_scat,
                                      required=SCAT_KERNELS)
    scat_toas, _ = survey_toas(wd("scat"))
    if not all("-scat_time" in t for f in scat_files for t in scat_toas[f]):
        raise AssertionError("--fit_scat TOAs without -scat_time")

    # one canonical archive's survey through the plain versions, without
    # and with --fit_scat, against the kernels' runs above at full
    # precision: MJD within 1 ns, the TOA error, DM, DM error and every
    # float flag within 1e-9 relative (1e-6 with --fit_scat: the
    # scattering fit stops at ftol 1e-12 of its chi2, which leaves its
    # parameters free by up to ~1e-3 of their errors, and K3's last-bit
    # differences from its plain version move them by ~1e-8 relative —
    # 8.7e-9 read on the H100; K3 itself is held to 1e-12 above)
    plain_gaps = {}
    for tag, kern_objs, kw, tol in (
            ("toas", main_objs, {}, 1e-9),
            ("fit_scat", scat_objs, dict(fit_scat=True), 1e-6)):
        with plain_kernels(K), survey_toa_objects() as objs:
            res = run_survey(plan_survey([canon[0]], modelfile=gm),
                             wd("plain_" + tag), process_index=0,
                             process_count=1, bary=False, device=device,
                             **kw)
        mjd_ns, rel = survey_result_gaps(kern_objs[canon[0]],
                                         objs[canon[0]])
        plain_gaps[tag] = dict(max_ns=mjd_ns, max_rel=max(rel.values()),
                               tol=tol, rel=rel)
        if res["counts"]["done"] != 1 or not (
                mjd_ns < 1.0 and max(rel.values()) <= tol):
            raise AssertionError("survey%s through the plain versions: %s, "
                                 "%s" % (" --" + tag if kw else "",
                                         res["counts"], plain_gaps[tag]))

    # two worker processes sharing the card
    plan("supervise")
    with environ(PYTHONPATH=root):
        wsup, _, sup = survey_cli(K, [
            "supervise", "-w", wd("supervise"), "--min-workers", "2",
            "--max-workers", "2", "--interval", "0.5",
            "--worker-arg=--no_bary", "--device", device, "--quiet"])
    survey_exactly_once(wd("supervise"), files, bad, nsub=nsub)
    if sup["outstanding"] != 0:
        raise AssertionError("supervise: %s" % sup)
    sup_gap = same_toas("supervise", survey_toas(wd("supervise"))[0], files)

    # the chain zap -> align -> toas in one workdir, 4 subints each
    plan("chain", meta=inp["chain_meta"])
    chain_s = {}
    for wl, extra in (("zap", ["--workload_opt", "all_subs=true"]),
                      ("align", ["-m", inp["tmpl"]]),
                      ("toas", ["--no_bary"])):
        argv = ["run", "-w", wd("chain"), "--device", device, "--quiet"]
        if wl != "toas":
            argv += ["--workload", wl]
        chain_s[wl] = survey_cli(K, argv + extra)[0]
        survey_exactly_once(wd("chain"), inp["chain"], workload=wl,
                            nsub=SURVEY_CHAIN[0] if wl == "toas" else None)
    if not os.path.isfile(os.path.join(wd("chain"), "aligned.fits")):
        raise AssertionError("the align pass wrote no aligned archive")

    launches = {n: main_launches[n] + scat_launches[n] for n in K.KERNELS}
    emit("survey", archives=len(files), shapes=sorted(set(
        "%dx%dx%d" % s for s in SURVEY_SHAPES)), make_s=make_s,
         plan=out["plan"], warm=warm, runs=runs, profiled=profiled,
         trace_cost_s=runs["prefetch2_traced"]["wall_s"]
         - runs["prefetch2"]["wall_s"],
         resume=dict(run_s=w1, resume_s=w2, done_first=r1["counts"]["done"]),
         scat=dict(archives=len(scat_files), wall_s=ws,
                   launches=scat_launches, counts=rs["counts"]),
         supervise=dict(wall_s=wsup, workers=sup.get("workers"),
                        counts=sup.get("counts")),
         chain_s=chain_s, survey_vs_pptoas_max_ns=canon_gap,
         padded_max_abs_z_and_ddm=pad_gap,
         pp_grid=dict(padded=pad_grid, others=sorted({
             str(grid[f]) for f in files if f not in padded})),
         plain_vs_kernel=plain_gaps, column_gaps=cols,
         prefetch_vs_serial_max_ns=prefetch_gap, resume_max_ns=resume_gap,
         supervise_max_ns=sup_gap,
         path_kernels_vs_plain=dict(main=path_rows, fit_scat=scat_rows),
         launches=launches, phase_s=time.perf_counter() - t_phase)
    # what the serve phase reuses: the archives, pptoas's TOAs of the
    # 512 x 2048 bucket and the primed kernel build directory
    return launches, dict(gm=gm, par=inp["par"], canon=canon,
                          small=files[-2:], native=native, kernel_dir=kdir,
                          main_wd=wd("prefetch2"))


SERVE_TENANTS = ("alice", "bob")
SERVE_LOAD = 40         # closed-loop requests on the 512 x 2048 bucket
SERVE_TRACED = 8        # the traced closed loop's requests (device busy)
SERVE_CONCURRENCY = 4   # pploadgen workers; the daemon's batch_max too
SERVE_WINDOW_S = 0.25   # the daemon's micro-batch window


def serve_pptoas(K, work, tag, files, gm, device, *extra):
    """The port's pptoas CLI in this process on ``files`` (not counted on
    any path): {archive: [TOA tokens]}."""
    from pulseportraiture_tpu_torch.cli import pptoas

    meta = os.path.join(work, tag + ".meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    tim = os.path.join(work, tag + ".tim")
    n0 = dict(K.LAUNCHES)
    if pptoas.main(["-d", meta, "-m", gm, "--no_bary", "--quiet",
                    "--device", device, "-o", tim] + list(extra)) != 0:
        raise AssertionError("pptoas %s failed" % tag)
    K.LAUNCHES.update(n0)
    out = {}
    for ln in open(tim):
        tok = ln.split()
        if tok and tok[0] not in ("FORMAT", "C"):
            out.setdefault(tok[0], []).append(tok)
    return out


def path_kernel_times(K, seen):
    """Each kernel on the inputs a path gave it (``first_kernel_inputs``
    with ``per_shape``): device ms by CUDA-graph replay, the plain
    version's by CUDA events, and the bound of the same work (the
    kernels phase's ``*_bound_ms``, the load phase's load_bound_ms).  The timing launches are not
    counted."""
    import torch

    plains = {name: getattr(K, name + "_plain") for name in K.KERNELS}
    n0 = dict(K.LAUNCHES)
    rows = {}
    for (name, _), (a, kw) in sorted(seen.items(), key=str):
        fn = getattr(K, name)
        ms = graph_ms(lambda: fn(*a, **kw))
        plain_ms = cuda_ms(lambda: plains[name](*a, **kw), reps=3, warm=1)
        shape = list(a[0].shape)
        if name in K4_NAMES:
            arg = k4_arguments(fn, a, kw).arguments
            bms, by = spectra_bound_ms(
                *shape, arg["kmax"], arg["mfft"].ndim == 3,
                arg.get("absm2_out") is not None, name == "spectra_noise")
        elif name == "fftfit":
            Ns, newton = a[4], a[5]
            shape.append(Ns)
            bms, by = fftfit_bound_ms(*shape[:2], Ns, newton)
        elif name in K9_NAMES:                  # lanes, and the data's shape
            shape = [shape[0]] + list(a[1].shape)
            bms, by = gauss_bound_ms(*shape, K.gauss_ngauss(a[0].shape[1]),
                                     name == "gauss_normal",
                                     k9_err_values(a[2]))
        elif name in K10_NAMES:
            shape = [shape[0]] + list(a[1].shape)
            bms, by = gauss_ft_bound_ms(
                *shape, K.gauss_ft_ngauss(a[0].shape[1], a[8]), a[8],
                name == "gauss_ft_normal")
        elif name in K1_NAMES:
            # the evaluated rows: all, or the lanes given
            bms, by = moments_bound_ms(a[1].shape[0], *shape[1:],
                                       grad_hess=name != "moments")
        elif name == "rotate":  # the rows of the broadcast, nharm wide
            lead = torch.broadcast_shapes(a[0].shape[:-1], a[1].shape)
            bms, by = load_bound_ms(name, math.prod(lead),
                                    2 * (shape[-1] - 1))
        elif name in LOAD_NAMES:
            bms, by = load_bound_ms(name, shape[0], shape[-1])
        else:
            bms, by = moments_scat_bound_ms(
                a[2].shape[0], *shape[1:], shared=a[1].shape[0] == 1,
                grad_hess=name == "moments_scat_grad_hess")
        rows["%s@%s" % (name, "x".join(map(str, shape)))] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            share_of_bound=bms / ms)
    torch.cuda.synchronize()
    K.LAUNCHES.update(n0)
    return rows


class _Marker:
    """Read a subprocess's stdout on a thread (so its pipe never fills)
    and wait for a line starting with ``mark``: the readiness markers
    PPSERVE_READY / PPROUTER_READY."""

    def __init__(self, proc, mark):
        import threading

        self.proc, self.mark, self.info = proc, mark, None
        self.lines = []
        self.ready = threading.Event()
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for ln in self.proc.stdout:
            self.lines.append(ln.rstrip("\n"))
            if self.info is None and ln.startswith(self.mark):
                self.info = json.loads(ln[len(self.mark):].strip())
                self.ready.set()

    def wait(self, timeout, log):
        t0 = time.time()
        while not self.ready.wait(0.5):
            if self.proc.poll() is not None or time.time() - t0 > timeout:
                tail = open(log).read()[-3000:] if os.path.exists(log) \
                    else ""
                raise AssertionError("no %s (exit %s): %s" % (
                    self.mark, self.proc.poll(), tail))
        return self.info


def serve_start(root, argv, log):
    """``python -m pulseportraiture_tpu_torch.cli.<argv>`` as a process
    of its own (stdout piped, stderr to ``log``)."""
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("PPTPU_FAULTS", None)
    with open(log, "w") as errf:
        return subprocess.Popen(
            [sys.executable, "-m", "pulseportraiture_tpu_torch.cli." + argv[0]]
            + argv[1:], stdout=subprocess.PIPE, stderr=errf, text=True,
            cwd=root, env=env)


def serve_stop(proc, timeout=300):
    """SIGTERM, then the exit code (a process still running at the
    timeout is killed and fails the phase)."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=60)
        raise AssertionError("%s did not drain in %d s" % (proc.args[2],
                                                          timeout))


def serve_tenant_toas(wd):
    """{archive: (tenant, [TOA tokens], checkpoint blocks)} over every
    tenant ledger of a daemon (or fleet) workdir; an archive found under
    two tenants or daemons fails."""
    out = {}
    for dirpath, _, names in os.walk(wd):
        if "toas.tim" not in names or \
                os.path.basename(os.path.dirname(dirpath)) != "tenants":
            continue
        toas, blocks = survey_toas(dirpath)
        for f in set(toas) | set(blocks):
            if f in out:
                raise AssertionError("%s served twice: %s and %s"
                                     % (f, out[f][0], dirpath))
            out[f] = (dirpath, toas.get(f, []), blocks.get(f, 0))
    return out


def serve_check_toas(served, source, native, nsub):
    """Every served archive once, ``nsub`` TOAs, within 1 ns of pptoas's
    on its source archive and the printed error and DM columns within
    one printed unit: the largest MJD gap [ns] and column gaps."""
    gap, cols = 0.0, dict(err_us=0.0, pp_dm=0.0, pp_dme=0.0)
    for f, (where, toas, blocks) in served.items():
        if blocks != 1 or len(toas) != nsub:
            raise AssertionError("%s: %d blocks, %d TOAs in %s"
                                 % (f, blocks, len(toas), where))
        ref = native[source[f]]
        gap = max(gap, survey_tim_gap_ns(toas, ref))
        for k, v in survey_column_gaps(toas, ref).items():
            cols[k] = max(cols[k], v)
    if not (gap < 1.0 and cols["err_us"] <= 1.0005e-3
            and cols["pp_dm"] <= 1.0005e-7 and cols["pp_dme"] <= 1.0005e-7):
        raise AssertionError("served TOAs differ from pptoas's: %.3g ns, "
                             "%s" % (gap, cols))
    return gap, cols


def gpu_used_mib():
    """The card's used memory [MiB] by nvidia-smi: every process's CUDA
    context and allocations.  (Its per-process list cannot tell this
    machine's processes apart: they share one PID namespace entry.)"""
    return int(subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])


def phase_serve(root, work, K, survey, device="cuda"):
    """The TOA service (ppserve, pprouter, pploadgen) at full width, on
    the survey phase's archives: an in-process TOAService (batch_max 4,
    window 0.25 s, the plan's two buckets warmed with coalesce 2..4)
    behind its socket; pploadgen's closed loop of SERVE_LOAD requests
    from two tenants on 512 x 2048 (fresh spooled copies, concurrency
    4): requests/s and the client latencies over ten cycles; then
    over the socket the two 256 x 1024 archives, a fit_scat request, a
    duplicate (a replay: no launch) and two requests under a dispatch
    fault (PPTPU_FAULTS: one retries, its cycle sibling completes); a
    traced closed loop of SERVE_TRACED more (device busy).  Every served
    archive once in its tenant's toas.tim, within 1 ns of pptoas's on the same
    archive; at least one coalesced dispatch; no kernel built after
    warm; K1, K2 and K3 held against their plain versions at every
    shape the path gave them, and timed there.  Then ppserve start as a
    process (--plan --warm on the survey's primed kernel build
    directory: no build), one ``ppserve submit --wait``, ``status``,
    SIGTERM -> exit 0; pprouter start with 2 spawned daemons, 4 requests
    over both buckets (pploadgen against the router), each answered once
    with pptoas's TOAs, each daemon's allocator and the card memory the
    daemons added (contexts included), SIGTERM -> exit 0.  Returns the path's launches (the load and the socket requests)."""
    import io
    import shutil

    import torch

    from pulseportraiture_tpu_torch import obs
    from pulseportraiture_tpu_torch.cli import pploadgen, ppserve
    from pulseportraiture_tpu_torch.runner.plan import plan_survey
    from pulseportraiture_tpu_torch.service import (ServiceServer,
                                                    TOAService,
                                                    client_request)

    t_phase = time.perf_counter()
    work = os.path.join(work, "serve")
    os.makedirs(work)
    gm, canon, small = survey["gm"], survey["canon"], survey["small"]
    nsub = SURVEY_SHAPES[0][0]
    t0 = time.perf_counter()
    native = dict(survey["native"])
    native.update(serve_pptoas(K, work, "small", small, gm, device))
    scat_src = canon[0]
    native_scat = serve_pptoas(K, work, "scat", [scat_src], gm, device,
                               "--fit_scat")
    pptoas_s = time.perf_counter() - t0
    plan = plan_survey(canon + small, modelfile=gm)
    plan_path = os.path.join(work, "plan.json")
    plan.save(plan_path)

    def copy(src, name):
        dst = os.path.join(work, name)
        shutil.copyfile(src, dst)
        return dst

    # -- the in-process daemon and its socket --------------------------
    wd = os.path.join(work, "daemon")
    svc = TOAService(gm, wd, plan=plan, batch_window_s=SERVE_WINDOW_S,
                     batch_max=SERVE_CONCURRENCY, backoff_s=0.0,
                     get_toas_kw=dict(bary=False), quiet=True,
                     device=device).start()
    sock = os.path.join(wd, "ppserve.sock")
    server = ServiceServer(svc, sock).start()
    try:
        run_dir = obs.current().dir
        t0 = time.perf_counter()
        warm = svc.warm(coalesce=(2, 3, 4))
        warm_s = time.perf_counter() - t0
        if not warm["programs"] or not all(p["ok"]
                                           for p in warm["programs"]):
            raise AssertionError("serve warm: %s" % warm["programs"])
        rec = obs.current()
        builds0 = int(rec.counters.get("backend_compiles", 0))
        source = {}
        requests = pploadgen.build_requests(
            canon, SERVE_LOAD, list(SERVE_TENANTS),
            os.path.join(work, "spool"), seed=9)
        for i, (_, dst) in enumerate(requests):
            source[dst] = canon[i % len(canon)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with first_kernel_inputs(K, toa_path_kernels(K), True) \
                as seen:
            K.reset_launches()
            results, load_wall = pploadgen.run_load(
                sock, requests, mode="closed",
                concurrency=SERVE_CONCURRENCY, seed=9, timeout=600)
            snap = client_request(sock, {"op": "metrics"},
                                  timeout=60)["snapshot"]
            report = pploadgen.summarize_load(results, load_wall,
                                              server_snapshot=snap)
            if report["n_ok"] != SERVE_LOAD or report["n_cached"]:
                raise AssertionError("serve load: %s" % report["errors"])

            def submit(tenant, path, config=None):
                r = client_request(sock, {"op": "submit", "tenant": tenant,
                                          "archive": path,
                                          "config": config}, timeout=60)
                if not r.get("ok"):
                    raise AssertionError("submit %s: %s" % (path, r))
                return r["request_id"]

            def wait(rid):
                return client_request(sock, {"op": "wait", "request_id": rid,
                                             "timeout_s": 600}, timeout=660)

            # the 256 x 1024 bucket, one request per tenant
            for f in small:
                source[f] = f
            small_res = [wait(r) for r in [
                submit(t, f) for t, f in zip(SERVE_TENANTS, small)]]
            # a scattering fit (K3) of a fresh copy
            scat = copy(scat_src, "scat_req.fits")
            scat_res = wait(submit("alice", scat, {"fit_scat": True}))
            # a duplicate of a served request: replayed, nothing launched
            n_dup = dict(K.LAUNCHES)
            dup = client_request(sock, {"op": "submit",
                                        "tenant": requests[0][0],
                                        "archive": requests[0][1],
                                        "wait": True, "timeout_s": 60},
                                 timeout=90)
            dup_launches = {k: K.LAUNCHES[k] - n_dup[k] for k in n_dup}
            # two requests of one cycle under a dispatch fault: the first
            # to reach the fit's dispatch site raises, retries, completes
            fault = [copy(canon[1], "fault_a.fits"),
                     copy(canon[2], "fault_b.fits")]
            source.update({fault[0]: canon[1], fault[1]: canon[2]})
            with environ(PPTPU_FAULTS="site:dispatch@nth=1"):
                fault_res = [wait(r) for r in [
                    submit(t, f) for t, f in zip(SERVE_TENANTS, fault)]]
            launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for r in small_res + [scat_res] + fault_res:
            if r.get("state") != "done":
                raise AssertionError("serve request: %s" % r)
        if not dup.get("cached") or dup.get("state") != "done" \
                or any(dup_launches.values()):
            raise AssertionError("duplicate: %s, launches %s"
                                 % (dup, dup_launches))
        failed = {}
        for f in fault:
            t = [r["tenant"] for r in fault_res if r["archive"] == f][0]
            for ln in open(os.path.join(wd, "tenants", t, "ledger.0.jsonl")):
                e = json.loads(ln)
                if e["archive"] == f and e["state"] == "failed":
                    failed[f] = e.get("reason")
        if len(failed) != 1 or "InjectedFault" not in \
                str(list(failed.values())[0]):
            raise AssertionError("dispatch fault: failed records %s"
                                 % failed)
        # served archives carry their noise: K4's first epilogue only;
        # their loads decode and remove the baseline in one K5 launch; no
        # request smooths (K8) or fits a Gaussian model (K9, K10)
        served = tuple(n for n in toa_path_kernels(K) if n not in (
            "spectra_noise", "baseline") + SMOOTH_KERNELS + K9_NAMES
            + K10_NAMES)
        if any(launches[n] == 0 for n in served):
            raise AssertionError("serve launches %s" % launches)
        path_rows = path_kernels_vs_plain(K, seen, required=served)
        times = path_kernel_times(K, seen)
        # a traced closed loop of one cycle: the device's busy seconds
        traced = pploadgen.build_requests(
            canon, SERVE_TRACED, list(SERVE_TENANTS),
            os.path.join(work, "spool_traced"), seed=10)
        for i, (_, dst) in enumerate(traced):
            source[dst] = canon[i % len(canon)]
        n0 = dict(K.LAUNCHES)
        _, busy = kernel_device_ms(lambda: pploadgen.run_load(
            sock, traced, mode="closed", concurrency=SERVE_CONCURRENCY,
            seed=10, timeout=600), K, copies=True)
        K.LAUNCHES.update(n0)
        status = svc.status()
        builds_after = int(rec.counters.get("backend_compiles", 0))
    finally:
        server.stop()
        drained = svc.shutdown(timeout=300)
    if not drained:
        raise AssertionError("the serve daemon did not drain")
    events = obs_events(run_dir)
    sizes = [e["n_requests"] for e in events
             if e.get("name") == "microbatch_dispatch"]
    if not sizes or max(sizes) < 2:
        raise AssertionError("no coalesced dispatch: %s" % sizes)
    manifests = [json.load(open(os.path.join(wd, "obs_requests", d,
                                             "manifest.json")))
                 for d in sorted(os.listdir(os.path.join(wd,
                                                         "obs_requests")))]
    req_builds = sorted({int((m.get("counters") or {}).get(
        "backend_compiles", 0)) for m in manifests})
    if builds_after != builds0 or req_builds != [0]:
        raise AssertionError("kernel builds after warm: %d -> %d, request "
                             "manifests %s" % (builds0, builds_after,
                                               req_builds))
    # the traced cycle's copies to the card: each archive's stored int16
    # column goes up pinned, and no portrait from pageable memory (one
    # subint's portrait of the canonical shape at the least)
    portrait = 8 * SURVEY_SHAPES[0][1] * SURVEY_SHAPES[0][2]
    if busy["h2d"]["largest_pageable_bytes"] >= portrait:
        raise AssertionError("pageable copies of portraits in the traced "
                             "cycle: %s" % busy["h2d"])
    served = serve_tenant_toas(wd)
    if set(served) != set(source) | {scat}:
        raise AssertionError("served archives %s" % sorted(served))
    gap, cols = serve_check_toas(
        {f: v for f, v in served.items() if f != scat}, source, native, nsub)
    scat_gap, scat_cols = serve_check_toas(
        {scat: served[scat]}, {scat: scat_src}, native_scat, nsub)
    server_phases = {p: report["server"]["phases"][p]["p50_s"]
                     for p in ("queue_wait", "park", "dispatch", "fit",
                               "total") if p in report["server"]["phases"]}
    daemon = dict(
        warm_s=warm_s, warm_programs=warm["n_programs"],
        load=dict(requests=SERVE_LOAD, wall_s=load_wall,
                  requests_per_s=report["client"]["throughput_rps"],
                  client_p50_s=report["client"]["p50_s"],
                  client_p90_s=report["client"]["p90_s"],
                  client_p99_s=report["client"]["p99_s"],
                  client_max_s=report["client"]["max_s"],
                  latencies_s=sorted(r.latency_s for r in results),
                  server_p50_s=server_phases),
        dispatch_sizes=sizes, buckets=status["buckets"],
        device_busy=busy, peak_bytes=peak,
        device_memory=status.get("device_memory"),
        dup_launches=dup_launches, fault_failed=failed,
        fault_attempts=[r.get("attempts") for r in fault_res],
        toas_vs_pptoas_max_ns=gap, column_gaps=cols,
        fit_scat_vs_pptoas_max_ns=scat_gap, fit_scat_column_gaps=scat_cols,
        path_kernels_vs_plain=path_rows, path_kernel_times=times)

    # -- ppserve start as a process of its own -------------------------
    cli_wd = os.path.join(work, "cli")
    log = os.path.join(work, "ppserve.log")
    torch.cuda.empty_cache()
    used0 = gpu_used_mib()
    t0 = time.perf_counter()
    proc = serve_start(root, [
        "ppserve", "start", "-w", cli_wd, "-m", gm, "--plan", plan_path,
        "--warm", "--compile-cache", survey["kernel_dir"], "--batch", "4",
        "--window", str(SERVE_WINDOW_S), "--no_bary", "--quiet",
        "--device", device], log)
    try:
        ready = _Marker(proc, "PPSERVE_READY").wait(600, log)
        ready_s = time.perf_counter() - t0
        cli_arch = copy(canon[3], "cli_req.fits")
        source[cli_arch] = canon[3]
        outs = {}
        for op, argv in (("submit", ["-t", "cli", "--wait", cli_arch]),
                         ("status", [])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = ppserve.main([op, "-w", cli_wd] + argv)
            if rc != 0:
                raise AssertionError("ppserve %s: %s" % (op, buf.getvalue()))
            outs[op] = json.loads(buf.getvalue())
        cli_used = gpu_used_mib() - used0
        cli_rc = serve_stop(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    cli_s = time.perf_counter() - t0
    sub, st = outs["submit"], outs["status"]
    cli_gap = survey_tim_gap_ns([ln.split() for ln in sub["toa_lines"]],
                                native[canon[3]])
    cw = st.get("warm") or {}
    if cli_rc != 0 or sub.get("state") != "done" or not cli_gap < 1.0 \
            or not ready.get("warmed") or cw.get("backend_compiles") != 0 \
            or device == "cuda" and \
            cw.get("compile_cache_hits") != len(K.SOURCES):
        raise AssertionError("ppserve CLI: rc %s, %s, %.3g ns, warm %s"
                             % (cli_rc, sub.get("state"), cli_gap, cw))
    cli = dict(ready_s=ready_s, process_s=cli_s, exit_code=cli_rc,
               warm=cw, toas_vs_pptoas_max_ns=cli_gap,
               device_memory=st.get("device_memory"),
               card_used_mib_added=cli_used)

    # -- pprouter start with two spawned daemons -----------------------
    fleet_wd = os.path.join(work, "fleet")
    log = os.path.join(work, "pprouter.log")
    used0 = gpu_used_mib()
    t0 = time.perf_counter()
    proc = serve_start(root, [
        "pprouter", "start", "-w", fleet_wd, "-m", gm, "--plan",
        plan_path, "-n", "2", "--warm", "--compile-cache",
        survey["kernel_dir"], "--batch", "4", "--window",
        str(SERVE_WINDOW_S), "--daemon-arg=--no_bary", "--quiet",
        "--device", device], log)
    try:
        ready = _Marker(proc, "PPROUTER_READY").wait(900, log)
        ready_s = time.perf_counter() - t0
        if ready.get("ready") != 2:
            raise AssertionError("pprouter: %s" % ready)
        fleet_reqs = [("alice", canon[4]), ("bob", canon[5]),
                      ("alice", small[0]), ("bob", small[1])]
        fres, fwall = pploadgen.run_load(
            os.path.join(fleet_wd, "pprouter.sock"), fleet_reqs,
            mode="closed", concurrency=4, timeout=600)
        fstatus = client_request(os.path.join(fleet_wd, "pprouter.sock"),
                                 {"op": "status"}, timeout=60)
        footprint = {}
        for name in sorted(fstatus["daemons"]):
            st = client_request(os.path.join(fleet_wd, name,
                                             "ppserve.sock"),
                                {"op": "status"}, timeout=60)
            footprint[name] = dict(pid=fstatus["daemons"][name]["pid"],
                                   buckets=fstatus["daemons"][name]
                                   ["buckets"],
                                   device_memory=st.get("device_memory"))
        fleet_used = gpu_used_mib() - used0
        fleet_rc = serve_stop(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    fleet_s = time.perf_counter() - t0
    if fleet_rc != 0 or not all(r.ok and not r.cached for r in fres):
        raise AssertionError("pprouter: rc %s, %s" % (fleet_rc, [
            (r.archive, r.state, r.error) for r in fres]))
    fserved = serve_tenant_toas(fleet_wd)
    if set(fserved) != {f for _, f in fleet_reqs}:
        raise AssertionError("fleet served %s" % sorted(fserved))
    fgap, _ = serve_check_toas(fserved, {f: f for _, f in fleet_reqs},
                               native, nsub)
    fleet = dict(ready_s=ready_s, process_s=fleet_s, exit_code=fleet_rc,
                 requests=len(fleet_reqs), wall_s=fwall,
                 assignment=fstatus.get("assignment"),
                 daemons=footprint, card_used_mib_added=fleet_used,
                 toas_vs_pptoas_max_ns=fgap)
    emit("serve", archives=dict(canon=len(canon), small=len(small)),
         pptoas_s=pptoas_s, daemon=daemon, cli=cli, fleet=fleet,
         launches=launches, phase_s=time.perf_counter() - t_phase)
    return launches


# -- the device-mesh layer (parallel/mesh, sharded_fit, multihost) ----------

MESH_SHAPES = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 2)]
MESH_SURVEY = 4        # the survey's 512 x 2048 archives fit on a mesh
MESH_ONES = 16         # subints fit in groups of one, on a (16, 1, 1) mesh

# one process of the two-process distributed_sweep_fit: a gloo group,
# the north-star data drawn from the same seed as the parent's, this
# rank's half fit on a one-device mesh (given init, then seeded); its
# rows saved as an .npz beside a JSON line of walls and launches
MESH_WORKER = r"""
import json, sys, time
root, rank, port, device, shape, out = (sys.argv[1], int(sys.argv[2]),
    int(sys.argv[3]), sys.argv[4], json.loads(sys.argv[5]), sys.argv[6])
sys.path.insert(0, root)
import numpy as np
import torch
import chip_smoke as cs
from pulseportraiture_tpu_torch import _kernels as K
from pulseportraiture_tpu_torch.fit.portrait import model_kmax
from pulseportraiture_tpu_torch.parallel import multihost
t0 = time.perf_counter()
multihost.initialize("127.0.0.1:%d" % port, num_processes=2,
                     process_id=rank, backend="gloo", timeout_s=600)
dev = torch.device(device)
ds, phis, _ = cs.north_star_draw(dev, 0, *shape)
model = cs.north_star_model(dev, ds)
half = shape[0] // 2
data = ds.subints[rank * half:(rank + 1) * half].clone()
freqs = ds.freqs
ds.clear()
del ds
init = torch.zeros((shape[0], 5), dtype=torch.float64, device=dev)
init[:, 0] = phis
mesh = multihost.global_mesh(devices=[device])
kw = dict(fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30,
          kmax=model_kmax(model))
res, walls = {}, {}
K.reset_launches()
for tag, x in (("given", init), ("seeded", None)):
    t1 = time.perf_counter()
    r = multihost.distributed_sweep_fit(mesh, data, model, x, cs.P0, freqs,
                                        **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    walls[tag] = time.perf_counter() - t1
    for k in ("global_rows", "phi", "DM", "phi_err", "nfeval",
              "return_code"):
        res["%s_%s" % (tag, k)] = r[k].cpu().numpy()
np.savez(out, **res)
print(json.dumps(dict(rank=rank, walls=walls, launches=dict(K.LAUNCHES),
                      process_s=time.perf_counter() - t0)), flush=True)
"""


def mesh_gaps(got, want, P):
    """A sharded fit against the unsharded one: TOAs (phi, DM, nu_DM)
    bit-equal, rc and nfeval equal per lane, the largest relative
    difference of any other field (its largest magnitude), and the
    largest TOA difference [ns]."""
    import torch

    from pulseportraiture_tpu_torch.fit.portrait import RESULT_KEYS

    rel = {k: rel_err(got[k], want[k]) for k in RESULT_KEYS
           if k not in ("nfeval", "return_code")}
    worst = max(rel, key=rel.get)
    dphi = ((got.phi - want.phi + 0.5) % 1.0 - 0.5).abs().max()
    return dict(
        toas_equal=all(torch.equal(got[k], want[k])
                       for k in ("phi", "DM", "nu_DM")),
        fields_equal=sum(torch.equal(got[k], want[k]) for k in RESULT_KEYS),
        fields=len(RESULT_KEYS),
        rc_nfev_equal=bool(torch.equal(got.return_code, want.return_code)
                           and torch.equal(got.nfeval, want.nfeval)),
        max_rel=rel[worst], worst_field=worst,
        max_dt_ns=float(dphi) * P * 1e9)


def mesh_two_process(root, work, shape, device, ref, timeout=600):
    """Two processes of a gloo group on the one card, each fitting its
    half of the north-star data through distributed_sweep_fit: their rows
    reassembled by their global indices against the single-process fit
    ``ref`` ({"given", "seeded": DataBunch}): given init equal, seeded
    within 1 ns."""
    import socket

    import numpy as np

    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=root)
    outs = [os.path.join(work, "mesh_rank%d.npz" % r) for r in (0, 1)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MESH_WORKER, root, str(r), str(port), device,
         json.dumps(list(shape)), outs[r]], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=root)
        for r in (0, 1)]
    lines = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise AssertionError("mesh worker exited %d: %s"
                                     % (p.returncode, se[-3000:]))
            lines.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    res = {}
    for tag in ("given", "seeded"):
        z = [np.load(o) for o in outs]
        rows = np.concatenate([x[tag + "_global_rows"] for x in z])
        if sorted(rows.tolist()) != list(range(shape[0])):
            raise AssertionError("two-process rows: %s" % rows)
        order = np.argsort(rows)
        got = {k: np.concatenate([x["%s_%s" % (tag, k)] for x in z])[order]
               for k in ("phi", "DM", "phi_err", "nfeval", "return_code")}
        want = {k: ref[tag][k].cpu().numpy() for k in got}
        dphi = np.abs((got["phi"] - want["phi"] + 0.5) % 1.0 - 0.5).max()
        res[tag] = dict(
            fields_equal=[k for k in got if np.array_equal(got[k], want[k])],
            max_dt_ns=float(dphi) * P0 * 1e9)
    # given init: the TOAs, rc and nfeval equal; seeded: within 1 ns
    ok = {"phi", "DM", "nfeval", "return_code"} <= set(
        res["given"]["fields_equal"]) and res["seeded"]["max_dt_ns"] < 1.0
    return dict(wall_s=wall, workers=lines, **res), ok


def phase_mesh(root, work, K, survey, shape=(1000, 512, 2048),
               device="cuda"):
    """The device-mesh layer on the one card named repeatedly: the
    north-star fit (``shape``, data made on the card by B11) on meshes
    MESH_SHAPES, with a given init (the injected phases; TOAs bit-equal
    to the unsharded kernel fit's, every other field within 1e-12
    relative, rc and nfeval equal) and seeded (TOAs within 1 ns); the
    first MESH_ONES subints in groups of one (within 1 ns); the
    throughput_scat fit on a (1, 2, 1) mesh (K3 per channel shard; equal
    to the unsharded fit); single-process distributed_sweep_fit;
    run_survey(use_mesh=True) on MESH_SURVEY of the survey's 512 x 2048
    archives over a (2, 2, 1) mesh and ``ppsurvey run --mesh`` (a 1 x 1 x
    1 mesh) on them, TOAs against the unmeshed survey's main run; then
    two processes on gloo, each fitting half the batch, their rows
    reassembled against the single-process fit.  Walls, device busy and
    peak memory per mesh; K1, K2 and K3 against their plain versions at
    every shape the phase gave them, with their times and bounds.
    Returns the path's launches (every count set to 0 before each
    segment of the path, summed after it)."""
    import torch

    from pulseportraiture_tpu_torch.fit.portrait import (
        fit_portrait_full_batch, model_kmax)
    from pulseportraiture_tpu_torch.parallel import multihost
    from pulseportraiture_tpu_torch.parallel.mesh import make_mesh
    from pulseportraiture_tpu_torch.runner.execute import run_survey
    from pulseportraiture_tpu_torch.runner.plan import plan_survey

    t_phase = time.perf_counter()
    work = os.path.join(work, "mesh")
    os.makedirs(work)
    dev = torch.device(device)
    nsub = shape[0]
    launches = {name: 0 for name in K.KERNELS}

    def counted(fn):
        K.reset_launches()
        out = fn()
        for name, n in K.LAUNCHES.items():
            launches[name] += n
        return out

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def mesh_of(shp):
        return None if shp is None else make_mesh(
            *shp, devices=[device] * (shp[0] * shp[1] * shp[2]))

    data, freqs, nu0, phis, dDMs, model = north_star_data(dev, 0, *shape)[:6]
    kmax = model_kmax(model)
    init = torch.zeros((nsub, 5), dtype=torch.float64, device=dev)
    init[:, 0] = phis
    kw = dict(fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30,
              kmax=kmax)

    def fit(shp, x):
        return fit_portrait_full_batch(data, model, x, P0, freqs,
                                       mesh=mesh_of(shp), device=dev, **kw)

    # the unsharded kernel fits (each run twice: the second is timed)
    ref, ref_walls = {}, {}
    for tag, x in (("given", init), ("seeded", None)):
        fit(None, x)
        ref[tag], ref_walls[tag] = timed(lambda: fit(None, x))
    meshes, ok = [], True
    with first_kernel_inputs(K, toa_path_kernels(K), True) as seen:
        for shp in MESH_SHAPES:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = dict(launches)
            row = dict(mesh=list(shp))
            for tag, x in (("given", init), ("seeded", None)):
                out, wall = counted(lambda: timed(lambda: fit(shp, x)))
                row[tag] = dict(wall_s=wall, **mesh_gaps(out, ref[tag], P0))
            peak = torch.cuda.max_memory_allocated()
            row["peak_device_bytes"] = int(peak)
            row["peak_above_prior_bytes"] = int(peak - base)
            row["launches"] = {n: launches[n] - before[n]
                               for n in launches}
            g, sd = row["given"], row["seeded"]
            ok &= g["toas_equal"] and g["rc_nfev_equal"] \
                and g["max_rel"] <= 1e-12 and sd["max_dt_ns"] < 1.0
            meshes.append(row)
        # subint groups of one: on the card some kernels (cuFFT, small
        # reductions) take another summation order for a handful of rows,
        # so these are held to 1 ns only
        nb = min(MESH_ONES, nsub)
        ones_ref = fit_portrait_full_batch(data[:nb], model, init[:nb], P0,
                                           freqs, device=dev, **kw)
        ones, ones_wall = counted(lambda: timed(
            lambda: fit_portrait_full_batch(
                data[:nb], model, init[:nb], P0, freqs,
                mesh=mesh_of((nb, 1, 1)), **kw)))
        ones_row = dict(mesh=[nb, 1, 1], wall_s=ones_wall,
                        **mesh_gaps(ones, ones_ref, P0))
        ok &= ones_row["rc_nfev_equal"] and ones_row["max_dt_ns"] < 1.0
        # the multihost entry point, one process: its rows are the
        # two-process run's reference
        gmesh = multihost.global_mesh(devices=[device])
        single = {tag: counted(lambda: multihost.distributed_sweep_fit(
            gmesh, data, model, x, P0, freqs, **kw))
            for tag, x in (("given", init), ("seeded", None))}
        single_gaps = {tag: mesh_gaps(single[tag], ref[tag], P0)
                       for tag in single}
        ok &= single_gaps["given"]["toas_equal"]
        # device busy per mesh (torch.profiler; not counted)
        for row in meshes:
            row["profiled"] = kernel_device_ms(
                lambda: fit(tuple(row["mesh"]), init), K)[1]
        del data
        # the throughput_scat configuration on a (1, 2, 1) mesh: K3 once
        # per channel shard
        sdata, sfreqs, _, sphis, sdDMs, smodel = north_star_data(
            dev, 3, *shape, t_scat=TAU_INJ * P0)[:6]
        sinit = torch.zeros((nsub, 5), dtype=torch.float64, device=dev)
        sinit[:, 0], sinit[:, 1] = sphis, sdDMs
        sinit[:, 3], sinit[:, 4] = math.log10(TAU_INJ * 1.5), -4.0
        nus = torch.full((nsub,), nu0, dtype=torch.float64, device=dev)

        def fit_scat(shp):
            return fit_portrait_full_batch(
                sdata, smodel, sinit, P0, sfreqs, fit_flags=(1, 1, 0, 1, 1),
                nu_fits=(nus, nus, nus), nu_outs=(nus, nus, nus),
                log10_tau=True, max_iter=30, kmax=model_kmax(smodel),
                mesh=mesh_of(shp), device=dev)

        scat_ref = fit_scat(None)
        scat, scat_wall = counted(lambda: timed(lambda: fit_scat((1, 2, 1))))
        scat_row = dict(mesh=[1, 2, 1], wall_s=scat_wall,
                        **mesh_gaps(scat, scat_ref, P0))
        ok &= scat_row["toas_equal"] and scat_row["rc_nfev_equal"] \
            and scat_row["max_rel"] <= 1e-12
        del sdata, scat, scat_ref
        torch.cuda.empty_cache()

        # surveys on a mesh: the survey's main run is the unmeshed one
        files = survey["canon"][:MESH_SURVEY]
        main_toas, _ = survey_toas(survey["main_wd"])
        swd = os.path.join(work, "survey_mesh")
        t0 = time.perf_counter()
        sres = counted(lambda: run_survey(
            plan_survey(files, modelfile=survey["gm"]), swd,
            process_index=0, process_count=1, bary=False, use_mesh=True,
            mesh=mesh_of((2, 2, 1)), device=device))
        survey_row = dict(mesh=[2, 2, 1], wall_s=time.perf_counter() - t0,
                          counts=sres["counts"])
        meta = os.path.join(work, "mesh.meta")
        with open(meta, "w") as f:
            f.write("\n".join(files) + "\n")
        cwd = os.path.join(work, "cli_mesh")
        survey_cli(K, ["plan", "-d", meta, "-m", survey["gm"], "-w", cwd])
        wall, cli_launches, cres = survey_cli(
            K, ["run", "-w", cwd, "--no_bary", "--mesh", "--device", device,
                "--quiet"])
        for name, n in cli_launches.items():
            launches[name] += n
        cli_row = dict(mesh=[1, 1, 1], wall_s=wall, counts=cres["counts"])
        for row, wd in ((survey_row, swd), (cli_row, cwd)):
            toas, blocks = survey_toas(wd)
            row["blocks"] = sorted(blocks.values())
            row["max_dt_ns"] = max(survey_tim_gap_ns(main_toas[f], toas[f])
                                   for f in files)
            row["lines_equal"] = all(main_toas[f] == toas[f] for f in files)
            row["column_gaps"] = {k: max(v) for k, v in zip(
                ("err_us", "pp_dm", "pp_dme"), zip(*(survey_column_gaps(
                    main_toas[f], toas[f]).values() for f in files)))}
            c = row["column_gaps"]
            ok &= row["counts"]["done"] == len(files) \
                and row["blocks"] == [1] * len(files) \
                and row["max_dt_ns"] < 1.0 and c["err_us"] <= 1.0005e-3 \
                and c["pp_dm"] <= 1.0005e-7 and c["pp_dme"] <= 1.0005e-7
    path_rows = path_kernels_vs_plain(K, seen, required=tuple(
        n for n in toa_path_kernels(K)
        if n not in ("baseline",) + SMOOTH_KERNELS + K9_NAMES
        + K10_NAMES))
    times = path_kernel_times(K, seen)
    del seen
    torch.cuda.empty_cache()
    two, two_ok = mesh_two_process(root, work, shape, device, single)
    ok &= two_ok
    res = dict(shape=list(shape), kmax=kmax, unsharded_wall_s=ref_walls,
               peak_above_prior_bytes_by_mesh={
                   "x".join(map(str, row["mesh"])):
                   row["peak_above_prior_bytes"] for row in meshes},
               meshes=meshes, groups_of_one=ones_row,
               single_process=single_gaps, fit_scat=scat_row,
               survey=survey_row, cli=cli_row, two_process=two,
               path_kernels_vs_plain=path_rows, path_kernel_times=times,
               launches=launches, phase_s=time.perf_counter() - t_phase)
    emit("mesh", **res)
    if not ok:
        raise AssertionError("a sharded fit or survey disagrees with the "
                             "unsharded one (the mesh line above)")
    # the mesh's loads decode and remove the baseline in one K5 launch:
    # K5's baseline alone follows only a rotation or a state conversion;
    # nothing on it smooths (K8), fits a Gaussian model (K9, K10) or runs
    # K11 or K12 (its data is made before its counted fits)
    missing = [n for n, c in launches.items() if c == 0 and n not in
               ("baseline",) + SMOOTH_KERNELS + K9_NAMES + K10_NAMES
               + K11_K12_NAMES]
    if missing:
        raise AssertionError("kernels never launched on the mesh path: %s"
                             % missing)
    return launches



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
    # each path's launches, from its main run (counts zeroed just before);
    # the throughput fits first, while the profiler's clock conversion is
    # fresh (it drifts over a process's life and drops a capture's first
    # rows: PERF.md section 7)
    throughput, late = phase_throughput(dev, K)
    by_path = {"throughput": throughput["launches"],
               "throughput_scat": phase_throughput_scat(dev, K)["launches"]}
    # K12's path (the synth: the north-star data) and K11's (noise_fit)
    by_path["synth"], rows["synth_rows"] = late["synth"]
    by_path["noise_fit"], rows["noise_fit"] = late["noise_fit"]
    failed_lists = track_failed_datafiles()
    work = tempfile.mkdtemp(prefix="pp_smoke_")
    try:
        by_path["pptoas"], big, small = phase_pptoas(
            root, work, K, profile_dir=profile_dir)
        by_path["load"], load_rows = phase_load(root, work, K, dev, big)
        rows.update(load_rows)
        by_path["pptoas_scat"] = phase_pptoas_scat(root, work, K, big, small)
        by_path["narrowband"] = phase_narrowband(root, work, K, big, small)
        by_path["narrowband_scat"] = phase_narrowband_scat(root, work, K,
                                                           small)
        by_path["templates"] = phase_templates(root, work, K, small)
        by_path["ppzap"] = phase_ppzap(root, work, K, small)
        by_path["viz"] = phase_viz(root, work, K, small)
        by_path["ppalign"], avg = phase_ppalign(root, work, K, dev)
        by_path["ppalign_s"], k8_align = phase_ppalign_smooth(
            root, work, K, dev, avg)
        by_path["ppspline"], k8_spline = phase_ppspline(root, work, K, dev,
                                                        avg, small)
        rows["smooth_search"] = k8_spline + k8_align
        by_path["ppgauss"] = phase_ppgauss(root, work, K, dev, avg, small)
        by_path["ppgauss_scat"] = phase_ppgauss_scat(root, work, K, dev, avg)
        by_path["walkthrough"] = phase_walkthrough(root, work, K, dev)
        by_path["obs"] = phase_obs_fresh(root, work, small)
        by_path["survey"], survey = phase_survey(root, work, K)
        by_path["serve"] = phase_serve(root, work, K, survey)
        by_path["mesh"] = phase_mesh(root, work, K, survey)
        phase_obs_late(root, work, K, small)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # K1's (both epilogues) and K2's main path is pptoas, K3's (both
    # epilogues) pptoas_scat (their own fit-flag groups), each with the
    # later paths; K1 and K2 also with the template builders and the
    # walkthrough.  K4 runs on every path: its first epilogue wherever a
    # fit is given its errors, its second where it measures them (the
    # mesh's fits, the obs phase's throughput fit).  K5-K7 run on every
    # path that loads an archive, the load phase's own run first
    own = dict(moments="pptoas", moments_grad_hess="pptoas",
               fftfit="pptoas", moments_scat="pptoas_scat",
               moments_scat_grad_hess="pptoas_scat")
    paths = {name: [own[name], "narrowband", "narrowband_scat",
                    "templates", "ppzap"] for name in own}
    for name in K1_K2_NAMES:
        paths[name] += ["viz", "ppalign", "ppalign_s", "ppspline", "ppgauss",
                        "ppgauss_scat", "walkthrough"]
    for name in own:
        paths[name] += ["obs", "survey", "serve", "mesh"]
    for name in K4_NAMES + LOAD_NAMES:
        paths[name] = list(by_path)
    # K8 on every path that smooths
    paths["smooth_search"] = ["ppspline", "ppalign_s", "walkthrough"]
    # K9 on ppgauss's portrait fits, K10 on its scattered and joined ones
    for name in K9_NAMES:
        paths[name] = ["ppgauss"]
    for name in K10_NAMES:
        paths[name] = ["ppgauss_scat"]
    # K11 on the "fit" noise path, K12 on the synth
    paths["noise_fit"] = ["noise_fit"]
    paths["synth_rows"] = ["synth"]
    # no archive of any path failed on a device error
    failed = [f for made in failed_lists for f in made]
    emit("failed_datafiles", gettoas_runs=len(failed_lists), failed=failed)
    if failed:
        raise AssertionError("archives failed on the card: %s" % failed)
    launches = {name: sum(by_path[p][name] for p in paths[name])
                for name in paths}
    missing = [n for n in K4_NAMES + LOAD_NAMES if launches[n] == 0]
    # the load's main path, pptoas's load and its guess (K7)
    missing += ["%s on %s" % (n, p) for p, names in (
        ("load", LOAD_NAMES), ("pptoas", LOAD_PATH_KERNELS),
        ("ppspline", SMOOTH_KERNELS), ("ppalign_s", SMOOTH_KERNELS),
        ("walkthrough", SMOOTH_KERNELS), ("ppgauss", K9_NAMES),
        ("ppgauss_scat", K10_NAMES), ("noise_fit", ("noise_fit",)),
        ("synth", ("synth_rows",)))
        for n in names if by_path[p][n] == 0]
    if missing:
        raise AssertionError("kernels never launched on any path: %s"
                             % missing)

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
        elif name in K1_NAMES:
            r, extra = r[K1_MAIN], dict(shapes=[
                {key: c[key] for key in (
                    "shape", "lanes", "ms", "floor_ms",
                    "call_ms", "bound_ms", "share_of_bound", "plain_ms",
                    "max_rel_err", "max_abs_err")} for c in r])
        elif name in K3_NAMES:
            r, extra = r[K3_MAIN], dict(shapes=[
                {key: c[key] for key in (
                    "shape", "shared_abs_m2", "lanes", "ms", "call_ms",
                    "bound_ms", "share_of_bound", "plain_ms", "max_rel_err",
                    "max_abs_err")} for c in r])
        elif name in LOAD_NAMES:
            r, extra = r[0], dict(shapes=[
                {key: c[key] for key in (
                    "shape", "mode", "ms", "call_ms", "bound_ms",
                    "share_of_bound", "plain_ms", "library_ms", "errors",
                    "max_abs_err")} for c in r])
        elif name == "smooth_search":
            r, extra = max(r, key=lambda c: c["shape"][0]), dict(
                symbols=sorted(K._SYMBOLS[name]), rows_by_path=SMOOTH_TIERS,
                shapes=[{key: c[key] for key in (
                    "path", "shape", "nlevels", "nfact", "ms", "call_ms",
                    "call_synced_ms", "scan_ms", "scan_certify_ms",
                    "route_ms", "route_all_ms", "route_all_call_ms",
                    "route_all_call_synced_ms", "rows", "bound_ms",
                    "share_of_bound", "grid_bound_ms", "plain_ms",
                    "max_rel_err", "max_abs_err", "choice_mismatches",
                    "scan_vs_plain_max_rel_err", "scan_same_equal",
                    "gap_over_bound", "rows_failing_fft_check")}
                    for c in r])
        elif name in K10_NAMES:
            r, extra = r[K10_MAIN], dict(shapes=[
                {key: c[key] for key in (
                    "shape", "ngauss", "kind", "njoin", "ms", "call_ms",
                    "work_call_ms", "bound_ms", "bound_by", "share_of_bound",
                    "plain_ms", "rfft_bmm_ms", "split_ms", "path",
                    "cluster", "batch", "active_clusters", "staged_bytes",
                    "torch_route_jac_ms", "torch_route_ms", "errors",
                    "max_abs_err", "repeat_bit_equal") if key in c}
                for c in r])
        elif name in K9_NAMES:
            r, extra = r[K9_MAIN], dict(shapes=[
                {key: c[key] for key in (
                    "shape", "ngauss", "layout", "ms", "call_ms",
                    "work_call_ms", "bound_ms", "bound_by", "share_of_bound",
                    "plain_ms", "gram_cublas_ms", "torch_route_jac_ms",
                    "torch_route_ms", "errors", "max_abs_err",
                    "repeat_bit_equal") if key in c}
                for c in r])
        elif name == "noise_fit":
            extra = {key: r[key] for key in (
                "shape", "call_ms", "cufft_ms", "share_of_bound",
                "noise_max_rel_err", "k_crit_mismatches", "ties", "faults")}
        elif name == "synth_rows":
            extra = {key: r[key] for key in (
                "shapes", "narrow", "route_gap_over_peak", "make_warm_s",
                "make_launches")}
        elif name in K4_NAMES:
            r, extra = r[K4_MAIN], dict(shapes=[
                {key: c[key] for key in (
                    "shape", "kmax", "model_per_row", "ms", "call_ms",
                    "bound_ms", "share_of_bound", "l2_resident", "cold_ms",
                    "cold_share_of_bound", "plain_ms", "errors",
                    "max_abs_err") if key in c} for c in r])
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
