"""Compare kernels K3, K1, K9 or K10 and their fits across source trees on one GPU.

For each tree given (a checkout of this repository, e.g. the parent
commit unpacked with ``git archive`` into a git-ignored directory), in the
order given, in a subprocess of its own.  By default (K3):

* builds the tree's kernels and counts the FP64 instructions of K3's
  harmonic loop in the built library's SASS (``cuobjdump -sass``): for
  each loop of a ``moments_scat*`` kernel (a backward branch), the DFMA,
  DMUL, DADD, DSETP and FRND in its body, and the harmonics the body
  handles (one MUFU.RCP64H each: the division of B = 1 / (1 + i x));
* times K3's nine sums (``_kernels.moments_scat``), and epilogue B
  (``moments_scat_grad_hess``) where the tree has it, at [1000, 512, 128]
  and [16, 512, 128] with one |m|^2 shared (CUDA-graph replay,
  ``chip_smoke.graph_ms``);
* runs chip_smoke.py's throughput_scat fit (1000 x 512 x 2048, flags
  (1,1,0,1,1), log10 tau): five steady walls, one run under
  torch.profiler (device events, device-busy ms, the K3 rows) and the
  peak device memory.

With ``--k1`` first (K1):

* the SASS of K1's harmonic loop (``moments*`` kernels of
  libmoments-*.so): the same FP64 counts, the harmonics being the body's
  16-byte loads (LDG.E.128: one cross value each);
* K1's three sums (``_kernels.moments``), and epilogue B
  (``moments_grad_hess``) where the tree has it, at chip_smoke.py's
  K1_CASES and [15, 512, 128]: device ms by CUDA-graph replay, with
  the empty kernel's launch floor where the tree has it; nvcc's
  register report (a fresh build);
* one solver evaluation without scattering (``_Spectra.grad_hess``,
  flags (1,1,0,0,0)) at [1000, 512, 128] and [16, 512, 128]: device
  events and device-busy ms under torch.profiler, wall ms by CUDA events;
* chip_smoke.py's throughput fit (1000 x 512 x 2048, flags (1,1,0,0,0),
  phases seeded in the fit): five steady walls, one run under
  torch.profiler (device events, device-busy ms, the K1 rows), nfeval,
  return codes and the peak device memory.

With ``--spectra`` first (the fit's set-up, K4):

* where the tree has K4 (``_kernels.spectra``): chip_smoke.py's K4 phase
  at its throughput chunk, [64, 512, 2048] K 128 (both epilogues against
  their plain versions, device ms by CUDA-graph replay, bound);
* chip_smoke.py's throughput fit (1000 x 512 x 2048, flags (1,1,0,0,0),
  phases seeded in the fit, errors given) and throughput_scat fit (flags
  (1,1,0,1,1), log10 tau), and the throughput fit without errs (the
  noise measured by the fit): for each, ten steady walls, one
  run under torch.profiler (device events, device-busy ms, the eight
  longest device rows) and the peak device memory above what was
  allocated before the fit.

With ``--ppgauss`` first (the Gaussian portrait fit, K9):

* ``ppgauss --autogauss 0.05 --niter 2`` on one averaged archive (one
  subint, 512 channels x 2048 bins, dedispersed, noise 0.05, one evolving
  component of model code "000", made once with this tree's
  make_fake_pulsar, chip_smoke.py's ppgauss input), run twice in the
  tree's process; the second run is reported (the first builds the
  kernels): the CLI wall, each portrait fit's seconds
  (fit_gaussian_portrait, the device synchronised), nfev and rc, the hand
  kernels' launches, and the fitted model's parameters and errors; after
  the trees, each run's largest parameter gap to the first run's, over
  its errors.

With ``--k9`` first (the Gaussian portrait fit's normal equations):

* K9's two epilogues (``_kernels.gauss_normal``, ``gauss_sse``) at
  chip_smoke.py's K9 cases of this tree ([512, 2048], per-channel errs,
  chip_smoke.k9_inputs): device ms by CUDA-graph replay (through a
  GaussWork where the tree has one: its launches allocate nothing, as on
  the fit's path), the wrapper's
  ms per call by back-to-back CUDA events (``call_ms``), its host ms per
  call (the enqueue alone, no sync), and where the tree has
  ``_kernels.GaussWork`` the same two through a GaussWork (the route
  ``fit.gauss.GaussNormal`` takes: ``work_call_ms``, ``work_host_ms``);
  both epilogues' device ms at 1, 3 and 19 components over 512 to 4096
  bins and 128 to 2048 channels (``sweep``); both at 19 to 43 components
  at [512, 2048], across the mma layout's panel counts (``panels``: one
  64-row panel up to 20 components, three at 21-41, six at 43, each a
  pass over the bins); nvcc's register report.

With ``--k10`` first (the scattered and joined Gaussian portrait fit's
normal equations):

* K10's two epilogues (``_kernels.gauss_ft_normal``, ``gauss_ft_sse``) at
  chip_smoke.py's K10 shapes of this tree's ``k10_inputs`` ([512, 2048],
  one lane, 1, 4 and 19 components x tau > 0, tau = 0 fitted, two joins,
  joins with tau) and 19 components over [512, 8192]: device ms by
  CUDA-graph replay through a GaussFtWork; where the tree has
  ``_kernels.gauss_ft_path``, epilogue B's path (cluster size, 0 for the
  staged rows); nvcc's register report.

Each tree prints one JSON line; run the trees alternately (parent,
change, change, parent) to compare them within one call:

    python3 k3_compare.py PARENT_DIR . . PARENT_DIR
    python3 k3_compare.py --k1 PARENT_DIR . . PARENT_DIR
    python3 k3_compare.py --spectra PARENT_DIR . . PARENT_DIR
    python3 k3_compare.py --ppgauss PARENT_DIR . . PARENT_DIR
    python3 k3_compare.py --k9 PARENT_DIR . . PARENT_DIR
    python3 k3_compare.py --k10 PARENT_DIR . . PARENT_DIR

Needs a CUDA device and the CUDA toolkit (nvcc, cuobjdump).
"""

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

FP64_OPS = ("DFMA", "DMUL", "DADD", "DSETP", "FRND")
KERNEL_NAME = r"moments_scat(?:_grad_hess)?_kernel"
K1_KERNEL_NAME = r"moments(?:_grad_hess)?_kernel"


def _is_k3_harmonic(op):
    return op == "MUFU.RCP64H"


def _is_k1_harmonic(op):
    return op.startswith("LDG") and ".128" in op


def sass_loops(sass, kernel_name=KERNEL_NAME, harmonic=_is_k3_harmonic):
    """{kernel: [per-loop {op: count, "harmonics": n}]} for the kernels
    matching ``kernel_name`` (K3's by default) of a cuobjdump -sass
    listing; ``harmonic`` tells the instruction there is one of per
    harmonic."""
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        kernel = re.findall(kernel_name, name)
        if not kernel:
            continue
        code = []
        for line in func.splitlines():
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                         r"([A-Z0-9_.]+)\s*([^;]*)", line)
            if m:
                code.append((int(m.group(1), 16), m.group(3), m.group(4)))
        loops = []
        for addr, op, arg in code:
            target = re.match(r"0x([0-9a-f]+)", arg.strip())
            if op.startswith("BRA") and target and \
                    int(target.group(1), 16) < addr:
                lo = int(target.group(1), 16)
                body = [o for a, o, _ in code if lo <= a <= addr]
                counts = {k: sum(1 for o in body if o.split(".")[0] == k)
                          for k in FP64_OPS}
                counts["harmonics"] = sum(1 for o in body if harmonic(o))
                counts["instructions"] = len(body)
                if counts["harmonics"]:
                    loops.append(counts)
        out.setdefault(kernel[-1], []).extend(loops)
    return out


def one_tree(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _kernels as K
    from pulseportraiture_tpu_torch.fit.portrait import (
        fit_portrait_full_batch, model_kmax)

    K.build()
    cuobjdump = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    lib = [f for f in os.listdir(K.BUILD_DIR)
           if f.startswith("libmoments_scat") and f.endswith(".so")][0]
    sass = subprocess.run(
        [cuobjdump, "-sass", os.path.join(K.BUILD_DIR, lib)],
        capture_output=True, text=True, check=True).stdout
    res = dict(tree=root, gpu=cs.gpu_line(), sass_loops=sass_loops(sass))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    for n in (1000, 16):
        nchan, nh = 512, 128
        cross = torch.complex(
            torch.randn((n, nchan, nh), generator=gen, device=dev,
                        dtype=torch.float64),
            torch.randn((n, nchan, nh), generator=gen, device=dev,
                        dtype=torch.float64))

        def rand(*shape):
            return torch.rand(shape, generator=gen, device=dev,
                              dtype=torch.float64)

        abs_m2, inv_err2 = rand(1, nchan, nh) * 2.0, rand(n, nchan) + 0.5
        shifts = (rand(n, nchan) - 0.5) * 4000.0
        taus = rand(n, nchan) * 0.02
        args = (cross, abs_m2, shifts, taus, inv_err2)
        res["moments_scat_ms@%d" % n] = cs.graph_ms(
            lambda: K.moments_scat(*args))
        if hasattr(K, "moments_scat_grad_hess"):
            ones = torch.ones((n, nchan), dtype=torch.float64, device=dev)
            pd = torch.stack([ones, (rand(n, nchan) - 0.5) * 0.4,
                              (rand(n, nchan) - 0.5) * 2e-3], 1)
            extra = (pd, (rand(n, nchan) - 0.5) * 0.4,
                     rand(n) * 4e-3 + 1e-3, True)
            res["moments_scat_grad_hess_ms@%d" % n] = cs.graph_ms(
                lambda: K.moments_scat_grad_hess(*args, *extra))
        del cross, args
    torch.cuda.empty_cache()

    nsub, nchan, nbin = 1000, 512, 2048
    data, freqs, nu0, phis, dDMs, model = cs.north_star_data(
        dev, 3, nsub, nchan, nbin, t_scat=cs.TAU_INJ * cs.P0)[:6]
    kmax = model_kmax(model)
    errs = torch.full((nsub, nchan), cs.NOISE, dtype=torch.float64,
                      device=dev)
    init = torch.zeros((nsub, 5), dtype=torch.float64, device=dev)
    init[:, 0], init[:, 1] = phis, dDMs
    init[:, 3], init[:, 4] = math.log10(cs.TAU_INJ * 1.5), -4.0
    nus = torch.full((nsub,), nu0, dtype=torch.float64, device=dev)

    def run():
        return fit_portrait_full_batch(
            data, model, init, cs.P0, freqs, errs=errs,
            fit_flags=(1, 1, 0, 1, 1), nu_fits=(nus, nus, nus),
            nu_outs=(nus, nus, nus), log10_tau=True, max_iter=30,
            kmax=kmax, device=dev)

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events, busy_us, k3 = 0, 0.0, {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") \
                or e.key.startswith("pp_"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        events += e.count
        busy_us += us
        hit = re.findall(KERNEL_NAME, e.key)
        if hit:
            k3[hit[-1]] = [e.count, us / 1e3]
    res.update(fit_walls_s=walls, device_events=events,
               device_busy_ms=busy_us / 1e3, k3_rows=k3,
               peak_device_bytes=int(peak),
               peak_above_prior_bytes=int(peak - base),
               nfev_median=float(out.nfeval.double().median()),
               return_codes=sorted(int(c)
                                   for c in out.return_code.unique()))
    print(json.dumps(res), flush=True)


def device_profile(fn):
    """(device events, device-busy ms) of one call of fn() under
    torch.profiler, the solver's pp_* ranges left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events, busy_us, rows = 0, 0.0, {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") \
                or e.key.startswith("pp_"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        events += e.count
        busy_us += us
        hit = re.findall(K1_KERNEL_NAME, e.key)
        if hit:
            rows[hit[-1]] = [e.count, us / 1e3]
    return events, busy_us / 1e3, rows


def one_tree_k1(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _kernels as K
    from pulseportraiture_tpu_torch.fit import portrait as fp

    K.set_build_dir(tempfile.mkdtemp(prefix="k1_build_"))  # nvcc's report
    K.build()
    cuobjdump = os.path.join(os.path.dirname(K._nvcc()), "cuobjdump")
    lib = [f for f in os.listdir(K.BUILD_DIR)
           if f.startswith("libmoments-") and f.endswith(".so")][0]
    sass = subprocess.run(
        [cuobjdump, "-sass", os.path.join(K.BUILD_DIR, lib)],
        capture_output=True, text=True, check=True).stdout
    res = dict(tree=root, gpu=cs.gpu_line(),
               sass_loops=sass_loops(sass, K1_KERNEL_NAME, _is_k1_harmonic),
               ptxas=[ln for ln in K.BUILD_LOG.get("moments", "").splitlines()
                      if "Used" in ln or "spill" in ln])
    gh = hasattr(K, "moments_grad_hess")
    floor = hasattr(K, "moments_launch_floor")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev,
                          dtype=torch.float64)

    times = {}
    for n, nchan, nh, nlanes in [(1000, 512, 128, None), (48, 512, 128, None),
                                 (16, 256, 128, None), (1, 512, 128, None),
                                 (64, 512, 128, 40), (15, 512, 128, None)]:
        cross = torch.complex(rand(n, nchan, nh) - 0.5,
                              rand(n, nchan, nh) - 0.5)
        inv_err2 = rand(n, nchan) + 0.5
        lanes = None if nlanes is None else torch.sort(torch.randperm(
            n, generator=gen, device=dev)[:nlanes]).values
        m = n if lanes is None else nlanes
        shifts = (rand(m, nchan) - 0.5) * 4000.0
        row = {}
        calls = {"moments": (K.moments, (cross, shifts, inv_err2, lanes))}
        if gh:
            pd = torch.stack([torch.ones((m, nchan), dtype=torch.float64,
                                         device=dev),
                              (rand(m, nchan) - 0.5) * 0.4,
                              (rand(m, nchan) - 0.5) * 2e-3], 1).contiguous()
            S = (rand(n, nchan) + 0.1) * inv_err2
            calls["moments_grad_hess"] = (
                K.moments_grad_hess, (cross, shifts, pd, S, inv_err2, lanes))
        for name, (fn, args) in calls.items():
            row[name] = cs.graph_ms(lambda: fn(*args))
        if floor:
            row["floor"] = cs.graph_ms(
                lambda: K.moments_launch_floor(m, nchan, dev))
        times["%dx%dx%d%s" % (n, nchan, nh, "" if nlanes is None else
                              "-lanes%d" % nlanes)] = row
        del cross, calls
    res["times_ms"] = times
    torch.cuda.empty_cache()

    evals = {}
    for n in (1000, 16):
        nchan, nh = 512, 128
        cross = torch.complex(rand(n, nchan, nh) - 0.5,
                              rand(n, nchan, nh) - 0.5)
        inv_err2 = rand(n, nchan) + 0.5
        S = (rand(n, nchan) + 0.1) * inv_err2
        freqs = torch.linspace(1300.0, 1700.0, nchan, dtype=torch.float64,
                               device=dev).expand(n, nchan).contiguous()
        P = torch.full((n, 1), cs.P0, dtype=torch.float64, device=dev)
        sp = fp._Spectra(cross, None, S, inv_err2, freqs, P)
        params = torch.zeros((n, 5), dtype=torch.float64, device=dev)
        params[:, 0], params[:, 1] = rand(n) - 0.5, (rand(n) - 0.5) * 4e-3
        nus = tuple(torch.full((n, 1), 1500.0, dtype=torch.float64,
                               device=dev) for _ in range(3))

        def one():
            return sp.grad_hess(params, nus, (1, 1, 0, 0, 0))

        events, busy, rows = device_profile(one)
        evals["%dx%dx%d" % (n, nchan, nh)] = dict(
            device_events=events, device_busy_ms=busy, k1_rows=rows,
            wall_ms=cs.cuda_ms(one))
        del sp, cross
    res["evaluation"] = evals
    torch.cuda.empty_cache()

    nsub, nchan, nbin = 1000, 512, 2048
    data, freqs, nu0, phis, dDMs, model = cs.north_star_data(
        dev, 0, nsub, nchan, nbin)[:6]
    kmax = fp.model_kmax(model)
    errs = torch.full((nsub, nchan), cs.NOISE, dtype=torch.float64,
                      device=dev)

    def run():
        return fp.fit_portrait_full_batch(
            data, model, None, cs.P0, freqs, errs=errs,
            fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30,
            kmax=kmax, device=dev)

    run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    events, busy, rows = device_profile(run)
    res.update(fit_walls_s=walls, device_events=events, device_busy_ms=busy,
               k1_rows=rows, peak_device_bytes=int(peak),
               peak_above_prior_bytes=int(peak - base),
               nfev_median=float(out.nfeval.double().median()),
               nfev_max=int(out.nfeval.max()),
               return_codes=sorted(int(c)
                                   for c in out.return_code.unique()))
    print(json.dumps(res), flush=True)


def device_top(fn, n=8):
    """(device events, device-busy ms, the ``n`` longest device rows as
    [name, ms, count]) of one call of fn() under torch.profiler, the
    pp_* ranges left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA") \
                or e.key.startswith("pp_"):
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        rows.append([e.key[:60], us / 1e3, e.count])
    rows.sort(key=lambda r: -r[1])
    return (sum(r[2] for r in rows), sum(r[1] for r in rows), rows[:n])


SPECTRA_WALLS = 10


def fit_numbers(fn):
    """Steady walls [s] of fn() (after one warm call), its profile
    (device_top) and its peak device memory above the prior allocation;
    returns (dict, the last result)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(SPECTRA_WALLS):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    events, busy, top = device_top(fn)
    return dict(walls_s=times, wall_median_s=sorted(times)[SPECTRA_WALLS // 2],
                device_events=events, device_busy_ms=busy, device_top=top,
                peak_device_bytes=int(peak),
                peak_above_prior_bytes=int(peak - base),
                nfev_median=float(out.nfeval.double().median()),
                return_codes=sorted(int(c) for c in
                                    out.return_code.unique())), out


def one_tree_spectra(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _kernels as K
    from pulseportraiture_tpu_torch.fit import portrait as fp

    K.set_build_dir(tempfile.mkdtemp(prefix="k4_build_"))  # nvcc's report
    K.build()
    dev = torch.device("cuda")
    res = dict(tree=root, gpu=cs.gpu_line(), has_k4=hasattr(K, "spectra"),
               ptxas=[ln for ln in K.BUILD_LOG.get("spectra", "").splitlines()
                      if "Used" in ln or "spill" in ln])
    if res["has_k4"]:
        gen = torch.Generator(device=dev).manual_seed(7)
        res["k4"] = {name: {key: row[key] for key in (
            "shape", "ms", "bound_ms", "share_of_bound", "plain_ms",
            "errors")} for name, row in zip(cs.K4_NAMES, cs.phase_k4(
                dev, K, gen, *cs.K4_CASES[0]))}
        torch.cuda.empty_cache()
    nsub, nchan, nbin = 1000, 512, 2048
    data, freqs, nu0, _, _, model = cs.north_star_data(
        dev, 0, nsub, nchan, nbin)[:6]
    kmax = fp.model_kmax(model)
    errs = torch.full((nsub, nchan), cs.NOISE, dtype=torch.float64,
                      device=dev)
    kw = dict(fit_flags=(1, 1, 0, 0, 0), log10_tau=False, max_iter=30,
              kmax=kmax, device=dev)
    res["throughput"] = fit_numbers(lambda: fp.fit_portrait_full_batch(
        data, model, None, cs.P0, freqs, errs=errs, **kw))[0]
    res["throughput_no_errs"] = fit_numbers(
        lambda: fp.fit_portrait_full_batch(data, model, None, cs.P0, freqs,
                                           **kw))[0]
    del data, errs
    torch.cuda.empty_cache()
    data, freqs, nu0, phis, dDMs, model = cs.north_star_data(
        dev, 3, nsub, nchan, nbin, t_scat=cs.TAU_INJ * cs.P0)[:6]
    errs = torch.full((nsub, nchan), cs.NOISE, dtype=torch.float64,
                      device=dev)
    init = torch.zeros((nsub, 5), dtype=torch.float64, device=dev)
    init[:, 0], init[:, 1] = phis, dDMs
    init[:, 3], init[:, 4] = math.log10(cs.TAU_INJ * 1.5), -4.0
    nus = torch.full((nsub,), nu0, dtype=torch.float64, device=dev)
    res["throughput_scat"] = fit_numbers(lambda: fp.fit_portrait_full_batch(
        data, model, init, cs.P0, freqs, errs=errs, fit_flags=(1, 1, 0, 1, 1),
        nu_fits=(nus, nus, nus), nu_outs=(nus, nus, nus), log10_tau=True,
        max_iter=30, kmax=fp.model_kmax(model), device=dev))[0]
    print(json.dumps(res), flush=True)


def ppgauss_archive(work):
    """The averaged archive --ppgauss fits (this tree's make_fake_pulsar)."""
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
    from pulseportraiture_tpu_torch.io.gmodel import write_model

    root = os.path.dirname(os.path.abspath(__file__))
    gm = os.path.join(work, "one.gmodel")
    write_model(gm, "fake", "000", 1500.0,
                [0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2],
                [1] * 8, -4.0, 0, quiet=True)
    return make_fake_pulsar(
        gm, os.path.join(root, "examples", "example.par"),
        os.path.join(work, "avg.fits"), nsub=1, nchan=512, nbin=2048,
        nu0=1500.0, bw=800.0, tsub=60.0, noise_stds=0.05, dedispersed=True,
        seed=3, quiet=True)


def one_tree_ppgauss(root, archive):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from pulseportraiture_tpu_torch import _kernels as K
    from pulseportraiture_tpu_torch.cli import ppgauss
    from pulseportraiture_tpu_torch.models import gauss as mg

    fit, fits, built = mg.fit_gaussian_portrait, [], []
    make = mg.GaussianModelPortrait.make_gaussian_model

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = fit(*a, **kw)
        torch.cuda.synchronize()
        fits.append(dict(s=time.perf_counter() - t0, nfev=int(out.nfev),
                         rc=int(out.return_code)))
        return out

    def keep(self, *a, **kw):
        built.append(self)
        return make(self, *a, **kw)

    mg.fit_gaussian_portrait = timed
    mg.GaussianModelPortrait.make_gaussian_model = keep
    out = os.path.join(tempfile.mkdtemp(prefix="ppgauss_"), "m.gmodel")
    argv = ["-d", archive, "--autogauss", "0.05", "--niter", "2", "-o", out,
            "--device", "cuda"]
    for _ in range(2):
        del fits[:], built[:]
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = ppgauss.main(argv)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit("ppgauss exited %d" % rc)
    print(json.dumps(dict(
        tree=root, cli_s=wall, fits=fits,
        launches={k: v for k, v in K.LAUNCHES.items() if v},
        params=[float(v) for v in built[-1].model_params],
        errs=[float(v) for v in built[-1].model_param_errs])), flush=True)


def host_ms(fn, reps=200):
    """Host ms per call of ``fn`` (its enqueue: no sync in the loop)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / reps


def one_tree_k9(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _kernels as K

    K.build(["gauss_normal", "gauss_sse"])
    dev = torch.device("cuda")
    rows = []
    for ngauss, B in cs.K9_CASES:
        args = cs.k9_inputs(dev, ngauss, B)
        work = K.GaussWork(*args[1:]) if hasattr(K, "GaussWork") else None
        kw = {} if work is None else dict(work=work)
        row = dict(ngauss=ngauss, lanes=B)
        for name in ("gauss_normal", "gauss_sse"):
            fn = getattr(K, name)
            row[name] = dict(ms=cs.graph_ms(lambda: fn(*args, **kw)),
                             call_ms=cs.cuda_ms(lambda: fn(*args), reps=50),
                             host_ms=host_ms(lambda: fn(*args)))
            if work is not None:
                row[name]["work_call_ms"] = cs.cuda_ms(
                    lambda: fn(*args, work=work), reps=50)
                row[name]["work_host_ms"] = host_ms(
                    lambda: fn(*args, work=work))
        rows.append(row)
        torch.cuda.empty_cache()
    # gauss_normal's and gauss_sse's device ms as the bins and channels
    # grow, one lane, through a work where the tree has one: what is fixed
    # per call and per block, what grows with the bins
    sweep = []
    for ngauss in (1, 3, 19):
        for nchan, nbin in ((512, 512), (512, 1024), (512, 2048),
                            (512, 4096), (128, 2048), (2048, 2048)):
            args = cs.k9_inputs(dev, ngauss, 1, nchan, nbin)
            kw = {} if not hasattr(K, "GaussWork") else dict(
                work=K.GaussWork(*args[1:]))
            sweep.append(dict(
                ngauss=ngauss, nchan=nchan, nbin=nbin,
                normal_ms=cs.graph_ms(lambda: K.gauss_normal(*args, **kw)),
                sse_ms=cs.graph_ms(lambda: K.gauss_sse(*args, **kw))))
            torch.cuda.empty_cache()
    panels = []
    for ngauss in (19, 20, 21, 24, 41, 43):
        args = cs.k9_inputs(dev, ngauss, 1)
        kw = {} if not hasattr(K, "GaussWork") else dict(
            work=K.GaussWork(*args[1:]))
        panels.append(dict(
            ngauss=ngauss,
            normal_ms=cs.graph_ms(lambda: K.gauss_normal(*args, **kw)),
            sse_ms=cs.graph_ms(lambda: K.gauss_sse(*args, **kw))))
        torch.cuda.empty_cache()
    ptxas = [ln.strip() for ln in K.BUILD_LOG.get("gauss", "").splitlines()
             if "Used" in ln or "spill" in ln]
    print(json.dumps(dict(tree=root, gpu=cs.gpu_line(), k9=rows,
                          sweep=sweep, panels=panels, ptxas=ptxas)),
          flush=True)


def one_tree_k10(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _kernels as K

    K.build(["gauss_ft_normal", "gauss_ft_sse"])
    dev = torch.device("cuda")
    shapes = [(ng, kind, 2048) for ng in (1, 4, 19)
              for kind in ("tau", "tau0", "joined", "joined_tau")]
    rows = []
    for ngauss, kind, nbin in shapes + [(19, "tau", 8192)]:
        args, joins = cs.k10_inputs(dev, ngauss, kind, 1, 512, nbin)
        work = K.GaussFtWork(*args[1:])
        row = dict(ngauss=ngauss, kind=kind, nbin=nbin)
        if hasattr(K, "gauss_ft_path"):
            row["cluster"] = K.gauss_ft_path(ngauss, len(joins), 512,
                                             nbin)["cluster"]
        for name in ("gauss_ft_normal", "gauss_ft_sse"):
            fn = getattr(K, name)
            row[name] = cs.graph_ms(lambda: fn(*args, work=work))
        rows.append(row)
        del work
        torch.cuda.empty_cache()
    ptxas = [ln.strip() for ln in K.BUILD_LOG.get("gauss_ft", "").splitlines()
             if "Used" in ln or "spill" in ln]
    print(json.dumps(dict(tree=root, gpu=cs.gpu_line(), k10=rows,
                          ptxas=ptxas)), flush=True)


def params_gaps(lines):
    """Each --ppgauss run's largest parameter gap to the first run's,
    over the first run's finite errors."""
    import numpy as np

    runs = [json.loads(ln) for ln in lines]
    p0, e0 = (np.asarray(runs[0][k]) for k in ("params", "errs"))
    fin = np.isfinite(e0) & (e0 > 0)
    return [float(np.max(np.abs(np.asarray(r["params"]) - p0)[fin]
                         / e0[fin])) for r in runs]


def main(argv):
    mode = argv[0] if argv and argv[0] in ("--k1", "--spectra", "--ppgauss",
                                           "--k9", "--k10") else None
    if mode:
        argv = argv[1:]
    if len(argv) >= 2 and argv[0] == "--tree":
        if mode == "--spectra":
            one_tree_spectra(argv[1])
        elif mode == "--ppgauss":
            one_tree_ppgauss(argv[1], argv[2])
        elif mode == "--k9":
            one_tree_k9(argv[1])
        elif mode == "--k10":
            one_tree_k10(argv[1])
        else:
            (one_tree_k1 if mode else one_tree)(argv[1])
        return 0
    if not argv:
        print(__doc__)
        return 2
    extra = []
    if mode == "--ppgauss":
        extra = [ppgauss_archive(tempfile.mkdtemp(prefix="ppgauss_data_"))]
    rc, lines = 0, []
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__)]
                           + ([mode] if mode else [])
                           + ["--tree", root] + extra,
                           capture_output=True, text=True)
        print(r.stdout.strip(), flush=True)
        if r.returncode:
            print(r.stderr[-2000:], file=sys.stderr, flush=True)
            rc = r.returncode
        elif mode == "--ppgauss":
            lines.append(r.stdout.strip().splitlines()[-1])
    if mode == "--ppgauss" and lines:
        print(json.dumps(dict(params_gap_over_errs=params_gaps(lines))),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
