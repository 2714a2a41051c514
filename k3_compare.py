"""Compare kernel K3 and the scattering fit across source trees on one GPU.

For each tree given (a checkout of this repository, e.g. the parent
commit unpacked with ``git archive`` into a git-ignored directory), in the
order given, in a subprocess of its own:

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

Each tree prints one JSON line; run the trees alternately (parent,
change, change, parent) to compare them within one call:

    python3 k3_compare.py PARENT_DIR . . PARENT_DIR

Needs a CUDA device and the CUDA toolkit (nvcc, cuobjdump).
"""

import json
import math
import os
import re
import subprocess
import sys
import time

FP64_OPS = ("DFMA", "DMUL", "DADD", "DSETP", "FRND")
KERNEL_NAME = r"moments_scat(?:_grad_hess)?_kernel"


def sass_loops(sass):
    """{kernel: [per-loop {op: count, "harmonics": n}]} for the
    moments_scat* kernels of a cuobjdump -sass listing."""
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = func.split("\n", 1)[0]
        kernel = re.findall(KERNEL_NAME, name)
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
                counts["harmonics"] = sum(1 for o in body
                                          if o == "MUFU.RCP64H")
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


def main(argv):
    if len(argv) >= 2 and argv[0] == "--tree":
        one_tree(argv[1])
        return 0
    if not argv:
        print(__doc__)
        return 2
    rc = 0
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", root], capture_output=True, text=True)
        print(r.stdout.strip(), flush=True)
        if r.returncode:
            print(r.stderr[-2000:], file=sys.stderr, flush=True)
            rc = r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
