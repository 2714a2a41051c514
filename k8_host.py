"""Where a small call of kernel K8 (``_kernels.smooth_search``) spends its
time on one GPU: the device or the host.

At 2048 bins, 11 levels and 30 factors, for seeded rows of [10, 2048]
(seven noise rows, which the certification leaves uncertain, and three
pulse rows), [1, 2048] (one noise row) and [10, 2048] of pulse rows
alone, prints one JSON line per shape: the rows left uncertain, then the
ms per call by CUDA events over 50 calls back to back of

* ``A_call``: ``smooth_search`` (the set-up, the scan, the
  certification, one host sync, the route over the uncertain rows);
* ``B_route_all_call``: the route alone over every row (``_kernels._route``);
* ``D_scan_certify_sync``: the set-up, the scan and the certification
  with the sync; ``E_scan_certify_nosync`` without it;

and the host's own ms to issue 50 calls of A, B and E (``*_host_issue_ms``,
the host clock before the device is awaited), the ms to look up the
current stream and to allocate a small tensor.  Then torch.profiler's
table of host (CPU) time by operator for 10 calls of A at [10, 2048].

    python3 k8_host.py

Needs a CUDA device and the CUDA toolkit (nvcc).
"""

import json
import time

import numpy as np
import torch

import chip_smoke as cs
from pulseportraiture_tpu_torch import _kernels as K
from pulseportraiture_tpu_torch.ops.wavelet import (search_maxima,
                                                    search_tables)

NBIN, NLEVEL, NFACT, TOL = 2048, 11, 30, 0.1


def rows(rng, n, nnoise, dev):
    x = (np.arange(NBIN) + 0.5) / NBIN
    pulse = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2) \
        + 0.5 * np.exp(-0.5 * ((x - 0.5) / 0.04) ** 2)
    out = [rng.standard_normal(NBIN) * 0.05 for _ in range(nnoise)]
    out += [pulse * rng.uniform(3.0, 30.0) + rng.standard_normal(NBIN) * 0.1
            for _ in range(n - nnoise)]
    return torch.as_tensor(np.array(out), device=dev)


def host_ms(fn, reps=50):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def main():
    from torch.profiler import ProfilerActivity, profile

    K.build(["smooth_search"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    facts = torch.linspace(0.0, 3.0, NFACT, dtype=torch.float64, device=dev)
    tables = search_tables("db8", NBIN, NLEVEL, dev)
    maxima = search_maxima("db8", NBIN, NLEVEL, dev)
    print(cs.gpu_line(), flush=True)
    for n, nnoise in ((10, 7), (1, 1), (10, 0)):
        port = rows(rng, n, nnoise, dev)
        o = torch.empty_like(port)
        c = torch.empty((n, 2), dtype=torch.int64, device=dev)
        calls = dict(
            A=lambda: K.smooth_search(port, "db8", NLEVEL, facts, TOL),
            B=lambda: K._route(port, tables, facts, TOL, False, o, c,
                               card=True),
            E=lambda: K._scan_certify(port, tables, maxima, facts, TOL,
                                      False, o, c))
        flags, _ = calls["E"]()
        res = dict(shape=[n, NBIN], uncertain=int(flags.sum()),
                   A_call=cs.cuda_ms(calls["A"], reps=50),
                   B_route_all_call=cs.cuda_ms(calls["B"], reps=50),
                   D_scan_certify_sync=cs.cuda_ms(
                       lambda: torch.nonzero(calls["E"]()[0]), reps=50),
                   E_scan_certify_nosync=cs.cuda_ms(calls["E"], reps=50))
        for name, fn in calls.items():
            res[name + "_host_issue_ms"] = host_ms(fn)
        res["stream_lookup_ms"] = host_ms(
            lambda: torch.cuda.current_stream(dev).cuda_stream, reps=200)
        res["empty_ms"] = host_ms(lambda: torch.empty(
            (n, NLEVEL, NFACT), dtype=torch.float64, device=dev), reps=200)
        print(json.dumps(res), flush=True)
    port = rows(rng, 10, 7, dev)
    K.smooth_search(port, "db8", NLEVEL, facts, TOL)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            K.smooth_search(port, "db8", NLEVEL, facts, TOL)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=25), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
