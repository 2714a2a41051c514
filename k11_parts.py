"""Where K11's time goes (``_kernels.noise_fit``, csrc/noisefit.cu), on one
GPU.

Builds csrc/noisefit.cu as it stands and copies of it changed by a text
substitution in a temporary directory (``PARTS``): one harmonic a lane at
a time instead of four (``unroll1``: one load in flight a lane, the
kernel's first design; the same answer), the general instantiation in
place of kFast (``general``: the power's pointer and the shape passes
decided at run time; the same answer), and with one part left out: the
dot products with the shapes (``no_dots``), the second pass's log10
(``no_log2``), the first pass's (``no_p1log``), the (a, b, dc) grid
(``no_grid``: a = a_0), and all of those (``memory_only``).  A copy
without a part computes a wrong answer; only its time is read.  Each is
timed by CUDA-graph replay (``chip_smoke.graph_ms``) on one launch over
the noise_fit phase's [131072, 1025] spectrum (131,072 rows of 2048 bins:
white noise, half of them with a pulse), in turns (each variant, then
again in reverse order).  Prints one JSON line: the card, each variant's
registers and its two times, and whether ``unroll1`` and ``general`` gave
the kernel's bits.

    python3 k11_parts.py

Needs a CUDA device and the CUDA toolkit (nvcc).
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
DOTS = """#pragma unroll
            for (int u = 0; u < kAcc; ++u)
              if (u0 + u < nu)
                acc[u] = __dadd_rn(acc[u],
                                   __dmul_rn(y, __ldg(shapes + (int64_t)(u0 + u) * n + k)));"""
PARTS = {
    "unroll1": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;")],
    "general": [("const bool fast = onchip && nu <= kAcc;",
                 "const bool fast = false;")],
    "no_dots": [(DOTS, "")],
    "no_log2": [("__dsub_rn(log10(power(k)), mean)", "__dsub_rn(power(k), mean)")],
    "no_p1log": [("const double l = log10(v[j]);", "const double l = v[j];")],
    "no_grid": [("for (int pq = q; pq < nn; pq += kLanes) {",
                 "for (int pq = q; pq < 0; pq += kLanes) {"),
                ("bi = INT64_MAX;", "bi = 0;")],
}
PARTS["memory_only"] = [sub for name in ("no_dots", "no_log2", "no_p1log",
                                         "no_grid") for sub in PARTS[name]]


def main():
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _kernels as K
    from pulseportraiture_tpu_torch.ops import noise

    if not torch.cuda.is_available():
        raise SystemExit("k11_parts: no CUDA device")
    text = open(os.path.join(K.CSRC_DIR, "noisefit.cu")).read()
    tmp = tempfile.mkdtemp(prefix="k11_parts_")
    variants = dict(base=[], **PARTS)
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if old not in src:
                raise SystemExit("k11_parts: %s: no text %r" % (name, old))
            src = src.replace(old, new)
        path = os.path.join(tmp, name + ".cu")
        open(path, "w").write(src)
        procs[name] = subprocess.Popen(
            [K._nvcc()] + K.NVCC_FLAGS + ["-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, regs = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit("k11_parts: nvcc failed for %s:\n%s"
                             % (name, out))
        regs[name] = [int(r) for r in re.findall(r"Used (\d+) registers",
                                                 out)]
        fn = ctypes.CDLL(os.path.join(tmp, name + ".so")).pp_noise_fit
        fn.argtypes = K._SYMBOLS["noise_fit"]["pp_noise_fit"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rows, nbin = 131072, 2048
    x = torch.randn((rows, nbin), generator=g, dtype=torch.float64,
                    device=dev)
    ph = (torch.arange(nbin, dtype=torch.float64, device=dev) + 0.5) / nbin
    x[:rows // 2] += 20.0 * torch.exp(-0.5 * ((ph - 0.4) / 0.01) ** 2)
    X = torch.fft.rfft(x, dim=-1)
    del x
    N = nbin // 2 + 1
    grid = noise._kc_grid(N, "exp_dc", 20, dev)
    outs = tuple(torch.empty(rows, dtype=dt, device=dev)
                 for dt in (torch.float64, torch.int64))

    def launch(fn):
        err = fn(X.data_ptr(), 1, rows, N, nbin, grid.uniq.data_ptr(),
                 grid.uniq.shape[0], grid.inverse32.data_ptr(),
                 grid.S1.data_ptr(), grid.S2.data_ptr(), grid.kc.data_ptr(),
                 20, 1.1, int(0.99 * N), *(o.data_ptr() for o in outs),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit("k11_parts: launch failed: %d" % err)

    ms = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        ms[name].append(cs.graph_ms(lambda: launch(fns[name]), reps=10))
    launch(fns["base"])
    want = tuple(o.clone() for o in outs)
    same = {}
    for name in ("unroll1", "general"):
        launch(fns[name])
        same[name] = all(torch.equal(a, b) for a, b in zip(outs, want))
    bound, by = cs.k11_bound_ms(rows, N, int(grid.uniq.shape[0]))
    print(json.dumps(dict(gpu=cs.gpu_line(), shape=[rows, N],
                          bound_ms=bound, bound_by=by, registers=regs,
                          ms=ms, bit_equal=same)), flush=True)


if __name__ == "__main__":
    main()
