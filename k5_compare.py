"""Compare kernel K5 (csrc/unpack.cu) and the archive load across source
trees on one GPU.

For each tree given (a checkout of this repository, e.g. the parent
commit unpacked with ``git archive`` into a git-ignored directory), in the
order given, in a subprocess of its own:

* builds the tree's K5 (nvcc's register report of a fresh build);
* times K5 on the pptoas archive's column, [65536, 2048] (128 subints x
  512 channels of random int16, seeded): the decode with the baseline
  (``_kernels.unpack(..., frac=0.125)``), the baseline alone of the
  decoded rows (``_kernels.baseline``) and the decode alone, each by
  CUDA-graph replay (``chip_smoke.graph_ms``), beside its bound
  (``chip_smoke.load_bound_ms``), the decode's gap to the tree's plain
  version (bit-equal) and the baseline's (relative to each row's range);
  the column goes in as the tree's K5 takes it: the file's big-endian
  bytes where the tree has ``_kernels.stored_values``, native int16
  before;
* with ``--load ARCHIVE``: ``io.archive.load_data`` on the card with
  pptoas's flags, three walls and the seconds of each step (``split``).

Each tree prints one JSON line; run the trees alternately (parent,
change, change, parent) to compare them within one call:

    python3 k5_compare.py [--load ARCHIVE] PARENT_DIR . . PARENT_DIR

``--write-archive PATH`` writes the 128 x 512 x 2048 archive (this tree's
make_fake_pulsar, chip_smoke.py's pptoas archive) and exits.  Needs a
CUDA device and the CUDA toolkit (nvcc).
"""

import json
import os
import subprocess
import sys
import time

ROWS, NBIN = 128 * 512, 2048


def one_tree(root, archive=None):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _kernels as K

    K.build(["unpack", "baseline"])
    res = dict(tree=root, gpu=cs.gpu_line(), stored_column=hasattr(
        K, "stored_values"), ptxas=[ln for ln in K.BUILD_LOG.get(
            "unpack", "").splitlines() if "Used" in ln or "spill" in ln])
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    vals = rng.integers(-32768, 32768, (ROWS, NBIN)).astype(np.int16)
    col = vals.astype(">i2").view(np.int16) if res["stored_column"] \
        else vals
    raw = torch.from_numpy(col).to(dev)
    scl = torch.as_tensor(rng.uniform(1e-4, 1e-2, ROWS), device=dev)
    offs = torch.as_tensor(rng.uniform(-50, 50, ROWS), device=dev)
    x = K.unpack(raw, scl, offs)
    want = torch.from_numpy(vals).to(dev).to(torch.float64) * scl[:, None] \
        + offs[:, None]
    base = K.baseline_plain(x.clone())
    spread = (base.amax(-1, keepdim=True) - base.amin(-1, keepdim=True))
    both = K.unpack(raw, scl, offs, frac=0.125)
    alone = K.baseline(x)
    res["decode_bit_equal"] = bool(torch.equal(x, want))
    res["baseline_gap"] = float(((both - base).abs() / spread).max())
    res["baseline_alone_gap"] = float(((alone - base).abs() / spread).max())
    out = torch.empty_like(x)
    cases = dict(
        unpack=(lambda: K.unpack(raw, scl, offs, 0.125, out=out), "unpack"),
        baseline=(lambda: K.baseline(x, out=out), "baseline"),
        decode=(lambda: K.unpack(raw, scl, offs, out=out), "unpack"))
    for name, (fn, bname) in cases.items():
        ms = cs.graph_ms(fn)
        bms, by = cs.load_bound_ms(bname, ROWS, NBIN)
        if name == "decode":   # int16 in, float64 out, no window sums
            bms, by = cs.bound_ms(ROWS * NBIN * 10 + ROWS * 16,
                                  (ROWS * NBIN * 2, cs.PEAK_FP64_PER_S))
        res[name] = dict(ms=ms, bound_ms=bms, bound_by=by,
                         share_of_bound=bms / ms)
    del raw, x, out, both, alone, base, want
    torch.cuda.empty_cache()
    if archive is not None:
        from pulseportraiture_tpu_torch.io.archive import load_data

        kw = dict(cs.PPTOAS_LOAD)
        kw.pop("keep_cube", None)
        load_data(archive, device=dev, **kw)  # cuFFT plans, pinned buffers
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            load_data(archive, device=dev, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        split = {}
        load_data(archive, device=dev, split=split, **kw)
        res["load"] = dict(wall_s=walls, split_s=split)
    print(json.dumps(res), flush=True)


def write_archive(path):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar

    root = os.path.dirname(os.path.abspath(__file__))
    nsub, nchan, nbin = cs.PPTOAS_SHAPE
    make_fake_pulsar(os.path.join(root, "examples", "example.gmodel"),
                     os.path.join(root, "examples", "example.par"), path,
                     nsub=nsub, nchan=nchan, nbin=nbin, nu0=1500.0,
                     bw=800.0, tsub=60.0, phase=cs.PHASE_INJ,
                     dDM=cs.DDM_INJ, weights=cs.smoke_weights(nsub, nchan),
                     noise_stds=0.5, seed=11)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--write-archive":
        write_archive(argv[1])
        return 0
    archive = None
    if len(argv) >= 2 and argv[0] == "--load":
        archive, argv = os.path.abspath(argv[1]), argv[2:]
    if len(argv) >= 2 and argv[0] == "--tree":
        one_tree(argv[1], archive)
        return 0
    if not argv:
        print(__doc__)
        return 2
    rc = 0
    for root in argv:
        r = subprocess.run([sys.executable, os.path.abspath(__file__)]
                           + (["--load", archive] if archive else [])
                           + ["--tree", root], capture_output=True,
                           text=True)
        print(r.stdout.strip(), flush=True)
        if r.returncode:
            print(r.stderr[-2000:], file=sys.stderr, flush=True)
            rc = r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
