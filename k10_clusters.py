"""K10's epilogue B (``_kernels.gauss_ft_normal``) across its path rule's
limits, on one GPU.

For each source tree given (a checkout of this repository, e.g. the
parent commit unpacked with ``git archive`` into a git-ignored
directory), in a subprocess of its own: builds the tree's kernels and
times ``gauss_ft_normal`` by CUDA-graph replay (``chip_smoke.graph_ms``,
through a GaussFtWork) at one lane of [512, nbin] over component counts
and widths (``SHAPES``; chip_smoke.py's ``k10_inputs``, kind "tau"),
with the path each shape takes where the tree reports one (cluster size,
rows a transform batch; 0 for the staged rows).  With ``--wide`` before
a tree, a copy of its ``csrc/`` has the on-chip rule's limits raised
(``kMaxCluster`` to 8 blocks, ``kMaxBatches`` to 64 batches a block), so
the shapes past them run the on-chip kernel too.  Each tree prints one
JSON line:

    python3 k10_clusters.py PARENT_DIR . --wide .

Needs a CUDA device and the CUDA toolkit (nvcc).
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

SHAPES = [(ng, 2048) for ng in (1, 2, 3, 4, 5, 6, 8, 12, 16, 19)] + [
    (ng, 1024) for ng in (1, 4, 8, 12, 16)] + [
    (ng, 4096) for ng in (1, 2, 4)] + [(1, 512), (10, 512)]
WIDE = (("constexpr int kMaxCluster = 2;", "constexpr int kMaxCluster = 8;"),
        ("constexpr int kMaxBatches = 3;", "constexpr int kMaxBatches = 64;"))


def one(root, wide):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from pulseportraiture_tpu_torch import _kernels as K

    if wide:
        tmp = tempfile.mkdtemp(prefix="k10_wide_")
        src = os.path.join(tmp, "csrc")
        shutil.copytree(K.CSRC_DIR, src)
        path = os.path.join(src, "gauss_ft.cu")
        text = open(path).read()
        for old, new in WIDE:
            if old not in text:
                raise SystemExit("%s: no line %r" % (path, old))
            text = text.replace(old, new)
        open(path, "w").write(text)
        K.CSRC_DIR = src
        K.set_build_dir(os.path.join(tmp, "build"))
    K.build(["gauss_ft_normal"])
    dev = torch.device("cuda")
    rows = []
    for ng, nbin in SHAPES:
        args, _ = cs.k10_inputs(dev, ng, "tau", 1, 512, nbin)
        work = K.GaussFtWork(*args[1:])
        row = dict(ngauss=ng, nbin=nbin)
        if "cluster" in getattr(K, "GAUSS_FT_SIZES", ()):
            sz = K.gauss_ft_sizes(ng, 0, 512, nbin)
            row.update(cluster=sz["cluster"], batch=sz["batch"])
        row["ms"] = cs.graph_ms(lambda: K.gauss_ft_normal(*args, work=work))
        rows.append(row)
        del work
        torch.cuda.empty_cache()
    print(json.dumps(dict(tree=root, wide=wide, gpu=cs.gpu_line(),
                          rows=rows)), flush=True)


def main(argv):
    if len(argv) >= 2 and argv[0] == "--tree":
        one(argv[1], len(argv) > 2 and argv[2] == "--wide")
        return 0
    if not argv:
        print(__doc__)
        return 2
    rc, wide = 0, False
    for arg in argv:
        if arg == "--wide":
            wide = True
            continue
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--tree", arg] + (["--wide"] if wide else []),
                           capture_output=True, text=True)
        print(r.stdout.strip(), flush=True)
        if r.returncode:
            print(r.stderr[-2000:], file=sys.stderr, flush=True)
            rc = r.returncode
        wide = False
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
