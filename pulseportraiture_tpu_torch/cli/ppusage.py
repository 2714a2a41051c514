"""ppusage command-line tool: usage rollups and cost attribution.

A copy of the JAX package's ``cli/ppusage.py`` over the port's
``obs.usage``; it reads ledgers either package wrote.

Front-end for the usage-accounting plane (obs/usage.py, documented in
docs/OBSERVABILITY.md "Usage & quotas"): aggregate the per-run
``usage.jsonl`` ledgers — live files, rotated chains, per-process
shards, merged fleet dirs — into exact per-tenant and per-bucket
tables with top-N consumers and device-seconds-per-fit.

    python -m pulseportraiture_tpu_torch.cli.ppusage workdir/obs
    python -m pulseportraiture_tpu_torch.cli.ppusage --top 5 run1 run2
    python -m pulseportraiture_tpu_torch.cli.ppusage --json fleetdir

Rollups are pure order-independent sums, so pointing ppusage at any
mix of run dirs, shard dirs, and single ledger files yields the same
totals as rolling up their concatenation — each ledger file is read
exactly once even when roots overlap.
"""

import argparse
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppusage",
        description="Per-tenant usage rollups from usage.jsonl "
                    "ledgers (docs/OBSERVABILITY.md).")
    p.add_argument("paths", nargs="+", metavar="PATH",
                   help="Run dir, workdir, obs base dir, or ledger "
                        "file (searched recursively for usage "
                        "ledgers).")
    p.add_argument("-n", "--top", type=int, default=10, metavar="N",
                   help="Rows in the top-consumers table "
                        "(default 10).")
    p.add_argument("-t", "--tenant", default=None,
                   help="Only this tenant's records.")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="Emit the combined rollup as JSON instead of "
                        "tables.")
    return p


def find_ledger_dirs(root):
    """Every directory under ``root`` holding usage-ledger files
    (``usage.jsonl`` chains or ``usage.<proc>.jsonl`` shards)."""
    from ..obs.usage import usage_files

    found = []
    for dirpath, _dirnames, _filenames in os.walk(root):
        if usage_files(dirpath):
            found.append(dirpath)
    return sorted(found)


def collect_records(paths):
    """Read every usage record reachable from ``paths`` exactly once
    (overlapping roots dedup on the resolved ledger-file path)."""
    from ..obs.usage import read_usage, usage_files

    files = []
    for path in paths:
        if os.path.isfile(path):
            files.append(path)
        else:
            for d in find_ledger_dirs(path):
                files.extend(usage_files(d))
    records = []
    seen = set()
    for fpath in files:
        real = os.path.realpath(fpath)
        if real in seen:
            continue
        seen.add(real)
        records.extend(read_usage(fpath))
    return records, len(seen)


def _per_fit(dev_s, archives):
    return "%.3f" % (dev_s / archives) if archives else "-"


def render_rollup(rolled, top=10):
    """The rollup as text tables (per-tenant, top consumers by
    device-seconds, per-bucket groups)."""
    lines = ["# ppusage: %d record(s), %.3f device-s, %d fit(s)" % (
        rolled["records"], rolled["device_s"], rolled["archives"])]
    tenants = rolled.get("tenants") or {}
    if tenants:
        lines.append("")
        lines.append("## per-tenant")
        lines.append("%-16s %8s %8s %8s %10s %10s %10s %12s" % (
            "tenant", "records", "requests", "fits", "wall-s",
            "device-s", "dev-s/fit", "bytes-in"))
        for t in sorted(tenants):
            v = tenants[t]
            lines.append("%-16s %8d %8d %8d %10.3f %10.3f %10s %12d"
                         % (t, v["records"], v["requests"],
                            v["archives"], v["wall_s"], v["device_s"],
                            _per_fit(v["device_s"], v["archives"]),
                            v["bytes_decoded"]))
        ranked = sorted(tenants,
                        key=lambda t: -tenants[t]["device_s"])[:top]
        lines.append("")
        lines.append("## top consumers (device-s)")
        for i, t in enumerate(ranked, 1):
            lines.append("%2d. %-16s %10.3f dev-s  %6d record(s)" % (
                i, t, tenants[t]["device_s"], tenants[t]["records"]))
    groups = rolled.get("groups") or {}
    if groups:
        lines.append("")
        lines.append("## per-bucket")
        lines.append("%-16s %-14s %-10s %8s %10s %10s" % (
            "tenant", "bucket", "workload", "records", "device-s",
            "dev-s/fit"))
        for gkey in sorted(groups):
            tenant, bucket, workload = gkey.split("|", 2)
            v = groups[gkey]
            lines.append("%-16s %-14s %-10s %8d %10.3f %10s" % (
                tenant, bucket, workload, v["records"], v["device_s"],
                _per_fit(v["device_s"], v["archives"])))
    return "\n".join(lines)


def main(argv=None):
    from ..obs.usage import rollup

    args = build_parser().parse_args(argv)
    records, n_files = collect_records(args.paths)
    if args.tenant is not None:
        records = [r for r in records
                   if (r.get("tenant") or "_local") == args.tenant]
    if not records:
        print("ppusage: no usage records under %s"
              % " ".join(args.paths), file=sys.stderr)
        return 1
    rolled = rollup(records)
    if args.as_json:
        rolled["ledger_files"] = n_files
        print(json.dumps(rolled, indent=1, sort_keys=True))
    else:
        print(render_rollup(rolled, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
