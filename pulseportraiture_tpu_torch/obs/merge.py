"""Multi-process obs-shard merge: per-process runs into one report.

A multi-process job (one process per card, say) gives every
process its own recorder — per-process run directories whose contents
are copied into a shared shard directory as::

    <shards>/events.<proc>.jsonl[.N]   # rotated sets kept
    <shards>/manifest.<proc>.json

Process 0 then merges the shards into ONE run directory that
``tools/obs_report.py`` reads like any other:

* events are concatenated in timestamp order, each tagged with
  ``proc``; span/compile paths are prefixed ``p<proc>/`` so the phase
  table distinguishes hosts while aggregating names;
* fit telemetry passes through untouched — the report's per-subint
  convergence stats sum over every shard's fit events;
* ``devtime`` events (ingested profiler captures, obs/devtime.py) get
  their ``region`` prefixed ``p<proc>/`` like span paths; the phase
  and scope aggregations still sum across hosts by name;
* manifest counters/gauges are summed (numeric) or kept per-process,
  ``wall_s`` is the max (processes run concurrently), configs merged;
* usage ledgers (``usage.<proc>.jsonl``, obs/usage.py) concatenate —
  records are self-contained and rollups are pure sums, so the merged
  per-tenant totals are exact and order-independent.
"""

import json
import os
import re

from .core import list_event_files

__all__ = ["write_shard", "merge_obs_shards", "list_shards"]

_SHARD_RE = re.compile(r"^events\.(\d+)\.jsonl(?:\.(\d+))?$")


def _advance_shard(shards_dir, proc):
    """Rotate an existing shard set aside before publishing a new run.

    A workdir that chains sequential runs (the workload engine's
    zap→align→toas surveys share one workdir) calls ``write_shard``
    once per run with the same ``proc``; without rotation each call
    would overwrite the previous run's shard and the merged report
    would only show the last workload.  The previous live files move
    to the next free rotation index (rotation order is oldest-first,
    matching in-run size rotation), and the caller offsets the new
    run's own rotated files past them.  Returns the base index for
    the new run's rotated files.
    """
    live = os.path.join(shards_dir, "events.%d.jsonl" % proc)
    max_rot = 0
    try:
        for name in os.listdir(shards_dir):
            m = _SHARD_RE.match(name)
            if m and int(m.group(1)) == proc and m.group(2):
                max_rot = max(max_rot, int(m.group(2)))
    except OSError:
        pass
    if not os.path.isfile(live):
        return max_rot
    base = max_rot + 1
    os.replace(live, live + ".%d" % base)
    for name in ("manifest.%d.json" % proc,
                 "metrics.%d.jsonl" % proc,
                 "usage.%d.jsonl" % proc):
        src = os.path.join(shards_dir, name)
        if os.path.isfile(src):
            os.replace(src, src + ".%d" % base)
    return base


def _rotated_paths(shards_dir, base_name):
    """[oldest-first rotated copies..., live] for a shard-side file
    (``manifest.<proc>.json``, ``metrics.<proc>.jsonl``)."""
    out = []
    try:
        names = os.listdir(shards_dir)
    except OSError:
        names = []
    rot = []
    for name in names:
        if name.startswith(base_name + "."):
            tail = name[len(base_name) + 1:]
            if tail.isdigit():
                rot.append((int(tail), name))
    out.extend(os.path.join(shards_dir, n) for _, n in sorted(rot))
    live = os.path.join(shards_dir, base_name)
    if os.path.isfile(live):
        out.append(live)
    return out


def write_shard(run_dir, shards_dir, proc):
    """Copy a closed per-process run into the shared shard layout.

    Rotated event files keep their rotation index; the manifest is
    copied as ``manifest.<proc>.json``.  A shard already present for
    ``proc`` (an earlier sequential run in the same workdir, e.g. a
    prior workload pass) is advanced to rotated copies first, so
    chained runs accumulate instead of overwriting.  Returns the list
    of files written.
    """
    os.makedirs(shards_dir, exist_ok=True)
    base = _advance_shard(shards_dir, proc)
    written = []
    for src in list_event_files(run_dir):
        name = os.path.basename(src)          # events.jsonl[.N]
        suffix = name[len("events.jsonl"):]   # "" or ".N"
        if suffix and base:
            # keep global oldest-first order: this run's own rotation
            # indices shift past the previous runs' copies
            suffix = ".%d" % (base + int(suffix[1:]))
        dst = os.path.join(shards_dir,
                           "events.%d.jsonl%s" % (proc, suffix))
        with open(src, "rb") as sf, open(dst, "wb") as df:
            df.write(sf.read())
        written.append(dst)
    for name, pattern in (("manifest.json", "manifest.%d.json"),
                          ("metrics.jsonl", "metrics.%d.jsonl")):
        src = os.path.join(run_dir, name)
        if os.path.isfile(src):
            dst = os.path.join(shards_dir, pattern % proc)
            with open(src, "rb") as sf, open(dst, "wb") as df:
                df.write(sf.read())
            written.append(dst)
    # the usage ledger (obs/usage.py): records are order-independent,
    # so the run's rotated chain concatenates into ONE shard file —
    # no rotation-index bookkeeping to collide with the event set
    from .usage import usage_files

    srcs = usage_files(run_dir)
    if srcs:
        dst = os.path.join(shards_dir, "usage.%d.jsonl" % proc)
        with open(dst, "wb") as df:
            for src in srcs:
                with open(src, "rb") as sf:
                    df.write(sf.read())
        written.append(dst)
    return written


def list_shards(shards_dir):
    """{proc: [event files oldest-first]} found under ``shards_dir``."""
    shards = {}
    try:
        names = os.listdir(shards_dir)
    except OSError:
        return shards
    for name in names:
        m = _SHARD_RE.match(name)
        if not m:
            continue
        proc = int(m.group(1))
        rot = int(m.group(2)) if m.group(2) else None
        shards.setdefault(proc, []).append((rot, name))
    out = {}
    for proc, files in shards.items():
        # rotated files (oldest = .1) before the live (unsuffixed) file
        rotated = sorted((r, n) for r, n in files if r is not None)
        live = [n for r, n in files if r is None]
        out[proc] = [os.path.join(shards_dir, n)
                     for _, n in rotated] + \
                    [os.path.join(shards_dir, n) for n in live]
    return out


def _fold_snapshots(snaps):
    """Fold ONE process's sequential-run metrics snapshots into one:
    counters and histograms sum by identical series key (exact integer
    bucket sums), gauges last-write-wins with NO process prefix —
    unlike :func:`..metrics.merge_snapshots`, which is for DIFFERENT
    processes."""
    from .metrics import Histogram

    if len(snaps) == 1:
        return snaps[0]
    counters = {}
    gauges = {}
    hists = {}
    t = 0.0
    for s in snaps:
        t = max(t, float(s.get("t", 0.0) or 0.0))
        for k, v in (s.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        gauges.update(s.get("gauges") or {})
        for k, h in (s.get("histograms") or {}).items():
            cur = hists.get(k)
            if cur is None:
                hists[k] = Histogram.from_snapshot(h)
            else:
                cur.merge(Histogram.from_snapshot(h))
    out = dict(snaps[-1])
    out.update(t=t, counters=counters, gauges=gauges,
               histograms={k: h.to_snapshot()
                           for k, h in sorted(hists.items())})
    return out


def _fold_manifests(docs):
    """Fold ONE process's sequential-run manifests (oldest-first) into
    one: counters/walls/compile totals sum, configs and gauges update
    newest-wins, identity fields (platform, git SHA, name) come from
    the newest run, ``t_start`` from the oldest."""
    if len(docs) == 1:
        return docs[0]
    out = dict(docs[-1])
    counters = {}
    gauges = {}
    config = {}
    wall = 0.0
    compile_total = 0.0
    t_start = None
    for m in docs:
        for k, v in (m.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        gauges.update(m.get("gauges") or {})
        config.update(m.get("config") or {})
        wall += float(m.get("wall_s", 0.0) or 0.0)
        compile_total += float(m.get("compile_total_s", 0.0) or 0.0)
        ts = m.get("t_start")
        if ts is not None:
            t_start = ts if t_start is None else min(t_start, ts)
    out.update(counters=counters, gauges=gauges, config=config,
               wall_s=wall, compile_total_s=round(compile_total, 6))
    if t_start is not None:
        out["t_start"] = t_start
    return out


def _read_events(path):
    events = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except json.JSONDecodeError:
                    pass  # torn tail line from a crashed shard
    except OSError:
        pass
    return events


def merge_obs_shards(shards_dir, out_dir):
    """Merge every ``events.<proc>.jsonl`` shard set (+ manifests)
    under ``shards_dir`` into one obs run at ``out_dir``.

    Returns ``out_dir``; raises FileNotFoundError when no shards
    exist.  Idempotent: re-merging overwrites the previous merge.
    """
    shards = list_shards(shards_dir)
    if not shards:
        raise FileNotFoundError(f"no obs shards under {shards_dir}")
    os.makedirs(out_dir, exist_ok=True)

    merged = []
    for proc in sorted(shards):
        for path in shards[proc]:
            for ev in _read_events(path):
                ev["proc"] = proc
                if ev.get("kind") in ("span", "compile"):
                    for field in ("path", "span"):
                        if ev.get(field):
                            ev[field] = "p%d/%s" % (proc, ev[field])
                elif ev.get("kind") == "devtime" and ev.get("region"):
                    # keep per-host capture regions distinguishable;
                    # the phase/scope aggregations (obs_report's
                    # device column) still sum across hosts by name
                    ev["region"] = "p%d/%s" % (proc, ev["region"])
                merged.append(ev)
    merged.sort(key=lambda e: e.get("t", 0.0))
    with open(os.path.join(out_dir, "events.jsonl"), "w",
              encoding="utf-8") as fh:
        for ev in merged:
            fh.write(json.dumps(ev) + "\n")

    # metrics snapshots (obs/metrics.py): the LAST parseable snapshot
    # of every shard's metrics.<proc>.jsonl merges exactly — integer
    # bucket sums over identical log-bucket edges, shard-order
    # independent — into one metrics.jsonl line the report's latency
    # section reads like any single-process run's
    from . import metrics as _metrics

    shard_snaps = {}
    for proc in sorted(shards):
        # one last-snapshot per metrics file: the live copy plus any
        # rotated copies from earlier chained runs, folded WITHOUT the
        # per-process gauge prefix (they are all this proc's)
        per_run = []
        for mpath in _rotated_paths(shards_dir,
                                    "metrics.%d.jsonl" % proc):
            snaps = [s for s in _read_events(mpath)
                     if isinstance(s, dict)
                     and (s.get("histograms") is not None
                          or s.get("counters") is not None)]
            if snaps:
                per_run.append(snaps[-1])
        if per_run:
            shard_snaps[proc] = _fold_snapshots(per_run)
    if shard_snaps:
        merged_snap = _metrics.merge_snapshots(shard_snaps)
        with open(os.path.join(out_dir, "metrics.jsonl"), "w",
                  encoding="utf-8") as fh:
            fh.write(json.dumps(merged_snap) + "\n")

    # usage ledgers (obs/usage.py): records are self-contained and
    # rollups are pure sums, so the merge is concatenation — tagged
    # with ``proc`` and time-sorted for readability, exact either way
    usage = []
    for proc in sorted(shards):
        for upath in _rotated_paths(shards_dir,
                                    "usage.%d.jsonl" % proc):
            for rec in _read_events(upath):
                if isinstance(rec, dict):
                    rec["proc"] = proc
                    usage.append(rec)
    if usage:
        usage.sort(key=lambda r: r.get("t", 0.0))
        with open(os.path.join(out_dir, "usage.jsonl"), "w",
                  encoding="utf-8") as fh:
            for rec in usage:
                fh.write(json.dumps(rec) + "\n")

    manifests = {}
    for proc in sorted(shards):
        # fold this proc's manifests oldest-first: rotated copies from
        # earlier chained runs, then the live one.  Counters and walls
        # sum (the runs were sequential), configs/gauges update so the
        # newest run wins, identity fields come from the newest run.
        docs = []
        for mpath in _rotated_paths(shards_dir,
                                    "manifest.%d.json" % proc):
            try:
                with open(mpath, encoding="utf-8") as fh:
                    docs.append(json.load(fh))
            except (OSError, json.JSONDecodeError):
                pass
        if docs:
            manifests[proc] = _fold_manifests(docs)

    counters = {}
    gauges = {}
    config = {}
    wall = 0.0
    compile_total = 0.0
    for proc in sorted(manifests):
        m = manifests[proc]
        for k, v in (m.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        for k, v in (m.get("gauges") or {}).items():
            gauges["p%d/%s" % (proc, k)] = v
        config.update(m.get("config") or {})
        wall = max(wall, float(m.get("wall_s", 0.0) or 0.0))
        compile_total += float(m.get("compile_total_s", 0.0) or 0.0)
    base = manifests.get(min(manifests), {}) if manifests else {}
    out_manifest = {
        "schema": "pptpu-obs-v1",
        "name": str(base.get("name", "merged")) + "-merged",
        "run_id": os.path.basename(os.path.normpath(out_dir)),
        "merged_from": sorted(shards),
        "n_processes": len(shards),
        "platform": base.get("platform"),
        "device_count": base.get("device_count"),
        "torch_version": base.get("torch_version"),
        "cuda_version": base.get("cuda_version"),
        "device_kind": base.get("device_kind"),
        "git_sha": base.get("git_sha"),
        "t_start": min((m.get("t_start", 0.0) for m in
                        manifests.values()), default=0.0),
        "config": config,
        "counters": counters,
        "gauges": gauges,
        "wall_s": wall,
        "compile_total_s": round(compile_total, 6),
        "n_events": len(merged),
    }
    tmp = os.path.join(out_dir, "manifest.json.tmp")
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(out_manifest, fh, indent=1)
        fh.write("\n")
    os.replace(tmp, os.path.join(out_dir, "manifest.json"))
    return out_dir
