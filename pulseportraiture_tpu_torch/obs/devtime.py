"""Device-time attribution: profiler captures -> per-stage device seconds.

The wall-clock spans of :mod:`.core` say "solve took N s" without saying
where the card spent it.  This module closes that gap by parsing the
Chrome trace :mod:`.trace` exports from ``torch.profiler`` under
``$PPTPU_TRACE_DIR/<region>/<session>/*.trace.json.gz``:

* **Device rows** are the events the profiler takes from the card
  through CUPTI: ``cat`` ``kernel`` (the port's hand kernels K1/K2/K3
  and every PyTorch/cuFFT kernel), ``gpu_memcpy`` and ``gpu_memset``.
  Host-side rows (operators, Python frames, CUDA runtime calls) are not
  device time and are skipped.  A CPU-only capture has no device rows:
  its device total is 0.
* **Stage attribution** comes from the ``gpu_user_annotation`` rows:
  the profiler's mirror of each ``torch.profiler.record_function``
  range onto the stream its work ran on, spanning that work.  The
  solver names its stages ``pp_seed`` / ``pp_solve`` / ``pp_polish``
  (fit/portrait.py) and the scattering work ``pp_scatter``
  (fit/portrait.py, ops/scattering.py).  A device row's scope path is
  the ordered list of ``pp_*`` ranges on its own track that contain its
  start, outermost first (a stream runs its work in launch order, so a
  range's mirror holds exactly the rows launched inside it); its
  pipeline *phase* is the :data:`SCOPE_PHASES` entry of the outermost
  scope.  Rows without a ``pp_*`` scope (data transfers, spectra,
  guesses outside the fit) count toward the device total as
  ``unattributed``.

Rows on one (pid, tid) track are reduced to SELF time by interval
nesting before they are summed (:func:`self_times`; device rows of one
stream do not overlap, so this is their duration), so ``scopes`` +
``unattributed_s`` == ``device_total_s``.

**Completeness.**  torch.profiler places the card's rows on the host
clock and drops those it places before the capture's start; in a
process that has run for minutes the conversion has drifted and a
region's first rows are lost (PERF.md section 7).  The capture knows how
often each hand kernel was launched inside it (``_kernels.LAUNCHES``),
so the summary holds each one's rows against its launches
(:func:`kernel_rows`): ``complete`` is False when any differ, and
``device_total_s`` is then an undercount of ``lost_rows`` rows or more.

Not here, unlike the JAX package's module: its xplane protobuf reader
(XLA's format only) and with it the allocator-memory timeline of a
capture — the card's memory is read from the allocator instead
(:mod:`.memory`); and ``pp_coarse``, a stage the port's single-stage
solver does not have.

Everything here is host-side file parsing.
"""

import glob
import gzip
import json
import os
import re

from . import core

__all__ = ["SCOPE_PREFIX", "SCOPE_PHASES", "DEVICE_CATEGORIES",
           "find_capture", "parse_chrome_trace", "self_times",
           "scopes_of", "kernel_rows", "summarize_region",
           "summarize_trace_dir", "record_devtime"]

# record_function convention: any range name starting with this prefix
# is an attribution scope (every other annotation is ignored)
SCOPE_PREFIX = "pp_"

# outermost scope -> pipeline phase (the span names GetTOAs emits), so
# the phase table can carry a device column next to the wall column
SCOPE_PHASES = {
    "pp_seed": "guess",      # in-fit FFTFIT phase seeding (K2)
    "pp_solve": "solve",     # the batched Newton solve (K1 / K3)
    "pp_polish": "polish",   # nu-zero, covariance and scales finish
    "pp_scatter": "solve",   # scattering work reached outside a stage
}

# Chrome-trace categories of the rows the card executed
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_ANNOTATION = "gpu_user_annotation"


# -- capture discovery ----------------------------------------------------

def find_capture(region_dir):
    """Path of the trace of the NEWEST session under ``region_dir``, or
    None.  :mod:`.trace` writes each capture into a fresh timestamped
    session directory; re-capturing a region appends sessions, and the
    newest is the one the enclosing span just timed."""
    paths = glob.glob(os.path.join(region_dir, "**", "*.trace.json.gz"),
                      recursive=True) + \
        glob.glob(os.path.join(region_dir, "**", "*.trace.json"),
                  recursive=True)
    if not paths:
        return None
    # timestamped session dir names sort chronologically
    return max(paths, key=lambda p: (os.path.dirname(p), p))


# -- Chrome-trace side ----------------------------------------------------

def parse_chrome_trace(path):
    """Complete (``ph == "X"``) events of a ``*.trace.json[.gz]``.

    Returns dicts with ``pid``/``tid``/``ts``/``dur`` (microseconds)
    /``name``/``cat``; ``op`` is the row's name when it is a device row
    (:data:`DEVICE_CATEGORIES`), else None.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as fh:
        doc = json.load(fh)
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    out = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        try:
            ts = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        cat = e.get("cat", "")
        name = e.get("name", "")
        out.append({"pid": e.get("pid"), "tid": e.get("tid"),
                    "ts": ts, "dur": dur, "name": name, "cat": cat,
                    "op": name if cat in DEVICE_CATEGORIES else None})
    return out


def self_times(events):
    """Annotate each event with ``self`` = dur minus nested children.

    Rows nest on a (pid, tid) track; summing raw ``dur`` double-counts
    containers, self time partitions each track's busy time exactly.
    Mutates and returns ``events``.
    """
    tracks = {}
    for e in events:
        tracks.setdefault((e["pid"], e["tid"]), []).append(e)
    for track in tracks.values():
        # parents first at equal start times (longer duration first)
        track.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # open events, innermost last
        for e in track:
            e["self"] = e["dur"]
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            if stack:
                stack[-1]["self"] -= e["dur"]
            stack.append(e)
    return events


_SCOPE_RE = re.compile(r"^%s[A-Za-z0-9_]+$" % SCOPE_PREFIX)


def scopes_of(names):
    """The ``pp_*`` scopes among annotation ``names`` (outermost first),
    other names dropped: ['pp_solve', 'x', 'pp_scatter'] ->
    ['pp_solve', 'pp_scatter']."""
    return [n for n in names if n and _SCOPE_RE.match(n)]


def _scope_paths(events, rows):
    """{id(row): [pp_* scope names, outermost first]} for device rows:
    the ``gpu_user_annotation`` ranges on the row's own track that
    contain its start."""
    tracks = {}
    for a in events:
        if a["cat"] == _ANNOTATION:
            tracks.setdefault((a["pid"], a["tid"]), []).append(a)
    for track in tracks.values():
        track.sort(key=lambda a: (a["ts"], -a["dur"]))
    # the profiler rounds ts/dur to 1 ns; a row's start can land that
    # far outside the range mirrored from it
    eps = 1e-3
    return {id(r): scopes_of([
        a["name"] for a in tracks.get((r["pid"], r["tid"]), ())
        if a["ts"] - eps <= r["ts"] <= a["ts"] + a["dur"] + eps])
        for r in rows}


def kernel_rows(rows, functions):
    """{kernel: its device rows} for ``functions`` {kernel: the name of
    its CUDA function}: the rows whose name holds that name."""
    return {name: sum(1 for r in rows if fn in r["op"])
            for name, fn in functions.items()}


# -- aggregation ----------------------------------------------------------

def summarize_region(region_dir, top=10, kernels=None):
    """Aggregate the newest capture under one region directory.

    Returns None when no capture exists, else a JSON-ready dict::

        {"trace": ..., "device_total_s": ..., "unattributed_s": ...,
         "phases": {"solve": ..., "polish": ...},     # device seconds
         "scopes": {"pp_solve": ..., "pp_solve/pp_scatter": ...},
         "top_ops": {kernel name: device seconds}, "n_ops": ...}

    ``phases`` maps the outermost scope through :data:`SCOPE_PHASES`;
    ``scopes`` keeps the full nested scope path; ``top_ops`` the
    ``top`` device rows (kernels by their CUDA function name) that took
    longest, summed by name; ``n_ops`` counts device rows.  All values
    are self-time sums, so ``scopes`` + ``unattributed_s`` ==
    ``device_total_s`` (up to rounding).

    With ``kernels`` ({kernel: (CUDA function name, launches over the
    region)}) the summary also holds ``kernel_rows`` and
    ``kernel_launches`` by kernel, ``complete`` (every kernel's rows equal
    its launches) and ``lost_rows`` (the launches beyond their rows).
    """
    trace_path = find_capture(region_dir)
    if trace_path is None:
        return None
    events = parse_chrome_trace(trace_path)
    rows = self_times([e for e in events if e["op"]])
    paths = _scope_paths(events, rows)

    total_us = 0.0
    unattr_us = 0.0
    scopes = {}
    phases = {}
    top_ops = {}
    for e in rows:
        dt = e["self"]
        total_us += dt
        path = paths.get(id(e)) or []
        if path:
            key = "/".join(path)
            scopes[key] = scopes.get(key, 0.0) + dt
            phase = SCOPE_PHASES.get(path[0])
            if phase:
                phases[phase] = phases.get(phase, 0.0) + dt
        else:
            unattr_us += dt
        top_ops[e["op"]] = top_ops.get(e["op"], 0.0) + dt

    def s(us):
        return round(us / 1e6, 6)

    top = dict(sorted(top_ops.items(), key=lambda kv: -kv[1])[:top])
    out = {
        "trace": trace_path,
        "device_total_s": s(total_us),
        "unattributed_s": s(unattr_us),
        "phases": {k: s(v) for k, v in sorted(phases.items())},
        "scopes": {k: s(v) for k, v in sorted(scopes.items())},
        "top_ops": {k: s(v) for k, v in top.items()},
        "n_ops": len(rows),
    }
    if kernels is not None:
        counts = kernel_rows(rows, {k: fn for k, (fn, _) in kernels.items()})
        launched = {k: int(n) for k, (_, n) in kernels.items()}
        out.update(kernel_rows=counts, kernel_launches=launched,
                   complete=counts == launched,
                   lost_rows=sum(max(0, n - counts[k])
                                 for k, n in launched.items()))
    return out


def summarize_trace_dir(trace_root, top=10):
    """{region: summary} for every region directory under a
    ``PPTPU_TRACE_DIR`` root (regions with no capture are skipped)."""
    out = {}
    try:
        names = sorted(os.listdir(trace_root))
    except OSError:
        return out
    for name in names:
        region_dir = os.path.join(trace_root, name)
        if not os.path.isdir(region_dir):
            continue
        summary = summarize_region(region_dir, top=top)
        if summary is not None:
            out[name] = summary
    return out


def record_devtime(region, region_dir, kernels=None):
    """Ingest a just-closed capture and emit one ``devtime`` event into
    the active obs run (:mod:`.trace` calls this after the profiler
    stops, with ``kernels`` as :func:`summarize_region` takes it).

    Never raises and never emits when no run is active or the capture
    is unreadable — telemetry must not kill the run it observes.  The
    per-run ``device_seconds_total`` counter sums ``device_total_s``
    across regions, and ``devtime_incomplete`` counts the regions whose
    capture lost rows (``complete`` False): the sum undercounts then.
    """
    rec = core.current()
    if rec is None:
        return None
    try:
        summary = summarize_region(region_dir, kernels=kernels)
    except Exception as e:  # parsing must never be fatal
        rec.emit("event", name="devtime_error", region=region,
                 error=str(e)[:500])
        return None
    if summary is None:
        return None
    rec.emit("devtime", region=region, **summary)
    rec.bump("devtime_regions")
    rec.bump("device_seconds_total", summary["device_total_s"])
    if summary.get("complete") is False:
        rec.bump("devtime_incomplete")
    return summary
