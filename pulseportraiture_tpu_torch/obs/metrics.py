"""Streaming metrics: counters, gauges, log-bucketed latency histograms.

The event stream (:mod:`.core`) answers "what happened"; this module
answers "how is it doing *right now*" — the live telemetry plane a
long run is operated and SLO-gated on (a copy of the JAX package's
module; its TOA service and survey runner are its main users there):

* **Counters / gauges with labels** — monotonically increasing totals
  (``pps_requests_total{outcome="done",tenant="alice"}``) and
  last-value-wins gauges (``pps_queue_depth{tenant="alice"}``), keyed
  by a Prometheus-style series string so snapshots render to both JSON
  and the Prometheus text exposition format without a schema change.
* **Log-bucketed latency histograms** (HDR-style) — bucket ``i``
  covers ``[lo·2^(i/per_octave), lo·2^((i+1)/per_octave))``; the
  boundaries are *fixed by construction* from ``(lo, hi,
  per_octave)``, so any two histograms of one series merge **exactly**
  by summing sparse bucket counts — across threads, snapshots, shards
  and processes, in any order, with the same result
  (:func:`merge_snapshots`, used by ``obs/merge.py``).  Quantiles are
  read from the bucket upper edge clamped to the exactly-tracked
  min/max, so ``quantile(h, q)`` is within one bucket's relative
  resolution (``2^(1/per_octave) - 1``) of the true percentile.
* **Periodic snapshot exporter** — a daemon thread appends the full
  registry snapshot to ``<run-dir>/metrics.jsonl`` every
  ``PPTPU_METRICS_INTERVAL`` seconds (default 2.0; 0 disables the
  thread), plus one final snapshot at recorder close.  Each line is a
  complete cumulative snapshot, so readers (``tools/obs_report.py``,
  the ``--watch`` views, an SLO gate) take the **last
  parseable line** — a crash mid-append leaves a torn tail that is
  simply skipped, never a corrupted series.

Activation follows the obs run lifecycle: the module-level helpers
(:func:`inc`, :func:`set_gauge`, :func:`observe`, :func:`timed`)
no-op at one attribute read + ``None`` check when no run is active —
the same "disabled = free" contract as ``obs.span``.  With a run active
they record into the run's lazily-created :class:`MetricsRegistry`
(one per :class:`~.core.Recorder`).

Host-side only, like everything in ``obs``: never call it inside a
CUDA graph capture, where an ``observe`` would record the capture-time
value once and never again.
"""

import bisect
import contextlib
import json
import math
import os
import re
import threading
import time

from . import core as _core

__all__ = ["Histogram", "MetricsRegistry", "MetricsExporter",
           "series_key", "parse_series", "quantile", "percentiles",
           "exemplar_for_quantile", "inc", "set_gauge", "observe",
           "timed", "snapshot", "metrics_interval",
           "render_prometheus", "merge_snapshots", "load_snapshots",
           "last_snapshot", "latest_run_dir", "evaluate_slo",
           "render_watch", "PHASE_HISTOGRAM", "SNAPSHOT_SCHEMA",
           "EXEMPLARS_PER_BUCKET"]

SNAPSHOT_SCHEMA = "pptpu-metrics-v1"

# the one histogram family the request/survey lifecycles share; phases
# are distinguished by the ``phase`` label (docs/OBSERVABILITY.md):
# service requests: queue_wait / checkout / park / dispatch / fit /
# checkpoint / total; survey archives: claim / fit / checkpoint /
# archive
PHASE_HISTOGRAM = "pps_phase_seconds"

# default bucket geometry: 1 us .. ~4096 s at 8 buckets per octave
# (~9% relative resolution, 256 buckets); chosen so a socket RTT and a
# cold multi-minute compile land in the same instrument
DEFAULT_LO = 1e-6
DEFAULT_HI = 4096.0
DEFAULT_PER_OCTAVE = 8

# per-bucket exemplar retention (last-K trace ids per bucket): enough
# to resolve "who was in this p99 bucket" without the snapshot growing
# with traffic (OpenMetrics exemplars carry one per rendered bucket)
EXEMPLARS_PER_BUCKET = 4


def metrics_interval():
    """$PPTPU_METRICS_INTERVAL: snapshot cadence in seconds (default
    2.0; 0 / unparsable-as-positive disables the periodic thread — the
    close-time final snapshot is always written)."""
    v = os.environ.get("PPTPU_METRICS_INTERVAL", "").strip()
    try:
        return max(0.0, float(v)) if v else 2.0
    except ValueError:
        return 2.0


def series_key(name, labels=None):
    """Prometheus-style series key: ``name{k="v",...}`` with labels
    sorted (deterministic across processes), or bare ``name``."""
    if not labels:
        return name
    inner = ",".join('%s="%s"' % (k, labels[k]) for k in sorted(labels))
    return "%s{%s}" % (name, inner)


_SERIES_RE = re.compile(r'^([^{]+)(?:\{(.*)\})?$')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def parse_series(key):
    """Inverse of :func:`series_key`: ``(name, {label: value})``."""
    m = _SERIES_RE.match(key)
    if not m:
        return key, {}
    name, inner = m.group(1), m.group(2)
    if not inner:
        return name, {}
    return name, dict(_LABEL_RE.findall(inner))


class Histogram:
    """Log-bucketed latency histogram with exact deterministic merge.

    Bucket boundaries are a pure function of ``(lo, hi, per_octave)``
    — precomputed edges, indexed by bisection (no per-observation
    ``log`` call, no float-rounding ambiguity at the boundaries):
    ``edges[i] = lo * 2**(i / per_octave)``.  Values below ``lo`` land
    in ``under``, at/above ``hi`` in ``over``; exact ``count``,
    ``sum``, ``min`` and ``max`` ride along.
    """

    __slots__ = ("lo", "hi", "per_octave", "n_buckets", "edges",
                 "counts", "under", "over", "count", "sum", "min",
                 "max", "exemplars", "_lock")

    def __init__(self, lo=DEFAULT_LO, hi=DEFAULT_HI,
                 per_octave=DEFAULT_PER_OCTAVE):
        if not (lo > 0 and hi > lo and per_octave >= 1):
            raise ValueError("need 0 < lo < hi and per_octave >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.per_octave = int(per_octave)
        self.n_buckets = int(math.ceil(
            math.log(self.hi / self.lo, 2.0) * self.per_octave))
        self.edges = [self.lo * 2.0 ** (i / self.per_octave)
                      for i in range(self.n_buckets + 1)]
        self.counts = {}          # sparse: bucket index -> count
        self.under = 0
        self.over = 0
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        # sparse: bucket index -> last-K [{"trace_id", "value"}, ...]
        # (index n_buckets = the overflow bucket); the distributed-
        # tracing hook: a quantile's bucket resolves to concrete trace
        # ids (obs/tracing.py, tools/obs_trace.py)
        self.exemplars = {}
        self._lock = threading.Lock()

    def bucket_index(self, value):
        """Bucket index for ``value`` (-1 = under, n_buckets = over)."""
        v = float(value)
        if v < self.lo:
            return -1
        if v >= self.edges[-1]:
            return self.n_buckets
        return bisect.bisect_right(self.edges, v) - 1

    def observe(self, value, exemplar=None):
        """Record one observation; ``exemplar`` (a trace id string)
        attaches the observation's trace to its bucket, keeping the
        last ``EXEMPLARS_PER_BUCKET`` per bucket."""
        v = float(value)
        if v != v:          # NaN: drop rather than poison the stats
            return
        i = self.bucket_index(v)
        with self._lock:
            if i < 0:
                self.under += 1
            elif i >= self.n_buckets:
                self.over += 1
            else:
                self.counts[i] = self.counts.get(i, 0) + 1
            if exemplar:
                # clamp to [0, n_buckets]: an under-range value keeps
                # its exemplar on the first bucket (the rendered
                # cumulative bucket 0 already counts ``under``), the
                # symmetric move to the over bucket above — a traced
                # sub-resolution observation must stay traceable
                ex = self.exemplars.setdefault(
                    max(0, min(i, self.n_buckets)), [])
                ex.append({"trace_id": str(exemplar), "value": v})
                del ex[:-EXEMPLARS_PER_BUCKET]
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def merge(self, other):
        """Fold ``other`` in; exact (integer bucket sums) and
        commutative, provided the geometries match."""
        if (self.lo, self.hi, self.per_octave) != \
                (other.lo, other.hi, other.per_octave):
            raise ValueError(
                "histogram geometry mismatch: (%g,%g,%d) vs (%g,%g,%d)"
                % (self.lo, self.hi, self.per_octave,
                   other.lo, other.hi, other.per_octave))
        with self._lock:
            for i, c in other.counts.items():
                i = int(i)
                self.counts[i] = self.counts.get(i, 0) + int(c)
            # exemplars survive the merge (the bucket-count merge stays
            # exact regardless): concatenate per bucket, dedupe by
            # trace id preserving order, keep the last K — shard order
            # is fixed by the callers (sorted proc), so the merged
            # exemplar set is deterministic
            for i, ex in other.exemplars.items():
                i = int(i)
                seen = {}
                for item in self.exemplars.get(i, []) + list(ex):
                    tid = item.get("trace_id")
                    if tid:
                        seen[tid] = item
                self.exemplars[i] = \
                    list(seen.values())[-EXEMPLARS_PER_BUCKET:]
            self.under += other.under
            self.over += other.over
            self.count += other.count
            self.sum += other.sum
            for attr, pick in (("min", min), ("max", max)):
                ov = getattr(other, attr)
                if ov is not None:
                    sv = getattr(self, attr)
                    setattr(self, attr,
                            ov if sv is None else pick(sv, ov))
        return self

    def to_snapshot(self):
        with self._lock:
            snap = {"lo": self.lo, "hi": self.hi,
                    "per_octave": self.per_octave,
                    "count": self.count,
                    "sum": round(self.sum, 9),
                    "min": self.min, "max": self.max,
                    "under": self.under, "over": self.over,
                    "counts": {str(i): c
                               for i, c in sorted(self.counts.items())}}
            if self.exemplars:
                snap["exemplars"] = {
                    str(i): [dict(x) for x in ex]
                    for i, ex in sorted(self.exemplars.items()) if ex}
            return snap

    @classmethod
    def from_snapshot(cls, snap):
        h = cls(lo=snap.get("lo", DEFAULT_LO),
                hi=snap.get("hi", DEFAULT_HI),
                per_octave=snap.get("per_octave", DEFAULT_PER_OCTAVE))
        h.counts = {int(i): int(c)
                    for i, c in (snap.get("counts") or {}).items()}
        h.under = int(snap.get("under", 0))
        h.over = int(snap.get("over", 0))
        h.count = int(snap.get("count", 0))
        h.sum = float(snap.get("sum", 0.0))
        h.min = snap.get("min")
        h.max = snap.get("max")
        h.exemplars = {int(i): [dict(x) for x in ex
                                if isinstance(x, dict)]
                       for i, ex in (snap.get("exemplars")
                                     or {}).items()}
        return h

    def quantile(self, q):
        """Value at quantile ``q`` in [0, 1], within one bucket's
        relative resolution; None on an empty histogram.

        Walks the cumulative counts to the covering bucket and returns
        its upper edge clamped into the exactly-tracked [min, max], so
        q=0 is the true min and q=1 the true max.
        """
        with self._lock:
            total = self.count
            if not total:
                return None
            if q <= 0.0:
                return self.min
            if q >= 1.0:
                return self.max
            rank = q * total
            cum = self.under
            if cum >= rank and cum:
                return self.min if self.min is not None else self.lo
            val = None
            for i in sorted(self.counts):
                cum += self.counts[i]
                if cum >= rank:
                    val = self.edges[i + 1]
                    break
            if val is None:      # rank beyond all buckets: overflow
                val = self.max if self.max is not None else self.hi
            if self.min is not None:
                val = max(val, self.min)
            if self.max is not None:
                val = min(val, self.max)
            return val


def quantile(hist_snapshot, q):
    """Quantile from a histogram *snapshot dict* (see
    :meth:`Histogram.to_snapshot`); None when empty/absent."""
    if not hist_snapshot:
        return None
    return Histogram.from_snapshot(hist_snapshot).quantile(q)


def percentiles(hist_snapshot, qs=(0.5, 0.9, 0.99)):
    """{q: value} for a snapshot dict (empty dict when no samples)."""
    if not hist_snapshot or not hist_snapshot.get("count"):
        return {}
    h = Histogram.from_snapshot(hist_snapshot)
    return {q: h.quantile(q) for q in qs}


def exemplar_for_quantile(hist_snapshot, q):
    """The exemplar whose bucket covers quantile ``q`` of a snapshot —
    the "resolve this p99 to a trace" hook (docs/OBSERVABILITY.md).

    Walks the cumulative counts to q's covering bucket and returns its
    newest exemplar as ``{"trace_id", "value", "bucket"}``; when that
    bucket recorded none (exemplars are sampled, counts are exact) the
    nearest exemplar-carrying bucket wins, preferring slower buckets —
    for a tail quantile the slower neighbor is the honest stand-in.
    None when the snapshot carries no exemplars at all.
    """
    if not hist_snapshot:
        return None
    h = Histogram.from_snapshot(hist_snapshot)
    if not h.exemplars or not h.count:
        return None
    rank = max(0.0, min(1.0, float(q))) * h.count
    cum = h.under
    covering = None
    for i in sorted(h.counts):
        cum += h.counts[i]
        if cum >= rank:
            covering = i
            break
    if covering is None:
        covering = h.n_buckets  # rank beyond all buckets: overflow
    have = sorted(h.exemplars)
    best = min(have, key=lambda i: (abs(i - covering), covering - i))
    ex = dict(h.exemplars[best][-1])
    ex["bucket"] = best
    return ex


class MetricsRegistry:
    """Label-keyed counters, gauges and histograms for one run.

    Series creation takes the registry lock once; increments take only
    the per-histogram lock (counters/gauges update under the registry
    lock — they are single dict stores, far from any hot path's
    budget).  ``snapshot()`` is safe against concurrent writers and
    returns plain JSON-ready dicts.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters = {}
        self._gauges = {}
        self._hists = {}
        self._t0 = time.time()
        self._seq = 0

    # -- write side -----------------------------------------------------

    def inc(self, name, value=1, **labels):
        key = series_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + value

    def set_gauge(self, name, value, **labels):
        key = series_key(name, labels)
        with self._lock:
            self._gauges[key] = value

    def histogram(self, name, lo=DEFAULT_LO, hi=DEFAULT_HI,
                  per_octave=DEFAULT_PER_OCTAVE, **labels):
        key = series_key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(
                    lo=lo, hi=hi, per_octave=per_octave)
            return h

    def observe(self, name, value, exemplar=None, **labels):
        self.histogram(name, **labels).observe(value,
                                               exemplar=exemplar)

    # -- read side ------------------------------------------------------

    def snapshot(self):
        """One cumulative snapshot dict (a ``metrics.jsonl`` line)."""
        with self._lock:
            self._seq += 1
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
            seq = self._seq
        return {"schema": SNAPSHOT_SCHEMA,
                "t": round(time.time(), 6),
                "uptime_s": round(time.time() - self._t0, 6),
                "seq": seq,
                "counters": counters,
                "gauges": gauges,
                "histograms": {k: h.to_snapshot()
                               for k, h in sorted(hists.items())}}


class MetricsExporter:
    """Periodic + final snapshot writer for one registry.

    Appends one snapshot line to ``<run_dir>/metrics.jsonl`` every
    ``interval_s`` (daemon thread; 0 disables it) and once at
    :meth:`stop`.  Write failures are dropped, never fatal — the
    ``obs`` "never fatal" contract.
    """

    def __init__(self, registry, run_dir, interval_s=None):
        self.registry = registry
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self.interval_s = metrics_interval() if interval_s is None \
            else float(interval_s)
        self.dropped = 0
        # health-plane hook (obs/health.py): called before each
        # periodic snapshot so that tick's alert gauges land in the
        # metrics.jsonl line it writes; failures never kill the loop
        self.on_tick = None
        self._stop = threading.Event()
        self._thread = None
        if self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, name="pptpu-metrics-exporter",
                daemon=True)
            self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            cb = self.on_tick
            if cb is not None:
                try:
                    cb()
                except Exception:
                    pass
            self.write_snapshot()

    def write_snapshot(self):
        try:
            line = json.dumps(self.registry.snapshot(),
                              default=_core._json_default)
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
                fh.flush()
        except (OSError, TypeError, ValueError):
            self.dropped += 1

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None
        self.write_snapshot()


# -- module-level helpers (the instrumented-code API) -------------------


def _registry():
    rec = _core._active
    if rec is None:
        return None
    return rec.metrics_registry()


def inc(name, value=1, **labels):
    """Bump a counter series; no-op when no obs run is active."""
    reg = _registry()
    if reg is not None:
        reg.inc(name, value, **labels)


def set_gauge(name, value, **labels):
    """Set a gauge series (last value wins); no-op when inactive."""
    reg = _registry()
    if reg is not None:
        reg.set_gauge(name, value, **labels)


def _ambient_exemplar():
    """Ambient trace id (obs/tracing.py) as the default exemplar: one
    thread-local read, so every observe made while serving a traced
    request links its bucket to that trace with zero caller churn."""
    ctx = getattr(_core._tls, "trace", None)
    return ctx[0] if ctx is not None else None


def observe(name, seconds, exemplar=None, **labels):
    """Record one latency observation; no-op when inactive.  The
    ambient trace context (if any) rides along as the bucket's
    exemplar unless the caller passes its own."""
    reg = _registry()
    if reg is not None:
        reg.observe(name, seconds,
                    exemplar=exemplar or _ambient_exemplar(), **labels)


@contextlib.contextmanager
def timed(name, **labels):
    """Time a with-block into a histogram series; no-op when
    inactive.  Records on every exit path (including raises) — a
    failed dispatch's latency is exactly the one an SLO cares about."""
    reg = _registry()
    if reg is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        reg.observe(name, time.perf_counter() - t0,
                    exemplar=_ambient_exemplar(), **labels)


def snapshot():
    """The active run's current snapshot, or None when inactive."""
    reg = _registry()
    return None if reg is None else reg.snapshot()


# -- rendering ----------------------------------------------------------


def _prom_name(key):
    name, labels = parse_series(key)
    return name, labels


def render_prometheus(snap):
    """Prometheus text exposition of one snapshot dict.

    Counters/gauges render directly; histograms render as cumulative
    ``_bucket{le=...}`` series (per-octave edges), ``_sum`` and
    ``_count`` — scrape-compatible with any Prometheus-style
    collector without this repo growing a dependency.
    """
    if not snap:
        return ""
    out = []
    typed = set()

    def type_line(name, kind):
        if name not in typed:
            typed.add(name)
            out.append("# TYPE %s %s" % (name, kind))

    for key in sorted(snap.get("counters") or {}):
        name, _ = _prom_name(key)
        type_line(name, "counter")
        out.append("%s %s" % (key, (snap["counters"][key])))
    for key in sorted(snap.get("gauges") or {}):
        name, _ = _prom_name(key)
        type_line(name, "gauge")
        out.append("%s %s" % (key, snap["gauges"][key]))
    for key in sorted(snap.get("histograms") or {}):
        h = snap["histograms"][key]
        name, labels = _prom_name(key)
        type_line(name, "histogram")
        edges = Histogram(lo=h.get("lo", DEFAULT_LO),
                          hi=h.get("hi", DEFAULT_HI),
                          per_octave=h.get("per_octave",
                                           DEFAULT_PER_OCTAVE)).edges
        cum = int(h.get("under", 0))
        counts = {int(i): int(c)
                  for i, c in (h.get("counts") or {}).items()}
        exemplars = {int(i): ex
                     for i, ex in (h.get("exemplars") or {}).items()
                     if ex}

        def exemplar_suffix(i):
            # OpenMetrics exemplar syntax on the bucket that recorded
            # it: `# {trace_id="..."} <observed value>` — a scraper
            # (or a human) jumps from the p99 bucket straight to the
            # trace (tools/obs_trace.py)
            ex = exemplars.get(i)
            if not ex:
                return ""
            last = ex[-1]
            return ' # {trace_id="%s"} %.9g' % (
                last.get("trace_id", ""), float(last.get("value", 0.0)))

        # only edges that close a non-empty bucket, to keep the
        # exposition proportional to the data, plus +Inf
        n_buckets = len(edges) - 1
        for i in sorted(counts):
            cum += counts[i]
            lab = dict(labels)
            lab["le"] = "%.9g" % edges[i + 1]
            out.append("%s %d%s" % (series_key(name + "_bucket", lab),
                                    cum, exemplar_suffix(i)))
        lab = dict(labels)
        lab["le"] = "+Inf"
        out.append("%s %d%s" % (series_key(name + "_bucket", lab),
                                int(h.get("count", 0)),
                                exemplar_suffix(n_buckets)))
        out.append("%s %s" % (series_key(name + "_sum", labels),
                              h.get("sum", 0.0)))
        out.append("%s %d" % (series_key(name + "_count", labels),
                              int(h.get("count", 0))))
    return "\n".join(out) + ("\n" if out else "")


# -- snapshot files -----------------------------------------------------


def load_snapshots(run_dir):
    """Every parseable snapshot of a run's ``metrics.jsonl``, oldest
    first.  Torn tail lines (crash mid-append) are skipped."""
    path = os.path.join(run_dir, "metrics.jsonl")
    out = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    snap = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(snap, dict):
                    out.append(snap)
    except OSError:
        pass
    return out


def last_snapshot(run_dir):
    """The newest parseable snapshot of a run, or None."""
    snaps = load_snapshots(run_dir)
    return snaps[-1] if snaps else None


def _run_dirs(base):
    """Every run directory under an obs base dir (or ``base`` itself
    when it already is one); [] when nothing qualifies."""
    if not base:
        return []
    for probe in ("metrics.jsonl", "events.jsonl", "manifest.json"):
        if os.path.isfile(os.path.join(base, probe)):
            return [base]
    try:
        names = os.listdir(base)
    except OSError:
        return []
    runs = []
    for name in names:
        d = os.path.join(base, name)
        if any(os.path.isfile(os.path.join(d, p))
               for p in ("metrics.jsonl", "events.jsonl",
                         "manifest.json")):
            runs.append(d)
    return runs


def latest_run_dir(base):
    """Newest run directory under an obs base dir (mtime order), or
    ``base`` itself when it already is a run dir; None when nothing
    qualifies.  The ``--watch`` views poll this instead of replaying
    ledgers."""
    runs = _run_dirs(base)
    return max(runs, key=os.path.getmtime) if runs else None


def overlay_supervisor(snap, base):
    """Fold the supervisor's ``pps_supervisor_*`` series into a watch
    snapshot.

    ``ppsurvey status --watch`` tails the *newest* run dir under the
    workdir's obs base — on a supervised survey that is almost always
    a worker's run (workers start after the supervisor, so their dirs
    are newer), which would make the supervisor's gauges invisible
    exactly when they matter.  This scans the run dirs newest-first
    for the supervisor's own series and copies them in.  Absent, not
    broken: an unsupervised run has no such series anywhere, and the
    snapshot is returned untouched (bit-identical frame)."""
    def _sup_series(s):
        out = {}
        for kind in ("gauges", "counters"):
            for key, v in (s.get(kind) or {}).items():
                if key.rsplit("/", 1)[-1].startswith(
                        "pps_supervisor_"):
                    out.setdefault(kind, {})[key] = v
        return out

    if snap and _sup_series(snap):
        return snap
    try:
        runs = sorted(_run_dirs(base), key=os.path.getmtime,
                      reverse=True)
    except OSError:
        runs = []
    for run_dir in runs:
        other = last_snapshot(run_dir)
        if not other:
            continue
        sup = _sup_series(other)
        if not sup:
            continue
        if snap is None:
            return other
        snap = dict(snap)
        for kind, series in sup.items():
            merged = dict(snap.get(kind) or {})
            merged.update(series)
            snap[kind] = merged
        return snap
    return snap


def merge_snapshots(snaps):
    """Merge per-process snapshots into one (``obs/merge.py`` path).

    ``snaps`` is ``{proc: snapshot}``.  Counters and histograms sum
    across shards **by identical series key** — histogram merges are
    integer bucket sums over identical edges, so the result is exact
    and independent of shard order; gauges keep a ``p<proc>/`` prefix
    (a queue depth summed across hosts would be a lie).
    """
    counters = {}
    gauges = {}
    hists = {}
    t = 0.0
    for proc in sorted(snaps):
        s = snaps[proc] or {}
        t = max(t, float(s.get("t", 0.0) or 0.0))
        for k, v in (s.get("counters") or {}).items():
            if isinstance(v, (int, float)):
                counters[k] = counters.get(k, 0) + v
        for k, v in (s.get("gauges") or {}).items():
            gauges["p%s/%s" % (proc, k)] = v
        for k, h in (s.get("histograms") or {}).items():
            cur = hists.get(k)
            if cur is None:
                hists[k] = Histogram.from_snapshot(h)
            else:
                cur.merge(Histogram.from_snapshot(h))
    return {"schema": SNAPSHOT_SCHEMA,
            "t": t,
            "seq": 1,
            "merged_from": sorted(snaps),
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.to_snapshot()
                           for k, h in sorted(hists.items())}}


# -- SLO evaluation (pploadgen gate) ------------------------------------


def evaluate_slo(spec, hist_snapshot, n_ok, n_err, wall_s):
    """Evaluate an SLO spec against a latency-histogram snapshot plus
    outcome counts; returns ``{"ok", "breaches", "measured"}``.

    Spec fields (all optional — absent means not gated):

    * ``p50_s`` / ``p90_s`` / ``p99_s`` — latency ceilings [s]
    * ``max_error_rate``      — errors / (ok + errors) ceiling
    * ``min_throughput_rps``  — ok / wall floor [requests/s]
    * ``min_requests``        — sample-size floor (guards the gate
      against vacuously passing on an empty run)
    """
    n_ok = int(n_ok)
    n_err = int(n_err)
    total = n_ok + n_err
    wall_s = float(wall_s)
    measured = {
        "n_ok": n_ok, "n_err": n_err,
        "error_rate": round(n_err / total, 6) if total else None,
        "throughput_rps": round(n_ok / wall_s, 6)
        if wall_s > 0 else None,
        "wall_s": round(wall_s, 6),
    }
    for q in (0.5, 0.9, 0.99):
        v = quantile(hist_snapshot, q)
        measured["p%g_s" % (100 * q)] = None if v is None \
            else round(v, 6)
    if hist_snapshot:
        measured["max_s"] = hist_snapshot.get("max")
    breaches = []

    def breach(field, got, limit, cmp):
        breaches.append({"slo": field, "measured": got, "limit": limit,
                         "detail": "%s %s (limit %s)" % (field, got,
                                                         cmp + str(
                                                             limit))})

    for field, mkey in (("p50_s", "p50_s"), ("p90_s", "p90_s"),
                        ("p99_s", "p99_s")):
        limit = spec.get(field)
        if limit is None:
            continue
        got = measured.get(mkey)
        if got is None or got > float(limit):
            breach(field, got, limit, "<=")
    if spec.get("max_error_rate") is not None:
        got = measured["error_rate"]
        if got is None or got > float(spec["max_error_rate"]):
            breach("max_error_rate", got, spec["max_error_rate"], "<=")
    if spec.get("min_throughput_rps") is not None:
        got = measured["throughput_rps"]
        if got is None or got < float(spec["min_throughput_rps"]):
            breach("min_throughput_rps", got,
                   spec["min_throughput_rps"], ">=")
    if spec.get("min_requests") is not None \
            and total < int(spec["min_requests"]):
        breach("min_requests", total, spec["min_requests"], ">=")
    return {"ok": not breaches, "breaches": breaches,
            "measured": measured}


# -- watch rendering (pptop-style) --------------------------------------


def _fmt_lat(v):
    if v is None:
        return "-"
    if v < 1e-3:
        return "%.0fus" % (v * 1e6)
    if v < 1.0:
        return "%.1fms" % (v * 1e3)
    return "%.2fs" % v


def _fmt_bytes(n):
    try:
        n = float(n)
    except (TypeError, ValueError):
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return ("%d%s" % (n, unit)) if unit == "B" \
                else "%.1f%s" % (n, unit)
        n /= 1024.0


def _memory_row(gauges):
    """The ``--watch`` memory line from the sampler's gauges
    (obs/memory.py), summed over any ``p<proc>/`` merge prefixes;
    None when the snapshot carries no memory gauges (pre-memory runs
    must keep their original frame)."""
    sums = {}
    for key, v in gauges.items():
        base = key.rsplit("/", 1)[-1]
        if base in ("pps_device_bytes_in_use", "pps_device_peak_bytes",
                    "pps_host_rss_bytes"):
            try:
                sums[base] = sums.get(base, 0.0) + float(v)
            except (TypeError, ValueError):
                continue
    if not sums:
        return None
    return "memory: device in-use %s  peak %s  host RSS %s" % (
        _fmt_bytes(sums.get("pps_device_bytes_in_use")),
        _fmt_bytes(sums.get("pps_device_peak_bytes")),
        _fmt_bytes(sums.get("pps_host_rss_bytes")))


def _quality_row(snap):
    """The ``--watch`` quality line (obs/quality.py): bad-fit rate
    from the exact ``pps_quality_*_total`` counters (summed across any
    ``p<proc>/`` merge prefixes — counters, never gauges: gauge merges
    keep per-process values, which cannot be combined into a rate) and
    the median reduced chi^2 from the merged fixed-geometry
    distribution series; None when the snapshot carries no quality
    series (pre-quality runs keep their original frame)."""
    from . import quality as _q     # lazy: quality imports metrics

    n = bad = 0
    for key, v in (snap.get("counters") or {}).items():
        base = key.rsplit("/", 1)[-1]
        try:
            if base == _q.CTR_SUBINTS:
                n += int(v)
            elif base == _q.CTR_BAD_SUBINTS:
                bad += int(v)
        except (TypeError, ValueError):
            continue
    if not n:
        return None
    chi2 = None
    for key, h in (snap.get("histograms") or {}).items():
        name, _labels = parse_series(key.rsplit("/", 1)[-1])
        if name != _q.HIST_RED_CHI2:
            continue
        hh = Histogram.from_snapshot(h)
        if chi2 is None:
            chi2 = hh
        else:
            chi2.merge(hh)
    med = chi2.quantile(0.5) if chi2 is not None else None
    return "quality: bad-fit %.2f%% (%d/%d)  med chi2=%s" % (
        100.0 * bad / n, bad, n,
        "%.3g" % med if med is not None else "-")


def _compile_cache_row(snap):
    """The ``--watch`` persistent-compile-cache line from the exact
    ``pps_compile_cache_*_total`` counters (summed across any
    ``p<proc>/`` merge prefixes); None when the snapshot carries no
    cache series (pre-warm runs keep their original frame)."""
    hits = misses = 0
    seen = False
    for key, v in (snap.get("counters") or {}).items():
        base = key.rsplit("/", 1)[-1]
        try:
            if base == "pps_compile_cache_hits_total":
                hits += int(v)
                seen = True
            elif base == "pps_compile_cache_misses_total":
                misses += int(v)
                seen = True
        except (TypeError, ValueError):
            continue
    if not seen:
        return None
    total = hits + misses
    rate = " (%.0f%% hit)" % (100.0 * hits / total) if total else ""
    return "compile-cache: %d hit(s) / %d miss(es)%s" % (hits, misses,
                                                         rate)


def _alerts_row(snap):
    """The ``--watch`` alerts line (obs/health.py): firing rules from
    the rule-labeled ``pps_alerts_firing`` gauges (a rule counts as
    firing when its flag is truthy on ANY ``p<proc>/`` merge prefix —
    gauges are never summed into rates) plus the fired total from the
    ``pps_alerts_total`` counters (summed across prefixes); None when
    the snapshot carries no alert series (pre-health runs keep their
    original frame)."""
    firing = set()
    seen = False
    for key, v in (snap.get("gauges") or {}).items():
        name, labels = parse_series(key.rsplit("/", 1)[-1])
        if name != "pps_alerts_firing":
            continue
        seen = True
        rule = labels.get("rule")
        try:
            if rule and float(v):
                firing.add(rule)
        except (TypeError, ValueError):
            continue
    fired = 0
    for key, v in (snap.get("counters") or {}).items():
        name, _labels = parse_series(key.rsplit("/", 1)[-1])
        if name != "pps_alerts_total":
            continue
        seen = True
        try:
            fired += int(v)
        except (TypeError, ValueError):
            continue
    if not seen:
        return None
    if firing:
        return "alerts: %d firing (%s)  %d fired total" % (
            len(firing), ", ".join(sorted(firing)), fired)
    return "alerts: none firing  %d fired total" % fired


def _usage_row(snap, prev=None, dt=None):
    """The ``--watch`` per-tenant usage line (obs/usage.py): metered
    device-seconds and request counts from the exact, tenant-labeled
    ``pps_usage_*_total`` counters (summed across any ``p<proc>/``
    merge prefixes — counters, never gauges), with a per-second
    request rate when ``prev``/``dt`` are available; None when the
    snapshot carries no usage series (pre-usage runs keep their
    original frame)."""
    def _fold(s):
        by_tenant = {}
        for key, v in (s.get("counters") or {}).items():
            name, labels = parse_series(key.rsplit("/", 1)[-1])
            if name not in ("pps_usage_records_total",
                            "pps_usage_device_seconds_total"):
                continue
            tenant = labels.get("tenant", "-")
            cur = by_tenant.setdefault(tenant, [0, 0.0])
            try:
                if name == "pps_usage_records_total":
                    cur[0] += int(v)
                else:
                    cur[1] += float(v)
            except (TypeError, ValueError):
                continue
        return by_tenant

    by_tenant = _fold(snap)
    if not by_tenant:
        return None
    prev_t = _fold(prev) if prev else {}
    parts = []
    for tenant in sorted(by_tenant):
        recs, dev = by_tenant[tenant]
        rate = ""
        if dt:
            rate = " (+%.2f/s)" % ((recs - prev_t.get(tenant,
                                                      [0, 0.0])[0]) / dt)
        parts.append("%s=%d rec%s %.2f dev-s" % (tenant, recs, rate,
                                                 dev))
    return "usage: " + "  ".join(parts)


def _supervisor_row(snap):
    """The ``--watch`` autoscaling-supervisor line (the JAX package's
    runner/supervisor.py): desired/live/parked worker counts from the
    state-labeled ``pps_supervisor_workers`` gauges (per-state values,
    never summed across ``p<proc>/`` merge prefixes — only the one
    supervisor process publishes them), respawn/scale totals from the
    ``pps_supervisor_*_total`` counters (summed across prefixes), and
    the last scale action from the ``pps_supervisor_last_scale``
    timestamp gauges; None when the snapshot carries no supervisor
    series (unsupervised runs keep their original frame)."""
    workers = {}
    last = None  # (t, action)
    for key, v in (snap.get("gauges") or {}).items():
        name, labels = parse_series(key.rsplit("/", 1)[-1])
        try:
            if name == "pps_supervisor_workers":
                workers[labels.get("state", "?")] = int(float(v))
            elif name == "pps_supervisor_last_scale":
                t = float(v)
                if last is None or t > last[0]:
                    last = (t, labels.get("action", "?"))
        except (TypeError, ValueError):
            continue
    if not workers:
        return None
    respawns = scales = 0
    for key, v in (snap.get("counters") or {}).items():
        name, _labels = parse_series(key.rsplit("/", 1)[-1])
        try:
            if name == "pps_supervisor_respawns_total":
                respawns += int(v)
            elif name == "pps_supervisor_scale_events_total":
                scales += int(v)
        except (TypeError, ValueError):
            continue
    scale_txt = "-"
    if last is not None:
        ago = ""
        try:
            dt = float(snap.get("t", 0.0)) - last[0]
            if dt >= 0:
                ago = " (%.0fs ago)" % dt
        except (TypeError, ValueError):
            pass
        scale_txt = "%s%s" % (last[1], ago)
    return ("supervisor: desired %d  live %d  parked %d  "
            "respawns %d  scale-events %d  last scale %s" % (
                workers.get("desired", 0), workers.get("live", 0),
                workers.get("parked", 0), respawns, scales,
                scale_txt))


def render_watch(snap, prev=None, title=""):
    """A terminal dashboard frame from one snapshot (pptop-style).

    ``prev`` (the previous tick's snapshot) turns cumulative counters
    and histogram counts into per-second rates; per-phase latency
    p50/p90/p99/max come from the cumulative histograms.  Pure
    string-building: the ``--watch`` loops own the screen control.
    """
    if not snap:
        return "(no metrics snapshot yet)"
    lines = []
    head = "%s  t=%s  seq=%s  uptime=%.1fs" % (
        title or "metrics", time.strftime(
            "%H:%M:%S", time.localtime(snap.get("t", 0.0))),
        snap.get("seq"), float(snap.get("uptime_s", 0.0) or 0.0))
    lines.append(head.strip())
    dt = None
    if prev and snap.get("t") and prev.get("t"):
        dt = max(1e-9, float(snap["t"]) - float(prev["t"]))

    hists = snap.get("histograms") or {}
    by_phase = {}
    for key, h in hists.items():
        name, labels = parse_series(key)
        if name != PHASE_HISTOGRAM:
            continue
        phase = labels.get("phase", "?")
        cur = by_phase.get(phase)
        if cur is None:
            by_phase[phase] = Histogram.from_snapshot(h)
        else:
            cur.merge(Histogram.from_snapshot(h))
    if by_phase:
        lines.append("")
        lines.append("%-12s %8s %8s %9s %9s %9s %9s" %
                     ("phase", "n", "n/s", "p50", "p90", "p99", "max"))
        prev_counts = {}
        if prev:
            for key, h in (prev.get("histograms") or {}).items():
                name, labels = parse_series(key)
                if name == PHASE_HISTOGRAM:
                    ph = labels.get("phase", "?")
                    prev_counts[ph] = prev_counts.get(ph, 0) \
                        + int(h.get("count", 0))
        for phase in sorted(by_phase):
            h = by_phase[phase]
            rate = "-"
            if dt:
                rate = "%.2f" % ((h.count - prev_counts.get(phase, 0))
                                 / dt)
            lines.append("%-12s %8d %8s %9s %9s %9s %9s" % (
                phase, h.count, rate,
                _fmt_lat(h.quantile(0.5)), _fmt_lat(h.quantile(0.9)),
                _fmt_lat(h.quantile(0.99)), _fmt_lat(h.max)))

    # per-workload breakdown (the survey engine labels every phase
    # sample with its workload): only shown when the snapshot carries
    # more than the default single workload, so plain TOA surveys and
    # the service keep their original frame
    by_wl = {}
    for key, h in hists.items():
        name, labels = parse_series(key)
        if name != PHASE_HISTOGRAM or "workload" not in labels:
            continue
        k2 = (labels["workload"], labels.get("phase", "?"))
        cur = by_wl.get(k2)
        if cur is None:
            by_wl[k2] = Histogram.from_snapshot(h)
        else:
            cur.merge(Histogram.from_snapshot(h))
    if len({wl for wl, _ in by_wl}) > 1:
        lines.append("")
        lines.append("%-12s %-10s %8s %9s %9s %9s" %
                     ("workload", "phase", "n", "p50", "p99", "max"))
        for wl, phase in sorted(by_wl):
            h = by_wl[(wl, phase)]
            lines.append("%-12s %-10s %8d %9s %9s %9s" % (
                wl, phase, h.count,
                _fmt_lat(h.quantile(0.5)),
                _fmt_lat(h.quantile(0.99)), _fmt_lat(h.max)))

    gauges = snap.get("gauges") or {}
    mem = _memory_row(gauges)
    if mem:
        lines.append("")
        lines.append(mem)
    qual = _quality_row(snap)
    if qual:
        if not mem:
            lines.append("")
        lines.append(qual)
    cache = _compile_cache_row(snap)
    if cache:
        if not mem and not qual:
            lines.append("")
        lines.append(cache)
    alerts = _alerts_row(snap)
    if alerts:
        if not mem and not qual and not cache:
            lines.append("")
        lines.append(alerts)
    used = _usage_row(snap, prev, dt)
    if used:
        if not mem and not qual and not cache and not alerts:
            lines.append("")
        lines.append(used)
    sup = _supervisor_row(snap)
    if sup:
        if not mem and not qual and not cache and not alerts \
                and not used:
            lines.append("")
        lines.append(sup)
    if gauges:
        lines.append("")
        lines.append("gauges: " + "  ".join(
            "%s=%s" % (k, v) for k, v in sorted(gauges.items())))
    counters = snap.get("counters") or {}
    if counters:
        prev_c = (prev or {}).get("counters") or {}
        lines.append("")
        lines.append("counters:")
        for k in sorted(counters):
            rate = ""
            if dt:
                rate = "  (+%.2f/s)" % ((counters[k]
                                         - prev_c.get(k, 0)) / dt)
            lines.append("  %s: %s%s" % (k, counters[k], rate))
    return "\n".join(lines)
