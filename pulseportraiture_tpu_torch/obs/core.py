"""Structured observability core: runs, spans, events, fit telemetry.

One :class:`Recorder` per run writes two files under
``$PPTPU_OBS_DIR/<run-id>/``:

* ``events.jsonl`` — an append-only stream of timestamped JSON events
  (spans, one-off events, kernel-build notifications from the
  :mod:`.monitor` bridge, per-batch fit telemetry);
* ``manifest.json`` — the run's static context (shapes, config,
  platform, git SHA; see :mod:`.manifest`), rewritten at close with
  the aggregated counters, gauges and wall time merged in.

Design rules (the contract the tests enforce):

* **Disabled = free.**  With ``PPTPU_OBS_DIR`` unset (the default),
  every entry point short-circuits on ``_active is None`` — no files,
  no threads, no device synchronization.
* **Host-side only.**  Nothing here runs inside a kernel or a CUDA
  graph capture.  The device→host copy fit telemetry performs on the
  fit's per-subint vectors is the feature's documented cost, exactly
  like the PPTPU_SANITIZE NaN hooks.
* **Explicit device boundaries.**  A span that times device work must
  mark its result with ``sp.block(value)`` so the card holding it is
  synchronized before the duration is taken — otherwise asynchronous
  launches attribute the device time to whichever span happens to
  synchronize later.
* **Never fatal.**  Telemetry IO failures degrade to dropped events,
  not pipeline crashes.
"""

import contextlib
import functools
import json
import os
import threading
import time

from ..testing import faults
from . import monitor
from .manifest import build_manifest, device_info

__all__ = ["obs_dir", "enabled", "current", "run", "scoped_run",
           "configure", "span", "phases", "event", "counter", "gauge",
           "fit_telemetry", "Recorder", "list_event_files",
           "obs_max_bytes"]

_state_lock = threading.Lock()
_active = None           # the process's active Recorder, or None
_run_seq = 0             # uniquifies run dirs within one process

_tls = threading.local()  # per-thread span path stack + trace context


def _trace_child():
    """Allocate a child span under the thread's ambient trace context
    (obs/tracing.py) and install it; returns ``(saved_ctx, fields)`` —
    ``fields`` is None when no context is ambient.  The caller MUST
    restore ``_tls.trace = saved_ctx`` on exit.  Kept inline here (not
    in tracing.py) so the no-context cost is one thread-local read."""
    ctx = getattr(_tls, "trace", None)
    if ctx is None:
        return None, None
    sid = os.urandom(8).hex()
    _tls.trace = (ctx[0], sid)
    fields = {"trace_id": ctx[0], "span_id": sid}
    if ctx[1] is not None:
        fields["parent_span_id"] = ctx[1]
    return ctx, fields


def obs_dir():
    """$PPTPU_OBS_DIR, or None when observability is disabled."""
    v = os.environ.get("PPTPU_OBS_DIR", "").strip()
    return v or None


def obs_max_bytes():
    """$PPTPU_OBS_MAX_BYTES: events.jsonl rotation threshold in bytes
    (0 / unset / unparsable = no rotation)."""
    v = os.environ.get("PPTPU_OBS_MAX_BYTES", "").strip()
    try:
        return max(0, int(v)) if v else 0
    except ValueError:
        return 0


def list_event_files(run_dir):
    """Every event file of a run, oldest first: the rotated set
    (``events.jsonl.1``, ``events.jsonl.2``, ...) then the live
    ``events.jsonl``.  Readers (tools/obs_report.py, obs/merge.py) use
    this so survey-scale rotated runs read back as one stream."""
    out = []
    try:
        names = os.listdir(run_dir)
    except OSError:
        return out
    rotated = []
    for name in names:
        if name.startswith("events.jsonl."):
            suffix = name.rsplit(".", 1)[-1]
            if suffix.isdigit():
                rotated.append((int(suffix), name))
    out = [os.path.join(run_dir, name) for _, name in sorted(rotated)]
    live = os.path.join(run_dir, "events.jsonl")
    if os.path.isfile(live):
        out.append(live)
    return out


def enabled():
    """True when a run is active or PPTPU_OBS_DIR would enable one."""
    return _active is not None or obs_dir() is not None


def current():
    """The active Recorder, or None."""
    return _active


def _span_stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _json_default(x):
    # numpy scalars/arrays and other non-JSON leaves degrade to
    # something readable instead of raising mid-pipeline
    try:
        import numpy as np

        if isinstance(x, np.ndarray):
            return x.tolist()
        if isinstance(x, np.generic):
            return x.item()
    except Exception:
        pass
    return repr(x)


class Recorder:
    """JSONL event sink + manifest writer for one run."""

    def __init__(self, name, base_dir, config=None):
        global _run_seq
        with _state_lock:
            _run_seq += 1
            seq = _run_seq
        stamp = time.strftime("%Y%m%dT%H%M%S")
        self.run_id = "%s-%s-p%d-%02d" % (name, stamp, os.getpid(), seq)
        self.name = name
        self.dir = os.path.join(base_dir, self.run_id)
        os.makedirs(self.dir, exist_ok=True)
        self.events_path = os.path.join(self.dir, "events.jsonl")
        self.manifest_path = os.path.join(self.dir, "manifest.json")
        self._lock = threading.Lock()
        # always-on flight ring (obs/flight.py): every emitted event
        # also lands in a bounded in-memory deque, so a postmortem can
        # show the last few seconds even when the sink itself is dead
        from .flight import FlightRecorder

        self.flight = FlightRecorder(self)
        self._fh = open(self.events_path, "a", encoding="utf-8")
        # size-based sink rotation (PPTPU_OBS_MAX_BYTES): survey-scale
        # runs emit one fit event per archive batch and must not grow
        # one unbounded file
        self._max_bytes = obs_max_bytes()
        try:
            self._bytes = os.path.getsize(self.events_path)
        except OSError:
            self._bytes = 0
        self._rot_seq = 0
        self._t0 = time.time()
        self._perf0 = time.perf_counter()
        self.counters = {}
        self.gauges = {}
        self.n_events = 0
        self.dropped_events = 0  # sink-write failures (never fatal)
        self.compile_total_s = 0.0
        self.manifest = build_manifest(name, self.run_id, config=config)
        self._write_manifest()
        self._mon_cb = monitor.subscribe(self._on_monitoring)
        # streaming metrics (obs/metrics.py): registry + snapshot
        # exporter created lazily on the first metrics.* call, so a
        # run that records no metrics costs neither a thread nor a
        # metrics.jsonl
        self._metrics = None
        self._metrics_exporter = None
        # memory watermark sampler (obs/memory.py): created lazily on
        # the first span boundary, same gating as the exporter above
        self._memory = None
        # fit-quality aggregation (obs/quality.py): created lazily on
        # the first quality record — a run that fits nothing pays
        # nothing
        self._quality = None
        # alert-rule engine (obs/health.py): created lazily on the
        # first health evaluation (runner claim cycle, service health
        # verb), same gating as the states above
        self._health = None
        # usage-accounting plane (obs/usage.py): created lazily on the
        # first metered unit — a run that serves nothing bills nothing
        self._usage = None
        self._closed = False

    def metrics_registry(self):
        """The run's MetricsRegistry (created on first use, together
        with the periodic ``metrics.jsonl`` exporter)."""
        reg = self._metrics
        if reg is not None:
            return reg
        from .metrics import MetricsExporter, MetricsRegistry

        with self._lock:
            if self._metrics is None:
                self._metrics = MetricsRegistry()
                self._metrics_exporter = MetricsExporter(
                    self._metrics, self.dir)
            return self._metrics

    def memory_state(self):
        """The run's memory watermark sampler (obs/memory.py), created
        on first use; None when creation failed — never fatal."""
        st = self._memory
        if st is not None:
            return st
        from .memory import MemoryState

        with self._lock:
            if self._memory is None and not self._closed:
                try:
                    # publish=False init skips the registry re-entry path
                    self._memory = MemoryState(self)
                except Exception:
                    return None
            return self._memory

    def quality_state(self):
        """The run's fit-quality aggregator (obs/quality.py), created
        on first use; None when creation failed — never fatal."""
        st = self._quality
        if st is not None:
            return st
        from .quality import QualityState

        # materialize the registry first: QualityState.__init__ reads
        # it, and self._lock is not reentrant
        self.metrics_registry()
        with self._lock:
            if self._quality is None and not self._closed:
                try:
                    # registry materialized above: no re-entry
                    self._quality = QualityState(self)
                except Exception:
                    return None
            return self._quality

    def usage_state(self):
        """The run's usage-accounting plane (obs/usage.py), created on
        first use; None when creation failed — never fatal."""
        st = self._usage
        if st is not None:
            return st
        from .usage import UsageState

        # materialize the registry first: UsageState.__init__ reads
        # it, and self._lock is not reentrant
        self.metrics_registry()
        with self._lock:
            if self._usage is None and not self._closed:
                try:
                    # registry materialized above: no re-entry
                    self._usage = UsageState(self)
                except Exception:
                    return None
            return self._usage

    def health_state(self):
        """The run's alert-rule engine (obs/health.py), created on
        first use; None when PPTPU_HEALTH=0 or creation failed —
        never fatal."""
        st = self._health
        if st is not None:
            return st
        from .health import HealthState, health_enabled

        if not health_enabled():
            return None
        # materialize the registry first: HealthState samples it, and
        # self._lock is not reentrant
        self.metrics_registry()
        with self._lock:
            if self._health is None and not self._closed:
                try:
                    # registry materialized above: no re-entry
                    self._health = HealthState(self)
                except Exception:
                    return None
        exporter = self._metrics_exporter
        if exporter is not None and self._health is not None:
            # evaluate on the exporter cadence, just before each
            # periodic snapshot, so the alert gauges land in the
            # metrics.jsonl line that tick writes
            exporter.on_tick = self._health.evaluate
        return self._health

    # -- event stream ---------------------------------------------------

    def emit(self, kind, **fields):
        """Append one timestamped JSON event; never raises."""
        rec = {"t": round(time.time(), 6), "kind": kind}
        rec.update(fields)
        # flight ring first (obs/flight.py): the in-memory trail must
        # survive a sink-write failure — that failure is exactly what
        # a postmortem needs to explain
        self.flight.record(rec)
        try:
            line = json.dumps(rec, default=_json_default)
        except Exception:
            return
        with self._lock:
            if self._closed:
                return
            try:
                # chaos site: an injected sink-write failure (full
                # disk, dead NFS) must DROP the event, never crash the
                # pipeline — the "never fatal" contract above
                faults.check("obs_write")
                if self._max_bytes and self._bytes and \
                        self._bytes + len(line) + 1 > self._max_bytes:
                    self._rotate()
                # the sink write IS the critical section
                self._fh.write(line + "\n")
                self._fh.flush()  # bounded flush of one line
                self.n_events += 1
                self._bytes += len(line) + 1
            except (OSError, faults.InjectedFault):
                self.dropped_events += 1

    def _rotate(self):
        """Move the live events file aside as ``events.jsonl.<n>`` and
        start a fresh one (caller holds the lock).  ``.1`` is the
        oldest; ``list_event_files`` reads the set back in order.
        Failures degrade to continuing on the current file."""
        self._rot_seq += 1
        try:
            self._fh.close()
            os.replace(self.events_path,
                       "%s.%d" % (self.events_path, self._rot_seq))
        except OSError:
            pass
        self._fh = open(self.events_path, "a", encoding="utf-8")
        try:
            self._bytes = os.path.getsize(self.events_path)
        except OSError:
            self._bytes = 0

    def bump(self, name, inc=1):
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + inc

    def counter(self, name, inc=1):
        """Per-recorder form of the module-level :func:`counter` (the
        health/flight planes bump their own recorder's counters)."""
        self.bump(name, inc)

    def event(self, name, **fields):
        """Per-recorder form of the module-level :func:`event`: a
        one-off JSON event on THIS recorder, ambient-trace-stamped
        the same way (the health/flight planes emit their lifecycle
        events through the recorder they observe)."""
        ctx = getattr(_tls, "trace", None)
        if ctx is not None:
            fields.setdefault("trace_id", ctx[0])
            if ctx[1] is not None:
                fields.setdefault("span_id", ctx[1])
        self.emit("event", name=name, **fields)

    def set_gauge(self, name, value):
        with self._lock:
            self.gauges[name] = value

    def merge_config(self, config):
        """Fold extra config into the manifest (reentrant runs)."""
        self.manifest.setdefault("config", {}).update(config or {})
        self._write_manifest()

    # -- kernel-build bridge (obs/monitor.py) ---------------------------

    def _on_monitoring(self, evt, duration, **fields):
        if evt == monitor.COMPILE_EVENT:
            # one nvcc build of a kernel source (_kernels.build)
            self.bump("backend_compiles")
            with self._lock:
                self.compile_total_s += duration
            stack = _span_stack()
            self.emit("compile", dur_s=round(duration, 6),
                      span="/".join(s.name for s in stack) or None,
                      **fields)
        elif evt == monitor.CACHE_HIT_EVENT:
            # a kernel library already built: the build this process
            # did not pay.  Mirrored into the metrics plane so live
            # --watch views show the hit/miss ratio without waiting for
            # the run manifest.
            self.bump("compile_cache_hits")
            try:
                self.metrics_registry().inc(
                    "pps_compile_cache_hits_total")
            except Exception:
                pass
        elif evt == monitor.CACHE_MISS_EVENT:
            self.bump("compile_cache_misses")
            try:
                self.metrics_registry().inc(
                    "pps_compile_cache_misses_total")
            except Exception:
                pass

    # -- manifest -------------------------------------------------------

    def _write_manifest(self):
        try:
            tmp = self.manifest_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(self.manifest, fh, indent=1,
                          default=_json_default)
                fh.write("\n")
            os.replace(tmp, self.manifest_path)
        except OSError:
            pass

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        monitor.unsubscribe(self._mon_cb)
        if self._memory is not None:
            # stop the sampler BEFORE the exporter: the final memory
            # gauges must land in the final metrics.jsonl snapshot
            self._memory.stop()
        if self._quality is not None:
            # same ordering: the run-level quality fingerprint gauges
            # must make the manifest written below
            try:
                self._quality.stop()
            except Exception:
                pass
        if self._health is not None:
            # final rule pass BEFORE the exporter stop: the closing
            # alert gauges must land in the final metrics.jsonl
            # snapshot
            try:
                self._health.stop()
            except Exception:
                pass
        if self._usage is not None:
            # same ordering: the run-total usage gauges must make the
            # manifest written below (bench/obs_diff read them back)
            try:
                self._usage.stop()
            except Exception:
                pass
        if self._metrics_exporter is not None:
            # final cumulative snapshot: even a run closed before the
            # first periodic tick leaves one metrics.jsonl line
            self._metrics_exporter.stop()
        # the device facts once more: a run that first touched the card
        # after its manifest was opened reports the card now
        self.manifest.update(device_info())
        self.manifest.update(
            t_end=time.time(),
            wall_s=round(time.perf_counter() - self._perf0, 6),
            counters=dict(self.counters),
            gauges=dict(self.gauges),
            n_events=self.n_events,
            dropped_events=self.dropped_events,
            compile_total_s=round(self.compile_total_s, 6),
        )
        self._write_manifest()
        try:
            self._fh.close()
        except OSError:
            pass


@contextlib.contextmanager
def run(name, config=None, base_dir=None):
    """Open a run (Recorder) for the dynamic extent of the context.

    Reentrant: when a run is already active (a CLI opened one and a
    pipeline opens another), the existing recorder is reused — its
    manifest absorbs the inner ``config`` and the inner context's exit
    does NOT close it.  A no-op yielding None when PPTPU_OBS_DIR is
    unset — unless ``base_dir`` is given, which opens the run there
    regardless of the environment (callers whose *output* is the obs
    run, such as per-process shards).
    """
    global _active
    with _state_lock:
        existing = _active
    if existing is not None:
        if config:
            existing.merge_config(config)
        yield existing
        return
    base = base_dir or obs_dir()
    if base is None:
        yield None
        return
    try:
        rec = Recorder(name, base, config=config)
    except OSError:
        yield None  # an unwritable obs dir must not kill the pipeline
        return
    with _state_lock:
        _active = rec
    try:
        yield rec
    finally:
        with _state_lock:
            _active = None
        rec.close()


def scoped_run(name):
    """Decorator form of :func:`run` for pipeline entry points.

    ``@obs.scoped_run("pptoas")`` opens (or, reentrantly, joins) a run
    for the duration of each call; call :func:`configure` inside the
    body to fold runtime config into the manifest once it is known.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with run(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def configure(**config):
    """Merge fields into the active run's manifest config (no-op when
    no run is active)."""
    rec = _active
    if rec is not None:
        rec.merge_config(config)


def _sync(value):
    """Wait for the card(s) holding ``value`` (a tensor, or a dict, list
    or tuple of them); nothing for CPU tensors and host values.  Never
    raises: a failed synchronization surfaces at the caller's next
    device call, not in telemetry."""
    devs = set()
    todo = [value]
    while todo:
        v = todo.pop()
        if isinstance(v, dict):
            todo.extend(v.values())
        elif isinstance(v, (list, tuple)):
            todo.extend(v)
        else:
            dev = getattr(v, "device", None)
            if getattr(dev, "type", None) == "cuda":
                devs.add(dev)
    if not devs:
        return
    try:
        import torch

        for dev in devs:
            torch.cuda.synchronize(dev)
    except Exception:
        pass


class _Span:
    """Handle yielded by :func:`span`; ``block(x)`` marks the device
    value whose completion bounds the span."""

    __slots__ = ("name", "_block")

    def __init__(self, name):
        self.name = name
        self._block = None

    def block(self, value):
        """Mark ``value`` for a device synchronization at span exit;
        returns ``value`` unchanged so it nests in expressions."""
        self._block = value
        return value


class _NullSpan:
    __slots__ = ()
    name = None

    def block(self, value):
        return value


_NULL_SPAN = _NullSpan()


@contextlib.contextmanager
def span(name, **attrs):
    """Record a nested wall-clock span event.

    Usage::

        with obs.span("solve", archive=path, batch=B) as sp:
            out = fit_portrait_full_batch(...)
            sp.block(out.params)     # device boundary: block before t1

    Emits ``{"kind": "span", "name": ..., "path": "a/b/solve",
    "dur_s": ..., ...attrs}``.  When no run is active this is a no-op
    yielding a shared null handle.  Never call it inside a CUDA graph
    capture: the body would be timed at capture time once and never
    again.
    """
    rec = _active
    if rec is None:
        yield _NULL_SPAN
        return
    sp = _Span(name)
    stack = _span_stack()
    stack.append(sp)
    # ambient trace context (obs/tracing.py): the span becomes a child
    # of whatever request/archive trace this thread is working for,
    # and its own id is ambient for nested spans — zero caller churn
    saved_ctx, trace_fields = _trace_child()
    # memory watermark bracket (obs/memory.py): peak footprint over
    # the span's extent rides along as the event's ``peak_bytes``
    mem = rec.memory_state()
    mtok = mem.mark() if mem is not None else None
    t0 = time.perf_counter()
    err = None
    try:
        yield sp
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        if sp._block is not None:
            _sync(sp._block)
        dur = time.perf_counter() - t0
        if trace_fields is not None:
            _tls.trace = saved_ctx
        if stack and stack[-1] is sp:
            stack.pop()
        path = "/".join(s.name for s in stack + [sp])
        fields = dict(attrs)
        if trace_fields is not None:
            fields.update(trace_fields)
        if err is not None:
            fields["error"] = err
        if mtok is not None:
            pk = mem.peak(mtok)
            if pk:
                fields["peak_bytes"] = pk
        rec.emit("span", name=name, path=path, dur_s=round(dur, 6),
                 **fields)


class phases:
    """Sequential phase spans for long pipeline bodies.

    A with-block per phase would force re-indenting hundred-line
    pipeline sections; this timer instead closes the previous phase
    whenever the next one is entered::

        ph = obs.phases(archive=path)
        ph.enter("load");  data = load(...)
        ph.enter("solve"); out = fit(...); ph.block(out.params)
        ph.enter("write"); write(...)
        ph.done()

    Each phase is emitted as a normal span event (same schema and path
    rules) and participates in the thread's span stack, so compile
    events are attributed to the phase they occurred in.  ``done()``
    must run on every exit path of the instrumented region — a missed
    one drops that phase's event and cleans the stack lazily, it never
    corrupts later spans.  All methods are no-ops when no run is
    active at ``enter`` time.
    """

    def __init__(self, **attrs):
        self._attrs = attrs
        self._sp = None
        self._t0 = 0.0
        self._extra = {}
        self._block = None
        self._saved_ctx = None
        self._trace_fields = None
        self._mem = None
        self._mtok = None

    def enter(self, name, **attrs):
        """Close the current phase (if any) and open ``name``."""
        self._finish()
        rec = _active
        if rec is None:
            return
        self._sp = _Span(name)
        self._extra = dict(attrs)
        _span_stack().append(self._sp)
        # each phase is a child span of the ambient trace context, and
        # ambient for its own extent (same contract as obs.span)
        self._saved_ctx, self._trace_fields = _trace_child()
        self._mem = rec.memory_state()
        self._mtok = self._mem.mark() if self._mem is not None else None
        self._t0 = time.perf_counter()

    def block(self, value):
        """Device value bounding the CURRENT phase: its card is
        synchronized before the duration is taken.  Returns ``value``."""
        self._block = value
        return value

    def done(self, **attrs):
        """Close the current phase, folding ``attrs`` into its event."""
        self._extra.update(attrs)
        self._finish()

    def _finish(self):
        sp, self._sp = self._sp, None
        if sp is None:
            self._block = None
            return
        if self._block is not None:
            _sync(self._block)
            self._block = None
        dur = time.perf_counter() - self._t0
        trace_fields, self._trace_fields = self._trace_fields, None
        if trace_fields is not None:
            _tls.trace = self._saved_ctx
            self._saved_ctx = None
        stack = _span_stack()
        if sp in stack:
            path = "/".join(s.name for s in stack[:stack.index(sp) + 1])
            stack.remove(sp)
        else:
            path = sp.name
        mem, self._mem = self._mem, None
        mtok, self._mtok = self._mtok, None
        pk = mem.peak(mtok) if mem is not None and mtok is not None \
            else None
        rec = _active
        if rec is not None:
            fields = dict(self._attrs)
            fields.update(self._extra)
            if trace_fields is not None:
                fields.update(trace_fields)
            if pk:
                fields["peak_bytes"] = pk
            rec.emit("span", name=sp.name, path=path,
                     dur_s=round(dur, 6), **fields)
        self._extra = {}


def event(name, **fields):
    """One-off JSON event (no duration); no-op when no run is active.

    When a trace context is ambient (obs/tracing.py) the event is
    stamped with ``trace_id`` (+ the enclosing ``span_id``), so the
    lease/robustness audit events become causally searchable without
    any caller change.  Explicit fields win over the ambient stamp.
    """
    rec = _active
    if rec is not None:
        ctx = getattr(_tls, "trace", None)
        if ctx is not None:
            fields.setdefault("trace_id", ctx[0])
            if ctx[1] is not None:
                fields.setdefault("span_id", ctx[1])
        rec.emit("event", name=name, **fields)


def counter(name, inc=1):
    """Bump an aggregate counter (written into the manifest at close)."""
    rec = _active
    if rec is not None:
        rec.bump(name, inc)


def gauge(name, value):
    """Set a gauge (last value wins; manifest at close + JSONL event)."""
    rec = _active
    if rec is not None:
        rec.set_gauge(name, value)
        rec.emit("gauge", name=name, value=value)


# fields of a batched fit result that carry per-subint fit quality
_FIT_FIELDS = ("nfeval", "chi2", "red_chi2", "return_code")

# solver return codes that mean "converged" (config.RCSTRINGS): 0/1/2;
# 3 = iteration budget exhausted, 4 = damping blew past mu_max (stuck)
_CONVERGED_RCS = (0, 1, 2)


def _host(v):
    """A tensor (any device) or array-like as a host numpy array."""
    import numpy as np

    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def fit_telemetry(result, where="fit", **attrs):
    """Log per-batch fit-quality telemetry from a fit result.

    ``result`` is a fit DataBunch/dict carrying per-subint ``nfeval``,
    ``chi2``/``red_chi2`` and ``return_code`` (the auxiliary outputs
    the batched solver in fit/portrait.py returns).  Emits one ``fit``
    event with summary statistics, the return-code histogram, and the
    per-subint vectors.  Returns ``result`` unchanged.

    Host-side only, and nothing happens when no run is active.  The
    device→host copy of the small per-subint vectors (which waits for
    the fit) is the documented cost when enabled.
    """
    rec = _active
    if rec is None:
        return result
    try:
        fields = {k: result[k] for k in _FIT_FIELDS
                  if isinstance(result, dict) and k in result}
    except Exception:
        return result
    if not fields:
        return result
    import numpy as np

    try:
        host = {k: _host(v) for k, v in fields.items()}
    except Exception:
        return result
    ev = {"where": where}
    ev.update(attrs)
    nfev = np.atleast_1d(np.asarray(host.get("nfeval", [])))
    rc = np.atleast_1d(np.asarray(host.get("return_code", [])))
    chi2 = np.atleast_1d(np.asarray(
        host.get("red_chi2", host.get("chi2", []))), )
    ev["batch"] = int(nfev.size) if nfev.size else int(rc.size)
    if nfev.size:
        ev["nfeval"] = {"min": int(nfev.min()),
                        "median": float(np.median(nfev)),
                        "max": int(nfev.max())}
        ev["nfeval_per_subint"] = nfev.astype(int).tolist()
    if chi2.size:
        finite = np.isfinite(chi2)
        ev["chi2"] = {"median": float(np.median(chi2[finite]))
                      if finite.any() else None,
                      "max": float(chi2[finite].max())
                      if finite.any() else None,
                      "n_nonfinite": int((~finite).sum())}
        ev["red_chi2_per_subint"] = [round(float(x), 6) for x in chi2]
    if rc.size:
        hist = {}
        for code in rc.astype(int):
            hist[str(code)] = hist.get(str(code), 0) + 1
        ev["rc_hist"] = hist
        converged = np.isin(rc.astype(int), _CONVERGED_RCS)
        bad = ~converged
        if chi2.size == rc.size:
            bad = bad | ~np.isfinite(chi2)
        ev["n_bad"] = int(bad.sum())
        ev["bad_isubs"] = np.flatnonzero(bad).tolist()
    rec.emit("fit", **ev)
    rec.bump("fit_batches")
    rec.bump("fit_subints", ev.get("batch", 0))
    if "n_bad" in ev:
        rec.bump("fit_bad_subints", ev["n_bad"])
    return result
