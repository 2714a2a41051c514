"""Live memory observability: allocator/host watermarks, per-span peaks.

The port's counterpart of the JAX package's ``obs/memory.py``, with the
same activation contract as everything else in ``obs``:

* **Live sampler** — one daemon thread per run (gated exactly like the
  ``metrics.jsonl`` exporter: created lazily on the first span, cadence
  ``PPTPU_MEMORY_INTERVAL`` seconds, default the metrics interval, 0
  disables the thread) reads the CUDA caching allocator's statistics
  (``torch.cuda.memory_stats``) plus host RSS and publishes the
  ``pps_device_bytes_in_use`` gauge (the allocator's
  ``allocated_bytes.all.current``: bytes held by live tensors), the
  ``pps_device_peak_bytes`` gauge (``allocated_bytes.all.peak``, the
  statistic ``torch.cuda.max_memory_allocated`` reads) and
  ``pps_host_rss_bytes`` into the run's streaming-metrics registry.
  The allocator is read only once this process has initialized CUDA:
  the sampler never initializes a device itself.
* **Per-span peak watermarks** — :meth:`MemoryState.mark` /
  :meth:`MemoryState.peak` bracket every ``obs.span`` / ``obs.phases``
  extent (wired in ``obs/core.py``), so each span event carries a
  ``peak_bytes`` field: the maximum *footprint* observed between entry
  and exit.  Every sample (boundary or periodic) folds into all open
  marks; and when the allocator's own peak rose during the span, that
  peak was reached inside it, so it folds in too — a transient peak
  between two samples is still seen.  Nothing here resets the
  allocator's peak statistics: a caller's own
  ``reset_peak_memory_stats`` / ``max_memory_allocated`` bracket stays
  intact.
* **Footprint semantics** — ``footprint_bytes`` is the allocator's
  in-use bytes summed over the devices once CUDA is initialized, else
  host RSS (a CPU run's tensors live in the process heap, so RSS is the
  honest watermark).  Which one a sample used is recorded (``source``:
  ``device`` / ``host``).
* **OOM forensics** — :func:`device_memory_dump` pickles the caching
  allocator's snapshot (``torch.cuda.memory._snapshot()``: segments,
  blocks and their allocation stacks where recording is on) into a
  run-dir file; :func:`record_oom` attaches its path plus the last
  sampled watermarks to an ``oom`` event.

Never fatal, host-side only, and disabled = free: with no run active
every module-level helper is one attribute read + ``None`` check.
"""

import itertools
import os
import sys
import threading

from . import core as _core
from . import metrics as _metrics

__all__ = ["GAUGE_IN_USE", "GAUGE_PEAK", "GAUGE_HOST_RSS",
           "memory_interval", "host_rss_bytes", "sample",
           "watermarks", "last", "is_oom", "record_oom",
           "device_memory_dump", "MemoryState"]

# the streaming-metrics gauge names the sampler publishes (and the
# --watch memory row / obs_report read back)
GAUGE_IN_USE = "pps_device_bytes_in_use"
GAUGE_PEAK = "pps_device_peak_bytes"
GAUGE_HOST_RSS = "pps_host_rss_bytes"


def memory_interval():
    """$PPTPU_MEMORY_INTERVAL: sampler cadence in seconds (default:
    the metrics snapshot interval; 0 disables the thread — boundary
    samples at span entry/exit still run)."""
    v = os.environ.get("PPTPU_MEMORY_INTERVAL", "").strip()
    try:
        return max(0.0, float(v)) if v else _metrics.metrics_interval()
    except ValueError:
        return _metrics.metrics_interval()


_page_size = None


def host_rss_bytes():
    """Resident set size of this process in bytes (0 when /proc is
    unavailable — never fatal)."""
    global _page_size
    try:
        if _page_size is None:
            _page_size = os.sysconf("SC_PAGE_SIZE")
        with open("/proc/self/statm", "rb") as fh:
            return int(fh.read().split()[1]) * _page_size
    except (OSError, ValueError, IndexError):
        return 0


def _cuda():
    """torch, when this process has initialized CUDA; else None (the
    sampler must never be the thing that initializes a device)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        return torch if torch.cuda.is_initialized() else None
    except Exception:
        return None


def sample():
    """One point-in-time watermark sample.

    Returns ``{"host_rss_bytes", "footprint_bytes", "source"}`` plus,
    once CUDA is initialized, ``device_bytes_in_use`` /
    ``device_peak_bytes`` (the caching allocator's current and peak
    allocated bytes, summed over the devices).  ``footprint_bytes`` is
    the number per-span peaks track: device in-use when available, else
    host RSS.
    """
    out = {"host_rss_bytes": host_rss_bytes()}
    torch = _cuda()
    if torch is not None:
        in_use = peak = 0
        for d in range(torch.cuda.device_count()):
            try:
                st = torch.cuda.memory_stats(d)
            except Exception:
                st = {}
            bi = int(st.get("allocated_bytes.all.current", 0) or 0)
            in_use += bi
            peak += int(st.get("allocated_bytes.all.peak", bi) or bi)
        out["device_bytes_in_use"] = in_use
        out["device_peak_bytes"] = max(peak, in_use)
        out["footprint_bytes"] = in_use
        out["source"] = "device"
    else:
        out["footprint_bytes"] = out["host_rss_bytes"]
        out["source"] = "host"
    return out


class _Mark:
    """One open watermark bracket (a span's extent): the highest
    footprint seen in it, and the allocator's peak when it opened."""

    __slots__ = ("peak", "dev_peak0")

    def __init__(self, peak, dev_peak0):
        self.peak = peak
        self.dev_peak0 = dev_peak0

    def fold(self, s):
        """Fold one sample in: its footprint, and the allocator's peak
        when that rose since the bracket opened (the peak was then
        reached inside the bracket)."""
        f = s["footprint_bytes"]
        dev_peak = s.get("device_peak_bytes")
        if dev_peak is not None and self.dev_peak0 is not None \
                and dev_peak > self.dev_peak0:
            f = max(f, dev_peak)
        if f > self.peak:
            self.peak = f


class MemoryState:
    """Per-recorder sampler thread + watermark bookkeeping.

    Created lazily by :meth:`~.core.Recorder.memory_state` on the first
    span boundary (a run that never opens a span costs nothing), and
    stopped by ``Recorder.close()`` *before* the metrics exporter so
    the final gauges land in the final ``metrics.jsonl`` snapshot.
    """

    def __init__(self, recorder, interval_s=None):
        self._recorder = recorder
        self.interval_s = memory_interval() if interval_s is None \
            else float(interval_s)
        self._lock = threading.Lock()
        self._marks = {}
        self._mark_seq = itertools.count(1)
        self._last = None
        self._run = None  # the run-long bracket, opened by the 1st sample
        self.run_peak_bytes = 0
        self.n_samples = 0
        self._stop = threading.Event()
        self._thread = None
        self.sample_now(publish=False)
        # the footprint when sampling began: on the CPU the estimator
        # compares against peak GROWTH over this baseline (the
        # interpreter and the torch runtime dominate absolute RSS)
        self.baseline_footprint_bytes = self._last["footprint_bytes"]
        if self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, name="pptpu-memory-sampler",
                daemon=True)
            self._thread.start()

    # -- sampling -------------------------------------------------------

    def sample_now(self, publish=True):
        """Take one sample, fold it into every open mark, optionally
        publish the gauges; returns the sample dict."""
        s = sample()
        with self._lock:
            self._last = s
            self.n_samples += 1
            if self._run is None:
                self._run = _Mark(s["footprint_bytes"],
                                  s.get("device_peak_bytes"))
            for m in [self._run, *self._marks.values()]:
                m.fold(s)
            self.run_peak_bytes = self._run.peak
        if publish:
            self._publish(s)
        return s

    def last(self):
        """The most recent sample (never None after construction)."""
        with self._lock:
            return dict(self._last) if self._last else None

    def _publish(self, s):
        # gauges go through the run's streaming-metrics registry (the
        # --watch / Prometheus surface); creating it here is exactly
        # the metrics-exporter activation the sampler is gated like
        try:
            reg = self._recorder.metrics_registry()
        except Exception:
            return
        reg.set_gauge(GAUGE_HOST_RSS, s["host_rss_bytes"])
        if "device_bytes_in_use" in s:
            reg.set_gauge(GAUGE_IN_USE, s["device_bytes_in_use"])
            reg.set_gauge(GAUGE_PEAK, s["device_peak_bytes"])
        else:
            # no CUDA in this process: the footprint gauges mirror RSS
            # so the watch row / regression gates read one schema
            # everywhere
            reg.set_gauge(GAUGE_IN_USE, s["footprint_bytes"])
            with self._lock:
                peak = self.run_peak_bytes
            reg.set_gauge(GAUGE_PEAK, peak)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.sample_now()

    # -- span watermarks ------------------------------------------------

    def mark(self):
        """Open a watermark bracket (span entry); returns a token."""
        self.sample_now(publish=False)
        with self._lock:
            tok = next(self._mark_seq)
            self._marks[tok] = _Mark(self._last["footprint_bytes"],
                                     self._last.get("device_peak_bytes"))
        return tok

    def peak(self, tok):
        """Close a bracket (span exit); returns its peak footprint in
        bytes, or None for an unknown token."""
        self.sample_now(publish=False)
        with self._lock:
            m = self._marks.pop(tok, None)
        return None if m is None else m.peak

    # -- lifecycle ------------------------------------------------------

    def stop(self):
        """Stop the thread, take a final sample, publish final gauges
        (only when a metrics registry already exists — stopping must
        not create one), and record the run-level peak gauges."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None
        self.sample_now(publish=False)
        s = self.last() or {}
        rec = self._recorder
        if rec._metrics is not None:
            self._publish(s)
        # manifest gauges: the run-level summary obs_report / bench
        # read back without parsing metrics.jsonl
        rec.set_gauge("peak_footprint_bytes", self.run_peak_bytes)
        rec.set_gauge("baseline_footprint_bytes",
                      self.baseline_footprint_bytes)
        rec.set_gauge("host_rss_bytes", s.get("host_rss_bytes", 0))
        if "device_peak_bytes" in s:
            rec.set_gauge("device_peak_bytes", s["device_peak_bytes"])


# -- module-level helpers (the instrumented-code API) -------------------


def _state():
    rec = _core._active
    if rec is None:
        return None
    return rec.memory_state()


def watermarks():
    """A fresh watermark sample of the active run (fed into the run's
    open marks), or None when no run is active."""
    st = _state()
    return None if st is None else st.sample_now(publish=False)


def last():
    """The active run's most recent sample without taking a new one
    (the OOM-forensics read), or None when no run is active."""
    st = _state()
    return None if st is None else st.last()


def is_oom(err):
    """True when ``err`` (an exception or its message string) looks
    like a device out-of-memory failure: ``torch.cuda.OutOfMemoryError``
    ("CUDA out of memory. Tried to allocate ..."), or the JAX package's
    ``RESOURCE_EXHAUSTED`` marker, so the string form recorded in
    ``failed_datafiles`` classifies the same as the live exception."""
    text = str(err)
    return ("RESOURCE_EXHAUSTED" in text
            or "out of memory" in text.lower())


def record_oom(where, err, **fields):
    """OOM forensics: emit an ``oom`` event into the active run.

    The event carries the error text, a final watermark sample (plus
    the run peak so far) and the path of a fresh allocator snapshot
    (:func:`device_memory_dump`).  Returns the event fields, or None
    when no run is active.  Never fatal — forensics must not mask the
    failure being recorded.
    """
    rec = _core._active
    if rec is None:
        return None
    try:
        ev = dict(fields)
        ev["where"] = where
        ev["error"] = str(err)[:500]
        st = rec.memory_state()
        if st is not None:
            ev["watermarks"] = st.sample_now(publish=False)
            ev["run_peak_bytes"] = st.run_peak_bytes
        scopes = getattr(rec, "memory_scopes", None)
        if scopes:
            ev["scopes"] = scopes
        dump = device_memory_dump(rec.dir)
        if dump:
            ev["memory_profile"] = dump
        rec.emit("oom", **ev)
        rec.bump("oom_events")
        return ev
    except Exception:
        return None


def device_memory_dump(run_dir, tag="oom"):
    """Pickle the CUDA caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``) into ``run_dir``; returns the
    path, or None when CUDA is not initialized in this process or the
    dir is unwritable.  Never fatal."""
    torch = _cuda()
    if torch is None:
        return None
    try:
        import pickle

        snap = torch.cuda.memory._snapshot()
        path = os.path.join(run_dir, "%s_memory.pickle" % tag)
        with open(path, "wb") as fh:
            pickle.dump(snap, fh)
    except Exception:
        return None
    return path
