"""Bounded double-buffered host prefetch (docs/RUNNER.md "Host
pipeline").

The survey fit loop (execute.py) runs each archive's load serially
*between* fits: the FITS read, the decode and statistics on the card
(io/archive.load_data) and ``pad_databunch``.  :class:`HostPrefetcher`
moves that load off the fit timeline: a small
worker pool runs :func:`~.plan.load_bucketed_databunch` for the *next*
archives while the current one fits, handing each finished buffer back
through a :class:`PrefetchTicket`.

Hand-off protocol (every invariant the serial path proves is preserved
by construction):

* **claim first, prefetch second** — callers submit a ticket only for
  an archive they have already claimed (and whose lease a heartbeat is
  renewing); a prefetch NEVER touches the ledger.
* **outcome replay** — the worker runs the exact serial load function
  and captures ``("data", bunch_or_None)`` or ``("raise", exc)``.  The
  consumer installs it via ``GetTOAs.preload``, so the fit's own
  ``_load_archive`` call site returns or raises precisely what it
  would have inline: ``archive_read`` / ``archive_pad`` injected
  faults (testing/faults.py) keep their quarantine/retry/backoff
  semantics unchanged, they merely fire on the prefetch thread.
* **discard without transition** — a lease lost (or drain/stop) while
  a ticket is queued discards the buffer (:meth:`~HostPrefetcher.
  discard`); whether the ledger then gets a ``reset`` (we still own
  the claim and hand it back) or nothing at all (a sibling took it) is
  the *caller's* decision, same as serial.
* **bounded memory** — live ticket bytes are capped by ``depth ×
  ShapeBucket.est_bytes()`` (the runner bounds its claim-ahead window
  at ``depth``; the daemon uses :meth:`~HostPrefetcher.try_submit`,
  which refuses past the cap) and surfaced in the memory plane as the
  ``pps_prefetch_buffer_bytes`` gauge.
* **trace adoption** — the worker activates the archive's trace
  context for the whole load, so decode spans, fault events, and the
  ``prefetch_load`` span stay attributed to their request while
  visibly moving OFF the request's critical path (tools/obs_trace.py).

The pool defaults to ONE worker: hand-off order then equals submission
(claim) order, so ``nth=``/``every=`` fault-site counting stays
deterministic, and the overlap that matters — load vs *fit* — needs no
load-vs-load parallelism.  The worker thread does the load's device
work too: it uploads the stored DATA column, runs the decode, baseline
and statistics kernels (K5-K7) on the card and brings the subints back
into pinned host memory, on its current stream (the device's default
stream, as the fit thread's).  The buffer it hands over is the serial
load's DataBunch: its numpy schema, as in the JAX package, and the
load's device cube beside it (``io.archive.LoadedBunch``), which the fit
thread's ``GetTOAs`` takes and indexes on the card instead of uploading
the portraits again.  ``load_data`` returns only after its download into
pinned memory, which synchronises the worker's stream, so the cube is
complete when the fit thread reads it: no event is needed.  A cube lives
from its load to the end of its archive's fit, so the card holds at most
``depth`` held cubes (the live tickets) and the one being fitted; a
padded archive's cube is dropped at the pad (``pad_databunch``) and its
host cube uploaded by the fit.  A prefetched buffer replays
bit-identically to a serial load.
"""

import contextlib
import queue as queue_mod
import threading
import time

from .. import obs
from ..obs import metrics, tracing
from ..obs.metrics import PHASE_HISTOGRAM

__all__ = ["HostPrefetcher", "PrefetchTicket", "DEPTH_GAUGE",
           "BYTES_GAUGE", "HITS_COUNTER", "MISSES_COUNTER",
           "DISCARDED_COUNTER"]

# host-pipeline metric names (docs/OBSERVABILITY.md)
DEPTH_GAUGE = "pps_prefetch_depth"
BYTES_GAUGE = "pps_prefetch_buffer_bytes"
HITS_COUNTER = "pps_prefetch_hits"
MISSES_COUNTER = "pps_prefetch_misses"
DISCARDED_COUNTER = "pps_prefetch_discarded"


class PrefetchTicket:
    """Hand-off slot for one submitted load.

    The worker publishes exactly one outcome — ``("data", bunch)`` or
    ``("raise", exc)`` — and sets the event; the consumer side either
    waits for it (:meth:`HostPrefetcher.consume`) or abandons it
    (:meth:`HostPrefetcher.discard`).
    """

    __slots__ = ("path", "est_bytes", "ctx", "load_s", "_evt",
                 "_outcome", "_cancelled")

    def __init__(self, path, est_bytes=0, ctx=None):
        self.path = path
        self.est_bytes = int(est_bytes or 0)
        self.ctx = tuple(ctx) if ctx is not None else None
        self.load_s = None
        self._evt = threading.Event()
        self._outcome = ("data", None)
        self._cancelled = False

    def done(self):
        """True when the load outcome is published (no wait)."""
        return self._evt.is_set()

    def cancel(self):
        """Ask the worker to skip this load if it has not started."""
        self._cancelled = True

    def wait(self, timeout=None):
        """Block until the outcome is published; returns it (or the
        null outcome on timeout — callers that can time out must check
        :meth:`done`)."""
        self._evt.wait(timeout)
        return self._outcome


class HostPrefetcher:
    """A small thread pool decoding + padding upcoming archives.

    ``depth`` bounds the live (submitted, not yet consumed/discarded)
    tickets a *bounded* submitter may hold — the memory cap is
    ``depth × est_bytes`` of the costliest bucket, reported live on the
    ``pps_prefetch_buffer_bytes`` gauge.  ``workers`` defaults to 1
    (module docstring: deterministic hand-off order).
    """

    def __init__(self, depth=2, workers=1, name="pptpu-prefetch"):
        self.depth = max(1, int(depth))
        self.name = name
        self._jobs = queue_mod.SimpleQueue()
        self._lock = threading.Lock()
        self._stopped = False
        self._n_live = 0
        self._live_bytes = 0
        self.peak_bytes = 0
        self.n_hits = 0
        self.n_misses = 0
        self.n_discarded = 0
        metrics.set_gauge(DEPTH_GAUGE, self.depth)
        metrics.set_gauge(BYTES_GAUGE, 0)
        self._threads = []
        for i in range(max(1, int(workers))):
            t = threading.Thread(target=self._run, daemon=True,
                                 name="%s-%d" % (name, i))
            t.start()
            self._threads.append(t)

    # -- submit side ----------------------------------------------------
    def submit(self, path, loader, est_bytes=0, ctx=None):
        """Queue ``loader()`` (a zero-arg callable returning the loaded
        buffer) for ``path``; returns the :class:`PrefetchTicket`.

        The caller is responsible for bounding its live tickets at
        ``depth`` (the runner's claim-ahead window does) and for
        holding the archive's claim+lease for the ticket's lifetime.
        """
        ticket = PrefetchTicket(path, est_bytes=est_bytes, ctx=ctx)
        with self._lock:
            self._n_live += 1
            self._live_bytes += ticket.est_bytes
            self.peak_bytes = max(self.peak_bytes, self._live_bytes)
            live = self._live_bytes
        metrics.set_gauge(BYTES_GAUGE, live)
        self._jobs.put((ticket, loader))
        return ticket

    def try_submit(self, path, loader, est_bytes=0, ctx=None):
        """Like :meth:`submit`, but returns None instead of exceeding
        ``depth`` live tickets — the unbounded-submitter guard (the
        daemon's intake may admit more parked requests than the window;
        the overflow simply decodes inline at fit time, as before)."""
        with self._lock:
            if self._stopped or self._n_live >= self.depth:
                return None
        return self.submit(path, loader, est_bytes=est_bytes, ctx=ctx)

    # -- worker side ----------------------------------------------------
    def _run(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            ticket, loader = job
            if ticket._cancelled or self._stopped:
                # discarded before the load started: publish the null
                # outcome so a racing wait() can never hang
                ticket._evt.set()
                continue
            # adopt the archive's trace context for the WHOLE load:
            # decode spans and injected-fault events attribute to the
            # archive's trace exactly as they would inline, and the
            # prefetch_load span shows the load moved off the fit
            # timeline
            ctx = contextlib.nullcontext() if ticket.ctx is None \
                else tracing.activate(ticket.ctx)
            t0 = time.perf_counter()
            with ctx:
                try:
                    outcome = ("data", loader())
                except BaseException as e:  # replayed at the consumer
                    outcome = ("raise", e)
                dt = time.perf_counter() - t0
                tracing.emit_span("prefetch_load", dt,
                                  archive=ticket.path,
                                  outcome=outcome[0])
                metrics.observe(PHASE_HISTOGRAM, dt,
                                phase="prefetch_load")
            ticket.load_s = dt
            ticket._outcome = outcome
            ticket._evt.set()

    # -- consume side ---------------------------------------------------
    def consume(self, ticket):
        """The load outcome for ``ticket``, waiting if it is still in
        flight; counts a *hit* (buffer ready before the fit needed it)
        or a *miss* (the fit had to wait)."""
        if ticket.done():
            self.n_hits += 1
            metrics.inc(HITS_COUNTER)
            obs.counter(HITS_COUNTER)
        else:
            self.n_misses += 1
            metrics.inc(MISSES_COUNTER)
            obs.counter(MISSES_COUNTER)
        outcome = ticket.wait()
        self._release(ticket)
        return outcome

    def discard(self, ticket, cause):
        """Drop ``ticket`` without consuming it (lease lost, drain,
        shutdown).  Only the buffer is released — any ledger transition
        (or deliberate absence of one) is the caller's move."""
        ticket.cancel()
        self.n_discarded += 1
        metrics.inc(DISCARDED_COUNTER)
        obs.counter(DISCARDED_COUNTER)
        obs.event("prefetch_discarded", archive=ticket.path,
                  cause=cause)
        self._release(ticket)

    def _release(self, ticket):
        with self._lock:
            self._n_live = max(0, self._n_live - 1)
            self._live_bytes = max(0,
                                   self._live_bytes - ticket.est_bytes)
            live = self._live_bytes
        metrics.set_gauge(BYTES_GAUGE, live)

    # -- lifecycle ------------------------------------------------------
    def stop(self, wait=True, timeout=10.0):
        """Stop the workers (each finishes its current load first —
        a drain is a *flush*, never a mid-decode abort)."""
        self._stopped = True
        for _ in self._threads:
            self._jobs.put(None)
        if wait:
            deadline = time.monotonic() + timeout
            for t in self._threads:
                t.join(max(0.0, deadline - time.monotonic()))
