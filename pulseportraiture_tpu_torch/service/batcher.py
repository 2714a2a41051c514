"""Cross-request micro-batching: coalesce same-bucket device dispatches.

The PyTorch port of the JAX package's ``service/batcher.py``.  The
service fits each request of a micro-batch on its own worker thread,
through an ordinary per-request ``GetTOAs`` whose ``fit_batch`` hook
points at one shared :class:`MicroBatcher` per shape bucket.  The hook
is where the requests meet: each worker's batched-fit call parks with
its argument set, and once every live worker of the cycle has either
parked or finished, the last arriver becomes the *leader* — it joins
the parked batches along the subint axis, issues ONE
``fit_portrait_full_batch`` dispatch for the combined batch, splits the
result rows back per caller and releases everyone.  K same-bucket
single-archive submissions therefore execute as ``ceil(K / batch_max)``
batched fits instead of K (the service's dispatcher sizes the cycles).

Coalescing is correctness-transparent:

* only calls with identical *static* fit configuration (fit flags,
  bounds, iteration caps, device, ...) merge — a config mismatch
  degrades to separate dispatches in the same cycle;
* per-call tensors (data, models, init, errs, weights, nu columns)
  are joined on the batch axis and the result rows are sliced back,
  so each request sees the rows its own solo dispatch would have
  produced (the solver is row-independent: one masked lane per
  subint, fit/portrait.py ``_solve``);
* the harmonic cutoff ``kmax`` is pinned to the max over the parked
  calls' models (``model_kmax``, one model row to the host per call) —
  without it the combined dispatch would take the first row's cutoff.

Joining on the card.  The port's pipeline hands the hook the data and
models as tensors on the fit's device (pipelines/toas.py), the other
columns as host arrays.  The leader joins the data with ``torch.cat``
on that device; a caller's one ``[nchan, nbin]`` model is expanded to
its rows and joined the same way (four 16-subint 512 x 2048 calls make
a 64 x 512 x 2048 float64 model block of 537 MB next to the data's
537 MB); errs, weights and the nu columns are moved to the device and
joined there, init, Ps and freqs joined as the types they came in.
Nothing of the data goes device -> host -> device.  The result rows are
slices of the combined output tensors, left on the device: the
pipeline copies each caller's rows to the host itself.

The reference pads the combined batch to its power-of-two bucket
(``bucket_batch_size``, passed as ``pad_to``) so that coalesced XLA
programs stay few per shape bucket.  The port resizes only
``scan_size`` (fit/portrait.py policy): its eager fit ignores
``pad_to``, its kernels compile nothing per batch size, so the
combined batch is fitted unpadded.

Failure semantics: a combined dispatch that raises fails every parked
call of that group — each request then retries through its tenant
ledger's backoff, and a retry may land in a different (possibly solo)
cycle.  Injected ``dispatch`` faults (testing/faults.py) fire per
archive *before* the hook, so a chaos-faulted request never reaches
the shared dispatch at all.
"""

import threading
import time

import numpy as np
import torch

from .. import obs
from ..obs import metrics, tracing
from ..obs.metrics import PHASE_HISTOGRAM

__all__ = ["MicroBatcher"]


def _device_of(x):
    """The device of a tensor, None for a host array."""
    return x.device if isinstance(x, torch.Tensor) else None


def _static_key(kw, data=None):
    """Hashable static-configuration key; calls coalesce only within
    one key.  The device (the ``device`` argument and the data's own)
    is part of it: calls for different devices never merge."""
    bounds = kw.get("bounds")
    if bounds is not None:
        bounds = tuple(None if b is None else tuple(
            None if v is None else float(v) for v in b) for b in bounds)
    nu_outs = kw.get("nu_outs")
    nu_outs_shape = None if nu_outs is None else \
        tuple(col is not None for col in nu_outs)
    device = kw.get("device")
    return (
        tuple(int(f) for f in kw.get("fit_flags", (1, 1, 0, 0, 0))),
        bounds,
        bool(kw.get("log10_tau", True)),
        int(kw.get("max_iter", 50)),
        kw.get("polish_iter"), kw.get("coarse_iter"),
        kw.get("coarse_kmax"),
        nu_outs_shape,
        kw.get("errs") is None,
        kw.get("weights") is None,
        None if device is None else str(torch.device(device)),
        None if data is None else str(_device_of(data)),
    )


def _on(x, dev):
    """``x`` as a float64 tensor on ``dev`` (a tensor already there is
    returned as is; a host array is uploaded once)."""
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    return torch.from_numpy(np.array(x, dtype=np.float64)).to(dev)


def _join(parts, dev=None):
    """Concatenate ``parts`` on the batch axis: on ``dev`` when given,
    else as the parts' own type (tensors on their device, host arrays
    with numpy)."""
    if dev is None:
        tens = [p for p in parts if isinstance(p, torch.Tensor)]
        if not tens:
            return np.concatenate([np.asarray(p) for p in parts], axis=0)
        dev = tens[0].device
    return torch.cat([_on(p, dev) for p in parts], dim=0)


def _rows(x, n, shape):
    """``x`` as ``n`` rows of ``shape`` (one period, or one ``[nchan,
    nbin]`` model, broadcast over the call's subints): a view, the join
    copies."""
    if isinstance(x, torch.Tensor):
        return x.expand((n,) + tuple(shape))
    return np.broadcast_to(np.asarray(x), (n,) + tuple(shape))


class _Parked:
    """One worker's fit call waiting for the cycle's leader."""

    __slots__ = ("args", "kw", "n", "event", "result", "error", "t0",
                 "ctx")

    def __init__(self, args, kw):
        self.args = args
        self.kw = kw
        # a tensor on the card or a host array: its leading extent
        self.n = int(args[0].shape[0])
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.t0 = time.perf_counter()  # park time (metrics)
        # the parking worker's trace context (obs/tracing.py): the
        # combined dispatch span links back to every member through it
        self.ctx = tracing.current()


class MicroBatcher:
    """Per-bucket coalescing ``fit_batch`` hook (module docstring).

    ``begin(n)`` opens a cycle expecting ``n`` worker threads;
    each worker must call ``worker_done()`` exactly once (in a
    ``finally``) so a request that never reaches a fit call — load
    failure, injected read fault, quarantine — releases the barrier
    instead of stalling the cycle until ``window_s``.
    """

    def __init__(self, bucket=None, window_s=2.0, fit=None):
        self.bucket = tuple(bucket) if bucket else None
        self.window_s = float(window_s)
        self._fit = fit  # injectable for tests; default resolved lazily
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._parked = []
        self._expected = 0
        self._done = 0
        # absolute dispatch deadline for the current cycle (service
        # dispatcher: the most urgent member's completion deadline);
        # None = window-only semantics
        self._deadline = None
        # cumulative stats (service status / obs)
        self.n_dispatches = 0
        self.n_calls = 0
        self.n_coalesced = 0  # calls that shared a dispatch

    # -- cycle management ----------------------------------------------

    def begin(self, n, deadline=None):
        """Open a cycle of ``n`` workers (dispatcher thread).

        ``deadline`` (absolute ``time.time()``) caps how long parked
        members wait for stragglers: past it, whoever notices leads a
        partial dispatch — a stalled sibling cannot park the rest of
        the cycle beyond the most urgent member's deadline.
        """
        with self._lock:
            self._expected = int(n)
            self._done = 0
            self._parked = []
            self._deadline = None if deadline is None \
                else float(deadline)

    def worker_done(self):
        """A worker of the cycle finished (fit call resolved, or it
        never made one)."""
        with self._lock:
            self._done += 1
            self._cond.notify_all()

    # -- the fit_batch hook --------------------------------------------

    def _resolve_fit(self):
        if self._fit is None:
            from ..fit.portrait import fit_portrait_full_batch

            self._fit = fit_portrait_full_batch
        return self._fit

    def fit(self, *args, **kw):
        """``fit_portrait_full_batch`` drop-in (GetTOAs.fit_batch)."""
        slot = _Parked(args, kw)
        with self._lock:
            self.n_calls += 1
            if self._expected <= 1:
                # solo cycle: no one to wait for
                return self._dispatch_alone(slot)
            self._parked.append(slot)
            if self._barrier_met():
                self._fire_locked()
            else:
                while not slot.event.is_set():
                    if not self._cond.wait(timeout=self._park_timeout()):
                        # window (or cycle deadline) expired: whoever
                        # notices first leads a partial dispatch so one
                        # slow sibling cannot hold the batch hostage
                        if not slot.event.is_set():
                            self._fire_locked()
                        break
                    if slot.event.is_set():
                        break
                    if self._barrier_met():
                        self._fire_locked()
        slot.event.wait()
        if slot.error is not None:
            raise slot.error
        return slot.result

    def _park_timeout(self):
        """In-barrier wait budget: the configured window, trimmed to
        the cycle deadline when one is nearer (caller holds the
        lock)."""
        timeout = threading.TIMEOUT_MAX if self.window_s <= 0 \
            else self.window_s
        if self._deadline is not None:
            timeout = min(timeout,
                          max(0.01, self._deadline - time.time()))
        return timeout

    def _barrier_met(self):
        # every expected worker is either parked here or fully done:
        # nothing more can join this round (caller holds the lock)
        return self._parked and \
            len(self._parked) + self._done >= self._expected

    # -- dispatching ---------------------------------------------------

    def _label(self):
        return "-" if self.bucket is None else "%dx%d" % self.bucket

    def _dispatch_alone(self, slot):
        fit = self._resolve_fit()
        self.n_dispatches += 1
        self._emit(1, slot.n)
        attrs = self._span_attrs([slot], slot.n)
        with metrics.timed(PHASE_HISTOGRAM, phase="dispatch",
                           bucket=self._label()), \
                obs.span("dispatch", **attrs):
            return fit(*slot.args, **self._sized_kw(slot.kw, slot.n))

    def _span_attrs(self, slots, total):
        """Attrs for the dispatch span: ONE span per batched fit,
        carrying a span link to every member call's context
        (obs/tracing.py), so a combined dispatch is causally reachable
        from each of the K requests it served."""
        attrs = {"n_requests": len(slots), "batch": int(total),
                 "bucket": None if self.bucket is None
                 else "%dx%d" % self.bucket}
        links = [tracing.link(s.ctx) for s in slots
                 if s.ctx is not None]
        if links:
            attrs["links"] = links
        return attrs

    def _sized_kw(self, kw, total):
        """Recompute ``scan_size`` for the (possibly combined) batch
        size; per-call values were sized for solo dispatch.  The port's
        fit ignores ``pad_to`` (module docstring)."""
        from ..fit.portrait import auto_scan_size

        return dict(kw, scan_size=auto_scan_size(total))

    def _fire_locked(self):
        """Dispatch every parked call (caller holds the lock); the
        current thread is the leader.  The device work runs OUTSIDE
        the lock so late workers can park for the next round."""
        parked, self._parked = self._parked, []
        self._lock.release()
        try:
            groups = {}
            for slot in parked:
                groups.setdefault(_static_key(slot.kw, slot.args[0]),
                                  []).append(slot)
            for slots in groups.values():
                self._dispatch_group(slots)
        finally:
            self._lock.acquire()
        self._cond.notify_all()

    def _dispatch_group(self, slots):
        # micro-batch park: how long each call waited for its leader
        t_fire = time.perf_counter()
        blabel = self._label()
        for slot in slots:
            park_s = max(0.0, t_fire - slot.t0)
            metrics.observe(PHASE_HISTOGRAM, park_s,
                            phase="park", bucket=blabel,
                            exemplar=slot.ctx[0] if slot.ctx else None)
            if slot.ctx is not None:
                # each member's wait-for-leader, in its own trace
                tracing.emit_span("park", park_s, ctx=slot.ctx,
                                  bucket=blabel)
        if len(slots) == 1:
            slot = slots[0]
            try:
                slot.result = self._dispatch_alone(slot)
            except BaseException as e:  # noqa: BLE001 — forwarded
                slot.error = e
            finally:
                slot.event.set()
            return
        try:
            self._dispatch_combined(slots)
        except BaseException as e:  # noqa: BLE001 — forwarded to all
            for slot in slots:
                slot.error = e
                slot.event.set()

    def _combined_args(self, slots):
        """(args, kw) of the combined dispatch (module docstring)."""
        from ..fit.portrait import model_kmax

        total = sum(s.n for s in slots)
        dev = _device_of(slots[0].args[0])
        # positional contract (pipelines/toas.py): data, models, init,
        # Ps, freqs; a model may be one [nchan, nbin] for the call
        data = _join([s.args[0] for s in slots], dev)
        models = _join([_rows(s.args[1], s.n, s.args[0].shape[1:])
                        if s.args[1].ndim == 2
                        or s.args[1].shape[0] != s.n else s.args[1]
                        for s in slots], dev)
        init = _join([s.args[2] for s in slots])
        Ps = _join([_rows(s.args[3], s.n, ())
                    if np.ndim(s.args[3]) == 0 else s.args[3]
                    for s in slots])
        freqs = _join([s.args[4] for s in slots])

        kw = self._sized_kw(slots[0].kw, total)
        for key in ("errs", "weights", "nu_fits"):
            if slots[0].kw.get(key) is not None:
                kw[key] = _join([s.kw[key] for s in slots], dev)
        nu_outs0 = slots[0].kw.get("nu_outs")
        if nu_outs0 is not None:
            kw["nu_outs"] = tuple(
                None if col is None else _join(
                    [s.kw["nu_outs"][i] for s in slots], dev)
                for i, col in enumerate(nu_outs0))
        # pin the harmonic cutoff to the most demanding member —
        # fit_portrait_full_batch would otherwise derive it from the
        # FIRST batch row only (fit/portrait.model_kmax)
        if kw.get("kmax") is None:
            kmaxes = [model_kmax(s.args[1]) for s in slots]
            kmaxes = [k for k in kmaxes if k is not None]
            if kmaxes:
                kw["kmax"] = max(kmaxes)
        return (data, models, init, Ps, freqs), kw, total

    def _dispatch_combined(self, slots):
        from ..utils.databunch import DataBunch

        fit = self._resolve_fit()
        args, kw, total = self._combined_args(slots)
        self.n_dispatches += 1
        self.n_coalesced += len(slots)
        self._emit(len(slots), total)
        with metrics.timed(PHASE_HISTOGRAM, phase="dispatch",
                           bucket=self._label()), \
                obs.span("dispatch", **self._span_attrs(slots, total)):
            out = dict(fit(*args, **kw))
        del args
        off = 0
        for slot in slots:
            # each caller's rows: slices of the combined output, left
            # where the fit put them
            slot.result = DataBunch(**{
                k: (v[off:off + slot.n]
                    if getattr(v, "ndim", 0) >= 1
                    and v.shape[0] == total else v)
                for k, v in out.items()})
            off += slot.n
            slot.event.set()

    def _emit(self, n_requests, total):
        obs.event("microbatch_dispatch",
                  bucket=None if self.bucket is None
                  else "%dx%d" % self.bucket,
                  n_requests=n_requests, batch=int(total))
        obs.counter("service_dispatches")
        if n_requests > 1:
            obs.counter("service_coalesced_requests", n_requests)
