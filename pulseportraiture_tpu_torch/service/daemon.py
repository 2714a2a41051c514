"""TOA-as-a-service: the resident multi-tenant fitting daemon.

The PyTorch port of the JAX package's ``service/daemon.py``: the same
daemon, fitting on one device (``device=``, the CUDA device unless the
caller asks for ``"cpu"``; with no CUDA device and no ``"cpu"`` the
constructor raises).

``run_survey`` (runner/execute.py) is batch-shaped: every invocation
pays archive load, kernel build and process bring-up.
:class:`TOAService` keeps all of that resident so every request after
warm-up is *fit-bound*:

* **Intake / tenancy** — each tenant owns a ledger-backed work queue
  (``runner/queue.WorkQueue`` under ``<workdir>/tenants/<name>/``):
  the same append-only / bounded-retry / quarantine semantics the
  survey runner trusts, so a request's full lifecycle — attempts,
  failure reasons, terminal state — is crash-safe on disk and a
  restarted daemon resumes whatever was accepted but unfinished.
  Fitted TOAs land in the tenant's own ``toas.tim`` through the
  pipeline's exactly-once checkpoint protocol (block + ``pp_done``
  marker per archive), which also makes duplicate submissions replay
  the recorded result instead of refitting.
* **Warm bucket pools** — per-(nchan, nbin)-bucket
  ``_BucketedGetTOAs`` fitters are pooled and reused across requests
  (result state reset between checkouts), and ``warm()`` builds the
  hand-written kernels and primes every shape a plan enumerates
  (service/warm.py), so a request on a planned bucket triggers zero
  kernel builds (``nvcc``).
* **Micro-batching** — the dispatcher coalesces same-bucket requests
  that arrive within ``batch_window_s`` (up to ``batch_max``) into one
  cycle; their device dispatches merge through the bucket's
  :class:`~.batcher.MicroBatcher`, so K single-archive submissions
  cost ~ceil(K/batch) batched fits.  The K worker threads of a cycle
  upload their archives and run their FFTFIT guesses (kernel K2)
  concurrently on the device's default stream; the cycle's leader runs
  the combined fit (K1, or K3 for a scattering fit) for all of them.
* **Fairness / backpressure** — cycles seed from the tenant whose
  oldest ready request has waited longest, each tenant holds at most
  ``tenant_max_inflight`` slots of a cycle, and a tenant whose open
  requests reach ``tenant_max_queue`` gets ``backpressure`` rejections
  instead of unbounded intake; no tenant can starve another.
* **SLO under chaos** (testing/faults.py, docs/SERVICE.md failure
  matrix) — injected ``archive_read``/``dispatch`` faults travel the
  same per-archive isolation path as the survey runner
  (``runner/execute._fit_one``): the affected request retries with
  backoff and quarantines on exhaustion, concurrent requests —
  including the rest of its own micro-batch cycle — complete.
  SIGTERM (cli/ppserve.py) flips :meth:`request_drain`: intake starts
  rejecting, everything already accepted finishes, state flushes, the
  daemon exits 0.

Observability: the daemon runs under one long-lived obs run
(``<workdir>/obs``, events rotated via ``PPTPU_OBS_MAX_BYTES``), and
every request additionally gets its own run directory under
``<workdir>/obs_requests`` (manifest + lifecycle events + its compile
counters — a warm request's manifest proves ``backend_compiles: 0``:
no ``nvcc`` build ran while it was open).  Device profiler capture
(``PPTPU_TRACE_DIR``) is process-global: when two requests' archives
are fitted at once, the second records a ``trace_skipped`` event and
fits untraced (obs/trace.py).
Request run dirs are pruned to a count/byte budget
(``run_dirs_max``/``run_bytes_max``, env
``PPTPU_SERVE_MAX_RUNS``/``PPTPU_SERVE_MAX_RUN_BYTES``) so a resident
process cannot grow obs state without bound.
"""

import collections
import contextlib
import functools
import itertools
import os
import re
import shutil
import threading
import time

from .. import obs
from ..io.timfile import format_toa_line
from ..obs import flight, memory, metrics, quality, tracing, usage
from ..obs import health as obs_health
from ..obs.metrics import PHASE_HISTOGRAM
from ..obs.core import Recorder
from ..config import resolve_device
from ..runner.execute import _BucketedGetTOAs, _fit_one
from ..runner.plan import SurveyPlan, canonical_shape, \
    estimate_archive_bytes, load_bucketed_databunch, \
    scan_archive_header
from ..runner.prefetch import HostPrefetcher
from ..runner.queue import DONE, FAILED, QUARANTINED, WorkQueue
from ..testing import faults
from .batcher import MicroBatcher

__all__ = ["TOAService", "Request"]

_TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")

# request-side states layered over the ledger's: "dispatching" marks a
# request claimed by the current micro-batch cycle
PENDING = "pending"
DISPATCHING = "dispatching"

_REQ_SEQ = itertools.count(1)

# deadline-aware parking (docs/SERVICE.md "Deadline semantics"): a
# request is never parked past this fraction of its deadline budget —
# the rest is reserved for the fit itself
PARK_FRACTION = 0.5

# adaptive window ceiling: under sustained load the parking window
# stretches up to this multiple of ``batch_window_s`` (denser batches
# when arrivals keep coming), never beyond
WINDOW_STRETCH_MAX = 4.0

# arrival-rate window feeding the load stretch [s]
_LOAD_WINDOW_S = 1.0


def _blabel(key):
    """Metrics label for a shape bucket ('-' before classification)."""
    return "-" if key is None else "%dx%d" % tuple(key)


def _env_int(name, default):
    v = os.environ.get(name, "").strip()
    try:
        return int(v) if v else default
    except ValueError:
        return default


def _device_memory(device):
    """The caching allocator's bytes on ``device`` (this process only:
    its CUDA context itself is not counted); zeros before CUDA is
    initialized."""
    import torch

    if not torch.cuda.is_initialized():
        return {"allocated": 0, "reserved": 0, "peak_allocated": 0}
    return {"allocated": int(torch.cuda.memory_allocated(device)),
            "reserved": int(torch.cuda.memory_reserved(device)),
            "peak_allocated": int(torch.cuda.max_memory_allocated(device))}


class Request:
    """One accepted TOA request (in-memory view; the tenant ledger is
    the durable record)."""

    __slots__ = ("id", "tenant", "path", "key", "config", "bucket",
                 "nsub", "nchan", "nbin", "state", "reason", "attempts",
                 "n_toas", "toa_lines", "quality", "t_submit", "t_done",
                 "done_evt", "recorder", "recovered", "batch_id",
                 "trace_id", "parent_span_id", "span_id", "ticket",
                 "priority", "deadline_s", "fit_s", "fit_peak_bytes",
                 "bytes_in")

    def __init__(self, req_id, tenant, path, key, config,
                 priority=0, deadline_s=None):
        self.id = req_id
        self.tenant = tenant
        self.path = path
        self.key = key
        self.config = config or {}
        self.bucket = None
        self.nsub = self.nchan = self.nbin = 0
        self.state = PENDING
        self.reason = None
        self.attempts = 0
        self.n_toas = 0
        self.toa_lines = None
        # fit-quality fingerprint of the request's archive
        # (obs/quality.py gt_fingerprint, stamped before checkin)
        self.quality = None
        # usage accounting (obs/usage.py): fit-phase device seconds
        # accumulate across attempts, peak fit footprint and decoded
        # archive bytes bill at finalize
        self.fit_s = 0.0
        self.fit_peak_bytes = 0
        self.bytes_in = 0
        # deadline class (docs/SERVICE.md): higher priority seeds
        # cycles first; ``deadline_s`` is a completion budget from
        # submit time — the dispatcher never parks the request past
        # PARK_FRACTION of it (None = no deadline, window semantics)
        self.priority = int(priority or 0)
        self.deadline_s = None if deadline_s is None \
            else max(0.0, float(deadline_s))
        self.t_submit = time.time()
        self.t_done = None
        self.done_evt = threading.Event()
        self.recorder = None
        self.recovered = False
        self.batch_id = None
        # decode-at-intake hand-off (runner/prefetch.py): the ticket
        # whose buffer the fit worker consumes via gt.preload
        self.ticket = None
        # causal identity (obs/tracing.py): the trace this request
        # belongs to (client-minted via the traceparent carrier, or
        # daemon-minted), the client span it parents on, and the id of
        # the daemon-side request span every lifecycle child references
        self.trace_id = None
        self.parent_span_id = None
        self.span_id = tracing.new_span_id()

    def ctx(self):
        """(trace_id, request_span_id): the context lifecycle children
        parent on."""
        return (self.trace_id, self.span_id)

    def park_cutoff(self):
        """Absolute time by which this request must leave the parking
        window (half its deadline budget spent), or None when it has
        no deadline."""
        if self.deadline_s is None:
            return None
        return self.t_submit + PARK_FRACTION * self.deadline_s

    def deadline_at(self):
        """Absolute completion deadline, or None."""
        if self.deadline_s is None:
            return None
        return self.t_submit + self.deadline_s

    def payload(self, cached=False):
        out = {"ok": True, "request_id": self.id, "tenant": self.tenant,
               "archive": self.path, "state": self.state,
               "attempts": self.attempts}
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.bucket:
            out["bucket"] = "%dx%d" % self.bucket
        if self.priority:
            out["priority"] = self.priority
        if self.deadline_s is not None:
            out["deadline_s"] = self.deadline_s
            if self.t_done is not None:
                out["deadline_miss"] = \
                    (self.t_done - self.t_submit) > self.deadline_s
        if self.reason:
            out["reason"] = self.reason
        if self.state == DONE:
            out["n_toas"] = self.n_toas
            if self.quality is not None:
                out["quality"] = self.quality
            if self.toa_lines is not None:
                out["toa_lines"] = self.toa_lines
        if self.t_done is not None:
            out["wall_s"] = round(self.t_done - self.t_submit, 6)
        if cached:
            out["cached"] = True
        return out


class _Tenant:
    """Per-tenant intake: ledger queue, checkpoint, open-request FIFO."""

    def __init__(self, name, root, max_attempts, backoff_s):
        self.name = name
        self.dir = os.path.join(root, name)
        os.makedirs(self.dir, exist_ok=True)
        self.queue = WorkQueue(os.path.join(self.dir, "ledger.0.jsonl"),
                               max_attempts=max_attempts,
                               backoff_s=backoff_s)
        self.checkpoint = os.path.join(self.dir, "toas.tim")
        self.fifo = []        # open request ids, submit order
        self.inflight = 0     # requests in the current cycle
        self.n_submitted = 0
        self.n_completed = 0
        self.n_rejected = 0


class _Bucket:
    """Warm per-bucket state: the micro-batcher + a fitter pool."""

    def __init__(self, key, modelfile, window_s, device):
        self.key = tuple(key)
        self.batcher = MicroBatcher(bucket=self.key, window_s=window_s)
        self.modelfile = modelfile
        self.device = device
        self._pool = []
        self._lock = threading.Lock()
        self.n_requests = 0

    def checkout(self):
        with self._lock:
            if self._pool:
                return self._pool.pop()
        return _BucketedGetTOAs([], self.modelfile, self.key, quiet=True,
                                device=self.device)

    def checkin(self, gt):
        from ..pipelines.toas import GetTOAs

        for attr in GetTOAs.RESULT_ATTRS:
            setattr(gt, attr, [])
        gt.TOA_list = []
        gt.failed_datafiles = []
        gt.poisoned_datafiles = []
        gt.fit_batch = None
        if hasattr(gt, "_data_cache"):
            gt._data_cache = {}
        with self._lock:
            self._pool.append(gt)


class _Info:
    """Duck-typed ArchiveInfo for runner/execute._fit_one."""

    __slots__ = ("path",)

    def __init__(self, path):
        self.path = path


class TOAService:
    """The resident fitting daemon (module docstring).

    In-process API (the socket server in service/server.py is a thin
    shell over it): :meth:`start`, :meth:`warm`, :meth:`submit`,
    :meth:`wait`, :meth:`status`, :meth:`request_drain`,
    :meth:`shutdown`.  ``device`` is where every request is fitted
    (None = the CUDA device; raises without one unless ``"cpu"``).
    """

    def __init__(self, modelfile, workdir, plan=None, narrowband=False,
                 batch_window_s=0.25, batch_max=8, solo_window_s=0.1,
                 tenant_max_inflight=4, tenant_max_queue=64,
                 max_attempts=3, backoff_s=0.0, run_dirs_max=None,
                 run_bytes_max=None, mem_budget_bytes=None,
                 quotas=None, return_toa_lines=True, get_toas_kw=None,
                 prefetch=2, quiet=True, device=None):
        # no CUDA device and no explicit "cpu": fail here, not per
        # request
        self.device = resolve_device(device)
        self.modelfile = modelfile
        self.workdir = workdir
        if isinstance(plan, str):
            plan = SurveyPlan.load(plan)
        self.plan = plan
        self.narrowband = bool(narrowband)
        self.batch_window_s = float(batch_window_s)
        self.batch_max = max(1, int(batch_max))
        # adaptive-window floor: a cycle with no other joinable
        # candidate dispatches after this grace instead of the full
        # window — the window only ever buys coalescing, never pure
        # latency (the solo-late-arriver fix, docs/SERVICE.md)
        self.solo_window_s = min(float(solo_window_s),
                                 self.batch_window_s)
        self.tenant_max_inflight = max(1, int(tenant_max_inflight))
        self.tenant_max_queue = max(1, int(tenant_max_queue))
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.run_dirs_max = _env_int("PPTPU_SERVE_MAX_RUNS", 256) \
            if run_dirs_max is None else int(run_dirs_max)
        self.run_bytes_max = _env_int("PPTPU_SERVE_MAX_RUN_BYTES", 0) \
            if run_bytes_max is None else int(run_bytes_max)
        # memory-aware admission: a request whose analytical footprint
        # estimate (runner/plan.estimate_archive_bytes) exceeds this
        # device budget is rejected at intake (0 = disabled)
        self.mem_budget_bytes = _env_int("PPTPU_SERVE_MEM_BUDGET", 0) \
            if mem_budget_bytes is None else int(mem_budget_bytes)
        # per-tenant usage quotas (obs/usage.py): admission checks the
        # metered totals against these budgets; {} = unlimited.  A
        # malformed explicit spec raises at construction (a quota typo
        # must not silently admit forever); the env fallback is lax.
        self.quotas = usage.quotas_from_env() if quotas is None \
            else usage.parse_quotas(quotas)
        self.return_toa_lines = bool(return_toa_lines)
        self.get_toas_kw = dict(get_toas_kw or {})
        # decode-at-intake (docs/SERVICE.md): up to ``prefetch``
        # admitted requests have their FITS decode + bucket pad run on
        # the host-prefetch pool during the micro-batch window instead
        # of inside ``fit``, off the warmed critical path.  0 disables
        # (decode runs inline in the fit worker, the pre-prefetch
        # behavior).
        self.prefetch = max(0, int(prefetch))
        self._prefetcher = None
        self.quiet = quiet

        os.makedirs(workdir, exist_ok=True)
        self._tenant_root = os.path.join(workdir, "tenants")
        self._req_obs_dir = os.path.join(workdir, "obs_requests")
        os.makedirs(self._tenant_root, exist_ok=True)
        os.makedirs(self._req_obs_dir, exist_ok=True)

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tenants = {}
        self._requests = {}       # open requests by id
        self._done_requests = {}  # terminal requests, bounded FIFO
        self._done_order = []
        self._done_keep = 4096
        self._buckets = {}
        self._draining = False
        # recent submit timestamps: the arrival-rate signal the
        # adaptive parking window stretches on (bounded, lock-held)
        self._recent_submits = collections.deque(maxlen=64)
        self._stopped = threading.Event()
        self._drained = threading.Event()
        self._thread = None
        self._obs_stack = contextlib.ExitStack()
        self._batch_seq = itertools.count(1)
        self.t_start = None
        self.warm_summary = None

    # -- lifecycle ------------------------------------------------------

    def start(self):
        """Open the daemon obs run, recover accepted-but-unfinished
        requests from the tenant ledgers, start the dispatcher."""
        if self._thread is not None:
            raise RuntimeError("TOAService already started")
        self.t_start = time.time()
        self._obs_stack.enter_context(obs.run(
            "ppserve", base_dir=os.path.join(self.workdir, "obs"),
            config={"modelfile": self.modelfile,
                    "narrowband": self.narrowband,
                    "batch_window_s": self.batch_window_s,
                    "solo_window_s": self.solo_window_s,
                    "batch_max": self.batch_max,
                    "tenant_max_inflight": self.tenant_max_inflight,
                    "tenant_max_queue": self.tenant_max_queue,
                    "max_attempts": self.max_attempts,
                    "run_dirs_max": self.run_dirs_max,
                    "run_bytes_max": self.run_bytes_max,
                    "mem_budget_bytes": self.mem_budget_bytes,
                    "quotas": self.quotas or None,
                    "prefetch": self.prefetch,
                    "device": str(self.device)}))
        if self.quotas:
            # install the budgets on the usage plane: metering keeps
            # the pps_quota_burn gauge live for the quota_burn rule
            usage.configure_quotas(self.quotas)
        if self.mem_budget_bytes:
            # the memory_watermark health rule prices device usage
            # against this budget gauge (obs/health.py)
            metrics.set_gauge("pps_mem_budget_bytes",
                              self.mem_budget_bytes)
        # prime the alert-rule engine so the exporter evaluates on
        # every snapshot tick from the first one
        obs_health.evaluate()
        if self.prefetch:
            # before recovery: recovered requests prefetch like fresh
            # ones, so a restarted daemon's first cycle is warm too
            self._prefetcher = HostPrefetcher(depth=self.prefetch,
                                              name="ppserve-prefetch")
        self._recover_tenants()
        self._thread = threading.Thread(target=self._dispatcher,
                                        name="ppserve-dispatcher",
                                        daemon=True)
        self._thread.start()
        obs.event("service_started", workdir=self.workdir,
                  n_tenants=len(self._tenants))
        return self

    def warm(self, coalesce=None, aot=True):
        """Warm every program the startup plan enumerates on the
        daemon's device (service/warm.py: the kernels built, each
        planned shape and coalesced batch fitted once); stores +
        returns the summary.  ``aot`` builds every kernel source up
        front (runner/warm.py)."""
        from .warm import warm_plan

        if self.plan is None:
            return None
        if coalesce is None:
            # every cycle size a full-rate tenant mix can produce: the
            # batch-glue programs key on the raw combined batch, so
            # K=2..batch_max each warm their own total (warm.py)
            coalesce = tuple(range(2, self.batch_max + 1))
        self.warm_summary = warm_plan(
            self.plan, self.modelfile, get_toas_kw=self.get_toas_kw,
            coalesce=coalesce, aot=aot, narrowband=self.narrowband,
            quiet=self.quiet, device=self.device)
        rec = obs.current()
        if rec is not None:
            # the warm-path proof marker: every kernel built so far
            # was built before the first request
            obs.gauge("warm_backend_compiles",
                      int(rec.counters.get("backend_compiles", 0)))
        # build-directory misses after this point are a warm-path
        # leak: arm the compile_cache_postwarm health rule's guard
        metrics.set_gauge("pps_warm_complete", 1)
        return self.warm_summary

    def request_drain(self):
        """Stop accepting; finish everything accepted; then stop."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._cond.notify_all()
        obs.event("service_drain")
        obs.counter("service_drains")
        metrics.set_gauge("pps_draining", 1)

    def drained(self, timeout=None):
        """Block until a drain completed; True when it has."""
        return self._drained.wait(timeout)

    def shutdown(self, timeout=60.0):
        """Drain and stop the dispatcher; close obs state.  Returns
        True when the drain completed in time."""
        if self._thread is None:
            self._drained.set()
        self.request_drain()
        ok = self._drained.wait(timeout)
        self._stopped.set()
        with self._lock:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None
        with self._lock:
            tenants = list(self._tenants.values())
            requests = list(self._requests.values())
        for rq in requests:
            self._close_request_recorder(rq)
        for t in tenants:
            t.queue.close()
        obs.event("service_stopped", drained=bool(ok))
        self._obs_stack.close()
        return ok

    # -- intake ---------------------------------------------------------

    def _tenant(self, name):
        """Get-or-create a tenant (caller holds the lock)."""
        t = self._tenants.get(name)
        if t is None:
            t = _Tenant(name, self._tenant_root, self.max_attempts,
                        self.backoff_s)
            self._tenants[name] = t
        return t

    def _recover_tenants(self):
        """Re-enqueue ledger entries a previous daemon accepted but
        never finished (crash/drain leftovers): the accepted-work
        contract survives restarts."""
        if not os.path.isdir(self._tenant_root):
            return
        recovered = []
        for name in sorted(os.listdir(self._tenant_root)):
            if not _TENANT_RE.match(name) or not os.path.isfile(
                    os.path.join(self._tenant_root, name,
                                 "ledger.0.jsonl")):
                continue
            with self._lock:
                t = self._tenant(name)
                for key in t.queue.outstanding():
                    rq = self._new_request(t, key, key, {},
                                           recovered=True)
                    recovered.append(rq)
        for rq in recovered:
            # header scan outside the lock (file IO); unreadable
            # leftovers quarantine exactly like a fresh submission's
            if self._classify(rq):
                self._maybe_prefetch(rq)
                self._emit_request(rq, "recovered")

    def _maybe_prefetch(self, rq):
        """Decode-at-intake: hand a freshly admitted request's FITS
        decode + bucket pad to the prefetch pool so it overlaps the
        micro-batch window instead of extending ``fit``.  Best-effort —
        past ``depth`` live tickets :meth:`~HostPrefetcher.try_submit`
        refuses and the request simply decodes inline at fit time, the
        pre-prefetch behavior."""
        pf = self._prefetcher
        if pf is None or rq.bucket is None or rq.ticket is not None \
                or rq.t_done is not None:
            return
        kw = dict(self.get_toas_kw)
        kw.update(rq.config or {})
        rq.ticket = pf.try_submit(
            rq.path,
            functools.partial(load_bucketed_databunch, rq.path,
                              tuple(rq.bucket),
                              tscrunch=bool(kw.get("tscrunch", False)),
                              quiet=self.quiet, device=self.device),
            est_bytes=estimate_archive_bytes(rq.nchan, rq.nbin,
                                             nsub=rq.nsub),
            ctx=rq.ctx())

    def _new_request(self, tenant, path, key, config, recovered=False,
                     traceparent=None, priority=0, deadline_s=None):
        """Register an open request (caller holds the lock)."""
        rq = Request("r%06d" % next(_REQ_SEQ), tenant.name, path, key,
                     config, priority=priority, deadline_s=deadline_s)
        rq.recovered = recovered
        self._recent_submits.append(rq.t_submit)
        # join the client's trace (traceparent carrier) or mint a new
        # one: every accepted request is traceable, client-aware or not
        ctx = tracing.parse_traceparent(traceparent)
        if ctx is not None:
            rq.trace_id, rq.parent_span_id = ctx
        else:
            rq.trace_id = tracing.new_trace_id()
        self._requests[rq.id] = rq
        tenant.fifo.append(rq.id)
        tenant.n_submitted += 1
        metrics.inc("pps_requests_total", tenant=tenant.name,
                    outcome="accepted")
        metrics.set_gauge("pps_queue_depth", len(tenant.fifo),
                          tenant=tenant.name)
        metrics.set_gauge("pps_open_requests", len(self._requests))
        self._open_request_recorder(rq)
        self._cond.notify_all()
        return rq

    def submit(self, tenant, archive, config=None, wait=False,
               timeout=None, traceparent=None, priority=0,
               deadline_s=None):
        """Accept one TOA request; returns the response payload.

        ``priority`` (int, higher = more urgent) orders cycle seeding;
        ``deadline_s`` is a completion budget from submit time: the
        dispatcher never parks the request past ``PARK_FRACTION`` of
        it, and a terminal result past it counts a deadline miss
        (``pps_deadline_total``).

        Replays: an archive this tenant's ledger already records as
        done/quarantined responds with the recorded outcome instead of
        refitting (the checkpoint holds its TOA block).  Rejections
        (``ok: False``): bad tenant name, unreadable archive header
        recorded as an immediate quarantine, ``backpressure`` beyond
        the tenant's open-request budget, ``draining`` after a drain
        began.

        ``traceparent`` (W3C carrier string, obs/tracing.py) threads
        the caller's trace through the whole request lifecycle; without
        one the daemon mints a trace of its own.  Replays echo the
        recorded outcome's trace id so a duplicate submission is
        causally linked to the fit that actually served it.
        """
        if not _TENANT_RE.match(str(tenant or "")):
            return {"ok": False, "error": "bad_tenant",
                    "detail": "tenant must match %s" % _TENANT_RE.pattern}
        path = str(archive)
        key = WorkQueue.key_for(path)
        with self._lock:
            if self._draining:
                metrics.inc("pps_requests_total", tenant=tenant,
                            outcome="rejected_draining")
                return {"ok": False, "error": "draining"}
            t = self._tenant(tenant)
            state = t.queue.state(key)
            if state in (DONE, QUARANTINED):
                rec = t.queue.record(key) or {}
                obs.counter("service_replays")
                metrics.inc("pps_requests_total", tenant=tenant,
                            outcome="replayed")
                obs.event("service_replay", tenant=tenant,
                          archive=path, state=state,
                          trace_id=rec.get("trace"),
                          replay_traceparent=traceparent)
                return {"ok": True, "request_id": None, "cached": True,
                        "tenant": tenant, "archive": path,
                        "state": state,
                        "n_toas": rec.get("n_toas"),
                        "trace_id": rec.get("trace"),
                        "reason": rec.get("reason")}
            for rid in t.fifo:
                rq = self._requests[rid]
                if rq.key == key:  # already accepted: attach to it
                    break
            else:
                rq = None
            if rq is None:
                if len(t.fifo) >= self.tenant_max_queue:
                    t.n_rejected += 1
                    obs.event("service_backpressure", tenant=tenant,
                              archive=path, open=len(t.fifo))
                    obs.counter("service_backpressure_rejections")
                    metrics.inc("pps_requests_total", tenant=tenant,
                                outcome="rejected_backpressure")
                    metrics.inc("pps_backpressure_total",
                                tenant=tenant)
                    return {"ok": False, "error": "backpressure",
                            "tenant": tenant, "open": len(t.fifo)}
                rq = self._new_request(t, path, key, config,
                                       traceparent=traceparent,
                                       priority=priority,
                                       deadline_s=deadline_s)
                obs.counter("service_requests")
        if rq.bucket is None:
            if self._classify(rq):
                rejection = self._memory_admission(rq) \
                    or self._quota_admission(rq)
                if rejection is not None:
                    return rejection
                self._maybe_prefetch(rq)
            # else: header scan failed — quarantined at intake, like
            # the survey planner's unreadable-archive path
        self._emit_request(rq, "submitted")
        if wait:
            rq.done_evt.wait(timeout)
        return rq.payload()

    def _memory_admission(self, rq):
        """Memory-aware admission (docs/SERVICE.md): settle a freshly
        classified request at intake when its analytical footprint
        estimate exceeds the configured device budget — dispatching it
        would OOM deterministically, burning a device cycle and a
        retry budget to learn what the plan already knows.  Returns
        the ``rejected_memory`` payload, or None when admitted."""
        budget = self.mem_budget_bytes
        if budget <= 0 or rq.bucket is None:
            return None
        est = estimate_archive_bytes(rq.nchan, rq.nbin, nsub=rq.nsub)
        if est <= budget:
            return None
        reason = ("memory: estimated %d bytes exceeds device budget %d"
                  % (est, budget))
        with self._lock, tracing.activate(rq.ctx()):
            t = self._tenants[rq.tenant]
            t.queue.quarantine(rq.path, reason)
            self._finalize_locked(rq, QUARANTINED, reason)
        metrics.inc("pps_requests_total", tenant=rq.tenant,
                    outcome="rejected_memory")
        obs.event("service_memory_reject", tenant=rq.tenant,
                  archive=rq.path, request=rq.id, est_bytes=est,
                  budget_bytes=budget, bucket="%dx%d" % rq.bucket,
                  nsub=rq.nsub)
        obs.counter("service_memory_rejections")
        return {"ok": False, "error": "memory", "tenant": rq.tenant,
                "archive": rq.path, "request_id": rq.id,
                "est_bytes": est, "budget_bytes": budget}

    def _quota_admission(self, rq):
        """Quota admission (obs/usage.py): settle a freshly classified
        request at intake when its tenant has exhausted a configured
        budget against the locally metered usage.  Quarantine-at-
        submit, like the memory shed: the rejection lands in the
        tenant ledger, so a duplicate submit replays it without
        burning another admission — and without re-metering.  Returns
        the ``rejected_quota`` payload, or None when admitted."""
        if not self.quotas:
            return None
        breach = usage.check(rq.tenant, self.quotas)
        if breach is None:
            return None
        reason = ("quota: %s used %s of limit %s"
                  % (breach["quota"], breach["used"], breach["limit"]))
        with self._lock, tracing.activate(rq.ctx()):
            t = self._tenants[rq.tenant]
            t.queue.quarantine(rq.path, reason)
            self._finalize_locked(rq, QUARANTINED, reason)
        metrics.inc("pps_requests_total", tenant=rq.tenant,
                    outcome="rejected_quota")
        metrics.inc("pps_shed_total", reason="quota")
        obs.event("service_quota_reject", tenant=rq.tenant,
                  archive=rq.path, request=rq.id, **breach)
        obs.counter("service_quota_rejections")
        return {"ok": False, "error": "quota", "tenant": rq.tenant,
                "archive": rq.path, "request_id": rq.id, **breach}

    def _classify(self, rq):
        """Header-scan the archive into its shape bucket; quarantine on
        failure.  Returns True when the request is fittable."""
        if rq.bucket is not None or rq.t_done is not None:
            return rq.bucket is not None
        try:
            info = scan_archive_header(rq.path)
        except (OSError, ValueError, KeyError,
                faults.InjectedFault) as e:
            with self._lock, tracing.activate(rq.ctx()):
                t = self._tenants[rq.tenant]
                if t.queue.state(rq.key) is None:
                    t.queue.add([rq.path])
                t.queue.quarantine(rq.path,
                                   "unreadable at intake: %s" % e)
                self._finalize_locked(rq, QUARANTINED,
                                      "unreadable at intake: %s" % e)
            return False
        with self._lock, tracing.activate(rq.ctx()):
            rq.nsub, rq.nchan, rq.nbin = info.nsub, info.nchan, info.nbin
            rq.bucket = canonical_shape(info.nchan, info.nbin)
            try:
                # the bytes-decoded usage measure (obs/usage.py): the
                # archive the fit will decode, billed at finalize
                rq.bytes_in = os.path.getsize(rq.path)
            except OSError:
                rq.bytes_in = 0
            t = self._tenants[rq.tenant]
            if t.queue.state(rq.key) is None:
                t.queue.add([rq.path])
            self._cond.notify_all()
        return True

    def wait(self, request_id, timeout=None):
        with self._lock:
            rq = self._requests.get(request_id) \
                or self._done_requests.get(request_id)
        if rq is None:
            return {"ok": False, "error": "unknown_request",
                    "request_id": request_id}
        rq.done_evt.wait(timeout)
        return rq.payload()

    # -- scheduling -----------------------------------------------------

    def _ready_locked(self, rq, now):
        if rq.state != PENDING or rq.bucket is None:
            return False
        t = self._tenants[rq.tenant]
        rec = t.queue.record(rq.key)
        if rec is None:
            return False
        if rec["state"] == FAILED:
            return now >= rec.get("retry_at", 0.0)
        return rec["state"] not in (DONE, QUARANTINED)

    @staticmethod
    def _seed_key(rq):
        """Cycle-seeding order: highest priority class first; within
        a class the nearest park cutoff (deadline-bearing requests),
        then oldest.  Deadline-free requests sort by age alone, the
        pre-deadline behavior."""
        cut = rq.park_cutoff()
        return (-rq.priority,
                cut if cut is not None else float("inf"),
                rq.t_submit)

    def _joinable_locked(self, batch, seed):
        """Could waiting grow this cycle?  True when any other open
        request might still land in the seed's bucket (unclassified
        requests count: their bucket is not known yet)."""
        members = {rq.id for rq in batch}
        for rq in self._requests.values():
            if rq.id in members or rq.state != PENDING:
                continue
            if rq.bucket is not None and rq.bucket != seed.bucket:
                continue
            return True
        return False

    def _fire_at_locked(self, batch, seed, now):
        """Absolute dispatch time for the assembled cycle — the
        adaptive parking window (docs/SERVICE.md "Deadline
        semantics"):

        * base window anchored at the seed's submit time;
        * stretched up to ``WINDOW_STRETCH_MAX``× by the recent
          arrival rate (denser batches under load);
        * collapsed to ``solo_window_s`` when nothing else can join
          (a solo late arriver never pays the full window);
        * clamped to the earliest member's park cutoff — a request is
          never parked past ``PARK_FRACTION`` of its deadline.
        """
        window = self.batch_window_s
        if window > 0:
            if len(batch) == 1 and not self._joinable_locked(batch,
                                                             seed):
                window = self.solo_window_s
            else:
                cutoff = now - _LOAD_WINDOW_S
                arrivals = sum(1 for t in self._recent_submits
                               if t >= cutoff)
                stretch = min(WINDOW_STRETCH_MAX,
                              1.0 + arrivals / float(self.batch_max))
                window *= stretch
        t_fire = seed.t_submit + window
        for rq in batch:
            cut = rq.park_cutoff()
            if cut is not None:
                t_fire = min(t_fire, cut)
        return t_fire

    def _collect_batch(self):
        """Assemble the next micro-batch: seed by priority class /
        park cutoff / age (:meth:`_seed_key`), fill with same-bucket
        ready requests (seed order, per-tenant inflight cap), and hold
        the cycle open until the adaptive window expires
        (:meth:`_fire_at_locked`) or the batch is full."""
        with self._lock:
            while True:
                if self._stopped.is_set():
                    return None
                now = time.time()
                ready = [rq for rid, rq in self._requests.items()
                         if self._ready_locked(rq, now)]
                if not ready:
                    if self._draining and not self._requests:
                        return None
                    # wake for the earliest backoff expiry, a new
                    # submission, or a drain
                    self._cond.wait(timeout=0.1)
                    continue
                seed = min(ready, key=self._seed_key)
                batch = self._fill_batch_locked(ready, seed)
                t_fire = self._fire_at_locked(batch, seed, now)
                if len(batch) >= self.batch_max or now >= t_fire:
                    for rq in batch:
                        rq.state = DISPATCHING
                        self._tenants[rq.tenant].inflight += 1
                    for name in {rq.tenant for rq in batch}:
                        metrics.set_gauge(
                            "pps_inflight",
                            self._tenants[name].inflight, tenant=name)
                    return batch
                self._cond.wait(timeout=max(0.01, t_fire - now))

    def _fill_batch_locked(self, ready, seed):
        per_tenant = {}
        batch = []
        for rq in sorted(ready, key=self._seed_key):
            if rq.bucket != seed.bucket:
                continue
            n = per_tenant.get(rq.tenant, 0)
            if n >= self.tenant_max_inflight:
                continue
            per_tenant[rq.tenant] = n + 1
            batch.append(rq)
            if len(batch) >= self.batch_max:
                break
        return batch

    def _dispatcher(self):
        try:
            while True:
                batch = self._collect_batch()
                if batch is None:
                    break
                self._dispatch(batch)
        finally:
            self._drained.set()
            with self._lock:
                self._cond.notify_all()

    def _dispatch(self, batch):
        batch_id = "b%05d" % next(self._batch_seq)
        bucket = self._bucket(batch[0].bucket)
        bucket.n_requests += len(batch)
        n_disp0 = bucket.batcher.n_dispatches
        with self._lock:
            for rq in batch:
                rq.batch_id = batch_id
                t = self._tenants[rq.tenant]
                with tracing.activate(rq.ctx()):
                    # the ambient context stamps the ledger's running
                    # record with the trace id (runner/queue.py)
                    claim = t.queue.claim(rq.path)
                rq.attempts = claim.get("attempts", 0)
        now = time.time()
        for rq in batch:
            # queue-wait: submission (or last retry release) to the
            # cycle that finally claimed the request
            wait_s = max(0.0, now - rq.t_submit)
            metrics.observe(PHASE_HISTOGRAM, wait_s,
                            phase="queue_wait", tenant=rq.tenant,
                            bucket=_blabel(rq.bucket),
                            exemplar=rq.trace_id)
            tracing.emit_span("queue_wait", wait_s, ctx=rq.ctx(),
                              request=rq.id, batch=batch_id)
            self._emit_request(rq, "dispatching")
        # deadline hint: a stalled cycle sibling cannot hold the
        # barrier past the most urgent member's completion deadline
        deadlines = [rq.deadline_at() for rq in batch]
        deadlines = [d for d in deadlines if d is not None]
        bucket.batcher.begin(len(batch),
                             deadline=min(deadlines) if deadlines
                             else None)
        workers = []
        for rq in batch:
            w = threading.Thread(target=self._run_one,
                                 args=(rq, bucket),
                                 name="ppserve-fit-%s" % rq.id,
                                 daemon=True)
            workers.append(w)
            w.start()
        for w in workers:
            w.join()
        obs.event("service_batch", batch=batch_id,
                  bucket="%dx%d" % bucket.key, n_requests=len(batch),
                  tenants=sorted({rq.tenant for rq in batch}),
                  dispatches=bucket.batcher.n_dispatches - n_disp0)

    def _bucket(self, key):
        with self._lock:
            b = self._buckets.get(tuple(key))
            if b is None:
                b = _Bucket(key, self.modelfile, self.batch_window_s,
                            self.device)
                self._buckets[tuple(key)] = b
            return b

    def _run_one(self, rq, bucket):
        # the worker thread adopts the request's trace context: every
        # span/event/metric below — including the GetTOAs phase spans
        # and the batcher's park/dispatch — is causally stamped
        with tracing.activate(rq.ctx()):
            self._run_one_traced(rq, bucket)

    def _run_one_traced(self, rq, bucket):
        t = self._tenants[rq.tenant]
        blabel = _blabel(bucket.key)
        t0 = time.perf_counter()
        gt = bucket.checkout()
        checkout_s = time.perf_counter() - t0
        metrics.observe(PHASE_HISTOGRAM, checkout_s,
                        phase="checkout", bucket=blabel)
        tracing.emit_span("checkout", checkout_s, request=rq.id)
        gt.fit_batch = bucket.batcher.fit
        if rq.ticket is not None and self._prefetcher is not None:
            # decode-at-intake hand-off: the fit's own _load_archive
            # call site replays the prefetched outcome (data or fault)
            # exactly as if it had loaded inline.  A retry after a
            # consumed faulty ticket decodes inline, same as serial.
            ticket, rq.ticket = rq.ticket, None
            gt.preload(rq.path, self._prefetcher.consume(ticket))
        kw = dict(self.get_toas_kw)
        kw.update(rq.config or {})
        flags = dict(kw.get("addtnl_toa_flags") or {})
        flags.setdefault("pp_tenant", rq.tenant)
        kw["addtnl_toa_flags"] = flags
        padded = (rq.nchan, rq.nbin) != tuple(bucket.key)
        state = None
        # usage accounting (obs/usage.py): the fit phase is the
        # device-seconds measure; its peak footprint rides the memory
        # plane's watermark bracket.  Accumulated across attempts —
        # a retried request burned every attempt's device time.
        rec = obs.current()
        mem = rec.memory_state() if rec is not None else None
        mtok = mem.mark() if mem is not None else None
        tfit = time.perf_counter()
        try:
            with metrics.timed(PHASE_HISTOGRAM, phase="fit",
                               tenant=rq.tenant, bucket=blabel), \
                    obs.span("fit", request=rq.id, tenant=rq.tenant,
                             bucket=blabel), \
                    quality.context(bucket=blabel, tenant=rq.tenant):
                state = _fit_one(gt, t.queue, _Info(rq.path),
                                 t.checkpoint, padded, kw, self.quiet,
                                 narrowband=self.narrowband)
        except Exception as e:  # noqa: BLE001 — total per-request guard
            reason = "%s: %s" % (type(e).__name__, e)
            if memory.is_oom(e):
                # _fit_one classifies OOMs it sees itself; this covers
                # allocator exhaustion escaping around it (checkout
                # machinery, batch glue) — same quarantine-not-retry
                memory.record_oom("service_fit", e, request=rq.id,
                                  tenant=rq.tenant, archive=rq.path)
                rec = t.queue.quarantine(rq.path,
                                         "oom: %s" % reason[:400])
            else:
                rec = t.queue.fail(rq.path, reason)
            state = rec["state"]
        finally:
            rq.fit_s += time.perf_counter() - tfit
            if mem is not None and mtok is not None:
                pk = mem.peak(mtok)
                if pk:
                    rq.fit_peak_bytes = max(rq.fit_peak_bytes, pk)
            bucket.batcher.worker_done()
            n_toas = len(gt.TOA_list)
            lines = [format_toa_line(toa) for toa in gt.TOA_list] \
                if self.return_toa_lines else None
            # fingerprint BEFORE checkin: checkin resets the pooled
            # instance's result arrays for the next request
            rq.quality = quality.gt_fingerprint(gt)
            bucket.checkin(gt)
        self._settle(rq, state, n_toas, lines)

    def _settle(self, rq, state, n_toas, toa_lines):
        with self._lock:
            t = self._tenants[rq.tenant]
            t.inflight = max(0, t.inflight - 1)
            metrics.set_gauge("pps_inflight", t.inflight,
                              tenant=rq.tenant)
            rec = t.queue.record(rq.key) or {}
            state = rec.get("state", state)
            rq.attempts = rec.get("attempts", rq.attempts)
            if state in (DONE, QUARANTINED):
                if state == DONE:
                    rq.n_toas = n_toas
                    rq.toa_lines = toa_lines
                self._finalize_locked(rq, state, rec.get("reason"))
            else:
                rq.state = PENDING  # failed: backoff, then retried
                rq.reason = rec.get("reason")
                obs.counter("service_retries")
                metrics.inc("pps_retries_total", tenant=rq.tenant)
                self._emit_request(rq, "retrying")
            self._cond.notify_all()

    def _finalize_locked(self, rq, state, reason):
        if rq.t_done is not None:
            return  # already finalized (racing duplicate settle)
        if rq.ticket is not None and self._prefetcher is not None:
            # settled without the fit consuming its buffer (e.g. a
            # quarantine racing ahead of dispatch): drop it — no
            # ledger transition, the settle already wrote the record
            ticket, rq.ticket = rq.ticket, None
            self._prefetcher.discard(ticket, "settled_before_fit")
        rq.state = state
        rq.reason = reason
        rq.t_done = time.time()
        t = self._tenants[rq.tenant]
        if rq.id in t.fifo:
            t.fifo.remove(rq.id)
        t.n_completed += 1
        self._requests.pop(rq.id, None)
        # keep the terminal view queryable (wait/replay) under a
        # bounded budget — a resident process must not grow this map
        self._done_requests[rq.id] = rq
        self._done_order.append(rq.id)
        while len(self._done_order) > self._done_keep:
            self._done_requests.pop(self._done_order.pop(0), None)
        obs.counter("service_done" if state == DONE
                    else "service_quarantined")
        metrics.inc("pps_requests_total", tenant=rq.tenant,
                    outcome=state)
        total_s = max(0.0, rq.t_done - rq.t_submit)
        metrics.observe(PHASE_HISTOGRAM, total_s,
                        phase="total", tenant=rq.tenant,
                        bucket=_blabel(rq.bucket),
                        priority=str(rq.priority),
                        exemplar=rq.trace_id)
        if rq.deadline_s is not None:
            missed = total_s > rq.deadline_s
            metrics.inc("pps_deadline_total", tenant=rq.tenant,
                        outcome="miss" if missed else "met")
            if missed:
                obs.event("service_deadline_miss", request=rq.id,
                          tenant=rq.tenant, archive=rq.path,
                          deadline_s=rq.deadline_s,
                          wall_s=round(total_s, 6),
                          priority=rq.priority, state=state)
        # the daemon-side request span: the root every lifecycle child
        # (queue_wait/checkout/fit/...) parents on, itself a child of
        # the client's submit span when a traceparent arrived
        tracing.emit_span("request", total_s,
                          ctx=(rq.trace_id, rq.parent_span_id),
                          span_id=rq.span_id, request=rq.id,
                          tenant=rq.tenant, archive=rq.path,
                          state=state, batch=rq.batch_id,
                          attempts=rq.attempts)
        metrics.set_gauge("pps_queue_depth", len(t.fifo),
                          tenant=rq.tenant)
        metrics.set_gauge("pps_open_requests", len(self._requests))
        # bill the request exactly once, at the terminal transition:
        # a duplicate submit replays from the ledger and never gets
        # here again (obs/usage.py exactly-once accounting).  Metered
        # before the per-request recorder closes, and before waiters
        # wake — a quota check racing this finalize sees the bill.
        usage.meter("request", tenant=rq.tenant,
                    bucket=_blabel(rq.bucket), wall_s=total_s,
                    device_s=rq.fit_s, peak_bytes=rq.fit_peak_bytes,
                    archives=1 if state == DONE else 0,
                    bytes_decoded=rq.bytes_in, request=rq.id,
                    state=state, attempts=rq.attempts)
        self._emit_request(rq, "terminal")
        if state != DONE:
            # quarantine forensics: the terminal service_request event
            # above is already in the flight ring when the bundle is
            # cut, and the quarantine_spike health rule sees the inc
            metrics.inc("pps_quarantined_total", tenant=rq.tenant)
            flight.dump("quarantine", request=rq.id, tenant=rq.tenant,
                        archive=rq.path, reason=str(reason)[:200])
        self._close_request_recorder(rq)
        rq.done_evt.set()

    # -- per-request obs runs ------------------------------------------

    def _open_request_recorder(self, rq):
        try:
            rq.recorder = Recorder(
                "req-%s" % rq.id, self._req_obs_dir,
                config={"request": rq.id, "tenant": rq.tenant,
                        "archive": rq.path})
        except OSError:
            rq.recorder = None

    def _emit_request(self, rq, phase, **extra):
        fields = dict(request=rq.id, tenant=rq.tenant, archive=rq.path,
                      phase=phase, state=rq.state,
                      attempts=rq.attempts,
                      bucket=None if rq.bucket is None
                      else "%dx%d" % rq.bucket,
                      batch=rq.batch_id, reason=rq.reason,
                      trace_id=rq.trace_id, span_id=rq.span_id,
                      **extra)
        if rq.state == DONE:
            fields["n_toas"] = rq.n_toas
        if rq.t_done is not None:
            fields["wall_s"] = round(rq.t_done - rq.t_submit, 6)
        if phase == "terminal" and rq.quality is not None:
            fields["quality"] = rq.quality
        fields = {k: v for k, v in fields.items() if v is not None}
        obs.event("service_request", **fields)
        if rq.recorder is not None:
            rq.recorder.emit("event", name="service_request", **fields)

    def _close_request_recorder(self, rq):
        rec, rq.recorder = rq.recorder, None
        if rec is None:
            return
        rec.close()
        self._prune_request_runs()

    def _prune_request_runs(self):
        """Bound the retained per-request run dirs by count and bytes
        (oldest pruned first); open requests' runs are kept."""
        keep = {os.path.basename(rq.recorder.dir)
                for rq in self._requests.values()
                if rq.recorder is not None}
        try:
            names = os.listdir(self._req_obs_dir)
        except OSError:
            return
        entries = []
        total = 0
        for name in names:
            if name in keep:
                continue
            path = os.path.join(self._req_obs_dir, name)
            if not os.path.isdir(path):
                continue
            size = mtime = 0
            for root, _, files in os.walk(path):
                for f in files:
                    try:
                        st = os.stat(os.path.join(root, f))
                    except OSError:
                        continue
                    size += st.st_size
                    mtime = max(mtime, st.st_mtime)
            entries.append((mtime, path, size))
            total += size
        entries.sort()
        budget_dirs = self.run_dirs_max or 0
        budget_bytes = self.run_bytes_max or 0
        n_pruned = 0
        while entries and (
                (budget_dirs and len(entries) > budget_dirs)
                or (budget_bytes and total > budget_bytes)):
            _, path, size = entries.pop(0)
            shutil.rmtree(path, ignore_errors=True)
            total -= size
            n_pruned += 1
        if n_pruned:
            obs.counter("service_runs_pruned", n_pruned)

    # -- introspection --------------------------------------------------

    def metrics_snapshot(self):
        """Current streaming-metrics snapshot of the daemon's obs run
        (obs/metrics.py) — the ``metrics`` socket verb's payload; None
        when no run is active."""
        return metrics.snapshot()

    def status(self):
        with self._lock:
            tenants = {}
            for name, t in self._tenants.items():
                tenants[name] = {
                    "counts": t.queue.counts(),
                    "open": len(t.fifo), "inflight": t.inflight,
                    "submitted": t.n_submitted,
                    "completed": t.n_completed,
                    "rejected": t.n_rejected}
            buckets = {}
            for key, b in self._buckets.items():
                buckets["%dx%d" % key] = {
                    "requests": b.n_requests,
                    "dispatches": b.batcher.n_dispatches,
                    "coalesced": b.batcher.n_coalesced,
                    "fit_calls": b.batcher.n_calls,
                    "pool": len(b._pool)}
            out = {"ok": True,
                   "uptime_s": round(time.time() - (self.t_start
                                                    or time.time()), 3),
                   "draining": self._draining,
                   "open_requests": len(self._requests),
                   "tenants": tenants, "buckets": buckets,
                   "narrowband": self.narrowband,
                   "device": str(self.device),
                   "batch_window_s": self.batch_window_s,
                   "solo_window_s": self.solo_window_s,
                   "batch_max": self.batch_max}
        rec = obs.current()
        if rec is not None:
            out["counters"] = dict(rec.counters)
            out["obs_run"] = rec.dir
        if self.device.type == "cuda":
            out["device_memory"] = _device_memory(self.device)
        if self.warm_summary is not None:
            out["warm"] = {k: self.warm_summary[k]
                           for k in ("n_programs", "wall_s",
                                     "backend_compiles",
                                     "compile_cache_hits",
                                     "compile_cache_misses")}
        return out

    def health(self):
        """Liveness/readiness + firing alerts — the ``health`` socket
        verb (docs/SERVICE.md), the probe surface a fleet router or
        autoscaler consumes.  Liveness is the dispatcher thread;
        readiness is "accepting new work" (live and not draining).
        Runs a fresh rule pass (obs/health.py) so the answer reflects
        now, not the last exporter tick."""
        alerts = obs_health.evaluate()
        if alerts is None:
            alerts = []
        live = self._thread is not None and self._thread.is_alive()
        with self._lock:
            draining = self._draining
            open_requests = len(self._requests)
        out = {"ok": live,
               "live": live,
               "ready": live and not draining,
               "draining": draining,
               "open_requests": open_requests,
               "alerts_firing": len(alerts),
               "alerts": alerts}
        rec = obs.current()
        if rec is not None:
            out["alerts_fired"] = int(
                rec.counters.get("alerts_fired", 0))
            out["postmortems_written"] = int(
                rec.counters.get("postmortems_written", 0))
            out["obs_run"] = rec.dir
        return out
