"""Fleet front-end: bucket-routed serving across N ppserve daemons.

The PyTorch port of the JAX package's ``service/router.py``.  Spawned
daemons run the port's ``ppserve`` (``python -m
pulseportraiture_tpu_torch.cli.ppserve start``) with the router's
``--device``; several daemons on one GPU each open their own CUDA
context and caching allocator, so each holds its own device memory
(``status`` reports each daemon's).

One :class:`TOAService` daemon is the single-host unit (daemon.py);
this module is the layer above it — the routing front the ROADMAP's
"heavy traffic" north-star needs.  A :class:`FleetRouter`:

* **spawns or adopts** N ``ppserve`` daemons, every one sharing the
  same kernel build directory and warm plan, so the fleet runs
  ``nvcc`` at most once and every replica starts fit-bound;
* **routes by shape bucket** — each submission is header-scanned
  router-side (``runner/plan.scan_archive_header``) and forwarded to
  the daemon that owns its ``(nchan, nbin)`` bucket, so same-bucket
  traffic from many tenants lands on ONE warm fitter pool and
  coalesces into dense micro-batches instead of spreading thin across
  replicas.  Bucket→daemon assignment is sticky; a load-based
  rebalance pass moves the coldest bucket off the hottest daemon when
  the open-request skew exceeds ``rebalance_delta``;
* **supervises** the fleet: a poll loop consumes each daemon's
  ``health`` verb and its process exit status; a daemon that
  dies or fails ``unhealthy_after`` consecutive probes is declared
  down, its buckets re-route to live daemons for NEW work, and it is
  respawned **in place** — same workdir, same per-tenant ledgers — so
  accepted-but-unfinished requests replay exactly once.  In-flight
  forwards that lose their connection retry against the SAME daemon
  after respawn (never a sibling): the ledger that accepted the work
  is the only one that can dedupe it;
* **sheds load** at the front door: fleet-level memory-aware
  admission (the plan's footprint estimate against
  ``mem_budget_bytes``) and an
  optional fleet open-request ceiling reject requests the fleet would
  only queue or OOM on, before they burn a forward;
* **merges observability**: the ``metrics`` verb returns one
  :func:`~..obs.metrics.merge_snapshots` view over the router and
  every live daemon, and the router's own obs run records the fleet
  lifecycle (``router_*`` events) that ``tools/obs_report``'s
  "## fleet" section renders.

The router duck-types the :class:`~.server.ServiceServer` service
interface (submit/wait/status/health/metrics_snapshot/request_drain),
so the same JSONL-over-Unix-socket protocol serves both a daemon and
a fleet; ``request_id``s are namespaced ``d<i>:r<nnnnnn>`` so ``wait``
can find the owning daemon.

Host-side orchestration only — subprocess + socket + threading; no
device code.
"""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time

from .. import obs
from ..config import resolve_device
from ..obs import metrics, usage
from ..obs import health as obs_health
from ..runner.plan import SurveyPlan, canonical_shape, \
    estimate_archive_bytes, scan_archive_header
from ..runner.respawn import PARK, RespawnPolicy, RespawnTracker
from .server import DEFAULT_SOCKET_NAME, client_request

__all__ = ["FleetRouter", "DEFAULT_ROUTER_SOCKET_NAME"]

DEFAULT_ROUTER_SOCKET_NAME = "pprouter.sock"

# ppserve readiness marker (cli/ppserve.py prints it; the smoke tools
# and this supervisor both key on it)
_READY_MARK = "PPSERVE_READY"


def _blabel(bucket):
    return "-" if bucket is None else "%dx%d" % tuple(bucket)


class _Daemon:
    """One supervised fleet member (spawned subprocess or adopted
    socket)."""

    __slots__ = ("idx", "name", "workdir", "socket", "proc", "ready",
                 "adopted", "fails", "open_requests", "buckets",
                 "n_routed", "respawns", "last_health", "pid",
                 "drain_sent")

    def __init__(self, idx, workdir, socket_path, adopted=False):
        self.idx = idx
        self.name = "d%d" % idx
        self.workdir = workdir
        self.socket = socket_path
        self.proc = None
        self.ready = threading.Event()
        self.adopted = adopted
        self.fails = 0
        self.open_requests = 0
        self.buckets = set()
        self.n_routed = 0
        self.respawns = 0
        self.last_health = None
        self.pid = None
        self.drain_sent = False

    def load(self):
        """Routing load score: open requests dominate; bucket count
        breaks ties so fresh buckets spread before traffic does."""
        return (self.open_requests, len(self.buckets), self.idx)


class FleetRouter:
    """The fleet front-end (module docstring).

    In-process API mirrors :class:`~.daemon.TOAService` so
    :class:`~.server.ServiceServer` can serve it unchanged:
    :meth:`start`, :meth:`submit`, :meth:`wait`, :meth:`status`,
    :meth:`health`, :meth:`metrics_snapshot`, :meth:`request_drain`,
    :meth:`drained`, :meth:`shutdown`.
    """

    def __init__(self, modelfile, workdir, n_daemons=3, plan=None,
                 compile_cache=None, warm=True, batch_window_s=0.25,
                 batch_max=8, solo_window_s=0.1, mem_budget_bytes=None,
                 quotas=None, fleet_max_open=0, health_interval_s=1.0,
                 unhealthy_after=2, rebalance_delta=8,
                 respawn_timeout_s=300.0, forward_attempts=3,
                 adopt_sockets=None, daemon_args=None, daemon_env=None,
                 flap_count=5, flap_window_s=60.0, quiet=True,
                 device=None):
        # the device every spawned daemon fits on (None = the CUDA
        # device; with no CUDA device and no explicit "cpu" this
        # raises before any daemon is spawned)
        self.device = resolve_device(device)
        self.modelfile = modelfile
        self.workdir = workdir
        self.compile_cache = compile_cache
        self.warm = bool(warm)
        self.batch_window_s = float(batch_window_s)
        self.batch_max = int(batch_max)
        self.solo_window_s = float(solo_window_s)
        self.mem_budget_bytes = int(mem_budget_bytes or 0)
        # per-tenant usage quotas (obs/usage.py): enforced at the
        # router's own admission over its metered forwards, AND
        # propagated to every spawned daemon (--quotas), whose
        # device-seconds metering is the authoritative enforcement
        self.quotas = usage.quotas_from_env() if quotas is None \
            else usage.parse_quotas(quotas)
        self.fleet_max_open = int(fleet_max_open or 0)
        self.health_interval_s = float(health_interval_s)
        self.unhealthy_after = max(1, int(unhealthy_after))
        self.rebalance_delta = max(1, int(rebalance_delta))
        self.respawn_timeout_s = float(respawn_timeout_s)
        self.forward_attempts = max(1, int(forward_attempts))
        # extra ppserve-start argv for every spawn (e.g. --no_bary)
        self.daemon_args = list(daemon_args or [])
        # extra env for the FIRST spawn of each daemon (the chaos
        # hook: fleet_smoke injects a sigkill clause here); respawns
        # scrub PPTPU_FAULTS — a replacement must come back clean
        self.daemon_env = dict(daemon_env or {})
        self.quiet = quiet

        os.makedirs(workdir, exist_ok=True)
        if isinstance(plan, SurveyPlan):
            path = os.path.join(workdir, "fleet_plan.json")
            plan.save(path)
            plan = path
        self.plan_path = plan

        self._daemons = []
        self._by_name = {}
        if adopt_sockets:
            for i, sock in enumerate(adopt_sockets):
                d = _Daemon(i, os.path.dirname(sock), sock,
                            adopted=True)
                self._daemons.append(d)
        else:
            for i in range(max(1, int(n_daemons))):
                wd = os.path.join(workdir, "d%d" % i)
                d = _Daemon(i, wd,
                            os.path.join(wd, DEFAULT_SOCKET_NAME))
                self._daemons.append(d)
        self._by_name = {d.name: d for d in self._daemons}
        # crash-loop guard (runner/respawn.py): zero backoff keeps the
        # below-threshold path exactly the old immediate in-place
        # respawn; a daemon that dies flap_count times inside
        # flap_window_s is parked (router_flap) instead of burning CPU
        policy = RespawnPolicy(backoff_s=0.0,
                               flap_count=max(1, int(flap_count)),
                               flap_window_s=float(flap_window_s))
        self._flap = {d.name: RespawnTracker(policy, key=d.name)
                      for d in self._daemons}

        self._lock = threading.Lock()
        self._assign = {}          # bucket -> _Daemon
        self._bucket_routed = {}   # bucket -> routed count (rebalance)
        self._draining = False
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._thread = None
        self._obs_stack = contextlib.ExitStack()
        self.t_start = None

    # -- lifecycle ------------------------------------------------------

    def start(self, ready_timeout=600.0):
        """Open the router obs run, bring the fleet up (spawn or
        adopt), start the supervisor.  Blocks until every daemon is
        ready (or ``ready_timeout`` expires — stragglers keep coming
        up under supervision)."""
        if self._thread is not None:
            raise RuntimeError("FleetRouter already started")
        self.t_start = time.time()
        self._obs_stack.enter_context(obs.run(
            "pprouter", base_dir=os.path.join(self.workdir, "obs"),
            config={"modelfile": self.modelfile,
                    "n_daemons": len(self._daemons),
                    "plan": self.plan_path,
                    "compile_cache": self.compile_cache,
                    "mem_budget_bytes": self.mem_budget_bytes,
                    "quotas": self.quotas or None,
                    "fleet_max_open": self.fleet_max_open,
                    "batch_window_s": self.batch_window_s,
                    "batch_max": self.batch_max,
                    "device": self.device.type}))
        if self.quotas:
            usage.configure_quotas(self.quotas)
        obs_health.evaluate()
        for d in self._daemons:
            if d.adopted:
                # adopted daemons are someone else's processes: probe
                # once, then supervise like any other (no respawn);
                # fleet-lifecycle events, no one request trace to adopt
                threading.Thread(target=self._probe_adopted,
                                 args=(d,), daemon=True,
                                 name="pprouter-adopt-%s" % d.name
                                 ).start()
            else:
                self._spawn(d, first=True)
        deadline = time.time() + float(ready_timeout)
        for d in self._daemons:
            d.ready.wait(timeout=max(0.0, deadline - time.time()))
        self._thread = threading.Thread(target=self._supervise,
                                        name="pprouter-supervisor",
                                        daemon=True)
        self._thread.start()
        obs.event("router_started", workdir=self.workdir,
                  n_daemons=len(self._daemons),
                  ready=sum(1 for d in self._daemons
                            if d.ready.is_set()))
        self._publish_gauges()
        return self

    def _probe_adopted(self, d):
        try:
            h = client_request(d.socket, {"op": "health"},
                               timeout=10.0)
        except (OSError, ValueError):
            return
        if h.get("live"):
            d.pid = None
            d.last_health = h
            d.ready.set()
            obs.event("router_daemon_ready", daemon=d.name,
                      socket=d.socket, adopted=True)

    def _daemon_cmd(self):
        cmd = [sys.executable, "-m",
               "pulseportraiture_tpu_torch.cli.ppserve", "start",
               "-m", self.modelfile, "--device", self.device.type,
               "--window", str(self.batch_window_s),
               "--solo-window", str(self.solo_window_s),
               "--batch", str(self.batch_max)]
        if self.plan_path:
            cmd += ["--plan", self.plan_path]
            if self.warm:
                cmd += ["--warm"]
        if self.compile_cache:
            cmd += ["--compile-cache", self.compile_cache]
        if self.quotas:
            # every daemon enforces the same budgets over its OWN
            # metered usage (per-enforcement-point totals)
            cmd += ["--quotas", json.dumps(self.quotas)]
        if self.quiet:
            cmd += ["--quiet"]
        cmd += self.daemon_args
        return cmd

    def _spawn(self, d, first):
        """Launch (or relaunch) one daemon; a waiter thread flips
        ``d.ready`` when the PPSERVE_READY marker appears."""
        os.makedirs(d.workdir, exist_ok=True)
        env = dict(os.environ)
        if first:
            env.update(self.daemon_env)
        else:
            # a respawn must come back clean: one-shot chaos clauses
            # (sigkill specs) died with the process they killed
            env.pop("PPTPU_FAULTS", None)
        log = open(os.path.join(d.workdir, "daemon.log"), "ab")
        try:
            d.proc = subprocess.Popen(
                self._daemon_cmd() + ["-w", d.workdir],
                stdout=subprocess.PIPE, stderr=log, env=env)
        finally:
            log.close()
        # ready-marker watcher: fleet-lifecycle telemetry only, no
        # request trace to adopt
        threading.Thread(target=self._wait_ready, args=(d, first),
                         daemon=True,
                         name="pprouter-wait-%s" % d.name).start()

    def _wait_ready(self, d, first):
        proc = d.proc
        marked = False
        for raw in proc.stdout:
            line = raw.decode("utf-8", errors="replace").strip()
            if not marked and line.startswith(_READY_MARK):
                try:
                    info = json.loads(line[len(_READY_MARK):].strip())
                except (json.JSONDecodeError, ValueError):
                    info = {}
                d.pid = info.get("pid", proc.pid)
                d.fails = 0
                d.last_health = None
                d.ready.set()
                marked = True
                obs.event("router_daemon_ready", daemon=d.name,
                          pid=d.pid, warmed=info.get("warmed"),
                          respawn=not first)
                self._publish_gauges()
            # keep draining stdout either way: a full pipe would
            # wedge the daemon on its next print
        if not marked:
            obs.event("router_daemon_down", daemon=d.name,
                      reason="spawn_failed",
                      returncode=proc.poll())

    # -- supervision ----------------------------------------------------

    def _supervise(self):
        while not self._stop.wait(self.health_interval_s):
            try:
                self._poll_once()
            except Exception:  # noqa: BLE001 — supervisor never dies
                pass
        self._drained.set()

    def _poll_once(self):
        for d in self._daemons:
            if not d.ready.is_set():
                continue  # spawning/respawning; the waiter owns it
            if d.proc is not None and d.proc.poll() is not None:
                if self._draining:
                    continue  # drained exit is the expected path
                self._daemon_down(
                    d, "exit_%s" % d.proc.returncode)
                continue
            try:
                h = client_request(d.socket, {"op": "health"},
                                   timeout=10.0)
            except (OSError, ValueError) as e:
                d.fails += 1
                if d.fails >= self.unhealthy_after \
                        and not self._draining:
                    self._daemon_down(d, "health_unreachable: %s"
                                      % type(e).__name__)
                continue
            d.fails = 0
            d.last_health = h
            d.open_requests = int(h.get("open_requests") or 0)
            if not h.get("live") and not self._draining:
                self._daemon_down(d, "not_live")
        self._rebalance()
        self._publish_gauges()
        obs_health.evaluate()

    def _publish_gauges(self):
        metrics.set_gauge("pps_fleet_daemons",
                          sum(1 for d in self._daemons
                              if d.ready.is_set()))
        metrics.set_gauge("pps_fleet_open_requests",
                          sum(d.open_requests for d in self._daemons
                              if d.ready.is_set()))

    def _daemon_down(self, d, reason):
        """Declare a daemon dead: re-route its buckets for new work,
        respawn it in place (same workdir → same ledgers → replay is
        exactly-once).  Callable from the supervisor AND from a
        forwarder that noticed the death first — the check-and-clear
        under the lock makes it fire once."""
        with self._lock:
            if not d.ready.is_set():
                return
            d.ready.clear()
            d.open_requests = 0
        obs.event("router_daemon_down", daemon=d.name, reason=reason,
                  pid=d.pid)
        with self._lock:
            moved = []
            for bucket in sorted(d.buckets):
                target = self._pick_locked(exclude=d)
                if target is None:
                    continue  # nowhere to go; forwards wait on respawn
                self._assign[bucket] = target
                target.buckets.add(bucket)
                moved.append((bucket, target.name))
            for bucket, _ in moved:
                d.buckets.discard(bucket)
        for bucket, target in moved:
            obs.event("router_rebalance", bucket=_blabel(bucket),
                      src=d.name, dst=target, cause="daemon_down")
        if d.proc is not None:
            # make sure a half-dead process is fully gone before its
            # replacement binds the same socket path
            with contextlib.suppress(OSError):
                d.proc.kill()
            with contextlib.suppress(Exception):
                d.proc.wait(timeout=10.0)
        if d.adopted or self._draining:
            return
        verdict = self._flap[d.name].record_death(time.time())
        if verdict["action"] == PARK:
            # crash-looping daemon: park it instead of respawning
            # forever — the fleet degrades onto the survivors (its
            # buckets were just re-routed above)
            obs.event("router_flap", daemon=d.name,
                      deaths=verdict.get("deaths"),
                      window_s=verdict.get("window_s"),
                      respawns=d.respawns)
            self._publish_gauges()
            return
        d.respawns += 1
        obs.counter("router_respawns")
        metrics.inc("pps_respawns_total", daemon=d.name)
        obs.event("router_respawn", daemon=d.name, reason=reason,
                  respawns=d.respawns)
        self._spawn(d, first=False)
        self._publish_gauges()

    def _rebalance(self):
        """Load-based rebalance: when the open-request skew between
        the hottest and coldest ready daemon exceeds
        ``rebalance_delta``, move the hottest daemon's
        least-trafficked bucket to the coldest (new work only —
        accepted work stays on the ledger that owns it)."""
        with self._lock:
            ready = [d for d in self._daemons if d.ready.is_set()]
            if len(ready) < 2:
                return
            hot = max(ready, key=lambda d: d.open_requests)
            cold = min(ready, key=lambda d: d.open_requests)
            if hot.open_requests - cold.open_requests \
                    < self.rebalance_delta:
                return
            if len(hot.buckets) < 2:
                return  # moving its only bucket just moves the spot
            bucket = min(hot.buckets,
                         key=lambda b: self._bucket_routed.get(b, 0))
            hot.buckets.discard(bucket)
            cold.buckets.add(bucket)
            self._assign[bucket] = cold
        obs.counter("router_rebalances")
        metrics.inc("pps_rebalances_total")
        obs.event("router_rebalance", bucket=_blabel(bucket),
                  src=hot.name, dst=cold.name, cause="load",
                  hot_open=hot.open_requests,
                  cold_open=cold.open_requests)

    # -- routing --------------------------------------------------------

    def _pick_locked(self, exclude=None):
        ready = [d for d in self._daemons
                 if d.ready.is_set() and d is not exclude]
        if not ready:
            return None
        return min(ready, key=_Daemon.load)

    def _owner(self, bucket):
        """The daemon owning ``bucket`` (sticky; assigned to the
        least-loaded ready daemon on first sight).  Unclassifiable
        archives (bucket None) go wherever load is lowest — the
        daemon's intake quarantine owns them."""
        with self._lock:
            if bucket is None:
                return self._pick_locked()
            d = self._assign.get(bucket)
            if d is None:
                d = self._pick_locked()
                if d is None:
                    return None
                self._assign[bucket] = d
                d.buckets.add(bucket)
                obs.event("router_assign", bucket=_blabel(bucket),
                          daemon=d.name)
            return d

    def _classify(self, archive):
        """(bucket, est_bytes) from a router-side header scan; both
        None when the archive is unreadable (the daemon quarantines
        it at intake)."""
        try:
            info = scan_archive_header(archive)
        except (OSError, ValueError, KeyError):
            return None, None
        return (canonical_shape(info.nchan, info.nbin),
                estimate_archive_bytes(info.nchan, info.nbin,
                                       nsub=info.nsub))

    def _admission(self, tenant, archive, est):
        """Fleet-level load-shed before any forward: the memory
        estimate against the per-daemon device budget, the tenant's
        usage quota against the router's metered forwards
        (obs/usage.py), and the fleet open-request ceiling."""
        if self.quotas:
            breach = usage.check(tenant, self.quotas)
            if breach is not None:
                obs.counter("router_sheds")
                metrics.inc("pps_shed_total", reason="quota")
                obs.event("router_shed", tenant=tenant,
                          archive=archive, reason="quota", **breach)
                return {"ok": False, "error": "quota",
                        "tenant": tenant, "archive": archive,
                        **breach}
        if self.mem_budget_bytes and est is not None \
                and est > self.mem_budget_bytes:
            obs.counter("router_sheds")
            metrics.inc("pps_shed_total", reason="memory")
            obs.event("router_shed", tenant=tenant, archive=archive,
                      reason="memory", est_bytes=est,
                      budget_bytes=self.mem_budget_bytes)
            return {"ok": False, "error": "memory", "tenant": tenant,
                    "archive": archive, "est_bytes": est,
                    "budget_bytes": self.mem_budget_bytes}
        if self.fleet_max_open:
            open_total = sum(d.open_requests for d in self._daemons
                             if d.ready.is_set())
            if open_total >= self.fleet_max_open:
                obs.counter("router_sheds")
                metrics.inc("pps_shed_total", reason="overloaded")
                obs.event("router_shed", tenant=tenant,
                          archive=archive, reason="overloaded",
                          open=open_total,
                          limit=self.fleet_max_open)
                return {"ok": False, "error": "overloaded",
                        "tenant": tenant, "open": open_total,
                        "limit": self.fleet_max_open}
        return None

    def submit(self, tenant, archive, config=None, wait=False,
               timeout=None, traceparent=None, priority=0,
               deadline_s=None):
        """Route one submission to its bucket's daemon; the response
        is the daemon's, with the ``request_id`` namespaced
        ``d<i>:...``."""
        if self._draining:
            metrics.inc("pps_requests_total", tenant=str(tenant),
                        outcome="rejected_draining")
            return {"ok": False, "error": "draining"}
        obs.counter("router_requests")
        path = str(archive)
        bucket, est = self._classify(path)
        shed = self._admission(tenant, path, est)
        if shed is not None:
            return shed
        payload = {"op": "submit", "tenant": tenant, "archive": path,
                   "wait": bool(wait)}
        if config:
            payload["config"] = config
        if timeout is not None:
            payload["timeout_s"] = timeout
        if traceparent:
            payload["traceparent"] = traceparent
        if priority:
            payload["priority"] = int(priority)
        if deadline_s is not None:
            payload["deadline_s"] = float(deadline_s)
        conn_timeout = (float(timeout) if timeout else 300.0) + 30.0
        return self._forward(bucket, payload, conn_timeout)

    def _forward(self, bucket, payload, conn_timeout):
        """Forward with supervised retry.  A connection that dies
        mid-forward retries against the SAME daemon after respawn —
        the ledger that may have accepted the work is the only one
        that can replay it exactly once.  A ``draining`` rejection
        (daemon being replaced while the fleet is live) provably did
        NOT accept, so the bucket re-routes and the forward moves on.
        """
        d = None
        last_err = None
        for _ in range(self.forward_attempts):
            if d is None:
                d = self._owner(bucket)
            if d is None:
                return {"ok": False, "error": "no_daemon",
                        "detail": "no ready daemon in the fleet"}
            if not d.ready.wait(timeout=self.respawn_timeout_s):
                return {"ok": False, "error": "daemon_unavailable",
                        "daemon": d.name,
                        "detail": "respawn did not become ready"}
            try:
                resp = client_request(d.socket, payload,
                                      timeout=conn_timeout)
            except (OSError, ValueError) as e:
                last_err = e
                obs.counter("router_forward_retries")
                metrics.inc("pps_forward_retries_total")
                obs.event("router_forward_retry", daemon=d.name,
                          archive=payload.get("archive"),
                          error=type(e).__name__)
                d.fails += 1
                # the forwarder is a failure detector too: a dead
                # process gets declared down (and respawned) NOW
                # instead of after the next health-poll window, so
                # the retry below blocks on d.ready instead of
                # spinning against a dead socket
                if not self._draining:
                    if d.proc is not None and d.proc.poll() is not None:
                        self._daemon_down(d, "exit_%s"
                                          % d.proc.returncode)
                    else:
                        time.sleep(min(1.0, self.health_interval_s))
                continue  # same daemon: wait out its respawn
            if not resp.get("ok") and resp.get("error") == "draining" \
                    and not self._draining:
                with self._lock:
                    if bucket is not None \
                            and self._assign.get(bucket) is d:
                        d.buckets.discard(bucket)
                        self._assign.pop(bucket, None)
                d = None
                continue
            with self._lock:
                d.n_routed += 1
                if bucket is not None:
                    self._bucket_routed[bucket] = \
                        self._bucket_routed.get(bucket, 0) + 1
            metrics.inc("pps_routed_total", bucket=_blabel(bucket),
                        daemon=d.name)
            # meter the forward (obs/usage.py): the router's own
            # usage view — request counts and, when the daemon
            # answered with a terminal payload, its wall seconds.
            # Device seconds stay on the daemon that burned them; the
            # fleet-merged metrics verb sums both sides per tenant.
            wall = resp.get("wall_s")
            usage.meter("forward", tenant=payload.get("tenant"),
                        bucket=_blabel(bucket),
                        wall_s=wall if isinstance(
                            wall, (int, float)) else 0.0,
                        daemon=d.name, ok=bool(resp.get("ok")))
            if resp.get("request_id"):
                resp["request_id"] = "%s:%s" % (d.name,
                                                resp["request_id"])
            return resp
        return {"ok": False, "error": "daemon_unavailable",
                "daemon": d.name if d else None,
                "detail": "%s: %s" % (type(last_err).__name__,
                                      last_err)
                if last_err else "forward attempts exhausted"}

    def wait(self, request_id, timeout=None):
        name, _, rid = str(request_id or "").partition(":")
        d = self._by_name.get(name)
        if d is None or not rid:
            return {"ok": False, "error": "unknown_request",
                    "request_id": request_id}
        try:
            resp = client_request(
                d.socket, {"op": "wait", "request_id": rid,
                           "timeout_s": timeout},
                timeout=(float(timeout) if timeout else 300.0) + 30.0)
        except (OSError, ValueError) as e:
            return {"ok": False, "error": "daemon_unavailable",
                    "daemon": d.name, "detail": str(e)}
        if resp.get("request_id"):
            resp["request_id"] = "%s:%s" % (d.name,
                                            resp["request_id"])
        return resp

    # -- introspection --------------------------------------------------

    def status(self):
        with self._lock:
            daemons = {}
            for d in self._daemons:
                daemons[d.name] = {
                    "ready": d.ready.is_set(),
                    "adopted": d.adopted,
                    "pid": d.pid,
                    "open_requests": d.open_requests,
                    "routed": d.n_routed,
                    "respawns": d.respawns,
                    "parked": self._flap[d.name].parked,
                    "buckets": sorted(_blabel(b)
                                      for b in d.buckets)}
            assignment = {_blabel(b): d.name
                          for b, d in self._assign.items()}
        out = {"ok": True,
               "uptime_s": round(time.time() - (self.t_start
                                                or time.time()), 3),
               "draining": self._draining,
               "n_daemons": len(self._daemons),
               "daemons": daemons,
               "assignment": assignment}
        rec = obs.current()
        if rec is not None:
            out["counters"] = dict(rec.counters)
            out["obs_run"] = rec.dir
        return out

    def health(self):
        """Fleet probe surface: the router is live while its
        supervisor runs; ready while at least one daemon accepts
        work."""
        alerts = obs_health.evaluate() or []
        live = self._thread is not None and self._thread.is_alive()
        ready_daemons = [d for d in self._daemons if d.ready.is_set()]
        out = {"ok": live,
               "live": live,
               "ready": live and not self._draining
               and bool(ready_daemons),
               "draining": self._draining,
               "daemons_ready": len(ready_daemons),
               "daemons_total": len(self._daemons),
               "open_requests": sum(d.open_requests
                                    for d in ready_daemons),
               "respawns": sum(d.respawns for d in self._daemons),
               "alerts_firing": len(alerts),
               "alerts": alerts}
        rec = obs.current()
        if rec is not None:
            out["obs_run"] = rec.dir
        return out

    def metrics_snapshot(self):
        """One merged fleet snapshot: the router's own registry plus
        every live daemon's, via
        :func:`~..obs.metrics.merge_snapshots` (counters/histograms
        sum; gauges keep per-process identity under ``p<name>/``)."""
        snaps = {}
        own = metrics.snapshot()
        if own:
            snaps["router"] = own
        for d in self._daemons:
            if not d.ready.is_set():
                continue
            try:
                snap = client_request(d.socket, {"op": "metrics"},
                                      timeout=15.0).get("snapshot")
            except (OSError, ValueError):
                continue
            if snap:
                snaps[d.name] = snap
        if not snaps:
            return None
        if len(snaps) == 1:
            return next(iter(snaps.values()))
        return metrics.merge_snapshots(snaps)

    # -- drain / shutdown -----------------------------------------------

    def request_drain(self):
        """Fleet drain: stop routing, ask every daemon to drain."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
        obs.event("router_drain")
        metrics.set_gauge("pps_draining", 1)
        self._notify_drain()

    def _notify_drain(self):
        """Forward the shutdown op to every ready daemon not yet
        told.  A daemon mid-respawn when the drain started (not ready
        yet) is notified later, from drained()'s wait loop, the
        moment its warm-up finishes — otherwise it would outlive the
        fleet."""
        for d in self._daemons:
            if d.drain_sent or not d.ready.is_set():
                continue
            d.drain_sent = True
            with contextlib.suppress(OSError, ValueError):
                client_request(d.socket, {"op": "shutdown"},
                               timeout=10.0)

    def drained(self, timeout=None):
        """True when every spawned daemon has exited after a drain.
        An adopted-only fleet (no child processes) counts as drained
        once the drain was requested — adopted daemons are not ours
        to wait on."""
        if all(d.proc is None for d in self._daemons):
            if not self._draining and timeout:
                time.sleep(timeout)
            return self._draining
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if self._draining:
                self._notify_drain()
            alive = [d for d in self._daemons
                     if d.proc is not None and d.proc.poll() is None]
            if not alive:
                return True
            if deadline is not None and time.time() >= deadline:
                return False
            left = 0.2 if deadline is None \
                else min(0.2, max(0.01, deadline - time.time()))
            try:
                alive[0].proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                pass

    def shutdown(self, timeout=120.0):
        """Drain the fleet, stop the supervisor, close obs state.
        Returns True when every daemon exited in time."""
        self.request_drain()
        ok = self.drained(timeout=timeout)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(10.0)
            self._thread = None
        for d in self._daemons:
            if d.proc is not None and d.proc.poll() is None:
                with contextlib.suppress(OSError):
                    d.proc.kill()
                with contextlib.suppress(Exception):
                    d.proc.wait(timeout=10.0)
            d.ready.clear()
        obs.event("router_stopped", drained=bool(ok),
                  respawns=sum(d.respawns for d in self._daemons))
        self._obs_stack.close()
        return ok
