"""Self-healing autoscaling supervisor for elastic survey workers.

``ppsurvey supervise`` closes the loop from observability back into
actuation: instead of a human picking ``--processes`` and re-running
``ppsurvey resume`` after every crash, one control loop owns the
survey end-to-end.  It spawns ``ppsurvey run`` worker subprocesses
(one per *slot*, slot index == worker ``--process`` index, so every
replacement inherits its predecessor's ledger shard, checkpoint
reconcile and crash-recovery semantics for free) and reconciles
desired vs. actual worker count every tick from the live planes the
runner already maintains:

* **queue depth + leases** (runner/queue.py): a readonly union replay
  gives ready-work backlog, outstanding totals, and expired leases —
  the same view ``ppsurvey status`` renders;
* **memory admission** (obs/memory.py + the plan's per-bucket
  ``est_bytes``): a worker-count cap of ``mem_budget_bytes //
  est_worker_bytes`` when a budget is configured;
* **health alerts** (obs/health.py): a firing ``memory_watermark``
  blocks scale-up, and supervisor respawn churn feeds the
  ``worker_churn`` rule.

Policy — all of it inside the pure, table-testable
:func:`decide(observed) -> actions`:

* scale **up** when ready backlog per live worker exceeds
  ``backlog_per_worker`` (and memory headroom allows, and no blocking
  alert fires), bounded by ``max_workers``;
* scale **down** by SIGTERM drain (the runner's preemption semantics: the
  in-flight archive finishes, the worker exits 0) when the live set
  outnumbers the remaining work;
* **replace** any worker that exits nonzero or whose leases expire,
  through per-slot crash-loop exponential backoff
  (runner/respawn.py); a slot that dies ``flap_count`` times inside
  ``flap_window_s`` is **parked** with a ``supervisor_flap`` event
  instead of respawning forever — the survey finishes on the
  survivors.

Every action is audited: ``supervisor_*`` events,
``pps_supervisor_workers{state}`` gauges and
``pps_supervisor_respawns_total`` / ``pps_supervisor_scale_events_total``
counters, all merged into the survey report via the supervisor's own
obs shard.  Killing the supervisor never loses work: the workers are
plain ``ppsurvey run`` processes that drain standalone, and a plain
``ppsurvey resume`` afterwards continues from the union ledger.
"""

import math
import os
import signal
import subprocess
import sys
import threading
import time

from .. import obs
from ..obs import health as obs_health
from ..obs import memory as obs_memory
from ..obs import metrics
from ..obs.merge import merge_obs_shards, write_shard
from ..testing import faults
from .plan import SurveyPlan
from .queue import DEFAULT_WORKLOAD, WorkQueue, owner_pid
from .respawn import PARK, RespawnPolicy, RespawnTracker

__all__ = ["Supervisor", "decide", "GAUGE_WORKERS", "GAUGE_LAST_SCALE",
           "COUNTER_RESPAWNS", "COUNTER_SCALE_EVENTS", "BLOCKING_ALERTS"]

GAUGE_WORKERS = "pps_supervisor_workers"
GAUGE_LAST_SCALE = "pps_supervisor_last_scale"
COUNTER_RESPAWNS = "pps_supervisor_respawns_total"
COUNTER_SCALE_EVENTS = "pps_supervisor_scale_events_total"

# alerts that veto scale-up (replacements still happen: a survey that
# is already over budget should not *grow*, but keeping the configured
# floor alive is what drains the pressure)
BLOCKING_ALERTS = frozenset(["memory_watermark"])

# slot states
EMPTY = "empty"        # spawnable: never spawned, or exited clean
LIVE = "live"          # subprocess running
DEAD = "dead"          # died dirty; respawn pending its backoff
PARKED = "parked"      # flapped; never respawned again


def decide(observed):
    """Pure reconciliation policy: one observation in, actions out.

    ``observed`` (plain dict, every key optional):

    * ``ready`` — archives claimable right now (pending, retry-backoff
      elapsed, or under an expired lease);
    * ``outstanding`` — archives not yet done/quarantined;
    * ``live`` / ``draining`` / ``parked`` / ``empty`` — slot-index
      lists by state (``draining`` ⊆ ``live``);
    * ``dead`` — ``[{"slot", "action": "respawn"|"park", "due"}]``
      verdicts from each dead slot's RespawnTracker;
    * ``expired`` — live slots whose ledger leases have expired (a
      wedged worker: alive to the OS, dead to the survey);
    * ``min_workers`` / ``max_workers`` / ``backlog_per_worker`` —
      the scaling knobs;
    * ``mem_budget_bytes`` / ``est_worker_bytes`` — admission inputs
      (0 = unconstrained);
    * ``alerts`` — names of firing health rules.

    Returns ``[{"op", "slot", "cause"}]`` with op one of ``spawn``
    (cause ``scale_up``/``replace``), ``drain`` (``scale_down``/
    ``complete``), ``respawn`` (``lease_expired``: kill + backoff +
    re-spawn) or ``park`` (``flap``).  Deterministic: scale-up fills
    the lowest empty slots, scale-down drains the highest live ones.
    """
    acts = []
    live = sorted(observed.get("live") or ())
    draining = set(observed.get("draining") or ())
    min_w = int(observed.get("min_workers", 1))
    max_w = int(observed.get("max_workers", 1))
    per = float(observed.get("backlog_per_worker", 2.0))
    ready = int(observed.get("ready", 0))
    outstanding = int(observed.get("outstanding", 0))
    alerts = set(observed.get("alerts") or ())
    budget = int(observed.get("mem_budget_bytes") or 0)
    est = int(observed.get("est_worker_bytes") or 0)

    # 1. dead slots: obey each tracker's verdict
    for d in observed.get("dead") or ():
        if d.get("action") == PARK:
            acts.append({"op": "park", "slot": d["slot"],
                         "cause": "flap"})
        elif d.get("due") and outstanding > 0:
            acts.append({"op": "spawn", "slot": d["slot"],
                         "cause": "replace"})
    replacing = set(a["slot"] for a in acts if a["op"] == "spawn")

    # 2. wedged workers: live to the OS but their leases expired
    for slot in observed.get("expired") or ():
        if slot in live and slot not in draining:
            acts.append({"op": "respawn", "slot": slot,
                         "cause": "lease_expired"})

    # 3. survey complete: drain everything (below min_workers too)
    if outstanding <= 0:
        for slot in live:
            if slot not in draining:
                acts.append({"op": "drain", "slot": slot,
                             "cause": "complete"})
        return acts

    # 4. scale down: the live set outnumbers the remaining work
    if len(live) > outstanding:
        surplus = len(live) - max(outstanding, min_w)
        for slot in sorted(live, reverse=True)[:max(0, surplus)]:
            if slot not in draining:
                acts.append({"op": "drain", "slot": slot,
                             "cause": "scale_down"})
        return acts

    # 5. scale up: backlog per live worker exceeds the threshold
    want = math.ceil(ready / per) if per > 0 else max_w
    want = min(max_w, max(min_w, want))
    if budget > 0 and est > 0:
        want = min(want, max(budget // est, min_w))
    add = want - (len(live) + len(replacing))
    if add > 0 and not (alerts & BLOCKING_ALERTS):
        pool = [s for s in sorted(observed.get("empty") or ())
                if s not in replacing]
        for slot in pool[:add]:
            acts.append({"op": "spawn", "slot": slot,
                         "cause": "scale_up"})
    return acts


class _Slot(object):
    """One worker slot: a fixed ``--process`` index plus its current
    subprocess (if any) and respawn bookkeeping."""

    __slots__ = ("index", "state", "proc", "pid", "spawned_at",
                 "tracker", "draining", "spawn_count")

    def __init__(self, index, policy):
        self.index = index
        self.state = EMPTY
        self.proc = None
        self.pid = None
        self.spawned_at = None
        self.tracker = RespawnTracker(policy, key="w%d" % index)
        self.draining = False
        self.spawn_count = 0


class Supervisor(object):
    """Own a planned survey end-to-end: spawn, scale, replace, drain.

    ``run()`` blocks until the survey has no outstanding work (or
    every slot is parked), then merges the obs shards — including the
    supervisor's own audit shard — and returns a summary dict.
    """

    def __init__(self, workdir, modelfile=None, min_workers=1,
                 max_workers=4, backlog_per_worker=2.0, interval_s=1.0,
                 lease_s=600.0, mem_budget_bytes=0,
                 est_worker_bytes=None, workload=DEFAULT_WORKLOAD,
                 warm=None, compile_cache=None, respawn_policy=None,
                 worker_args=(), worker_env=None, drain_grace_s=60.0,
                 max_ticks=None, device="cuda", quiet=False):
        if max_workers < 1 or min_workers < 0 \
                or min_workers > max_workers:
            raise ValueError("need 0 <= min_workers <= max_workers, "
                             "max_workers >= 1")
        self.workdir = workdir
        self.modelfile = modelfile
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.backlog_per_worker = float(backlog_per_worker)
        self.interval_s = float(interval_s)
        self.lease_s = float(lease_s)
        self.mem_budget_bytes = int(mem_budget_bytes or 0)
        self.workload = str(workload or DEFAULT_WORKLOAD)
        self.warm = warm
        self.compile_cache = compile_cache
        self.worker_args = list(worker_args or ())
        self.worker_env = dict(worker_env or {})  # slot -> {K: V}
        self.drain_grace_s = float(drain_grace_s)
        self.max_ticks = max_ticks
        # forwarded to every worker's --device
        self.device = str(device or "cuda")
        self.quiet = bool(quiet)

        plan_path = os.path.join(workdir, "plan.json")
        if not os.path.isfile(plan_path):
            raise FileNotFoundError(
                "no plan at %s — run 'ppsurvey plan' first" % plan_path)
        self.plan = SurveyPlan.load(plan_path)
        self.planned = [WorkQueue.key_for(info.path)
                        for info, _ in self.plan.archives()]
        self.planned_total = len(self.planned) + len(self.plan.unreadable)
        if est_worker_bytes is None:
            est_worker_bytes = max(
                (b.est_bytes() for b in self.plan.buckets), default=0)
        self.est_worker_bytes = int(est_worker_bytes or 0)

        policy = respawn_policy or RespawnPolicy(
            backoff_s=1.0, backoff_max_s=30.0, flap_count=3,
            flap_window_s=60.0)
        self.policy = policy
        self.slots = [_Slot(i, policy) for i in range(self.max_workers)]
        self._stop = False
        self._desired = self.min_workers
        self._last_scale = None      # (action, t)
        self.totals = {"spawned": 0, "respawns": 0, "parked": 0,
                       "scale_ups": 0, "scale_downs": 0}

    # -- observation ----------------------------------------------------

    def observe_survey(self, now=None):
        """One reconciliation input for :func:`decide`: slot states
        from the process table, work states from a readonly union
        replay (the same file-tail-tolerant view ``ppsurvey status``
        uses — no locks taken, safe against live workers)."""
        now = time.time() if now is None else now
        q = WorkQueue(None, readonly=True, union_dir=self.workdir,
                      workload=self.workload)
        counts = q.counts()
        settled = counts.get("done", 0) + counts.get("quarantined", 0)
        outstanding = max(0, self.planned_total - settled)
        ready = sum(1 for p in self.planned
                    if p not in q.entries or q.ready(p, now))
        expired_idx = set()
        for row in q.leases(now):
            if row.get("expired"):
                idx = owner_pid(row.get("owner"))
                if idx is not None:
                    expired_idx.add(idx)
        alerts = [a.get("rule") for a in obs_health.firing()]
        obsd = {
            "now": now,
            "ready": ready,
            "outstanding": outstanding,
            "counts": counts,
            "live": [s.index for s in self.slots if s.state == LIVE],
            "draining": [s.index for s in self.slots if s.draining],
            "parked": [s.index for s in self.slots
                       if s.state == PARKED],
            "empty": [s.index for s in self.slots if s.state == EMPTY],
            "dead": [{"slot": s.index,
                      "action": PARK if s.tracker.parked else "respawn",
                      "due": s.tracker.due(now)}
                     for s in self.slots if s.state == DEAD],
            "expired": sorted(
                i for i in expired_idx
                if i < len(self.slots)
                and self.slots[i].state == LIVE),
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "backlog_per_worker": self.backlog_per_worker,
            "mem_budget_bytes": self.mem_budget_bytes,
            "est_worker_bytes": self.est_worker_bytes,
            "alerts": alerts,
        }
        return obsd

    # -- actuation ------------------------------------------------------

    def _worker_cmd(self, slot):
        cmd = [sys.executable, "-m",
               "pulseportraiture_tpu_torch.cli.ppsurvey", "run",
               "-w", self.workdir,
               "--process", str(slot.index),
               "--processes", str(self.max_workers),
               "--lease", str(self.lease_s),
               "--device", self.device,
               "--no_merge"]
        if self.modelfile:
            cmd += ["-m", self.modelfile]
        if self.workload != DEFAULT_WORKLOAD:
            cmd += ["--workload", self.workload]
        if self.warm:
            cmd += ["--warm", self.warm]
        if self.compile_cache:
            cmd += ["--compile-cache", self.compile_cache]
        if self.quiet:
            cmd += ["--quiet"]
        cmd += self.worker_args
        return cmd

    def _spawn(self, slot, cause, now):
        """Launch one worker into ``slot``; an injected spawn fault
        counts as an instant death (backoff/flap chain), so the
        crash-loop machinery is testable without burning subprocesses."""
        env = dict(os.environ)
        if slot.spawn_count == 0:
            env.update(self.worker_env.get(slot.index, {}))
        else:
            # a respawn must come back clean: one-shot chaos clauses
            # (sigkill specs) died with the process they killed
            env.pop("PPTPU_FAULTS", None)
        slot.spawn_count += 1
        logdir = os.path.join(self.workdir, "supervisor")
        os.makedirs(logdir, exist_ok=True)
        log = open(os.path.join(logdir, "worker.%d.log" % slot.index),
                   "ab")
        try:
            faults.check("supervisor_spawn", key="w%d" % slot.index)
            slot.proc = subprocess.Popen(
                self._worker_cmd(slot), stdout=log,
                stderr=subprocess.STDOUT, env=env)
        except (faults.InjectedFault, OSError) as e:
            self._record_death(slot, now, returncode=None,
                               reason="spawn_failed: %s" % e)
            return False
        finally:
            log.close()
        slot.pid = slot.proc.pid
        slot.state = LIVE
        slot.draining = False
        slot.spawned_at = now
        self.totals["spawned"] += 1
        obs.event("supervisor_spawn", slot=slot.index, pid=slot.pid,
                  cause=cause, spawn_count=slot.spawn_count)
        if cause != "scale_up":
            self.totals["respawns"] += 1
            obs.counter("supervisor_respawns")
            metrics.inc(COUNTER_RESPAWNS, cause=cause)
        return True

    def _record_death(self, slot, now, returncode, reason):
        verdict = slot.tracker.record_death(now)
        obs.event("supervisor_worker_exit", slot=slot.index,
                  returncode=returncode, reason=reason,
                  strikes=verdict.get("strikes"),
                  verdict=verdict["action"])
        slot.proc = None
        slot.pid = None
        slot.draining = False
        if verdict["action"] == PARK:
            self._park(slot, verdict)
        else:
            slot.state = DEAD
        return verdict

    def _park(self, slot, verdict):
        slot.state = PARKED
        slot.draining = False
        self.totals["parked"] += 1
        obs.event("supervisor_flap", slot=slot.index,
                  deaths=verdict.get("deaths"),
                  window_s=verdict.get("window_s"))

    def _drain(self, slot, cause):
        if slot.proc is not None and slot.proc.poll() is None:
            try:
                slot.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
        slot.draining = True
        obs.event("supervisor_drain", slot=slot.index, cause=cause)

    def _kill(self, slot):
        if slot.proc is not None and slot.proc.poll() is None:
            try:
                slot.proc.kill()
                slot.proc.wait(timeout=10.0)
            except (OSError, subprocess.TimeoutExpired):
                pass

    def apply(self, actions, observed):
        """Actuate one decide() output; emits the scale events and
        counters that make the decision auditable."""
        now = observed.get("now") or time.time()
        ups = downs = 0
        for a in actions:
            slot = self.slots[a["slot"]]
            op, cause = a["op"], a.get("cause", "")
            if op == "park":
                self._park(slot, slot.tracker.state())
            elif op == "spawn":
                if self._spawn(slot, cause, now) \
                        and cause == "scale_up":
                    ups += 1
            elif op == "respawn":
                self._kill(slot)
                self._record_death(slot, now,
                                   returncode=slot.proc.returncode
                                   if slot.proc else None,
                                   reason=cause)
            elif op == "drain":
                self._drain(slot, cause)
                if cause == "scale_down":
                    downs += 1
        if ups:
            self.totals["scale_ups"] += 1
            obs.counter("supervisor_scale_events")
            metrics.inc(COUNTER_SCALE_EVENTS, direction="up")
            obs.event("supervisor_scale_up", n=ups,
                      live=len(observed.get("live") or ()) + ups,
                      ready=observed.get("ready"))
            self._last_scale = ("up", now)
            metrics.set_gauge(GAUGE_LAST_SCALE, now, action="up")
        if downs:
            self.totals["scale_downs"] += 1
            obs.counter("supervisor_scale_events")
            metrics.inc(COUNTER_SCALE_EVENTS, direction="down")
            obs.event("supervisor_scale_down", n=downs,
                      live=len(observed.get("live") or ()),
                      outstanding=observed.get("outstanding"))
            self._last_scale = ("down", now)
            metrics.set_gauge(GAUGE_LAST_SCALE, now, action="down")

    # -- the control loop -----------------------------------------------

    def _reap(self, now):
        """Fold exited subprocesses back into slot state.  A clean
        exit (rc 0, or any exit while draining) frees the slot; a
        dirty one feeds the crash-loop tracker."""
        for slot in self.slots:
            if slot.state != LIVE or slot.proc is None:
                continue
            rc = slot.proc.poll()
            if rc is None:
                continue
            uptime = now - (slot.spawned_at or now)
            if slot.draining or rc == 0:
                obs.event("supervisor_worker_exit", slot=slot.index,
                          returncode=rc, reason="clean",
                          uptime_s=round(uptime, 3),
                          drained=slot.draining)
                slot.state = EMPTY
                slot.proc = None
                slot.pid = None
                slot.draining = False
            else:
                self._record_death(slot, now, returncode=rc,
                                   reason="exit")

    def _publish_gauges(self):
        by_state = {LIVE: 0, PARKED: 0, DEAD: 0}
        for s in self.slots:
            if s.state in by_state:
                by_state[s.state] += 1
        metrics.set_gauge(GAUGE_WORKERS, self._desired, state="desired")
        metrics.set_gauge(GAUGE_WORKERS, by_state[LIVE], state="live")
        metrics.set_gauge(GAUGE_WORKERS, by_state[PARKED],
                          state="parked")
        metrics.set_gauge(GAUGE_WORKERS, by_state[DEAD], state="dead")

    def _request_stop(self, signum, frame):
        self._stop = True

    def run(self):
        """Supervise until the survey settles.  Returns the summary
        (also printed by ``ppsurvey supervise``)."""
        t0 = time.time()
        stopped_by = None
        old_term = old_int = None
        if threading.current_thread() is threading.main_thread():
            old_term = signal.signal(signal.SIGTERM, self._request_stop)
            old_int = signal.signal(signal.SIGINT, self._request_stop)
        shards_dir = os.path.join(self.workdir, "obs_shards")
        run_dir = None
        try:
            with obs.run("ppsupervisor",
                         base_dir=os.path.join(self.workdir, "obs"),
                         config={"min_workers": self.min_workers,
                                 "max_workers": self.max_workers,
                                 "backlog_per_worker":
                                     self.backlog_per_worker,
                                 "lease_s": self.lease_s,
                                 "mem_budget_bytes":
                                     self.mem_budget_bytes,
                                 "est_worker_bytes":
                                     self.est_worker_bytes,
                                 "workload": self.workload}) as rec:
                run_dir = rec.dir if rec is not None else None
                obs.event("supervisor_started", workdir=self.workdir,
                          planned=self.planned_total,
                          min_workers=self.min_workers,
                          max_workers=self.max_workers)
                ticks = 0
                observed = self.observe_survey()
                while True:
                    now = time.time()
                    self._reap(now)
                    if self._stop:
                        stopped_by = "signal"
                        break
                    observed = self.observe_survey(now)
                    actions = decide(observed)
                    self._desired = max(0, (
                        len(observed["live"])
                        + sum(1 for a in actions
                              if a["op"] == "spawn")
                        - sum(1 for a in actions
                              if a["op"] == "drain")))
                    self.apply(actions, observed)
                    self._publish_gauges()
                    obs_memory.watermarks()
                    obs_health.evaluate(now)
                    live = [s for s in self.slots if s.state == LIVE]
                    if observed["outstanding"] <= 0 and not live:
                        break
                    if not live and all(s.state == PARKED
                                        for s in self.slots):
                        # every slot flapped out: degrade honestly
                        # instead of spinning on an unwinnable survey
                        stopped_by = "all_parked"
                        break
                    ticks += 1
                    if self.max_ticks is not None \
                            and ticks >= self.max_ticks:
                        stopped_by = "max_ticks"
                        break
                    time.sleep(self.interval_s)
                if stopped_by in ("signal", "max_ticks"):
                    # hand the survey back intact: drain the workers
                    # (their in-flight archives finish), then leave —
                    # a plain `ppsurvey resume` continues from here
                    for slot in self.slots:
                        if slot.state == LIVE:
                            self._drain(slot, cause="supervisor_stop")
                self._wait_drain()
                self._publish_gauges()
                observed = self.observe_survey()
                obs.event("supervisor_stopped",
                          stopped_by=stopped_by or "complete",
                          outstanding=observed["outstanding"],
                          wall_s=round(time.time() - t0, 3),
                          **self.totals)
        finally:
            if old_term is not None:
                signal.signal(signal.SIGTERM, old_term)
            if old_int is not None:
                signal.signal(signal.SIGINT, old_int)
        if run_dir is not None:
            # publish the audit trail as one more obs shard (one slot
            # past the worker indices) and merge, so `ppsurvey report`
            # shows the supervisor's decisions next to the fits
            write_shard(run_dir, shards_dir, self.max_workers)
            try:
                merge_obs_shards(shards_dir,
                                 os.path.join(self.workdir,
                                              "obs_merged"))
            except FileNotFoundError:
                pass
        counts = observed.get("counts", {})
        return {"stopped_by": stopped_by or "complete",
                "counts": counts,
                "outstanding": observed["outstanding"],
                "workers": dict(self.totals),
                "parked_slots": [s.index for s in self.slots
                                 if s.state == PARKED],
                "wall_s": round(time.time() - t0, 3)}

    def _wait_drain(self):
        """Bounded wait for draining/live workers to exit; anything
        still alive past the grace window is left running (it keeps
        the survey safe — the ledger protects against double fits)."""
        deadline = time.time() + self.drain_grace_s
        for slot in self.slots:
            if slot.proc is None or slot.state != LIVE:
                continue
            left = deadline - time.time()
            try:
                slot.proc.wait(timeout=max(0.1, left))
            except subprocess.TimeoutExpired:
                obs.event("supervisor_drain_timeout", slot=slot.index,
                          pid=slot.pid)
                continue
            slot.state = EMPTY
            slot.proc = None


def supervise(workdir, **kw):
    """Convenience wrapper: build a Supervisor and run it."""
    return Supervisor(workdir, **kw).run()
