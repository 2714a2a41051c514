"""Live health plane: declarative alert rules over streaming metrics.

Every obs plane before this one (events, metrics, tracing, memory,
quality) is a passive recorder consumed *after* a run; this module is
the part of the system that can say "this run is unhealthy *right
now*" while it is still running — the probe surface a router or an
autoscaler consumes, and the trigger that makes the
flight recorder (:mod:`.flight`) dump a postmortem the moment things
go sideways.

**Rules** are declarative dicts evaluated over a sliding window of
registry snapshots (:class:`~.metrics.MetricsRegistry`).  Four kinds:

* ``threshold`` — a gauge's current value against a limit, optionally
  derived from a budget gauge (``budget_frac`` × ``budget_gauge``);
* ``rate`` — a windowed counter delta against a limit, optionally
  gated on a gauge (``guard_gauge``) and/or on another counter family
  staying quiet (``quiet``);
* ``ratio`` — windowed delta of ``num`` counters over ``den``
  counters, with a ``min_den`` sample floor;
* ``burn_rate`` — :func:`~.metrics.evaluate_slo` re-applied to the
  *window's* request deltas and latency-histogram delta, so an SLO
  breach is detected while it burns instead of at the end of the run.

**Lifecycle** per rule: ``ok`` → ``pending`` (predicate true) →
``firing`` (true for ``for_s`` continuously; emits ``alert_firing``,
bumps the ``alerts_fired`` manifest counter and the
``pps_alerts_total`` metric, raises the ``pps_alerts_firing`` gauges
and dumps a flight-recorder postmortem) → back to ``ok`` on recovery
(emits ``alert_resolved``, bumps ``alerts_resolved``).  The bare
``pps_alerts_firing`` gauge is the count of firing rules; the
rule-labeled series are 1/0 flags so watch views can name them.

**Cadence**: the metrics exporter calls :meth:`HealthState.evaluate`
on every snapshot tick; a driver loop may call it on demand.  Everything here is never
fatal, host-side only, and disabled at one attribute
read when no run is active — the standing obs contract.
``PPTPU_HEALTH=0`` turns the plane off; ``PPTPU_HEALTH_RULES``
overlays rule fields (JSON) or appends custom rules.
"""

import collections
import json
import os
import time

from . import core as _core
from .metrics import PHASE_HISTOGRAM, Histogram, evaluate_slo, \
    parse_series

__all__ = ["BUILTIN_RULES", "HealthState", "health_enabled",
           "health_rules", "evaluate", "firing"]

# gauge published by budget-aware hosts (the JAX package's service) that the
# memory_watermark rule prices device usage against; absent = the rule
# stays quiet (no budget, no watermark)
BUDGET_GAUGE = "pps_mem_budget_bytes"

# gauge set once warm-up finishes (the JAX package's runner and service):
# the compile_cache_postwarm guard — a miss during
# warm-up is the expected cold compile, a miss after it is a leak
WARM_GAUGE = "pps_warm_complete"

BUILTIN_RULES = (
    {"name": "quarantine_spike", "kind": "rate", "severity": "critical",
     "signal": ("pps_quarantined_total",),
     "op": ">=", "threshold": 3, "window_s": 120.0, "for_s": 0.0,
     "summary": "archives/requests quarantined faster than the "
                "poison-pill baseline"},
    {"name": "retry_burn", "kind": "rate", "severity": "warning",
     "signal": ("pps_retries_total",),
     "op": ">=", "threshold": 10, "window_s": 120.0, "for_s": 0.0,
     "summary": "request retries burning through attempt budgets"},
    {"name": "lease_expiry_spike", "kind": "rate",
     "severity": "warning",
     "signal": ("pps_lease_expirations_total",),
     "op": ">=", "threshold": 3, "window_s": 120.0, "for_s": 0.0,
     "summary": "workers losing leases (stalls, kills, clock pressure)"},
    {"name": "memory_watermark", "kind": "threshold",
     "severity": "critical",
     "gauge": "pps_device_bytes_in_use",
     "budget_gauge": BUDGET_GAUGE, "budget_frac": 0.9,
     "op": ">=", "window_s": 60.0, "for_s": 0.0,
     "summary": "device memory above 90% of the configured budget"},
    {"name": "slo_burn", "kind": "burn_rate", "severity": "critical",
     "slo": {"max_error_rate": 0.5}, "min_requests": 4,
     "window_s": 120.0, "for_s": 0.0,
     "summary": "request error rate burning the SLO inside the window"},
    {"name": "bad_fit_drift", "kind": "ratio", "severity": "warning",
     "num": ("pps_quality_bad_subints_total",),
     "den": ("pps_quality_subints_total",), "min_den": 8,
     "op": ">=", "threshold": 0.5, "window_s": 300.0, "for_s": 0.0,
     "summary": "bad-fit rate drifting above half of recent subints"},
    {"name": "prefetch_stall", "kind": "rate", "severity": "warning",
     "signal": ("pps_prefetch_misses",),
     "quiet": ("pps_prefetch_hits",),
     "op": ">=", "threshold": 2, "window_s": 120.0, "for_s": 0.0,
     "summary": "prefetch missing with zero hits: the pipeline is "
                "IO-bound on a stalled prefetcher"},
    {"name": "compile_cache_postwarm", "kind": "rate",
     "severity": "warning",
     "signal": ("pps_compile_cache_misses_total",),
     "op": ">=", "threshold": 1, "window_s": 120.0, "for_s": 0.0,
     "guard_gauge": WARM_GAUGE, "guard_value": 1,
     "summary": "compile-cache misses after warm-up: the zero-cold-"
                "start contract is leaking compiles"},
    {"name": "daemon_churn", "kind": "rate", "severity": "warning",
     "signal": ("pps_respawns_total",),
     "op": ">=", "threshold": 2, "window_s": 300.0, "for_s": 0.0,
     "summary": "fleet daemons respawning repeatedly (crash-looping "
                "replica or poisoned bucket)"},
    {"name": "worker_churn", "kind": "rate", "severity": "warning",
     "signal": ("pps_supervisor_respawns_total",),
     "op": ">=", "threshold": 3, "window_s": 300.0, "for_s": 0.0,
     "summary": "survey workers respawning repeatedly under the "
                "supervisor (respawn storm; flapping slots park)"},
    # the quota plane (obs/usage.py) publishes pps_quota_burn as the
    # UNLABELED max used/limit fraction across budgeted tenants (the
    # per-tenant fractions live under a different name on purpose:
    # a threshold rule sums label variants); absent = no quotas, quiet
    {"name": "quota_burn", "kind": "threshold", "severity": "warning",
     "gauge": "pps_quota_burn",
     "op": ">=", "threshold": 0.85, "window_s": 60.0, "for_s": 0.0,
     "summary": "a tenant burned 85% of its usage quota: hard shed "
                "is imminent"},
)

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

# window samples kept beyond the largest rule window (slack for jitter)
_PRUNE_SLACK_S = 60.0


def health_enabled():
    """False when PPTPU_HEALTH=0 turned the plane off."""
    return os.environ.get("PPTPU_HEALTH", "").strip() != "0"


def health_rules():
    """The effective rule list: built-ins with the
    ``PPTPU_HEALTH_RULES`` JSON overlay applied.  A dict overlay maps
    rule name → field overrides (``{"disabled": true}`` drops a rule);
    a list overlay appends full custom rules.  Unparsable overlays are
    ignored — never fatal."""
    rules = [dict(r) for r in BUILTIN_RULES]
    raw = os.environ.get("PPTPU_HEALTH_RULES", "").strip()
    if not raw:
        return rules
    try:
        overlay = json.loads(raw)
    except (json.JSONDecodeError, ValueError):
        return rules
    if isinstance(overlay, dict):
        out = []
        for r in rules:
            ov = overlay.get(r["name"])
            if isinstance(ov, dict):
                r.update(ov)
            if not r.get("disabled"):
                out.append(r)
        return out
    if isinstance(overlay, list):
        for r in overlay:
            if isinstance(r, dict) and r.get("name") and r.get("kind"):
                rules.append(dict(r))
    return rules


class _Sample:
    """One windowed registry snapshot (the health plane's unit of
    history)."""

    __slots__ = ("t", "counters", "gauges", "hists")

    def __init__(self, t, snap):
        self.t = t
        self.counters = snap.get("counters") or {}
        self.gauges = snap.get("gauges") or {}
        self.hists = snap.get("histograms") or {}


def _series_sum(store, specs):
    """Sum every series in ``store`` whose base name (merge prefixes
    stripped) matches one of ``specs``; a spec is a bare name or a
    ``(name, {label: value})`` filter.  None when no series matched —
    absent is not zero (a pre-plane snapshot must not fire rules)."""
    total = None
    for key, v in store.items():
        name, labels = parse_series(key.rsplit("/", 1)[-1])
        for spec in specs:
            if isinstance(spec, (tuple, list)) and len(spec) == 2:
                want, want_labels = spec
            else:
                want, want_labels = spec, None
            if name != want:
                continue
            if want_labels and any(labels.get(k) != str(val)
                                   for k, val in want_labels.items()):
                continue
            try:
                total = (total or 0.0) + float(v)
            except (TypeError, ValueError):
                pass
            break
    return total


class HealthState:
    """Windowed rule evaluation + alert lifecycle for one
    :class:`~.core.Recorder`."""

    def __init__(self, recorder, rules=None):
        self._rec = recorder
        self.rules = list(rules) if rules is not None else \
            health_rules()
        max_w = max([float(r.get("window_s", 0.0) or 0.0)
                     for r in self.rules] or [0.0])
        self._keep_s = max_w + _PRUNE_SLACK_S
        self._samples = collections.deque()
        # rule name -> {"state", "since", "fired_t", "measured"}
        self._states = {r["name"]: {"state": "ok", "since": None,
                                    "fired_t": None, "measured": None}
                        for r in self.rules}
        self._evaluating = False

    # -- window ---------------------------------------------------------

    def _baseline(self, now, window_s):
        """The newest sample at least ``window_s`` old, else the
        oldest available (a partial window on young runs — deltas
        start at zero, so a restart never back-fires a rate rule)."""
        cutoff = now - float(window_s)
        base = self._samples[0]
        for s in self._samples:
            if s.t <= cutoff:
                base = s
            else:
                break
        return base

    def _delta(self, store_attr, specs, now, window_s):
        cur = self._samples[-1]
        base = self._baseline(now, window_s)
        a = _series_sum(getattr(base, store_attr), specs)
        b = _series_sum(getattr(cur, store_attr), specs)
        if b is None:
            return None
        return b - (a or 0.0)

    # -- predicates -----------------------------------------------------

    def _predicate(self, rule, now):
        """(is_breaching, measured) for one rule against the current
        window; unknown kinds and absent signals read as healthy."""
        kind = rule.get("kind")
        op = _OPS.get(rule.get("op", ">="), _OPS[">="])
        window_s = float(rule.get("window_s", 120.0) or 120.0)
        if kind == "threshold":
            cur = self._samples[-1]
            val = _series_sum(cur.gauges, (rule["gauge"],))
            limit = rule.get("threshold")
            bg = rule.get("budget_gauge")
            if bg:
                budget = _series_sum(cur.gauges, (bg,))
                if not budget:
                    return False, {"value": val, "limit": None}
                limit = float(rule.get("budget_frac", 0.9)) * budget
            if val is None or limit is None:
                return False, {"value": val, "limit": limit}
            return op(val, float(limit)), {"value": val,
                                           "limit": float(limit)}
        if kind == "rate":
            delta = self._delta("counters", rule["signal"], now,
                                window_s)
            measured = {"delta": delta, "window_s": window_s,
                        "limit": rule.get("threshold")}
            if delta is None:
                return False, measured
            gg = rule.get("guard_gauge")
            if gg is not None:
                gv = _series_sum(self._samples[-1].gauges, (gg,))
                measured["guard"] = gv
                if gv != rule.get("guard_value", 1):
                    return False, measured
            quiet = rule.get("quiet")
            if quiet:
                qd = self._delta("counters", quiet, now, window_s)
                measured["quiet_delta"] = qd
                if qd:
                    return False, measured
            return op(delta, float(rule.get("threshold", 1))), measured
        if kind == "ratio":
            num = self._delta("counters", rule["num"], now, window_s)
            den = self._delta("counters", rule["den"], now, window_s)
            measured = {"num": num, "den": den,
                        "limit": rule.get("threshold"),
                        "window_s": window_s}
            if not den or den < float(rule.get("min_den", 1)):
                return False, measured
            ratio = (num or 0.0) / den
            measured["ratio"] = round(ratio, 6)
            return op(ratio, float(rule.get("threshold", 1.0))), \
                measured
        if kind == "burn_rate":
            return self._burn_rate(rule, now, window_s)
        return False, {}

    def _burn_rate(self, rule, now, window_s):
        cur = self._samples[-1]
        base = self._baseline(now, window_s)
        ok = err = 0
        for key, v in cur.counters.items():
            name, labels = parse_series(key.rsplit("/", 1)[-1])
            if name != "pps_requests_total":
                continue
            prev = base.counters.get(key, 0) or 0
            try:
                d = float(v) - float(prev)
            except (TypeError, ValueError):
                continue
            if labels.get("outcome") == "done":
                ok += d
            else:
                err += d
        span = max(1e-9, cur.t - base.t)
        measured = {"n_ok": int(ok), "n_err": int(err),
                    "window_s": window_s}
        total = ok + err
        if total < int(rule.get("min_requests", 1)):
            return False, measured
        hist = self._phase_hist_delta(cur, base,
                                      rule.get("phase", "total"))
        res = evaluate_slo(rule.get("slo") or {}, hist, ok, err, span)
        measured.update(res["measured"])
        measured["breaches"] = [b["slo"] for b in res["breaches"]]
        return (not res["ok"]), measured

    def _phase_hist_delta(self, cur, base, phase):
        """Window delta of the ``pps_phase_seconds{phase=...}``
        histograms as one snapshot dict (exact integer bucket
        subtraction — the same fixed-geometry property the shard merge
        relies on), or None when the phase has no series."""
        def collect(sample):
            h = None
            for key, snap in sample.hists.items():
                name, labels = parse_series(key.rsplit("/", 1)[-1])
                if name != PHASE_HISTOGRAM or \
                        labels.get("phase") != phase:
                    continue
                hh = Histogram.from_snapshot(snap)
                h = hh if h is None else h.merge(hh)
            return h
        cur_h = collect(cur)
        if cur_h is None:
            return None
        if cur is not base:
            old = collect(base)
            if old is not None:
                for i, c in old.counts.items():
                    cur_h.counts[i] = cur_h.counts.get(i, 0) - c
                cur_h.counts = {i: c for i, c in cur_h.counts.items()
                                if c > 0}
                cur_h.under -= old.under
                cur_h.over -= old.over
                cur_h.count -= old.count
                cur_h.sum -= old.sum
        return cur_h.to_snapshot()

    # -- lifecycle ------------------------------------------------------

    def evaluate(self, now=None):
        """Take one registry sample and advance every rule's
        lifecycle; returns the currently firing alerts.  Never raises
        — a broken rule reads as healthy, not as a crashed pipeline."""
        try:
            return self._evaluate(now)
        except Exception:
            return self.firing()

    def _evaluate(self, now):
        rec = self._rec
        reg = rec._metrics
        if reg is None or self._evaluating:
            return []
        now = float(now) if now is not None else time.time()
        # single-flight: the exporter tick, the claim cycle and the
        # health verb may race; one sampler at a time is plenty and
        # transitions stay single-threaded
        self._evaluating = True
        try:
            self._samples.append(_Sample(now, reg.snapshot()))
            while len(self._samples) > 1 and \
                    self._samples[0].t < now - self._keep_s:
                self._samples.popleft()
            transitions = []
            for rule in self.rules:
                st = self._states[rule["name"]]
                try:
                    breaching, measured = self._predicate(rule, now)
                except Exception as exc:
                    # per-rule isolation: one malformed rule must read
                    # as healthy without wedging the rules after it
                    breaching, measured = \
                        False, {"error": type(exc).__name__}
                st["measured"] = measured
                if breaching:
                    if st["state"] == "ok":
                        st["state"] = "pending"
                        st["since"] = now
                    if st["state"] == "pending" and \
                            now - st["since"] >= \
                            float(rule.get("for_s", 0.0) or 0.0):
                        st["state"] = "firing"
                        st["fired_t"] = now
                        transitions.append(("firing", rule, st))
                else:
                    if st["state"] == "firing":
                        transitions.append(("resolved", rule, st))
                    st["state"] = "ok"
                    st["since"] = None
            self._apply(transitions, reg, now)
            reg.set_gauge("pps_alerts_firing", sum(
                1 for s in self._states.values()
                if s["state"] == "firing"))
        finally:
            self._evaluating = False
        return self.firing()

    def _apply(self, transitions, reg, now):
        """Emit the lifecycle events/metrics for this pass's
        transitions, then trigger postmortems — the ``alert_firing``
        event lands in the ring before the bundle freezes it."""
        rec = self._rec
        for what, rule, st in transitions:
            name = rule["name"]
            if what == "firing":
                rec.event("alert_firing", rule=name,
                          severity=rule.get("severity", "warning"),
                          summary=rule.get("summary"),
                          measured=st["measured"])
                rec.counter("alerts_fired")
                reg.inc("pps_alerts_total", rule=name)
                reg.set_gauge("pps_alerts_firing", 1, rule=name)
            else:
                rec.event("alert_resolved", rule=name,
                          severity=rule.get("severity", "warning"),
                          firing_s=round(now - (st["fired_t"]
                                                or now), 6))
                rec.counter("alerts_resolved")
                reg.set_gauge("pps_alerts_firing", 0, rule=name)
        for what, rule, st in transitions:
            if what == "firing":
                rec.flight.dump("alert:%s" % rule["name"],
                                context={"rule": rule["name"],
                                         "severity": rule.get(
                                             "severity"),
                                         "measured": st["measured"]})

    def firing(self):
        """The currently firing alerts as JSON-ready dicts."""
        out = []
        for rule in self.rules:
            st = self._states[rule["name"]]
            if st["state"] != "firing":
                continue
            out.append({"rule": rule["name"],
                        "severity": rule.get("severity", "warning"),
                        "summary": rule.get("summary"),
                        "since": st["fired_t"],
                        "measured": st["measured"]})
        return out

    def states(self):
        """{rule name: lifecycle state} — the readiness surface."""
        return {name: dict(st) for name, st in self._states.items()}

    def stop(self):
        """Final evaluation at recorder close, so the last
        metrics.jsonl snapshot carries the closing alert gauges."""
        self.evaluate()


# -- module-level helpers (the instrumented-code API) -------------------


def evaluate(now=None):
    """Evaluate the active run's health rules (claim-cycle hook);
    returns the firing alerts, or None when no run is active /
    health is disabled — one attribute read on the disabled path."""
    rec = _core._active
    if rec is None:
        return None
    hs = rec.health_state()
    return hs.evaluate(now=now) if hs is not None else None


def firing():
    """The active run's firing alerts ([] when inactive/disabled)."""
    rec = _core._active
    if rec is None:
        return []
    hs = rec.health_state()
    return hs.firing() if hs is not None else []
