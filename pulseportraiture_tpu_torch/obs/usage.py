"""Per-tenant usage metering, cost attribution and quotas.

A copy of the JAX package's module, which meters its TOA service and
fleet.  Tenant attribution in transient metric labels alone does not
durably answer "what did tenant X consume, and when do we cut them
off?".  This module completes the plane series (seconds → spans, bytes → memory,
correctness → quality, liveness → health) with the observable
operators bill and budget on: **resource-seconds per tenant**.

* **Usage ledger** — every unit of work (a service request, a fleet
  forward, a survey archive) is metered by :func:`meter` into one
  JSON record per unit, appended to ``<run>/usage.jsonl``.  Records
  carry ``(tenant, bucket, workload)`` attribution plus additive
  measures (wall-seconds, device-seconds from the fit-phase spans,
  peak bytes from the memory plane, archives fitted, compiles
  triggered, bytes decoded).  The ledger shares the obs sinks'
  discipline: size rotation (``PPTPU_OBS_MAX_BYTES``), torn-tail
  tolerant read-back (:func:`read_usage` skips the unparsable last
  line a SIGKILL leaves), never fatal (a failed append drops the
  record, bills the in-memory aggregate anyway), and exact shard
  merge — records are order-independent and rollups are pure sums,
  so fleet-merged and multi-process totals are integer/float-exact.
* **Live counters** — ``pps_usage_records_total{tenant=}`` /
  ``pps_usage_device_seconds_total{tenant=}`` /
  ``pps_usage_wall_seconds_total{tenant=}`` /
  ``pps_usage_bytes_decoded_total{tenant=}`` ride the streaming
  metrics registry, so the fleet ``metrics`` verb merges per-tenant
  usage across daemons for free and ``--watch`` gets a usage row.
* **Quotas** — per-tenant budgets (``PPTPU_QUOTAS`` JSON /
  ``--quotas``) over the :data:`RESOURCES` measures.  Enforcement
  points (daemon submit, router admission) call :func:`check` against
  the *local* metered totals; exhaustion surfaces first as the
  ``quota_burn`` health rule (the ``pps_quota_burn`` gauge crosses
  its threshold → pending → firing) and then as a hard shed.  With
  no run active :func:`check` admits — quotas are an observability
  feature and obey "disabled = free".

Host-side only, never fatal, disabled = free: with no
run active every module-level helper is one attribute read + ``None``
check.
"""

import json
import os
import threading
import time

from ..testing import faults
from . import core as _core

__all__ = ["SCHEMA", "RESOURCES", "UsageState", "meter", "check",
           "configure_quotas", "parse_quotas", "quotas_from_env",
           "totals", "usage_files", "read_usage", "rollup",
           "quota_burn_fraction"]

# every usage.jsonl line carries this schema tag; a field change is a
# schema change (readers key on it to skip foreign lines)
SCHEMA = "pptpu-usage-v1"

# quota-able resources: keys of a PPTPU_QUOTAS per-tenant budget dict.
# Each maps onto one additive measure of the tenant rollup.
RESOURCES = ("device_seconds", "wall_seconds", "requests", "archives",
             "bytes_decoded")

# rollup measure each quota resource is charged against
_RESOURCE_KEY = {"device_seconds": "device_s",
                 "wall_seconds": "wall_s",
                 "requests": "requests",
                 "archives": "archives",
                 "bytes_decoded": "bytes_decoded"}

# the additive measures of one usage record (rollups sum exactly these)
_MEASURES = ("wall_s", "device_s", "peak_bytes", "archives",
             "compiles", "bytes_decoded")

# tenant attribution for un-attributed work (local survey runs)
LOCAL_TENANT = "_local"


def parse_quotas(spec):
    """Parse a quota spec into ``{tenant: {resource: float}}``.

    ``spec`` is a dict or a JSON object text: tenant → budget, where a
    budget is either a scalar (shorthand for ``device_seconds``) or a
    dict over :data:`RESOURCES`.  Raises ValueError on malformed JSON
    or unknown resource names — a quota typo must fail the daemon at
    start, not silently admit forever.
    """
    if spec is None:
        return {}
    if isinstance(spec, str):
        spec = spec.strip()
        if not spec:
            return {}
        try:
            spec = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ValueError("quotas: not valid JSON: %s" % e)
    if not isinstance(spec, dict):
        raise ValueError("quotas: expected an object "
                         "{tenant: budget}, got %r" % type(spec).__name__)
    out = {}
    for tenant, budget in spec.items():
        if isinstance(budget, (int, float)):
            budget = {"device_seconds": budget}
        if not isinstance(budget, dict):
            raise ValueError("quotas[%r]: budget must be a number or "
                             "an object over %s" % (tenant, ", ".join(
                                 RESOURCES)))
        limits = {}
        for res, lim in budget.items():
            if res not in RESOURCES:
                raise ValueError("quotas[%r]: unknown resource %r "
                                 "(known: %s)" % (tenant, res,
                                                  ", ".join(RESOURCES)))
            limits[res] = float(lim)
        if limits:
            out[str(tenant)] = limits
    return out


def quotas_from_env():
    """``$PPTPU_QUOTAS`` parsed, or ``{}`` when unset/unparsable (a
    broken env var must not kill a daemon that never opted in)."""
    try:
        return parse_quotas(os.environ.get("PPTPU_QUOTAS", ""))
    except ValueError:
        return {}


class UsageState:
    """Per-recorder usage accounting.

    Created lazily by :meth:`~.core.Recorder.usage_state` on the first
    metered unit (a run that serves nothing costs nothing) and stopped
    by ``Recorder.close()``, which writes the run totals into the
    manifest gauges bench and obs_diff read back.  The ledger file
    inherits the recorder's rotation threshold; the per-tenant
    counters live in the run's streaming-metrics registry, so fleet
    merge and ``--watch`` rendering are inherited, not reimplemented.
    """

    def __init__(self, recorder):
        self._recorder = recorder
        self._lock = threading.Lock()
        self.path = os.path.join(recorder.dir, "usage.jsonl")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._max_bytes = recorder._max_bytes
        try:
            self._bytes = os.path.getsize(self.path)
        except OSError:
            self._bytes = 0
        self._rot_seq = 0
        self.n_records = 0
        self.dropped_records = 0
        # (tenant, bucket, workload) → {measure: sum, "records": n}
        self._groups = {}
        # tenant → {measure: sum, "records": n, "requests": n}
        self._tenants = {}
        # parsed quota table (configure_quotas); {} = no enforcement
        self.quotas = {}
        self._reg = recorder.metrics_registry()

    # -- metering -------------------------------------------------------

    def record(self, kind, tenant, bucket="-", workload="-",
               wall_s=0.0, device_s=0.0, peak_bytes=0, archives=0,
               compiles=0, bytes_decoded=0, **extra):
        """Meter one unit of work: append the ledger record, fold the
        in-memory rollup, bump the per-tenant counters.  Never raises;
        a failed append drops the *record* but still bills the
        aggregate (the quota plane must not lose billing to a full
        disk)."""
        tenant = str(tenant or LOCAL_TENANT)
        rec = {"t": round(time.time(), 6), "schema": SCHEMA,
               "kind": kind, "tenant": tenant,
               "bucket": bucket or "-", "workload": workload or "-",
               "wall_s": round(float(wall_s), 6),
               "device_s": round(float(device_s), 6),
               "peak_bytes": int(peak_bytes or 0),
               "archives": int(archives or 0),
               "compiles": int(compiles or 0),
               "bytes_decoded": int(bytes_decoded or 0)}
        rec.update(extra)
        try:
            line = json.dumps(rec, default=_core._json_default)
        except Exception:
            return None
        with self._lock:
            try:
                # chaos site shared with the event sink: a full disk
                # fails the usage ledger the same way (key "usage"
                # lets a spec target just this sink)
                faults.check("obs_write", key="usage")
                if self._max_bytes and self._bytes and \
                        self._bytes + len(line) + 1 > self._max_bytes:
                    self._rotate()
                # the ledger append IS the critical section
                self._fh.write(line + "\n")
                self._fh.flush()  # bounded flush of one line
                self._bytes += len(line) + 1
            except (OSError, ValueError, faults.InjectedFault):
                self.dropped_records += 1
            self.n_records += 1
            gkey = (tenant, rec["bucket"], rec["workload"])
            g = self._groups.get(gkey)
            if g is None:
                g = self._groups[gkey] = dict.fromkeys(_MEASURES, 0)
                g["records"] = 0
            t = self._tenants.get(tenant)
            if t is None:
                t = self._tenants[tenant] = dict.fromkeys(_MEASURES, 0)
                t["records"] = t["requests"] = 0
            for m in _MEASURES:
                g[m] += rec[m]
                t[m] += rec[m]
            g["records"] += 1
            t["records"] += 1
            if kind in ("request", "forward"):
                t["requests"] += 1
        reg = self._reg
        reg.inc("pps_usage_records_total", tenant=tenant)
        if rec["wall_s"]:
            reg.inc("pps_usage_wall_seconds_total", rec["wall_s"],
                    tenant=tenant)
        if rec["device_s"]:
            reg.inc("pps_usage_device_seconds_total", rec["device_s"],
                    tenant=tenant)
        if rec["bytes_decoded"]:
            reg.inc("pps_usage_bytes_decoded_total",
                    rec["bytes_decoded"], tenant=tenant)
        self._recorder.bump("usage_records")
        if self.quotas:
            self._publish_burn()
        return rec

    def _rotate(self):
        """Move the live ledger aside as ``usage.jsonl.<n>`` (caller
        holds the lock); same convention as the event sink so
        :func:`usage_files` reads the set back oldest-first."""
        self._rot_seq += 1
        try:
            self._fh.close()
            os.replace(self.path, "%s.%d" % (self.path, self._rot_seq))
        except OSError:
            pass
        self._fh = open(self.path, "a", encoding="utf-8")
        try:
            self._bytes = os.path.getsize(self.path)
        except OSError:
            self._bytes = 0

    # -- quotas ---------------------------------------------------------

    def set_quotas(self, quotas):
        with self._lock:
            self.quotas = dict(quotas or {})
        if self.quotas:
            self._publish_burn()

    def _tenant_used(self, tenant, resource):
        # caller holds the lock
        t = self._tenants.get(tenant)
        if t is None:
            return 0.0
        return float(t.get(_RESOURCE_KEY[resource], 0) or 0)

    def check(self, tenant, quotas=None):
        """The first exhausted ``{"quota", "limit", "used"}`` breach
        for ``tenant`` against the LOCAL metered totals, or None to
        admit.  A tenant with no budget row is unlimited."""
        tenant = str(tenant or LOCAL_TENANT)
        with self._lock:
            limits = (quotas if quotas is not None else
                      self.quotas).get(tenant)
            if not limits:
                return None
            for res in RESOURCES:
                lim = limits.get(res)
                if lim is None:
                    continue
                used = self._tenant_used(tenant, res)
                if used >= lim:
                    return {"quota": res, "limit": lim,
                            "used": round(used, 6)}
        return None

    def burn_fraction(self, tenant=None):
        """Max used/limit fraction over every budgeted resource — of
        one tenant, or (``tenant=None``) across all budgeted tenants.
        0.0 when nothing is budgeted."""
        with self._lock:
            tenants = [tenant] if tenant is not None else \
                list(self.quotas)
            frac = 0.0
            for ten in tenants:
                limits = self.quotas.get(ten)
                if not limits:
                    continue
                for res, lim in limits.items():
                    if lim <= 0:
                        return 1.0
                    frac = max(frac,
                               self._tenant_used(ten, res) / lim)
        return frac

    def _publish_burn(self):
        """Quota-burn gauges: the UNLABELED ``pps_quota_burn`` (max
        fraction across tenants — the ``quota_burn`` health rule's
        input; per-tenant fractions must not share its name or the
        rule's label-summing would add them) plus the per-tenant
        ``pps_quota_used_frac{tenant=}`` diagnostics."""
        reg = self._reg
        burn = 0.0
        with self._lock:
            quotas = dict(self.quotas)
        for tenant in quotas:
            frac = self.burn_fraction(tenant)
            burn = max(burn, frac)
            reg.set_gauge("pps_quota_used_frac", round(frac, 6),
                          tenant=tenant)
        reg.set_gauge("pps_quota_burn", round(burn, 6))

    # -- read side ------------------------------------------------------

    def totals(self):
        """``{"records", "tenants": {tenant: sums}}`` — the run's
        in-memory rollup (runner summary extras, quota introspection).
        """
        with self._lock:
            return {"records": self.n_records,
                    "dropped_records": self.dropped_records,
                    "tenants": {t: dict(v) for t, v in
                                sorted(self._tenants.items())}}

    def stop(self):
        """Run end: totals become manifest gauges (the summary bench /
        obs_diff / obs_report read back without parsing the ledger)."""
        if self.n_records:
            rec = self._recorder
            dev = wall = 0.0
            with self._lock:
                for t in self._tenants.values():
                    dev += t["device_s"]
                    wall += t["wall_s"]
            rec.set_gauge("usage_records_total", self.n_records)
            rec.set_gauge("usage_device_seconds_total", round(dev, 6))
            rec.set_gauge("usage_wall_seconds_total", round(wall, 6))
        with self._lock:
            try:
                self._fh.close()
            except OSError:
                pass


# -- module-level helpers (the instrumented-code API) -------------------


def _state():
    rec = _core._active
    if rec is None:
        return None
    return rec.usage_state()


def meter(kind, tenant=None, bucket=None, workload=None, wall_s=0.0,
          device_s=0.0, peak_bytes=0, archives=0, compiles=0,
          bytes_decoded=0, **extra):
    """Meter one unit of work into the active run's usage ledger.

    ``kind`` names the unit (``request`` — one service fit,
    ``forward`` — one router forward, ``archive`` — one survey
    archive).  Returns the ledger record, or None when no run is
    active.  Never fatal."""
    st = _state()
    if st is None:
        return None
    try:
        return st.record(kind, tenant, bucket=bucket or "-",
                         workload=workload or "-", wall_s=wall_s,
                         device_s=device_s, peak_bytes=peak_bytes,
                         archives=archives, compiles=compiles,
                         bytes_decoded=bytes_decoded, **extra)
    except Exception:
        return None


def configure_quotas(quotas):
    """Install a parsed/parsable quota table on the active run (the
    daemon/router start path).  Returns the parsed table (callers keep
    it for explicit :func:`check` calls); no-op → parsed table when no
    run is active."""
    parsed = quotas if isinstance(quotas, dict) and all(
        isinstance(v, dict) for v in quotas.values()) \
        else parse_quotas(quotas)
    st = _state()
    if st is not None and parsed:
        st.set_quotas(parsed)
    return parsed


def check(tenant, quotas=None):
    """Quota admission: the breach dict for ``tenant`` or None to
    admit.  No run active → None (disabled = free admits)."""
    rec = _core._active
    if rec is None or (quotas is None and rec._usage is None):
        return None
    st = _state()
    if st is None:
        return None
    try:
        return st.check(tenant, quotas=quotas)
    except Exception:
        return None


def totals():
    """The active run's usage rollup, or None when no run is active or
    nothing was metered (bench / runner summary read)."""
    rec = _core._active
    if rec is None or rec._usage is None:
        return None
    st = rec.usage_state()
    if st is None or not st.n_records:
        return None
    return st.totals()


def quota_burn_fraction():
    """The active run's max quota-burn fraction, or None when no run /
    no quotas (the health probe surface)."""
    rec = _core._active
    if rec is None or rec._usage is None:
        return None
    st = rec.usage_state()
    if st is None or not st.quotas:
        return None
    return st.burn_fraction()


# -- ledger read-back (CLI / diff / report / merge) ---------------------


def usage_files(run_dir):
    """Every usage-ledger file of a run or shard dir, oldest first:
    per-run rotated sets (``usage.jsonl.1``, ..., then the live
    ``usage.jsonl``) and per-process shard sets (``usage.<proc>.jsonl``
    with their rotated chains)."""
    try:
        names = os.listdir(run_dir)
    except OSError:
        return []
    groups = {}   # (proc or None) → [(rot or None, name)]
    for name in names:
        if not name.startswith("usage."):
            continue
        parts = name.split(".")
        # usage.jsonl | usage.jsonl.N | usage.P.jsonl | usage.P.jsonl.N
        if parts[1] == "jsonl":
            proc, rest = None, parts[2:]
        elif len(parts) > 2 and parts[1].isdigit() \
                and parts[2] == "jsonl":
            proc, rest = int(parts[1]), parts[3:]
        else:
            continue
        if not rest:
            rot = None
        elif len(rest) == 1 and rest[0].isdigit():
            rot = int(rest[0])
        else:
            continue
        groups.setdefault(proc, []).append((rot, name))
    out = []
    for proc in sorted(groups, key=lambda p: (p is not None, p)):
        files = groups[proc]
        rotated = sorted((r, n) for r, n in files if r is not None)
        live = [n for r, n in files if r is None]
        out.extend(os.path.join(run_dir, n) for _, n in rotated)
        out.extend(os.path.join(run_dir, n) for n in live)
    return out


def read_usage(path):
    """Usage records of ``path`` (a run/shard dir, or one ledger
    file), torn-tail tolerant: the unparsable line a SIGKILL tears is
    skipped, every completed record survives.  Lines without the
    :data:`SCHEMA` tag are skipped — a ledger is only ever appended
    by this module."""
    files = [path] if os.path.isfile(path) else usage_files(path)
    records = []
    for fpath in files:
        try:
            with open(fpath, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail from a crashed writer
                    if isinstance(rec, dict) \
                            and rec.get("schema") == SCHEMA:
                        records.append(rec)
        except OSError:
            continue
    return records


def rollup(records):
    """Aggregate usage records into exact, order-independent sums:
    ``{"records", "wall_s", "device_s", ..., "tenants": {tenant:
    sums}, "groups": {"tenant|bucket|workload": sums}}``.  Pure sums
    over :data:`_MEASURES` — merging two rollups equals rolling up the
    concatenation, which is what makes shard/fleet totals exact."""
    out = {"records": 0}
    for m in _MEASURES:
        out[m] = 0
    tenants = {}
    groups = {}
    for rec in records:
        out["records"] += 1
        gkey = "%s|%s|%s" % (rec.get("tenant") or LOCAL_TENANT,
                             rec.get("bucket") or "-",
                             rec.get("workload") or "-")
        tkey = rec.get("tenant") or LOCAL_TENANT
        t = tenants.get(tkey)
        if t is None:
            t = tenants[tkey] = dict.fromkeys(_MEASURES, 0)
            t["records"] = t["requests"] = 0
        g = groups.get(gkey)
        if g is None:
            g = groups[gkey] = dict.fromkeys(_MEASURES, 0)
            g["records"] = 0
        for m in _MEASURES:
            v = rec.get(m)
            if isinstance(v, (int, float)):
                out[m] += v
                t[m] += v
                g[m] += v
        t["records"] += 1
        g["records"] += 1
        if rec.get("kind") in ("request", "forward"):
            t["requests"] += 1
    for m in ("wall_s", "device_s"):
        out[m] = round(out[m], 6)
        for d in list(tenants.values()) + list(groups.values()):
            d[m] = round(d[m], 6)
    out["tenants"] = {k: tenants[k] for k in sorted(tenants)}
    out["groups"] = {k: groups[k] for k in sorted(groups)}
    return out
