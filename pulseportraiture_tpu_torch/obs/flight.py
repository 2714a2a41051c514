"""Flight recorder: an always-on ring of recent events + postmortems.

The event stream (:mod:`.core`) is complete but append-only on disk —
when a run goes sideways (an OOM quarantine, a watchdog kill, a firing
alert) the question is "what happened in the last few seconds", and
answering it from a multi-megabyte ``events.jsonl`` after the fact is
exactly the forensics lag this module removes.  Every
:class:`~.core.Recorder` owns one :class:`FlightRecorder`:

* **Always-on ring.**  ``record()`` appends every emitted event dict
  into a bounded in-memory deque (``PPTPU_FLIGHT_CAPACITY``, default
  256) *before* the sink write, so the ring still holds the trail when
  the sink itself is the failure (full disk, dead NFS — the
  ``obs_write`` chaos site).  The append is one ``deque.append`` of an
  already-built dict.
* **Postmortem bundles.**  ``dump(trigger)`` freezes the ring together
  with the last metrics snapshot, the firing alerts (:mod:`.health`)
  and a manifest excerpt into
  ``<run-dir>/postmortem/<seq>-<trigger>.json``.  Dumps are capped per
  run (``PPTPU_FLIGHT_MAX_DUMPS``, default 8) so a flapping alert
  cannot fill a disk, and every failure degrades to a dropped bundle —
  the obs "never fatal" contract.

Triggers are wired where the failures live: in the JAX package its
survey runner dumps on OOM/watchdog/quarantine and its TOA service on
request quarantine; here, as there, the health plane dumps the moment
any alert transitions to firing (obs/health.py).

Host-side only, like everything in ``obs``.
"""

import collections
import json
import os
import re
import threading
import time

from . import core as _core

__all__ = ["FLIGHT_SCHEMA", "flight_capacity", "flight_max_dumps",
           "FlightRecorder", "dump", "load_postmortems"]

FLIGHT_SCHEMA = "pptpu-postmortem-v1"

# manifest keys worth carrying into a bundle: enough context to read a
# postmortem without the run directory (the full manifest stays there)
_MANIFEST_EXCERPT_KEYS = ("schema", "run_id", "name", "t_start",
                          "config", "platform", "git")

_TRIGGER_SAFE_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def flight_capacity():
    """$PPTPU_FLIGHT_CAPACITY: ring size in events (default 256; 0
    disables the ring — and with it, postmortem dumps)."""
    v = os.environ.get("PPTPU_FLIGHT_CAPACITY", "").strip()
    try:
        return max(0, int(v)) if v else 256
    except ValueError:
        return 256


def flight_max_dumps():
    """$PPTPU_FLIGHT_MAX_DUMPS: postmortem bundles per run (default 8;
    a flapping trigger must not fill the disk)."""
    v = os.environ.get("PPTPU_FLIGHT_MAX_DUMPS", "").strip()
    try:
        return max(0, int(v)) if v else 8
    except ValueError:
        return 8


class FlightRecorder:
    """Bounded ring of recent event dicts + postmortem bundle writer
    for one :class:`~.core.Recorder`."""

    def __init__(self, recorder):
        self._recorder = recorder
        cap = flight_capacity()
        # None (capacity 0) keeps record() at one attribute read
        self._ring = collections.deque(maxlen=cap) if cap else None
        self._max_dumps = flight_max_dumps()
        self._seq = 0
        self._lock = threading.Lock()

    @property
    def capacity(self):
        return self._ring.maxlen if self._ring is not None else 0

    def record(self, rec):
        """Append one event dict (a ``deque.append`` — the whole
        always-on cost; the deque's maxlen bounds memory)."""
        ring = self._ring
        if ring is not None:
            ring.append(rec)

    def snapshot_ring(self):
        """The ring's current contents, oldest first."""
        ring = self._ring
        return list(ring) if ring is not None else []

    def dump(self, trigger, context=None):
        """Write one postmortem bundle; returns its path, or None when
        disabled, capped or failed — never raises."""
        rec = self._recorder
        if self._ring is None or rec is None:
            return None
        try:
            with self._lock:
                if self._seq >= self._max_dumps:
                    return None
                self._seq += 1
                seq = self._seq
            bundle = self._build_bundle(trigger, context)
            pm_dir = os.path.join(rec.dir, "postmortem")
            os.makedirs(pm_dir, exist_ok=True)
            fname = "%03d-%s.json" % (
                seq, _TRIGGER_SAFE_RE.sub("-", str(trigger)) or "dump")
            path = os.path.join(pm_dir, fname)
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(bundle, fh, indent=1,
                          default=_core._json_default)
                fh.write("\n")
            os.replace(tmp, path)
        except Exception:
            return None
        # the bundle itself lands first, then its audit trail: a sink
        # failure here loses the event, never the postmortem
        rec.event("postmortem_written", trigger=str(trigger),
                  path=path,
                  n_ring=len(bundle.get("ring") or ()))
        rec.counter("postmortems_written")
        return path

    def _build_bundle(self, trigger, context):
        rec = self._recorder
        bundle = {"schema": FLIGHT_SCHEMA,
                  "t": round(time.time(), 6),
                  "trigger": str(trigger)}
        if context:
            bundle["context"] = dict(context)
        bundle["ring"] = self.snapshot_ring()
        # already-materialized sub-states only: a postmortem must not
        # spin up the exporter thread of a run that never used metrics
        reg = rec._metrics
        bundle["metrics"] = reg.snapshot() if reg is not None else None
        hs = rec._health
        bundle["alerts_firing"] = hs.firing() if hs is not None else []
        bundle["manifest"] = {k: rec.manifest.get(k)
                              for k in _MANIFEST_EXCERPT_KEYS
                              if k in rec.manifest}
        bundle["counters"] = dict(rec.counters)
        return bundle


def dump(trigger, **context):
    """Dump a postmortem from the active run's flight recorder;
    returns the bundle path, or None when no run is active (no-op at
    one attribute read — the disabled-obs contract)."""
    rec = _core._active
    if rec is None:
        return None
    return rec.flight.dump(trigger, context=context or None)


def load_postmortems(run_dir):
    """Every parseable postmortem bundle of a run, oldest first, each
    with its ``file`` name injected.  Torn or partial bundles (a
    sigkilled worker mid-dump) are skipped — a dead shard's ring must
    never corrupt a survivor's forensics."""
    pm_dir = os.path.join(run_dir, "postmortem")
    try:
        names = sorted(os.listdir(pm_dir))
    except OSError:
        return []
    out = []
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(pm_dir, name),
                      encoding="utf-8") as fh:
                bundle = json.load(fh)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            continue
        if isinstance(bundle, dict):
            bundle["file"] = name
            out.append(bundle)
    return out
