"""Persistent survey work queue: a crash-safe JSONL state ledger.

One line is appended per state transition, so the ledger is crash-safe
by construction (a torn tail line is dropped on replay) and the full
history of every archive — attempts, failure reasons, timestamps — is
preserved for the final survey report.  Replaying the file left to
right reconstructs current state: the **last** record per archive
wins.

States::

    pending -> running -> done
                       -> failed (transient; bounded retries with
                                  exponential backoff) -> pending
                       -> quarantined (poison: corrupt file, model
                                       mismatch, retries exhausted)

``running`` entries found at load time are crash leftovers (the fit
never completed) and are reverted to ``pending``, mirroring how the
``.tim`` checkpoint drops unterminated archive blocks
(pipelines/toas.py).  Quarantined archives are terminal: they are
reported with their reason, never silently retried — one corrupt
PSRFITS file must not be able to wedge a week-long run in a retry
loop.

Union replay & leases (elastic multihost, docs/RUNNER.md)
---------------------------------------------------------

With ``union_dir`` set, a queue still appends **only to its own shard**
(``ledger.<pid>.jsonl`` — never multi-writer files) but replays the
union of every shard under the directory, so the merged ledger — not a
static partition — is the single source of truth for work ownership:

* ``claim()`` appends a ``running`` record carrying ``owner`` (process
  index + run epoch, e.g. ``p1@8812.2``) and ``lease_expires_at``;
  ``renew()`` heartbeats extend the lease with further appends.
* Merge order is deterministic and independent of shard read order:
  records sort by ``(t, owner, seq)`` and the **max** record per
  archive wins.  A double-claim therefore resolves identically on
  every process; the loser abandons with *no* ledger transition (the
  same discipline the dispatch watchdog uses for late finishers).
* ``ready()`` treats an expired-lease ``running`` entry as claimable:
  a dead straggler's archives expire back into the pool instead of
  staying stranded until a full restart.  The claimant first appends a
  visible ``pending`` revocation (``reason="lease_expired"``,
  ``prev_owner=...``) so every takeover is auditable from the ledger
  alone; ``revoke()`` does the same for barrier-named stragglers.
* ``refresh()`` tails every shard incrementally (byte offsets, torn
  tails never consumed) so a live process observes other processes'
  claims/completions without rereading whole files.

Workload dimension (runner/workloads.py)
----------------------------------------

A workdir may host several sequential workload passes (zap -> align ->
toas) sharing the same shard files.  Every record written by this
queue carries ``workload``; records **without** the field (ledgers
written before the workload engine existed) replay as ``"toas"``, so
old workdirs resume unchanged.  ``entries``/``ready``/``claim``/
``counts`` and every other single-workload API are filtered to this
queue's own workload — two workloads never contend for the same
archive — while ``all_entries`` keeps the cross-workload union for
``record_for``/``counts_by_workload``/``workloads_seen`` (the status
and pre-fit-chain views).
"""

import hashlib
import json
import os
import re
import threading
import time

from ..obs import tracing
from ..testing import faults

__all__ = ["WorkQueue", "PENDING", "RUNNING", "DONE", "FAILED",
           "QUARANTINED", "owner_pid", "DEFAULT_WORKLOAD",
           "record_workload"]

PENDING = "pending"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
QUARANTINED = "quarantined"

_STATES = (PENDING, RUNNING, DONE, FAILED, QUARANTINED)

_LEDGER_RE = re.compile(r"^ledger\.(\d+)\.jsonl$")
_OWNER_RE = re.compile(r"^p(\d+)@")

# records written before the workload engine existed have no
# ``workload`` field — they are TOA surveys by construction
DEFAULT_WORKLOAD = "toas"


def record_workload(rec):
    """Workload a ledger record belongs to (back-compat default)."""
    return str(rec.get("workload") or DEFAULT_WORKLOAD)


def owner_pid(owner):
    """Process index encoded in an owner string (``p<idx>@<epoch>``),
    or None for legacy/unparseable owners."""
    if not owner:
        return None
    m = _OWNER_RE.match(str(owner))
    return int(m.group(1)) if m else None


def _jitter_factor(key, attempts):
    """Deterministic backoff jitter in [0.5, 1.0), seeded from the
    archive path + attempt number.

    A bare ``backoff_s * 2**(attempts-1)`` is identical across every
    process of a multihost run, so one shared transient (tunnel blip,
    NFS hiccup) produces a synchronized retry stampede.  Hashing the
    key decorrelates the retry times across archives and processes
    while keeping every individual schedule exactly reproducible —
    no global randomness, so tests (and reruns) see the same ledger.
    """
    h = hashlib.sha1(("%s|%d" % (key, int(attempts)))
                     .encode("utf-8", "replace")).digest()
    return 0.5 + int.from_bytes(h[:8], "big") / 2.0 ** 65


def _rec_key(rec):
    """Total order for union replay: ``(t, owner, seq)`` primary (seq
    breaks same-owner microsecond ties causally), then state + the
    canonical JSON as a final deterministic tie-break so the merged
    winner is identical regardless of shard read order."""
    try:
        seq = int(rec.get("seq") or 0)
    except (TypeError, ValueError):
        seq = 0
    try:
        t = float(rec.get("t") or 0.0)
    except (TypeError, ValueError):
        t = 0.0
    return (t, str(rec.get("owner") or ""), seq,
            str(rec.get("state") or ""),
            json.dumps(rec, sort_keys=True, default=str))


class WorkQueue:
    """On-disk per-archive state machine for one survey.

    Archives are keyed by ``os.path.realpath`` so resumed runs match
    regardless of path spelling, exactly like the checkpoint resume in
    pipelines/toas.py.  All writes are appends flushed per line, and
    always to ``path`` (this process's own shard) only; with
    ``union_dir`` set the *read* side replays every ``ledger.*.jsonl``
    under it (module docstring).  ``owner``/``lease_s`` arm lease-based
    claiming; ``process_index`` identifies which stale ``running``
    records are this process's own crash leftovers.
    """

    def __init__(self, path, max_attempts=3, backoff_s=1.0,
                 readonly=False, union_dir=None, owner=None,
                 lease_s=600.0, process_index=None,
                 workload=DEFAULT_WORKLOAD):
        self.path = path
        self.max_attempts = int(max_attempts)
        self.backoff_s = float(backoff_s)
        self.readonly = bool(readonly)
        self.union_dir = union_dir
        self.owner = owner
        self.lease_s = float(lease_s)
        self.workload = str(workload or DEFAULT_WORKLOAD)
        if process_index is None:
            process_index = owner_pid(owner)
        self.process_index = process_index
        self.entries = {}      # realpath -> latest record, own workload
        self.all_entries = {}  # (workload, realpath) -> latest record
        self._order = []       # insertion order of first sighting
        self._seq = 0          # per-process record sequence (union tie-break)
        self._offsets = {}     # shard path -> bytes consumed
        self._shard_of = {}    # realpath -> shard pid of winning record
        self.shards_seen = 0   # shard files found by the last refresh
        self.scan_errors = 0   # unreadable shards tolerated by refresh
        # appends may race between the survey loop, its dispatch
        # watchdog settling an abandoned archive, and the lease
        # heartbeat thread (runner/execute.py)
        self._iolock = threading.Lock()
        if self.union_dir is not None:
            self.refresh(include_own=True)
        elif path is not None and os.path.isfile(path):
            self._replay()
        if self.readonly:
            # inspection only (ppsurvey status): no appends, and no
            # crash recovery — a live run may own the file
            self._fh = None
            return
        if path is None:
            raise ValueError("WorkQueue needs a shard path unless "
                             "readonly")
        # a torn tail (kill mid-append) must not glue the next append
        # onto the partial line — both records would then be lost
        if os.path.isfile(path) and os.path.getsize(path):
            with open(path, "rb") as fh:
                fh.seek(-1, os.SEEK_END)
                torn = fh.read(1) != b"\n"
            if torn:
                with open(path, "ab") as fh:
                    fh.write(b"\n")
        self._fh = open(path, "a", encoding="utf-8")
        self._recover()

    # -- persistence ----------------------------------------------------

    def _replay(self):
        """Single-shard replay: file order IS the causal order."""
        with open(self.path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from a crash
                key = rec.get("archive")
                if key is None or rec.get("state") not in _STATES:
                    continue
                wl = record_workload(rec)
                self.all_entries[(wl, key)] = rec
                if wl == self.workload:
                    if key not in self.entries:
                        self._order.append(key)
                    self.entries[key] = rec
                self._seq = max(self._seq, int(rec.get("seq") or 0))

    def _apply(self, rec, shard):
        """Merge one replayed record: max ``_rec_key`` per (workload,
        archive) wins (idempotent, shard-read-order independent).
        Only this queue's own workload feeds ``entries``/``_order`` —
        other workloads' records are visible through ``all_entries``
        but never contend for claims."""
        key = rec.get("archive")
        if key is None or rec.get("state") not in _STATES:
            return
        wl = record_workload(rec)
        wkey = (wl, key)
        prev = self.all_entries.get(wkey)
        if prev is not None and _rec_key(rec) < _rec_key(prev):
            return
        self.all_entries[wkey] = rec
        if wl != self.workload:
            return
        if key not in self.entries:
            self._order.append(key)
        self.entries[key] = rec
        self._shard_of[key] = shard

    def _read_shard(self, path, shard):
        """Tail one shard from its consumed offset; never consume an
        unterminated tail line (it may still be mid-append — or torn
        forever, in which case it stays ignored)."""
        off = self._offsets.get(path, 0)
        with open(path, "rb") as fh:
            fh.seek(off)
            data = fh.read()
        if not data:
            return 0
        lines = data.split(b"\n")
        tail = lines.pop()  # b"" when data ends on a newline
        self._offsets[path] = off + len(data) - len(tail)
        n = 0
        for raw in lines:
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw.decode("utf-8", "replace"))
            except json.JSONDecodeError:
                continue  # torn line mid-file (pre-fix glue): skip it
            self._apply(rec, shard)
            n += 1
        return n

    def refresh(self, include_own=False):
        """Union mode: fold in every shard's new records; returns how
        many records were read.  A shard that cannot be read right now
        (NFS blip, injected ``ledger_scan`` fault) is skipped and
        retried on the next refresh — the view is then momentarily
        stale, which the claim protocol tolerates (ownership is
        re-checked against the union before every transition)."""
        if self.union_dir is None:
            return 0
        try:
            names = os.listdir(self.union_dir)
        except OSError:
            return 0
        own = os.path.basename(self.path) if self.path else None
        n = 0
        self.shards_seen = 0
        for name in sorted(names):
            m = _LEDGER_RE.match(name)
            if not m:
                continue
            self.shards_seen += 1
            if not include_own and name == own:
                continue  # own appends are applied at write time
            spath = os.path.join(self.union_dir, name)
            try:
                # chaos site: a failed shard scan must degrade to a
                # stale view, never crash the claim loop (checked
                # outside the lock — injected hangs must not block
                # the heartbeat thread's appends)
                faults.check("ledger_scan", key=spath)
                with self._iolock:
                    n += self._read_shard(spath, int(m.group(1)))
            except (faults.InjectedFault, OSError):
                self.scan_errors += 1
                continue
        for rec in self.all_entries.values():
            # seq must be monotone across EVERY workload sharing the
            # shard files, or a later pass's records would lose the
            # union tie-break to an earlier pass's
            self._seq = max(self._seq, int(rec.get("seq") or 0))
        return n

    def _append(self, key, state, **fields):
        if self._fh is None:
            raise RuntimeError("WorkQueue opened readonly")
        # chaos site: an injected append fault is a hard crash (full
        # disk, killed process) — nothing is recorded, and the resume
        # path must reconstruct from what IS on disk
        faults.check("ledger_append", key=key)
        # ambient trace context (obs/tracing.py): ledger transitions
        # made while serving a traced request/archive carry the trace
        # id, so lease takeovers and replays are causally auditable
        trace_id = tracing.current_trace_id()
        with self._iolock:
            self._seq += 1
            rec = {"t": round(time.time(), 6), "archive": key,
                   "state": state, "seq": self._seq,
                   "workload": self.workload}
            if trace_id is not None:
                rec["trace"] = trace_id
            if self.owner is not None:
                rec["owner"] = self.owner
            prev = self.entries.get(key)
            rec["attempts"] = int(fields.pop(
                "attempts", (prev or {}).get("attempts", 0)))
            rec.update(fields)
            if self.union_dir is not None:
                self._apply(rec, self.process_index)
            else:
                if key not in self.entries:
                    self._order.append(key)
                self.entries[key] = rec
                self.all_entries[(self.workload, key)] = rec
            # the ledger append IS _iolock's critical section (docs/RUNNER.md)
            self._fh.write(json.dumps(rec) + "\n")
            # flushed before the lease becomes visible to peers
            self._fh.flush()
        return rec

    def _recover(self):
        """Crash recovery: running -> pending (the fit never finished).

        In union mode only THIS process's own stale claims are
        recovered (an older epoch of the same process index); other
        owners' claims are left to lease expiry — their process may be
        alive and mid-fit.
        """
        for key, rec in list(self.entries.items()):
            if rec["state"] != RUNNING:
                continue
            own = rec.get("owner")
            if self.union_dir is not None:
                if own == self.owner:
                    continue  # cannot happen on open, but be safe
                if owner_pid(own) != self.process_index:
                    continue  # someone else's lease: expiry handles it
                self._append(key, PENDING, reason="recovered_from_crash",
                             prev_owner=own)
            else:
                self._append(key, PENDING, reason="recovered_from_crash")

    def close(self):
        if self._fh is None:
            return
        try:
            self._fh.close()
        except OSError:
            pass

    # -- transitions ----------------------------------------------------

    @staticmethod
    def key_for(path):
        return os.path.realpath(path)

    def add(self, paths):
        """Register archives as pending; known archives (in ANY shard
        of a union) keep their state (idempotent across resumes)."""
        for path in paths:
            key = self.key_for(path)
            if key not in self.entries:
                self._append(key, PENDING, path=path)

    def claim(self, path, lease_s=None, **extra_fields):
        """Claim an archive for this owner.

        Without an owner this is the legacy bare ``running`` append.
        With one, the record carries ``owner`` + ``lease_expires_at``;
        taking over another owner's expired (or revoked) claim first
        appends a visible ``pending`` revocation and tags the new claim
        with ``takeover_from``, so the ledger narrates every takeover.
        The caller must re-check :meth:`owns` after a
        :meth:`refresh` — a concurrent double-claim is resolved by the
        deterministic ``(t, owner)`` union order and the loser must
        abandon with no further transition.  ``extra_fields`` ride on
        the claim record (the toas workload stamps the upstream zap
        decision chain here — runner/workloads.py).
        """
        key = self.key_for(path)
        if self.owner is None:
            return self._append(key, RUNNING, **extra_fields)
        prev = self.entries.get(key)
        fields = {"lease_expires_at": round(
            time.time() + (self.lease_s if lease_s is None
                           else float(lease_s)), 6)}
        if prev is not None:
            if prev.get("state") == RUNNING \
                    and prev.get("owner") != self.owner:
                # visible revocation: the dead owner's lease expires
                # into the pool as an explicit ledger transition
                self._append(key, PENDING, reason="lease_expired",
                             prev_owner=prev.get("owner"),
                             attempts=prev.get("attempts", 0))
                fields["takeover_from"] = prev.get("owner")
            elif prev.get("prev_owner") \
                    and prev.get("prev_owner") != self.owner:
                # claimed straight off a revocation/recovery record
                fields["takeover_from"] = prev.get("prev_owner")
        fields.update(extra_fields)
        return self._append(key, RUNNING, **fields)

    def renew(self, path):
        """Heartbeat: extend this owner's lease with a fresh append.
        No-op (returns None) once the archive is no longer this
        owner's — ownership is verified against a *refreshed* union
        first, because a renewal appended over an unseen takeover
        would steal the archive back and double-fit it."""
        key = self.key_for(path)
        self.refresh()
        rec = self.entries.get(key)
        if self.owner is None or rec is None \
                or rec.get("state") != RUNNING \
                or rec.get("owner") != self.owner:
            return None
        # chaos site: a failed renewal lets the lease run out — the
        # fit's completion guard must then abandon without transitions
        faults.check("lease_renew", key=key)
        return self._append(
            key, RUNNING,
            lease_expires_at=round(time.time() + self.lease_s, 6),
            renewals=int(rec.get("renewals", 0)) + 1)

    def owns(self, path, refresh=False):
        """True when this owner holds the archive's current ``running``
        record in the union view (always True without lease mode)."""
        if self.owner is None:
            return True
        if refresh:
            self.refresh()
        rec = self.entries.get(self.key_for(path))
        return rec is not None and rec.get("state") == RUNNING \
            and rec.get("owner") == self.owner

    def revoke(self, path, reason):
        """Force another owner's ``running`` claim back to pending
        (barrier-named straggler, operator action).  Returns the
        revocation record, or None when there is nothing to revoke."""
        key = self.key_for(path)
        rec = self.entries.get(key)
        if rec is None or rec.get("state") != RUNNING \
                or rec.get("owner") == self.owner:
            return None
        return self._append(key, PENDING, reason=str(reason),
                            prev_owner=rec.get("owner"),
                            attempts=rec.get("attempts", 0))

    def revoke_owner(self, process_index, reason):
        """Revoke every ``running`` lease held by a process index (the
        ``BarrierTimeout.missing`` straggler path).  Returns the
        revocation records."""
        out = []
        for key, rec in list(self.entries.items()):
            if rec.get("state") == RUNNING \
                    and rec.get("owner") != self.owner \
                    and owner_pid(rec.get("owner")) == process_index:
                out.append(self._append(
                    key, PENDING, reason=str(reason),
                    prev_owner=rec.get("owner"),
                    attempts=rec.get("attempts", 0)))
        return out

    def complete(self, path, **info):
        if self.process_index is not None:
            # which process's .tim checkpoint holds this archive's
            # block (reconcile + elastic resume need to know)
            info.setdefault("ckpt", int(self.process_index))
        return self._append(self.key_for(path), DONE, **info)

    def fail(self, path, reason):
        """Transient failure: retry with exponential backoff until
        ``max_attempts``, then quarantine with the chain recorded."""
        key = self.key_for(path)
        attempts = self.entries.get(key, {}).get("attempts", 0) + 1
        if attempts >= self.max_attempts:
            return self._append(
                key, QUARANTINED, attempts=attempts,
                reason=f"retries exhausted ({attempts}): {reason}")
        span = self.backoff_s * 2 ** (attempts - 1)
        retry_at = time.time() + span * _jitter_factor(key, attempts)
        return self._append(key, FAILED, attempts=attempts,
                            reason=str(reason),
                            retry_at=round(retry_at, 6))

    def quarantine(self, path, reason):
        """Poison archive: terminal, with the reason on record."""
        return self._append(self.key_for(path), QUARANTINED,
                            reason=str(reason))

    def reset(self, path, reason):
        """Force an archive back to pending (ledger/checkpoint
        reconciliation — see execute.py)."""
        return self._append(self.key_for(path), PENDING,
                            reason=str(reason))

    # -- queries --------------------------------------------------------

    def state(self, path):
        rec = self.entries.get(self.key_for(path))
        return rec["state"] if rec else None

    def record(self, path):
        return self.entries.get(self.key_for(path))

    def shard_of(self, path):
        """Shard pid whose record currently wins for this archive
        (union mode; None single-shard)."""
        return self._shard_of.get(self.key_for(path))

    def ready(self, path, now=None):
        """True when the archive should be (re)fit now: pending,
        failed with its backoff elapsed, or — in union/lease mode —
        ``running`` under another owner's *expired* lease (a lease no
        one can renew counts as expired immediately)."""
        rec = self.entries.get(self.key_for(path))
        if rec is None:
            return False
        if rec["state"] == PENDING:
            return True
        if rec["state"] == FAILED:
            now = time.time() if now is None else now
            return now >= rec.get("retry_at", 0.0)
        if rec["state"] == RUNNING and self.union_dir is not None \
                and self.owner is not None \
                and rec.get("owner") != self.owner:
            exp = rec.get("lease_expires_at")
            if exp is None:
                return True  # unrenewable legacy claim: claimable
            now = time.time() if now is None else now
            return now >= exp
        return False

    def outstanding(self):
        """Archives not yet done or quarantined (pending, failed
        awaiting backoff, or running), in first-seen order."""
        return [k for k in self._order
                if self.entries[k]["state"] in (PENDING, RUNNING, FAILED)]

    def done(self):
        return {k for k in self._order
                if self.entries[k]["state"] == DONE}

    def quarantined(self):
        """[(archive, reason)] for every quarantined archive."""
        return [(k, self.entries[k].get("reason", ""))
                for k in self._order
                if self.entries[k]["state"] == QUARANTINED]

    def counts(self):
        out = {s: 0 for s in _STATES}
        for rec in self.entries.values():
            out[rec["state"]] += 1
        return out

    def leases(self, now=None, all_workloads=False):
        """[{archive, workload, owner, lease_expires_at, expires_in,
        expired}] for every ``running`` entry — the ``ppsurvey
        status`` lease table.  ``all_workloads`` widens the scan to
        every workload sharing the workdir."""
        now = time.time() if now is None else now
        if all_workloads:
            recs = [(k, self.all_entries[(wl, k)])
                    for wl, k in sorted(self.all_entries)]
        else:
            recs = [(k, self.entries[k]) for k in self._order]
        out = []
        for k, rec in recs:
            if rec["state"] != RUNNING:
                continue
            exp = rec.get("lease_expires_at")
            out.append({
                "archive": k,
                "workload": record_workload(rec),
                "owner": rec.get("owner"),
                "lease_expires_at": exp,
                "expires_in": None if exp is None
                else round(exp - now, 3),
                "expired": exp is None or now >= exp})
        return out

    # -- cross-workload queries (runner/workloads.py, status views) -----

    def workloads_seen(self):
        """Sorted workload names present anywhere in the union view."""
        return sorted({wl for wl, _ in self.all_entries})

    def record_for(self, workload, path):
        """Latest record for an archive under ANY workload (the toas
        pass reads the zap pass's decisions through this)."""
        return self.all_entries.get(
            (str(workload), self.key_for(path)))

    def entries_for(self, workload):
        """{realpath: record} snapshot of one workload's entries."""
        workload = str(workload)
        return {k: rec for (wl, k), rec in self.all_entries.items()
                if wl == workload}

    def counts_by_workload(self):
        """{workload: {state: n}} across the whole union view."""
        out = {}
        for (wl, _), rec in self.all_entries.items():
            per = out.setdefault(wl, {s: 0 for s in _STATES})
            per[rec["state"]] += 1
        return out
