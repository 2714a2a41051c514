"""Deterministic, env-gated fault injection: the chaos harness.

A copy of the JAX package's ``testing/faults.py`` for the PyTorch
port: the same spec grammar, the same sites and the same fire
decisions, so a given ``PPTPU_FAULTS`` spec fires at the same (site,
key) pairs in both packages.  A wedged device dispatch, a truncated
archive read or a sink write hitting a full disk cannot be provoked on
demand without an injection layer — this module is that layer.

Named **sites** are threaded through the host-side pipeline; each is a
single ``faults.check(site, key=...)`` call that is a near-free no-op
unless a matching fault spec is active.  The port threads these:

=================  ====================================================
site               where it fires
=================  ====================================================
``archive_read``   ``io/archive.load_data`` (per archive load)
``dispatch``       ``pipelines/toas.py`` just before the batched device
                   fit (wideband and narrowband drivers)
``checkpoint_flush``  the per-archive ``.tim`` checkpoint append
``obs_write``      ``obs/core.Recorder.emit`` and the usage ledger
                   append (the injected failure must DROP the event,
                   never crash)
``header_scan``    ``runner/plan.scan_archive_header`` (plan time)
``archive_pad``    ``runner/plan.pad_databunch`` (bucket padding)
``ledger_append``  ``runner/queue`` ledger appends
``ledger_scan``    ``runner/queue`` ledger replay
``lease_renew``    ``runner/queue.WorkQueue.renew`` (the heartbeat)
``barrier``        ``parallel/multihost.barrier``
``compile_cache``  ``runner/warm.enable_persistent_cache``
``supervisor_spawn``  ``runner/supervisor`` worker spawns
=================  ====================================================

The sites are the JAX package's, so one spec serves both packages.

Spec grammar (``PPTPU_FAULTS`` or :func:`configure`)::

    spec    := clause (";" clause)*
    clause  := "site:"NAME "@" param ("," param)*
             | ("sigterm" | "sigint" | "sigkill") "@" param
               ("," param)*
    param   := FLOAT          probability per check, decided by a
                              stable hash of (seed, site, key) — a
                              given key either always faults or never
                              (persistent corruption), keys you never
                              pass decide per check count (transients)
             | "nth="K        fire exactly on the K-th check of the site
                              (check *order* dependent — for targeting
                              a load that may run on a prefetch thread
                              prefer a probability clause, whose per-key
                              hash is order independent)
             | "every="K      fire on every K-th check
             | "after="K      sites: fire on every check past the K-th;
                              signals: deliver ONCE when the counting
                              site's check counter reaches K.
                              ``sigkill`` is a REAL hard kill — no
                              handler, no drain, the check never
                              returns — so lease-expiry recovery is
                              testable without any cooperation from
                              the victim (use it on a subprocess,
                              never in-process in a test runner)
             | "at="NAME      signal clauses: the counting site
                              (default "dispatch")
             | "hang="SECS    on fire, sleep SECS first — watchdog
                              fodder; the hang then *releases as the
                              fault* so an abandoned watchdogged
                              thread terminates instead of leaking
             | "latency="SECS on fire, sleep SECS then PROCEED — the
                              check returns normally, no fault is
                              raised.  Slow-storage simulation (an
                              NFS/Lustre archive mount) for the host
                              pipeline: inject on ``archive_read``
             | "times="M      cap total fires of this clause
             | "seed="N       probability-hash seed (default 0)

Example — a chaos run::

    PPTPU_FAULTS="site:archive_read@0.1;site:dispatch@nth=3;sigterm@after=5"

Contract:

* **Deterministic.**  No wall-clock or global randomness decides a
  fire: probabilities hash (seed, site, key), everything else counts
  checks.  The same spec over the same run fires identically.
* **Env-gated and near-free.**  With no spec active, ``check`` is one
  dict lookup.  The spec is re-read from the environment whenever the
  variable changes, so a resumed in-process run can drop its faults.
* **Auditable.**  Every fire appends to :func:`fired` and emits an obs
  ``fault_injected`` event (+ ``faults_injected`` counter), so a chaos
  run's report shows exactly what was injected where — except the
  ``obs_write`` site, whose whole point is failing the sink itself.
* **Host-only.**  Sites sit between device calls, never inside a
  kernel or a CUDA graph capture.
"""

import hashlib
import os
import signal as _signal
import threading
import time

__all__ = ["InjectedFault", "SITES", "check", "active", "configure",
           "reset", "fired", "spec_string"]

SITES = ("archive_read", "header_scan", "archive_pad", "dispatch",
         "ledger_append", "ledger_scan", "lease_renew",
         "checkpoint_flush", "obs_write", "barrier", "compile_cache",
         "supervisor_spawn")

_SIGNALS = {"sigterm": _signal.SIGTERM, "sigint": _signal.SIGINT,
            "sigkill": _signal.SIGKILL}

# injected hangs sleep in slices this long, so a process exit (or the
# hang deadline) is never more than one slice away
HANG_SLICE_S = 0.05


class InjectedFault(RuntimeError):
    """Raised at a firing injection site.

    Subclasses RuntimeError so it travels exactly the except paths a
    real IO/runtime failure would (``load_archive_data`` swallows it
    like a truncated payload) — the harness tests the *handlers*, not
    a bespoke error channel.
    """


class _Clause:
    __slots__ = ("raw", "site", "signal", "p", "nth", "every", "after",
                 "at", "hang_s", "latency_s", "times", "seed",
                 "n_fired")

    def __init__(self, raw, site=None, sig=None):
        self.raw = raw
        self.site = site
        self.signal = sig
        self.p = None
        self.nth = None
        self.every = None
        self.after = None
        self.at = "dispatch"
        self.hang_s = None
        self.latency_s = None
        self.times = None
        self.seed = 0
        self.n_fired = 0


def _parse(spec):
    """List of _Clause from a spec string; raises ValueError on typos
    (an unknown site silently never firing would defeat the harness)."""
    clauses = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, params = part.partition("@")
        head = head.strip()
        if head.startswith("site:"):
            site = head[len("site:"):].strip()
            if site not in SITES:
                raise ValueError(
                    "PPTPU_FAULTS: unknown site %r (known: %s)"
                    % (site, ", ".join(SITES)))
            c = _Clause(part, site=site)
        elif head in _SIGNALS:
            c = _Clause(part, sig=head)
        else:
            raise ValueError(
                "PPTPU_FAULTS: clause %r must start with 'site:<name>'"
                ", 'sigterm' or 'sigint'" % part)
        for tok in params.split(","):
            tok = tok.strip()
            if not tok:
                continue
            key, _, val = tok.partition("=")
            try:
                if not _:
                    c.p = float(tok)
                elif key == "nth":
                    c.nth = int(val)
                elif key == "every":
                    c.every = int(val)
                elif key == "after":
                    c.after = int(val)
                elif key == "at":
                    if val not in SITES:
                        raise ValueError("unknown counting site %r"
                                         % val)
                    c.at = val
                elif key == "hang":
                    c.hang_s = float(val)
                elif key == "latency":
                    c.latency_s = float(val)
                elif key == "times":
                    c.times = int(val)
                elif key == "seed":
                    c.seed = int(val)
                else:
                    raise ValueError("unknown param %r" % tok)
            except ValueError as e:
                raise ValueError("PPTPU_FAULTS: bad clause %r: %s"
                                 % (part, e))
        if c.signal is not None:
            if c.after is None:
                raise ValueError("PPTPU_FAULTS: signal clause %r needs "
                                 "after=<n>" % part)
        elif c.p is None and c.nth is None and c.every is None \
                and c.after is None:
            raise ValueError("PPTPU_FAULTS: clause %r has no trigger "
                             "(probability, nth=, every= or after=)"
                             % part)
        clauses.append(c)
    return clauses


class _Harness:
    """Parsed spec + per-site check counters + the fired log."""

    def __init__(self, clauses, spec):
        self.clauses = clauses
        self.spec = spec
        self.counts = {}
        self.fired = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    # -- trigger evaluation --------------------------------------------

    @staticmethod
    def _hash_fires(clause, site, key, n):
        ident = "%d|%s|%s" % (clause.seed, site,
                              key if key is not None else n)
        h = hashlib.sha1(ident.encode("utf-8", "replace")).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < clause.p

    def _matches(self, c, site, key, n):
        if c.nth is not None:
            return n == c.nth
        if c.every is not None:
            return n % c.every == 0
        if c.after is not None:
            return n > c.after
        return self._hash_fires(c, site, key, n)

    # -- firing --------------------------------------------------------

    def _record(self, c, site, n, key, action):
        c.n_fired += 1
        rec = {"site": site, "n": n, "key": key, "action": action,
               "clause": c.raw}
        with self._lock:
            self.fired.append(rec)
        self._emit(rec)
        return rec

    def _emit(self, rec):
        # the obs_write site fails the sink itself: logging it through
        # the sink would be circular (it stays visible via fired())
        if rec["site"] == "obs_write":
            return
        self._tls.emitting = True
        try:
            from .. import obs

            obs.event("fault_injected", **rec)
            obs.counter("faults_injected")
        except Exception:
            pass
        finally:
            self._tls.emitting = False

    def check(self, site, key=None):
        if getattr(self._tls, "emitting", False):
            return  # our own obs emission re-entering a site
        with self._lock:
            n = self.counts.get(site, 0) + 1
            self.counts[site] = n
        for c in self.clauses:
            if c.times is not None and c.n_fired >= c.times:
                continue
            if c.signal is not None:
                # deliver ONCE, exactly when the counting site's
                # counter reaches after=N (preemption at a defined
                # progress point); the check itself then proceeds —
                # except sigkill, which never returns (hard death)
                if site == c.at and n == c.after:
                    self._record(c, site, n, key, c.signal)
                    os.kill(os.getpid(), _SIGNALS[c.signal])
                continue
            if c.site != site or not self._matches(c, site, key, n):
                continue
            if c.latency_s:
                # pure success-path delay (slow-storage simulation):
                # sleep, record, and keep checking — never raises
                self._record(c, site, n, key, "latency")
                deadline = time.monotonic() + c.latency_s
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    time.sleep(min(HANG_SLICE_S, left))
                continue
            action = "hang" if c.hang_s else "fail"
            self._record(c, site, n, key, action)
            if c.hang_s:
                deadline = time.monotonic() + c.hang_s
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    time.sleep(min(HANG_SLICE_S, left))
            raise InjectedFault(
                "injected fault at site %r (check #%d%s%s)"
                % (site, n,
                   "" if key is None else ", key=%r" % key,
                   ", after %.3gs hang" % c.hang_s if c.hang_s else ""))


_lock = threading.Lock()
_harness = None     # active _Harness (env- or configure()-driven)
_env_spec = None    # the env string _harness was parsed from
_override = False   # True when configure() owns _harness


def _current():
    """The active harness, re-synced with $PPTPU_FAULTS on change."""
    global _harness, _env_spec
    if _override:
        return _harness
    env = os.environ.get("PPTPU_FAULTS", "").strip()
    if not env:
        if _env_spec is not None:
            with _lock:
                _harness, _env_spec = None, None
        return None
    if env != _env_spec:
        with _lock:
            if env != _env_spec:
                _harness = _Harness(_parse(env), env)
                _env_spec = env
    return _harness


def check(site, key=None):
    """Fault-injection hook: no-op unless an active spec matches.

    ``key`` identifies the work item (archive path, barrier name) so
    probability clauses can decide per item and the fired log reads
    usefully.  May raise :class:`InjectedFault`, sleep (``hang=``) or
    deliver a signal to this process — exactly what the instrumented
    code must survive.  Host-side only.
    """
    h = _current()
    if h is not None:
        h.check(site, key)


def active():
    """True when a fault spec is currently active."""
    return _current() is not None


def spec_string():
    """The active spec string, or None."""
    h = _current()
    return h.spec if h is not None else None


def configure(spec):
    """Activate ``spec`` programmatically (tests), overriding the
    environment until :func:`reset`.  Parses eagerly: a bad spec fails
    here, not silently at the first check."""
    global _harness, _override
    with _lock:
        _harness = _Harness(_parse(spec), spec)
        _override = True


def reset():
    """Drop any active spec and all counters; the environment is
    re-read (and re-parsed) on the next :func:`check`."""
    global _harness, _env_spec, _override
    with _lock:
        _harness, _env_spec, _override = None, None, False


def fired():
    """Copy of the fired log: [{"site", "n", "key", "action",
    "clause"}] in firing order."""
    h = _harness
    return list(h.fired) if h is not None else []
