"""Crash-loop backoff + flap detection shared by every respawn path.

Two respawn loops exist in the tree — the fleet router's daemon
respawn (service/router.py) and the survey supervisor's worker
respawn (runner/supervisor.py) — and both face the same failure
shape: a child that dies the instant it starts.  Respawning it
unconditionally burns CPU, floods ``pps_respawns_total`` and, in the
supervisor's case, can starve the healthy workers of the ledger lock.
This module is the one policy for that shape:

* **Exponential backoff** between consecutive deaths: the n-th strike
  waits ``backoff_s * 2**(n-1)`` seconds (capped at
  ``backoff_max_s``), decorrelated with the same deterministic jitter
  the work queue uses for retry stampedes (queue._jitter_factor).
  ``backoff_s=0`` disables the delay entirely — the router uses that
  to keep its below-threshold behavior exactly what it was before
  this module existed (immediate in-place respawn).
* **Flap quarantine**: ``flap_count`` deaths inside a sliding
  ``flap_window_s`` window parks the slot — ``record_death`` returns
  ``{"action": "park"}`` and every later call keeps returning it.  A
  parked slot is never respawned again; the caller emits its
  ``*_flap`` event and the survey/fleet degrades gracefully onto the
  survivors.

A child that stays up longer than the window prunes its old strikes
by construction (the window is evaluated against death timestamps),
so a slow leak that dies once an hour never escalates past strike 1.

Trackers are pure bookkeeping over caller-supplied clocks: nothing
here spawns, sleeps, or reads the wall clock, which is what makes the
supervisor's ``decide()`` table-testable.
"""

from .queue import _jitter_factor

__all__ = ["RespawnPolicy", "RespawnTracker", "RESPAWN", "PARK"]

RESPAWN = "respawn"
PARK = "park"


class RespawnPolicy(object):
    """Tunables for one family of slots (all daemons, all workers)."""

    __slots__ = ("backoff_s", "backoff_max_s", "flap_count",
                 "flap_window_s")

    def __init__(self, backoff_s=1.0, backoff_max_s=60.0, flap_count=5,
                 flap_window_s=60.0):
        if flap_count < 1:
            raise ValueError("flap_count must be >= 1")
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self.flap_count = int(flap_count)
        self.flap_window_s = float(flap_window_s)

    def delay_s(self, key, strikes):
        """Backoff before the respawn that follows strike #strikes."""
        if self.backoff_s <= 0.0 or strikes <= 0:
            return 0.0
        raw = min(self.backoff_s * 2.0 ** (strikes - 1), self.backoff_max_s)
        return raw * _jitter_factor(str(key), strikes)


class RespawnTracker(object):
    """Per-slot death ledger: feed it deaths, obey its verdicts.

    ``record_death(now)`` returns either

    * ``{"action": "respawn", "delay_s": float, "not_before": now+delay,
       "strikes": n}`` — respawn after the backoff, or
    * ``{"action": "park", "deaths": k, "window_s": w, "strikes": n}``
      — the slot flapped; park it forever.

    ``due(now)`` answers "has the last verdict's backoff elapsed" so a
    polling loop can defer the actual spawn without sleeping.
    """

    __slots__ = ("policy", "key", "deaths", "strikes", "parked",
                 "not_before", "total_deaths")

    def __init__(self, policy, key):
        self.policy = policy
        self.key = str(key)
        self.deaths = []        # death timestamps inside the flap window
        self.strikes = 0        # consecutive fast deaths (backoff exponent)
        self.parked = False
        self.not_before = 0.0   # earliest time the next respawn may run
        self.total_deaths = 0

    def record_death(self, now):
        self.total_deaths += 1
        win = self.policy.flap_window_s
        self.deaths = [t for t in self.deaths if now - t < win]
        self.deaths.append(now)
        if self.parked or len(self.deaths) >= self.policy.flap_count:
            self.parked = True
            return {"action": PARK, "deaths": len(self.deaths),
                    "window_s": win, "strikes": self.strikes}
        # strikes reset when the child outlived the flap window: only
        # deaths still inside the window count toward the exponent.
        self.strikes = len(self.deaths)
        delay = self.policy.delay_s(self.key, self.strikes)
        self.not_before = now + delay
        return {"action": RESPAWN, "delay_s": delay,
                "not_before": self.not_before, "strikes": self.strikes}

    def due(self, now):
        """True when a pending respawn's backoff has elapsed."""
        return (not self.parked) and now >= self.not_before

    def state(self):
        return {"key": self.key, "parked": self.parked,
                "strikes": self.strikes, "deaths": self.total_deaths,
                "not_before": self.not_before}
