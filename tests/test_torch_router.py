"""The port's fleet router (``service/router.py``, ``cli/pprouter``)
against the JAX package's.

Unit level, both packages' routers driven through the same operations
with no processes (daemons marked adopted and ready by hand): sticky
and load-based bucket assignment, the load rebalance and its
last-bucket guard, daemon-down re-routing — the same assignment tables
— plus memory admission and a draining router's rejection.  Integration
level: the port's router over two ADOPTED in-process port daemons
serving on the CPU (routing, namespaced waits, merged metrics, fleet
health, drain).  Chaos level: a spawned fleet of two port daemons
(``--device cpu``) whose one-shot ``sigkill`` fault kills each at its
first dispatch — respawned in place exactly once, every archive done
exactly once across the fleet's ledgers.  The reference's own chaos
test (tests/test_router.py) covers its side; this one runs the port's
fleet only.  The spawned daemon command is the port's ppserve with the
router's ``--device``.
"""

import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.service import FleetRouter as JFleetRouter
from pulseportraiture_tpu_torch import obs
from pulseportraiture_tpu_torch.runner.plan import plan_survey
from pulseportraiture_tpu_torch.service import (DEFAULT_ROUTER_SOCKET_NAME,
                                                FleetRouter, ServiceServer,
                                                TOAService, client_request)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_PARAMS = np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5])
WAIT_S = 300


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_router")
    gm = str(tmp / "r.gmodel")
    write_model(gm, "r", "000", 1500.0, MODEL_PARAMS,
                np.ones(8, int), -4.0, 0, quiet=True)
    par = str(tmp / "r.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    files = []
    for i in range(4):
        out = str(tmp / f"r{i}.fits")
        make_fake_pulsar(gm, par, out, nsub=2, nchan=8, nbin=64,
                         nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.02 * (i + 1), dDM=5e-4,
                         noise_stds=0.01, dedispersed=False,
                         seed=70 + i, quiet=True)
        files.append(out)
    return SimpleNamespace(tmp=tmp, gm=gm, par=par, files=files,
                           plan=plan_survey(files, modelfile=gm))


def _bare(cls, corpus, workdir, n=3, **kw):
    """A router that is never start()ed, its daemons marked adopted and
    ready by hand (the port's on the CPU)."""
    if cls is FleetRouter:
        kw.setdefault("device", "cpu")
    r = cls(corpus.gm, str(workdir), n_daemons=n, **kw)
    for d in r._daemons:
        d.adopted = True
        d.ready.set()
    return r


def _table(r):
    return {b: d.name for b, d in sorted(r._assign.items())}


def _both(corpus, tmp_path, **kw):
    return [_bare(cls, corpus, tmp_path / tag, **kw)
            for cls, tag in ((FleetRouter, "port"), (JFleetRouter, "ref"))]


# -- unit: the same routing decisions as the reference ------------------


def test_assignment_sticky_and_load_based_equals_reference(corpus,
                                                           tmp_path):
    tables = []
    for r in _both(corpus, tmp_path):
        d0, d1, d2 = r._daemons
        d0.open_requests, d1.open_requests, d2.open_requests = 5, 1, 3
        assert r._owner((8, 64)) is d1            # least loaded owns it
        d1.open_requests = 9
        assert r._owner((8, 64)) is d1            # sticky
        assert r._owner((16, 128)) is d2
        assert r._owner(None) is d2               # by load, unassigned
        assert None not in r._assign
        tables.append(_table(r))
    assert tables[0] == tables[1] == {(8, 64): "d1", (16, 128): "d2"}


def test_rebalance_and_last_bucket_guard_equal_reference(corpus, tmp_path):
    tables = []
    for r in _both(corpus, tmp_path, rebalance_delta=4):
        d0, d1, d2 = r._daemons
        for b in ((8, 64), (16, 64), (32, 128)):
            d0.buckets.add(b)
            r._assign[b] = d0
        r._bucket_routed = {(8, 64): 50, (16, 64): 1, (32, 128): 9}
        d0.open_requests, d1.open_requests, d2.open_requests = 9, 1, 5
        r._rebalance()
        first = _table(r)
        d0.open_requests = 2                      # below the skew
        r._rebalance()
        assert _table(r) == first
        # a daemon's only bucket never moves
        d2.buckets = {(64, 256)}
        r._assign[(64, 256)] = d2
        d1.buckets = set()
        d2.open_requests, d1.open_requests = 20, 0
        r._rebalance()
        tables.append((first, _table(r)))
    assert tables[0] == tables[1]
    assert tables[0][0][(16, 64)] == "d1" and tables[0][0][(8, 64)] == "d0"
    assert tables[0][1][(64, 256)] == "d2"


def test_daemon_down_reroutes_equal_reference(corpus, tmp_path):
    tables = []
    for r in _both(corpus, tmp_path):
        d0, d1, d2 = r._daemons
        for b in ((8, 64), (16, 128)):
            d0.buckets.add(b)
            r._assign[b] = d0
        d1.open_requests, d2.open_requests = 3, 1
        r._daemon_down(d0, "test_kill")
        assert not d0.ready.is_set() and not d0.buckets
        assert d0.respawns == 0                   # adopted: not ours
        tables.append(_table(r))
    assert tables[0] == tables[1]
    assert set(tables[0].values()) <= {"d1", "d2"}


def test_memory_admission_and_drain(corpus, tmp_path):
    r = _bare(FleetRouter, corpus, tmp_path / "rt", mem_budget_bytes=1)
    with obs.run("rt-test", base_dir=str(tmp_path / "obs")):
        resp = r.submit("alice", corpus.files[0])
    assert resp["ok"] is False and resp["error"] == "memory"
    assert resp["est_bytes"] > 1
    r._draining = True
    assert r.submit("alice", corpus.files[0]) == {"ok": False,
                                                  "error": "draining"}


def test_crash_looping_daemon_parks_after_flap_threshold(corpus,
                                                         tmp_path):
    """Below the flap threshold a dead daemon respawns in place; at it
    the slot parks (``router_flap``); an adopted daemon never counts."""
    r = FleetRouter(corpus.gm, str(tmp_path / "rt"), n_daemons=3,
                    flap_count=2, flap_window_s=60.0, device="cpu")
    for d in r._daemons:
        d.ready.set()
    d0 = r._daemons[0]
    spawns = []
    r._spawn = lambda d, first: spawns.append((d.name, first))
    with obs.run("rt-flap", base_dir=str(tmp_path / "obs")) as rec:
        r._daemon_down(d0, "test_kill")
        assert spawns == [("d0", False)] and d0.respawns == 1
        assert r.status()["daemons"]["d0"]["parked"] is False
        d0.ready.set()
        r._daemon_down(d0, "test_kill")
        assert spawns == [("d0", False)] and d0.respawns == 1
        assert r.status()["daemons"]["d0"]["parked"] is True
        run_dir = rec.dir
    names = []
    for path in obs.list_event_files(run_dir):
        with open(path, encoding="utf-8") as fh:
            names += [json.loads(ln).get("name") for ln in fh if ln.strip()]
    assert names.count("router_respawn") == 1
    assert names.count("router_flap") == 1
    adopted = _bare(FleetRouter, corpus, tmp_path / "ad", flap_count=1)
    a0 = adopted._daemons[0]
    for _ in range(3):
        a0.ready.set()
        adopted._daemon_down(a0, "test_kill")
    assert adopted.status()["daemons"]["d0"]["parked"] is False
    assert a0.respawns == 0


def test_daemon_command_is_the_ports_ppserve(corpus, tmp_path):
    r = FleetRouter(corpus.gm, str(tmp_path / "rt"), n_daemons=1,
                    plan=corpus.plan, compile_cache=str(tmp_path / "k"),
                    daemon_args=["--no_bary"], device="cpu")
    cmd = r._daemon_cmd()
    assert cmd[:4] == [sys.executable, "-m",
                       "pulseportraiture_tpu_torch.cli.ppserve", "start"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--compile-cache") + 1] == str(tmp_path / "k")
    assert "--warm" in cmd and cmd[-1] == "--no_bary"


# -- integration: routing over adopted in-process daemons ---------------


def test_router_over_adopted_daemons_end_to_end(corpus, tmp_path):
    """Two live in-process port daemons behind a router socket: bucket
    routing, namespaced request ids, wait, merged fleet metrics, fleet
    health, status and a fleet drain."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    daemons, servers = [], []
    try:
        for i in range(2):
            wd = tmp_path / ("d%d" % i)
            svc = TOAService(corpus.gm, str(wd), batch_window_s=0.2,
                             batch_max=4, backoff_s=0.0,
                             get_toas_kw={"bary": False}, quiet=True,
                             device="cpu").start()
            srv = ServiceServer(svc, str(wd / "ppserve.sock")).start()
            daemons.append(svc)
            servers.append(srv)
        router = FleetRouter(
            corpus.gm, str(tmp_path / "rt"),
            adopt_sockets=[s.socket_path for s in servers],
            health_interval_s=0.2, device="cpu")
        router.start(ready_timeout=30)
        rsock = str(tmp_path / "rt" / DEFAULT_ROUTER_SOCKET_NAME)
        rserver = ServiceServer(router, rsock).start()
        try:
            assert all(d.ready.is_set() for d in router._daemons)
            resps = []
            for i, path in enumerate(corpus.files[:3]):
                resp = client_request(
                    rsock, {"op": "submit", "tenant": "alice",
                            "archive": path, "wait": True,
                            "timeout_s": WAIT_S, "priority": i % 2,
                            "deadline_s": 300.0}, timeout=WAIT_S + 30)
                assert resp.get("ok") and resp["state"] == "done", resp
                assert resp.get("deadline_miss") is False
                resps.append(resp)
            owners = {r["request_id"].split(":")[0] for r in resps}
            assert len(owners) == 1, owners       # one bucket, one daemon
            owner = owners.pop()
            assert router._assign[(8, 64)].name == owner
            rid = resps[0]["request_id"]
            w = client_request(rsock, {"op": "wait", "request_id": rid,
                                       "timeout_s": 60}, timeout=90)
            assert w["state"] == "done" and w["request_id"] == rid
            h = client_request(rsock, {"op": "health"}, timeout=30)
            assert h["ok"] and h["ready"] and h["daemons_ready"] == 2
            snap = client_request(rsock, {"op": "metrics"},
                                  timeout=60)["snapshot"]
            assert len(snap.get("merged_from") or []) == 3
            routed = sum(v for k, v in snap["counters"].items()
                         if k.startswith("pps_routed_total"))
            assert routed >= 3
            st = client_request(rsock, {"op": "status"}, timeout=30)
            assert st["assignment"].get("8x64") == owner
            sh = client_request(rsock, {"op": "shutdown"}, timeout=30)
            assert sh["ok"] and sh["draining"]
            assert router.drained(timeout=5)      # adopted-only fleet
            assert all(svc.drained(timeout=60) for svc in daemons)
        finally:
            rserver.stop()
            router._stop.set()
            router._obs_stack.close()
    finally:
        for srv in servers:
            srv.stop()
        for svc in daemons:
            svc.shutdown(timeout=60)
        torch.set_num_threads(n_threads)


# -- chaos: SIGKILL mid-dispatch -> respawn, exactly once ---------------


def test_fleet_sigkill_respawn_exactly_once(corpus, tmp_path,
                                            monkeypatch):
    """Every spawned port daemon (``--device cpu``) carries a one-shot
    ``sigkill`` fault that kills it at its first dispatch.  The
    supervisor respawns each in place without the fault, the in-flight
    forward retries against the SAME daemon, and the tenant ledgers keep
    every archive's result exactly once."""
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fleet_wd = str(tmp_path / "fleet")
    router = FleetRouter(
        corpus.gm, fleet_wd, n_daemons=2, batch_window_s=0.1,
        batch_max=4, health_interval_s=0.25, unhealthy_after=2,
        respawn_timeout_s=120.0,
        daemon_args=["--no_bary", "--backoff", "0.0"],
        daemon_env={"PPTPU_FAULTS": "sigkill@after=1,at=dispatch"},
        quiet=True, device="cpu")
    router.start(ready_timeout=120)
    try:
        assert all(d.ready.is_set() for d in router._daemons)
        for i, path in enumerate(corpus.files[:3]):
            resp = router.submit("alice" if i % 2 else "bob", path,
                                 wait=True, timeout=WAIT_S)
            assert resp.get("ok") and resp["state"] == "done", resp
        assert sum(d.respawns for d in router._daemons) >= 1, \
            "sigkill fault never fired"
        blocks = 0
        for root, _dirs, names in os.walk(fleet_wd):
            for name in names:
                if name == "toas.tim":
                    with open(os.path.join(root, name)) as fh:
                        blocks += sum(1 for ln in fh
                                      if ln.split()[:2] == ["C", "pp_done"])
        assert blocks == 3, blocks
        deadline = time.time() + 120
        while time.time() < deadline and not all(
                d.ready.is_set() for d in router._daemons):
            time.sleep(0.25)
        h = router.health()
        assert h["ready"] and h["daemons_ready"] == 2, h
        assert all(d.respawns <= 1 for d in router._daemons)
    finally:
        assert router.shutdown(timeout=120)
    assert all(d.proc.returncode == 0 for d in router._daemons)
    evs = []
    obs_root = os.path.join(fleet_wd, "obs")
    for run in sorted(os.listdir(obs_root)):
        for path in obs.list_event_files(os.path.join(obs_root, run)):
            with open(path, encoding="utf-8") as fh:
                evs.extend(json.loads(ln) for ln in fh if ln.strip())
    names = {e.get("name") for e in evs}
    assert {"router_daemon_down", "router_respawn"} <= names
