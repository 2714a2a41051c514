"""The port's ``pploadgen`` against the JAX package's.

The arrival schedule for a seed equals the reference's; spooled request
copies get the reference's names; SLO specs load the same; and
``summarize_load`` builds the same report (schema ``pptpu-loadgen-v1``)
from the same client results and server snapshot, passes and breaches
alike.  Then the CLI end to end against a port daemon serving on the
CPU over its socket: a closed-loop run within a lenient SLO exits 0
with every request a fresh fit (no replay), and an SLO the run cannot
meet exits nonzero.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.cli import pploadgen as jlg
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.obs import metrics as JM
from pulseportraiture_tpu_torch.cli import pploadgen as tlg
from pulseportraiture_tpu_torch.obs import metrics as TM
from pulseportraiture_tpu_torch.service import ServiceServer, TOAService

MODEL_PARAMS = np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5])


@pytest.mark.parametrize("n,rate,seed", [(1, 1.0, 0), (50, 4.0, 7),
                                         (2000, 0.5, 123)])
def test_arrival_schedule_equals_reference(n, rate, seed):
    assert tlg.arrival_schedule(n, rate, seed) == \
        jlg.arrival_schedule(n, rate, seed)


def test_build_requests_and_slo_equal_reference(tmp_path):
    srcs = []
    for i in range(2):
        p = tmp_path / ("src%d.fits" % i)
        p.write_bytes(b"payload-%d" % i)
        srcs.append(str(p))
    t = tlg.build_requests(srcs, 5, ["alice", "bob"],
                           str(tmp_path / "tspool"), seed=7)
    r = jlg.build_requests(srcs, 5, ["alice", "bob"],
                           str(tmp_path / "rspool"), seed=7)
    assert [(a, os.path.basename(b)) for a, b in t] == \
        [(a, os.path.basename(b)) for a, b in r]
    assert all(open(b, "rb").read() == open(srcs[i % 2], "rb").read()
               for i, (_, b) in enumerate(t))
    spec = {"p99_s": 2.0, "max_error_rate": 0.1}
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(spec))
    for arg in (json.dumps(spec), str(path), None):
        assert tlg.load_slo(arg) == jlg.load_slo(arg)
    assert tlg.parse_classes("2,0,1", "1.5,none,-") == \
        jlg.parse_classes("2,0,1", "1.5,none,-")


def _results(mod, latencies, errors=0, cached=0):
    out = []
    for i, lat in enumerate(latencies):
        r = mod._Result("t%d" % (i % 2), "a%d.fits" % i)
        r.latency_s = lat
        r.ok = i >= errors
        r.state = "done" if r.ok else "quarantined"
        r.cached = i < cached
        r.trace_id = "%032x" % (i + 1)
        r.priority = i % 2
        r.deadline_s = 0.25 if i % 3 == 0 else None
        r.deadline_miss = r.deadline_s is not None and lat > 0.25
        r.rerouted = i % 2
        if not r.ok:
            r.error = "state=quarantined"
        out.append(r)
    return out


def _snapshot(mod):
    reg = mod.MetricsRegistry()
    for v in (0.1, 0.3):
        reg.observe(mod.PHASE_HISTOGRAM, v, phase="total", tenant="a")
    reg.observe(mod.PHASE_HISTOGRAM, 0.2, phase="total", tenant="b")
    reg.observe(mod.PHASE_HISTOGRAM, 0.05, phase="fit", bucket="8x64")
    return reg.snapshot()


@pytest.mark.parametrize("case", [
    dict(lat=[0.1, 0.2, 0.2, 0.4], errors=0,
         slo={"p99_s": 1.0, "max_error_rate": 0.0,
              "min_throughput_rps": 1.0, "min_requests": 4}),
    dict(lat=[0.1, 0.2, 0.2, 0.4], errors=2, slo={"max_error_rate": 0.1}),
    dict(lat=[0.11, 0.31, 0.21, 3.0, 0.05], errors=1, cached=1,
         slo={"p50_s": 0.1, "p99_s": 0.5}, server=True),
    dict(lat=[0.3] * 7, errors=0, slo=None, server=True),
], ids=["pass", "error_breach", "latency_breach_server", "no_slo"])
def test_summarize_load_equals_reference(case):
    """The same results (and server snapshot) give the reference's
    report, key for key; the SLO verdict and breaches included."""
    kw = dict(wall_s=2.0, slo=case["slo"])
    snap = _snapshot(TM) if case.get("server") else None
    if snap is not None:
        # the two registries' snapshots agree but for their clocks
        ref_snap = _snapshot(JM)
        clocks = ("t", "uptime_s")
        assert {k: v for k, v in snap.items() if k not in clocks} == \
            {k: v for k, v in ref_snap.items() if k not in clocks}
    t = tlg.summarize_load(
        _results(tlg, case["lat"], case["errors"], case.get("cached", 0)),
        server_snapshot=json.loads(json.dumps(snap)), **kw)
    r = jlg.summarize_load(
        _results(jlg, case["lat"], case["errors"], case.get("cached", 0)),
        server_snapshot=json.loads(json.dumps(snap)), **kw)
    assert t["schema"] == "pptpu-loadgen-v1"
    assert json.loads(json.dumps(t)) == json.loads(json.dumps(r))
    if case["slo"] is not None:
        assert t["slo"]["ok"] is (case["errors"] == 0
                                  and "p50_s" not in case["slo"])


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    """A port daemon on the CPU behind its socket, and two archives."""
    tmp = tmp_path_factory.mktemp("torch_loadgen")
    gm = str(tmp / "s.gmodel")
    write_model(gm, "s", "000", 1500.0, MODEL_PARAMS, np.ones(8, int),
                -4.0, 0, quiet=True)
    par = str(tmp / "s.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    files = []
    for i in range(2):
        out = str(tmp / ("s%d.fits" % i))
        make_fake_pulsar(gm, par, out, nsub=2, nchan=8, nbin=64,
                         nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.02 * (i + 1), dDM=5e-4, noise_stds=0.01,
                         dedispersed=False, seed=300 + i, quiet=True)
        files.append(out)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    wd = tmp / "wd"
    svc = TOAService(gm, str(wd), batch_window_s=0.2, batch_max=4,
                     backoff_s=0.0, get_toas_kw={"bary": False},
                     quiet=True, device="cpu").start()
    server = ServiceServer(svc, str(wd / "ppserve.sock")).start()
    try:
        yield SimpleNamespace(wd=str(wd), files=files, svc=svc)
    finally:
        server.stop()
        svc.shutdown(timeout=120)
        torch.set_num_threads(n_threads)


def test_pploadgen_cli_slo_gate(daemon, tmp_path, capsys):
    """Closed loop, two tenants, fresh spooled copies: a lenient SLO
    passes (exit 0, no cached replays, the server's total phase seen);
    an impossible p50 bound breaches (exit 1) on a second schedule."""
    out = str(tmp_path / "rep.json")
    rc = tlg.main(["-w", daemon.wd, "-t", "alice,bob", "--archives"]
                  + daemon.files + ["-n", "4", "--mode", "closed",
                                    "--concurrency", "2", "--seed", "3",
                                    "--timeout", "300", "--slo",
                                    '{"p99_s": 120.0, "max_error_rate": '
                                    '0.0, "min_requests": 4}',
                                    "--out", out, "--quiet"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, line
    assert line["n_ok"] == 4 and line["slo_ok"] is True
    rep = json.load(open(out))
    assert rep["schema"] == "pptpu-loadgen-v1"
    assert rep["n_cached"] == 0 and rep["n_err"] == 0
    assert rep["server"]["phases"]["total"]["n"] >= 4
    rc = tlg.main(["-w", daemon.wd, "--archives"] + daemon.files
                  + ["-n", "2", "--mode", "open", "--rate", "20",
                     "--seed", "4", "--timeout", "300", "--no_trace",
                     "--slo", '{"p50_s": 1e-6}', "--quiet"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and line["slo_ok"] is False and line["n_ok"] == 2


def test_pploadgen_without_daemon_exits_2(tmp_path):
    assert tlg.main(["-w", str(tmp_path), "--archives", "x.fits",
                     "-n", "1"]) == 2
