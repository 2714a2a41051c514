"""The port's TOA service (``service/``, ``cli/ppserve``) against the JAX
package's.

One corpus, written by the JAX package's ``make_fake_pulsar`` (8
channels x 64 bins, 2 subints, as tests/test_service.py).  Both
packages' daemons serve the same schedule once (a module fixture: four
same-bucket requests from two tenants, then a duplicate submission):
TOAs within 1 ns per archive, the same ledger states, the same
``microbatch_dispatch`` (n_requests, batch) and the same replay.  The
port's micro-batcher joins its callers' tensors on their own device
(a fake fit sees tensors; on the ``meta`` device, which has no host
copy, the join still runs) and a coalesced dispatch's rows equal the
solo dispatches' — the port's own and the reference's — within 1e-8 in
phi and DM.  Then the daemon's promises, on the port alone (the
reference's tests/test_service.py holds its side): static-key
splits, group errors, backpressure and fairness, chaos isolation and a
transient retry, drain, quarantine and restart recovery, the run-dir
budget, the adaptive window (its numbers equal to the reference's),
the solo late arriver, the socket protocol and metrics verb, the
``--watch`` frame, a concurrent device-profile capture degrading to
``trace_skipped``, the warm enumeration (equal to the reference's) and
a warm daemon's zero kernel builds.  Everything runs on the CPU
(``device="cpu"`` for the port).
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pulseportraiture_tpu import obs as jobs
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.obs import core as jcore
from pulseportraiture_tpu.runner.plan import plan_survey as jplan_survey
from pulseportraiture_tpu.service import TOAService as JTOAService
from pulseportraiture_tpu.service import daemon as jdaemon
from pulseportraiture_tpu.service import program_specs as jprogram_specs
from pulseportraiture_tpu.testing import faults as jfaults
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch import obs as tobs
from pulseportraiture_tpu_torch.obs import core as tcore
from pulseportraiture_tpu_torch.runner.plan import plan_survey
from pulseportraiture_tpu_torch.runner.queue import WorkQueue
from pulseportraiture_tpu_torch.service import (MicroBatcher, Request,
                                                ServiceServer, TOAService,
                                                client_request,
                                                program_specs)
from pulseportraiture_tpu_torch.service import daemon as tdaemon
from pulseportraiture_tpu_torch.service.batcher import _static_key
from pulseportraiture_tpu_torch.testing import faults
from pulseportraiture_tpu_torch.utils.databunch import DataBunch
from torch_tim import assert_same_tim, lines

MODEL_PARAMS = np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5])
# the parity schedule: (tenant, archive index), submitted back to back
SCHEDULE = [("alice", 0), ("bob", 1), ("alice", 2), ("bob", 3)]
# ledger-record fields that name a process, a time or a trace
VOLATILE = ("t", "owner", "lease_expires_at", "seq", "trace", "pid",
            "retry_at", "renewals", "takeover_from", "prev_owner", "ckpt")
WAIT_S = 300


def _make_archives(tmp, gm, par, n, nchan=8, nbin=64, nsub=2, seed0=90,
                   prefix="s"):
    files = []
    for i in range(n):
        out = str(tmp / f"{prefix}{i}.fits")
        make_fake_pulsar(gm, par, out, nsub=nsub, nchan=nchan,
                         nbin=nbin, nu0=1500.0, bw=800.0, tsub=60.0,
                         phase=0.02 * (i + 1), dDM=5e-4,
                         noise_stds=0.01, dedispersed=False,
                         seed=seed0 + i, quiet=True)
        files.append(out)
    return files


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_fresh_jit_caches():
    """Small CPU fits: one intra-op thread each (the daemon runs several
    fit threads at once).  The reference fits add variants to the JAX
    package's jit caches, which tests/test_retrace_budget.py holds to a
    budget in whatever process runs it next: drop them at the end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    """No fault spec and empty span stacks around every test (an
    exception escaping a ``phases`` region leaves its span on the
    thread's stack in both packages, ROADMAP Queue C)."""
    monkeypatch.delenv("PPTPU_FAULTS", raising=False)
    monkeypatch.delenv("PPTPU_TRACE_DIR", raising=False)
    faults.reset()
    jfaults.reset()
    for core in (jcore, tcore):
        core._tls.stack = []
    yield
    faults.reset()
    jfaults.reset()
    for core in (jcore, tcore):
        core._tls.stack = []


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_service")
    gm = str(tmp / "s.gmodel")
    write_model(gm, "s", "000", 1500.0, MODEL_PARAMS,
                np.ones(8, int), -4.0, 0, quiet=True)
    par = str(tmp / "s.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    files = _make_archives(tmp, gm, par, 6)
    return SimpleNamespace(tmp=tmp, gm=gm, par=par, files=files,
                           plan=plan_survey(files, modelfile=gm))


def _service(corpus, workdir, **kw):
    kw.setdefault("batch_window_s", 0.2)
    kw.setdefault("batch_max", 4)
    kw.setdefault("backoff_s", 0.0)
    kw.setdefault("get_toas_kw", {"bary": False})
    kw.setdefault("quiet", True)
    kw.setdefault("device", "cpu")
    return TOAService(corpus.gm, str(workdir), **kw)


def _events(obs_mod, run_dir):
    out = []
    for path in obs_mod.list_event_files(run_dir):
        with open(path, encoding="utf-8") as fh:
            out.extend(json.loads(ln) for ln in fh if ln.strip())
    return out


def _drive(cls, obs_mod, corpus, workdir, **kw):
    """Serve SCHEDULE, then a duplicate of its first submission (the
    cycle fires when its 4 requests are in; the long window keeps a slow
    member, such as the reference's first compile, from splitting it)."""
    svc = cls(corpus.gm, str(workdir), batch_window_s=2.0, batch_max=4,
              backoff_s=0.0, get_toas_kw={"bary": False}, quiet=True,
              **kw).start()
    run_dir = obs_mod.current().dir
    try:
        ids = [svc.submit(t, corpus.files[i])["request_id"]
               for t, i in SCHEDULE]
        res = [svc.wait(rid, timeout=WAIT_S) for rid in ids]
        replay = svc.submit("alice", corpus.files[0], wait=True,
                            timeout=60)
        status = svc.status()
    finally:
        drained = svc.shutdown(timeout=120)
    return SimpleNamespace(res=res, replay=replay, status=status,
                           events=_events(obs_mod, run_dir),
                           wd=str(workdir), drained=drained)


@pytest.fixture(scope="module")
def parity(corpus):
    """One reference daemon run and one port daemon run of SCHEDULE."""
    ref = _drive(JTOAService, jobs, corpus, corpus.tmp / "ref_wd")
    port = _drive(TOAService, tobs, corpus, corpus.tmp / "port_wd",
                  device="cpu")
    return SimpleNamespace(ref=ref, port=port)


def _archive_tim(ckpt, archive, out):
    """One archive's TOA lines of a tenant checkpoint, as a .tim file."""
    with open(out, "w") as f:
        f.write("FORMAT 1\n")
        for tok in lines(ckpt, skip_comments=True):
            if tok[0] == archive:
                f.write(" ".join(tok) + "\n")
    return out


def _ledger(wd, tenant):
    """{archive: [stable ledger record]} of a tenant's ledger."""
    out = {}
    path = os.path.join(wd, "tenants", tenant, "ledger.0.jsonl")
    with open(path) as fh:
        for ln in fh:
            rec = json.loads(ln)
            out.setdefault(rec["archive"], []).append(
                {k: v for k, v in rec.items() if k not in VOLATILE})
    return out


# -- parity with the reference daemon -----------------------------------


def test_served_toas_equal_reference(parity, corpus, tmp_path):
    """Each archive's TOAs in its tenant's toas.tim within 1 ns of the
    reference daemon's, every flag (-pp_tenant too) equal to its
    printed digit; the responses carry the same TOA counts."""
    assert parity.ref.drained and parity.port.drained
    for tenant, i in SCHEDULE:
        f = corpus.files[i]
        ckpts = [os.path.join(run.wd, "tenants", tenant, "toas.tim")
                 for run in (parity.port, parity.ref)]
        tims = [_archive_tim(c, f, str(tmp_path / ("%s%d.tim" % (tag, i))))
                for c, tag in zip(ckpts, ("port", "ref"))]
        assert_same_tim(*tims, n=2)
    for rp, rr in zip(parity.port.res, parity.ref.res):
        assert rp["state"] == rr["state"] == "done", (rp, rr)
        assert rp["n_toas"] == rr["n_toas"] == 2
        assert len(rp["toa_lines"]) == 2
        assert all("-pp_tenant %s" % rp["tenant"] in ln
                   for ln in rp["toa_lines"])


def test_dispatches_ledgers_and_replay_equal_reference(parity):
    """Same coalescing (one dispatch of 4 requests, 8 subints), the same
    ledger records per archive, the same replay and bucket counters."""
    def dispatches(run):
        return [(e["n_requests"], e["batch"]) for e in run.events
                if e.get("name") == "microbatch_dispatch"]

    assert dispatches(parity.port) == dispatches(parity.ref) == [(4, 8)]
    for tenant in ("alice", "bob"):
        assert _ledger(parity.port.wd, tenant) == \
            _ledger(parity.ref.wd, tenant)
    for key in ("cached", "state", "n_toas", "request_id"):
        assert parity.port.replay.get(key) == parity.ref.replay.get(key)
    assert parity.port.replay["cached"] is True
    keys = ("requests", "dispatches", "coalesced", "fit_calls")
    sp, sr = parity.port.status["buckets"], parity.ref.status["buckets"]
    assert {b: {k: v[k] for k in keys} for b, v in sp.items()} == \
        {b: {k: v[k] for k in keys} for b, v in sr.items()}
    assert parity.port.status["device"] == "cpu"
    batches = [e for e in parity.port.events
               if e.get("name") == "service_batch"]
    assert batches and batches[0]["tenants"] == ["alice", "bob"]


# -- the micro-batcher ---------------------------------------------------


def _stub_fit_calls():
    calls = []

    def fit(*args, **kw):
        calls.append((args, kw))
        B = args[0].shape[0]
        return DataBunch(phi=torch.arange(B, dtype=torch.float64,
                                          device=args[0].device),
                         scalar=1.0)
    return calls, fit


def _run_cycle(batcher, arg_sets):
    """Drive N worker threads through one batcher cycle; returns each
    worker's result (or exception)."""
    out = [None] * len(arg_sets)

    def work(i):
        args, kw = arg_sets[i]
        try:
            out[i] = batcher.fit(*args, **kw)
        except Exception as e:  # noqa: BLE001 — assertion payload
            out[i] = e
        finally:
            batcher.worker_done()

    batcher.begin(len(arg_sets))
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(arg_sets))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive(), "a batcher worker did not finish"
    return out


def _fake_args(B, nchan=4, nbin=16, on="cpu", **kw):
    """The argument set the port's pipeline gives the hook: data and one
    shared model as tensors on the fit's device, the rest host arrays."""
    rng = np.random.default_rng(B)
    pulse = np.exp(-0.5 * ((np.arange(nbin) + 0.5) / nbin - 0.5) ** 2
                   / 0.05 ** 2)
    args = (torch.as_tensor(rng.normal(size=(B, nchan, nbin)), device=on),
            torch.as_tensor(np.tile(pulse, (nchan, 1)), device=on),
            np.zeros((B, 5)), np.full(B, 0.005),
            np.broadcast_to(np.linspace(1.0, 2.0, nchan), (B, nchan)).copy())
    base = dict(errs=rng.uniform(1.0, 2.0, (B, nchan)),
                weights=np.ones((B, nchan)),
                nu_fits=np.full((B, 3), 1.5),
                nu_outs=(None, None, np.full(B, 1.4)),
                bounds=[(None, None), (None, None), (None, None),
                        (np.log10(1.0 / 640), None), (-10.0, 10.0)],
                log10_tau=False, max_iter=50, fit_flags=(1, 1, 0, 0, 0),
                device=torch.device(on))
    base.update(kw)
    return args, base


def test_batcher_coalesces_same_config_and_splits_rows():
    calls, fit = _stub_fit_calls()
    b = MicroBatcher(bucket=(4, 16), window_s=5.0, fit=fit)
    out = _run_cycle(b, [_fake_args(2), _fake_args(3)])
    assert len(calls) == 1, "same-config calls must share a dispatch"
    args, kw = calls[0]
    assert args[0].shape[0] == 5  # joined batch
    assert kw["scan_size"] is None and "pad_to" not in kw  # resized
    assert b._sized_kw(dict(scan_size=None), 129)["scan_size"] == 100
    assert b.n_dispatches == 1 and b.n_coalesced == 2 and b.n_calls == 2
    assert out[0].phi.shape == (2,) and out[1].phi.shape == (3,)
    # rows split back in parking order, scalars shared
    torch.testing.assert_close(torch.cat([out[0].phi, out[1].phi]),
                               torch.arange(5, dtype=torch.float64))
    assert out[0].scalar == out[1].scalar == 1.0


def test_batcher_joins_tensors_on_the_callers_device():
    """The combined data, models, errs, weights and nu columns reach the
    fit as tensors on the callers' device; each caller's one model is
    expanded to its rows; the result rows are slices of the combined
    output (no copy)."""
    calls, fit = _stub_fit_calls()
    b = MicroBatcher(bucket=(4, 16), window_s=5.0, fit=fit)
    sets = [_fake_args(2), _fake_args(3)]
    out = _run_cycle(b, sets)
    args, kw = calls[0]
    cpu = torch.device("cpu")
    for x in (args[0], args[1], kw["errs"], kw["weights"], kw["nu_fits"],
              kw["nu_outs"][2]):
        assert isinstance(x, torch.Tensor) and x.device == cpu
        assert x.dtype == torch.float64
    assert kw["nu_outs"][:2] == (None, None)
    assert args[1].shape == (5, 4, 16)
    torch.testing.assert_close(args[0], torch.cat([s[0][0] for s in sets]))
    torch.testing.assert_close(kw["errs"], torch.as_tensor(
        np.concatenate([s[1]["errs"] for s in sets])))
    assert isinstance(args[2], np.ndarray) and args[2].shape == (5, 5)
    assert kw["kmax"] is not None  # pinned from the callers' models
    combined = calls[0][1]
    assert combined["device"] == cpu
    assert out[1].phi.data_ptr() == out[0].phi.data_ptr() + 2 * 8


def test_batcher_join_has_no_host_round_trip():
    """On the ``meta`` device (no data, no host copy possible) the whole
    join runs: nothing of the callers' tensors goes to the host."""
    calls, fit = _stub_fit_calls()
    b = MicroBatcher(bucket=(4, 16), window_s=5.0, fit=fit)
    out = _run_cycle(b, [_fake_args(2, on="meta", kmax=8),
                         _fake_args(3, on="meta", kmax=8)])
    assert not any(isinstance(o, Exception) for o in out), out
    args, kw = calls[0]
    for x in (args[0], args[1], kw["errs"], kw["weights"], kw["nu_fits"],
              kw["nu_outs"][2]):
        assert x.device.type == "meta"
    assert args[1].shape == (5, 4, 16)
    assert out[0].phi.device.type == "meta" and out[1].phi.shape == (3,)


@pytest.mark.parametrize("other", [
    dict(fit_flags=(1, 0, 0, 0, 0)),
    dict(device=torch.device("cuda")),
    dict(bounds=None),
    dict(max_iter=30),
], ids=["flags", "device", "bounds", "max_iter"])
def test_batcher_static_key_splits_dispatches(other):
    """A different fit configuration — flags, device, bounds, iteration
    cap — never shares a dispatch; every caller still gets its rows."""
    calls, fit = _stub_fit_calls()
    b = MicroBatcher(bucket=(4, 16), window_s=5.0, fit=fit)
    out = _run_cycle(b, [_fake_args(2), _fake_args(2, **other)])
    assert len(calls) == 2, "config mismatch must not share a dispatch"
    assert all(o.phi.shape == (2,) for o in out)
    # bounds as the port's pipeline gives them (pairs with None, numpy
    # floats) key equal to the same bounds as plain floats
    a = _fake_args(2)[1]
    c = dict(a, bounds=[tuple(None if v is None else float(v) for v in p)
                        for p in a["bounds"]])
    assert _static_key(a) == _static_key(c)


def test_batcher_error_propagates_to_group():
    def fit(*args, **kw):
        raise RuntimeError("device fell over")

    b = MicroBatcher(bucket=(4, 16), window_s=5.0, fit=fit)
    out = _run_cycle(b, [_fake_args(2), _fake_args(2)])
    assert all(isinstance(o, RuntimeError) for o in out)


def test_batcher_combined_matches_solo_real_fit(corpus):
    """A coalesced dispatch returns the rows each solo dispatch gives:
    the port's own solo fits and the reference's, within 1e-8 in phi
    and DM (the reference's own test tolerance), rc and nfeval equal."""
    from pulseportraiture_tpu_torch.fit.portrait import \
        fit_portrait_full_batch
    from pulseportraiture_tpu_torch.runner.execute import _BucketedGetTOAs
    from pulseportraiture_tpu_torch.service.warm import synth_databunch

    gt = _BucketedGetTOAs([], corpus.gm, (8, 64), quiet=True,
                          device="cpu")
    freqs = 1500.0 + 100.0 * (np.arange(8) - 3.5)
    model = gt._build_model(freqs, (np.arange(64) + 0.5) / 64, 0.005,
                            fit_scat=False)
    model_np = model.numpy()
    sets, host = [], []
    for seed in (1, 2):
        d = synth_databunch(model_np, freqs, 2, seed=seed)
        data = np.ascontiguousarray(d.subints[:, 0])
        kw = dict(errs=d.noise_stds[:, 0], weights=d.weights,
                  nu_fits=np.full((2, 3), 1500.0), nu_outs=None,
                  bounds=None, log10_tau=False, max_iter=50,
                  fit_flags=(1, 1, 0, 0, 0))
        rest = (np.zeros((2, 5)), d.Ps, d.freqs)
        sets.append(((torch.as_tensor(data), model) + rest,
                     dict(kw, device=torch.device("cpu"))))
        host.append(((data, np.broadcast_to(model_np, (2, 8, 64))) + rest,
                     kw))
    solo = [fit_portrait_full_batch(*a, **k) for a, k in sets]
    ref = [jfp.fit_portrait_full_batch(*a, **k) for a, k in host]
    b = MicroBatcher(bucket=(8, 64), window_s=5.0)
    combined = _run_cycle(b, sets)
    assert b.n_dispatches == 1 and b.n_coalesced == 2
    for s, r, c in zip(solo, ref, combined):
        for key in ("phi", "DM"):
            assert isinstance(c[key], torch.Tensor)
            np.testing.assert_allclose(c[key].numpy(), s[key].numpy(),
                                       rtol=0, atol=1e-8)
            np.testing.assert_allclose(c[key].numpy(), np.asarray(r[key]),
                                       rtol=0, atol=1e-8)
        for key in ("return_code", "nfeval"):
            np.testing.assert_array_equal(c[key].numpy(), s[key].numpy())


# -- the daemon ----------------------------------------------------------


def test_submit_complete_replay_and_checkpoint(corpus, tmp_path):
    svc = _service(corpus, tmp_path / "wd").start()
    try:
        run_dir = tobs.current().dir
        r = svc.submit("alice", corpus.files[0], wait=True,
                       timeout=WAIT_S)
        assert r["state"] == "done", r
        assert r["n_toas"] == 2 and len(r["toa_lines"]) == 2
        tim = tmp_path / "wd" / "tenants" / "alice" / "toas.tim"
        assert sum(1 for ln in tim.read_text().splitlines()
                   if ln.split()[:2] == ["C", "pp_done"]) == 1
        n_calls0 = sum(b.batcher.n_calls for b in svc._buckets.values())
        launches0 = dict(_kernels.LAUNCHES)
        rp = svc.submit("alice", corpus.files[0], wait=True, timeout=60)
        assert rp.get("cached") and rp["state"] == "done", rp
        assert sum(b.batcher.n_calls
                   for b in svc._buckets.values()) == n_calls0
        assert dict(_kernels.LAUNCHES) == launches0
        assert len(os.listdir(tmp_path / "wd" / "obs_requests")) == 1
    finally:
        assert svc.shutdown(timeout=120)
    phases = [e.get("phase") for e in _events(tobs, run_dir)
              if e.get("name") == "service_request"]
    assert "submitted" in phases and "terminal" in phases


def test_backpressure_rejects_beyond_budget(corpus, tmp_path):
    svc = _service(corpus, tmp_path / "wd", tenant_max_queue=2,
                   batch_window_s=5.0).start()  # hold dispatch open
    try:
        assert svc.submit("alice", corpus.files[0])["ok"]
        assert svc.submit("alice", corpus.files[1])["ok"]
        r3 = svc.submit("alice", corpus.files[2])
        assert not r3["ok"] and r3["error"] == "backpressure", r3
        assert svc.submit("bob", corpus.files[3])["ok"]
    finally:
        assert svc.shutdown(timeout=120)


def test_fairness_flooding_tenant_does_not_starve(corpus, tmp_path):
    svc = _service(corpus, tmp_path / "wd", batch_window_s=0.6,
                   batch_max=2, tenant_max_inflight=1).start()
    try:
        a_ids = [svc.submit("alice", f)["request_id"]
                 for f in corpus.files[:4]]
        b_id = svc.submit("bob", corpus.files[4])["request_id"]
        res_b = svc.wait(b_id, timeout=WAIT_S)
        assert res_b["state"] == "done"
        res_a = [svc.wait(i, timeout=WAIT_S) for i in a_ids]
        assert all(r["state"] == "done" for r in res_a)
        assert res_b["wall_s"] <= max(r["wall_s"] for r in res_a) + 1e-6
    finally:
        assert svc.shutdown(timeout=120)


def _fault_seed_for(path_fault, path_ok, p=0.5):
    for seed in range(200):
        c = SimpleNamespace(p=p, seed=seed)
        fire = faults._Harness._hash_fires
        if fire(c, "archive_read", WorkQueue.key_for(path_fault), 1) \
                and not fire(c, "archive_read",
                             WorkQueue.key_for(path_ok), 1):
            return seed
    raise AssertionError("no discriminating seed found")


def test_chaos_fault_isolated_to_one_request(corpus, tmp_path):
    """A persistent read fault on one archive quarantines exactly that
    request; its cycle sibling from another tenant completes."""
    bad, good = corpus.files[0], corpus.files[1]
    seed = _fault_seed_for(bad, good)
    svc = _service(corpus, tmp_path / "wd", max_attempts=2,
                   batch_window_s=0.4).start()
    faults.configure("site:archive_read@0.5,seed=%d" % seed)
    try:
        rb = svc.submit("alice", bad)
        rg = svc.submit("bob", good)
        wb = svc.wait(rb["request_id"], timeout=WAIT_S)
        wg = svc.wait(rg["request_id"], timeout=WAIT_S)
        assert wg["state"] == "done", wg
        assert wb["state"] == "quarantined", wb
        assert "retries exhausted" in wb["reason"], wb
        assert any(f["site"] == "archive_read" for f in faults.fired())
    finally:
        faults.reset()
        assert svc.shutdown(timeout=120)


def test_chaos_transient_dispatch_fault_retries(corpus, tmp_path):
    svc = _service(corpus, tmp_path / "wd", max_attempts=3,
                   batch_window_s=0.1).start()
    faults.configure("site:dispatch@nth=1")
    try:
        r = svc.submit("alice", corpus.files[2], wait=True,
                       timeout=WAIT_S)
        assert r["state"] == "done", r
        assert r["attempts"] == 1, r
    finally:
        faults.reset()
        assert svc.shutdown(timeout=120)


def test_drain_rejects_new_finishes_accepted(corpus, tmp_path):
    svc = _service(corpus, tmp_path / "wd", batch_window_s=0.5).start()
    r = svc.submit("alice", corpus.files[3])
    assert r["ok"]
    svc.request_drain()
    rejected = svc.submit("alice", corpus.files[4])
    assert not rejected["ok"] and rejected["error"] == "draining"
    assert svc.wait(r["request_id"], timeout=WAIT_S)["state"] == "done"
    assert svc.drained(timeout=60)
    assert svc.shutdown(timeout=60)


def test_intake_quarantine_and_restart_recovery(corpus, tmp_path):
    wd = tmp_path / "wd"
    corrupt = tmp_path / "corrupt.fits"
    corrupt.write_bytes(b"SIMPLE  =                    T" + b"\x00" * 64)
    svc = _service(corpus, wd).start()
    try:
        r = svc.submit("alice", str(corrupt), wait=True, timeout=60)
        assert r["state"] == "quarantined", r
        assert "unreadable at intake" in r["reason"]
    finally:
        assert svc.shutdown(timeout=120)
    os.makedirs(wd / "tenants" / "bob", exist_ok=True)
    q = WorkQueue(str(wd / "tenants" / "bob" / "ledger.0.jsonl"))
    q.add([corpus.files[5]])
    q.close()
    svc2 = _service(corpus, wd).start()
    try:
        deadline = time.time() + WAIT_S
        key = WorkQueue.key_for(corpus.files[5])
        state = None
        while time.time() < deadline:
            with svc2._lock:
                t = svc2._tenants.get("bob")
                state = t.queue.state(key) if t else None
            if state == "done":
                break
            time.sleep(0.1)
        assert state == "done", state
    finally:
        assert svc2.shutdown(timeout=120)


def test_request_run_dir_budget(corpus, tmp_path):
    svc = _service(corpus, tmp_path / "wd", run_dirs_max=2,
                   batch_window_s=0.05).start()
    try:
        for f in corpus.files[:4]:
            r = svc.submit("alice", f, wait=True, timeout=WAIT_S)
            assert r["state"] == "done", r
    finally:
        assert svc.shutdown(timeout=120)
    assert len(os.listdir(tmp_path / "wd" / "obs_requests")) <= 2


def test_adaptive_window_schedule_math_equals_reference(corpus, tmp_path):
    """The adaptive parking window (solo grace, full window when
    joinable, deadline clamp, load stretch, seed order) gives the
    reference's numbers on the same requests."""
    now = time.time()

    def times(daemon_mod, svc):
        def mk(i, priority=0, deadline_s=None):
            rq = daemon_mod.Request("r%06d" % i, "t", "/a%d.fits" % i,
                                    "k%d" % i, None, priority=priority,
                                    deadline_s=deadline_s)
            rq.t_submit = now
            assert rq.state == daemon_mod.PENDING
            return rq

        out = []
        solo = mk(1)
        out.append(svc._fire_at_locked([solo], solo, now))
        other = mk(2)
        svc._requests[other.id] = other
        out.append(svc._fire_at_locked([solo], solo, now))
        tight = mk(3, deadline_s=0.4)
        out.append(svc._fire_at_locked([solo, tight], solo, now))
        for _ in range(8):
            svc._recent_submits.append(now)
        out.append(svc._fire_at_locked([solo, other], solo, now))
        lo, hi = mk(4), mk(5, priority=2)
        near = mk(6, priority=2, deadline_s=0.2)
        seeds = [min([lo, hi, near], key=svc._seed_key).id,
                 min([lo, hi], key=svc._seed_key).id]
        return [t - now for t in out], seeds

    kw = dict(batch_window_s=1.0, batch_max=4, solo_window_s=0.05)
    port = times(tdaemon, TOAService(corpus.gm, str(tmp_path / "p"),
                                     device="cpu", **kw))
    ref = times(jdaemon, JTOAService(corpus.gm, str(tmp_path / "r"), **kw))
    assert port == ref
    stretch = min(tdaemon.WINDOW_STRETCH_MAX, 1.0 + 8 / 4.0)
    np.testing.assert_allclose(
        port[0], [0.05, 1.0, tdaemon.PARK_FRACTION * 0.4, stretch],
        rtol=0, atol=1e-6)  # absolute times of ~1.8e9 s, differenced
    assert port[1] == ["r000006", "r000005"]


def test_solo_late_arriver_skips_window(corpus, tmp_path):
    from pulseportraiture_tpu_torch.obs import metrics as M

    svc = _service(corpus, tmp_path / "wd", batch_window_s=5.0).start()
    try:
        r = svc.submit("alice", corpus.files[1], wait=True,
                       timeout=WAIT_S, deadline_s=120.0)
        assert r["state"] == "done", r
        assert r.get("deadline_miss") is False
        snap = svc.metrics_snapshot()
        qmax = 0.0
        for key, h in (snap.get("histograms") or {}).items():
            name, labels = M.parse_series(key)
            if name == M.PHASE_HISTOGRAM \
                    and labels.get("phase") == "queue_wait":
                qmax = max(qmax, h.get("max") or 0.0)
        assert 0.0 < qmax < 2.0, qmax
        met = sum(v for k, v in snap["counters"].items()
                  if k.startswith("pps_deadline_total")
                  and 'outcome="met"' in k)
        assert met == 1
    finally:
        assert svc.shutdown(timeout=120)


def test_socket_roundtrip_and_metrics_verb(corpus, tmp_path):
    """The JSONL protocol over a Unix socket: ping, submit with wait,
    status (the device and the tenant counts), health, metrics (the
    lifecycle phase histograms and the Prometheus text), an unknown op,
    shutdown; the socket file is gone afterwards."""
    from pulseportraiture_tpu_torch.obs import metrics as M

    svc = _service(corpus, tmp_path / "wd", batch_window_s=2.0,
                   batch_max=2).start()
    sock = str(tmp_path / "wd" / "t.sock")
    server = ServiceServer(svc, sock).start()
    try:
        assert client_request(sock, {"op": "ping"}, timeout=30)["ok"]
        ids = []
        for tenant, path in zip(["alice", "bob"], corpus.files[:2]):
            r = client_request(sock, {"op": "submit", "tenant": tenant,
                                      "archive": path}, timeout=30)
            assert r["ok"], r
            ids.append(r["request_id"])
        for rid in ids:
            w = client_request(sock, {"op": "wait", "request_id": rid,
                                      "timeout_s": WAIT_S},
                               timeout=WAIT_S + 30)
            assert w["state"] == "done", w
        st = client_request(sock, {"op": "status"}, timeout=30)
        assert st["ok"] and st["device"] == "cpu"
        assert st["tenants"]["alice"]["counts"]["done"] == 1
        assert "device_memory" not in st
        h = client_request(sock, {"op": "health"}, timeout=30)
        assert h["live"] and h["ready"] and not h["draining"]
        snap = client_request(sock, {"op": "metrics"},
                              timeout=60)["snapshot"]
        phases = {}
        for key, hist in snap["histograms"].items():
            name, labels = M.parse_series(key)
            if name == M.PHASE_HISTOGRAM:
                ph = labels.get("phase")
                phases[ph] = phases.get(ph, 0) + hist["count"]
        for ph in ("queue_wait", "checkout", "park", "dispatch", "fit",
                   "checkpoint", "total"):
            assert phases.get(ph), (ph, phases)
        assert phases["total"] == 2 and phases["dispatch"] == 1
        prom = client_request(sock, {"op": "metrics",
                                     "format": "prometheus"},
                              timeout=60)["text"]
        assert "# TYPE pps_phase_seconds histogram" in prom
        bad = client_request(sock, {"op": "frobnicate"}, timeout=30)
        assert not bad["ok"] and bad["error"] == "unknown_op"
        sh = client_request(sock, {"op": "shutdown"}, timeout=30)
        assert sh["ok"] and sh["draining"]
        assert svc.drained(timeout=60)
    finally:
        server.stop()
        svc.shutdown(timeout=60)
    assert not os.path.exists(sock)


def test_status_watch_frame_from_daemon_snapshot(corpus, tmp_path,
                                                 capsys):
    """``ppserve status --watch``: two frames rendered from the daemon's
    metrics verb, with per-phase latency rows (the CLI's own loop, now
    in cli/ppserve.py and shared with ppsurvey)."""
    from pulseportraiture_tpu_torch.cli import ppserve, ppsurvey

    assert not hasattr(ppsurvey, "watch_loop")
    svc = _service(corpus, tmp_path / "wd").start()
    server = ServiceServer(svc, str(tmp_path / "wd" / "ppserve.sock"))
    server.start()
    try:
        r = svc.submit("alice", corpus.files[2], wait=True,
                       timeout=WAIT_S)
        assert r["state"] == "done", r
        capsys.readouterr()
        rc = ppserve.main(["status", "-w", str(tmp_path / "wd"),
                           "--watch", "--ticks", "2", "--interval",
                           "0.05"])
        assert rc == 0
        out = capsys.readouterr().out
        assert out.count("ppserve %s" % (tmp_path / "wd")) == 2
        assert "p99" in out and "fit" in out and "total" in out
        assert 'pps_requests_total{outcome="done",tenant="alice"}: 1' \
            in out
    finally:
        server.stop()
        assert svc.shutdown(timeout=120)


def test_concurrent_trace_capture_skips_not_crashes(corpus, tmp_path,
                                                    monkeypatch):
    """The device profiler capture is process-global: two requests of
    one cycle are both inside their archive's capture while they wait
    for each other in the batcher, so one records trace_skipped, and
    both complete."""
    monkeypatch.setenv("PPTPU_TRACE_DIR", str(tmp_path / "traces"))
    svc = _service(corpus, tmp_path / "wd", batch_window_s=2.0,
                   batch_max=2).start()
    try:
        run_dir = tobs.current().dir
        ids = [svc.submit(t, f)["request_id"]
               for t, f in zip(["alice", "bob"], corpus.files[:2])]
        res = [svc.wait(i, timeout=WAIT_S) for i in ids]
        assert [r["state"] for r in res] == ["done", "done"], res
    finally:
        assert svc.shutdown(timeout=120)
    names = [e.get("name") for e in _events(tobs, run_dir)]
    assert names.count("trace_skipped") == 1, names
    assert names.count("trace") == 1
    assert [e["n_requests"] for e in _events(tobs, run_dir)
            if e.get("name") == "microbatch_dispatch"] == [2]


@pytest.mark.parametrize("coalesce", [(), (2,), (4,), (2, 3, 4)])
def test_warm_enumeration_equals_reference(corpus, coalesce):
    """service.program_specs enumerates the reference's programs for the
    same plan (the coalesced batch shapes of each cycle size too)."""
    jplan = jplan_survey(corpus.files, modelfile=corpus.gm)
    port = [s.to_dict() for s in program_specs(corpus.plan,
                                               coalesce=coalesce)]
    ref = [s.to_dict() for s in jprogram_specs(jplan, coalesce=coalesce)]
    assert port == ref and port
    co = [s for s in port if s["kind"] == "coalesced"]
    assert len(co) == len([k for k in coalesce if k > 1])


def test_warm_then_requests_build_no_kernel(corpus, tmp_path_factory,
                                            monkeypatch):
    """A warm daemon with a kernel build directory (the port's
    counterpart of the reference's persistent compile cache, ROADMAP
    Queue C): the build directory is the one given, warm runs every
    planned program (the coalesced batch included), and the requests
    after it build nothing — the daemon's backend_compiles equals its
    warm_backend_compiles gauge and every request manifest reads 0."""
    from pulseportraiture_tpu_torch.cli.ppserve import build_parser, \
        _compile_cache

    tmp = tmp_path_factory.mktemp("torch_service_warm")
    files = _make_archives(tmp, corpus.gm, corpus.par, 2, nchan=16,
                           nbin=64, seed0=120, prefix="w")
    plan = plan_survey(files, modelfile=corpus.gm)
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    kdir = str(tmp / "kernels")
    args = build_parser().parse_args(["start", "-w", str(tmp / "wd"),
                                      "-m", corpus.gm,
                                      "--compile-cache", kdir])
    assert _compile_cache(args) == kdir
    assert _kernels.BUILD_DIR == kdir and os.path.isdir(kdir)
    svc = _service(corpus, tmp / "wd", plan=plan, batch_window_s=0.4,
                   batch_max=2).start()
    try:
        summary = svc.warm(coalesce=(2,))
        assert summary["n_programs"] == 2
        assert all(p["ok"] for p in summary["programs"])
        rec = tobs.current()
        c0 = int(rec.counters.get("backend_compiles", 0))
        assert rec.gauges.get("warm_backend_compiles") == c0
        ids = [svc.submit(t, f)["request_id"]
               for t, f in zip(["alice", "bob"], files)]
        res = [svc.wait(i, timeout=WAIT_S) for i in ids]
        assert [r["state"] for r in res] == ["done", "done"], res
        assert int(rec.counters.get("backend_compiles", 0)) == c0
        assert svc.status()["warm"]["n_programs"] == 2
    finally:
        assert svc.shutdown(timeout=120)
    req_dir = tmp / "wd" / "obs_requests"
    manifests = [json.load(open(req_dir / d / "manifest.json"))
                 for d in sorted(os.listdir(req_dir))]
    assert len(manifests) == 2
    assert all(int((m.get("counters") or {}).get("backend_compiles", 0))
               == 0 for m in manifests)


def test_requests_and_status_record_the_device(corpus, tmp_path):
    """The daemon's obs run and status name its device; a Request keeps
    the reference's payload keys."""
    svc = _service(corpus, tmp_path / "wd").start()
    try:
        run_dir = tobs.current().dir
        r = svc.submit("alice", corpus.files[4], wait=True,
                       timeout=WAIT_S)
        assert set(r) >= {"ok", "request_id", "tenant", "archive",
                          "state", "attempts", "bucket", "n_toas",
                          "toa_lines", "wall_s", "trace_id"}
        assert isinstance(Request("r1", "t", "/a", "k", None).payload(),
                          dict)
    finally:
        assert svc.shutdown(timeout=120)
    man = json.load(open(os.path.join(run_dir, "manifest.json")))
    assert man["config"]["device"] == "cpu"


def test_launch_counts_and_k2_tables_from_many_threads():
    """The daemon's fit workers launch kernels from several threads at
    once: no launch count is lost, and the K2 table cache (more keys
    than it keeps) never loses an entry it is about to return."""
    import sys

    from pulseportraiture_tpu_torch import _kernels as K

    n0 = K.LAUNCHES["fftfit"]
    errors = []

    def work(i):
        try:
            for j in range(2000):
                K._count("fftfit")
                if j % 200 == 0:
                    T = K.fftfit_table(9, -0.5, 0.5, 4 + (i + j) % 12, "cpu")
                    assert T.shape[0] >= 18
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
        launches = K.LAUNCHES["fftfit"] - n0
        K.LAUNCHES["fftfit"] = n0
    assert not errors, errors
    assert launches == 16 * 2000
