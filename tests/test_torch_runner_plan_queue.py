"""The port's survey plan, ledger, respawn policy, prefetch stage and
supervisor policy against the JAX package's.

No fit runs here: ``plan.json`` of one metafile is the same document
from both packages, ``pad_databunch`` pads one loaded archive to the
same arrays (to 1e-12), a ledger written by either package's
``WorkQueue`` replays to the same states in the other, and the pure
policies (``canonical_shape``, ``RespawnTracker``, ``decide``) give the
same answers on the same inputs.
"""

import copy
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.runner import plan as jplan
from pulseportraiture_tpu.runner import queue as jqueue
from pulseportraiture_tpu.runner import respawn as jrespawn
from pulseportraiture_tpu.runner import supervisor as jsup
from pulseportraiture_tpu_torch.io.archive import load_data as tload_data
from pulseportraiture_tpu_torch.runner import plan as tplan
from pulseportraiture_tpu_torch.runner import prefetch as tprefetch
from pulseportraiture_tpu_torch.runner import queue as tqueue
from pulseportraiture_tpu_torch.runner import respawn as trespawn
from pulseportraiture_tpu_torch.runner import supervisor as tsup


def _copy(d):
    """A deep copy of a DataBunch (a dict whose __dict__ is itself, which
    copy.deepcopy does not rebuild)."""
    return type(d)(**{k: copy.deepcopy(v) for k, v in d.items()})


MODEL_PARAMS = np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5])
# native shapes: canonical, channel-padded, bin-padded, both
SHAPES = [(16, 128), (12, 128), (16, 100), (12, 100)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_runner_plan")
    gm = str(tmp / "p.gmodel")
    write_model(gm, "p", "000", 1500.0, MODEL_PARAMS, np.ones(8, int),
                -4.0, 0, quiet=True)
    par = str(tmp / "p.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    files = []
    for i, (nchan, nbin) in enumerate(SHAPES):
        out = str(tmp / ("p%d.fits" % i))
        make_fake_pulsar(gm, par, out, nsub=2, nchan=nchan, nbin=nbin,
                         nu0=1500.0, bw=400.0, tsub=60.0, phase=0.05 * i,
                         dDM=5e-4, noise_stds=0.01, dedispersed=False,
                         seed=310 + i, quiet=True)
        files.append(out)
    bad = str(tmp / "truncated.fits")
    with open(files[0], "rb") as f:
        head = f.read(4000)
    with open(bad, "wb") as f:
        f.write(head)
    meta = str(tmp / "p.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files + [bad]) + "\n")
    return SimpleNamespace(tmp=tmp, gm=gm, files=files, bad=bad, meta=meta)


# -- plan ---------------------------------------------------------------

@pytest.mark.parametrize("as_meta", [True, False], ids=["metafile", "list"])
def test_plan_json_equal(corpus, tmp_path, as_meta):
    """The same archives plan to the same plan.json (buckets, archive
    facts, unreadable reasons) from either package."""
    src = corpus.meta if as_meta else corpus.files + [corpus.bad]
    jp = jplan.plan_survey(src, modelfile=corpus.gm)
    tp = tplan.plan_survey(src, modelfile=corpus.gm)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jp.save(jpath)
    tp.save(tpath)
    assert json.load(open(tpath)) == json.load(open(jpath))
    assert [b.key for b in tp.buckets] == [(16, 128)]
    assert len(tp.unreadable) == 1 and tp.unreadable[0][0] == corpus.bad
    # a plan saved by one package loads in the other
    assert tplan.SurveyPlan.load(jpath).to_dict() == tp.to_dict()
    assert jplan.SurveyPlan.load(tpath).to_dict() == jp.to_dict()


@pytest.mark.parametrize("shape", [(1, 1), (7, 63), (8, 64), (9, 65),
                                   (12, 96), (16, 128), (500, 2000),
                                   (512, 2048), (513, 4097)])
def test_canonical_shape_equal(shape):
    assert tplan.canonical_shape(*shape) == jplan.canonical_shape(*shape)


@pytest.mark.parametrize("i", range(len(SHAPES)),
                         ids=["%dx%d" % s for s in SHAPES])
def test_pad_databunch_equal(corpus, i):
    """One loaded archive padded by both packages' pad_databunch: the
    same arrays to 1e-12 (absolute, on data of unit scale)."""
    d = tload_data(corpus.files[i], dedisperse=False, tscrunch=False,
                   pscrunch=True, rm_baseline=True, return_arch=False,
                   quiet=True, device="cpu")
    jd = jplan.pad_databunch(_copy(d), 16, 128)
    td = tplan.pad_databunch(_copy(d), 16, 128)
    for key in ("subints", "prof", "noise_stds", "freqs", "weights",
                "SNRs", "phases", "masks"):
        np.testing.assert_allclose(np.asarray(getattr(td, key)),
                                   np.asarray(getattr(jd, key)),
                                   rtol=0, atol=1e-12, err_msg=key)
    for key in ("prof_noise", "bw", "nchan", "nbin"):
        assert abs(float(getattr(td, key)) - float(getattr(jd, key))) \
            <= 1e-12, key
    assert td.subints.shape == (2, 1, 16, 128)
    native = SHAPES[i] != (16, 128)
    assert hasattr(td, "nchan_native") == native


def test_pad_databunch_tensor_fields(corpus):
    """A DataBunch holding CPU tensors pads to the numpy arrays."""
    d = tload_data(corpus.files[3], pscrunch=True, rm_baseline=True,
                   return_arch=False, quiet=True, device="cpu")
    want = tplan.pad_databunch(_copy(d), 16, 128)
    dt = _copy(d)
    for key in ("subints", "prof", "noise_stds", "freqs", "weights",
                "SNRs", "phases", "masks"):
        setattr(dt, key, torch.as_tensor(np.asarray(getattr(dt, key))))
    got = tplan.pad_databunch(dt, 16, 128)
    for key in ("subints", "noise_stds", "freqs", "weights", "masks"):
        np.testing.assert_array_equal(getattr(got, key),
                                      getattr(want, key))


def test_load_bucketed_matches_reference_load(corpus):
    """The port's whole bucketed load (load + pad) against the
    reference's on a padded archive: the decode agrees to the f64
    floor, so the padded arrays do too."""
    t = tplan.load_bucketed_databunch(corpus.files[3], (16, 128),
                                      device="cpu")
    j = jplan.load_bucketed_databunch(corpus.files[3], (16, 128))
    np.testing.assert_allclose(t.subints, np.asarray(j.subints),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(t.noise_stds, np.asarray(j.noise_stds),
                               rtol=1e-10)
    assert tplan.load_bucketed_databunch(corpus.files[0], (8, 64),
                                         device="cpu") is None


# -- ledger -------------------------------------------------------------

def _drive(qmod, ledger, paths, union_dir):
    q = qmod.WorkQueue(ledger, max_attempts=2, backoff_s=0.0,
                       union_dir=union_dir, owner="p0@1.1", lease_s=60.0,
                       process_index=0)
    q.add(paths)
    q.claim(paths[0])
    q.complete(paths[0], n_toas=2)
    q.claim(paths[1])
    q.fail(paths[1], "RuntimeError: transient")
    q.claim(paths[2])
    q.quarantine(paths[2], "poison: no subints")
    q.claim(paths[3])
    q.reset(paths[3], "prefetch_abandoned: stopped")
    q.close()


def _states(qmod, union_dir):
    q = qmod.WorkQueue(None, readonly=True, union_dir=union_dir)
    try:
        return ({k: (r["state"], r.get("attempts"), r.get("reason"),
                     r.get("n_toas"))
                 for k, r in q.entries.items()}, q.counts())
    finally:
        q.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ledger_replays_in_the_other_package(corpus, tmp_path, writer):
    """A ledger written by one package's WorkQueue replays to the same
    per-archive states and counts in both: the record format is
    shared."""
    wd = str(tmp_path / "wd")
    os.makedirs(wd)
    qmod = tqueue if writer == "port" else jqueue
    _drive(qmod, os.path.join(wd, "ledger.0.jsonl"), corpus.files, wd)
    t_states, t_counts = _states(tqueue, wd)
    j_states, j_counts = _states(jqueue, wd)
    assert t_states == j_states and t_counts == j_counts
    assert t_counts == {"pending": 1, "running": 0, "done": 1,
                        "failed": 1, "quarantined": 1}


@pytest.mark.parametrize("name", ["DEFAULT_WORKLOAD", "PENDING", "RUNNING",
                                  "DONE", "FAILED", "QUARANTINED"])
def test_ledger_constants_equal(name):
    assert getattr(tqueue, name) == getattr(jqueue, name)


# -- respawn and supervisor policy -------------------------------------

@pytest.mark.parametrize("deaths", [[0.0], [0.0, 1.0], [0.0, 1.0, 2.0],
                                    [0.0, 100.0, 101.0],
                                    [0.0, 0.5, 1.0, 1.5, 2.0]])
def test_respawn_verdicts_equal(deaths):
    verdicts = []
    for mod in (trespawn, jrespawn):
        pol = mod.RespawnPolicy(backoff_s=1.0, backoff_max_s=30.0,
                                flap_count=4, flap_window_s=60.0)
        tr = mod.RespawnTracker(pol, key="w1")
        verdicts.append([tr.record_death(t) for t in deaths]
                        + [tr.state(), tr.due(deaths[-1] + 5.0)])
    assert verdicts[0] == verdicts[1]


DECIDE_CASES = [
    {},
    {"ready": 10, "outstanding": 10, "empty": [0, 1, 2, 3],
     "min_workers": 1, "max_workers": 4},
    {"ready": 10, "outstanding": 10, "live": [0], "empty": [1, 2, 3],
     "max_workers": 4, "backlog_per_worker": 2.0,
     "alerts": ["memory_watermark"]},
    {"ready": 10, "outstanding": 10, "live": [0], "empty": [1, 2, 3],
     "max_workers": 4, "mem_budget_bytes": 100, "est_worker_bytes": 40},
    {"ready": 0, "outstanding": 0, "live": [0, 1], "draining": [1]},
    {"ready": 1, "outstanding": 1, "live": [0, 1, 2], "min_workers": 1,
     "max_workers": 3},
    {"outstanding": 5, "ready": 5, "live": [0], "empty": [2],
     "dead": [{"slot": 1, "action": "respawn", "due": True},
              {"slot": 3, "action": "park", "due": False}],
     "max_workers": 4},
    {"outstanding": 3, "ready": 0, "live": [0, 1], "expired": [1],
     "max_workers": 2},
]


@pytest.mark.parametrize("case", range(len(DECIDE_CASES)))
def test_supervisor_decide_equal(case):
    """The supervisor's pure policy table: the same actions from the
    same observation."""
    obs = DECIDE_CASES[case]
    assert tsup.decide(dict(obs)) == jsup.decide(dict(obs))


def test_supervisor_worker_command(corpus, tmp_path):
    """Workers are the port's ppsurvey run and inherit --device."""
    wd = str(tmp_path / "wd")
    os.makedirs(wd)
    tplan.plan_survey(corpus.files, modelfile=corpus.gm).save(
        os.path.join(wd, "plan.json"))
    sup = tsup.Supervisor(wd, max_workers=2, device="cpu",
                          compile_cache="/k", warm="auto")
    cmd = sup._worker_cmd(sup.slots[1])
    assert cmd[1:4] == ["-m", "pulseportraiture_tpu_torch.cli.ppsurvey",
                        "run"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--process") + 1] == "1"
    assert cmd[cmd.index("--processes") + 1] == "2"
    assert cmd[cmd.index("--compile-cache") + 1] == "/k"
    jsupv = jsup.Supervisor(wd, max_workers=2, compile_cache="/k",
                            warm="auto")
    jcmd = jsupv._worker_cmd(jsupv.slots[1])
    i = cmd.index("--device")
    assert cmd[:i] + cmd[i + 2:] == [
        c.replace("pulseportraiture_tpu.cli", "pulseportraiture_tpu_torch"
                  ".cli") for c in jcmd]


# -- prefetch -------------------------------------------------------------

def test_prefetch_replays_load_outcomes(corpus):
    """The prefetch stage returns the serial load's buffer, and a load
    that raises replays as ("raise", exc)."""
    pf = tprefetch.HostPrefetcher(depth=2)
    try:
        good = pf.submit(corpus.files[3], lambda: tplan.
                         load_bucketed_databunch(corpus.files[3], (16, 128),
                                                 device="cpu"))

        def boom():
            raise RuntimeError("read fault")

        bad = pf.submit(corpus.files[0], boom)
        kind, val = pf.consume(good)
        assert kind == "data"
        serial = tplan.load_bucketed_databunch(corpus.files[3], (16, 128),
                                               device="cpu")
        np.testing.assert_array_equal(val.subints, serial.subints)
        kind, val = pf.consume(bad)
        assert kind == "raise" and isinstance(val, RuntimeError)
        assert pf.peak_bytes >= 0
    finally:
        pf.stop()
