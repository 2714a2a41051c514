"""The port's survey workloads (zap, align, modelfit, toas) against the
JAX package's, each run through its package's ``run_survey``.

Fixture: four 2-subint archives of 16 channels x 128 bins with one hot
channel at 8x the noise, and a 1-subint template.  Sixteen channels, not
the eight of tests/test_runner_workloads.py: ``get_zap_channels`` flags
a channel above median + 3 std (population std), and one outlier among
n otherwise equal channels reads at most n/sqrt(n-1) std above the
median, 3.02 at n = 8 (so a lone hot channel sits at the edge of
detection whatever its noise) and 4.13 at n = 16.  With 16 channels
the hot one is zapped in both packages, so the zap workloads are
compared where they do work.

Tolerances: zap decisions and the rewritten weights equal; align
portraits within 5e-8 and weights within 1e-9 of their largest
magnitude (the fits' f64 floor, tests/test_torch_align.py); TOAs within
1 ns (tests/torch_tim.py); the modelfit .gmodel parameters within 1e-6
relative.  Every (archive, workload) is done exactly once.
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import load_data as jload_data
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import read_model, write_model
from pulseportraiture_tpu.runner import execute as jexe
from pulseportraiture_tpu.runner import plan as jplan
from pulseportraiture_tpu.runner import workloads as jwl
from pulseportraiture_tpu.testing import faults as jfaults
from pulseportraiture_tpu_torch.pipelines.align import align_archives
from pulseportraiture_tpu_torch.runner import execute as texe
from pulseportraiture_tpu_torch.runner import plan as tplan
from pulseportraiture_tpu_torch.runner import workloads as twl
from pulseportraiture_tpu_torch.testing import faults as tfaults
from torch_tim import assert_same_tim, lines

MODEL_PARAMS = np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5])
NCHAN = 16
HOT_CHAN = 3
PORT_TOL = 5e-8
WEIGHT_TOL = 1e-9
WORKLOADS = ("zap", "align", "toas")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors run fastest on one intra-op thread here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """Drop the reference's jit-cache variants when the module ends
    (tests/test_retrace_budget.py holds them to a budget)."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("PPTPU_FAULTS", raising=False)
    tfaults.reset()
    jfaults.reset()
    yield
    tfaults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_runner_workloads")
    gm = str(tmp / "w.gmodel")
    write_model(gm, "w", "000", 1500.0, MODEL_PARAMS, np.ones(8, int),
                -4.0, 0, quiet=True)
    par = str(tmp / "w.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    noise = np.full(NCHAN, 0.01)
    noise[HOT_CHAN] = 0.08
    files = []
    for i in range(4):
        out = str(tmp / f"w{i}.fits")
        make_fake_pulsar(gm, par, out, nsub=2, nchan=NCHAN, nbin=128,
                         nu0=1500.0, bw=400.0, tsub=60.0,
                         phase=0.02 * (i + 1), dDM=5e-4,
                         noise_stds=noise, dedispersed=False,
                         seed=520 + i, quiet=True)
        files.append(out)
    tmpl = str(tmp / "tmpl.fits")
    make_fake_pulsar(gm, par, tmpl, nsub=1, nchan=NCHAN, nbin=128,
                     nu0=1500.0, bw=400.0, tsub=60.0, noise_stds=0.004,
                     dedispersed=True, seed=17, quiet=True)
    return SimpleNamespace(tmp=tmp, gm=gm, par=par, files=files, tmpl=tmpl)


def _copies(files, dst):
    os.makedirs(str(dst), exist_ok=True)
    out = []
    for f in files:
        t = os.path.join(str(dst), os.path.basename(f))
        shutil.copy(f, t)
        out.append(t)
    return out


def _union(workdir):
    recs = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("ledger.") and name.endswith(".jsonl"):
            with open(os.path.join(workdir, name)) as fh:
                recs.extend(json.loads(ln) for ln in fh if ln.strip())
    return recs


def _done_by_archive(recs, workload):
    out = {}
    for r in recs:
        if r.get("workload", "toas") == workload and r["state"] == "done":
            out[r["archive"]] = out.get(r["archive"], 0) + 1
    return out


def _run_chain(pkg, ws, root):
    """zap (two simulated processes, one injected read fault), align and
    toas through one workdir with the package's run_survey."""
    exe, plan_mod, fmod, kw = {
        "port": (texe, tplan, tfaults, {"device": "cpu"}),
        "ref": (jexe, jplan, jfaults, {})}[pkg]
    files = _copies(ws.files, root / "arch")
    wd = str(root / "wd")
    plan = plan_mod.plan_survey(files, modelfile=ws.gm)
    fmod.configure("site:archive_read@nth=2")
    s0 = exe.run_survey(plan, wd, workload="zap",
                        workload_opts={"all_subs": True}, process_index=0,
                        process_count=2, backoff_s=0.0, merge=False, **kw)
    fmod.reset()
    s1 = exe.run_survey(plan, wd, workload="zap",
                        workload_opts={"all_subs": True}, process_index=1,
                        process_count=2, backoff_s=0.0, merge=False, **kw)
    sa = exe.run_survey(plan, wd, workload="align",
                        workload_opts={"initial_guess": ws.tmpl},
                        process_index=0, process_count=1, backoff_s=0.0,
                        merge=False, **kw)
    st = exe.run_survey(plan, wd, process_index=0, process_count=1,
                        bary=False, backoff_s=0.0, merge=True, **kw)
    return SimpleNamespace(files=files, wd=wd, zap=(s0, s1), align=sa,
                           toas=st, recs=_union(wd))


@pytest.fixture(scope="module")
def chains(ws):
    return {pkg: _run_chain(pkg, ws, ws.tmp / pkg) for pkg in ("port",
                                                              "ref")}


def _zap_blocks(wd):
    out = {}
    for pid in (0, 1):
        path = os.path.join(wd, "zap.%d.jsonl" % pid)
        for rec in twl.read_jsonl_checkpoint(path).values():
            out[os.path.basename(rec["archive"])] = rec
    return out


# -- the chain: zap -> align -> toas in one workdir --------------------

@pytest.mark.parametrize("pkg", ["port", "ref"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_chain_exactly_once(chains, pkg, workload):
    """One done record per (archive, workload) across the injected read
    fault and the two zap processes, in both packages."""
    c = chains[pkg]
    keys = {os.path.realpath(f) for f in c.files}
    assert _done_by_archive(c.recs, workload) == {k: 1 for k in keys}
    assert any(r["state"] == "failed" and "InjectedFault" in
               str(r.get("reason")) for r in c.recs)


def test_chain_zap_decisions_match(chains):
    """The same proposals per archive, the hot channel among them in
    every subint, and the same weights written back."""
    t, r = _zap_blocks(chains["port"].wd), _zap_blocks(chains["ref"].wd)
    assert sorted(t) == sorted(r) == sorted(
        os.path.basename(f) for f in chains["port"].files)
    for name in t:
        for key in ("n_proposed", "n_zapped", "zap_channels", "nstd"):
            assert t[name][key] == r[name][key], (name, key)
        assert all(HOT_CHAN in subs for subs in t[name]["zap_channels"])
        assert t[name]["n_zapped"] >= 2
    for ft, fr in zip(chains["port"].files, chains["ref"].files):
        wt = jload_data(ft, quiet=True).weights
        wr = jload_data(fr, quiet=True).weights
        np.testing.assert_array_equal(np.asarray(wt), np.asarray(wr))
        assert np.all(np.asarray(wt)[:, HOT_CHAN] == 0.0)


def test_chain_align_matches(chains):
    """The align pass's reduce (align.result.npz) of both packages on
    their own zapped copies."""
    out = []
    for pkg in ("port", "ref"):
        with np.load(os.path.join(chains[pkg].wd, "align.result.npz")) as z:
            out.append((z["aligned_port"], z["total_weights"]))
    (tp, tw), (rp, rw) = out
    assert np.max(np.abs(tp - rp)) <= PORT_TOL * np.max(np.abs(rp))
    assert np.max(np.abs(tw - rw)) <= WEIGHT_TOL * np.max(np.abs(rw))


@pytest.mark.parametrize("i", range(4))
def test_chain_toas_match(chains, tmp_path, i):
    """The toas pass after zap: each archive's TOAs within 1 ns."""
    tims = []
    for pkg in ("port", "ref"):
        ckpt = os.path.join(chains[pkg].wd, "toas.0.tim")
        arch = chains[pkg].files[i]
        out = str(tmp_path / (pkg + ".tim"))
        with open(out, "w") as f:
            f.write("FORMAT 1\n")
            for tok in lines(ckpt, skip_comments=True):
                if tok[0] == arch:
                    f.write(" ".join([os.path.basename(arch)] + tok[1:])
                            + "\n")
        tims.append(out)
    assert_same_tim(tims[0], tims[1], 2)


def test_chain_pre_fit_reasons_match(chains):
    """The toas claims narrate the zap decisions in both packages."""
    def chain(pkg):
        return sorted((os.path.basename(r["archive"]), r["reason"],
                       r["pre_fit"]["zap"]["n_zapped"])
                      for r in chains[pkg].recs
                      if r.get("workload") == "toas"
                      and str(r.get("reason", "")).startswith("pre_fit"))
    assert chain("port") == chain("ref") and len(chain("port")) == 4


def test_chain_status_and_merged_report(chains):
    c = chains["port"]
    status = texe.survey_status(c.wd)
    for wl in WORKLOADS:
        assert status["workloads"][wl]["done"] == 4
    assert status["counts"]["done"] == 12
    merged = json.load(open(os.path.join(c.wd, "survey.json")))
    assert set(merged["workloads"]) >= set(WORKLOADS)
    evs = [json.loads(ln) for ln in open(os.path.join(
        c.wd, "obs_merged", "events.jsonl")) if ln.strip()]
    assert set(WORKLOADS) <= {e.get("workload") for e in evs
                              if e.get("name") == "runner_summary"}


# -- single workloads ----------------------------------------------------

def test_align_workload_parity_with_direct_call(ws, tmp_path):
    """The port's align workload against the port's own align_archives
    on the same archives: per-archive blocks against cross-archive ones,
    the same per-row math (the reference's tolerance for this)."""
    _, direct_port, direct_w = align_archives(
        ws.files, ws.tmpl, fit_dm=True, niter=1,
        outfile=str(tmp_path / "direct.fits"), quiet=True, device="cpu")
    wd = str(tmp_path / "wd")
    s = texe.run_survey(tplan.plan_survey(ws.files), wd, workload="align",
                        workload_opts={"initial_guess": ws.tmpl},
                        process_index=0, process_count=1, backoff_s=0.0,
                        merge=False, device="cpu")
    assert s["counts"]["done"] == 4
    assert s["aligned"] == os.path.join(wd, "aligned.fits")
    with np.load(os.path.join(wd, "align.result.npz")) as res:
        np.testing.assert_allclose(res["total_weights"], direct_w,
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(res["aligned_port"], direct_port,
                                   rtol=1e-5, atol=1e-8)
    d = jload_data(s["aligned"], quiet=True)
    assert d.nbin == 128 and d.DM == 0.0 and d.dmc is False


@pytest.mark.parametrize("niter", [1, 2])
def test_align_workload_matches_reference(ws, tmp_path, niter):
    """niter passes through the engine (per-pass ledger labels, the
    reduce between passes) in both packages: the final portraits."""
    out = []
    for exe, plan_mod, kw in ((texe, tplan, {"device": "cpu"}),
                              (jexe, jplan, {})):
        wd = str(tmp_path / exe.__name__.split(".")[0])
        s = exe.run_survey(plan_mod.plan_survey(ws.files), wd,
                           workload="align",
                           workload_opts={"initial_guess": ws.tmpl,
                                          "niter": niter},
                           process_index=0, process_count=1,
                           backoff_s=0.0, merge=False, **kw)
        assert s["counts"]["done"] == 4
        assert s.get("n_passes", 1) == niter
        with np.load(os.path.join(wd, "align.result.npz")) as z:
            out.append((z["aligned_port"], z["total_weights"]))
    (tp, tw), (rp, rw) = out
    assert np.max(np.abs(tp - rp)) <= PORT_TOL * np.max(np.abs(rp))
    assert np.max(np.abs(tw - rw)) <= WEIGHT_TOL * np.max(np.abs(rw))


def test_modelfit_gauss_matches_reference(ws, tmp_path):
    """modelfit (gauss, --autogauss 0.05, niter 1) of the template in
    both packages: the same .gmodel parameters within 1e-6 relative."""
    models = []
    for exe, plan_mod, kw in ((texe, tplan, {"device": "cpu"}),
                              (jexe, jplan, {})):
        wd = str(tmp_path / exe.__name__.split(".")[0])
        s = exe.run_survey(plan_mod.plan_survey([ws.tmpl]), wd,
                           workload="modelfit",
                           workload_opts={"kind": "gauss",
                                          "model_kw": {"auto_gauss": 0.05,
                                                       "niter": 1}},
                           process_index=0, process_count=1,
                           backoff_s=0.0, merge=False, **kw)
        assert s["counts"]["done"] == 1
        out = os.path.join(wd, "models", "tmpl.gmodel")
        (rec,) = [r for r in _union(wd) if r["state"] == "done"]
        assert rec["workload"] == "modelfit" and rec["model"] == out
        models.append(read_model(out))
    (tname, tcode, tnu, tng, tpar, tfl, talpha, _), \
        (rname, rcode, rnu, rng, rpar, rfl, ralpha, _) = models
    assert (tcode, tnu, tng) == (rcode, rnu, rng) and tng >= 1
    np.testing.assert_array_equal(tfl, rfl)
    np.testing.assert_allclose(tpar, rpar, rtol=1e-6, atol=1e-9)


# -- registry ------------------------------------------------------------

def test_registry_names_equal():
    assert twl.workload_names() == jwl.workload_names() == [
        "align", "modelfit", "toas", "zap"]
    with pytest.raises(ValueError, match="unknown workload 'nope'"):
        twl.get_workload("nope")
    with pytest.raises(ValueError, match="needs a modelfile"):
        twl.resolve_workload(None)
    with pytest.raises(TypeError, match="unexpected get_toas"):
        twl.resolve_workload("zap", get_toas_kw={"bary": False})


@pytest.mark.parametrize("ipass", range(3))
def test_pass_labels_and_checkpoint_paths_equal(ipass):
    t = twl.AlignWorkload(initial_guess="t.fits", niter=3)
    r = jwl.AlignWorkload(initial_guess="t.fits", niter=3)
    assert t.pass_label(ipass) == r.pass_label(ipass)
    assert t.checkpoint_path("wd", 1, ipass) == \
        r.checkpoint_path("wd", 1, ipass)
    assert twl.ToasWorkload("m").checkpoint_path("wd", 2) == \
        jwl.ToasWorkload("m").checkpoint_path("wd", 2)
