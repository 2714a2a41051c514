"""The port's survey runner (``run_survey``) against the JAX package's.

One corpus, written by the JAX package's ``make_fake_pulsar``: four
archives at the canonical 16 x 128 shape, two at 12 x 100 (padded into
the same bucket through ``pad_databunch``) and a truncated file.  Both
packages run the whole survey (``device="cpu"`` for the port): TOAs
within 1 ns per archive, native and padded, and the same final ledger
states, counts and quarantine reasons (timestamps, pids and owners
ignored).  Then what the runner promises: a workdir planned (or half
run) by either package finishes in the other; a kill through
``PPTPU_FAULTS`` followed by a resume fits every archive exactly once; a
transient fault retries and succeeds; two simulated processes merge one
obs report; prefetch does not change a TOA.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from pulseportraiture_tpu.cli import ppsurvey as jcli
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.runner import execute as jexe
from pulseportraiture_tpu.runner import plan as jplan
from pulseportraiture_tpu.testing import faults as jfaults
from pulseportraiture_tpu_torch.cli import ppsurvey as tcli
from pulseportraiture_tpu_torch.pipelines import toas as ttoas
from pulseportraiture_tpu_torch.runner import execute as texe
from pulseportraiture_tpu_torch.runner import plan as tplan
from pulseportraiture_tpu_torch.testing import faults as tfaults
from torch_tim import assert_same_tim, lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_PARAMS = np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5])
# four canonical-shape archives, then two that pad into their bucket
SHAPES = [(16, 128)] * 4 + [(12, 100)] * 2
NATIVE = [0, 1, 2, 3]
PADDED = [4, 5]
# ledger-record fields that name a process, a time or a trace
VOLATILE = ("t", "owner", "lease_expires_at", "seq", "trace", "pid",
            "retry_at", "renewals", "takeover_from", "prev_owner", "ckpt")


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever
    test process runs it next: drop them when the module ends."""
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
def survey(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_runner_exec")
    gm = str(tmp / "s.gmodel")
    write_model(gm, "s", "000", 1500.0, MODEL_PARAMS, np.ones(8, int),
                -4.0, 0, quiet=True)
    par = str(tmp / "s.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    rng = np.random.default_rng(41)
    files = []
    for i, (nchan, nbin) in enumerate(SHAPES):
        out = str(tmp / ("s%d.fits" % i))
        make_fake_pulsar(gm, par, out, nsub=2, nchan=nchan, nbin=nbin,
                         nu0=1500.0, bw=400.0, tsub=60.0,
                         phase=float(rng.uniform(-0.2, 0.2)),
                         dDM=float(rng.normal(0, 1e-3)), noise_stds=0.01,
                         dedispersed=False, seed=400 + i, quiet=True)
        files.append(out)
    bad = str(tmp / "truncated.fits")
    with open(files[0], "rb") as f:
        head = f.read(6000)
    with open(bad, "wb") as f:
        f.write(head)
    ref_wd, port_wd = str(tmp / "ref"), str(tmp / "port")
    ref = jexe.run_survey(jplan.plan_survey(files + [bad], modelfile=gm),
                          ref_wd, process_index=0, process_count=1,
                          bary=False, backoff_s=0.0)
    port = texe.run_survey(tplan.plan_survey(files + [bad], modelfile=gm),
                           port_wd, process_index=0, process_count=1,
                           bary=False, backoff_s=0.0, device="cpu")
    return SimpleNamespace(tmp=tmp, gm=gm, files=files, bad=bad,
                           ref=ref, port=port, ref_wd=ref_wd,
                           port_wd=port_wd)


def _archive_tim(ckpt, archive, out):
    """The TOA lines of one archive of a checkpoint, as a .tim file."""
    with open(out, "w") as f:
        f.write("FORMAT 1\n")
        for tok in lines(ckpt, skip_comments=True):
            if tok[0] == archive:
                f.write(" ".join(tok) + "\n")
    return out


def _union(workdir):
    recs = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("ledger.") and name.endswith(".jsonl"):
            with open(os.path.join(workdir, name)) as fh:
                recs.extend(json.loads(ln) for ln in fh if ln.strip())
    return recs


def _stable(rec):
    return {k: v for k, v in rec.items() if k not in VOLATILE}


def _done_counts(workdir, workload="toas"):
    out = {}
    for r in _union(workdir):
        if r.get("workload", "toas") == workload and r["state"] == "done":
            out[r["archive"]] = out.get(r["archive"], 0) + 1
    return out


def _blocks(ckpt):
    """{archive: number of C pp_done markers} of a .tim checkpoint."""
    out = {}
    for ln in open(ckpt):
        tok = ln.split()
        if tok[:2] == ["C", "pp_done"]:
            out[tok[2]] = out.get(tok[2], 0) + 1
    return out


# -- the survey against the reference's --------------------------------

@pytest.mark.parametrize("i", NATIVE + PADDED,
                         ids=["native%d" % i for i in NATIVE]
                         + ["padded%d" % i for i in PADDED])
def test_survey_toas_match_reference(survey, tmp_path, i):
    """Each archive's survey TOAs within 1 ns of the reference's survey
    (tests/torch_tim.py: MJDs 1 ns, flags to the printed digit; the
    padded ones carry -pp_grid 16x128 in both)."""
    arch = survey.files[i]
    tport = _archive_tim(survey.port["checkpoint"], arch,
                         str(tmp_path / "t.tim"))
    tref = _archive_tim(survey.ref["checkpoint"], arch,
                        str(tmp_path / "r.tim"))
    assert_same_tim(tport, tref, 2)
    has_grid = "-pp_grid" in open(tport).read()
    assert has_grid == (i in PADDED)


def test_survey_counts_and_quarantine_match(survey):
    assert survey.port["counts"] == survey.ref["counts"]
    assert survey.port["counts"]["done"] == len(survey.files)
    assert survey.port["counts"]["quarantined"] == 1
    assert survey.port["quarantined"] == survey.ref["quarantined"]
    (q,) = survey.port["quarantined"]
    assert q["archive"] == survey.bad and "unreadable" in q["reason"]


def test_survey_final_ledger_states_match(survey):
    """The same record sequence per archive (state, attempts, reason,
    n_toas, workload), process-, time- and trace-named fields aside."""
    def per_archive(wd):
        out = {}
        for r in _union(wd):
            out.setdefault(r["archive"], []).append(_stable(r))
        return out

    assert per_archive(survey.port_wd) == per_archive(survey.ref_wd)


def test_survey_manifests_match(survey):
    """survey.json: the same counts, workloads and per-archive states."""
    t = json.load(open(os.path.join(survey.port_wd, "survey.json")))
    r = json.load(open(os.path.join(survey.ref_wd, "survey.json")))
    assert t["counts"] == r["counts"] and t["workloads"] == r["workloads"]
    assert {k: (v["state"], v.get("n_toas")) for k, v in
            t["archives"].items()} == {k: (v["state"], v.get("n_toas"))
                                       for k, v in r["archives"].items()}


@pytest.mark.parametrize("i", PADDED)
def test_padded_archive_within_padding_bar(survey, i):
    """A padded archive's survey fit against the port's native pptoas
    fit of the same archive: phases within 5 sigma and DMs within 5e-4
    (the reference's bar for padding, tests/test_runner_execute.py:
    padding resamples the data, so the TOAs cannot be equal)."""
    arch = survey.files[i]
    native = ttoas.GetTOAs([arch], survey.gm, quiet=True, device="cpu")
    native.get_TOAs(bary=False, quiet=True)
    padded = texe._BucketedGetTOAs([arch], survey.gm, (16, 128),
                                   quiet=True, device="cpu")
    padded.get_TOAs(bary=False, quiet=True)
    p_nat, p_pad = np.asarray(native.phis[0]), np.asarray(padded.phis[0])
    err = np.asarray(native.phi_errs[0])
    dphi = np.abs(((p_pad - p_nat) + 0.5) % 1.0 - 0.5)
    assert np.all(dphi < 5 * err), (dphi, err)
    np.testing.assert_allclose(padded.DMs[0], native.DMs[0], atol=5e-4)
    assert 0.3 < np.median(np.asarray(padded.red_chi2s[0])) < 3.0


# -- one workdir, two packages -----------------------------------------

@pytest.mark.parametrize("planner", ["reference", "port"])
def test_workdir_planned_by_one_runs_in_the_other(survey, tmp_path,
                                                  planner, capsys):
    """``ppsurvey plan`` of one package, ``ppsurvey run`` of the other:
    the same TOAs as the reference's survey."""
    wd = str(tmp_path / "wd")
    files = survey.files[:1] + survey.files[4:5]
    meta = str(tmp_path / "m.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files) + "\n")
    plan_cli, run_cli = (jcli, tcli) if planner == "reference" \
        else (tcli, jcli)
    assert plan_cli.main(["plan", "-d", meta, "-m", survey.gm,
                          "-w", wd]) == 0
    argv = ["run", "-w", wd, "--no_bary", "--backoff", "0", "--quiet"]
    if run_cli is tcli:
        argv += ["--device", "cpu"]
    assert run_cli.main(argv) == 0
    capsys.readouterr()
    ckpt = os.path.join(wd, "toas.0.tim")
    for arch in files:
        assert_same_tim(
            _archive_tim(ckpt, arch, str(tmp_path / "t.tim")),
            _archive_tim(survey.ref["checkpoint"], arch,
                         str(tmp_path / "r.tim")), 2)
    assert _done_counts(wd) == {a: 1 for a in files}


def test_reference_half_run_resumed_by_port(survey, tmp_path):
    """The reference fits two archives and stops; the port resumes the
    same workdir: every archive done exactly once, one checkpoint block
    each, the TOAs equal to the reference's whole survey."""
    wd = str(tmp_path / "wd")
    files = survey.files[:4]
    s1 = jexe.run_survey(jplan.plan_survey(files, modelfile=survey.gm),
                         wd, process_index=0, process_count=1, bary=False,
                         max_archives=2, merge=False)
    assert s1["counts"]["done"] == 2
    s2 = texe.run_survey(tplan.plan_survey(files, modelfile=survey.gm),
                         wd, process_index=0, process_count=1, bary=False,
                         device="cpu")
    assert s2["counts"]["done"] == 4
    assert _done_counts(wd) == {a: 1 for a in files}
    assert _blocks(s2["checkpoint"]) == {a: 1 for a in files}
    for arch in files:
        assert_same_tim(
            _archive_tim(s2["checkpoint"], arch, str(tmp_path / "t.tim")),
            _archive_tim(survey.ref["checkpoint"], arch,
                         str(tmp_path / "r.tim")), 2)


# -- the runner's promises, on the port --------------------------------

def test_prefetch_does_not_change_a_toa(survey, tmp_path):
    """--prefetch 2 against the serial path: the same .tim, byte for
    byte in the TOA lines."""
    files = survey.files[:3] + survey.files[4:]
    out = []
    for depth in (0, 2):
        s = texe.run_survey(tplan.plan_survey(files, modelfile=survey.gm),
                            str(tmp_path / ("wd%d" % depth)),
                            process_index=0, process_count=1, bary=False,
                            prefetch=depth, device="cpu")
        assert s["counts"]["done"] == len(files)
        out.append(lines(s["checkpoint"], skip_comments=True))
    assert out[0] == out[1]


def test_kill_then_resume_exactly_once(survey, tmp_path):
    """A ``ppsurvey run`` subprocess is killed by PPTPU_FAULTS
    (``sigkill`` at the second archive's dispatch); a resume takes over
    the dead process's expired lease and finishes: every archive done
    once, one checkpoint block each, the killed archive's lease taken
    over on the ledger."""
    wd = str(tmp_path / "wd")
    files = survey.files[:3]
    os.makedirs(wd)
    tplan.plan_survey(files, modelfile=survey.gm).save(
        os.path.join(wd, "plan.json"))
    env = dict(os.environ, PPTPU_FAULTS="sigkill@after=2,at=dispatch",
               PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "pulseportraiture_tpu_torch.cli.ppsurvey",
         "run", "-w", wd, "--device", "cpu", "--no_bary", "--prefetch",
         "0", "--lease", "1", "--quiet"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == -9, proc.stderr[-2000:]
    assert len(_done_counts(wd)) == 1
    s = texe.run_survey(os.path.join(wd, "plan.json"), wd,
                        process_index=0, process_count=1, bary=False,
                        lease_s=1.0, device="cpu")
    assert s["counts"]["done"] == 3
    assert _done_counts(wd) == {a: 1 for a in files}
    assert _blocks(s["checkpoint"]) == {a: 1 for a in files}
    assert len(lines(s["checkpoint"], skip_comments=True)) == 6
    assert any(r.get("takeover_from") or r.get("reason") == "lease_expired"
               for r in _union(wd))


@pytest.mark.parametrize("spec,state_seq", [
    ("site:archive_read@nth=1", ["failed", "done"]),
    ("site:checkpoint_flush@nth=1", ["failed", "done"]),
    ("site:dispatch@nth=1", ["failed", "done"]),
])
def test_transient_fault_retries_then_succeeds(survey, tmp_path, spec,
                                               state_seq):
    """One injected transient fault: the archive fails once, retries and
    is done, exactly as in the reference (the same ledger outcome)."""
    files = survey.files[:1]
    out = []
    for exe, plan_mod, fmod, kw in (
            (texe, tplan, tfaults, {"device": "cpu"}),
            (jexe, jplan, jfaults, {})):
        fmod.configure(spec)
        wd = str(tmp_path / exe.__name__.split(".")[0])
        s = exe.run_survey(plan_mod.plan_survey(files, modelfile=survey.gm),
                           wd, process_index=0, process_count=1,
                           bary=False, backoff_s=0.0, merge=False, **kw)
        fmod.reset()
        assert s["counts"]["done"] == 1
        seq = [r["state"] for r in _union(wd)
               if r["state"] in ("failed", "done")]
        assert seq == state_seq
        assert _blocks(s["checkpoint"]) == {files[0]: 1}
        out.append([(r["state"], r.get("attempts"),
                     (r.get("reason") or "").split(":")[0])
                    for r in _union(wd)])
    assert out[0] == out[1]


def test_two_simulated_processes_merge_one_obs_report(survey, tmp_path):
    """Process 1 takes its round-robin half, process 0 the rest and
    merges both obs shards into one run and one survey.json."""
    wd = str(tmp_path / "wd")
    plan = tplan.plan_survey(survey.files[:4], modelfile=survey.gm)
    s1 = texe.run_survey(plan, wd, process_index=1, process_count=2,
                         bary=False, merge=False, max_archives=2,
                         device="cpu")
    assert s1["counts"]["done"] == 2
    s0 = texe.run_survey(plan, wd, process_index=0, process_count=2,
                         bary=False, merge=True, device="cpu")
    assert s0["counts"]["done"] == 4 and s0["merged_counts"]["done"] == 4
    owners = {}
    for rec in json.load(open(os.path.join(wd, "survey.json")))[
            "archives"].values():
        assert rec["state"] == "done"
        pid = rec["owner"].split("@")[0]
        owners[pid] = owners.get(pid, 0) + 1
    assert owners == {"p0": 2, "p1": 2}
    merged = s0["obs_merged"]
    man = json.load(open(os.path.join(merged, "manifest.json")))
    assert man["n_processes"] == 2
    assert man["counters"]["fit_batches"] == 4
    events = [json.loads(ln)
              for ln in open(os.path.join(merged, "events.jsonl"))]
    paths = {e["path"] for e in events if e.get("kind") == "span"}
    assert any(p.startswith("p0/") for p in paths)
    assert any(p.startswith("p1/") for p in paths)
    assert [e["t"] for e in events] == sorted(e["t"] for e in events)
    assert texe.survey_status(wd)["counts"]["done"] == 4


def test_device_policy_and_refusals(survey, tmp_path):
    """No CUDA device and no device="cpu": the survey raises before it
    fits anything, with and without ``use_mesh`` (whose default mesh is
    every visible CUDA device)."""
    import torch

    plan = tplan.plan_survey(survey.files[:1], modelfile=survey.gm)
    if not torch.cuda.is_available():
        for name, kw in (("a", {}), ("b", {"use_mesh": True})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                texe.run_survey(plan, str(tmp_path / name), process_index=0,
                                process_count=1, **kw)
            assert not os.path.exists(str(tmp_path / name))


def test_mesh_fitter_matches_unsharded():
    """make_mesh_fitter on a (4, 2, 1) mesh of CPU devices, B = 3 padded
    to the 4-wide subint axis (the reference's
    test_mesh_fitter_matches_unsharded inputs): the unsharded port's fit
    on every field (chi2 within 1e-12), the reference's within its own
    tolerances; scan_size, pad_to and device are ignored."""
    import torch

    from pulseportraiture_tpu.ops.fourier import (get_bin_centers,
                                                  rotate_data)
    from pulseportraiture_tpu.ops.profiles import gen_gaussian_portrait
    from pulseportraiture_tpu_torch.fit import portrait as tfp
    from pulseportraiture_tpu_torch.parallel.mesh import make_mesh

    B, nchan, nbin = 3, 16, 128
    freqs = np.linspace(1300.0, 1700.0, nchan)
    model = np.asarray(gen_gaussian_portrait(
        "000", np.array([0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2]),
        -4.0, np.asarray(get_bin_centers(nbin)), freqs, 1500.0))
    rng = np.random.default_rng(7)
    P0 = 0.005
    phis = rng.uniform(-0.1, 0.1, B)
    data = np.stack([
        np.asarray(rotate_data(model, -phis[i], 0.0, P0, freqs,
                               freqs.mean()))
        for i in range(B)]) + rng.normal(0, 0.005, (B, nchan, nbin))
    init = np.zeros((B, 5))
    init[:, 0] = phis
    errs = np.full((B, nchan), 0.005)
    kw = dict(errs=errs, fit_flags=(1, 1, 0, 0, 0), log10_tau=False)

    ref = jfp.fit_portrait_full_batch(data, model[None], init, P0, freqs,
                                      **kw)
    want = tfp.fit_portrait_full_batch(data, model[None], init, P0, freqs,
                                       device="cpu", **kw)
    fitter = texe.make_mesh_fitter(make_mesh(4, 2, 1, devices=["cpu"] * 8))
    out = fitter(data, model[None], init, P0, freqs, scan_size=64,
                 pad_to=8, device="cuda", **kw)  # all three ignored
    assert out.phi.shape == (B,) and out.scales.shape == (B, nchan)
    for key in tfp.RESULT_KEYS:
        tol = 1e-12 if key in ("chi2", "red_chi2") else 0
        torch.testing.assert_close(out[key], want[key], rtol=tol, atol=0)
    np.testing.assert_allclose(out.phi.numpy(), np.asarray(ref.phi),
                               atol=1e-8)
    np.testing.assert_allclose(out.DM.numpy(), np.asarray(ref.DM),
                               atol=1e-8)
    np.testing.assert_allclose(out.snr.numpy(), np.asarray(ref.snr),
                               rtol=1e-6)


def test_run_survey_use_mesh_matches_unmeshed(survey, tmp_path):
    """``run_survey(use_mesh=True)`` with a (2, 2, 1) mesh of CPU devices
    over the native and padded archives: every archive once, its TOAs
    within 1 ns of the unmeshed survey's (the fixture's port run)."""
    from pulseportraiture_tpu_torch.parallel.mesh import make_mesh

    s = texe.run_survey(
        tplan.plan_survey(survey.files, modelfile=survey.gm),
        str(tmp_path / "wd"), process_index=0, process_count=1,
        bary=False, use_mesh=True,
        mesh=make_mesh(2, 2, 1, devices=["cpu"] * 4), device="cpu")
    assert s["counts"]["done"] == len(survey.files)
    for arch in survey.files:
        assert_same_tim(
            _archive_tim(s["checkpoint"], arch, str(tmp_path / "m.tim")),
            _archive_tim(survey.port["checkpoint"], arch,
                         str(tmp_path / "u.tim")), 2)


@pytest.mark.parametrize("error,state,reason", [
    ("oom", "quarantined", "oom: "),
    ("launch", "quarantined", "retries exhausted (2): "),
])
def test_device_errors_take_retry_and_quarantine_paths(survey, tmp_path,
                                                       monkeypatch, error,
                                                       state, reason):
    """The device errors the pipeline isolates per archive: a CUDA
    out-of-memory quarantines at once (retrying repeats it), a refused
    kernel launch retries and, persisting, quarantines — the reference's
    policy for its own device errors."""
    import torch

    from pulseportraiture_tpu_torch import _kernels

    def fail(*a, **kw):
        if error == "oom":
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 8.00 GiB")
        raise _kernels.KernelLaunchError("moments", 700)

    monkeypatch.setattr(ttoas, "fit_portrait_full_batch", fail)
    wd = str(tmp_path / "wd")
    s = texe.run_survey(tplan.plan_survey(survey.files[:1],
                                          modelfile=survey.gm),
                        wd, process_index=0, process_count=1, bary=False,
                        backoff_s=0.0, max_attempts=2, merge=False,
                        device="cpu")
    (q,) = s["quarantined"]
    assert q["archive"] == survey.files[0] and q["reason"].startswith(reason)
    states = [r["state"] for r in _union(wd)]
    assert states[-1] == state
    assert states.count("failed") == (0 if error == "oom" else 1)
    assert not os.path.exists(s["checkpoint"]) or \
        not _blocks(s["checkpoint"])


def test_narrowband_survey_matches_reference(survey, tmp_path):
    """run_survey(narrowband=True): per-channel TOAs of a native and a
    padded archive within 1 ns of the reference's narrowband survey, one
    checkpoint block each (a stop after one archive, then a resume)."""
    files = [survey.files[0], survey.files[4]]
    ckpts = []
    for exe, plan_mod, kw in ((texe, tplan, {"device": "cpu"}),
                              (jexe, jplan, {})):
        wd = str(tmp_path / exe.__name__.split(".")[0])
        plan = plan_mod.plan_survey(files, modelfile=survey.gm)
        s1 = exe.run_survey(plan, wd, process_index=0, process_count=1,
                            narrowband=True, max_archives=1, merge=False,
                            **kw)
        s2 = exe.run_survey(plan, wd, process_index=0, process_count=1,
                            narrowband=True, **kw)
        assert s1["counts"]["done"] == 1 and s2["counts"]["done"] == 2
        assert _done_counts(wd) == {a: 1 for a in files}
        assert _blocks(s2["checkpoint"]) == {a: 1 for a in files}
        ckpts.append(s2["checkpoint"])
    n = len(lines(ckpts[0], skip_comments=True))
    assert n == 2 * 16 + 2 * 12          # every live (subint, channel)
    assert_same_tim(ckpts[0], ckpts[1], n, skip_comments=True)
