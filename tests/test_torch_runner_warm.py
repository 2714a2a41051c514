"""The port's warm pass (``runner/warm.py``) against the JAX package's.

``program_specs`` enumerates the same program classes as the reference
for every workload and ``coalesce`` (it labels them with the
reference's batch-size policy, held equal to the reference's
``fit/portrait.auto_scan_size`` / ``bucket_batch_size`` too).  The warm pass runs each workload's
synthetic archive on the CPU; ``enable_persistent_cache`` moves the
kernel build directory (the counterpart of the reference's XLA cache)
and degrades, never fails; the compile watch counts the kernel builds
``obs/monitor.py`` publishes; a ``--warm`` survey gives the same TOAs
as a plain one and records the warm keys in its manifest.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu.runner import plan as jplan
from pulseportraiture_tpu.runner import warm as jwarm
from pulseportraiture_tpu_torch import _kernels, obs
from pulseportraiture_tpu_torch.fit import portrait as tfp
from pulseportraiture_tpu_torch.obs import monitor
from pulseportraiture_tpu_torch.runner import execute as texe
from pulseportraiture_tpu_torch.runner import plan as tplan
from pulseportraiture_tpu_torch.runner import warm as twarm
from pulseportraiture_tpu_torch.testing import faults
from torch_tim import lines

MODEL_PARAMS = np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5])


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("PPTPU_FAULTS", raising=False)
    faults.reset()
    yield
    faults.reset()


def _plan(mod, shapes):
    """A SurveyPlan of header facts only: [(nchan, nbin, nsub), ...]."""
    buckets = {}
    for i, (nchan, nbin, nsub) in enumerate(shapes):
        info = mod.ArchiveInfo("a%02d.fits" % i, nsub, 1, nchan, nbin,
                               nu0=1400.0 + 10 * i, bw=200.0)
        b = buckets.setdefault(info.bucket, mod.ShapeBucket(*info.bucket))
        b.archives.append(info)
    return mod.SurveyPlan(buckets.values(), [], modelfile="m.gmodel")


SHAPES = [(16, 128, 2), (12, 100, 2), (16, 128, 3), (64, 256, 4),
          (512, 2048, 16), (500, 2000, 16), (256, 1024, 130),
          (16, 128, 200)]


@pytest.mark.parametrize("coalesce", [(), (2,), (2, 4)],
                         ids=["none", "x2", "x2x4"])
@pytest.mark.parametrize("workloads", [
    ("toas",), ("zap",), ("align",), ("modelfit",),
    ("toas", "zap", "align", "modelfit")],
    ids=["toas", "zap", "align", "modelfit", "all"])
def test_program_specs_equal(workloads, coalesce):
    t = twarm.program_specs(_plan(tplan, SHAPES), coalesce=coalesce,
                            workloads=workloads)
    r = jwarm.program_specs(_plan(jplan, SHAPES), coalesce=coalesce,
                            workloads=workloads)
    assert [s.to_dict() for s in t] == [s.to_dict() for s in r]
    assert len(t) > 0


@pytest.mark.parametrize("nsub", [1, 3, 4, 5, 100, 128, 129, 200, 257,
                                  1000])
def test_solver_program_equal(nsub):
    assert twarm.solver_program(nsub) == jwarm.solver_program(nsub)


@pytest.mark.parametrize("sizes", [(1, 4, 5, 99, 127, 128),
                                   (129, 200, 2048, 2049, 5000)],
                         ids=["padded", "scanned"])
def test_batch_size_policy_equal(sizes):
    """The reference's subint batch policy in the port's fit/portrait.py
    (the warm specs' labels and the micro-batcher's sizing)."""
    for b in sizes:
        assert tfp.auto_scan_size(b) == jfp.auto_scan_size(b)
        assert tfp.bucket_batch_size(b) == jfp.bucket_batch_size(b)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_runner_warm")
    gm = str(tmp / "w.gmodel")
    write_model(gm, "w", "000", 1500.0, MODEL_PARAMS, np.ones(8, int),
                -4.0, 0, quiet=True)
    par = str(tmp / "w.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    files = []
    for i, (nchan, nbin) in enumerate([(16, 128), (12, 100)]):
        out = str(tmp / f"w{i}.fits")
        make_fake_pulsar(gm, par, out, nsub=2, nchan=nchan, nbin=nbin,
                         nu0=1500.0, bw=400.0, tsub=60.0, phase=0.05,
                         dDM=5e-4, noise_stds=0.01, dedispersed=False,
                         seed=610 + i, quiet=True)
        files.append(out)
    plan = tplan.plan_survey(files, modelfile=gm)
    return SimpleNamespace(tmp=tmp, gm=gm, files=files, plan=plan)


@pytest.mark.parametrize("workload", ["toas", "zap", "align", "modelfit"])
def test_warm_plan_runs_every_spec(ws, workload):
    """Each workload's warm pass runs its synthetic archive on the CPU:
    one ok program per (bucket, native, nsub) class, the summary keys
    of the reference."""
    with obs.run("warm", base_dir=str(ws.tmp / ("obs_" + workload))) \
            as rec:
        summary = twarm.warm_plan(ws.plan, ws.gm, workloads=(workload,),
                                  get_toas_kw={"bary": False},
                                  device="cpu")
    assert summary["n_programs"] == 2
    assert all(p["ok"] for p in summary["programs"]), summary["programs"]
    assert {p["workload"] for p in summary["programs"]} == {workload}
    assert set(summary) >= {"n_programs", "programs", "wall_s",
                            "backend_compiles", "compile_cache_hits",
                            "compile_cache_misses"}
    assert rec.counters.get("warm_programs") == 2


def test_warm_plan_failure_not_fatal(ws):
    """A program that cannot run records its error; the pass goes on."""
    summary = twarm.warm_plan(ws.plan, "/nonexistent/model.gmodel",
                              device="cpu")
    assert summary["n_programs"] == 2
    assert not any(p["ok"] for p in summary["programs"])
    assert all("error" in p for p in summary["programs"])


def test_enable_persistent_cache_sets_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    d = str(tmp_path / "kernels")
    assert twarm.enable_persistent_cache(d) is True
    assert _kernels.BUILD_DIR == d and os.path.isdir(d)
    assert _kernels._lib_path("moments").startswith(d + os.sep)


@pytest.mark.parametrize("how", ["fault", "not_a_dir"])
def test_enable_persistent_cache_degrades(tmp_path, monkeypatch, how):
    """A bad directory or an injected compile_cache fault: False, a
    compile_cache_degraded event, the build directory unchanged."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    before = _kernels.BUILD_DIR
    d = str(tmp_path / "cache")
    if how == "fault":
        faults.configure("site:compile_cache@nth=1")
    else:
        with open(d, "w") as f:
            f.write("not a directory")
    with obs.run("warm", base_dir=str(tmp_path / "obs")) as rec:
        assert twarm.enable_persistent_cache(d) is False
    assert rec.counters.get("compile_cache_degraded") == 1
    assert _kernels.BUILD_DIR == before


def test_compile_watch_counts_kernel_builds(tmp_path):
    """The watch reads the nvcc-build bridge: a miss + a build, a hit."""
    with obs.run("warm", base_dir=str(tmp_path / "obs")):
        watch = twarm._CompileWatch()
        monitor.publish(monitor.CACHE_MISS_EVENT, kernel="moments")
        monitor.publish(monitor.COMPILE_EVENT, 2.5, kernel="moments",
                        source="moments.cu")
        monitor.publish(monitor.CACHE_HIT_EVENT, kernel="fftfit")
        assert watch.delta() == {"backend_compiles": 1,
                                 "compile_cache_hits": 1,
                                 "compile_cache_misses": 1}
    assert twarm._CompileWatch().delta() == {
        "backend_compiles": 0, "compile_cache_hits": 0,
        "compile_cache_misses": 0}


def test_run_survey_warm_same_toas_and_manifest(ws, tmp_path,
                                                monkeypatch):
    """--warm=always with a kernel build directory: the manifest gains
    warm_s / time_to_first_fit_s / warm_summary and the TOAs equal a
    plain run's; without --warm those keys are absent."""
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    plain = texe.run_survey(ws.plan, str(tmp_path / "plain"),
                            process_index=0, process_count=1, bary=False,
                            device="cpu")
    warm = texe.run_survey(ws.plan, str(tmp_path / "warm"),
                           process_index=0, process_count=1, bary=False,
                           warm="always", prefetch=1,
                           compile_cache=str(tmp_path / "kernels"),
                           device="cpu")
    for key in ("warm_s", "time_to_first_fit_s", "warm_summary"):
        assert key in warm and key not in plain
    assert warm["warm_summary"]["n_programs"] == 2
    assert _kernels.BUILD_DIR == str(tmp_path / "kernels")
    assert lines(warm["checkpoint"], skip_comments=True) == \
        lines(plain["checkpoint"], skip_comments=True)


def test_run_survey_warm_auto_skips_without_payoff(ws, tmp_path):
    s = texe.run_survey(ws.plan, str(tmp_path / "wd"), process_index=0,
                        process_count=1, bary=False, warm="auto",
                        prefetch=0, device="cpu")
    assert "warm_s" not in s and s["counts"]["done"] == 2


def test_warm_plan_coalesced_specs_run(ws):
    """coalesce=(2,): the combined-batch fits run on the CPU too."""
    summary = twarm.warm_plan(ws.plan, ws.gm, coalesce=(2,),
                              get_toas_kw={"bary": False}, device="cpu")
    kinds = [p["kind"] for p in summary["programs"]]
    assert kinds.count("coalesced") == 1 and kinds.count("archive") == 2
    assert all(p["ok"] for p in summary["programs"]), summary["programs"]
