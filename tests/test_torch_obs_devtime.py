"""Device-time attribution of the port (obs/devtime.py, obs/trace.py).

On a checked-in Chrome trace (tests/data/torch_devtime.trace.json, the
layout torch.profiler exports on the card: kernel, gpu_memcpy and
gpu_memset rows on two streams, the host rows around their launches, and
the gpu_user_annotation mirror of the record_function ranges on each
stream) the stage totals must come out exact: the scope of a row is the
pp_* ranges on its stream that contain its start, and each hand kernel's
rows are held against its launches over the region (a capture that lost
rows says so: ``complete`` False).  On the CPU a real
torch.profiler capture around the port's pipeline must yield one devtime
event per fit region with no device rows, and the capture keeps the
reference's contract: a nested capture is skipped with an event, a
profiler that cannot start never fails the run.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch import obs as tobs
from pulseportraiture_tpu_torch.io.archive import make_fake_pulsar
from pulseportraiture_tpu_torch.obs import devtime
from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs
from tools import obs_report

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "data", "torch_devtime.trace.json")
EXAMPLES = os.path.join(HERE, os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")


def _events(run_dir):
    out = []
    for path in tobs.list_event_files(run_dir):
        with open(path, encoding="utf-8") as fh:
            out.extend(json.loads(ln) for ln in fh if ln.strip())
    return out


def _region(tmp_path, sessions=("20260101T000000.000001",)):
    """A region directory holding the fixture in each session (the
    newest last)."""
    region = tmp_path / "region"
    for s in sessions:
        (region / s).mkdir(parents=True)
        shutil.copy(FIXTURE, region / s / "pid1.trace.json")
    return str(region)


def test_fixture_stage_totals_are_exact(tmp_path):
    s = devtime.summarize_region(_region(tmp_path))
    # microseconds: seed 4 + 3; solve 8 + 3 + 2 (+ 6 under pp_scatter);
    # polish 7 + 2 (the second stream's row); 1 outside every range
    assert s["scopes"] == {"pp_seed": 7e-06, "pp_solve": 1.3e-05,
                           "pp_solve/pp_scatter": 6e-06,
                           "pp_polish": 9e-06}
    assert s["phases"] == {"guess": 7e-06, "solve": 1.9e-05,
                           "polish": 9e-06}
    assert s["unattributed_s"] == 1e-06
    assert s["device_total_s"] == 3.6e-05
    assert s["n_ops"] == 9
    assert s["top_ops"]["(anonymous namespace)::moments_kernel"
                        "(double2 const*)"] == 1.5e-05
    assert s["trace"].endswith("pid1.trace.json")


def test_fixture_rows_and_kernel_names(tmp_path):
    rows = devtime.parse_chrome_trace(FIXTURE)
    dev = [r for r in rows if r["op"]]
    assert {r["cat"] for r in dev} == set(devtime.DEVICE_CATEGORIES)
    counts = {name: sum(1 for r in dev if fn in r["op"])
              for name, fn in _kernels.TRACE_NAMES.items()}
    assert counts == {"moments": 2, "moments_grad_hess": 0, "fftfit": 1,
                      "moments_scat": 1, "moments_scat_grad_hess": 0,
                      "spectra": 0, "spectra_noise": 0, "unpack": 0,
                      "baseline": 0, "load_stats": 0, "rotate": 0,
                      "smooth_search": 0, "gauss_normal": 0, "gauss_sse": 0,
                      "gauss_ft_normal": 0, "gauss_ft_sse": 0,
                      "noise_fit": 0, "synth_rows": 0}
    assert devtime.scopes_of(["pp_solve", "x", "pp_scatter", None]) == \
        ["pp_solve", "pp_scatter"]


FIXTURE_ROWS = {"moments": 2, "fftfit": 1, "moments_scat": 1}


@pytest.mark.parametrize("extra", [0, 1, 3], ids=["equal", "lost1", "lost3"])
def test_kernel_rows_held_against_launches(tmp_path, extra):
    """Each hand kernel's rows in the capture against its launches over
    the region: complete only where they are equal, and the rows missing
    counted (a region's first K1 rows lost by the profiler)."""
    launched = {name: FIXTURE_ROWS.get(name, 0) for name in _kernels.LAUNCHES}
    launched["moments"] += extra
    s = devtime.summarize_region(_region(tmp_path), kernels={
        name: (_kernels.TRACE_NAMES[name], n) for name, n in
        launched.items()})
    assert s["kernel_launches"] == launched
    assert s["kernel_rows"] == {name: FIXTURE_ROWS.get(name, 0)
                                for name in _kernels.LAUNCHES}
    assert s["complete"] is (extra == 0) and s["lost_rows"] == extra
    # the device total is what the trace holds, lost rows or not
    assert s["device_total_s"] == 3.6e-05
    assert "complete" not in devtime.summarize_region(_region(tmp_path /
                                                              "plain"))


def test_incomplete_capture_is_counted_in_the_run(tmp_path, monkeypatch):
    """A capture whose region launched a hand kernel more often than its
    trace shows (here: counts raised by hand, the CPU having no device
    rows) is marked incomplete in its devtime event and counted in the
    run's devtime_incomplete counter; a capture that launched nothing is
    complete."""
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("PPTPU_TRACE_DIR", str(tmp_path / "trace"))
    saved = dict(_kernels.LAUNCHES)
    try:
        with tobs.run("lost") as rec:
            with tobs.trace_capture("quiet"):
                torch.ones(64).sum()
            with tobs.trace_capture("lossy"):
                _kernels.LAUNCHES["spectra"] += 2
            run_dir = rec.dir
    finally:
        _kernels.LAUNCHES.update(saved)
    quiet, lossy = [e for e in _events(run_dir) if e["kind"] == "devtime"]
    assert quiet["complete"] and quiet["lost_rows"] == 0
    assert not lossy["complete"] and lossy["lost_rows"] == 2
    assert lossy["kernel_launches"]["spectra"] == 2
    assert lossy["kernel_rows"]["spectra"] == 0
    with open(os.path.join(run_dir, "manifest.json")) as fh:
        counters = json.load(fh)["counters"]
    assert counters["devtime_regions"] == 2
    assert counters["devtime_incomplete"] == 1


def test_newest_session_wins_and_a_region_without_one_is_none(tmp_path):
    region = _region(tmp_path, ("20260101T000000.000001",
                                "20260101T000000.000002"))
    assert "000002" in devtime.find_capture(region)
    assert devtime.summarize_region(str(tmp_path / "empty")) is None
    out = devtime.summarize_trace_dir(str(tmp_path))
    assert list(out) == ["region"]


def test_record_devtime_feeds_the_report(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path / "obs"))
    region = _region(tmp_path)
    assert devtime.record_devtime("r", region) is None  # no run
    with tobs.run("dt") as rec:
        s = devtime.record_devtime("r", region)
        run_dir = rec.dir
    (ev,) = [e for e in _events(run_dir) if e["kind"] == "devtime"]
    assert ev["region"] == "r" and ev["scopes"] == s["scopes"]
    with open(os.path.join(run_dir, "manifest.json")) as fh:
        man = json.load(fh)
    assert man["counters"]["devtime_regions"] == 1
    assert man["counters"]["device_seconds_total"] == 3.6e-05
    text = obs_report.summarize(run_dir)
    assert "## device time (named-scope attribution)" in text
    assert "| pp_solve/pp_scatter |" in text
    # a torn capture is an event, never an exception
    bad = tmp_path / "bad" / "s"
    bad.mkdir(parents=True)
    (bad / "x.trace.json").write_text("{not json")
    with tobs.run("dt2") as rec:
        assert devtime.record_devtime("bad", str(tmp_path / "bad")) \
            is None
        run_dir = rec.dir
    assert [e["name"] for e in _events(run_dir)] == ["devtime_error"]


def test_cpu_capture_of_a_scoped_region(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("PPTPU_TRACE_DIR", str(tmp_path / "trace"))
    with tobs.run("cap") as rec:
        with tobs.trace_capture("outer") as path:
            with record_function("pp_solve"):
                torch.ones(64).sum()
            # the profiler is one per process: a nested capture degrades
            with tobs.trace_capture("inner") as inner:
                assert inner is None
        run_dir = rec.dir
    assert path == str(tmp_path / "trace" / "outer")
    ev = _events(run_dir)
    assert [e.get("name") or e["kind"] for e in ev] == \
        ["trace_skipped", "trace", "devtime"]
    assert ev[0]["active_region"] == "outer"
    dt = ev[2]
    # the CPU has no device rows: nothing to attribute
    assert dt["device_total_s"] == 0.0 and dt["n_ops"] == 0
    names = {r["name"] for r in devtime.parse_chrome_trace(dt["trace"])
             if r["cat"] == "user_annotation"}
    assert "pp_solve" in names


def test_capture_that_cannot_start_never_fails(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path / "obs"))

    def refuse(*args, **kw):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with tobs.run("err") as rec:
        with tobs.trace_capture("r", base_dir=str(tmp_path)) as path:
            assert path is None
        # the singleton is free again
        assert tobs.trace._active_region is None
        run_dir = rec.dir
    (ev,) = _events(run_dir)
    assert ev["name"] == "trace_error" and "busy" in ev["error"]


def test_capture_off_without_trace_dir(monkeypatch):
    monkeypatch.delenv("PPTPU_TRACE_DIR", raising=False)
    with tobs.trace_capture("x") as path:
        assert path is None
    assert tobs.trace_dir() is None


@pytest.mark.parametrize("narrowband", [False, True],
                         ids=["wideband", "narrowband"])
def test_pipeline_emits_one_devtime_per_fit_region(tmp_path, monkeypatch,
                                                   narrowband):
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path / "obs"))
    monkeypatch.setenv("PPTPU_TRACE_DIR", str(tmp_path / "trace"))
    files = [make_fake_pulsar(GMODEL, PAR, str(tmp_path / ("a%d.fits" % i)),
                              nsub=2, nchan=8, nbin=64, phase=0.1,
                              dDM=1e-3, noise_stds=0.05, seed=i)
             for i in range(2)]
    gt = GetTOAs(files, GMODEL, quiet=True, device="cpu")
    if narrowband:
        gt.get_narrowband_TOAs(quiet=True)
    else:
        gt.get_TOAs(fit_scat=True, quiet=True)
    (run,) = os.listdir(tmp_path / "obs")
    ev = _events(str(tmp_path / "obs" / run))
    prefix = "ppnbtoas" if narrowband else "pptoas"
    assert [e["region"] for e in ev if e["kind"] == "devtime"] == \
        ["%s_arch%03d" % (prefix, i) for i in range(2)]
    stages = set()
    for e in ev:
        if e["kind"] == "devtime":
            stages |= {r["name"] for r in devtime.parse_chrome_trace(
                e["trace"]) if r["cat"] == "user_annotation"}
    if not narrowband:
        assert {"pp_solve", "pp_polish", "pp_scatter"} <= stages
    assert np.isfinite(np.concatenate(gt.phis)).all()
