"""The port's observability hooks against the JAX package's, on the CPU.

The same archives (written by the JAX package's make_fake_pulsar, seeded)
go through both packages' ``get_TOAs`` (flags (1,1,0,0,0) and
``fit_scat``), ``get_narrowband_TOAs`` and ``align_archives`` with
``PPTPU_OBS_DIR`` set; the port on the CPU.  After times, pids, paths
and the JAX package's jit-compile events are taken out, each port run's
``events.jsonl`` must have the reference's span paths in order, the
same events with equal non-timing fields, and equal manifest counters;
its ``quality`` statistics agree within 1e-9 relative, its fit
telemetry within the fit tolerances of tests/test_torch_fit.py.
``tools/obs_report.py`` and ``tools/obs_diff.py`` read both runs.  One
archive has a subint with one live channel (two fit-flag groups), one
NaN channels the non-finite guard zaps, one too many (refused).

Also here: the per-archive device-error handling against the
reference's, the disabled-is-silent contract, the kernel-build bridge
(obs.monitor), the manifest's device block, the allocator watermarks
on the CPU and a span's device boundary.
"""

import contextlib
import json
import math
import os
import threading

import jax
import numpy as np
import pytest
import torch

from pulseportraiture_tpu.cli import pptoas as jcli
from pulseportraiture_tpu import obs as jobs
from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.obs import core as jcore
from pulseportraiture_tpu.pipelines import align as jalign
from pulseportraiture_tpu.pipelines import toas as jtoas
from pulseportraiture_tpu_torch import _kernels
from pulseportraiture_tpu_torch import obs as tobs
from pulseportraiture_tpu_torch.obs import core as tcore
from pulseportraiture_tpu_torch.obs import memory as tmemory
from pulseportraiture_tpu_torch.cli import pptoas as tcli
from pulseportraiture_tpu_torch.obs import monitor as tmonitor
from pulseportraiture_tpu_torch.pipelines import align as talign
from pulseportraiture_tpu_torch.pipelines import toas as ttoas
from tools import obs_diff, obs_report, obs_trace

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")

# event fields that are times, sizes of this process or trace ids
_VOLATILE = {"t", "dur_s", "peak_bytes", "fit_duration_s", "trace_id",
             "span_id", "parent_span_id"}
# fields that hold a path: compared by file name
_PATHS = {"archive", "datafile", "outfile", "modelfile", "checkpoint"}
# fit telemetry fields compared within the fit tolerance
_FIT_FLOATS = ("chi2", "red_chi2_per_subint")


@pytest.fixture(autouse=True)
def _no_stale_spans():
    """An exception escaping a ``phases`` region leaves its span on the
    thread's span stack, in both packages (ROADMAP Queue C), so a later
    span's path would carry it as a prefix: start and end every test here
    with empty stacks."""
    for core in (jcore, tcore):
        core._tls.stack = []
    yield
    for core in (jcore, tcore):
        core._tls.stack = []


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits here add variants to the JAX package's jit
    caches, which tests/test_retrace_budget.py holds to a budget in
    whatever test process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@contextlib.contextmanager
def _env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: v for k, v in kw.items() if v is not None})
    for k, v in kw.items():
        if v is None:
            os.environ.pop(k, None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _poisoned(real):
    """load_data with NaN channels: 2 of 16 in a2 (zapped by the guard),
    12 of 16 in a3 (refused)."""
    def load(filename, **kw):
        d = real(filename, **kw)
        name = os.path.basename(str(filename))
        if name == "a2.fits":
            d.subints[:, :, 3:5, :] = np.nan
        elif name == "a3.fits":
            d.subints[:, :, :12, :] = np.nan
        return d
    return load


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_obs")
    files = []
    for i in range(4):
        w = np.ones((4, 16))
        w[:, 11] = 0.0
        if i == 1:
            w[2] = 0.0
            w[2, 7] = 1.0  # a subint with one live channel
        out = str(tmp / ("a%d.fits" % i))
        make_fake_pulsar(GMODEL, PAR, out, nsub=4, nchan=16, nbin=128,
                         tsub=60.0, phase=0.1 * i - 0.12, dDM=1e-3 * i,
                         weights=w, noise_stds=0.05, seed=40 + i,
                         quiet=True)
        files.append(out)
    tmpl = str(tmp / "tmpl.fits")
    make_fake_pulsar(GMODEL, PAR, tmpl, nsub=1, nchan=16, nbin=128,
                     tsub=60.0, noise_stds=0.0, dedispersed=True, seed=0,
                     quiet=True)
    return tmp, files, tmpl


def _one_run(base):
    runs = sorted(os.listdir(base))
    assert len(runs) == 1, runs
    return os.path.join(base, runs[0])


def _scenario(tmp, name, files, tmpl, monkeypatch):
    """Run one scenario through both packages with PPTPU_OBS_DIR set:
    {"jax": run dir, "torch": run dir}."""
    out = {}
    for key, toas, align, cli, kw in (("jax", jtoas, jalign, jcli, {}),
                                      ("torch", ttoas, talign, tcli,
                                       {"device": "cpu"})):
        base = str(tmp / ("%s_%s" % (name, key)))
        outdir = tmp / ("%s_%s_out" % (name, key))  # same file names
        outdir.mkdir()
        with monkeypatch.context() as mp, _env(PPTPU_OBS_DIR=base):
            mp.setattr(toas, "load_data", _poisoned(toas.load_data))
            if name == "align":
                align.align_archives(files[:2], tmpl, niter=1,
                                     outfile=str(outdir / "aligned.fits"),
                                     quiet=True, **kw)
            elif name == "cli":  # one run: the fit and the .tim write
                argv = ["-d", files[0], "-m", GMODEL, "--quiet", "-o",
                        str(outdir / "toas.tim")]
                assert cli.main(argv + (["--device", "cpu"] if kw
                                        else [])) == 0
            else:
                gt = toas.GetTOAs(files if name == "wideband"
                                  else files[:1], GMODEL, quiet=True, **kw)
                if name == "narrowband":
                    gt.get_narrowband_TOAs(quiet=True)
                else:
                    gt.get_TOAs(fit_scat=name == "scat", quiet=True)
                gt.write_TOAs(outfile=str(outdir / "toas.tim"))
        out[key] = _one_run(base)
    return out


@pytest.fixture(scope="module")
def runs(data):
    tmp, files, tmpl = data
    for core in (jcore, tcore):  # see _no_stale_spans
        core._tls.stack = []
    mp = pytest.MonkeyPatch()
    try:
        return {name: _scenario(tmp, name, files, tmpl, mp)
                for name in ("wideband", "scat", "narrowband", "align",
                             "cli")}
    finally:
        mp.undo()


def _events(run_dir):
    out = []
    for path in tobs.list_event_files(run_dir):
        with open(path, encoding="utf-8") as fh:
            out.extend(json.loads(ln) for ln in fh if ln.strip())
    return out


def _manifest(run_dir):
    with open(os.path.join(run_dir, "manifest.json")) as fh:
        return json.load(fh)


def _normalized(run_dir):
    """The run's events without the JAX package's compile events, times,
    process sizes, trace ids; paths by file name; the fit events'
    batch_padded (the port's eager solver pads no batch)."""
    out = []
    for e in _events(run_dir):
        if e["kind"] == "compile":
            continue
        e = {k: (os.path.basename(v) if k in _PATHS and v else v)
             for k, v in e.items() if k not in _VOLATILE}
        if e["kind"] == "fit":
            e.pop("batch_padded")
        out.append(e)
    return out


def _close(a, b, rtol):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], rtol)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rtol)
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-12) or (
            math.isnan(a) and math.isnan(b)), (a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("scenario", ["wideband", "scat", "narrowband",
                                      "align", "cli"])
def test_events_match_reference(runs, scenario):
    ref = _normalized(runs[scenario]["jax"])
    port = _normalized(runs[scenario]["torch"])
    spans = [(e["path"]) for e in ref if e["kind"] == "span"]
    assert [e["path"] for e in port if e["kind"] == "span"] == spans
    assert [(e["kind"], e.get("name")) for e in port] == \
        [(e["kind"], e.get("name")) for e in ref]
    for a, b in zip(port, ref):
        if a["kind"] == "quality":
            _close(a, b, 1e-9)
        elif a["kind"] == "fit":
            fa = {k: a.pop(k) for k in _FIT_FLOATS}
            fb = {k: b.pop(k) for k in _FIT_FLOATS}
            # red chi2 is printed to 6 decimals; the fits agree far
            # closer than one printed digit
            _close(fa["chi2"], fb["chi2"], 1e-8)
            np.testing.assert_allclose(fa["red_chi2_per_subint"],
                                       fb["red_chi2_per_subint"],
                                       rtol=0, atol=1.5e-6)
            assert a == b
        else:
            assert a == b
    assert spans, "no span events"


def test_counters_and_config_match_reference(runs):
    jax_only = {"jaxpr_traces", "backend_compiles", "compile_cache_hits",
                "compile_cache_misses"}
    for scenario, pair in runs.items():
        ref, port = _manifest(pair["jax"]), _manifest(pair["torch"])
        assert port["counters"] == {k: v for k, v in
                                    ref["counters"].items()
                                    if k not in jax_only}, scenario
        cfg = dict(ref["config"])
        for k in ("modelfile", "outfile"):
            if k in cfg:
                assert os.path.basename(port["config"].pop(k)) == \
                    os.path.basename(cfg.pop(k))
        assert port["config"] == cfg, scenario
        q = {k: v for k, v in ref["gauges"].items()
             if k.startswith("quality_")}
        _close({k: port["gauges"][k] for k in q}, q, 1e-9)
        assert port["platform"] == ref["platform"] == "cpu"


def test_wideband_runs_exercise_every_hook(runs):
    events = _normalized(runs["wideband"]["torch"])
    names = [e.get("name") for e in events if e["kind"] == "event"]
    assert names.count("nonfinite_guard") == 2
    assert names.count("archive") == 3
    skipped = [e.get("skipped") for e in events if e["kind"] == "span"]
    assert skipped.count("nonfinite_poison") == 1
    assert {e["fit_flags"][1] for e in events if e["kind"] == "fit"} == \
        {0, 1}  # both fit-flag groups
    cli = _normalized(runs["cli"]["torch"])
    assert [e["path"] for e in cli if e["kind"] == "span"] == [
        "load", "guess", "solve", "polish", "write"]
    assert sorted(os.listdir(runs["wideband"]["torch"])) == sorted(
        os.listdir(runs["wideband"]["jax"]))


def test_obs_report_and_diff_read_port_runs(runs):
    for scenario, pair in runs.items():
        texts = {k: obs_report.summarize(v) for k, v in pair.items()}
        heads = {k: [ln for ln in t.splitlines() if ln.startswith("## ")
                     # the JAX package's jit compiles; the port compiles
                     # no kernel on the CPU
                     and ln != "## compile attribution"]
                 for k, t in texts.items()}
        assert heads["torch"] == heads["jax"], scenario
        assert "## phases" in heads["torch"]
        assert "platform: cpu" in texts["torch"]
        d = obs_diff.diff_runs(obs_diff.run_summary(pair["jax"]),
                               obs_diff.run_summary(pair["torch"]),
                               rel=1e9, min_s=1e9, quality_rel=1e-6,
                               quality_min_subints=1)
        assert not d.regressions, (scenario, d.regressions)
    assert obs_diff.main([runs["wideband"]["jax"],
                          runs["wideband"]["torch"], "--rel", "1e9",
                          "--min-s", "1e9"]) == 0


def test_obs_trace_reads_traced_runs(data, tmp_path):
    """Under an ambient trace context the spans carry trace and span
    ids in both packages; tools/obs_trace.py rebuilds the same trees,
    and the port's checkpoint marker names the trace."""
    _, files, _ = data
    got = {}
    for key, toas, obs, kw in (("jax", jtoas, jobs, {}),
                               ("torch", ttoas, tobs, {"device": "cpu"})):
        base = str(tmp_path / key)
        ckpt = str(tmp_path / ("%s.tim" % key))
        with _env(PPTPU_OBS_DIR=base):
            ctx = obs.tracing.mint()
            with obs.tracing.activate(ctx):
                gt = toas.GetTOAs(files[:1], GMODEL, quiet=True, **kw)
                gt.get_TOAs(quiet=True, checkpoint=ckpt)
        res = obs_trace.analyze([_one_run(base)])
        (tid, summary), = res["traces"].items()
        assert tid == ctx[0] and not res["orphan_spans"]
        assert summary["root"] in ("load", "guess", "solve", "polish",
                                   "write", "checkpoint")
        got[key] = (res["n_spans"], summary["n_spans"])
        marks = toas.checkpoint_traces(ckpt)
        assert marks == {os.path.realpath(files[0]): ctx[0]}
    assert got["torch"] == got["jax"]


# -- per-archive device errors -------------------------------------------


def _failing_fit(real, error, calls):
    def fit(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise error
        return real(*args, **kw)
    return fit


def test_device_error_recorded_per_archive_as_reference(data, tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """A device error on the second of three archives: the reference's
    JaxRuntimeError and the port's KernelLaunchError leave the same
    ok_idatafiles, failed_datafiles and device_errors counter."""
    _, files, _ = data
    files = files[:3]
    got = {}
    for key, toas, err, kw in (
            ("jax", jtoas, jax.errors.JaxRuntimeError("INTERNAL: lost"),
             {}),
            ("torch", ttoas, _kernels.KernelLaunchError("moments", 700),
             {"device": "cpu"})):
        base = str(tmp_path / key)
        calls = []
        monkeypatch.setattr(toas, "fit_portrait_full_batch", _failing_fit(
            toas.fit_portrait_full_batch, err, calls))
        with _env(PPTPU_OBS_DIR=base):
            gt = toas.GetTOAs(files, GMODEL, quiet=True, **kw)
            gt.get_TOAs(quiet=True)
        man = _manifest(_one_run(base))
        got[key] = (gt.ok_idatafiles,
                    [(os.path.basename(f), e) for f, e in
                     gt.failed_datafiles],
                    man["counters"].get("device_errors"), len(gt.TOA_list),
                    [e.get("error") for e in _events(_one_run(base))
                     if e["kind"] == "span" and e.get("error")])
    assert got["torch"][:4] == (got["jax"][0], [("a1.fits", str(
        _kernels.KernelLaunchError("moments", 700)))], 1, got["jax"][3])
    assert got["jax"][1] == [("a1.fits", "INTERNAL: lost")]
    assert got["torch"][0] == [0, 2]
    assert got["torch"][4] == ["KernelLaunchError"]
    assert got["jax"][4] == ["JaxRuntimeError"]
    err = capsys.readouterr().err
    assert "Device error fitting %s" % files[1] in err


def test_device_errors_are_narrow():
    assert issubclass(_kernels.KernelLaunchError, RuntimeError)
    assert _kernels.KernelLaunchError in ttoas.DEVICE_ERRORS
    assert torch.cuda.OutOfMemoryError in ttoas.DEVICE_ERRORS
    assert RuntimeError not in ttoas.DEVICE_ERRORS
    assert Exception not in ttoas.DEVICE_ERRORS


def test_other_errors_escape_the_archive_loop(data, monkeypatch):
    """Anything but a device error leaves get_TOAs, as in the reference."""
    _, files, _ = data

    def broken(*args, **kw):
        raise ValueError("not a device error")

    monkeypatch.setattr(ttoas, "fit_portrait_full_batch", broken)
    gt = ttoas.GetTOAs(files[:1], GMODEL, quiet=True, device="cpu")
    with pytest.raises(ValueError):
        gt.get_TOAs(quiet=True)
    assert gt.failed_datafiles == []


# -- disabled = silent -----------------------------------------------------


def test_obs_off_writes_nothing_and_starts_no_thread(data, tmp_path,
                                                     monkeypatch):
    _, files, tmpl = data
    for var in ("PPTPU_OBS_DIR", "PPTPU_TRACE_DIR", "PPTPU_FAULTS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    threads = {t.ident for t in threading.enumerate()}
    gt = ttoas.GetTOAs(files[:2], GMODEL, quiet=True, device="cpu")
    gt.get_TOAs(quiet=True)
    gt.get_narrowband_TOAs(quiet=True)
    talign.align_archives(files[:1], tmpl, niter=1, quiet=True,
                          outfile=str(tmp_path / "al.fits"),
                          device="cpu")
    assert tobs.current() is None
    assert sorted(os.listdir(tmp_path)) == ["al.fits"]
    assert {t.ident for t in threading.enumerate()} <= threads


# -- the kernel-build bridge -------------------------------------------------


def test_kernel_builds_become_compile_events(tmp_path, monkeypatch):
    """nvcc builds publish compile events and cache outcomes through
    obs.monitor (driven here through the bridge: this machine has no
    nvcc)."""
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path))
    with tobs.run("build") as rec:
        with tobs.span("load"):
            tmonitor.publish(tmonitor.CACHE_MISS_EVENT, kernel="fftfit")
            tmonitor.publish(tmonitor.COMPILE_EVENT, 2.5, kernel="fftfit",
                             source="fftfit.cu")
        tmonitor.publish(tmonitor.CACHE_HIT_EVENT, kernel="moments")
        run_dir = rec.dir
    # no subscriber once the run is closed
    tmonitor.publish(tmonitor.COMPILE_EVENT, 1.0, kernel="x")
    comp = [e for e in _events(run_dir) if e["kind"] == "compile"]
    assert [(e["kernel"], e["source"], e["dur_s"], e["span"])
            for e in comp] == [("fftfit", "fftfit.cu", 2.5, "load")]
    man = _manifest(run_dir)
    assert man["counters"] == {"backend_compiles": 1,
                               "compile_cache_hits": 1,
                               "compile_cache_misses": 1}
    assert man["compile_total_s"] == 2.5
    text = obs_report.summarize(run_dir)
    assert "## compile attribution" in text
    assert "## compile cache (persistent)" in text


def test_build_publishes_a_cache_hit_for_a_built_library(tmp_path,
                                                         monkeypatch):
    """_kernels.build finds a library already built: one cache hit, no
    nvcc (a stand-in library takes the place of the built one)."""
    lib = tmp_path / "libstub.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_kernels, "_LIBS", {})
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_kernels, "_lib_path", lambda name: str(lib))

    class _Fn:
        pass

    monkeypatch.setattr(_kernels.ctypes, "CDLL",
                        lambda path: type("L", (), {
                            s: _Fn() for s in _kernels._SYMBOLS["moments"]}))
    seen = []
    cb = tmonitor.subscribe(lambda evt, dur, **kw: seen.append(
        (evt, kw["kernel"])))
    try:
        _kernels.build(["moments"])
    finally:
        tmonitor.unsubscribe(cb)
    assert seen == [(tmonitor.CACHE_HIT_EVENT, "moments")]


# -- manifest, memory and span boundaries on the CPU ------------------------


def test_manifest_device_block_leaves_cuda_alone(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path))
    with tobs.run("m") as rec:
        run_dir = rec.dir
    man = _manifest(run_dir)
    assert man["platform"] == "cpu" and man["device_kind"] == "cpu"
    assert man["torch_version"] == torch.__version__
    assert "jax_version" not in man
    assert not torch.cuda.is_initialized()


def test_memory_sampler_on_the_cpu_reads_host_rss(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path))
    monkeypatch.setenv("PPTPU_MEMORY_INTERVAL", "0")
    s = tmemory.sample()
    assert s["source"] == "host" and "device_bytes_in_use" not in s
    assert s["footprint_bytes"] == s["host_rss_bytes"] > 0
    with tobs.run("mem") as rec:
        with tobs.span("alloc"):
            big = np.ones(1 << 24)  # 128 MB
            big[::4096] = 2.0
        del big
        run_dir = rec.dir
    ev = [e for e in _events(run_dir) if e["kind"] == "span"][0]
    assert ev["peak_bytes"] >= 1 << 27
    gauges = _manifest(run_dir)["gauges"]
    assert gauges["peak_footprint_bytes"] >= ev["peak_bytes"]
    assert "device_peak_bytes" not in gauges
    assert tmemory.device_memory_dump(str(tmp_path)) is None


def test_span_watermark_folds_the_allocator_peak(monkeypatch):
    """A peak between two samples: the allocator's peak rose while the
    bracket was open, so the bracket reports it."""
    samples = iter([
        {"host_rss_bytes": 1, "footprint_bytes": 10,
         "device_bytes_in_use": 10, "device_peak_bytes": 50,
         "source": "device"},
        {"host_rss_bytes": 1, "footprint_bytes": 10,
         "device_bytes_in_use": 10, "device_peak_bytes": 50,
         "source": "device"},
        {"host_rss_bytes": 1, "footprint_bytes": 12,
         "device_bytes_in_use": 12, "device_peak_bytes": 90,
         "source": "device"},
        {"host_rss_bytes": 1, "footprint_bytes": 12,
         "device_bytes_in_use": 12, "device_peak_bytes": 90,
         "source": "device"},
        {"host_rss_bytes": 1, "footprint_bytes": 12,
         "device_bytes_in_use": 12, "device_peak_bytes": 90,
         "source": "device"}])
    monkeypatch.setattr(tmemory, "sample", lambda: next(samples))

    class _Rec:
        _metrics = None

    st = tmemory.MemoryState(_Rec(), interval_s=0)
    tok = st.mark()           # peak 50 when it opened
    assert st.peak(tok) == 90  # the allocator's peak rose to 90 inside
    tok = st.mark()
    assert st.peak(tok) == 12  # no rise: the sampled footprint
    assert st.run_peak_bytes == 90


def test_span_block_ignores_cpu_tensors(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path))
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    with tobs.run("b"):
        with tobs.span("solve") as sp:
            out = sp.block({"x": torch.ones(3), "y": [np.ones(2), 1.0]})
        ph = tobs.phases(archive="a")
        ph.enter("fit")
        ph.block(torch.zeros(2))
        ph.done()
    assert synced == []
    assert float(out["x"].sum()) == 3.0


def test_fit_telemetry_copies_tensors_to_the_host(tmp_path, monkeypatch):
    monkeypatch.setenv("PPTPU_OBS_DIR", str(tmp_path))
    res = {"nfeval": torch.tensor([3, 5]), "red_chi2":
           torch.tensor([1.0, math.nan], dtype=torch.float64),
           "return_code": torch.tensor([1, 3])}
    with tobs.run("f") as rec:
        assert tobs.fit_telemetry(res, where="w") is res
        run_dir = rec.dir
    (ev,) = [e for e in _events(run_dir) if e["kind"] == "fit"]
    assert ev["nfeval_per_subint"] == [3, 5]
    assert ev["rc_hist"] == {"1": 1, "3": 1}
    assert ev["bad_isubs"] == [1] and ev["chi2"]["n_nonfinite"] == 1
    assert tobs.fit_telemetry(res) is res  # no run: untouched
