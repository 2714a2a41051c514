"""The port's ``ppsurvey`` CLI against the JAX package's.

Every subcommand takes the reference's options plus ``--device``; a
plan/run/resume/status/report round trip on the CPU; the device policy
(no CUDA and no ``--device cpu``: the command fails) and ``--mesh``
(refused without CUDA, the unmeshed TOAs on a CPU mesh); ``supervise``
running two worker subprocesses of the port over one workdir, every
archive done once.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.cli import ppsurvey as jcli
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.io.gmodel import write_model
from pulseportraiture_tpu_torch.cli import ppsurvey as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_PARAMS = np.array([0.0, 0.0, 0.4, 0.0, 0.05, 0.0, 1.0, -0.5])
COMMANDS = ("plan", "run", "resume", "warm", "supervise", "status",
            "report")
# subcommands whose port version adds --device
DEVICE_COMMANDS = ("run", "resume", "warm", "supervise")


def _options(parser, command):
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {opt: (a.dest, a.default, a.nargs, getattr(a, "choices", None))
            for a in sub.choices[command]._actions
            for opt in a.option_strings}


@pytest.mark.parametrize("command", COMMANDS)
def test_options_match_reference(command):
    """The reference's options with the same destinations, defaults and
    choices; the port adds --device (cuda by default) where it fits."""
    t = _options(tcli.build_parser(), command)
    r = _options(jcli.build_parser(), command)
    extra = {"--device"} if command in DEVICE_COMMANDS else set()
    assert set(t) == set(r) | extra
    for opt in r:
        assert t[opt] == r[opt], opt
    if extra:
        assert t["--device"][1] == "cuda"


@pytest.mark.parametrize("pairs", [[], ["nstd=5"], ["niter=2", "x=abc"],
                                   ["kind=\"gauss\"", "l=[1, 2]"]])
def test_workload_opts_parse_equal(pairs):
    assert tcli._parse_workload_opts(pairs) == \
        jcli._parse_workload_opts(pairs)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ppsurvey_cli")
    gm = str(tmp / "c.gmodel")
    write_model(gm, "c", "000", 1500.0, MODEL_PARAMS, np.ones(8, int),
                -4.0, 0, quiet=True)
    par = str(tmp / "c.par")
    with open(par, "w") as f:
        f.write("PSR J0\nRAJ 00:00:00\nDECJ 00:00:00\nF0 200.0\n"
                "PEPOCH 56000.0\nDM 30.0\n")
    files = []
    for i in range(4):
        out = str(tmp / f"c{i}.fits")
        make_fake_pulsar(gm, par, out, nsub=2, nchan=16, nbin=128,
                         nu0=1500.0, bw=400.0, tsub=60.0,
                         phase=0.03 * (i + 1), dDM=5e-4, noise_stds=0.01,
                         dedispersed=False, seed=710 + i, quiet=True)
        files.append(out)
    bad = str(tmp / "bad.fits")
    with open(bad, "wb") as f:
        f.write(b"SIMPLE  =                    T" + b" " * 100)
    meta = str(tmp / "c.meta")
    with open(meta, "w") as f:
        f.write("\n".join(files + [bad]) + "\n")
    return SimpleNamespace(tmp=tmp, gm=gm, files=files, bad=bad, meta=meta)


def _union(workdir):
    recs = []
    for name in sorted(os.listdir(workdir)):
        if name.startswith("ledger.") and name.endswith(".jsonl"):
            with open(os.path.join(workdir, name)) as fh:
                recs.extend(json.loads(ln) for ln in fh if ln.strip())
    return recs


def _done(workdir):
    out = {}
    for r in _union(workdir):
        if r["state"] == "done":
            out[r["archive"]] = out.get(r["archive"], 0) + 1
    return out


def _blocks(workdir):
    out = {}
    for name in os.listdir(workdir):
        if name.startswith("toas.") and name.endswith(".tim"):
            for ln in open(os.path.join(workdir, name)):
                tok = ln.split()
                if tok[:2] == ["C", "pp_done"]:
                    out[tok[2]] = out.get(tok[2], 0) + 1
    return out


def test_plan_run_resume_status_report(ws, tmp_path, capsys):
    wd = str(tmp_path / "wd")
    assert tcli.main(["plan", "-d", ws.meta, "-m", ws.gm, "-w", wd]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_archives"] == 4 and out["unreadable"] == 1
    assert out["buckets"] == {"16x128": 4}
    assert tcli.main(["run", "-w", wd, "--device", "cpu", "--no_bary",
                      "--max_archives", "2", "--quiet"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["counts"]["done"] == 2 and out["counts"]["pending"] == 2
    assert tcli.main(["resume", "-w", wd, "--device", "cpu", "--no_bary",
                      "--quiet"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["counts"]["done"] == 4 and out["counts"]["quarantined"] == 1
    assert _done(wd) == {f: 1 for f in ws.files}
    assert _blocks(wd) == {f: 1 for f in ws.files}
    assert tcli.main(["status", "-w", wd]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["counts"]["done"] == 4
    assert st["quarantined"][0]["archive"] == ws.bad
    assert tcli.main(["report", "-w", wd]) == 0
    text = capsys.readouterr().out
    assert "## survey state" in text and "- done: 4" in text
    assert "## quarantined archives" in text and ws.bad in text
    # tools/obs_report.py rendered the merged run (port obs helpers)
    assert "| load " in text and "| solve " in text
    assert tcli.main(["status", "-w", wd, "--watch", "--interval", "0.05",
                      "--ticks", "1"]) == 0


def test_warm_command(ws, tmp_path, capsys):
    wd = str(tmp_path / "wd")
    assert tcli.main(["plan", "-d", ws.meta, "-m", ws.gm, "-w", wd]) == 0
    capsys.readouterr()
    assert tcli.main(["warm", "-w", wd, "--device", "cpu", "--no_bary",
                      "--compile-cache", str(tmp_path / "k"),
                      "--quiet"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_programs"] == 1
    assert set(out) == {"n_programs", "wall_s", "backend_compiles",
                        "compile_cache_hits", "compile_cache_misses"}
    # the program ran (the plan's model: warm was given no -m)
    (run,) = os.listdir(os.path.join(wd, "obs"))
    events = [json.loads(ln) for ln in open(os.path.join(
        wd, "obs", run, "events.jsonl"))]
    progs = [e for e in events if e.get("name") == "warm_program"]
    assert len(progs) == 1 and progs[0]["ok"] is True, progs


@pytest.mark.parametrize("command", ["run", "warm"])
def test_no_cuda_and_no_device_cpu_fails(ws, tmp_path, capsys, monkeypatch,
                                         command):
    """With no CUDA device (as here; made so on a machine with one) the
    default --device cuda fails before the survey touches its ledger."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wd = str(tmp_path / "wd")
    assert tcli.main(["plan", "-d", ws.meta, "-m", ws.gm, "-w", wd]) == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main([command, "-w", wd, "--no_bary"])
    assert not [n for n in os.listdir(wd) if n.startswith("ledger.")]


def test_mesh_is_refused(ws, tmp_path, capsys, monkeypatch):
    """``run --mesh`` is refused without a CUDA device (as here; made so
    on a machine with one) and without ``--device cpu``: its default
    mesh is every visible CUDA device.  With ``--device cpu`` (a
    one-device CPU mesh) it writes the TOAs of the same run without
    ``--mesh``."""
    from torch_tim import lines

    tims = []
    for name, extra in (("plain", []), ("mesh", ["--mesh"])):
        wd = str(tmp_path / name)
        assert tcli.main(["plan", "-d", ws.meta, "-m", ws.gm, "-w", wd]) == 0
        if extra:
            with monkeypatch.context() as m, pytest.raises(
                    RuntimeError, match="CUDA is not available"):
                m.setattr(torch.cuda, "is_available", lambda: False)
                tcli.main(["run", "-w", wd, "--no_bary"] + extra)
        capsys.readouterr()
        assert tcli.main(["run", "-w", wd, "--device", "cpu", "--no_bary",
                          "--quiet"] + extra) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["counts"]["done"] == len(ws.files)
        tims.append(lines(summary["checkpoint"], skip_comments=True))
    assert tims[0] == tims[1]


def test_supervise_two_workers(ws, tmp_path, capsys, monkeypatch):
    """Two worker subprocesses (the port's ppsurvey run, --device cpu)
    share one workdir: every archive done once, one block each."""
    monkeypatch.setenv("PYTHONPATH", ROOT)
    monkeypatch.chdir(ROOT)
    wd = str(tmp_path / "wd")
    assert tcli.main(["plan", "-d", ws.meta, "-m", ws.gm, "-w", wd]) == 0
    capsys.readouterr()
    rc = tcli.main(["supervise", "-w", wd, "--device", "cpu",
                    "--min-workers", "2", "--max-workers", "2",
                    "--interval", "0.2", "--lease", "60",
                    "--worker-arg=--no_bary", "--worker-arg=--backoff",
                    "--worker-arg=0", "--quiet"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0, summary
    assert summary["outstanding"] == 0
    assert summary["stopped_by"] == "complete"
    assert summary["workers"]["spawned"] >= 1
    assert _done(wd) == {f: 1 for f in ws.files}
    assert _blocks(wd) == {f: 1 for f in ws.files}
    logs = os.listdir(os.path.join(wd, "supervisor"))
    assert any(n.startswith("worker.") for n in logs)
