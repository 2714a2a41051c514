"""The port's live telemetry planes against the JAX package's, on the CPU.

pulseportraiture_tpu_torch.obs copies the JAX package's metrics, health,
usage, flight and merge modules.  Each test here drives both packages'
modules with the same inputs (values drawn from a seeded numpy
generator) and requires the same results: histogram merges and
quantiles, snapshot merges, the Prometheus text, SLO verdicts, alert
lifecycles over the same synthetic registry snapshots, usage records,
rollups and quota decisions, and merged shard runs.  Times, pids and
paths are taken out before comparing.
"""

import json
import os

import numpy as np
import pytest

from pulseportraiture_tpu import obs as jobs
from pulseportraiture_tpu.cli import ppusage as jppusage
from pulseportraiture_tpu.obs import core as jcore
from pulseportraiture_tpu.obs import merge as jmerge
from pulseportraiture_tpu_torch import obs as tobs
from pulseportraiture_tpu_torch.cli import ppusage as tppusage
from pulseportraiture_tpu_torch.obs import core as tcore
from pulseportraiture_tpu_torch.obs import merge as tmerge

PACKAGES = {"jax": jobs, "torch": tobs}
MERGE = {"jax": jmerge, "torch": tmerge}


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


def _both(fn):
    """fn(obs package, key) for both packages -> (jax result, port
    result)."""
    return fn(PACKAGES["jax"], "jax"), fn(PACKAGES["torch"], "torch")


# -- metrics -----------------------------------------------------------


def _observations(seed, n):
    rng = np.random.default_rng(seed)
    return rng.lognormal(-2.0, 1.5, n)


@pytest.mark.parametrize("per_octave", [4, 8])
def test_histogram_merge_and_quantiles_match(per_octave):
    vals = _observations(3, 3000)

    def run(obs, _):
        M = obs.metrics
        whole = M.Histogram(per_octave=per_octave)
        shards = [M.Histogram(per_octave=per_octave) for _ in range(3)]
        for i, v in enumerate(vals):
            whole.observe(float(v))
            shards[i % 3].observe(float(v))
        merged = M.Histogram.from_snapshot(shards[2].to_snapshot())
        for h in shards[:2]:
            merged.merge(M.Histogram.from_snapshot(h.to_snapshot()))
        return (whole.to_snapshot(), merged.to_snapshot(),
                [merged.quantile(q) for q in (0.5, 0.9, 0.99, 1.0)])

    ref, port = _both(run)
    assert port == ref


def _registry_snapshot(M, seed):
    reg = M.MetricsRegistry()
    for i, v in enumerate(_observations(seed, 200)):
        tenant = "ab"[i % 2]
        reg.observe("pps_phase_seconds", float(v), phase="fit",
                    tenant=tenant)
        reg.inc("pps_requests_total", tenant=tenant,
                outcome="done" if i % 7 else "error")
    reg.set_gauge("pps_queue_depth", seed, tenant="a")
    snap = reg.snapshot()
    snap.pop("t", None)
    return snap


def test_snapshot_merge_and_prometheus_text_match():
    def run(obs, _):
        M = obs.metrics
        snaps = {p: _registry_snapshot(M, 10 + p) for p in range(3)}
        merged = M.merge_snapshots(snaps)
        merged.pop("t", None)
        return merged, M.render_prometheus(snaps[0])

    ref, port = _both(run)
    assert port == ref
    assert "# TYPE pps_phase_seconds histogram" in port[1]


@pytest.mark.parametrize("slo", [
    {"p50_s": 1.0, "p99_s": 1.0, "max_error_rate": 0.2,
     "min_throughput_rps": 0.01, "min_requests": 4},
    {"p99_s": 0.05},
    {"max_error_rate": 0.01},
    {"min_requests": 10 ** 6}], ids=["pass", "p99", "errors", "count"])
def test_slo_verdicts_match(slo):
    vals = _observations(5, 400)

    def run(obs, _):
        h = obs.metrics.Histogram()
        for v in vals:
            h.observe(float(v))
        return obs.metrics.evaluate_slo(slo, h.to_snapshot(), 380, 20,
                                        30.0)

    ref, port = _both(run)
    assert port == ref


# -- health --------------------------------------------------------------


def _events(run_dir, obs):
    out = []
    for path in obs.list_event_files(run_dir):
        with open(path, encoding="utf-8") as fh:
            out.extend(json.loads(ln) for ln in fh if ln.strip())
    return out


_RULES = [
    {"name": "qspike", "kind": "rate", "severity": "critical",
     "signal": ("pps_quarantined_total",), "op": ">=", "threshold": 2,
     "window_s": 30.0, "for_s": 5.0, "summary": "quarantine spike"},
    {"name": "deep_queue", "kind": "threshold", "severity": "warning",
     "signal": "pps_queue_depth", "op": ">", "threshold": 4,
     "window_s": 30.0, "for_s": 0.0, "summary": "queue too deep"},
    {"name": "errors", "kind": "ratio", "severity": "warning",
     "num": ("pps_requests_total{outcome=\"error\"}",),
     "den": ("pps_requests_total",), "op": ">", "threshold": 0.25,
     "min_den": 4, "window_s": 30.0, "for_s": 0.0,
     "summary": "error ratio"},
]

# (time, counter increments, gauge value) fed before each evaluation
_TIMELINE = [(1000.0, {}, 0), (1001.0, {"q": 3, "done": 4}, 2),
             (1004.0, {"err": 3}, 6), (1007.0, {"done": 1}, 7),
             (1020.0, {"done": 9}, 3), (1050.0, {}, 1),
             (1051.0, {"q": 5, "err": 4}, 9), (1090.0, {}, 0)]


def _health_lifecycle(obs, tmp_path):
    health, flight = obs.health, obs.flight
    with obs.run("life", base_dir=str(tmp_path)) as rec:
        run_dir = rec.dir
        reg = rec.metrics_registry()
        hs = health.HealthState(rec, rules=[dict(r) for r in _RULES])
        rec._health = hs
        trail = []
        for now, incs, depth in _TIMELINE:
            if incs.get("q"):
                reg.inc("pps_quarantined_total", incs["q"], tenant="a")
            for outcome in ("done", "err"):
                if incs.get(outcome):
                    reg.inc("pps_requests_total", incs[outcome],
                            outcome="error" if outcome == "err"
                            else "done")
            reg.set_gauge("pps_queue_depth", depth)
            firing = hs.evaluate(now=now)
            trail.append((now, sorted(a["rule"] for a in firing),
                          {k: v["state"] for k, v in
                           sorted(hs.states().items())}))
        gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
                  if k.startswith("pps_alerts")}
        counters = {k: v for k, v in reg.snapshot()["counters"].items()
                    if k.startswith("pps_alerts")}
        bundles = [(b["trigger"], [a["rule"] for a in
                                   b.get("alerts_firing") or []])
                   for b in flight.load_postmortems(run_dir)]
    names = [(e.get("name"), e.get("rule")) for e in _events(run_dir, obs)
             if e.get("kind") == "event"]
    with open(os.path.join(run_dir, "manifest.json")) as fh:
        man = json.load(fh)
    keep = ("alerts_fired", "alerts_resolved", "postmortems_written")
    return (trail, gauges, counters, bundles, names,
            {k: v for k, v in man["counters"].items() if k in keep})


def test_alert_lifecycles_match(tmp_path):
    ref, port = _both(lambda obs, key: _health_lifecycle(
        obs, tmp_path / key))
    assert port == ref
    trail = port[0]
    assert any(t[1] for t in trail), "no rule fired: the test is vacuous"
    assert port[5].get("alerts_resolved"), port[5]


def test_health_rule_overlay_matches(monkeypatch):
    monkeypatch.setenv("PPTPU_HEALTH_RULES", json.dumps(
        [{"name": "extra", "kind": "threshold", "signal": "pps_x",
          "op": ">", "threshold": 1}, {"name": "broken"}]))
    ref, port = _both(lambda obs, _: obs.health.health_rules())
    assert port == ref


# -- usage and quotas ----------------------------------------------------


def _meter(obs, tmp_path):
    usage = obs.usage
    rng = np.random.default_rng(8)
    quotas = {"alice": {"requests": 3, "device_seconds": 0.2},
              "bob": {"wall_seconds": 0.9}}
    decisions = []
    with obs.run("usage", base_dir=str(tmp_path)) as rec:
        usage.configure_quotas(quotas)
        for i in range(12):
            tenant = ["alice", "bob", None][i % 3]
            decisions.append(usage.check(tenant))
            usage.meter("request" if i % 3 else "archive", tenant=tenant,
                        bucket="8x64", workload="toas",
                        wall_s=float(rng.uniform(0.01, 0.5)),
                        device_s=float(rng.uniform(0.001, 0.1)),
                        archives=1, bytes_decoded=1024 * (i + 1))
        decisions.append(usage.check("alice"))
        decisions.append(usage.check("bob"))
        totals = usage.totals()
        burn = usage.quota_burn_fraction()
        run_dir = rec.dir
    records = usage.read_usage(run_dir)
    for r in records:
        for k in ("t", "pid", "run_id", "trace_id", "span_id"):
            r.pop(k, None)
    return decisions, totals, burn, records, usage.rollup(records)


def test_usage_records_and_quota_decisions_match(tmp_path):
    ref, port = _both(lambda obs, key: _meter(obs, tmp_path / key))
    assert port == ref
    decisions = port[0]
    assert any(d is None for d in decisions)
    assert any(d is not None for d in decisions), decisions


def test_ppusage_rollups_match(tmp_path, capsys):
    """ppusage over the ledgers both packages wrote: the same JSON and
    the same table from either package's CLI."""
    for key in ("jax", "torch"):
        _meter(PACKAGES[key], tmp_path / key)
    out = {}
    for key, cli in (("jax", jppusage), ("torch", tppusage)):
        for flags in (["--json"], ["--top", "2"]):
            assert cli.main(flags + [str(tmp_path)]) == 0
            out[key, flags[0]] = capsys.readouterr().out
    assert out["torch", "--json"] == out["jax", "--json"]
    assert out["torch", "--top"] == out["jax", "--top"]
    rolled = json.loads(out["torch", "--json"])
    assert rolled["records"] == 24


def test_parse_quotas_matches():
    specs = [{"acme": 30}, '{"a": {"requests": 5, "wall_seconds": 2.5}}',
             None, ""]
    ref, port = _both(lambda obs, _: [obs.usage.parse_quotas(s)
                                      for s in specs])
    assert port == ref
    for bad in ({"a": {"device_secnds": 1}}, "{nope", {"a": [1, 2]}):
        with pytest.raises(ValueError):
            tobs.usage.parse_quotas(bad)


# -- shard merge ---------------------------------------------------------


def _shard_runs(obs, merge, tmp_path):
    shards = tmp_path / "shards"
    shards.mkdir(parents=True)
    for proc in range(2):
        with obs.run("shard", base_dir=str(tmp_path / ("p%d" % proc))) \
                as rec:
            with obs.span("solve", archive="a%d" % proc):
                obs.event("archive", datafile="a%d" % proc, nsub=4)
            obs.counter("fit_batches", proc + 1)
            rec.metrics_registry().observe("pps_phase_seconds",
                                           0.1 * (proc + 1), phase="fit")
            obs.usage.meter("archive", tenant="t%d" % proc, wall_s=0.5,
                            archives=1)
            run_dir = rec.dir
        merge.write_shard(run_dir, str(shards), proc)
    out = merge.merge_obs_shards(str(shards), str(tmp_path / "merged"))
    evs = []
    for e in _events(out, obs):
        evs.append({k: v for k, v in e.items()
                    if k not in ("t", "dur_s", "peak_bytes")})
    with open(os.path.join(out, "manifest.json")) as fh:
        man = json.load(fh)
    snap = obs.metrics.last_snapshot(out)
    usage = obs.usage.rollup(obs.usage.read_usage(out))
    return (evs, man["counters"], man["n_processes"],
            snap["histograms"], usage)


def test_merge_obs_shards_matches(tmp_path):
    ref, port = _both(lambda obs, key: _shard_runs(obs, MERGE[key],
                                                   tmp_path / key))
    assert port == ref
    assert port[2] == 2
    paths = [e.get("path") for e in port[0] if e.get("kind") == "span"]
    assert paths == ["p0/solve", "p1/solve"]
