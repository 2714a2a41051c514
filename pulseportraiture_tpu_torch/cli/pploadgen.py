"""pploadgen: open/closed-loop load generator + SLO gate for ppserve.

The PyTorch port of the JAX package's ``pploadgen`` (host-only: it
talks to a daemon over its socket and touches no device).  Drives a
running ``ppserve`` daemon or ``pprouter`` fleet with a seeded,
deterministic request schedule and gates the run on an SLO spec
evaluated from latency-histogram snapshots (obs/metrics.py) — the
capacity-planning and regression tool for requests/s at p50/p99:

    python -m pulseportraiture_tpu_torch.cli.pploadgen -w workdir \\
        -t alice --archives a.fits b.fits --requests 16 \\
        --mode open --rate 2.0 --seed 7 --slo slo.json --out report.json

* **Open loop** (``--mode open``): requests are submitted at seeded
  Poisson arrival times (``--rate`` req/s) regardless of completions —
  the honest model of independent clients, which exposes queueing
  collapse a closed loop hides.
* **Closed loop** (``--mode closed``): ``--concurrency`` workers
  submit back-to-back — the max-throughput probe.
* Every request is a **fresh archive**: each source archive is copied
  into a spool directory under a schedule-unique name, because the
  daemon's per-tenant ledger REPLAYS known-done archives instead of
  refitting them (a loadgen that measured replay latency would be
  measuring a dict lookup).
* The **SLO spec** (JSON file or inline ``{...}``) may bound
  ``p50_s`` / ``p90_s`` / ``p99_s``, ``max_error_rate``,
  ``min_throughput_rps`` and ``min_requests``
  (:func:`~..obs.metrics.evaluate_slo`); a breach exits nonzero —
  that exit code IS the gate.

The report records both the **client-side** latency histogram (what
callers experienced, socket included) and the daemon's own
streaming-metrics snapshot (the ``metrics`` socket verb): the
acceptance contract is that the server's per-phase ``total`` p50/p99
match the client's within histogram bucket resolution.

Every request is issued inside its own **distributed trace**
(obs/tracing.py, unless ``--no_trace``): the client submit span — the
trace root — lands in ``<workdir>/obs_client`` and the trace id rides
the socket as a W3C ``traceparent``, so a p99 bucket's exemplar in
either histogram resolves via ``tools/obs_trace.py`` to the full
client → daemon span tree and its critical path.

The report (schema ``pptpu-loadgen-v1``) is the reference's.
"""

import argparse
import json
import os
import random
import shutil
import sys
import threading
import time


def arrival_schedule(n, rate, seed):
    """Seeded Poisson (exponential inter-arrival) offsets [s] for an
    open-loop run; deterministic for a given (n, rate, seed)."""
    rng = random.Random(int(seed))
    t = 0.0
    out = []
    for _ in range(int(n)):
        t += rng.expovariate(float(rate))
        out.append(t)
    return out


def build_requests(archives, n, tenants, spool_dir, seed):
    """The request list: ``n`` (tenant, spooled-copy-path) pairs.

    Sources round-robin; each copy gets a schedule-unique name
    (``lg<seed>_<i>_<srcbase>``) so every submission is a fresh ledger
    entry, never a replay.
    """
    os.makedirs(spool_dir, exist_ok=True)
    out = []
    for i in range(int(n)):
        src = archives[i % len(archives)]
        dst = os.path.join(spool_dir, "lg%s_%04d_%s"
                           % (seed, i, os.path.basename(src)))
        if not os.path.isfile(dst):
            shutil.copyfile(src, dst)
        out.append((tenants[i % len(tenants)], dst))
    return out


def load_slo(spec):
    """SLO spec from an inline JSON object string or a file path."""
    if not spec:
        return None
    if spec.strip().startswith("{"):
        return json.loads(spec)
    with open(spec, encoding="utf-8") as fh:
        return json.loads(fh.read())


class _Result:
    __slots__ = ("tenant", "archive", "latency_s", "ok", "state",
                 "error", "cached", "trace_id", "priority",
                 "deadline_s", "rerouted", "deadline_miss")

    def __init__(self, tenant, archive):
        self.tenant = tenant
        self.archive = archive
        self.latency_s = None
        self.ok = False
        self.state = None
        self.error = None
        self.cached = False
        self.trace_id = None
        self.priority = 0
        self.deadline_s = None
        self.rerouted = 0
        self.deadline_miss = False


# a "draining" rejection is re-routable, not a failure: the daemon
# (or a fleet member being replaced behind a router) provably did NOT
# accept the work, so the client retries — against a router the retry
# lands on the re-routed bucket owner
_DRAIN_RETRIES = 5
_DRAIN_BACKOFF_S = 0.2


def _submit_one(socket_path, res, timeout):
    """Submit one request inside a freshly-minted trace.

    The client-side ``submit`` span is the trace ROOT: it lands in the
    loadgen's own obs run (``<workdir>/obs_client``) and its id rides
    the socket protocol as a W3C ``traceparent``, so the daemon-side
    request span tree hangs off it — ``tools/obs_trace.py`` over both
    run dirs reconstructs client submit → daemon lifecycle end to end.
    With no obs run active the span no-ops and no carrier is sent (the
    daemon then mints its own trace); ids stamped here still feed the
    client histogram's exemplars either way.

    ``draining`` rejections retry (bounded) instead of erroring;
    retry delay stays inside the measured latency — the honest client
    experience of a fleet mid-respawn.
    """
    from ..obs import tracing
    from ..service import client_request

    payload = {"op": "submit", "tenant": res.tenant,
               "archive": res.archive, "wait": True,
               "timeout_s": timeout}
    if res.priority:
        payload["priority"] = res.priority
    if res.deadline_s is not None:
        payload["deadline_s"] = res.deadline_s
    ctx = tracing.mint()
    res.trace_id = ctx[0]
    t0 = time.perf_counter()
    with tracing.activate(ctx):
        from .. import obs

        with obs.span("submit", tenant=res.tenant,
                      archive=os.path.basename(res.archive)):
            if tracing.current_span_id() is not None:
                tracing.inject(payload)
            while True:
                try:
                    resp = client_request(socket_path, payload,
                                          timeout=timeout + 30.0)
                except (OSError, ValueError) as e:
                    res.error = "%s: %s" % (type(e).__name__, e)
                    return res
                if not resp.get("ok") \
                        and resp.get("error") == "draining" \
                        and res.rerouted < _DRAIN_RETRIES:
                    res.rerouted += 1
                    time.sleep(_DRAIN_BACKOFF_S * res.rerouted)
                    continue
                break
    res.latency_s = time.perf_counter() - t0
    res.state = resp.get("state")
    res.cached = bool(resp.get("cached"))
    res.ok = bool(resp.get("ok")) and res.state == "done"
    if res.deadline_s is not None and res.latency_s is not None:
        res.deadline_miss = res.latency_s > res.deadline_s
    if not res.ok:
        res.error = resp.get("error") or resp.get("reason") \
            or ("state=%s" % res.state)
    from ..obs import metrics

    if res.latency_s is not None:
        # per-priority client series: deadline classes diff separately
        # in the obs_client run (pps_phase_seconds{...,priority=...})
        metrics.observe(metrics.PHASE_HISTOGRAM, res.latency_s,
                        phase="client_total", tenant=res.tenant,
                        priority=str(res.priority))
    return res


def run_load(socket_path, requests, mode="closed", rate=1.0,
             concurrency=4, seed=0, timeout=600.0, quiet=True,
             priorities=None, deadlines=None):
    """Execute the load; returns (results, wall_s).

    Open loop: one thread per request fired at its seeded arrival
    offset.  Closed loop: ``concurrency`` workers drain the request
    list back-to-back.  Both are deterministic in *schedule*; actual
    latencies are, of course, the measurement.

    ``priorities`` / ``deadlines`` (lists; a None deadline = no
    deadline) are assigned round-robin across the schedule, so a
    mixed-deadline-class run is deterministic too.
    """
    results = [_Result(t, a) for t, a in requests]
    for i, res in enumerate(results):
        if priorities:
            res.priority = int(priorities[i % len(priorities)])
        if deadlines:
            d = deadlines[i % len(deadlines)]
            res.deadline_s = None if d is None else float(d)
    t_start = time.perf_counter()
    if mode == "open":
        sched = arrival_schedule(len(results), rate, seed)
        threads = []
        for i, (res, due) in enumerate(zip(results, sched)):
            wait = t_start + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            th = threading.Thread(target=_submit_one,
                                  args=(socket_path, res, timeout),
                                  daemon=True,
                                  name="pploadgen-open-%d" % i)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout + 60.0)
    else:
        it = iter(results)
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    res = next(it, None)
                if res is None:
                    return
                _submit_one(socket_path, res, timeout)
                if not quiet:
                    print("pploadgen: %s %s %.3fs %s"
                          % (res.tenant,
                             os.path.basename(res.archive),
                             res.latency_s or -1.0,
                             res.state), file=sys.stderr)

        threads = [threading.Thread(target=worker, daemon=True,
                                    name="pploadgen-closed-%d" % i)
                   for i in range(max(1, int(concurrency)))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout + 60.0)
    return results, time.perf_counter() - t_start


def summarize_load(results, wall_s, server_snapshot=None, slo=None):
    """The loadgen report dict: client histogram + percentiles,
    error/throughput numbers, the server snapshot, the SLO verdict."""
    from ..obs import metrics

    hist = metrics.Histogram()
    n_ok = n_err = n_cached = 0
    n_rerouted = n_deadline_miss = 0
    by_prio = {}
    for res in results:
        if res.latency_s is not None:
            # the client histogram carries exemplars too: a slow
            # client-side bucket resolves to its trace without asking
            # the daemon
            hist.observe(res.latency_s, exemplar=res.trace_id)
            ph = by_prio.setdefault(res.priority, metrics.Histogram())
            ph.observe(res.latency_s)
        if res.ok:
            n_ok += 1
        else:
            n_err += 1
        if res.cached:
            n_cached += 1
        n_rerouted += res.rerouted
        if res.deadline_miss:
            n_deadline_miss += 1
    snap = hist.to_snapshot()
    verdict = metrics.evaluate_slo(slo or {}, snap, n_ok, n_err,
                                   wall_s)
    report = {
        "schema": "pptpu-loadgen-v1",
        "n_requests": len(results),
        "n_ok": n_ok,
        "n_err": n_err,
        "n_cached": n_cached,
        "n_rerouted": n_rerouted,
        "n_deadline_miss": n_deadline_miss,
        "wall_s": round(wall_s, 6),
        "client": {
            "histogram": snap,
            "p50_s": metrics.quantile(snap, 0.5),
            "p90_s": metrics.quantile(snap, 0.9),
            "p99_s": metrics.quantile(snap, 0.99),
            "p99_exemplar": metrics.exemplar_for_quantile(snap, 0.99),
            "max_s": snap.get("max"),
            "throughput_rps": round(n_ok / wall_s, 6)
            if wall_s > 0 else None,
            "priorities": {
                str(p): {"n": h.count,
                         "p50_s": h.quantile(0.5),
                         "p99_s": h.quantile(0.99),
                         "max_s": h.max}
                for p, h in sorted(by_prio.items())},
        },
        "errors": [{"tenant": r.tenant,
                    "archive": os.path.basename(r.archive),
                    "state": r.state, "error": r.error,
                    "trace_id": r.trace_id}
                   for r in results if not r.ok][:20],
        "slo": verdict if slo else None,
        "measured": verdict["measured"],
    }
    if server_snapshot is not None:
        phases = {}
        hists = server_snapshot.get("histograms") or {}
        from ..obs.metrics import PHASE_HISTOGRAM, parse_series

        for key, h in hists.items():
            name, labels = parse_series(key)
            if name != PHASE_HISTOGRAM:
                continue
            phase = labels.get("phase", "?")
            cur = phases.get(phase)
            if cur is None:
                phases[phase] = metrics.Histogram.from_snapshot(h)
            else:
                cur.merge(metrics.Histogram.from_snapshot(h))
        report["server"] = {
            "snapshot": server_snapshot,
            "phases": {p: {"n": h.count,
                           "p50_s": h.quantile(0.5),
                           "p90_s": h.quantile(0.9),
                           "p99_s": h.quantile(0.99),
                           "max_s": h.max}
                       for p, h in sorted(phases.items())}}
    return report


def build_parser():
    p = argparse.ArgumentParser(
        prog="pploadgen",
        description="Load generator + SLO gate for the ppserve "
                    "daemon (PyTorch port).")
    p.add_argument("-w", "--workdir", required=True,
                   help="The daemon's workdir (socket + spool default "
                        "under it).")
    p.add_argument("--socket", default=None,
                   help="Unix socket path (default: "
                        "<workdir>/ppserve.sock, or "
                        "<workdir>/pprouter.sock with --router).")
    p.add_argument("--router", action="store_true",
                   help="Target a pprouter fleet socket instead of a "
                        "single daemon (same protocol; 'draining' "
                        "rejections from a respawning fleet member "
                        "retry instead of erroring).")
    p.add_argument("-t", "--tenants", default="loadgen",
                   help="Comma-separated tenant names, round-robined "
                        "across requests.")
    p.add_argument("--archives", nargs="+", required=True,
                   help="Source archives, round-robined; each request "
                        "fits a fresh spooled copy (never a replay).")
    p.add_argument("-n", "--requests", type=int, default=8,
                   help="Total requests to issue.")
    p.add_argument("--mode", choices=("open", "closed"),
                   default="closed",
                   help="open = seeded Poisson arrivals at --rate; "
                        "closed = --concurrency back-to-back workers.")
    p.add_argument("--rate", type=float, default=1.0,
                   help="Open-loop arrival rate [req/s].")
    p.add_argument("--concurrency", type=int, default=4,
                   help="Closed-loop worker count.")
    p.add_argument("--seed", type=int, default=0,
                   help="Schedule + spool-name seed (deterministic).")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="Per-request wait timeout [s].")
    p.add_argument("--priorities", default=None, metavar="P,P,...",
                   help="Comma-separated integer priorities assigned "
                        "round-robin across requests (higher "
                        "dispatches first).")
    p.add_argument("--deadlines", default=None, metavar="S,S,...",
                   help="Comma-separated per-request deadlines [s] "
                        "assigned round-robin ('none' = no deadline "
                        "for that slot); drives the daemon's "
                        "deadline-aware parking window.")
    p.add_argument("--spool", default=None,
                   help="Spool dir for per-request archive copies "
                        "(default: <workdir>/loadgen_spool).")
    p.add_argument("--slo", default=None,
                   help="SLO spec: a JSON file path or an inline "
                        "{...} object (p50_s/p90_s/p99_s/"
                        "max_error_rate/min_throughput_rps/"
                        "min_requests); breach = nonzero exit.")
    p.add_argument("--out", default=None,
                   help="Write the full JSON report here.")
    p.add_argument("--no_trace", action="store_true",
                   help="Skip distributed tracing: no client obs run "
                        "under <workdir>/obs_client, no traceparent "
                        "on the wire (the daemon then mints its own "
                        "trace ids).")
    p.add_argument("--quiet", action="store_true")
    return p


def parse_classes(priorities, deadlines):
    """(priorities list, deadlines list) from the CLI comma strings;
    'none'/'-' deadline slots mean no deadline."""
    prios = None
    if priorities:
        prios = [int(x) for x in priorities.split(",") if x.strip()]
    dls = None
    if deadlines:
        dls = []
        for x in deadlines.split(","):
            x = x.strip()
            if not x:
                continue
            dls.append(None if x.lower() in ("none", "-")
                       else float(x))
    return prios, dls


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ..service import DEFAULT_ROUTER_SOCKET_NAME, \
        DEFAULT_SOCKET_NAME, client_request

    sock = args.socket or os.path.join(
        args.workdir,
        DEFAULT_ROUTER_SOCKET_NAME if args.router
        else DEFAULT_SOCKET_NAME)
    try:
        slo = load_slo(args.slo)
    except (OSError, json.JSONDecodeError) as e:
        print("pploadgen: bad --slo spec: %s" % e, file=sys.stderr)
        return 2
    try:
        ping = client_request(sock, {"op": "ping"}, timeout=10.0)
    except (OSError, ValueError) as e:
        print("pploadgen: no daemon at %s (%s)" % (sock, e),
              file=sys.stderr)
        return 2
    if not ping.get("ok"):
        print("pploadgen: daemon ping failed: %s" % ping,
              file=sys.stderr)
        return 2

    tenants = [t for t in args.tenants.split(",") if t]
    spool = args.spool or os.path.join(args.workdir, "loadgen_spool")
    requests = build_requests(args.archives, args.requests, tenants,
                              spool, args.seed)
    # the client side of the trace: each request's submit span (the
    # trace root) lands in this run so tools/obs_trace.py can join it
    # to the daemon's span tree across run dirs
    import contextlib

    from .. import obs

    client_run = contextlib.nullcontext() if args.no_trace else \
        obs.run("pploadgen",
                base_dir=os.path.join(args.workdir, "obs_client"))
    try:
        prios, dls = parse_classes(args.priorities, args.deadlines)
    except ValueError as e:
        print("pploadgen: bad --priorities/--deadlines: %s" % e,
              file=sys.stderr)
        return 2
    with client_run:
        results, wall_s = run_load(
            sock, requests, mode=args.mode, rate=args.rate,
            concurrency=args.concurrency, seed=args.seed,
            timeout=args.timeout, quiet=args.quiet,
            priorities=prios, deadlines=dls)
    try:
        server_snap = client_request(
            sock, {"op": "metrics"}, timeout=30.0).get("snapshot")
    except (OSError, ValueError):
        server_snap = None
    report = summarize_load(results, wall_s,
                            server_snapshot=server_snap, slo=slo)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1)
            fh.write("\n")
    line = {k: report[k] for k in ("n_requests", "n_ok", "n_err",
                                   "wall_s")}
    line.update({k: report["client"][k]
                 for k in ("p50_s", "p99_s", "throughput_rps")})
    if report["n_rerouted"]:
        line["n_rerouted"] = report["n_rerouted"]
    if dls:
        line["n_deadline_miss"] = report["n_deadline_miss"]
    if slo:
        line["slo_ok"] = report["slo"]["ok"]
    print(json.dumps(line))
    if slo and not report["slo"]["ok"]:
        for b in report["slo"]["breaches"]:
            print("pploadgen: SLO breach: %s" % b["detail"],
                  file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
