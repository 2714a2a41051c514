"""ppsurvey command-line tool: survey-scale TOA measurement (PyTorch port).

Front-end for the port's survey runner (docs/RUNNER.md): plan a
metafile into shape buckets, run/resume the bucketed fits with fault
isolation, and report state + the merged observability run.

    python -m pulseportraiture_tpu_torch.cli.ppsurvey plan \\
        -d archives.meta -m model.gmodel -w workdir
    python -m pulseportraiture_tpu_torch.cli.ppsurvey warm   -w workdir \\
        --compile-cache /shared/ppkernels
    python -m pulseportraiture_tpu_torch.cli.ppsurvey run    -w workdir
    python -m pulseportraiture_tpu_torch.cli.ppsurvey resume -w workdir
    python -m pulseportraiture_tpu_torch.cli.ppsurvey supervise -w workdir \\
        --max-workers 4
    python -m pulseportraiture_tpu_torch.cli.ppsurvey status -w workdir
    python -m pulseportraiture_tpu_torch.cli.ppsurvey report -w workdir

``run`` and ``resume`` are the same operation (the ledger makes every
run a resume); both names exist so scripts read honestly.  The fits run
on the CUDA device unless ``--device cpu`` is given; with no CUDA device
and no ``--device cpu`` ``run``, ``warm`` and ``supervise``'s workers
fail.  On a multi-process job (``torchrun``) every process runs the same
command; the plan is partitioned deterministically and process 0 merges
the obs shards.  ``--compile-cache DIR`` names the directory the hand
kernels are built into and loaded from.  ``--mesh`` shards each bucket
batch over a device mesh of every visible CUDA device (one CPU device
with ``--device cpu``; parallel/mesh.py); under ``torchrun`` with several
processes on a host, give each process its own cards by
``CUDA_VISIBLE_DEVICES``.  Arguments and outputs
are the JAX package's ``ppsurvey``'s, so a workdir planned by either
package runs in the other.
"""

import argparse
import json
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppsurvey",
        description="Shape-bucketed survey runner for wideband TOA "
                    "measurement (docs/RUNNER.md).")
    sub = p.add_subparsers(dest="command")

    pl = sub.add_parser("plan", help="Scan archives into shape buckets.")
    pl.add_argument("-d", "--datafiles", required=True, metavar="meta",
                    help="Metafile of archive paths (or one archive).")
    pl.add_argument("-m", "--modelfile", default=None, metavar="model",
                    help="Model file the survey fits with (required "
                         "at run time for the toas workload; doubles "
                         "as the align initial-guess template).")
    pl.add_argument("-w", "--workdir", required=True,
                    help="Survey working directory (created).")

    for name, help_text in (
            ("run", "Execute the planned survey (resumable)."),
            ("resume", "Alias of run: continue a killed survey.")):
        r = sub.add_parser(name, help=help_text)
        r.add_argument("-w", "--workdir", required=True)
        r.add_argument("--workload", default=None, metavar="NAME",
                       help="What a claimed archive means "
                            "(runner/workloads.py): toas (default), "
                            "zap, align, modelfit, or any registered "
                            "name.  One workdir can chain workloads "
                            "(zap, then align, then toas) — each "
                            "keeps its own ledger records and "
                            "checkpoints.")
        r.add_argument("--workload_opt", action="append", default=[],
                       metavar="KEY=VALUE", dest="workload_opts",
                       help="Workload constructor option (repeatable; "
                            "values parse as JSON, else strings): "
                            "e.g. --workload zap --workload_opt "
                            "nstd=5, --workload align --workload_opt "
                            "niter=2.")
        r.add_argument("-m", "--modelfile", default=None,
                       metavar="model",
                       help="Override the plan's model file (also the "
                            "align workload's initial-guess "
                            "template).")
        r.add_argument("--process", type=int, default=None,
                       help="Simulated process index (default: ask "
                            "torch.distributed, initialized from "
                            "torchrun's environment).")
        r.add_argument("--processes", type=int, default=None,
                       help="Simulated process count.")
        r.add_argument("--max_attempts", type=int, default=3,
                       help="Retries before an archive is quarantined.")
        r.add_argument("--backoff", type=float, default=1.0,
                       help="Base retry backoff [s] (doubles per "
                            "attempt).")
        r.add_argument("--max_archives", type=int, default=None,
                       help="Stop after this many fit attempts "
                            "(incremental runs).")
        r.add_argument("--watchdog", type=float, default=None,
                       metavar="S", dest="watchdog_s",
                       help="Per-archive dispatch watchdog [s]: a "
                            "hung dispatch is requeued (and the "
                            "event recorded) instead of wedging the "
                            "run.  Pick it above the bucket's worst "
                            "first-compile time.")
        r.add_argument("--barrier_timeout", type=float, default=600.0,
                       metavar="S", dest="barrier_timeout_s",
                       help="Pre-merge multihost barrier timeout [s]; "
                            "a straggler is recorded, its leases are "
                            "revoked back into the pool, and the "
                            "merge proceeds over the shards that "
                            "exist.")
        r.add_argument("--lease", type=float, default=600.0,
                       metavar="S", dest="lease_s",
                       help="Work-ownership lease [s] (renewed every "
                            "S/3 by the heartbeat): a dead process's "
                            "claims expire back into the pool after "
                            "S, so any resume — with ANY process "
                            "count — or a surviving sibling takes "
                            "them over (docs/RUNNER.md Elasticity).")
        r.add_argument("--narrowband", action="store_true",
                       help="Measure per-channel (narrowband) TOAs "
                            "(get_narrowband_TOAs) through the same "
                            "bucket/ledger/lease/checkpoint "
                            "machinery.")
        r.add_argument("--nonfinite_max_frac", type=float, default=0.5,
                       metavar="F",
                       help="Quarantine an archive when more than "
                            "this fraction of its live channels is "
                            "NaN/Inf (below it, bad channels are "
                            "zero-weighted and counted as "
                            "n_nonfinite_zapped).")
        r.add_argument("--prefetch", type=int, default=2, metavar="N",
                       help="Claim-ahead depth of the host prefetch "
                            "stage: decode + pad the next N archives "
                            "on a background thread while the current "
                            "one fits (docs/RUNNER.md Host pipeline). "
                            "0 = serial load, bit-identical results "
                            "either way.")
        r.add_argument("--warm", nargs="?", const="always",
                       choices=["always", "auto"], default=None,
                       help="Warm the plan's program set at worker "
                            "start (runner/warm.py), overlapped with "
                            "the host prefetch so time-to-first-fit "
                            "collapses.  'auto' warms only when a "
                            "persistent compile cache is active or "
                            "prefetch overlap hides the wall time "
                            "(docs/RUNNER.md Warm start).")
        r.add_argument("--compile-cache", default=None, metavar="DIR",
                       dest="compile_cache",
                       help="Kernel build directory (default: "
                            "$PPTPU_COMPILE_CACHE_DIR): the hand "
                            "kernels are built into and loaded from "
                            "it, so nvcc runs once per machine.  A "
                            "corrupt/unwritable dir degrades to the "
                            "package's own build directory.")
        r.add_argument("--mesh", action="store_true", dest="use_mesh",
                       help="Shard each bucket batch over the local "
                            "device mesh (every visible card: with "
                            "several processes per host, give each its "
                            "own by CUDA_VISIBLE_DEVICES).")
        r.add_argument("--no_merge", action="store_false", dest="merge",
                       help="Skip the process-0 obs-shard merge.")
        r.add_argument("--trace-bucket", action="store_true",
                       dest="trace_bucket",
                       help="Capture one torch.profiler trace per shape "
                            "bucket (into $PPTPU_TRACE_DIR or "
                            "<workdir>/traces) and ingest it into the "
                            "obs run's devtime events + device-"
                            "utilization gauges (docs/RUNNER.md).")
        r.add_argument("--tenant", default=None, metavar="NAME",
                       help="Tenant the run's usage ledger bills "
                            "archives to (obs/usage.py; default: "
                            "'_local').")
        r.add_argument("--tscrunch", "-T", action="store_true")
        r.add_argument("--fit_scat", action="store_true")
        r.add_argument("--no_bary", dest="bary", action="store_false")
        r.add_argument("--device", choices=("cuda", "cpu"),
                       default="cuda",
                       help="Where the fits run (default: the CUDA "
                            "device; 'cpu' must be asked for).")
        r.add_argument("--quiet", action="store_true")

    wm = sub.add_parser(
        "warm", help="Build the kernels and run one synthetic archive "
                     "per planned shape class, then exit (no survey "
                     "run).")
    wm.add_argument("-w", "--workdir", required=True,
                    help="Survey working directory (its plan.json is "
                         "the default --plan).")
    wm.add_argument("-m", "--modelfile", default=None, metavar="model",
                    help="Override the plan's model file (required "
                         "for the toas workload if the plan carries "
                         "none).")
    wm.add_argument("--plan", default=None, metavar="plan.json",
                    help="Plan to warm (default: <workdir>/plan.json).")
    wm.add_argument("--workload", default=None, metavar="NAME",
                    help="Warm this workload's program set (toas "
                         "(default), zap, align, modelfit).")
    wm.add_argument("--compile-cache", default=None, metavar="DIR",
                    dest="compile_cache",
                    help="Kernel build directory (default: "
                         "$PPTPU_COMPILE_CACHE_DIR).  Idempotent and "
                         "safe to run concurrently from N processes "
                         "against one dir.")
    wm.add_argument("--coalesce", type=int, default=0, metavar="K",
                    help="Also warm the K-way coalesced batch "
                         "programs (the service micro-batcher's "
                         "dispatch shapes; toas only).")
    wm.add_argument("--no-aot", action="store_false", dest="aot",
                    help="Skip the up-front kernel build (each kernel "
                         "is then built at its first launch).")
    wm.add_argument("--narrowband", action="store_true")
    wm.add_argument("--tscrunch", "-T", action="store_true")
    wm.add_argument("--fit_scat", action="store_true")
    wm.add_argument("--no_bary", dest="bary", action="store_false")
    wm.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Where the warm fits run (default: the CUDA "
                         "device).")
    wm.add_argument("--quiet", action="store_true")

    sv = sub.add_parser(
        "supervise",
        help="Own the survey end-to-end: spawn worker subprocesses, "
             "autoscale on backlog, replace crashed/wedged workers, "
             "drain at completion (docs/RUNNER.md Autoscaling).")
    sv.add_argument("-w", "--workdir", required=True)
    sv.add_argument("-m", "--modelfile", default=None, metavar="model",
                    help="Override the plan's model file (forwarded "
                         "to every worker).")
    sv.add_argument("--min-workers", type=int, default=1,
                    dest="min_workers",
                    help="Worker-count floor while work remains.")
    sv.add_argument("--max-workers", type=int, default=4,
                    dest="max_workers",
                    help="Worker-count ceiling; also the workers' "
                         "--processes partition width, so every slot "
                         "keeps a stable ledger/checkpoint identity "
                         "across replacements.")
    sv.add_argument("--backlog-per-worker", type=float, default=2.0,
                    dest="backlog_per_worker", metavar="N",
                    help="Scale up while ready work per live worker "
                         "exceeds N (and memory headroom allows).")
    sv.add_argument("--interval", type=float, default=1.0,
                    dest="interval_s", metavar="S",
                    help="Reconcile-loop tick [s].")
    sv.add_argument("--lease", type=float, default=600.0,
                    dest="lease_s", metavar="S",
                    help="Worker work-ownership lease [s] (forwarded); "
                         "a wedged worker is replaced once its leases "
                         "expire.")
    sv.add_argument("--mem-budget-bytes", type=int, default=0,
                    dest="mem_budget_bytes", metavar="B",
                    help="Host admission budget: never scale past "
                         "B // est-worker-bytes live workers "
                         "(0 = unconstrained).")
    sv.add_argument("--est-worker-bytes", type=int, default=None,
                    dest="est_worker_bytes", metavar="B",
                    help="Per-worker working-set estimate (default: "
                         "the plan's largest bucket est_bytes).")
    sv.add_argument("--workload", default=None, metavar="NAME",
                    help="Workload the workers run (default toas).")
    sv.add_argument("--warm", nargs="?", const="always",
                    choices=["always", "auto"], default=None,
                    help="Forwarded to every worker (ppsurvey run "
                         "--warm).")
    sv.add_argument("--compile-cache", default=None, metavar="DIR",
                    dest="compile_cache",
                    help="Forwarded to every worker (share one kernel "
                         "build directory so replacements load the "
                         "built kernels instead of running nvcc).")
    sv.add_argument("--flap-count", type=int, default=3,
                    dest="flap_count", metavar="K",
                    help="Park a slot that dies K times inside the "
                         "flap window instead of respawning forever.")
    sv.add_argument("--flap-window", type=float, default=60.0,
                    dest="flap_window_s", metavar="W",
                    help="Flap-detection window [s].")
    sv.add_argument("--respawn-backoff", type=float, default=1.0,
                    dest="respawn_backoff_s", metavar="S",
                    help="Base crash-loop backoff [s] (doubles per "
                         "consecutive fast death, jittered).")
    sv.add_argument("--drain-grace", type=float, default=60.0,
                    dest="drain_grace_s", metavar="S",
                    help="Wait this long for draining workers at "
                         "shutdown before leaving them standalone.")
    sv.add_argument("--max-ticks", type=int, default=None,
                    dest="max_ticks",
                    help="Stop supervising after N reconcile ticks "
                         "(smoke/test bound; workers drain).")
    sv.add_argument("--worker-arg", action="append", default=[],
                    dest="worker_args", metavar="ARG",
                    help="Extra argv appended to every worker's "
                         "'ppsurvey run' (repeatable), e.g. "
                         "--worker-arg=--no_bary.")
    sv.add_argument("--worker-env", action="append", default=[],
                    dest="worker_env", metavar="SLOT:KEY=VALUE",
                    help="Extra env for the FIRST spawn of one slot "
                         "(repeatable; the chaos hook — respawns "
                         "scrub PPTPU_FAULTS).")
    sv.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Forwarded to every worker's --device.")
    sv.add_argument("--quiet", action="store_true")

    st = sub.add_parser("status", help="Aggregate ledger state.")
    st.add_argument("-w", "--workdir", required=True)
    st.add_argument("--watch", action="store_true",
                    help="Live view refreshed from the newest obs "
                         "run's metrics.jsonl snapshots (the running "
                         "survey exports them every "
                         "$PPTPU_METRICS_INTERVAL seconds) — no "
                         "union-ledger replay per tick.")
    st.add_argument("--interval", type=float, default=2.0, metavar="S",
                    help="--watch refresh interval [s].")
    st.add_argument("--ticks", type=int, default=0,
                    help="Stop --watch after N frames (0 = until "
                         "interrupted).")

    rp = sub.add_parser("report",
                        help="Merge obs shards + print the obs report "
                             "and quarantine list.")
    rp.add_argument("-w", "--workdir", required=True)
    return p


def _plan_path(workdir):
    return os.path.join(workdir, "plan.json")


def _cmd_plan(args):
    from ..runner.plan import plan_survey

    os.makedirs(args.workdir, exist_ok=True)
    plan = plan_survey(args.datafiles, modelfile=args.modelfile,
                       quiet=False)
    plan.save(_plan_path(args.workdir))
    print(json.dumps({
        "plan": _plan_path(args.workdir),
        "n_archives": plan.n_archives,
        "n_buckets": len(plan.buckets),
        "buckets": {"%dx%d" % b.key: len(b.archives)
                    for b in plan.buckets},
        "unreadable": len(plan.unreadable)}))
    return 0


def _parse_workload_opts(pairs):
    """--workload_opt KEY=VALUE list -> constructor kwargs; values
    parse as JSON when they can (numbers, booleans, lists), else stay
    strings."""
    opts = {}
    for pair in pairs or []:
        key, sep, value = pair.partition("=")
        if not sep or not key:
            raise SystemExit(
                "ppsurvey: --workload_opt wants KEY=VALUE, got %r"
                % pair)
        try:
            opts[key] = json.loads(value)
        except json.JSONDecodeError:
            opts[key] = value
    return opts


def _cache_dir(args):
    """--compile-cache or $PPTPU_COMPILE_CACHE_DIR, or None."""
    return args.compile_cache \
        or os.environ.get("PPTPU_COMPILE_CACHE_DIR", "").strip() \
        or None


def _cmd_warm(args):
    from .. import obs
    from ..config import resolve_device
    from ..runner.warm import enable_persistent_cache, warm_plan

    resolve_device(args.device)  # no CUDA and no --device cpu: fail now
    plan = args.plan or _plan_path(args.workdir)
    if not os.path.isfile(plan):
        print(f"ppsurvey: no plan at {plan} — run 'ppsurvey plan' "
              "first.", file=sys.stderr)
        return 1
    os.makedirs(args.workdir, exist_ok=True)
    workload = args.workload or "toas"
    fit_kw = {}
    if workload == "toas":
        fit_kw = dict(tscrunch=args.tscrunch, fit_scat=args.fit_scat)
        if not args.narrowband:
            fit_kw["bary"] = args.bary
    with obs.run("ppsurvey-warm",
                 base_dir=os.path.join(args.workdir, "obs")):
        cache = _cache_dir(args)
        if cache:
            enable_persistent_cache(cache)
        summary = warm_plan(
            plan, args.modelfile, get_toas_kw=fit_kw,
            coalesce=(args.coalesce,) if args.coalesce > 1 else (),
            aot=args.aot, narrowband=args.narrowband,
            quiet=args.quiet, workloads=(workload,),
            device=args.device)
    print(json.dumps({k: summary[k] for k in
                      ("n_programs", "wall_s", "backend_compiles",
                       "compile_cache_hits", "compile_cache_misses")}))
    return 0


def _cmd_run(args):
    from ..config import resolve_device
    from ..runner.execute import run_survey
    from ..runner.queue import DEFAULT_WORKLOAD

    resolve_device(args.device)  # no CUDA and no --device cpu: fail now
    if args.process is None and args.processes is None:
        # a torchrun job: join its process group (no-op single-process)
        from ..parallel import multihost

        multihost.initialize()
    plan = _plan_path(args.workdir)
    if not os.path.isfile(plan):
        print(f"ppsurvey: no plan at {plan} — run 'ppsurvey plan' "
              "first.", file=sys.stderr)
        return 1
    workload = args.workload or DEFAULT_WORKLOAD
    fit_kw = {}
    if workload == DEFAULT_WORKLOAD:
        # driver-specific fit kwargs: the narrowband driver has no
        # bary (per-channel TOAs are referenced at each channel's
        # frequency); other workloads configure via --workload_opt
        fit_kw = dict(tscrunch=args.tscrunch, fit_scat=args.fit_scat,
                      nonfinite_max_frac=args.nonfinite_max_frac)
        if not args.narrowband:
            fit_kw["bary"] = args.bary
    summary = run_survey(
        plan, args.workdir, modelfile=args.modelfile,
        process_index=args.process,
        process_count=args.processes, max_attempts=args.max_attempts,
        backoff_s=args.backoff, use_mesh=args.use_mesh,
        merge=args.merge, max_archives=args.max_archives,
        trace_bucket=args.trace_bucket, watchdog_s=args.watchdog_s,
        barrier_timeout_s=args.barrier_timeout_s,
        lease_s=args.lease_s, narrowband=args.narrowband,
        workload=workload, prefetch=args.prefetch,
        warm=args.warm, compile_cache=_cache_dir(args),
        workload_opts=_parse_workload_opts(args.workload_opts),
        tenant=args.tenant, device=args.device, quiet=args.quiet,
        **fit_kw)
    out = {"workload": summary.get("workload", workload),
           "counts": summary["counts"],
           "quarantined": summary["quarantined"],
           "checkpoint": summary["checkpoint"]}
    if summary.get("drained"):
        out["drained"] = summary["drained"]
    if summary.get("barrier_timeout"):
        out["barrier_timeout"] = summary["barrier_timeout"]
    print(json.dumps(out))
    # a drained run exits 0: preemption is a scheduled event, not a
    # failure — 'ppsurvey resume' continues it
    rc = 0 if not summary["counts"].get("failed") \
        or summary.get("drained") else 1
    from ..runner.execute import abandoned_workers

    if abandoned_workers(grace_s=1.0):
        # a watchdog-abandoned worker is wedged inside native code;
        # interpreter teardown would abort (std::terminate) AFTER all
        # state is safely flushed — skip teardown, keep the exit code
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(rc)
    return rc


def _parse_worker_env(pairs):
    """--worker-env SLOT:KEY=VALUE list -> {slot: {KEY: VALUE}}."""
    out = {}
    for pair in pairs or []:
        slot, sep, kv = pair.partition(":")
        key, sep2, value = kv.partition("=")
        if not sep or not sep2 or not key or not slot.isdigit():
            raise SystemExit(
                "ppsurvey: --worker-env wants SLOT:KEY=VALUE, got %r"
                % pair)
        out.setdefault(int(slot), {})[key] = value
    return out


def _cmd_supervise(args):
    from ..runner.queue import DEFAULT_WORKLOAD
    from ..runner.respawn import RespawnPolicy
    from ..runner.supervisor import Supervisor

    try:
        sup = Supervisor(
            args.workdir, modelfile=args.modelfile,
            min_workers=args.min_workers,
            max_workers=args.max_workers,
            backlog_per_worker=args.backlog_per_worker,
            interval_s=args.interval_s, lease_s=args.lease_s,
            mem_budget_bytes=args.mem_budget_bytes,
            est_worker_bytes=args.est_worker_bytes,
            workload=args.workload or DEFAULT_WORKLOAD,
            warm=args.warm, compile_cache=_cache_dir(args),
            respawn_policy=RespawnPolicy(
                backoff_s=args.respawn_backoff_s,
                flap_count=args.flap_count,
                flap_window_s=args.flap_window_s),
            worker_args=args.worker_args,
            worker_env=_parse_worker_env(args.worker_env),
            drain_grace_s=args.drain_grace_s,
            max_ticks=args.max_ticks, device=args.device,
            quiet=args.quiet)
    except (FileNotFoundError, ValueError) as e:
        print(f"ppsurvey: {e}", file=sys.stderr)
        return 1
    summary = sup.run()
    print(json.dumps(summary))
    return 0 if summary["outstanding"] == 0 else 1


def _cmd_status(args):
    from ..runner.execute import survey_status

    if getattr(args, "watch", False):
        # snapshot-driven live view: each tick reads the newest obs
        # run's last metrics.jsonl line — a file tail, not a union
        # replay of every ledger shard (which a large live survey
        # would pay per refresh)
        from ..obs import metrics
        from .ppserve import watch_loop

        base = os.path.join(args.workdir, "obs")

        def fetch():
            run_dir = metrics.latest_run_dir(base)
            snap = metrics.last_snapshot(run_dir) if run_dir else None
            # supervised surveys: the newest run dir is a worker's,
            # not the supervisor's — fold the supervisor's gauges in
            # (absent-not-broken on unsupervised runs)
            return metrics.overlay_supervisor(snap, base)

        return watch_loop(fetch, args.interval, args.ticks,
                          title="ppsurvey %s" % args.workdir)
    try:
        status = survey_status(args.workdir)
    except FileNotFoundError as e:
        print(f"ppsurvey: {e}", file=sys.stderr)
        return 1
    # readonly union replay over every ledger shard: works on a LIVE
    # multi-shard workdir (no appends, no crash recovery) and shows
    # who owns what, each lease's time-to-expiry, and the expired
    # leases a resume of any process count would take over
    print(json.dumps({"counts": status["counts"],
                      "workloads": status.get("workloads", {}),
                      "quarantined": [
                          {"archive": a, "reason": r}
                          for a, r in status["quarantined"]],
                      "owners": status["owners"],
                      "leases": status["leases"],
                      "expired_unreclaimed":
                          status["expired_unreclaimed"]},
                     indent=1))
    if status["expired_unreclaimed"]:
        print("ppsurvey: %d expired-but-unreclaimed lease(s) — "
              "'ppsurvey resume' (any --processes) will take them "
              "over" % len(status["expired_unreclaimed"]),
              file=sys.stderr)
    return 0


# tools/obs_report.py (the repo's report renderer) reads a run through
# the JAX package's obs helpers; the port imports nothing of that
# package, so the report renders in a subprocess whose
# ``pulseportraiture_tpu.obs`` imports are served by the port's copies
# of the same modules.
_OBS_REPORT = """
import runpy, sys
import pulseportraiture_tpu_torch as port
import pulseportraiture_tpu_torch.obs
sys.modules["pulseportraiture_tpu"] = port
for name, mod in list(sys.modules.items()):
    if name.startswith("pulseportraiture_tpu_torch.obs"):
        sys.modules["pulseportraiture_tpu" + name[len(port.__name__):]] = mod
tool = runpy.run_path(sys.argv[1], run_name="obs_report")
sys.stdout.write(tool["summarize"](sys.argv[2]))
"""


def _render_obs_report(merged):
    """tools/obs_report.py's summary of the merged run, or None when
    the repo's tools are not beside the package."""
    import subprocess

    pkg_parent = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    tool = os.path.join(pkg_parent, "tools", "obs_report.py")
    if not os.path.isfile(tool):
        return None
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [pkg_parent] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", _OBS_REPORT, tool,
                           merged], capture_output=True, text=True,
                          env=env, timeout=600)
    if proc.returncode != 0:
        return None
    return proc.stdout


def _cmd_report(args):
    from ..obs.merge import merge_obs_shards
    from ..runner.execute import survey_status

    shards = os.path.join(args.workdir, "obs_shards")
    merged = os.path.join(args.workdir, "obs_merged")
    try:
        merge_obs_shards(shards, merged)
    except FileNotFoundError as e:
        print(f"ppsurvey: {e}", file=sys.stderr)
        return 1
    text = _render_obs_report(merged)
    if text is None:  # repo tools not beside the package: raw pointer
        print(f"merged obs run: {merged} (render with "
              "python -m tools.obs_report from the repo root)")
    else:
        sys.stdout.write(text)
    try:
        status = survey_status(args.workdir)
    except FileNotFoundError:
        return 0
    print("\n## survey state")
    for k, v in sorted(status["counts"].items()):
        print(f"- {k}: {v}")
    workloads = status.get("workloads") or {}
    if len(workloads) > 1 or (workloads
                              and "toas" not in workloads):
        print("\n## per-workload state")
        for wl in sorted(workloads):
            nonzero = {k: v for k, v in sorted(workloads[wl].items())
                       if v}
            line = ", ".join("%s %d" % kv for kv in nonzero.items())
            print(f"- {wl}: {line or '(empty)'}")
    if status["quarantined"]:
        print("\n## quarantined archives")
        for archive, reason in status["quarantined"]:
            print(f"- {archive}: {reason}")
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command is None:
        build_parser().print_help()
        return 1
    return {"plan": _cmd_plan, "run": _cmd_run, "resume": _cmd_run,
            "warm": _cmd_warm, "status": _cmd_status,
            "supervise": _cmd_supervise,
            "report": _cmd_report}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
