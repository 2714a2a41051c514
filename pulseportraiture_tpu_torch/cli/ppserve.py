"""ppserve command-line tool: the resident TOA-fitting daemon (PyTorch port).

Front-end for the port's service subsystem (the JAX package's
``ppserve``, docs/SERVICE.md): start a long-lived multi-tenant daemon
that keeps per-bucket fitters warm and micro-batches requests, warm a
plan's kernels and shapes ahead of time, and submit/inspect over the
daemon's local socket.

    python -m pulseportraiture_tpu_torch.cli.ppserve start -w workdir \\
        -m model.gmodel --plan workdir/plan.json --warm
    python -m pulseportraiture_tpu_torch.cli.ppserve warm -w workdir \\
        -m model.gmodel --plan workdir/plan.json
    python -m pulseportraiture_tpu_torch.cli.ppserve submit -w workdir \\
        -t alice --wait archive.fits
    python -m pulseportraiture_tpu_torch.cli.ppserve status -w workdir
    python -m pulseportraiture_tpu_torch.cli.ppserve health -w workdir
    python -m pulseportraiture_tpu_torch.cli.ppserve shutdown -w workdir

The daemon fits on the CUDA device unless ``--device cpu`` is given;
with no CUDA device and no ``--device cpu``, ``start`` and ``warm``
fail.  ``--compile-cache DIR`` names the directory the hand kernels are
built into and loaded from (the JAX package's persistent XLA cache).
``--no-aot`` is accepted for the reference's command lines and does
nothing: eager PyTorch has no ahead-of-time compile stage, and warm
always builds every kernel source up front.  Other arguments and
outputs are the reference's.

SIGTERM/SIGINT drain the daemon: intake starts rejecting, everything
already accepted finishes, ledgers/checkpoints/obs flush, exit code 0
— preemption is a scheduled event, not a failure (same contract as
``ppsurvey``).  A second signal aborts hard.
"""

import argparse
import json
import os
import signal
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="ppserve",
        description="Resident multi-tenant TOA fitting daemon "
                    "(PyTorch port).")
    sub = p.add_subparsers(dest="command")

    st = sub.add_parser("start", help="Run the daemon (foreground).")
    st.add_argument("-w", "--workdir", required=True,
                    help="Service state directory (created).")
    st.add_argument("-m", "--modelfile", required=True,
                    help="Model file requests are fit against.")
    st.add_argument("--plan", default=None, metavar="plan.json",
                    help="Survey plan whose buckets seed the warm "
                         "pool (ppsurvey plan).")
    st.add_argument("-d", "--datafiles", default=None, metavar="meta",
                    help="Metafile to plan at startup instead of "
                         "--plan.")
    st.add_argument("--warm", action="store_true",
                    help="Build the kernels and prime every planned "
                         "bucket shape before serving "
                         "(service/warm.py).")
    st.add_argument("--no-aot", action="store_false", dest="aot",
                    help="Accepted for the reference's command lines; "
                         "does nothing (eager PyTorch has no "
                         "ahead-of-time compile stage).")
    st.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="Kernel build directory: the hand kernels are "
                         "built into and loaded from it (default: "
                         "$PPTPU_COMPILE_CACHE_DIR if set).")
    st.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Where the daemon fits (default the CUDA "
                         "device; 'cpu' must be asked for).")
    st.add_argument("--socket", default=None,
                    help="Unix socket path (default: "
                         "<workdir>/ppserve.sock).")
    st.add_argument("--window", type=float, default=0.25,
                    metavar="S", dest="batch_window_s",
                    help="Micro-batch gather window [s]: same-bucket "
                         "requests arriving within it share one "
                         "device dispatch.")
    st.add_argument("--batch", type=int, default=8, dest="batch_max",
                    help="Max requests per micro-batch cycle.")
    st.add_argument("--solo-window", type=float, default=0.1,
                    metavar="S", dest="solo_window_s",
                    help="Grace window [s] when a cycle has no other "
                         "parked candidate to coalesce with — a solo "
                         "late arriver dispatches after this instead "
                         "of the full --window.")
    st.add_argument("--max-inflight", type=int, default=4,
                    dest="tenant_max_inflight",
                    help="Per-tenant cap on slots in one cycle "
                         "(fairness).")
    st.add_argument("--max-queue", type=int, default=64,
                    dest="tenant_max_queue",
                    help="Per-tenant open-request budget; beyond it "
                         "submissions get 'backpressure' rejections.")
    st.add_argument("--prefetch", type=int, default=2, metavar="N",
                    help="Decode-at-intake pool depth: up to N "
                         "accepted requests decode + pad on the host "
                         "prefetch pool during the micro-batch window "
                         "(docs/SERVICE.md; 0 = decode inline in the "
                         "fit worker).")
    st.add_argument("--max_attempts", type=int, default=3,
                    help="Retries before a request is quarantined.")
    st.add_argument("--backoff", type=float, default=1.0,
                    help="Base retry backoff [s].")
    st.add_argument("--run-dirs-max", type=int, default=None,
                    help="Retained per-request obs run dirs "
                         "(default $PPTPU_SERVE_MAX_RUNS or 256).")
    st.add_argument("--run-bytes-max", type=int, default=None,
                    help="Byte budget for retained request runs "
                         "(default $PPTPU_SERVE_MAX_RUN_BYTES; 0 = "
                         "count budget only).")
    st.add_argument("--quotas", default=None, metavar="JSON",
                    help="Per-tenant usage budgets, e.g. "
                         "'{\"acme\": {\"device_seconds\": 30}}' "
                         "(docs/OBSERVABILITY.md; default "
                         "$PPTPU_QUOTAS).  Breaching tenants get "
                         "replayable 'quota' rejections.")
    st.add_argument("--narrowband", action="store_true",
                    help="Serve per-channel (narrowband) TOAs.")
    st.add_argument("--tscrunch", "-T", action="store_true")
    st.add_argument("--fit_scat", action="store_true")
    st.add_argument("--no_bary", dest="bary", action="store_false")
    st.add_argument("--quiet", action="store_true")

    wm = sub.add_parser("warm", help="Warm a plan's programs and exit "
                                     "(no daemon).")
    wm.add_argument("-w", "--workdir", required=True)
    wm.add_argument("-m", "--modelfile", required=True)
    wm.add_argument("--plan", default=None)
    wm.add_argument("-d", "--datafiles", default=None, metavar="meta")
    wm.add_argument("--no-aot", action="store_false", dest="aot",
                    help="Accepted; does nothing (see start).")
    wm.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="Kernel build directory (see start).")
    wm.add_argument("--coalesce", type=int, default=0, metavar="K",
                    help="Also warm the K-way coalesced batch "
                         "shapes.")
    wm.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Where the warm fits run (default the CUDA "
                         "device).")
    wm.add_argument("--narrowband", action="store_true")
    wm.add_argument("--quiet", action="store_true")

    sb = sub.add_parser("submit", help="Submit archives to a daemon.")
    sb.add_argument("-w", "--workdir", required=True)
    sb.add_argument("--socket", default=None)
    sb.add_argument("-t", "--tenant", required=True)
    sb.add_argument("--wait", action="store_true",
                    help="Block until each request settles.")
    sb.add_argument("--timeout", type=float, default=600.0)
    sb.add_argument("archives", nargs="+")

    for name, help_text in (("status", "Daemon status snapshot."),
                            ("health", "Liveness/readiness probe + "
                                       "firing alerts."),
                            ("shutdown", "Begin a graceful drain."),
                            ("ping", "Liveness check.")):
        c = sub.add_parser(name, help=help_text)
        c.add_argument("-w", "--workdir", required=True)
        c.add_argument("--socket", default=None)
        if name == "status":
            c.add_argument("--watch", action="store_true",
                           help="pptop-style live view: refresh from "
                                "the daemon's streaming-metrics "
                                "snapshots (the 'metrics' socket "
                                "verb) until interrupted.")
            c.add_argument("--interval", type=float, default=2.0,
                           metavar="S",
                           help="--watch refresh interval [s].")
            c.add_argument("--ticks", type=int, default=0,
                           help="Stop --watch after N frames "
                                "(0 = until interrupted).")
    return p


def _socket_path(args):
    from ..service import DEFAULT_SOCKET_NAME

    return args.socket or os.path.join(args.workdir,
                                       DEFAULT_SOCKET_NAME)


def _load_plan(args):
    from ..runner.plan import SurveyPlan, plan_survey

    if args.plan:
        return SurveyPlan.load(args.plan)
    if args.datafiles:
        return plan_survey(args.datafiles, modelfile=args.modelfile,
                           quiet=args.quiet)
    return None


def _compile_cache(args):
    cache = args.compile_cache \
        or os.environ.get("PPTPU_COMPILE_CACHE_DIR", "").strip()
    if cache:
        from ..service import enable_persistent_cache

        if not enable_persistent_cache(cache):
            return None  # degraded (compile_cache_degraded recorded)
    return cache or None


def _cmd_start(args):
    from ..config import resolve_device
    from ..service import ServiceServer, TOAService

    resolve_device(args.device)  # no CUDA and no --device cpu: fail now
    _compile_cache(args)
    plan = _load_plan(args)
    fit_kw = dict(tscrunch=args.tscrunch, fit_scat=args.fit_scat)
    if not args.narrowband:
        fit_kw["bary"] = args.bary
    svc = TOAService(
        args.modelfile, args.workdir, plan=plan,
        narrowband=args.narrowband,
        batch_window_s=args.batch_window_s, batch_max=args.batch_max,
        solo_window_s=args.solo_window_s,
        tenant_max_inflight=args.tenant_max_inflight,
        tenant_max_queue=args.tenant_max_queue,
        max_attempts=args.max_attempts, backoff_s=args.backoff,
        prefetch=args.prefetch,
        run_dirs_max=args.run_dirs_max,
        run_bytes_max=args.run_bytes_max,
        quotas=args.quotas,
        get_toas_kw=fit_kw, quiet=args.quiet, device=args.device)
    svc.start()
    if args.warm and plan is not None:
        svc.warm()
    server = ServiceServer(svc, _socket_path(args)).start()

    signals = {"n": 0}

    def _on_signal(signum, frame):
        signals["n"] += 1
        if signals["n"] > 1:
            raise KeyboardInterrupt  # second signal: abort hard
        svc.request_drain()

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _on_signal)

    # readiness marker for scripts (the fleet router waits on it)
    print("PPSERVE_READY " + json.dumps(
        {"socket": server.socket_path, "pid": os.getpid(),
         "warmed": svc.warm_summary is not None}))
    sys.stdout.flush()
    try:
        while not svc.drained(timeout=0.2):
            pass
        # grace for in-flight socket responses (wait/status handlers
        # racing the drain) before tearing the listener down
        import time

        time.sleep(0.5)
    except KeyboardInterrupt:
        print("ppserve: hard abort", file=sys.stderr)
        server.stop()
        return 130
    server.stop()
    svc.shutdown()
    if not args.quiet:
        print("ppserve: drained, exiting 0", file=sys.stderr)
    return 0


def _cmd_warm(args):
    from ..config import resolve_device
    from ..service import warm_plan

    resolve_device(args.device)  # no CUDA and no --device cpu: fail now
    _compile_cache(args)
    plan = _load_plan(args)
    if plan is None:
        print("ppserve warm: need --plan or --datafiles",
              file=sys.stderr)
        return 1
    from .. import obs

    os.makedirs(args.workdir, exist_ok=True)
    with obs.run("ppserve-warm",
                 base_dir=os.path.join(args.workdir, "obs")):
        summary = warm_plan(
            plan, args.modelfile,
            coalesce=(args.coalesce,) if args.coalesce > 1 else (),
            narrowband=args.narrowband, quiet=args.quiet,
            device=args.device)
    print(json.dumps({k: summary[k] for k in
                      ("n_programs", "wall_s", "backend_compiles",
                       "compile_cache_hits", "compile_cache_misses")}))
    return 0


def _cmd_submit(args):
    from ..service import client_request

    sock = _socket_path(args)
    rc = 0
    for archive in args.archives:
        resp = client_request(
            sock, {"op": "submit", "tenant": args.tenant,
                   "archive": os.path.abspath(archive),
                   "wait": args.wait, "timeout_s": args.timeout},
            timeout=args.timeout + 30.0)
        print(json.dumps(resp))
        if not resp.get("ok") or resp.get("state") == "quarantined":
            rc = 1
    return rc


def _cmd_simple(op):
    def run(args):
        from ..service import client_request

        resp = client_request(_socket_path(args), {"op": op})
        print(json.dumps(
            resp, indent=1 if op in ("status", "health") else None))
        return 0 if resp.get("ok") else 1
    return run


def watch_loop(fetch, interval, ticks, title):
    """Shared --watch loop (ppserve/pprouter/ppsurvey): render one
    frame per tick from ``fetch()``'s metrics snapshot, rates from the
    previous tick's — no ledger scans, just snapshot reads.  Bounded by
    ``ticks`` when nonzero; Ctrl-C exits 0."""
    import time

    from ..obs import metrics

    prev = None
    tick = 0
    try:
        while True:
            snap = fetch()
            frame = metrics.render_watch(snap, prev, title=title)
            if sys.stdout.isatty():
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print(frame)
            sys.stdout.flush()
            prev = snap
            tick += 1
            if ticks and tick >= ticks:
                return 0
            time.sleep(max(0.05, interval))
    except KeyboardInterrupt:
        return 0


def _cmd_status(args):
    if not getattr(args, "watch", False):
        return _cmd_simple("status")(args)
    from ..service import client_request

    sock = _socket_path(args)

    def fetch():
        try:
            return client_request(sock, {"op": "metrics"},
                                  timeout=30.0).get("snapshot")
        except (OSError, ValueError):
            return None

    return watch_loop(fetch, args.interval, args.ticks,
                      title="ppserve %s" % args.workdir)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command is None:
        build_parser().print_help()
        return 1
    return {"start": _cmd_start, "warm": _cmd_warm,
            "submit": _cmd_submit, "status": _cmd_status,
            "health": _cmd_simple("health"),
            "shutdown": _cmd_simple("shutdown"),
            "ping": _cmd_simple("ping")}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
