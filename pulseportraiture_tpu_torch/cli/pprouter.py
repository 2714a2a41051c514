"""pprouter command-line tool: the bucket-routed serving fleet (PyTorch port).

Front-end for the port's fleet subsystem (the JAX package's
``pprouter``, docs/SERVICE.md "Fleet"): bring up N ``ppserve`` daemons
behind one router socket — shared kernel build directory, shared warm
plan, shape-bucket routing, supervised respawn — and speak the same
JSONL socket protocol a single daemon does, so every daemon client
(``pploadgen``, ``ppserve submit``) points at the router socket
unchanged.

    python -m pulseportraiture_tpu_torch.cli.pprouter start -w fleetdir \\
        -m model.gmodel --plan plan.json -n 3 --warm \\
        --compile-cache kerneldir
    python -m pulseportraiture_tpu_torch.cli.pprouter status -w fleetdir
    python -m pulseportraiture_tpu_torch.cli.pprouter health -w fleetdir
    python -m pulseportraiture_tpu_torch.cli.pprouter shutdown -w fleetdir

The daemons run the port's ``ppserve`` on the CUDA device unless
``--device cpu`` is given (passed to every daemon); with no CUDA device
and no ``--device cpu``, ``start`` fails before spawning anything.
Several daemons on one GPU each hold their own CUDA context.

SIGTERM/SIGINT drain the whole fleet: the router stops routing, every
daemon drains its accepted work, ledgers/obs flush fleet-wide, exit
code 0.  A second signal aborts hard.
"""

import argparse
import json
import os
import signal
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="pprouter",
        description="Bucket-routed fleet of ppserve daemons "
                    "(PyTorch port).")
    sub = p.add_subparsers(dest="command")

    st = sub.add_parser("start", help="Run the router (foreground).")
    st.add_argument("-w", "--workdir", required=True,
                    help="Fleet state directory (created); daemon N "
                         "lives in <workdir>/dN.")
    st.add_argument("-m", "--modelfile", required=True,
                    help="Model file daemons fit against.")
    st.add_argument("-n", "--daemons", type=int, default=3,
                    dest="n_daemons",
                    help="Fleet size (spawned ppserve processes).")
    st.add_argument("--plan", default=None, metavar="plan.json",
                    help="Survey plan shared by every daemon's warm "
                         "pool.")
    st.add_argument("--warm", action="store_true",
                    help="Daemons warm their planned buckets before "
                         "serving (the first to build a kernel runs "
                         "nvcc; the shared build directory makes the "
                         "rest load it).")
    st.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="Shared kernel build directory (default: "
                         "$PPTPU_COMPILE_CACHE_DIR if set).")
    st.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="Where every daemon fits (default the CUDA "
                         "device; 'cpu' must be asked for).")
    st.add_argument("--socket", default=None,
                    help="Router socket path (default: "
                         "<workdir>/pprouter.sock).")
    st.add_argument("--window", type=float, default=0.25,
                    metavar="S", dest="batch_window_s",
                    help="Daemon micro-batch base window [s].")
    st.add_argument("--solo-window", type=float, default=0.1,
                    metavar="S", dest="solo_window_s",
                    help="Daemon solo-cycle grace window [s].")
    st.add_argument("--batch", type=int, default=8, dest="batch_max",
                    help="Daemon max requests per micro-batch.")
    st.add_argument("--mem-budget", type=int, default=0,
                    metavar="BYTES", dest="mem_budget_bytes",
                    help="Fleet admission: shed submissions whose "
                         "estimated device footprint exceeds this "
                         "(0 = no memory shed).")
    st.add_argument("--max-open", type=int, default=0,
                    dest="fleet_max_open",
                    help="Fleet admission: shed when this many "
                         "requests are already open across the fleet "
                         "(0 = unlimited).")
    st.add_argument("--quotas", default=None, metavar="JSON",
                    help="Per-tenant usage budgets enforced at fleet "
                         "admission AND propagated to every spawned "
                         "daemon (docs/OBSERVABILITY.md; default "
                         "$PPTPU_QUOTAS).")
    st.add_argument("--health-interval", type=float, default=1.0,
                    metavar="S", dest="health_interval_s",
                    help="Supervisor health-poll period [s].")
    st.add_argument("--rebalance-delta", type=int, default=8,
                    help="Open-request skew between hottest and "
                         "coldest daemon that triggers a bucket "
                         "move.")
    st.add_argument("--adopt", action="append", default=None,
                    metavar="SOCKET", dest="adopt_sockets",
                    help="Adopt an already-running daemon by socket "
                         "path instead of spawning (repeatable; "
                         "adopted daemons are health-polled but not "
                         "respawned).")
    st.add_argument("--daemon-arg", action="append", default=None,
                    dest="daemon_args", metavar="ARG",
                    help="Extra ppserve-start argument passed to "
                         "every spawned daemon (repeatable, e.g. "
                         "--daemon-arg=--no_bary).")
    st.add_argument("--quiet", action="store_true")

    for name, help_text in (("status", "Fleet status snapshot."),
                            ("health", "Fleet liveness/readiness "
                                       "probe + firing alerts."),
                            ("shutdown", "Begin a fleet-wide drain."),
                            ("ping", "Router liveness check.")):
        c = sub.add_parser(name, help=help_text)
        c.add_argument("-w", "--workdir", required=True)
        c.add_argument("--socket", default=None)
        if name == "status":
            c.add_argument("--watch", action="store_true",
                           help="Live view over the MERGED fleet "
                                "metrics snapshot (router + every "
                                "daemon) until interrupted.")
            c.add_argument("--interval", type=float, default=2.0,
                           metavar="S")
            c.add_argument("--ticks", type=int, default=0)
    return p


def _socket_path(args):
    from ..service import DEFAULT_ROUTER_SOCKET_NAME

    return args.socket or os.path.join(args.workdir,
                                       DEFAULT_ROUTER_SOCKET_NAME)


def _cmd_start(args):
    from ..service import FleetRouter, ServiceServer

    compile_cache = args.compile_cache \
        or os.environ.get("PPTPU_COMPILE_CACHE_DIR", "").strip() \
        or None
    router = FleetRouter(
        args.modelfile, args.workdir, n_daemons=args.n_daemons,
        plan=args.plan, compile_cache=compile_cache, warm=args.warm,
        batch_window_s=args.batch_window_s, batch_max=args.batch_max,
        solo_window_s=args.solo_window_s,
        mem_budget_bytes=args.mem_budget_bytes,
        quotas=args.quotas,
        fleet_max_open=args.fleet_max_open,
        health_interval_s=args.health_interval_s,
        rebalance_delta=args.rebalance_delta,
        adopt_sockets=args.adopt_sockets,
        daemon_args=args.daemon_args, quiet=args.quiet,
        device=args.device)
    router.start()
    server = ServiceServer(router, _socket_path(args)).start()

    signals = {"n": 0}

    def _on_signal(signum, frame):
        signals["n"] += 1
        if signals["n"] > 1:
            raise KeyboardInterrupt  # second signal: abort hard
        router.request_drain()

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _on_signal)

    ready = sum(1 for d in router._daemons if d.ready.is_set())
    # readiness marker for scripts
    print("PPROUTER_READY " + json.dumps(
        {"socket": server.socket_path, "pid": os.getpid(),
         "daemons": len(router._daemons), "ready": ready}))
    sys.stdout.flush()
    try:
        while not router.drained(timeout=0.2):
            pass
    except KeyboardInterrupt:
        print("pprouter: hard abort", file=sys.stderr)
        server.stop()
        router.shutdown(timeout=5.0)
        return 130
    import time

    time.sleep(0.5)  # grace for in-flight socket responses
    server.stop()
    router.shutdown(timeout=60.0)
    if not args.quiet:
        print("pprouter: fleet drained, exiting 0", file=sys.stderr)
    return 0


def _cmd_simple(op):
    def run(args):
        from ..service import client_request

        resp = client_request(_socket_path(args), {"op": op})
        print(json.dumps(
            resp, indent=1 if op in ("status", "health") else None))
        return 0 if resp.get("ok") else 1
    return run


def _cmd_status(args):
    if not getattr(args, "watch", False):
        return _cmd_simple("status")(args)
    from ..service import client_request
    from .ppserve import watch_loop

    sock = _socket_path(args)

    def fetch():
        try:
            return client_request(sock, {"op": "metrics"},
                                  timeout=30.0).get("snapshot")
        except (OSError, ValueError):
            return None

    return watch_loop(fetch, args.interval, args.ticks,
                      title="pprouter %s" % args.workdir)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command is None:
        build_parser().print_help()
        return 1
    return {"start": _cmd_start, "status": _cmd_status,
            "health": _cmd_simple("health"),
            "shutdown": _cmd_simple("shutdown"),
            "ping": _cmd_simple("ping")}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
