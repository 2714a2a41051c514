"""Local transport for the TOA service: JSONL over a Unix socket.

A copy of the JAX package's ``service/server.py`` (stdlib only; the
port imports nothing of that package).  One connection carries one
request: the client sends a single JSON object terminated by a
newline, the server answers with one JSON line and closes.  Blocking
ops (``submit`` with ``wait``, ``wait``) hold their connection open
until the request settles, so a caller needs no polling loop.  No new
dependencies — this is stdlib ``socket`` + ``json``, matching the
daemon's single-host scope (a fleet, service/router.py, fronts many
daemons over the same protocol).

Ops (all responses carry ``ok``)::

    {"op": "ping"}
    {"op": "submit", "tenant": T, "archive": PATH,
     "config": {...}, "wait": true, "timeout_s": 300,
     "priority": 1, "deadline_s": 5.0,          # deadline class
     "traceparent": "00-<32hex>-<16hex>-01"}   # optional W3C carrier
    {"op": "wait", "request_id": "r000001", "timeout_s": 300}
    {"op": "status"}
    {"op": "health"}            # liveness/readiness + firing alerts
    {"op": "metrics"}           # live streaming-metrics snapshot
    {"op": "metrics", "format": "prometheus"}   # + text exposition
    {"op": "shutdown"}          # begins a drain; daemon exits 0 after

The ``metrics`` payload is the daemon run's cumulative snapshot
(obs/metrics.py): counters, gauges and the request-lifecycle latency
histograms ``pploadgen``'s SLO gate and the ``ppserve status --watch``
view are driven by.
"""

import json
import os
import socket
import threading

from .. import obs
from ..obs import metrics as _metrics

__all__ = ["ServiceServer", "client_request", "DEFAULT_SOCKET_NAME"]

DEFAULT_SOCKET_NAME = "ppserve.sock"

_MAX_LINE = 1 << 20  # a request line this long is a protocol error


class ServiceServer:
    """Accept loop + per-connection handler threads over a
    :class:`~.daemon.TOAService`."""

    def __init__(self, service, socket_path):
        self.service = service
        self.socket_path = socket_path
        self._sock = None
        self._thread = None
        self._stop = threading.Event()

    def start(self):
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)  # stale socket from a crash
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="ppserve-server",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True,
                             name="ppserve-conn-%d" % conn.fileno(),
                             ).start()

    def _handle(self, conn):
        try:
            req = self._read_line(conn)
            resp = self._dispatch(req)
        except Exception as e:  # noqa: BLE001 — protocol boundary
            resp = {"ok": False, "error": "protocol",
                    "detail": "%s: %s" % (type(e).__name__, e)}
        try:
            conn.sendall((json.dumps(resp, default=str) + "\n")
                         .encode("utf-8"))
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _read_line(conn):
        buf = b""
        while b"\n" not in buf:
            if len(buf) > _MAX_LINE:
                raise ValueError("request line too long")
            chunk = conn.recv(65536)
            if not chunk:
                break
            buf += chunk
        line = buf.split(b"\n", 1)[0].strip()
        if not line:
            raise ValueError("empty request")
        return json.loads(line.decode("utf-8"))

    def _dispatch(self, req):
        op = req.get("op")
        svc = self.service
        if op == "ping":
            return {"ok": True, "pid": os.getpid()}
        if op == "submit":
            return svc.submit(req.get("tenant"), req.get("archive"),
                              config=req.get("config"),
                              wait=bool(req.get("wait")),
                              timeout=req.get("timeout_s"),
                              traceparent=req.get("traceparent"),
                              priority=req.get("priority") or 0,
                              deadline_s=req.get("deadline_s"))
        if op == "wait":
            return svc.wait(req.get("request_id"),
                            timeout=req.get("timeout_s"))
        if op == "status":
            return svc.status()
        if op == "health":
            return svc.health()
        if op == "metrics":
            snap = svc.metrics_snapshot()
            resp = {"ok": True, "snapshot": snap}
            if req.get("format") == "prometheus":
                resp["text"] = _metrics.render_prometheus(snap)
            return resp
        if op == "shutdown":
            obs.event("service_shutdown_requested", via="socket")
            svc.request_drain()
            return {"ok": True, "draining": True}
        return {"ok": False, "error": "unknown_op", "op": op}


def client_request(socket_path, payload, timeout=300.0):
    """Send one op to a running daemon; returns the response dict."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(socket_path)
        s.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    line = buf.split(b"\n", 1)[0].strip()
    if not line:
        raise ConnectionError("ppserve daemon closed the connection "
                              "without a response")
    return json.loads(line.decode("utf-8"))
