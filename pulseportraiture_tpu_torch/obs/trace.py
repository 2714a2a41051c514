"""Opt-in torch.profiler trace capture (PPTPU_TRACE_DIR).

``trace_capture(name)`` wraps a region in a ``torch.profiler`` capture
(host activity, plus the card's kernels, copies and memsets through
CUPTI when CUDA is available) when the ``PPTPU_TRACE_DIR`` environment
variable names a directory (or an explicit ``base_dir`` is given), and
is a no-op otherwise.  The capture is exported as a Chrome trace,
``<base>/<name>/<session>/pid<pid>.trace.json.gz``, one session
directory per capture.  A failing profiler start degrades to "no
trace, one event recorded" rather than an exception: telemetry must
never kill the run it is observing.

The profiler is a PROCESS-WIDE singleton (Kineto runs one session at a
time).  A nested ``trace_capture`` therefore degrades to a no-op that
yields None and records one ``trace_skipped`` event naming the owning
region — the outer capture keeps the device timeline.

On a successful stop the capture is immediately ingested by
:mod:`.devtime`: one ``devtime`` event (per-stage device seconds,
``record_function`` scope attribution, and each hand kernel's rows
against its launches inside the region: ``complete``) lands in the
active obs run next to the ``trace`` event that links the span wall
clock to the trace path.  The first capture of a process also
initializes CUPTI, which takes seconds on the card; a caller timing the
region warms the profiler up first.
"""

import contextlib
import os
import threading
import time

from . import core, devtime

__all__ = ["trace_dir", "trace_capture"]

_lock = threading.Lock()
_active_region = None  # region name owning the process-wide profiler


def trace_dir():
    """$PPTPU_TRACE_DIR, or None when profiler capture is disabled."""
    v = os.environ.get("PPTPU_TRACE_DIR", "").strip()
    return v or None


def _session_dir(path):
    """A fresh session directory under a region's ``path``; names sort
    in capture order (devtime.find_capture takes the newest)."""
    now = time.time()
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
    return os.path.join(path, "%s.%06d" % (stamp, int(now % 1 * 1e6)))


@contextlib.contextmanager
def trace_capture(name, base_dir=None):
    """Capture a torch.profiler trace of the region into
    ``<base>/<name>`` (``base_dir`` or ``$PPTPU_TRACE_DIR``); yields
    the region directory or None.

    Composes with :func:`.core.span`: the span carries the wall clock,
    the profiler trace carries the device timeline, the emitted
    ``trace`` event links the two, and the ``devtime`` event
    :func:`.devtime.record_devtime` ingests carries the per-stage
    device-second attribution.
    """
    global _active_region
    base = base_dir if base_dir is not None else trace_dir()
    if base is None:
        yield None
        return
    path = os.path.join(base, name)
    with _lock:
        owner = _active_region
        if owner is None:
            _active_region = name
    if owner is not None:
        # profiler already running: degrade, don't raise mid-pipeline
        core.event("trace_skipped", region=name, active_region=owner)
        yield None
        return
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from .. import _kernels

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        before = dict(_kernels.LAUNCHES)
        prof = profile(activities=acts)
        prof.start()
    except Exception as e:
        prof = None
        core.event("trace_error", region=name, error=str(e)[:500])
    try:
        yield path if prof is not None else None
    finally:
        if prof is not None:
            try:
                kernels = {k: (_kernels.TRACE_NAMES[k], n - before[k])
                           for k, n in _kernels.LAUNCHES.items()}
                prof.stop()
                session = _session_dir(path)
                os.makedirs(session, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    session, "pid%d.trace.json.gz" % os.getpid()))
                core.event("trace", region=name, path=path)
                devtime.record_devtime(name, path, kernels=kernels)
            except Exception as e:
                core.event("trace_error", region=name,
                           error=str(e)[:500])
        with _lock:
            _active_region = None
