"""Compile-event bridge shared by every telemetry consumer.

The JAX package bridges ``jax.monitoring``'s compile and compile-cache
events here.  Eager PyTorch compiles nothing per call: the port's
compiles are the ``nvcc`` builds of its hand-written kernels
(``_kernels.build``).  ``build`` publishes, per kernel source, either a
:data:`CACHE_HIT_EVENT` (its library is already built and is loaded) or
a :data:`CACHE_MISS_EVENT` followed by a :data:`COMPILE_EVENT` carrying
the build's seconds.  An active :class:`.core.Recorder` subscribes for
the duration of a run and turns them into ``compile`` events and the
``backend_compiles`` / ``compile_cache_hits`` / ``compile_cache_misses``
counters, so ``tools/obs_report.py``'s compile table lists the kernel
builds.

Subscribers are callables ``cb(event, duration, **fields)`` where
``event`` is one of the keys below, ``duration`` its seconds (0.0 for
events without one) and ``fields`` names the kernel (``kernel=``).
Subscription is thread-safe; callbacks run on the publishing thread and
must be cheap and exception-free (a raising subscriber is dropped
rather than allowed to break the build).
"""

import threading

__all__ = ["COMPILE_EVENT", "CACHE_HIT_EVENT", "CACHE_MISS_EVENT",
           "publish", "subscribe", "unsubscribe"]

# one nvcc build of one kernel source, with its seconds
COMPILE_EVENT = "/pptpu/kernels/nvcc_build_duration"
# a kernel's library found already built (no nvcc run) / one that had
# to be built
CACHE_HIT_EVENT = "/pptpu/kernels/build_cache_hits"
CACHE_MISS_EVENT = "/pptpu/kernels/build_cache_misses"

_lock = threading.Lock()
_subscribers = []


def publish(event, duration=0.0, **fields):
    """Fan ``event`` out to every current subscriber."""
    if not _subscribers:
        return
    with _lock:
        subs = list(_subscribers)
    for cb in subs:
        try:
            cb(event, float(duration), **fields)
        except Exception:
            # a broken subscriber must not break the publisher; drop it
            with _lock:
                if cb in _subscribers:
                    _subscribers.remove(cb)


def subscribe(cb):
    """Register ``cb(event, duration, **fields)``."""
    with _lock:
        _subscribers.append(cb)
    return cb


def unsubscribe(cb):
    """Remove a subscriber registered with :func:`subscribe`."""
    with _lock:
        if cb in _subscribers:
            _subscribers.remove(cb)
