"""Distributed tracing: causal ids for the obs event stream.

The event stream (:mod:`.core`) records *what happened*; the metrics
plane (:mod:`.metrics`) records *how the distribution looks*.  Neither
answers *why this particular request was slow* — that needs
Dapper-style request-scoped tracing (Sigelman et al. 2010): every span
carries ``trace_id`` / ``span_id`` / ``parent_span_id``, so a p99
histogram bucket's exemplar trace id resolves to a concrete span tree
and a critical path (``tools/obs_trace.py``).

Design (docs/OBSERVABILITY.md "Distributed tracing"):

* **Context is ambient, per thread.**  A context is the pair
  ``(trace_id, span_id)`` — the trace this thread is working for and
  the span any new child should parent on.  It lives in the same
  thread-local the span stack uses (``core._tls``), so the read is ONE
  ``getattr``.  :func:`activate` installs a context for a with-block (the
  cross-thread attach: a worker thread adopts its request's context).
* **Zero API churn for instrumented code.**  ``obs.span`` /
  ``obs.phases`` / ``obs.event`` stamp the ambient context onto the
  events they already emit and push the child context for their
  dynamic extent — the GetTOAs load/guess/solve/write phases become
  children of whatever request span is ambient without a single caller
  changing.  With no ambient context the events are exactly what they
  were before this module existed.
* **Explicit carriers across processes.**  :func:`inject` /
  :func:`extract` move a context through a dict using the W3C
  ``traceparent`` field (``00-<32hex trace>-<16hex span>-01``), which
  a socket protocol forwards verbatim, so a client-side submit span
  becomes the root of the server-side request tree.
* **Fan-in is first-class.**  A batched dispatch serving K requests is
  ONE span carrying ``links`` — ``[{"trace_id", "span_id"}, ...]``
  references to every member request's context (OpenTelemetry span
  links) — instead of K copies or a lost edge.

Host-side only, like everything in ``obs``: a trace id is a host
string, never a device value.
"""

import contextlib
import os
import re

from . import core as _core

__all__ = ["current", "current_trace_id", "current_span_id", "mint",
           "activate", "new_trace_id", "new_span_id", "inject",
           "extract", "format_traceparent", "parse_traceparent",
           "emit_span", "link", "TRACEPARENT_KEY"]

# the carrier field name (W3C Trace Context); the socket protocol and
# any future HTTP front reuse it unchanged
TRACEPARENT_KEY = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def new_trace_id():
    """A fresh 128-bit trace id (32 hex chars)."""
    return os.urandom(16).hex()


def new_span_id():
    """A fresh 64-bit span id (16 hex chars)."""
    return os.urandom(8).hex()


def mint():
    """A fresh root context: new trace, no parent span.  The first
    span opened under it becomes the trace's root."""
    return (new_trace_id(), None)


def current():
    """The ambient ``(trace_id, span_id)`` context of this thread, or
    None.  One thread-local lookup — safe on any hot path."""
    return getattr(_core._tls, "trace", None)


def current_trace_id():
    """Ambient trace id, or None (ledger/checkpoint stamping)."""
    ctx = getattr(_core._tls, "trace", None)
    return ctx[0] if ctx is not None else None


def current_span_id():
    """Ambient span id, or None."""
    ctx = getattr(_core._tls, "trace", None)
    return ctx[1] if ctx is not None else None


@contextlib.contextmanager
def activate(ctx):
    """Install ``ctx`` as this thread's ambient context for the
    with-block (and restore the previous one after).

    ``ctx`` is ``(trace_id, span_id)`` — typically a request's
    ``(trace_id, request_span_id)`` adopted by the worker thread that
    fits it, or :func:`mint` for a fresh root.  ``None`` deactivates
    tracing for the block.
    """
    tls = _core._tls
    prev = getattr(tls, "trace", None)
    tls.trace = tuple(ctx) if ctx is not None else None
    try:
        yield ctx
    finally:
        tls.trace = prev


def format_traceparent(ctx):
    """W3C traceparent string for a context (span id required — inject
    from inside a span, or allocate one first)."""
    trace_id, span_id = ctx
    if span_id is None:
        span_id = new_span_id()
    return "00-%s-%s-01" % (trace_id, span_id)


def parse_traceparent(value):
    """``(trace_id, span_id)`` from a traceparent string, or None when
    the value is absent/malformed (a bad carrier must degrade to an
    untraced request, never reject it)."""
    if not value or not isinstance(value, str):
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if not m:
        return None
    return (m.group(1), m.group(2))


def inject(carrier=None, ctx=None):
    """Write the (given or ambient) context into ``carrier`` as a
    ``traceparent`` field; returns the carrier (a fresh dict when
    None).  No-op returning the carrier unchanged when there is no
    context to propagate."""
    if carrier is None:
        carrier = {}
    if ctx is None:
        ctx = current()
    if ctx is not None:
        carrier[TRACEPARENT_KEY] = format_traceparent(ctx)
    return carrier


def extract(carrier):
    """Context from a carrier dict's ``traceparent`` field, or None."""
    if not isinstance(carrier, dict):
        return None
    return parse_traceparent(carrier.get(TRACEPARENT_KEY))


def link(ctx):
    """A span-link reference dict for ``ctx`` (JSON-ready)."""
    return {"trace_id": ctx[0], "span_id": ctx[1]}


def emit_span(name, dur_s, ctx=None, span_id=None, links=None,
              **attrs):
    """Record a span post-hoc (duration already measured).

    For intervals whose end is "now" but whose start predates any
    with-block — a request's queue wait measured at claim time, the
    request's own end-to-end span stamped at finalize.  Parents on the
    given ``ctx`` (or the ambient one); allocates ``span_id`` unless
    the caller pre-allocated it (a request span whose id children
    already reference).  ``links`` is a list of :func:`link` dicts.
    Returns the span id, or None when no run is active.
    """
    rec = _core._active
    if rec is None:
        return None
    if ctx is None:
        ctx = current()
    sid = span_id or new_span_id()
    fields = dict(attrs)
    if ctx is not None:
        fields["trace_id"] = ctx[0]
        if ctx[1] is not None:
            fields["parent_span_id"] = ctx[1]
    fields["span_id"] = sid
    if links:
        fields["links"] = list(links)
    rec.emit("span", name=name, path=name,
             dur_s=round(float(dur_s), 6), **fields)
    return sid
