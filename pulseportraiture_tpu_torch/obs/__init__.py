"""Structured observability for the TOA pipelines.

The PyTorch port's copy of the JAX package's ``obs`` layer: the same
environment variables, run-directory layout and event schema, so
``tools/obs_report.py``, ``tools/obs_diff.py`` and ``tools/obs_trace.py``
read a port run unchanged.

Gated on ``PPTPU_OBS_DIR``: when unset (the default) every entry point
is a cheap no-op; when set, pipelines write a per-run directory holding
``events.jsonl`` (spans, kernel builds, fit telemetry) and
``manifest.json`` (platform, shapes, config, git SHA).

Layout:

* :mod:`.core`     — runs, spans, events, counters, fit telemetry,
  size-based sink rotation (``PPTPU_OBS_MAX_BYTES``)
* :mod:`.monitor`  — the compile-event fan-out bridge: each ``nvcc``
  build of a kernel source (``_kernels.build``) is a ``compile`` event,
  each library already built a cache hit
* :mod:`.manifest` — run-manifest assembly (git SHA, torch and CUDA
  versions, the card, env)
* :mod:`.trace`    — opt-in ``torch.profiler`` capture
  (``PPTPU_TRACE_DIR``), reentrancy-safe (a nested capture degrades to
  a ``trace_skipped`` event; the profiler is a process-wide singleton)
* :mod:`.devtime`  — capture ingestion: Chrome-trace parsing, self-time
  reduction, ``record_function`` (``pp_*``) stage attribution of the
  card's kernel, copy and memset rows, the per-region ``devtime``
  events the phase table's device column is built from
* :mod:`.memory`   — memory observability: live allocator/host
  watermark sampler (``pps_device_bytes_in_use`` /
  ``pps_device_peak_bytes`` / ``pps_host_rss_bytes`` gauges), per-span
  ``peak_bytes`` watermarks, allocator-snapshot OOM dumps
* :mod:`.quality`  — fit-quality observability: per-run quality
  fingerprints from the per-subint fit statistics (reduced chi^2 /
  TOA-error / S/N distributions with fixed histogram geometry, exact
  bad-fit counters, per-archive ``quality`` events with residual
  whiteness) — the ``obs_diff --quality-rel`` drift gate's data plane
* :mod:`.metrics`  — live telemetry plane: label-keyed counters/
  gauges + log-bucketed latency histograms with exact deterministic
  merge, periodic ``metrics.jsonl`` snapshots, Prometheus text
  rendering, SLO evaluation, the ``--watch`` frames
* :mod:`.health`   — live health plane: declarative alert rules
  (threshold / rate / ratio / SLO burn-rate) over windowed registry
  snapshots with a pending→firing→resolved lifecycle
* :mod:`.usage`    — per-tenant usage metering (``usage.jsonl``) and
  quota enforcement (``PPTPU_QUOTAS``)
* :mod:`.flight`   — flight recorder: always-on bounded in-memory
  ring of recent events that freezes into postmortem bundles
  (``<run>/postmortem/``) on OOM/watchdog/quarantine/alert triggers
* :mod:`.tracing`  — distributed tracing: ``trace_id`` / ``span_id``
  / ``parent_span_id`` on every span and event via a thread-ambient
  context, ``traceparent`` carriers across processes
* :mod:`.merge`    — multi-process shard merge: per-process
  ``events.<proc>.jsonl`` + ``manifest.<proc>.json`` shards into one
  run (span paths prefixed by process, counters summed)

Everything here is host-side: a span that times device work marks its
result (``sp.block(x)``) so the card is synchronized before the span
closes; nothing here runs inside a kernel or a CUDA graph capture.
"""

from . import (devtime, flight, health, memory, metrics,  # noqa: F401
               monitor, quality, tracing, usage)
from .core import (Recorder, configure, counter, current, enabled,
                   event, fit_telemetry, gauge, list_event_files,
                   obs_dir, obs_max_bytes, phases, run, scoped_run,
                   span)
from .merge import merge_obs_shards
from .trace import trace_capture, trace_dir

__all__ = ["Recorder", "configure", "counter", "current", "devtime",
           "enabled", "event", "fit_telemetry", "flight", "gauge",
           "health", "list_event_files", "memory", "merge_obs_shards",
           "metrics", "obs_dir", "obs_max_bytes", "phases", "quality",
           "run", "scoped_run", "span", "trace_capture", "trace_dir",
           "monitor", "tracing", "usage"]
