"""Run-manifest assembly: the who/what/where record of one run.

A manifest is the JSON sidecar of a run's event stream: enough static
context (device platform, shapes/dtypes/config the caller passes, git
SHA, argv, relevant PPTPU_* environment) that a committed
``manifest.json`` + ``events.jsonl`` pair is self-describing evidence
— the reader never has to reconstruct "what was this run?" from shell
history, which is exactly how the hand-maintained PERF.md tables used
to decay.

Everything here is best-effort and exception-free: telemetry must
never be the thing that kills a pipeline, so unavailable fields are
recorded as a short error string instead of raised.
"""

import os
import subprocess
import sys
import time

__all__ = ["build_manifest", "device_info", "git_sha"]

_ENV_KEYS_PREFIX = "PPTPU_"
_ENV_KEYS_EXTRA = ("CUDA_VISIBLE_DEVICES", "PYTORCH_CUDA_ALLOC_CONF")


_GIT_SHA_CACHE = []  # [sha-or-None] once resolved


def git_sha():
    """HEAD commit of the repo this package lives in, or None.

    Memoized after the first lookup: a process may open many runs
    (and hence manifests), and a git subprocess per run would dominate
    a small run.  HEAD moving under a live process is not a case worth
    a stale-cache defense.
    """
    if _GIT_SHA_CACHE:
        return _GIT_SHA_CACHE[0]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sha = None
    try:
        out = subprocess.run(
            ["git", "-C", root, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            sha = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    _GIT_SHA_CACHE.append(sha)
    return sha


def device_info():
    """Platform/device facts of the run without initializing CUDA.

    ``platform`` is ``gpu`` once this process has initialized CUDA (a
    run on the card always has by the time its manifest is rewritten
    at close), with the card's name (``device_kind``), the device count
    and the first card's memory; otherwise ``cpu``.  Reading them for a
    run on the CPU must not initialize CUDA, so an uninitialized
    process is reported as ``cpu`` without asking the driver.  A torch
    failure is recorded as a short error string, never raised."""
    info = {}
    try:
        import torch

        info["torch_version"] = torch.__version__
        info["cuda_version"] = torch.version.cuda
        if torch.cuda.is_initialized():
            props = torch.cuda.get_device_properties(0)
            info.update(platform="gpu",
                        device_count=torch.cuda.device_count(),
                        device_kind=props.name,
                        device_memory_bytes=int(props.total_memory))
        else:
            info.update(platform="cpu", device_count=1,
                        device_kind="cpu")
    except Exception as e:
        info["torch_error"] = str(e)[:500]
    return info


def build_manifest(name, run_id, config=None):
    """The open-time manifest dict for a run (the recorder rewrites it
    at close with counters/durations merged in)."""
    env = {k: v for k, v in os.environ.items()
           if k.startswith(_ENV_KEYS_PREFIX) or k in _ENV_KEYS_EXTRA}
    m = {
        "schema": "pptpu-obs-v1",
        "name": name,
        "run_id": run_id,
        "t_start": time.time(),
        "argv": list(sys.argv),
        "cwd": os.getcwd(),
        "pid": os.getpid(),
        "git_sha": git_sha(),
        "env": env,
        "config": dict(config or {}),
    }
    m.update(device_info())
    return m
