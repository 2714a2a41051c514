"""Multi-process scale-out on ``torch.distributed``: the port of the JAX
package's ``parallel/multihost.py``.

A survey scales by running one ``ppsurvey run`` process per card (or
per host); the processes share nothing but the workdir's ledger shards,
split the plan round-robin (:func:`partition_indices`) and meet once,
at a bounded barrier before process 0 merges the obs shards
(:func:`barrier`).  One sharded sweep spans processes the way the
reference spans hosts: each process fits its own block of the batch on
its local device mesh (:func:`global_mesh`), so the process group
carries only the batch axis and no inner-loop communication crosses
processes (:func:`distributed_sweep_fit`).  Typical use on each process
of a job started by ``torchrun`` (which sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``):

    from pulseportraiture_tpu_torch.parallel import multihost
    multihost.initialize()                   # no-op when single-process
    mine = multihost.partition_indices(n)    # this process's share
    multihost.barrier("done", timeout_s=60)  # BarrierTimeout names stragglers
    mesh = multihost.global_mesh()           # this process's devices
    out = multihost.distributed_sweep_fit(   # this process's block in,
        mesh, local_data, model, ...)        # its rows + global indices out
"""

import datetime
import os
import re
import threading

from ..testing import faults

__all__ = ["initialize", "global_mesh", "distributed_sweep_fit",
           "process_count", "process_index", "partition_indices",
           "barrier", "BarrierTimeout", "straggler_ids"]

# the gloo group monitored_barrier runs on (created beside an NCCL
# default group when needed: monitored_barrier is gloo-only)
_GLOO = {"group": None}
_GLOO_LOCK = threading.Lock()


def _dist():
    """torch.distributed when it is available and initialized, else
    None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, timeout_s=None):
    """``torch.distributed.init_process_group``; a no-op single-process.

    With no arguments the group comes from the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``);
    with ``WORLD_SIZE`` unset or 1 nothing is initialized.  Explicit
    arguments are for manual bring-up: ``coordinator_address``
    ``'host:port'``, the process count and this process's rank.
    ``backend`` defaults to NCCL when CUDA is available, else gloo.
    Safe to call more than once.
    """
    import torch
    import torch.distributed as dist

    if not dist.is_available() or dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if world <= 1 or "MASTER_ADDR" not in os.environ:
            return  # single-process run with no cluster env: stay local
        init_method = "env://"
        num_processes = world
        process_id = int(os.environ.get("RANK", "0") or 0)
    else:
        init_method = "tcp://%s" % coordinator_address
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=int(num_processes),
                            rank=int(process_id or 0), **kw)


def process_count():
    """The process group's world size (1 when none is initialized)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None else 1


def process_index():
    """This process's rank (0 when no group is initialized)."""
    dist = _dist()
    return dist.get_rank() if dist is not None else 0


def partition_indices(n, process_id=None, num_processes=None):
    """This process's work-item indices under deterministic round-robin
    partitioning of ``n`` items across processes.

    Every process derives the same global assignment from the same
    item order with no communication — the way to split an
    embarrassingly parallel survey (the runner partitions its plan's
    bucket-major archive order this way, runner/execute.py).  Explicit
    ``process_id``/``num_processes`` support simulated multi-process
    runs in one process; the defaults ask the process group.
    """
    if num_processes is None:
        num_processes = process_count()
    if process_id is None:
        process_id = process_index()
    num_processes = max(1, int(num_processes))
    process_id = int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    return list(range(process_id, int(n), num_processes))


class BarrierTimeout(RuntimeError):
    """A named barrier timed out; carries which processes never arrived
    (when the process group can name them, else "unknown").

    The runner treats this as a survivable condition: a preempted or
    wedged straggler must not wedge every *other* process of a job
    forever (docs/RUNNER.md failure-modes matrix).
    """

    def __init__(self, name, timeout_s, missing="unknown"):
        self.name = name
        self.timeout_s = float(timeout_s)
        self.missing = missing
        super().__init__(
            "barrier %r timed out after %.1fs (missing: %s)"
            % (name, float(timeout_s), missing))


def straggler_ids(missing):
    """Normalize :attr:`BarrierTimeout.missing` to a list of process
    ids ([] for ``"unknown"``).

    The runner feeds these into lease revocation
    (``WorkQueue.revoke_owner``): a process the barrier names as never
    having arrived is presumed dead or wedged, so its ``running``
    leases are returned to the pool for the survivors (or the next
    resume, of any process count) to claim — docs/RUNNER.md
    "Elasticity".  With an unnameable straggler nothing is revoked; its
    leases simply expire.
    """
    if isinstance(missing, (list, tuple)):
        out = []
        for m in missing:
            try:
                out.append(int(m))
            except (TypeError, ValueError):
                continue
        return out
    return []


# torch.distributed.monitored_barrier's timeout text on rank 0, e.g.
# "Ranks 1, 3 failed to pass monitoredBarrier in 2000 ms"
_MONITORED_RE = re.compile(r"Ranks?\s+([\d,\s]+?)\s+failed to pass "
                           r"monitoredBarrier", re.IGNORECASE)


def _missing_processes(err_text):
    """Straggler process ids parsed from a barrier's timeout error, or
    "unknown": ``monitored_barrier``'s "Ranks 1, 3 failed to pass
    monitoredBarrier" text, else the reference's coordination-service
    pattern ("process 1", "task_id: 1", ...)."""
    m = _MONITORED_RE.search(err_text)
    if m:
        ids = sorted({int(x) for x in re.findall(r"\d+", m.group(1))})
        if ids:
            return ids
    ids = sorted({int(m) for m in re.findall(
        r"(?:process|task)[_\s]*(?:id)?[:=\s/]*(\d+)", err_text,
        re.IGNORECASE)})
    return ids or "unknown"


def _is_timeout(err_text):
    """True when a timed barrier's error means it did not complete in
    time: a timeout, or (on a late rank) the peers having already given
    up and closed their connections.  Other errors propagate."""
    t = err_text.lower()
    return any(k in t for k in ("monitoredbarrier", "timed out",
                                "timeout", "deadline",
                                "connection closed", "connection reset"))


def _gloo_group():
    """The gloo process group for ``monitored_barrier``: the default
    group when it is gloo, else one new gloo group over every rank
    (created once; every rank must reach this call)."""
    dist = _dist()
    if dist.get_backend() == "gloo":
        return None  # the default group
    with _GLOO_LOCK:
        if _GLOO["group"] is None:
            _GLOO["group"] = dist.new_group(backend="gloo")
        return _GLOO["group"]


def barrier(name="pptpu_barrier", timeout_s=None):
    """Block until every process reaches this point (no-op when
    single-process).  The runner uses it before process 0 merges the
    per-process obs shards, so no shard is read mid-write.

    With ``timeout_s``, a straggler becomes a :class:`BarrierTimeout`
    instead of an unbounded wedge.  In a multi-process group the barrier
    is ``torch.distributed.monitored_barrier`` on a gloo group, whose
    timeout names the ranks that never arrived
    (``BarrierTimeout.missing``; on rank 0, which monitors the others).
    Single-process, or with the chaos harness active, arrival runs in a
    watchdogged thread, which makes the timeout path exercisable through
    the ``barrier`` fault site (an injected hang simulates the
    straggler).
    """

    def _arrive():
        # chaos site: hang= simulates a straggler, fail= a torn link
        faults.check("barrier", key=name)
        dist = _dist()
        if dist is not None and dist.get_world_size() > 1:
            dist.barrier(group=_gloo_group())

    if timeout_s is None:
        _arrive()
        return
    dist = _dist()
    if dist is not None and dist.get_world_size() > 1 \
            and not faults.active():
        try:
            dist.monitored_barrier(
                group=_gloo_group(),
                timeout=datetime.timedelta(seconds=float(timeout_s)),
                wait_all_ranks=True)
            return
        except RuntimeError as e:
            if not _is_timeout(str(e)):
                raise
            raise BarrierTimeout(
                name, timeout_s,
                missing=_missing_processes(str(e))) from e
    # thread-join path: single-process and the fault-injection path.  A
    # timed-out arrival thread is abandoned (daemon) — it either raises
    # into the void or dies with the process.
    box = {}

    def _run():
        try:
            _arrive()
        except BaseException as e:  # surfaced below, incl. InjectedFault
            box["err"] = e

    t = threading.Thread(target=_run, daemon=True,
                         name="pptpu-barrier-%s" % name)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise BarrierTimeout(name, timeout_s)
    if "err" in box:
        raise box["err"]


def global_mesh(n_chan=1, n_bin=1, devices=None):
    """('subint', 'chan', 'bin') mesh over this process's devices (every
    visible CUDA device by default; on a host running several processes,
    give each its own, by ``devices`` or ``CUDA_VISIBLE_DEVICES``).

    The reference's global mesh spans the devices of every host; here the
    process group carries the batch axis (:func:`distributed_sweep_fit`)
    and each process's mesh splits its own block, so the 'chan' and 'bin'
    gathers never leave a process.
    """
    from .mesh import make_mesh

    return make_mesh(n_chan=n_chan, n_bin=n_bin, devices=devices)


def _all_gather(value):
    """Every process's ``value`` (a picklable object), in rank order."""
    dist = _dist()
    if dist is None or dist.get_world_size() == 1:
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def distributed_sweep_fit(mesh, local_data, model_port, init_params, Ps,
                          freqs, errs=None, weights=None,
                          fit_flags=(1, 1, 0, 0, 0), **kw):
    """Fit a process-local block as part of one global batch.

    Every process passes its own [B_local, nchan, nbin] block (epochs /
    pulsars assigned to it — e.g. a slice of a metafile) and fits it on
    its ``mesh`` (:func:`global_mesh`); process p's rows are rows
    ``p * B_local`` to ``(p + 1) * B_local`` of the global batch.  Returns
    this process's DataBunch (on the mesh's first device) with
    ``global_rows``, the rows' global indices: the counterpart of the
    reference's addressable shards.  Single-process it equals
    :func:`~.sharded_fit.sharded_fit_portrait_batch` on the same mesh.

    Every process must pass the SAME block size (pad the last block —
    e.g. with zero-weight rows — when the split is uneven); an all-gather
    over the process group checks it.  Per-row metadata (Ps, freqs, init,
    errs, weights) may be this process's block (leading dimension
    B_local), the global batch's (leading dimension B: its rows are
    taken) or anything broadcastable.  ``init_params=None`` seeds the
    phases in the fit (K2 per subint group); errs=None estimates the
    noise on this process's block.  The scattering kernel's choice is
    all-gathered and OR-ed, so one process with a nonzero tau turns K3 on
    everywhere, as in the reference.
    """
    import numpy as np
    import torch

    from ..fit.portrait import _scat_hint, fit_portrait_full_batch

    B_local = int(local_data.shape[0])
    sizes = _all_gather(B_local)
    if any(n != B_local for n in sizes):
        raise ValueError(
            "distributed_sweep_fit needs identical per-process "
            f"block sizes; got {sizes} — pad the "
            "short blocks with zero-weight rows.")
    nproc, pid = len(sizes), process_index()
    B = B_local * nproc
    mine = slice(pid * B_local, (pid + 1) * B_local)

    def local(x, shape):
        """This process's rows of per-row metadata of global ``shape``."""
        if x is None:
            return None
        arr = x if isinstance(x, torch.Tensor) else np.asarray(x)
        if arr.ndim == len(shape) and arr.shape[1:] == shape[1:] \
                and arr.shape[0] in (B_local, B):
            return arr if arr.shape[0] == B_local else arr[mine]
        return arr

    nchan = local_data.shape[1]
    seed = init_params is None
    if seed:
        init_params = np.zeros(5)
        if kw.get("log10_tau", True):
            init_params[3] = -np.inf
    init_params = local(init_params, (B, 5))
    if "scat_hint" not in kw:
        # every process must take the same moments kernel: one process
        # with a nonzero tau turns the scattering chain on everywhere
        hint = _scat_hint(tuple(fit_flags), init_params,
                          kw.get("log10_tau", True))
        kw["scat_hint"] = any(_all_gather(bool(hint)))
    out = fit_portrait_full_batch(
        local_data, local(model_port, (B,) + tuple(local_data.shape[1:])),
        init_params, local(Ps, (B,)),
        local(freqs, (B, nchan)), errs=local(errs, (B, nchan)),
        weights=local(weights, (B, nchan)), fit_flags=fit_flags,
        seed=seed, mesh=mesh, **kw)
    out["global_rows"] = torch.arange(mine.start, mine.stop,
                                      device=mesh.first)
    return out
