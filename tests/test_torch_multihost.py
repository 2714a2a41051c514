"""The port's process layer (``parallel/multihost.py``) against the JAX
package's.

``partition_indices``, ``straggler_ids`` and the straggler parsing agree
with the reference on the same inputs; single-process the barrier is a
no-op and an injected ``barrier`` hang becomes a ``BarrierTimeout``
through the reference's thread-join path.  Two real processes on gloo
(subprocesses, as tests/_multihost_worker.py runs the reference): one
rank never reaches the barrier, and rank 0's
``torch.distributed.monitored_barrier`` names it in
``BarrierTimeout.missing``.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from pulseportraiture_tpu.parallel import multihost as jmh
from pulseportraiture_tpu_torch.parallel import multihost as tmh
from pulseportraiture_tpu_torch.testing import faults
from pulseportraiture_tpu_torch.testing.faults import InjectedFault

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("PPTPU_FAULTS", raising=False)
    faults.reset()
    yield
    faults.reset()


@pytest.mark.parametrize("n,pid,nproc", [(0, 0, 1), (10, 0, 1),
                                         (10, 0, 3), (10, 2, 3),
                                         (7, 3, 4), (3, 3, 4), (12, 1, 2)])
def test_partition_indices_equal(n, pid, nproc):
    assert tmh.partition_indices(n, process_id=pid, num_processes=nproc) \
        == jmh.partition_indices(n, process_id=pid, num_processes=nproc)


def test_partition_indices_rejects_bad_ids():
    for mod in (tmh, jmh):
        with pytest.raises(ValueError, match="outside"):
            mod.partition_indices(4, process_id=2, num_processes=2)


@pytest.mark.parametrize("missing", ["unknown", [1, "2", None, 3.0], (4,),
                                     []])
def test_straggler_ids_equal(missing):
    assert tmh.straggler_ids(missing) == jmh.straggler_ids(missing)


@pytest.mark.parametrize("text", [
    "DEADLINE_EXCEEDED: Barrier timed out. Tasks: /job:jax_worker/"
    "replica:0/task:2 did not arrive",
    "process 1 and process 3 never reached barrier",
    "task_id: 5 missing",
    "something else entirely",
])
def test_missing_processes_equal_on_reference_texts(text):
    assert tmh._missing_processes(text) == jmh._missing_processes(text)


@pytest.mark.parametrize("text,want", [
    ("Rank 1 failed to pass monitoredBarrier in 2000 ms", [1]),
    ("[Rank 0]: Ranks 1, 3 failed to pass monitoredBarrier in 0:00:02",
     [1, 3]),
    ("Connection closed by peer", "unknown"),
])
def test_missing_processes_reads_monitored_barrier(text, want):
    assert tmh._missing_processes(text) == want


def test_single_process_defaults():
    assert tmh.process_count() == 1 and tmh.process_index() == 0
    assert tmh.partition_indices(5) == [0, 1, 2, 3, 4]
    tmh.initialize()  # no cluster environment: stays local
    assert tmh.process_count() == 1
    tmh.barrier("single")                  # no-op
    tmh.barrier("single", timeout_s=0.5)   # thread-join path, passes


def test_barrier_injected_hang_times_out():
    faults.configure("site:barrier@nth=1,hang=5")
    t0 = time.monotonic()
    with pytest.raises(tmh.BarrierTimeout) as ei:
        tmh.barrier("pptpu_runner_merge", timeout_s=0.3)
    assert time.monotonic() - t0 < 3.0
    assert ei.value.name == "pptpu_runner_merge"
    assert ei.value.missing == "unknown"
    assert str(ei.value) == str(jmh.BarrierTimeout(
        "pptpu_runner_merge", 0.3))
    faults.reset()
    tmh.barrier("pptpu_runner_merge", timeout_s=0.3)


def test_barrier_injected_failure_propagates():
    faults.configure("site:barrier@nth=1")
    with pytest.raises(InjectedFault):
        tmh.barrier("pptpu_runner_merge", timeout_s=1.0)


# one process of a two-rank gloo group: rank 1 sleeps past rank 0's
# barrier timeout; each rank prints one JSON line with what it saw
WORKER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[4])
from pulseportraiture_tpu_torch.parallel import multihost
rank, port, straggle = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
multihost.initialize("127.0.0.1:%d" % port, num_processes=2,
                     process_id=rank, backend="gloo", timeout_s=60)
out = {"rank": multihost.process_index(),
       "count": multihost.process_count(),
       "share": multihost.partition_indices(5)}
multihost.barrier("warmup", timeout_s=30)
if straggle == "1" and rank == 1:
    time.sleep(6.0)
try:
    multihost.barrier("pptpu_runner_merge", timeout_s=2.0)
    out["timeout"] = None
except multihost.BarrierTimeout as e:
    out["timeout"] = {"name": e.name, "missing": e.missing}
print(json.dumps(out), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(straggle):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("PPTPU_FAULTS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(port),
         "1" if straggle else "0", ROOT], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for rank in (0, 1)]
    outs = {}
    for p in procs:
        so, se = p.communicate(timeout=120)
        assert p.returncode == 0, se[-3000:]
        rec = json.loads(so.strip().splitlines()[-1])
        outs[rec["rank"]] = rec
    return outs


@pytest.mark.parametrize("straggle", [False, True],
                         ids=["all_arrive", "rank1_straggles"])
def test_two_process_gloo_barrier(straggle):
    """Two ranks on gloo: both see a group of two and their round-robin
    shares; with rank 1 late, rank 0's monitored barrier times out and
    names rank 1 as missing, and rank 1's barrier times out too."""
    outs = _run_pair(straggle)
    assert outs[0]["count"] == outs[1]["count"] == 2
    assert outs[0]["share"] == [0, 2, 4] and outs[1]["share"] == [1, 3]
    if not straggle:
        assert outs[0]["timeout"] is None and outs[1]["timeout"] is None
    else:
        t0 = outs[0]["timeout"]
        assert t0 is not None and t0["name"] == "pptpu_runner_merge"
        assert t0["missing"] == [1]
        assert tmh.straggler_ids(t0["missing"]) == [1]
        # the late rank finds its peers gone: a timeout, not a crash
        t1 = outs[1]["timeout"]
        assert t1 is not None and t1["name"] == "pptpu_runner_merge"
