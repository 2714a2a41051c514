"""The port's device-mesh layer (``parallel/mesh.py``, the sharded fit in
``fit/portrait.py``, ``parallel/sharded_fit.py`` and
``multihost.global_mesh`` / ``distributed_sweep_fit``) against the
unsharded port and the JAX package.

Meshes of eight CPU devices, as the reference's tests build them: the
port names the CPU eight times (``make_mesh(devices=["cpu"] * 8)``), the
reference uses its eight virtual devices (tests/conftest.py).  For a
given init a sharded fit equals the unsharded port's on every field (chi2
within 1e-12: its data power is a sum of per-shard partials), rc and
nfeval per lane included; against the reference it keeps the reference's
own sharded tolerances (phi and DM 1e-8, snr 1e-6 relative, TOAs 1 ns).
The reference's sharded programs run once per module (module fixtures).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.ops.fourier import get_bin_centers, rotate_data
from pulseportraiture_tpu.ops.profiles import gen_gaussian_portrait
from pulseportraiture_tpu.parallel import mesh as jmesh
from pulseportraiture_tpu.parallel import sharded_fit as jsf
from pulseportraiture_tpu_torch.fit import portrait as tfp
from pulseportraiture_tpu_torch.parallel import mesh as tmesh
from pulseportraiture_tpu_torch.parallel import multihost as tmh
from pulseportraiture_tpu_torch.parallel import sharded_fit as tsf
from test_torch_fit import _compare_scat_fits, _scat_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_PARAMS = np.array([0.0, 0.0, 0.35, -0.05, 0.05, 0.1, 1.0, -1.2])
CPU8 = ["cpu"] * 8
MESHES = [(8, 1, 1), (4, 2, 1), (2, 2, 2), (1, 8, 1), (1, 1, 8)]
FLAGS = (1, 1, 0, 0, 0)
# every result field but chi2: bit-equal to the unsharded port
EXACT = [k for k in tfp.RESULT_KEYS if k not in ("chi2", "red_chi2")]


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever test
    process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


@pytest.fixture(scope="module")
def problem():
    """The reference's sharding problem (tests/test_sharding.py): 8 x 16
    x 128, phases in +-0.1 rot, dDMs in +-1e-3, noise 0.005."""
    nsub, nchan, nbin = 8, 16, 128
    freqs = np.linspace(1300.0, 1700.0, nchan)
    phases = np.asarray(get_bin_centers(nbin))
    model = np.asarray(gen_gaussian_portrait("000", MODEL_PARAMS, -4.0,
                                             phases, freqs, 1500.0))
    rng = np.random.default_rng(11)
    P0 = 0.005
    phis = rng.uniform(-0.1, 0.1, nsub)
    dDMs = rng.uniform(-1e-3, 1e-3, nsub)
    data = np.stack([
        np.asarray(rotate_data(model, -phis[i], -dDMs[i], P0, freqs,
                               freqs.mean()))
        for i in range(nsub)]) + rng.normal(0, 0.005, (nsub, nchan, nbin))
    errs = np.full((nsub, nchan), 0.005)
    init = np.zeros((nsub, 5))
    init[:, 0] = phis + rng.normal(0, 0.005, nsub)
    return dict(data=data, model=model, init=init, P0=P0, freqs=freqs,
                errs=errs, phis=phis, dDMs=dDMs)


def _args(p, init="given"):
    return (p["data"], p["model"][None], p["init"] if init == "given"
            else None, p["P0"], p["freqs"])


@pytest.fixture(scope="module")
def unsharded(problem):
    """The unsharded port and the reference on the problem, given init
    and seeded."""
    out = {}
    for init in ("given", "seeded"):
        kw = dict(errs=problem["errs"]) if init == "given" else {}
        out["port", init] = tfp.fit_portrait_full_batch(
            *_args(problem, init), fit_flags=FLAGS, log10_tau=False,
            device="cpu", **kw)
        out["ref", init] = {k: np.asarray(v) for k, v in
                            jfp.fit_portrait_full_batch(
                                *_args(problem, init), fit_flags=FLAGS,
                                log10_tau=False, **kw).items()}
    return out


def _assert_port_equal(got, want, what):
    """Every field bit-equal to the unsharded port's, chi2 within 1e-12
    relative; rc and nfeval equal per lane."""
    for key in EXACT:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   equal_nan=True, msg=lambda m: "%s %s: %s"
                                   % (what, key, m))
    for key in ("chi2", "red_chi2"):
        torch.testing.assert_close(got[key], want[key], rtol=1e-12, atol=0,
                                   msg=lambda m: "%s %s: %s"
                                   % (what, key, m))


def _assert_ref_close(got, ref, P0, what):
    """The reference's own sharded tolerances: phi and DM within 1e-8,
    snr 1e-6 relative, TOAs (phi x P) within 1 ns."""
    phi = got["phi"].numpy()
    np.testing.assert_allclose(phi, ref["phi"], rtol=0, atol=1e-8,
                               err_msg=what)
    np.testing.assert_allclose(got["DM"].numpy(), ref["DM"], rtol=0,
                               atol=1e-8, err_msg=what)
    np.testing.assert_allclose(got["snr"].numpy(), ref["snr"], rtol=1e-6,
                               err_msg=what)
    dphi = (phi - ref["phi"] + 0.5) % 1.0 - 0.5
    assert np.abs(dphi).max() * P0 < 1e-9, (what, dphi)


# -- make_mesh and shard_batch ----------------------------------------------

def test_make_mesh_shapes():
    """Shapes, axis names and the ValueError of the reference's make_mesh
    over eight devices; without CUDA and without ``devices`` the port
    refuses (its device policy)."""
    for shape in [(4, 2, 1), (2, 2, 2), (None, 1, 1), (None, 4, 2)]:
        n_sub, n_chan, n_bin = shape
        t = tmesh.make_mesh(n_sub, n_chan, n_bin, devices=CPU8)
        r = jmesh.make_mesh(n_sub, n_chan, n_bin)
        assert t.devices.shape == r.devices.shape, shape
        assert t.axis_names == r.axis_names == ("subint", "chan", "bin")
        assert dict(t.shape) == dict(r.shape)
        assert all(d == torch.device("cpu") for d in t.devices.flat)
    for bad in [(3, 2, 1), (None, 3, 1), (1, 1, 16)]:
        with pytest.raises(ValueError) as te:
            tmesh.make_mesh(*bad, devices=CPU8)
        with pytest.raises(ValueError) as re_:
            jmesh.make_mesh(*bad)
        assert str(te.value) == str(re_.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()


def test_shard_batch_placement(problem):
    """Each block of data [8, 16, 128] and errs [8, 16] on a (4, 2, 1)
    mesh: its device, mesh coordinates, index and values, against the
    reference's shards of the same arrays on the same mesh shape."""
    data, errs = problem["data"], problem["errs"]
    t = tmesh.make_mesh(4, 2, 1, devices=CPU8)
    r = jmesh.make_mesh(n_subint=4, n_chan=2)
    d_sh, e_sh = tmesh.shard_batch(t, data, errs=errs)
    rd, re_ = jmesh.shard_batch(r, data, errs=errs)
    for got, ref, x in ((d_sh, rd, data), (e_sh, re_, errs)):
        assert got.shape == x.shape and len(got.shards) == 8
        want = {}
        for s in ref.addressable_shards:
            coords = tuple(int(c) for c in
                           np.argwhere(r.devices == s.device)[0])
            want[coords] = tuple((sl.start or 0, sl.stop or n) for sl, n in
                                 zip(s.index, x.shape))
        for s in got.shards:
            assert s.device == torch.device("cpu")
            assert t.devices[s.coords] == s.device
            span = tuple((sl.start or 0, sl.stop or n) for sl, n in
                         zip(s.index, x.shape))
            assert span == want[s.coords], (s.coords, span)
            np.testing.assert_array_equal(s.data.numpy(), x[s.index])
        np.testing.assert_array_equal(got.gather("cpu").numpy(), x)
    # bins split too: a cell joins its bin shards on its device
    m3 = tmesh.make_mesh(2, 2, 2, devices=CPU8)
    d3 = tmesh.shard_batch(m3, data)
    assert d3.block((1, 0, 1)).data.shape == (4, 8, 64)
    np.testing.assert_array_equal(d3.cell(1, 1).numpy(), data[4:, 8:])
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(tmesh.make_mesh(1, 3, 1, devices=["cpu"] * 3),
                          data)


# -- the sharded fit ----------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES)
def test_sharded_fit_equals_unsharded_port(problem, unsharded, shape):
    mesh = tmesh.make_mesh(*shape, devices=CPU8)
    out = tsf.sharded_fit_portrait_batch(
        mesh, *_args(problem), errs=problem["errs"], fit_flags=FLAGS,
        log10_tau=False)
    assert out.phi.device == mesh.first
    _assert_port_equal(out, unsharded["port", "given"], shape)


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_fit_matches_reference(problem, unsharded, shape):
    out = tsf.sharded_fit_portrait_batch(
        tmesh.make_mesh(*shape, devices=CPU8), *_args(problem),
        errs=problem["errs"], fit_flags=FLAGS, log10_tau=False)
    _assert_ref_close(out, unsharded["ref", "given"], problem["P0"], shape)
    assert np.max(np.abs(out.phi.numpy() - problem["phis"])) < 5e-3


def test_sharded_fit_matches_reference_sharded(problem):
    """Once against the reference's own sharded program, (4, 2, 1)."""
    ref = jsf.sharded_fit_portrait_batch(
        jmesh.make_mesh(n_subint=4, n_chan=2), *_args(problem),
        errs=problem["errs"], fit_flags=FLAGS, log10_tau=False)
    out = tsf.sharded_fit_portrait_batch(
        tmesh.make_mesh(4, 2, 1, devices=CPU8), *_args(problem),
        errs=problem["errs"], fit_flags=FLAGS, log10_tau=False)
    _assert_ref_close(out, {k: np.asarray(v) for k, v in ref.items()},
                      problem["P0"], "reference sharded (4, 2, 1)")


def test_sharded_scattering_fit(rng):
    """fit_scat flags (1,1,0,1,1) with log10 tau on a scattered batch
    (4 x 32 x 256) over a (2, 2, 1) mesh: K3 per channel shard (its
    plain version here) gives the unsharded port's fit, and the
    reference's within the scattering parity bounds."""
    args, kw = _scat_case(rng, (1, 1, 0, 1, 1), True)
    want = tfp.fit_portrait_full_batch(*args, device="cpu", **kw)
    calls = []
    mesh = tmesh.make_mesh(2, 2, 1, devices=["cpu"] * 4)
    saved = tfp._kernels.moments_scat

    def count(cross, *a, **k):
        calls.append(tuple(cross.shape))
        return saved(cross, *a, **k)

    tfp._kernels.moments_scat = count
    try:
        got = tfp.fit_portrait_full_batch(*args, mesh=mesh, **kw)
    finally:
        tfp._kernels.moments_scat = saved
    assert calls and set(calls) == {(2, 16, 128)}, set(calls)
    _assert_port_equal(got, want, "fit_scat (2, 2, 1)")
    ref = jfp.fit_portrait_full_batch(*args, **kw)
    _compare_scat_fits(ref, got, "fit_scat (2, 2, 1)")


@pytest.mark.parametrize("shape", [(4, 2, 1), (2, 2, 2)])
def test_seeded_sharded_fit(problem, unsharded, shape):
    """init_params=None: band averages summed over channel shards, K2 once
    per subint group; within 1e-8 rot and 1 ns of the unsharded port and
    of the reference, and the injection recovered."""
    out = tfp.fit_portrait_full_batch(
        *_args(problem, "seeded"), fit_flags=FLAGS, log10_tau=False,
        mesh=tmesh.make_mesh(*shape, devices=CPU8))
    port = unsharded["port", "seeded"]
    np.testing.assert_allclose(out.phi.numpy(), port.phi.numpy(), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(out.DM.numpy(), port.DM.numpy(), rtol=0,
                               atol=1e-8)
    _assert_ref_close(out, unsharded["ref", "seeded"], problem["P0"], shape)
    assert np.max(np.abs(out.phi.numpy() - problem["phis"])) < 5e-3


def test_ipta_sweep_fit(problem, unsharded):
    """A (pulsar 2, epoch 4) sweep over eight CPU devices: the unsharded
    port's fit of the flattened batch."""
    sweep = problem["data"].reshape(2, 4, 16, 128)
    out = tsf.ipta_sweep_fit(sweep, problem["model"][None], problem["init"],
                             problem["P0"], problem["freqs"],
                             errs=problem["errs"].reshape(2, 4, 16),
                             fit_flags=FLAGS, devices=CPU8)
    assert out.phi.shape == (8,)
    want = tfp.fit_portrait_full_batch(
        *_args(problem), errs=problem["errs"], fit_flags=FLAGS,
        log10_tau=False, device="cpu")
    _assert_port_equal(out, want, "ipta (8, 1, 1)")
    assert np.max(np.abs(out.phi.numpy() - problem["phis"])) < 5e-3


# -- multihost: global_mesh and distributed_sweep_fit ------------------------

def test_multihost_single_process_path(problem, unsharded):
    """The reference's single-process inputs: initialize() a no-op, the
    mesh over eight devices with n_chan 2, distributed_sweep_fit (the
    local block is the batch) equal to sharded_fit_portrait_batch and
    the unsharded port, its global rows 0..7; seeded, the injection."""
    tmh.initialize()
    assert tmh.process_count() == 1 and tmh.process_index() == 0
    mesh = tmh.global_mesh(n_chan=2, devices=CPU8)
    assert mesh.devices.size == 8 and mesh.devices.shape == (4, 2, 1)
    out = tmh.distributed_sweep_fit(
        mesh, *_args(problem), errs=problem["errs"], fit_flags=FLAGS,
        log10_tau=False)
    assert out.global_rows.tolist() == list(range(8))
    _assert_port_equal(out, unsharded["port", "given"], "distributed")
    _assert_port_equal(out, tsf.sharded_fit_portrait_batch(
        mesh, *_args(problem), errs=problem["errs"], fit_flags=FLAGS,
        log10_tau=False), "distributed vs sharded_fit")
    _assert_ref_close(out, unsharded["ref", "given"], problem["P0"],
                      "distributed")
    seeded = tmh.distributed_sweep_fit(
        mesh, *_args(problem, "seeded"), errs=problem["errs"],
        fit_flags=FLAGS, log10_tau=False)
    assert np.max(np.abs(seeded.phi.numpy() - problem["phis"])) < 5e-3


# each rank of a two-process gloo group: first a block-size mismatch (rank
# 1 passes 3 rows), then its half of the sweep on a mesh of four CPU
# devices (seeded, drifting periods, global freqs); one JSON line out
WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[4])
import numpy as np
import torch
torch.set_num_threads(1)
from pulseportraiture_tpu_torch.parallel import multihost
rank, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
multihost.initialize("127.0.0.1:%d" % port, num_processes=2,
                     process_id=rank, backend="gloo", timeout_s=120)
z = np.load(path)
B = z["data"].shape[0]
mine = slice(rank * B // 2, (rank + 1) * B // 2)
mesh = multihost.global_mesh(n_chan=2, devices=["cpu"] * 4)
out = {"rank": rank}
try:
    multihost.distributed_sweep_fit(
        mesh, z["data"][mine][:3 + (rank == 0)], z["model"], None,
        z["Ps"][mine], z["freqs"])
except ValueError as e:
    out["mismatch"] = str(e)
res = multihost.distributed_sweep_fit(
    mesh, z["data"][mine], z["model"], None, z["Ps"][mine], z["freqs"])
out["rows"] = res.global_rows.tolist()
out["fields"] = {k: res[k].tolist() for k in ("phi", "DM", "phi_err",
                                              "snr", "nfeval")}
print(json.dumps(out), flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_sweep(tmp_path):
    """Two processes on gloo, each fitting its half of the reference's
    two-process sweep (8 x 16 x 64 from the reference's
    make_fake_dataset, drifting periods, seeded): the reassembled rows
    equal the single-process port's fit and are within 1e-7 / 1e-6
    (phi / DM) of the reference's; a block-size mismatch raises the
    reference's ValueError on both ranks."""
    import jax

    from pulseportraiture_tpu.pipelines.synth import make_fake_dataset

    ds = make_fake_dataset(jax.random.key(7), MODEL_PARAMS, nsub=8,
                           nchan=16, nbin=64, noise_std=0.01)
    model = np.asarray(gen_gaussian_portrait(
        ds.model_code, MODEL_PARAMS, -4.0, get_bin_centers(64), ds.freqs,
        ds.nu_ref))
    data = np.asarray(ds.subints)
    Ps = np.full(8, 0.005) * (1.0 + 1e-6 * np.arange(8))
    freqs = np.broadcast_to(np.asarray(ds.freqs), (8, 16))
    path = str(tmp_path / "sweep.npz")
    np.savez(path, data=data, model=model, Ps=Ps, freqs=freqs)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(port), path, ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for rank in (0, 1)]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, se[-3000:]
        outs.append(json.loads(so.strip().splitlines()[-1]))
    for o in outs:
        assert o["mismatch"] == (
            "distributed_sweep_fit needs identical per-process block "
            "sizes; got [4, 3] — pad the short blocks with zero-weight "
            "rows.")
    rows = {}
    for o in outs:
        for n, i in enumerate(o["rows"]):
            rows[i] = {k: v[n] for k, v in o["fields"].items()}
    assert sorted(rows) == list(range(8))
    got = {k: np.array([rows[i][k] for i in range(8)])
           for k in outs[0]["fields"]}
    single = tmh.distributed_sweep_fit(
        tmh.global_mesh(n_chan=2, devices=CPU8), data, model, None, Ps,
        freqs)
    for k, v in got.items():
        np.testing.assert_array_equal(v, single[k].numpy(), err_msg=k)
    ref = jfp.fit_portrait_full_batch(data, model, None, Ps, freqs)
    np.testing.assert_allclose(got["phi"], np.asarray(ref.phi), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(got["DM"], np.asarray(ref.DM), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(ds.phases_inj), got["phi"],
                               atol=5e-3)
