"""The port's fault-injection harness against the JAX package's.

pulseportraiture_tpu_torch.testing.faults copies the JAX package's
harness, the SHA-1 fire decision of probability clauses included, so a
``PPTPU_FAULTS`` spec fires at the same (site, key) pairs in both
packages.  A table of specs runs through both harnesses over the same
sequence of checks (sites and keys from a seeded numpy generator): the
fired lists and the checks that raise must be equal.  Then the same
specs go through both packages' pipelines on the CPU: the archive_read,
dispatch and checkpoint_flush sites fire at the same archives, with the
same outcome and the same ``fault_injected`` events.
"""

import contextlib
import json
import os

import numpy as np
import pytest

from pulseportraiture_tpu.fit import portrait as jfp
from pulseportraiture_tpu.io.archive import make_fake_pulsar
from pulseportraiture_tpu.obs import core as jcore
from pulseportraiture_tpu.pipelines import toas as jtoas
from pulseportraiture_tpu.testing import faults as jfaults
from pulseportraiture_tpu_torch import obs as tobs
from pulseportraiture_tpu_torch.obs import core as tcore
from pulseportraiture_tpu_torch.pipelines import toas as ttoas
from pulseportraiture_tpu_torch.testing import InjectedFault
from pulseportraiture_tpu_torch.testing import faults as tfaults

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")


@pytest.fixture(autouse=True)
def _no_stale_spans():
    """An exception escaping a ``phases`` region leaves its span on the
    thread's span stack, in both packages (ROADMAP Queue C), so a later
    span's path would carry it as a prefix: start and end every test here
    with empty stacks."""
    for core in (jcore, tcore):
        core._tls.stack = []
    yield
    for core in (jcore, tcore):
        core._tls.stack = []


@pytest.fixture(autouse=True)
def _fresh_harnesses(monkeypatch):
    monkeypatch.delenv("PPTPU_FAULTS", raising=False)
    for f in (jfaults, tfaults):
        f.reset()
    yield
    for f in (jfaults, tfaults):
        f.reset()


@pytest.fixture(autouse=True, scope="module")
def _drop_reference_jit_caches():
    """The reference fits add variants to the JAX package's jit caches,
    which tests/test_retrace_budget.py holds to a budget in whatever
    test process runs it next: drop them when the module ends."""
    yield
    jfp._batch_impl.clear_cache()
    jfp._solve.clear_cache()


def _checks(seed, n=60):
    """(site, key) pairs: sites of the harness, keys archive-like paths
    (some repeated, some None)."""
    rng = np.random.default_rng(seed)
    sites = ("archive_read", "dispatch", "checkpoint_flush", "obs_write")
    keys = ["/data/obs/%d.fits" % i for i in range(7)] + [None]
    return [(sites[rng.integers(len(sites))], keys[rng.integers(len(keys))])
            for _ in range(n)]


SPECS = [
    "site:archive_read@0.6",
    "site:archive_read@0.5,seed=7;site:dispatch@0.2,seed=1",
    "site:dispatch@nth=3",
    "site:checkpoint_flush@every=4,times=2",
    "site:obs_write@after=5",
    "site:archive_read@1.0,latency=0.001,times=3;site:dispatch@nth=2",
    "site:dispatch@nth=1,hang=0.01",
    "site:header_scan@0.5;site:barrier@nth=1;sigterm@after=1000",
]


def _drive(faults, spec, checks):
    faults.configure(spec)
    raised = []
    for i, (site, key) in enumerate(checks):
        try:
            faults.check(site, key=key)
        except faults.InjectedFault:
            raised.append(i)
    return faults.fired(), raised, faults.spec_string()


@pytest.mark.parametrize("spec", SPECS)
def test_specs_fire_identically(spec):
    checks = _checks(len(spec))
    ref = _drive(jfaults, spec, checks)
    port = _drive(tfaults, spec, checks)
    assert port == ref
    if "header_scan" not in spec:
        assert port[0], "the spec never fired: the case is vacuous"


@pytest.mark.parametrize("bad", [
    "site:nosuch@0.5", "archive_read@0.5", "site:dispatch@nth=x",
    "site:dispatch", "sigterm@0.5"])
def test_bad_specs_fail_alike(bad):
    msgs = []
    for faults in (jfaults, tfaults):
        with pytest.raises(ValueError) as exc:
            faults.configure(bad)
        msgs.append(str(exc.value))
    assert msgs[1] == msgs[0]


def test_sites_and_hash_decisions_are_the_references():
    assert tfaults.SITES == jfaults.SITES
    rng = np.random.default_rng(5)
    for _ in range(200):
        c = tfaults._Clause("x", site="dispatch")
        c.p, c.seed = float(rng.uniform()), int(rng.integers(100))
        key = "/a/%d.fits" % rng.integers(50)
        jc = jfaults._Clause("x", site="dispatch")
        jc.p, jc.seed = c.p, c.seed
        assert tfaults._Harness._hash_fires(c, "dispatch", key, 1) == \
            jfaults._Harness._hash_fires(jc, "dispatch", key, 1)
    assert issubclass(InjectedFault, RuntimeError)


def test_env_spec_resyncs_and_off_is_inactive(monkeypatch):
    assert not tfaults.active()
    monkeypatch.setenv("PPTPU_FAULTS", "site:dispatch@nth=1")
    with pytest.raises(InjectedFault):
        tfaults.check("dispatch", key="k")
    monkeypatch.delenv("PPTPU_FAULTS")
    tfaults.check("dispatch", key="k")
    assert not tfaults.active()


# -- the pipelines' sites ----------------------------------------------------


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_faults")
    files = []
    for i in range(3):
        out = str(tmp / ("f%d.fits" % i))
        make_fake_pulsar(GMODEL, PAR, out, nsub=2, nchan=8, nbin=64,
                         tsub=60.0, phase=0.1 * i, dDM=1e-3,
                         noise_stds=0.05, seed=60 + i, quiet=True)
        files.append(out)
    return tmp, files


@contextlib.contextmanager
def _env(**kw):
    saved = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _pipeline(tmp, key, files, spec, checkpoint=False):
    """Both packages' get_TOAs under ``spec`` with an obs run: (fired,
    the exception's type name, archives with TOAs, fault_injected
    events)."""
    toas, faults, kw = {"jax": (jtoas, jfaults, {}),
                        "torch": (ttoas, tfaults, {"device": "cpu"})}[key]
    base = str(tmp / key / "".join(c if c.isalnum() else "_"
                                   for c in spec))
    faults.reset()
    gt = toas.GetTOAs(files, GMODEL, quiet=True, **kw)
    err = None
    with _env(PPTPU_FAULTS=spec, PPTPU_OBS_DIR=base):
        try:
            gt.get_TOAs(quiet=True, checkpoint=(base + ".tim")
                        if checkpoint else None)
        except faults.InjectedFault as e:
            err = type(e).__name__
        fired = [(r["site"], os.path.basename(str(r["key"])), r["n"],
                  r["action"]) for r in faults.fired()]
    (run,) = os.listdir(base)
    events = []
    for path in tobs.list_event_files(os.path.join(base, run)):
        with open(path) as fh:
            events += [json.loads(ln) for ln in fh if ln.strip()]
    injected = [(e["site"], os.path.basename(str(e["key"])), e["n"])
                for e in events if e.get("name") == "fault_injected"]
    return (fired, err, sorted({os.path.basename(t.archive)
                                for t in gt.TOA_list}), injected)


@pytest.mark.parametrize("spec,checkpoint", [
    ("site:archive_read@0.5,seed=4", False),
    ("site:dispatch@nth=2", False),
    ("site:checkpoint_flush@nth=1", True)],
    ids=["archive_read", "dispatch", "checkpoint_flush"])
def test_pipeline_sites_fire_as_reference(archives, spec, checkpoint,
                                          monkeypatch):
    tmp, files = archives
    # both packages key the archive_read hash by the path they are given:
    # paths relative to the archives' directory do not move from run to
    # run, as pytest's base directory does
    monkeypatch.chdir(tmp)
    files = [os.path.basename(f) for f in files]
    ref = _pipeline(tmp, "jax", files, spec, checkpoint)
    port = _pipeline(tmp, "torch", files, spec, checkpoint)
    assert port == ref
    assert port[0], "nothing fired"
    assert port[3] == [f[:3] for f in port[0]]
