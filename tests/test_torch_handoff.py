"""The load's cube handed to the fit: GetTOAs with and without it.

``load_data(..., keep_cube=True)`` (the load GetTOAs and the survey run)
leaves its final cube on the load's device beside the DataBunch's numpy
schema (``io.archive.LoadedBunch.device_cube``).  ``GetTOAs`` takes it
off the bunch, indexes its fit batch there, runs the non-finite guard's
mask there and drops it after the archive's fit.  On the CPU the cube is
a CPU tensor, so these tests run that same code: the TOAs, rc and nfeval
of a bunch with the cube must equal, bit for bit, those of the same bunch
without it (the host batch uploaded once), wideband, with --fit_scat and
narrowband, with a NaN channel (the guard's mask taken from the cube
against the host guard's, and the port's guard on a tensor against the
JAX package's on the same arrays) and on survey bunches (a padded one
drops its cube).  Archives are written by the port's make_fake_pulsar.
"""

import gc
import os
import weakref

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.pipelines.toas import \
    _nonfinite_guard as jnonfinite_guard
from pulseportraiture_tpu_torch.io import archive as tarch
from pulseportraiture_tpu_torch.pipelines import toas as ttoas
from pulseportraiture_tpu_torch.pipelines.toas import (GetTOAs,
                                                       load_archive_data)
from pulseportraiture_tpu_torch.runner.plan import load_bucketed_databunch

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, os.pardir, "examples")
GMODEL = os.path.join(EXAMPLES, "example.gmodel")
PAR = os.path.join(EXAMPLES, "example.par")
NSUB, NCHAN, NBIN = 3, 16, 128
NAN_AT = (1, 5)   # (subint, channel) made NaN in the "nan" bunches


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_handoff")
    w = np.ones((NSUB, NCHAN))
    w[:, 2] = 0.0
    return tarch.make_fake_pulsar(
        GMODEL, PAR, str(tmp / "a.fits"), nsub=NSUB, nchan=NCHAN, nbin=NBIN,
        tsub=60.0, phase=0.1, dDM=2e-3, weights=w, noise_stds=0.05, seed=3)


def _bunch(path, cube=True, nan=False):
    """GetTOAs's load of ``path`` on the CPU, with its device cube or with
    it taken off; ``nan``: one live channel's data made NaN (in the cube
    too: on the CPU the cube and subints share their memory)."""
    d = load_archive_data(path, device="cpu")
    assert isinstance(d.device_cube, torch.Tensor)
    assert d.device_cube.shape == d.subints.shape
    if nan:
        d.subints[NAN_AT[0], 0, NAN_AT[1], 7] = np.nan
    if not cube:
        tarch.take_device_cube(d)
        assert d.device_cube is None
    return d


def _fit(path, bunch, method, **kw):
    gt = GetTOAs([path], GMODEL, quiet=True, device="cpu")
    gt.preload(path, ("data", bunch))
    if method == "get_TOAs":
        kw.setdefault("bary", False)
    getattr(gt, method)(**kw)
    return gt


def _same(a, b):
    """Bit-equal TOAs, rc, nfeval and fitted phases of two GetTOAs runs."""
    assert len(a.TOA_list) == len(b.TOA_list) > 0
    for ta, tb in zip(a.TOA_list, b.TOA_list):
        assert (ta.MJD.day, ta.MJD.secs) == (tb.MJD.day, tb.MJD.secs)
        assert ta.TOA_error == tb.TOA_error and ta.DM == tb.DM
        assert ta.flags == tb.flags
    for attr in ("phis", "phi_errs", "rcs", "nfevals", "n_nonfinite_zapped"):
        for x, y in zip(getattr(a, attr), getattr(b, attr)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=attr)


CASES = {
    "wideband": ("get_TOAs", {}),
    "fit_scat": ("get_TOAs", dict(fit_scat=True)),
    "narrowband": ("get_narrowband_TOAs", {}),
}


@pytest.mark.parametrize("nan", [False, True], ids=["clean", "nan"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gettoas_same_with_and_without_the_cube(archive, case, nan):
    """Bit-equal TOAs, rc and nfeval with the load's cube and without it;
    with a NaN channel both guards zap exactly that channel."""
    method, kw = CASES[case]
    with_cube = _fit(archive, _bunch(archive, True, nan), method, **kw)
    without = _fit(archive, _bunch(archive, False, nan), method, **kw)
    _same(with_cube, without)
    assert [int(n) for n in with_cube.n_nonfinite_zapped] == [int(nan)]


def test_the_cube_is_released_after_the_fit(archive):
    """GetTOAs takes the cube off the bunch and keeps no reference to it
    (nor to the batch it gathered from it) once the archive is fitted."""
    d = _bunch(archive)
    d.device_cube = d.device_cube.clone()  # no numpy array shares it
    ref = weakref.ref(d.device_cube)
    gt = _fit(archive, d, "get_TOAs")
    assert d.device_cube is None and not gt._preloaded
    gc.collect()
    assert ref() is None
    assert tarch.take_device_cube(d) is None


def test_a_checkpointed_archive_drops_its_preload(archive, tmp_path):
    """An archive the checkpoint already holds is skipped, and its
    preloaded buffer (with its cube) is dropped, not kept on GetTOAs."""
    ck = str(tmp_path / "ck.tim")
    gt = _fit(archive, _bunch(archive), "get_TOAs", checkpoint=ck)
    n = len(gt.TOA_list)
    gt.preload(archive, ("data", _bunch(archive)))
    gt.get_TOAs(bary=False, checkpoint=ck)
    assert len(gt.TOA_list) == n and not gt._preloaded


@pytest.mark.parametrize("nbin_pad", [NBIN, 2 * NBIN],
                         ids=["canonical", "padded"])
def test_survey_bunches(archive, nbin_pad):
    """The survey's bucketed load: a canonical bunch keeps its cube and
    fits bit-equal to the same bunch without it; a padded bunch has
    dropped it (its host cube is what the fit uploads)."""
    def bunch(cube):
        d = load_bucketed_databunch(archive, (NCHAN, nbin_pad),
                                    device="cpu")
        if not cube:
            tarch.take_device_cube(d)
        return d

    d = bunch(True)
    if nbin_pad == NBIN:
        assert d.device_cube is not None
    else:
        assert d.device_cube is None and d.subints.shape[-1] == nbin_pad
    _same(_fit(archive, d, "get_TOAs"), _fit(archive, bunch(False),
                                             "get_TOAs"))


def test_the_card_side_guard_is_the_reference_guard():
    """_nonfinite_guard on a tensor (the cube's path) against the JAX
    package's on the same host arrays: the same mask, counts and scrubbed
    arrays, bit for bit; no channel zapped leaves the tensor as it was."""
    rng = np.random.default_rng(0)
    ports = rng.standard_normal((4, 6, 16))
    errs = rng.uniform(0.5, 1.0, (4, 6))
    weights = np.ones((4, 6))
    weights[0, 1] = 0.0
    ports[0, 1, 3] = np.nan       # not live: not zapped
    ports[2, 4, 0] = np.inf
    errs[3, 5] = np.nan
    got = ttoas._nonfinite_guard(torch.as_tensor(ports), errs, weights)
    want = jnonfinite_guard(ports, errs, weights)
    assert isinstance(got[0], torch.Tensor)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[4] == 2 and got[5] == 23
    clean = torch.as_tensor(rng.standard_normal((2, 3, 8)))
    out = ttoas._nonfinite_guard(clean, np.ones((2, 3)), np.ones((2, 3)))
    assert out[0] is clean and out[4] == 0


def test_load_data_keeps_the_cube_only_when_asked(archive):
    """keep_cube: the bunch's cube equals its subints; without it the
    bunch carries none, and the cube is no key of the bunch."""
    kept = tarch.load_data(archive, device="cpu", pscrunch=True,
                           keep_cube=True)
    plain = tarch.load_data(archive, device="cpu", pscrunch=True)
    assert plain.device_cube is None
    np.testing.assert_array_equal(kept.device_cube.numpy(), kept.subints)
    assert "device_cube" not in kept and set(kept) == set(plain)
