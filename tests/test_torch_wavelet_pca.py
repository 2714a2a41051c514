"""Wavelet smoothing and PCA: the port against the JAX package on the CPU.

Inputs are made from numpy seeds and go through both packages' functions.
Pass criteria: the Daubechies filters equal to 1e-15; swt/iswt and
wavelet_smooth within 1e-12 of the largest magnitude; smart_smooth picks
the same (nlevel, fact) candidate for every profile and returns it within
1e-10; PCA eigenvalues within 1e-10 of the largest, eigenvectors up to
sign within 1e-8 where the eigenvalue is separated from its neighbours,
the significant-eigenvector selection equal.
"""

import numpy as np
import pytest
import torch

from pulseportraiture_tpu.ops import pca as jpca
from pulseportraiture_tpu.ops import wavelet as jw
from pulseportraiture_tpu_torch.ops import pca as tpca
from pulseportraiture_tpu_torch.ops import wavelet as tw

WAVE_TOL = 1e-12
SMOOTH_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These small CPU tensors run fastest on one intra-op thread; more
    threads only contend with the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


def _profiles(nprof, nbin, seed, snrs=None):
    """Noisy two-component profiles whose S/N spans a decade each way
    (and a pure-noise row), with a fixed seed."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    if snrs is None:
        snrs = np.geomspace(3.0, 3000.0, nprof - 1)
    rows = []
    for snr in snrs:
        loc = rng.uniform(0.2, 0.8)
        prof = np.exp(-0.5 * ((x - loc) / rng.uniform(0.01, 0.05)) ** 2) \
            + 0.4 * np.exp(-0.5 * ((x - loc - 0.1) / 0.03) ** 2)
        rows.append(prof * snr / 30.0 + rng.standard_normal(nbin) * 0.1)
    rows.append(rng.standard_normal(nbin) * 0.1)
    return np.array(rows)


@pytest.mark.parametrize("N", [1, 2, 4, 8])
def test_daubechies_filters_match_reference(N):
    np.testing.assert_allclose(tw.daubechies_dec_lo(N),
                               jw.daubechies_dec_lo(N), rtol=0, atol=1e-15)


@pytest.mark.parametrize("wavelet", ["db2", "db8"])
def test_swt_iswt_match_reference(wavelet):
    x = np.random.default_rng(0).standard_normal((3, 256))
    for nlevel in (1, 3, 6):
        cA, cDs = jw.swt(x, nlevel, wavelet)
        tA, tDs = tw.swt(_t(x), nlevel, wavelet)
        assert _rel(tA.numpy(), cA) <= WAVE_TOL
        for a, b in zip(tDs, cDs):
            assert _rel(a.numpy(), b) <= WAVE_TOL
        assert _rel(tw.iswt(tA, tDs, wavelet).numpy(),
                    jw.iswt(cA, cDs, wavelet)) <= WAVE_TOL
        # perfect reconstruction
        assert _rel(tw.iswt(tA, tDs, wavelet).numpy(), x) <= WAVE_TOL


@pytest.mark.parametrize("threshtype", ["hard", "soft"])
def test_wavelet_smooth_matches_reference(threshtype):
    port = _profiles(6, 256, 1)
    facts = np.linspace(0.0, 3.0, 7).reshape(7, 1)
    ref = jw.wavelet_smooth(port, "db8", 4, threshtype, facts)
    got = tw.wavelet_smooth(_t(port), "db8", 4, threshtype, _t(facts))
    assert got.shape == (7, 6, 256)
    assert _rel(got.numpy(), ref) <= WAVE_TOL


def _choices(ws, port, out, try_nlevels, nfact=30):
    """Per profile, the first (nlevel, fact index) whose smoothed
    candidate (computed with ``ws``, the package under test) is the
    returned profile; None where the profile was zeroed or kept raw."""
    facts = np.linspace(0.0, 3.0, nfact).reshape(nfact, 1)
    out = np.asarray(out)
    picks = [None] * len(port)
    for ilevel in range(try_nlevels):
        cand = np.asarray(ws.wavelet_smooth(
            port if ws is jw else _t(port), "db8", ilevel + 1, "hard",
            facts if ws is jw else _t(facts)))
        for i in range(len(port)):
            if picks[i] is not None or not out[i].any():
                continue
            gap = np.abs(cand[:, i] - out[i]).max(axis=-1)
            hit = np.flatnonzero(gap <= 1e-12 * np.abs(out[i]).max())
            if len(hit):
                picks[i] = (ilevel + 1, int(hit[0]))
    return picks


@pytest.mark.parametrize("fallback", ["zero", "raw"])
@pytest.mark.parametrize("seed", [2, 3])
def test_smart_smooth_choice_matches_reference(fallback, seed):
    """Fourteen profiles from S/N ~0.3 to ~300, a pure-noise one and an
    all-zero one (which stays zero): the same candidate per profile, the
    same profiles failing the gate, the same output."""
    port = np.concatenate([_profiles(15, 128, seed), np.zeros((1, 128))])
    ref = np.asarray(jw.smart_smooth(port, try_nlevels=5,
                                     fallback=fallback))
    got = tw.smart_smooth(_t(port), try_nlevels=5,
                          fallback=fallback).numpy()
    assert _rel(got, ref) <= SMOOTH_TOL
    picks = _choices(tw, port, got, 5)
    assert picks == _choices(jw, port, ref, 5)
    assert sum(p is not None for p in picks) >= 10
    assert not got[-1].any()


def test_smart_smooth_profile_and_odd_nbin_match_reference():
    prof = _profiles(2, 256, 4, snrs=[200.0])[0]
    assert _rel(tw.smart_smooth(_t(prof)).numpy(),
                jw.smart_smooth(prof)) <= SMOOTH_TOL
    odd = np.random.default_rng(5).standard_normal((2, 255))
    np.testing.assert_array_equal(tw.smart_smooth(_t(odd)).numpy(), odd)


def _portrait(nchan, nbin, seed):
    """An evolving two-component portrait with noise."""
    rng = np.random.default_rng(seed)
    x = (np.arange(nbin) + 0.5) / nbin
    nu = np.linspace(-1.0, 1.0, nchan)[:, None]
    port = np.exp(-0.5 * ((x - 0.4 - 0.01 * nu) / (0.03 + 0.005 * nu)) ** 2)
    port += (0.5 + 0.3 * nu) * np.exp(-0.5 * ((x - 0.55) / 0.02) ** 2)
    return port + rng.standard_normal((nchan, nbin)) * 0.01


@pytest.mark.parametrize("weighted", [False, True])
def test_pca_matches_reference(weighted):
    port = _portrait(32, 128, 6)
    w = np.random.default_rng(7).uniform(0.5, 2.0, 32) if weighted \
        else None
    mean = port.mean(axis=0) if weighted else None
    ev_j, V_j = (np.asarray(a) for a in jpca.pca(port, mean, w))
    ev_t, V_t = tpca.pca(_t(port), None if mean is None else _t(mean),
                         None if w is None else _t(w))
    ev_t, V_t = ev_t.numpy(), V_t.numpy()
    assert np.abs(ev_t - ev_j).max() <= 1e-10 * np.abs(ev_j).max()
    # eigenvectors up to sign, where the eigenvalue stands clear of its
    # neighbours (a degenerate eigenspace has no unique vectors)
    gaps = np.minimum(np.abs(np.diff(ev_j, prepend=np.inf)),
                      np.abs(np.diff(ev_j, append=-np.inf)))
    sep = np.flatnonzero(gaps > 1e-6 * ev_j[0])
    assert len(sep) >= 3
    sign = np.sign(np.sum(V_t[:, sep] * V_j[:, sep], axis=0))
    assert np.abs(V_t[:, sep] * sign - V_j[:, sep]).max() <= 1e-8
    rec_j = np.asarray(jpca.reconstruct_portrait(port, port.mean(0),
                                                 V_j[:, :3]))
    rec_t = tpca.reconstruct_portrait(_t(port), _t(port.mean(0)),
                                      _t(V_t[:, :3])).numpy()
    assert _rel(rec_t, rec_j) <= 1e-10


@pytest.mark.parametrize("return_smooth", [True, False])
def test_find_significant_eigvec_matches_reference(return_smooth):
    """The same indices from the reference's eigenvectors (the borderline
    crossings check included: a cutoff between the vectors' S/Ns), and
    the smoothed significant vectors within 1e-10."""
    port = _portrait(32, 128, 8)
    _, V = jpca.pca(port)
    V = np.asarray(V)
    for cutoff in (20.0, 150.0, 2000.0):
        ref = jpca.find_significant_eigvec(V, snr_cutoff=cutoff,
                                           return_smooth=return_smooth)
        got = tpca.find_significant_eigvec(_t(V), snr_cutoff=cutoff,
                                           return_smooth=return_smooth)
        if return_smooth:
            (ieig_j, sm_j), (ieig_t, sm_t) = ref, got
            assert _rel(sm_t.numpy(), sm_j) <= SMOOTH_TOL
        else:
            ieig_j, ieig_t = ref, got
        np.testing.assert_array_equal(ieig_t, ieig_j)
