"""Kernel K3 (csrc/moments_scat.cu), both epilogues, and their plain
versions.

The plain versions' row algebra on the CPU (lane subsets, a shared
|m|^2, tau = 0 against K1's function), and ``cuda``-marked tests that
hold the kernel against the plain version on the card: ragged K (not a
multiple of 8, K = 1, K = 257), one channel, per-subint |m|^2, a zapped
channel, shifts up to 2000 rot (the phasor recurrence), tau = 0 and
very large tau K, lane subsets bit for bit.  No JAX import, so the
card's tests run where JAX is absent:

    python -m pytest -m cuda --noconftest tests/test_torch_moments_scat.py
"""

import numpy as np
import pytest
import torch

from pulseportraiture_tpu_torch import _kernels


def _k3_inputs(gen_or_rng, B, nchan, Kh, per_subint, device="cpu"):
    rng = gen_or_rng
    cross = torch.as_tensor(rng.standard_normal((B, nchan, Kh))
                            + 1j * rng.standard_normal((B, nchan, Kh)),
                            device=device)
    abs_m2 = torch.as_tensor(rng.uniform(0.0, 2.0, (
        B if per_subint else 1, nchan, Kh)), device=device)
    inv_err2 = torch.as_tensor(rng.uniform(0.5, 2.0, (B, nchan)),
                               device=device)
    return cross, abs_m2, inv_err2


def test_scattering_moments_kernel_function_on_lane_subsets(rng):
    """K3's plain version on a lane subset equals the full rows; a shared
    |m|^2 equals the same rows repeated per subint; at tau == 0 its C,
    T1, T2 are K1's and S = sum |m|^2 w."""
    B, nchan, Kh = 5, 6, 40
    cross, abs_m2, inv_err2 = _k3_inputs(rng, B, nchan, Kh, False)
    shifts = torch.as_tensor(rng.uniform(-40.0, 40.0, (B, nchan)))
    taus = torch.as_tensor(rng.uniform(0.0, 0.02, (B, nchan)))
    full = _kernels.moments_scat(cross, abs_m2, shifts, taus, inv_err2)
    lanes = torch.tensor([3, 0], dtype=torch.int64)
    part = _kernels.moments_scat(cross, abs_m2, shifts[lanes].contiguous(),
                                 taus[lanes].contiguous(), inv_err2, lanes)
    torch.testing.assert_close(part, full[lanes], rtol=0, atol=0)
    rep = abs_m2.expand(B, nchan, Kh).contiguous()
    torch.testing.assert_close(
        _kernels.moments_scat(cross, rep, shifts, taus, inv_err2), full,
        rtol=0, atol=0)
    zero = _kernels.moments_scat(cross, abs_m2, shifts,
                                 torch.zeros_like(taus), inv_err2)
    k1 = _kernels.moments(cross, shifts, inv_err2)
    torch.testing.assert_close(zero[..., [0, 2, 3]], k1, rtol=1e-13,
                               atol=1e-12)
    torch.testing.assert_close(zero[..., 1], abs_m2.sum(-1) * inv_err2,
                               rtol=1e-14, atol=0)
    assert set(_kernels.LAUNCHES.values()) == {0}


# -- K3 on the card ---------------------------------------------------------

def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _assert_rows_close(got, want, tol=1e-12):
    """Each sum within tol of its largest magnitude over the rows."""
    for j, name in enumerate(_kernels.MOMENTS_SCAT_SUMS):
        g, w = got[..., j], want[..., j]
        scale = float(w.abs().max().clamp_min(1e-300))
        err = float((g - w).abs().max()) / scale
        assert err <= tol, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nchan,Kh,per_subint,tau_max", [
    (4, 16, 128, False, 0.02),
    (3, 7, 100, True, 0.02),     # K not a multiple of 32
    (2, 5, 1, False, 0.02),      # K = 1
    (3, 9, 257, True, 50.0),     # very large tau K
])
def test_moments_scat_kernel_matches_plain_on_the_card(B, nchan, Kh,
                                                       per_subint, tau_max):
    _on_card()
    rng = np.random.default_rng(B * 1000 + Kh)
    cross, abs_m2, inv_err2 = _k3_inputs(rng, B, nchan, Kh, per_subint,
                                         "cuda")
    inv_err2[0, 1] = 0.0  # a zapped channel
    shifts = torch.as_tensor(rng.uniform(-500.0, 500.0, (B, nchan)),
                             device="cuda")
    taus = torch.as_tensor(rng.uniform(0.0, tau_max, (B, nchan)),
                           device="cuda")
    got = _kernels.moments_scat(cross, abs_m2, shifts, taus, inv_err2)
    want = _kernels.moments_scat_plain(cross, abs_m2, shifts, taus, inv_err2)
    torch.cuda.synchronize()
    _assert_rows_close(got, want)
    assert bool((got[0, 1] == 0.0).all())


@pytest.mark.cuda
def test_moments_scat_kernel_lanes_shared_and_tau_zero_on_the_card():
    _on_card()
    rng = np.random.default_rng(3)
    B, nchan, Kh = 6, 11, 96
    cross, abs_m2, inv_err2 = _k3_inputs(rng, B, nchan, Kh, False, "cuda")
    shifts = torch.as_tensor(rng.uniform(-50.0, 50.0, (B, nchan)),
                             device="cuda")
    taus = torch.as_tensor(rng.uniform(0.0, 0.03, (B, nchan)), device="cuda")
    full = _kernels.moments_scat(cross, abs_m2, shifts, taus, inv_err2)
    lanes = torch.tensor([4, 1, 5], dtype=torch.int64, device="cuda")
    part = _kernels.moments_scat(cross, abs_m2, shifts[lanes].contiguous(),
                                 taus[lanes].contiguous(), inv_err2, lanes)
    assert torch.equal(part, full[lanes])  # bit for bit
    rep = abs_m2.expand(B, nchan, Kh).contiguous()
    assert torch.equal(_kernels.moments_scat(cross, rep, shifts, taus,
                                             inv_err2), full)
    zero = _kernels.moments_scat(cross, abs_m2, shifts,
                                 torch.zeros_like(taus), inv_err2)
    k1 = _kernels.moments(cross, shifts, inv_err2)
    torch.testing.assert_close(zero[..., [0, 2, 3]], k1, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(zero[..., 1], abs_m2.sum(-1) * inv_err2,
                               rtol=1e-13, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,nchan,Kh", [(3, 512, 128), (40, 1, 128),
                                        (3, 7, 257), (2, 512, 1),
                                        (4, 7, 100)])
def test_moments_scat_kernel_phasor_path_on_the_card(B, nchan, Kh):
    """Epilogue A at shifts up to 2000 rot, where the phasor recurrence
    corrects each step to the reference's rounded phase."""
    _on_card()
    rng = np.random.default_rng(B * 7 + nchan + Kh)
    cross, abs_m2, inv_err2 = _k3_inputs(rng, B, nchan, Kh, True, "cuda")
    shifts = torch.as_tensor(rng.uniform(-2000.0, 2000.0, (B, nchan)),
                             device="cuda")
    taus = torch.as_tensor(rng.uniform(0.0, 0.02, (B, nchan)), device="cuda")
    got = _kernels.moments_scat(cross, abs_m2, shifts, taus, inv_err2)
    want = _kernels.moments_scat_plain(cross, abs_m2, shifts, taus, inv_err2)
    torch.cuda.synchronize()
    _assert_rows_close(got, want)


# -- K3 epilogue B: per-row objective, gradient and Hessian --------------

def _gh_inputs(rng, B, nchan, Kh, per_subint, tau_max, shift_max, lanes,
               device="cpu"):
    """moments_scat_grad_hess's arguments (but log10_tau): channel
    min(1, nchan - 1) of subint 0 zapped."""
    cross, abs_m2, inv_err2 = _k3_inputs(rng, B, nchan, Kh, per_subint,
                                         device)
    inv_err2[0, min(1, nchan - 1)] = 0.0
    n = B if lanes is None else len(lanes)

    def t(x):
        return torch.as_tensor(x, device=device)

    pd = np.stack([np.ones((n, nchan)), rng.uniform(-0.2, 0.2, (n, nchan)),
                   rng.uniform(-1e-3, 1e-3, (n, nchan))], axis=1)
    return (cross, abs_m2,
            t(rng.uniform(-shift_max, shift_max, (n, nchan))),
            t(rng.uniform(0.0, tau_max, (n, nchan))), inv_err2, t(pd),
            t(rng.uniform(-0.2, 0.2, (n, nchan))),
            t(rng.uniform(1e-3, 5e-3, n)),
            None if lanes is None else t(np.asarray(lanes, dtype=np.int64)))


# Epilogue B against its plain version: each of the 21 columns within
# 1e-10 of its largest magnitude.  The nine sums agree to 1e-12 (~1e-15
# of their terms); the epilogue divides by C and S, which random rows
# bring near zero, and its Hessian terms cancel: a rounding model of the
# sums (1e-15 of each row's terms) moves the columns by <= 4e-14 of their
# largest magnitude, the sums' whole 1e-12 budget by up to ~4e-9.
GH_TOL = 1e-10


def _assert_gh_close(got, want, tol=GH_TOL):
    for j, name in enumerate(_kernels.GRAD_HESS_COLUMNS):
        g, w = got[:, j], want[:, j]
        scale = float(w.abs().max().clamp_min(1e-300))
        err = float((g - w).abs().max()) / scale
        assert err <= tol, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("log10_tau", [True, False])
@pytest.mark.parametrize("B,nchan,Kh,per_subint,tau_max,shift_max,lanes", [
    (4, 512, 128, False, 0.02, 2000.0, None),
    (3, 7, 100, True, 0.02, 2000.0, (2, 0)),
    (2, 7, 1, False, 0.02, 500.0, None),       # K = 1
    (6, 1, 257, True, 50.0, 2000.0, (5, 1, 3)),  # one channel, large tau K
    (3, 7, 128, False, 0.0, 2000.0, None),     # tau = 0
    (5, 512, 257, True, 0.02, 2000.0, (4, 0)),
])
def test_moments_scat_grad_hess_kernel_matches_plain_on_the_card(
        log10_tau, B, nchan, Kh, per_subint, tau_max, shift_max, lanes):
    _on_card()
    rng = np.random.default_rng(B * 1000 + nchan + Kh)
    a = _gh_inputs(rng, B, nchan, Kh, per_subint, tau_max, shift_max, lanes,
                   "cuda")
    args = a[:8] + (log10_tau, a[8])
    got = _kernels.moments_scat_grad_hess(*args)
    want = _kernels.moments_scat_grad_hess_plain(*args)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (a[2].shape[0], 21, nchan)
    _assert_gh_close(got, want)
    if lanes is None or 0 in lanes:
        i = 0 if lanes is None else list(lanes).index(0)
        assert bool((got[i, :, min(1, nchan - 1)] == 0.0).all())  # zapped


@pytest.mark.cuda
def test_moments_scat_grad_hess_kernel_lanes_and_tau_zero_on_the_card():
    """A lane subset's rows equal the full rows bit for bit; at tau == 0
    the (phi, DM, GM) terms are K1's (_kernels.moments_grad_hess_plain)."""
    _on_card()
    from pulseportraiture_tpu_torch.fit import portrait as tfp

    rng = np.random.default_rng(5)
    B, nchan, Kh = 6, 11, 96
    a = _gh_inputs(rng, B, nchan, Kh, False, 0.03, 50.0, None, "cuda")
    full = _kernels.moments_scat_grad_hess(*a[:8], True)
    lanes = torch.tensor([4, 1, 5], dtype=torch.int64, device="cuda")
    part = _kernels.moments_scat_grad_hess(
        *a[:2], *(x[lanes].contiguous() for x in a[2:4]), a[4],
        *(x[lanes].contiguous() for x in a[5:8]), True, lanes)
    assert torch.equal(part, full[lanes])
    cross, abs_m2, shifts, _, inv_err2, pd, lnf, _ = a[:8]
    rows = _kernels.moments_scat_grad_hess(
        cross, abs_m2, shifts, torch.zeros_like(shifts), inv_err2, pd, lnf,
        torch.zeros(B, dtype=torch.float64, device="cuda"), True)
    f, g, H = tfp._grad_hess_from_rows(rows, (1, 1, 1, 1, 1), True)
    S = abs_m2.sum(-1) * inv_err2
    f1, g1, H1 = tfp._grad_hess_from_rows(
        _kernels.moments_grad_hess_plain(cross, shifts, pd, S, inv_err2),
        (1, 1, 1, 0, 0), per_channel=True)
    for x, y in ((f, f1), (g, g1), (H, H1)):
        torch.testing.assert_close(x, y, rtol=1e-12,
                                   atol=1e-12 * float(y.abs().max()))
