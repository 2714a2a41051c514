"""Kernel K3 (csrc/moments_scat.cu) and its plain version.

The plain version's row algebra on the CPU (lane subsets, a shared
|m|^2, tau = 0 against K1's function), and ``cuda``-marked tests that
hold the kernel against the plain version on the card: ragged K (not a
multiple of 32, K = 1), per-subint |m|^2, a zapped channel, very large
tau K, lane subsets bit for bit.  No JAX import, so the card's tests run
where JAX is absent:

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
