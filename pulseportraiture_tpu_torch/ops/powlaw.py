"""Power-law spectrum utilities.

Port of the JAX package's ``ops/powlaw.py`` (reference pplib.py:1048-1096
``powlaw``, ``powlaw_integral``, ``powlaw_freqs`` and the ISM helpers
:1176-1202 ``mean_C2N``, ``dDM``).  Tensor in, tensor out (float64, on
the device of the input); Python numbers work too.
"""

import math

import torch

from ..config import real_dtype

__all__ = ["powlaw", "powlaw_integral", "powlaw_freqs", "mean_C2N", "dDM"]


def powlaw(nu, nu_ref, A, alpha):
    """F(nu) = A*(nu/nu_ref)**alpha (reference pplib.py:1048-1052)."""
    return A * (nu / nu_ref) ** alpha


def powlaw_integral(nu2, nu1, nu_ref, A, alpha):
    """Definite integral of A*(nu/nu_ref)**alpha from nu1 to nu2
    (reference pplib.py:1054-1066)."""
    nu2 = torch.as_tensor(nu2, dtype=real_dtype)
    nu1 = torch.as_tensor(nu1, dtype=real_dtype, device=nu2.device)
    alpha = torch.as_tensor(alpha, dtype=real_dtype, device=nu2.device)
    log_case = A * nu_ref * torch.log(nu2 / nu1)
    safe_alpha = torch.where(alpha == -1.0, torch.zeros_like(alpha), alpha)
    C = A * (nu_ref ** -safe_alpha) / (1 + safe_alpha)
    gen_case = C * ((nu2 ** (1 + safe_alpha)) - (nu1 ** (1 + safe_alpha)))
    return torch.where(alpha == -1.0, log_case, gen_case)


def powlaw_freqs(lo, hi, N, alpha, mid=False, device="cpu"):
    """Channel edges (or centers) with equal flux per channel for a
    power-law spectrum of index alpha (reference pplib.py:1068-1096)."""
    if alpha == -1.0:
        nus = torch.exp(torch.linspace(math.log(lo), math.log(hi), N + 1,
                                       dtype=real_dtype, device=device))
    else:
        nus = torch.pow(torch.linspace(lo ** (1 + alpha), hi ** (1 + alpha),
                                       N + 1, dtype=real_dtype,
                                       device=device), (1 + alpha) ** -1)
    if mid:
        nus = 0.5 * (nus[:-1] + nus[1:])
    return nus


def mean_C2N(nu, D, bw_scint):
    """Mean turbulence strength C2N [m**-20/3] (Foster, Fairhead & Backer
    1991); nu [MHz], D [kpc], scintillation bandwidth bw_scint [MHz]
    (reference pplib.py:1176-1187)."""
    return 2e-14 * nu ** (11 / 3.0) * D ** (-11 / 6.0) * \
        bw_scint ** (-5 / 6.0)


def dDM(D, D_screen, nu, bw_scint):
    """delta-DM [cm**-3 pc] predicted for a frequency-dependent DM
    (Cordes & Shannon 2010; reference pplib.py:1189-1202): D the pulsar
    distance [kpc], D_screen the Earth-screen distance [kpc], nu [MHz],
    bw_scint the scintillation bandwidth at nu [MHz]."""
    SM = mean_C2N(nu, D, bw_scint) * D  # scattering measure [m**-20/3 kpc]
    return 10 ** 4.45 * SM * D_screen ** (5 / 6.0) * nu ** (-11 / 6.0)
