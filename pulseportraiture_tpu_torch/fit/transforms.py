"""Phase/delay reference-frequency transforms and TOA helpers.

Port of the JAX package's ``fit/transforms.py`` (reference
pplib.py:2577-2648).  These are tiny host-side
formulas, so they take and return numpy values (or Python floats).
"""

import numpy as np

from ..config import Dconst

__all__ = ["DM_delay", "phase_transform", "calculate_TOA",
           "guess_fit_freq"]


def DM_delay(DM, freq, freq_ref=np.inf, P=None):
    """Dispersive delay [sec] (or [rot] if P given) between freq and
    freq_ref (reference pplib.py:2577-2590)."""
    delay = Dconst * DM * (np.asarray(freq, dtype=np.float64) ** -2.0
                           - freq_ref ** -2.0)
    if P is not None:
        return delay / P
    return delay


def calculate_TOA(epoch, P, phi, DM=0.0, nu_ref1=np.inf, nu_ref2=np.inf):
    """TOA (two-part MJD) = epoch + phi' * P, with phi transformed from
    nu_ref1 to nu_ref2 via the (pre-Doppler) DM (reference
    pplib.py:2634-2648)."""
    phi_prime = float(np.asarray(phase_transform(phi, DM, nu_ref1,
                                                 nu_ref2, P, mod=False)))
    return epoch.add_seconds(phi_prime * P)


def phase_transform(phi, DM, nu_ref1=np.inf, nu_ref2=np.inf, P=None,
                    mod=False):
    """Transform a delay at nu_ref1 to a delay at nu_ref2; mod=True wraps
    |phi'| >= 0.5 onto [-0.5, 0.5) (reference pplib.py:2592-2616)."""
    if P is None:
        P = 1.0
        mod = False
    phi_prime = phi + Dconst * DM * (np.asarray(nu_ref2, np.float64) ** -2.0
                                     - np.asarray(nu_ref1, np.float64)
                                     ** -2.0) / P
    if mod:
        phi_prime = np.where(np.abs(phi_prime) >= 0.5, phi_prime % 1,
                             phi_prime)
        phi_prime = np.where(phi_prime >= 0.5, phi_prime - 1.0, phi_prime)
    return phi_prime


def guess_fit_freq(freqs, SNRs=None):
    """SNR*nu^-2-weighted 'center of mass' frequency — a cheap
    zero-covariance frequency estimate (reference pplib.py:2618-2632)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    nu0 = (freqs.min() + freqs.max()) * 0.5
    if SNRs is None:
        SNRs = np.ones_like(freqs)
    w = SNRs * (1.0 / (freqs * freqs))
    return nu0 + np.sum((freqs - nu0) * w) / np.sum(w)
