"""Opt-in runtime sanitizer: non-finite checks of fit results.

Port of the NaN hooks of the JAX package's ``debug.py``.  Everything is
gated on the ``PPTPU_SANITIZE`` environment variable and is a no-op
when it is unset — no host copy and no device sync:

* unset / ``0`` / ``off``  — disabled (the default);
* ``1`` / ``raise``        — a violation raises :class:`NonFiniteError`;
* ``warn``                 — a violation emits a ``RuntimeWarning``.

``check_finite(value, name)`` and ``check_fit_result(result)`` check
concrete values on the host; ``fit_portrait_full_batch`` and
``fit_portrait_full`` call ``check_fit_result`` on what they return, so
a NaN chi-squared or parameter vector fails at the fit that produced it
instead of pipelines later in a .tim file.  The JAX package's retrace
budget and trace counter count jit traces and compiles; eager PyTorch
has neither, so they have no counterpart here.
"""

import os
import warnings

import numpy as np
import torch

__all__ = ["enabled", "sanitize_mode", "NonFiniteError", "check_finite",
           "check_fit_result"]


def sanitize_mode():
    """None (disabled), 'warn', or 'raise' from PPTPU_SANITIZE."""
    v = os.environ.get("PPTPU_SANITIZE", "").strip().lower()
    if v in ("", "0", "false", "off", "no"):
        return None
    return "warn" if v in ("warn", "log") else "raise"


def enabled():
    return sanitize_mode() is not None


class NonFiniteError(FloatingPointError):
    """A sanitized value contained NaN/Inf."""


def _violate(msg):
    if sanitize_mode() == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    else:
        raise NonFiniteError(msg)


def check_finite(value, name="value", allow_inf=False):
    """Raise/warn when ``value`` (a tensor or array) holds NaN (or Inf
    unless ``allow_inf``).  Returns ``value`` unchanged; a no-op when the
    sanitizer is off.  When on, it copies the value to the host, which
    syncs the device: the sanitizer's documented cost."""
    if not enabled():
        return value
    arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
        else np.asarray(value)
    if not np.issubdtype(arr.dtype, np.number):
        return value
    bad = np.isnan(arr) if allow_inf else ~np.isfinite(arr)
    if np.any(bad):
        _violate("%s: %d non-finite value(s) out of %d"
                 % (name, int(bad.sum()), arr.size))
    return value


def check_fit_result(result, where="fit"):
    """NaN hook for fit outputs: ``params`` and ``chi2``.

    NaN only (``allow_inf=True``): Inf appears by design — a frozen
    log10(tau) of -inf encodes "no scattering" — while NaN always means
    a poisoned fit.  No-op when the sanitizer is off; returns
    ``result``."""
    if not enabled():
        return result
    for field in ("params", "chi2"):
        if isinstance(result, dict) and field in result:
            check_finite(result[field], name="%s.%s" % (where, field),
                         allow_inf=True)
    return result
