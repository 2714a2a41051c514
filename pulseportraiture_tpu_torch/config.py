"""Global configuration, physical constants, and the device/dtype policy.

Constants are those of the JAX reference package's ``config`` module
(pplib.py:44-119); the precision and placement rules are
the port's own:

* **Device policy.** Entry points (``GetTOAs``, ``fit_portrait_full_batch``,
  ``fit_phase_shift``, the ``pptoas`` CLI) take ``device=None`` and then
  run on ``default_device()`` — the CUDA device.  With no CUDA device
  and no explicit ``device="cpu"`` they raise: nothing carries on on the
  CPU silently.  ``resolve_device`` is the one place that rule lives.
* **Dtype policy.** Everything runs in float64 / complex128: solver
  state, spectra and the moment sums (the branch the JAX package itself
  takes on CPU and GPU).  TF32 is switched off for float32 matmuls and
  cuDNN convolutions when this module is imported, so no float32 product
  anywhere in the process silently drops to ~3 decimal digits; the only
  float32 arithmetic in the port is the deliberate f32 LU of
  fit.smallsolve, which is refined back to f64.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# -- Dispersion constants [MHz**2 cm**3 pc**-1 s] ---------------------------
# Exact value of e**2/(2 pi m_e c) (used by PRESTO).
Dconst_exact = 4.148808e3
# "Traditional" value used by PSRCHIVE/TEMPO/PINT.  Fitted DM values depend
# on this choice (reference: pplib.py:44-51).
Dconst_trad = 0.000241 ** -1
Dconst = Dconst_trad

# Default power-law index for the scattering law tau(nu) = tau*(nu/nu_tau)**alpha
# (reference: pplib.py:53-54).
scattering_alpha = -4.0

# Upper bound on Gaussian component FWHM [rot] in the Gaussian fits, and
# the default evolution code of a Gaussian portrait, one digit per (loc,
# wid, amp): '0' power law, '1' linear (reference: pplib.py:68-79).
wid_max = 0.25
default_model = "000"

# Weight applied to the DC (k=0) harmonic in all Fourier-domain fits.
# 0 removes the baseline term from the fit (reference: pplib.py:64-66).
F0_fact = 0

# scipy.optimize.fmin_tnc return-code strings, kept verbatim for diagnostic
# parity (reference: pplib.py:109-119).  The batched Newton solver maps its
# own termination reasons onto the closest codes: 1 = function converged,
# 2 = step converged, 3 = max iterations, 4 = damping diverged.
RCSTRINGS = {
    "-1": "INFEASIBLE: Infeasible (low > up).",
    "0": "LOCALMINIMUM: Local minima reach (|pg| ~= 0).",
    "1": "FCONVERGED: Converged (|f_n-f_(n-1)| ~= 0.)",
    "2": "XCONVERGED: Converged (|x_n-x_(n-1)| ~= 0.)",
    "3": "MAXFUN: Max. number of function evaluations reach.",
    "4": "LSFAIL: Linear search failed.",
    "5": "CONSTANT: All lower bounds are equal to the upper bounds.",
    "6": "NOPROGRESS: Unable to progress.",
    "7": "USERABORT: User requested end of minimization.",
}

# The working precision: float64 (complex128 spectra).
real_dtype = torch.float64


def default_device():
    """The device entry points use when none is given: CUDA.

    Raises RuntimeError when no CUDA device is available — callers that
    mean the CPU must say ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: "
            "--device cpu) to run on the CPU explicitly.")
    return torch.device("cuda")


def resolve_device(device=None):
    """``device`` as a torch.device; None means ``default_device()``."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but CUDA is not available."
                           % device)
    return device


__all__ = [
    "Dconst",
    "Dconst_exact",
    "Dconst_trad",
    "scattering_alpha",
    "wid_max",
    "default_model",
    "F0_fact",
    "RCSTRINGS",
    "real_dtype",
    "default_device",
    "resolve_device",
]
