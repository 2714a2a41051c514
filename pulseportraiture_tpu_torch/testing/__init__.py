"""Test-support machinery that ships with the package.

``testing.faults`` is the chaos harness: deterministic, env-gated
fault injection at named host-side sites threaded through the TOA and
alignment pipelines.  It lives in the package (not tests/)
because production code calls its ``check()`` hooks — with
``PPTPU_FAULTS`` unset every hook is a near-free no-op.
"""

from . import faults
from .faults import InjectedFault

__all__ = ["faults", "InjectedFault"]
