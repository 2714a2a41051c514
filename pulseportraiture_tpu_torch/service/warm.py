"""Service-side alias of the shared warm core (``runner/warm.py``).

The PyTorch port of the JAX package's ``service/warm.py``: the daemon
(``ppserve warm``, :meth:`~.daemon.TOAService.warm`) and the batch
engine (``ppsurvey warm`` / ``ppsurvey run --warm``) prime the SAME
program enumeration against the same kernel build directory — see
runner/warm.py for the design.  This module stays as the service's
import surface (``service.warm_plan`` etc.).
"""

from ..runner.warm import (  # noqa: F401
    WARM_WORKLOADS, WarmSpec, _bucket_freqs, _CompileWatch,
    _fit_kwargs, _synth_model, _warm_archive_spec, _warm_coalesced_spec,
    _WARM_EPHEMERIS, enable_persistent_cache, program_specs,
    solver_program, synth_databunch, warm_plan, write_warm_archive)

__all__ = ["WarmSpec", "program_specs", "warm_plan",
           "enable_persistent_cache", "synth_databunch"]
