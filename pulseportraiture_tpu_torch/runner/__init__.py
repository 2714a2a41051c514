"""Survey runner: shape-bucketed batch scheduling with fault isolation.

The paper's workload is embarrassingly parallel — every archive's
subintegrations are fit independently — but a survey of thousands of
heterogeneous archives needs an execution *plan*: group archives into
shape buckets so the whole survey runs at O(#buckets) shapes
(:mod:`.plan`), track per-archive state in a crash-safe on-disk ledger
so one poison archive cannot kill a week-long run (:mod:`.queue`), and
drive the bucketed batches across processes with per-host obs shards
merged into one report (:mod:`.execute`).  The CLI front-end is
``python -m pulseportraiture_tpu_torch.cli.ppsurvey``; the full contract
lives in docs/RUNNER.md.

This is the PyTorch port of the JAX package's ``runner/``: the same
modules, public names, ledger records and checkpoint files (a workdir
planned by either package runs in the other), with the fits going
through the port's ``GetTOAs`` on the CUDA device (kernels K1, K2 and,
with ``fit_scat``, K3) unless ``device="cpu"`` is asked for.  Everything
here is host-side orchestration (file IO, ledger writes, process
partitioning).
"""

from .plan import (ArchiveInfo, ShapeBucket, SurveyPlan, canonical_shape,
                   load_bucketed_databunch, pad_databunch, plan_survey,
                   scan_archive_header)
from .queue import DEFAULT_WORKLOAD, WorkQueue
from .execute import run_survey, survey_status
from .prefetch import HostPrefetcher, PrefetchTicket
from .respawn import RespawnPolicy, RespawnTracker
from .supervisor import Supervisor, decide, supervise
from .warm import (WarmSpec, enable_persistent_cache, program_specs,
                   synth_databunch, warm_plan)
from .workloads import (AlignWorkload, ModelFitWorkload, ToasWorkload,
                        Workload, ZapWorkload, get_workload,
                        register_workload, resolve_workload,
                        workload_names)

__all__ = ["ArchiveInfo", "ShapeBucket", "SurveyPlan", "canonical_shape",
           "load_bucketed_databunch", "pad_databunch", "plan_survey",
           "scan_archive_header", "HostPrefetcher", "PrefetchTicket",
           "WorkQueue", "DEFAULT_WORKLOAD", "run_survey",
           "survey_status", "Workload", "ToasWorkload", "ZapWorkload",
           "AlignWorkload", "ModelFitWorkload", "register_workload",
           "get_workload", "workload_names", "resolve_workload",
           "WarmSpec", "program_specs", "warm_plan",
           "enable_persistent_cache", "synth_databunch",
           "RespawnPolicy", "RespawnTracker", "Supervisor", "decide",
           "supervise"]
