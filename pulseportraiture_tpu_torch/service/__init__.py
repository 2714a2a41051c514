"""TOA-as-a-service: resident multi-tenant fitting daemon.

The PyTorch port of the JAX package's ``service`` subsystem: per-tenant
ledger-backed intake, warm per-bucket fitter pools, cross-request
micro-batching on the device (batcher.py), fairness/backpressure
between tenants, per-request observability runs, the Unix-socket
transport (server.py) and the bucket-routed fleet (router.py).  See the
``ppserve`` and ``pprouter`` CLIs (cli/ppserve.py, cli/pprouter.py).

Host-side orchestration: nothing here runs device code itself; the
fits go through the pipeline's ``GetTOAs`` on the daemon's device.
"""

from .batcher import MicroBatcher
from .daemon import Request, TOAService
from .router import DEFAULT_ROUTER_SOCKET_NAME, FleetRouter
from .server import DEFAULT_SOCKET_NAME, ServiceServer, client_request
from .warm import (enable_persistent_cache, program_specs,
                   synth_databunch, warm_plan)

__all__ = ["TOAService", "Request", "MicroBatcher", "ServiceServer",
           "client_request", "DEFAULT_SOCKET_NAME", "warm_plan",
           "program_specs", "synth_databunch",
           "enable_persistent_cache", "FleetRouter",
           "DEFAULT_ROUTER_SOCKET_NAME"]
