"""repro_torch.service — overlay-as-a-service: the live membership control
plane (the torch port of ``repro.service``).

The batch pipeline (``dynamics.engine`` replaying a finished trace) turned
into a daemon: a long-running process that owns a live
:class:`~repro_torch.overlay.Overlay`, ingests Trace-format churn/latency
events over a versioned HTTP API, answers topology queries from the
incrementally-maintained distance matrix (bounded staleness: served
distances are exact or provable lower bounds), re-optimizes asynchronously
with an atomic double-buffered swap, and crash-recovers from atomic-commit
JSON snapshots.  The maintained distance state lives on the state's device
(``--device``, CUDA by default; ``device="cpu"`` on the CPU), and every
call the state serves, from any handler thread or the re-optimizer's
thread, runs there.

Modules:
  state       — ``ServiceState``: the lock-guarded engine + served Overlay
  server      — ``ServiceServer`` + ``python -m repro_torch.service`` daemon
  reoptimizer — background adapt/DQN worker (capture → optimize → swap →
                snapshot)
  snapshots   — atomic-commit snapshot files (COMMITTED-marker protocol)
  client      — stdlib HTTP client (``ServiceClient``)
"""
from .client import ServiceClient, ServiceError  # noqa: F401
from .reoptimizer import Reoptimizer  # noqa: F401
from .server import ServiceServer  # noqa: F401
from .snapshots import latest_snapshot, list_snapshots, write_snapshot  # noqa: F401
from .state import ReoptJob, ServiceState  # noqa: F401

__all__ = [
    "ServiceClient", "ServiceError", "Reoptimizer", "ServiceServer",
    "ServiceState", "ReoptJob", "write_snapshot", "latest_snapshot",
    "list_snapshots",
]
