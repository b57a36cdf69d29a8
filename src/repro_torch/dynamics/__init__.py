"""repro_torch.dynamics — churn-driven dynamic overlay engine, ported.

The same surface as ``repro.dynamics``.  Submodules:
  incremental — exact O(N^2) APSP repair under edge inserts / node joins,
                tombstone + threshold-rebuild under deletions (rebuilds
                through ``core.batcheval``: K1 / K2 + K1 on the card),
                batched replica variants over a (B, C, C) stack
  scenarios   — replayable churn traces (JSON, byte-identical to the
                reference's) + the scenario library (poisson churn, flash
                crowd, regional failure, diurnal drift, straggler storm)
  engine      — discrete-event replay of a trace against an overlay policy
                (DGRO / Chord / RAPID / Perigee) with SWIM failure
                confirmation and DGRO ring-selection self-repair

The distance state lives on ``batcheval.eval_device()``: CUDA unless the
caller asks for the CPU (``batcheval.eval_options(device="cpu")``).
"""
from . import engine, incremental, scenarios  # noqa: F401
from .engine import (ChordPolicy, ChurnEngine, DGROPolicy, PerigeePolicy,  # noqa: F401
                     POLICIES, RapidPolicy, RunResult)
from .incremental import IncrementalDistances  # noqa: F401
from .scenarios import SCENARIOS, Event, Trace  # noqa: F401
