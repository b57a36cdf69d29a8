"""repro_torch.hier — hierarchical overlays for N = 10^5..10^6 fleets (the
torch port of ``repro.hier``).

The flat :class:`repro_torch.overlay.Overlay` holds the full (N, N) latency
matrix: 40 GB of float32 at N = 10^5, and DGRO construction is
O(N^2 log N).  Following the paper's §VI composition argument (parallel
partition construction composes into two-level hierarchies), this
package partitions the fleet into latency-coherent clusters, builds a
cluster-local flat DGRO overlay per partition — ALL clusters of a chunk
in one device batch via ``nearest_rings_batched`` — and a DGRO head ring
over one representative ("head") per cluster.  Memory and construction
cost drop to O(sum_c P_c^2 + M^2).

Layout:

  geo      — lazy latency models (``LatencyModel``): block-on-demand
             synthetic geography so N = 10^5 never materializes (N, N)
  core     — clustering, fused construction, ``HierarchicalOverlay``
             (the second :class:`repro_torch.overlay.Topology`
             implementation;
             schema-2 serde), the ``"dgro-hier"`` registry builder
  routing  — three-leg greedy routing (cluster -> head ring -> cluster)
             reusing the packed-neighbour-table router per level
  engine   — ``HierChurnEngine``: cluster-local incremental maintenance;
             the head ring is touched only on head death / drain /
             split / merge

Distance/diameter bounds keep the stack-wide contract: stamped
``"exact"`` or ``"lower"`` (``"upper"`` for diameter estimates), never
silently approximate.  Importing this package registers the
``"dgro-hier"`` builder with :mod:`repro_torch.overlay` (the registry also
lazy-imports it on first use).  Device work (the clusters' nearest rings,
every APSP) runs on the eval device: CUDA unless the caller asks for the
CPU through ``batcheval.eval_options(device="cpu")``.
"""
from .core import (HierConfig, HierarchicalOverlay,  # noqa: F401
                   assign_latency_clusters, build_hier,
                   default_cluster_size)
from .engine import HierChurnEngine  # noqa: F401
from .geo import (DenseLatency, LatencyModel, SubsetLatency,  # noqa: F401
                  SyntheticGeo, as_latency, latency_from_spec,
                  synthetic_geo)
from .routing import (HierRouteResult, route_pairs_hier,  # noqa: F401
                      route_single_hier)

__all__ = [
    "HierConfig", "HierarchicalOverlay", "build_hier",
    "assign_latency_clusters", "default_cluster_size",
    "HierChurnEngine",
    "LatencyModel", "DenseLatency", "SyntheticGeo", "SubsetLatency",
    "synthetic_geo", "as_latency", "latency_from_spec",
    "HierRouteResult", "route_pairs_hier", "route_single_hier",
]
