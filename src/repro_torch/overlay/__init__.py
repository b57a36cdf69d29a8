"""repro_torch.overlay — the unified overlay API, ported.

The same surface as ``repro.overlay``: an immutable :class:`Overlay`
(numpy latency matrix, embedded rings, derived adjacency) plus a
string-keyed builder registry::

    from repro_torch import overlay
    from repro_torch.core.topology import make_latency

    w = make_latency("fabric", 4096, seed=0)
    ov = overlay.build("dgro", w, seed=0)        # candidates scored on CUDA
    ov.diameter()
    overlay.Overlay.from_json(ov.to_json())      # byte-identical to repro's

Registered builders:

====================  =====================================================
builder               paper section
====================  =====================================================
``"dgro"``            §V adaptive selection: rho-guided random/nearest ring
                      mix, best candidate by batched diameter (Alg. 3)
``"dgro-dqn"``        §IV Algs. 1-2: deep-Q constructor (graph embedding +
                      Q-head), best of n_starts greedy constructions
``"parallel"``        §VI Alg. 4: M-partition batched construction + stitch
``"chord"``           §II/§V-A baseline: identifier ring + 2^j fingers
``"rapid"``           §V-A baseline: K consistent-hash rings
``"perigee"``         §V-A baseline: d nearest neighbours + one ring
``"ga"``              §VII-A.2 genetic-algorithm K-ring search
``"nearest"``         §V "shortest ring": greedy nearest-available
``"random"``          §IV-B random K-ring (the paper's normalizer)
``"kleinberg"``       routing baseline: base ring + q harmonic long links
``"papillon"``        routing baseline: bounded-degree butterfly long links
``"dgro-hier"``       §VI composed: cluster-local rings + a DGRO ring over
                      cluster heads (``repro_torch.hier``, imported lazily)
====================  =====================================================
"""
from .core import Overlay  # noqa: F401
from .protocol import Topology, from_topology_json  # noqa: F401
from .registry import build, builders, get_builder, register  # noqa: F401
from .policies import (ChordConfig, DGROConfig,  # noqa: F401
                       DGRODQNConfig, GAConfig, KleinbergConfig,
                       NearestRingsConfig, PapillonConfig, ParallelConfig,
                       PerigeeConfig, RandomRingsConfig, RapidConfig,
                       chord_finger_edges, nearest_neighbour_edges)

__all__ = [
    "Overlay", "Topology", "from_topology_json",
    "build", "builders", "get_builder", "register",
    "ChordConfig", "DGROConfig", "DGRODQNConfig", "GAConfig",
    "KleinbergConfig", "NearestRingsConfig", "PapillonConfig",
    "ParallelConfig", "PerigeeConfig", "RandomRingsConfig", "RapidConfig",
    "chord_finger_edges", "nearest_neighbour_edges",
]
