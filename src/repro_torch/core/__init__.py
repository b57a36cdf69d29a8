"""DGRO core, ported: the algorithms the overlay builders are made of.

Submodules (each mirrors ``repro.core.<name>``):
  topology      — the four latency distributions of §VII-A (numpy)
  diameter      — min-plus APSP on tensors + scipy oracle, largest-CC rule
  batcheval     — streaming (B, N, N) diameter engine over the min-plus
                  kernels
  construction  — Algorithm 1 ring constructors (random/nearest/greedy/K-ring)
  selection     — Algorithm 3 gossip latency measurement + rho ring selection
  ga            — genetic-algorithm and random-search baselines (§VII-A.2)
"""
