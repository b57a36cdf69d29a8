"""Tuple-era protocol helpers — the builders live in ``repro_torch.overlay``.

A copy of ``repro.core.protocols``.  The Chord / RAPID / Perigee
construction rules that once returned raw ``(adjacency, rings)`` tuples are
registered overlay builders; importing a removed name raises
``AttributeError`` with the replacement spelled out, as in the reference::

    from repro_torch import overlay
    ov = overlay.build("chord", w, rng=rng)       # was protocols.chord
    ov.adjacency, ov.rings                        # what the tuple carried

Only :func:`node_degrees` remains — a plain adjacency utility with no
Overlay equivalent at the raw-matrix level.
"""
from __future__ import annotations

import numpy as np

from .diameter import is_edge

__all__ = ["node_degrees"]

_REMOVED = {
    "chord": 'overlay.build("chord", w, rng=rng)',
    "rapid": 'overlay.build("rapid", w, overlay.RapidConfig(k=k), rng=rng)',
    "perigee": 'overlay.build("perigee", w, overlay.PerigeeConfig(...), rng=rng)',
    "with_replaced_rings": "Overlay.replace_rings(new_rings)",
}


def __getattr__(name: str):
    if name in _REMOVED:
        raise AttributeError(
            f"repro_torch.core.protocols.{name} was removed; use "
            f"{_REMOVED[name]} (the repro_torch.overlay API replaced "
            f"(adjacency, rings) tuples; see overlay.build)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def node_degrees(adj: np.ndarray) -> np.ndarray:
    """Per-node overlay degree (number of actual edges per row)."""
    return is_edge(adj).sum(axis=1)
