"""String-keyed overlay builder registry.

Builders are functions ``fn(w, cfg, rng) -> Overlay`` registered under a
policy name together with their config dataclass::

    @register("chord", config=ChordConfig)
    def _build_chord(w, cfg, rng):
        ...

Consumers construct overlays without touching policy internals::

    ov = overlay.build("chord", w, seed=0)                  # default config
    ov = overlay.build("rapid", w, RapidConfig(k=4), rng=rng)
    ov = overlay.build("perigee", w, ring="nearest", seed=3)  # field override

New policies plug in through ``@register`` instead of editing call sites.
``"dgro-hier"`` lives in ``repro_torch.hier`` and registers itself when
that package is imported; the registry imports it on first use.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from .core import Overlay

__all__ = ["register", "build", "builders", "get_builder", "BuilderSpec"]

BuilderFn = Callable[[np.ndarray, object, np.random.Generator], Overlay]


@dataclasses.dataclass(frozen=True)
class BuilderSpec:
    name: str
    fn: BuilderFn
    config_cls: Optional[type]
    # "flat" builders return a dense Overlay; "hier" builders return a
    # HierarchicalOverlay (topology-protocol object, no dense adjacency) —
    # flat-only invariants (global ring routing, dense APSP parity) filter
    # on this
    kind: str = "flat"

    def default_config(self, **overrides):
        if self.config_cls is None:
            if overrides:
                raise ValueError(
                    f"builder {self.name!r} takes no config fields, got "
                    f"{sorted(overrides)}")
            return None
        return self.config_cls(**overrides)


_REGISTRY: Dict[str, BuilderSpec] = {}

# builders that live OUTSIDE repro_torch.overlay (above it in the layering)
# and self-register on import: resolved lazily so `import
# repro_torch.overlay` stays light and the layering stays acyclic
_LAZY_MODULES: Dict[str, str] = {"dgro-hier": "repro_torch.hier"}


def _resolve_lazy(name: Optional[str] = None) -> None:
    import importlib
    for key, module in _LAZY_MODULES.items():
        if (name is None or name == key) and key not in _REGISTRY:
            importlib.import_module(module)

def register(name: str, *, config: Optional[type] = None,
             kind: str = "flat"):
    """Decorator: register an overlay builder under ``name``."""

    def deco(fn: BuilderFn) -> BuilderFn:
        if name in _REGISTRY:
            raise ValueError(f"builder {name!r} already registered")
        _REGISTRY[name] = BuilderSpec(name=name, fn=fn, config_cls=config,
                                      kind=kind)
        return fn

    return deco


def builders() -> Dict[str, Optional[type]]:
    """Registered builder names -> config class (None = no config)."""
    _resolve_lazy()
    return {name: spec.config_cls for name, spec in sorted(_REGISTRY.items())}


def get_builder(name: str) -> BuilderSpec:
    _resolve_lazy(name)
    try:
        return _REGISTRY[name]
    except KeyError:
        _resolve_lazy()     # the message must list lazy builders too
        # sorted, comma-joined: a stable message tests/docs can rely on
        raise ValueError(
            f"unknown overlay builder {name!r}; registered builders: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def build(name: str, w: np.ndarray, cfg=None, *,
          rng: np.random.Generator | None = None, seed: int = 0,
          **overrides) -> Overlay:
    """Build a named overlay over the latency matrix ``w``.

    ``cfg`` is the builder's config dataclass instance; when omitted, the
    default config is built with ``overrides`` applied as field values.
    Randomness comes from ``rng`` (or ``np.random.default_rng(seed)``).

    Beside the paper's diameter-oriented builders (``"dgro"``,
    ``"dgro-dqn"``, ``"chord"``, ``"rapid"``, ``"perigee"``, ``"ga"``,
    ``"nearest"``, ``"random"``, ``"parallel"``), two routing-native
    small-world baselines back the ``repro_torch.routing`` workloads:

    * ``"kleinberg"`` — base ring + ``q`` long links per node drawn with
      probability ∝ ``1/ringdist^exponent`` (harmonic at the default
      exponent 1.0, the greedy-routable optimum for a 1-D ring);
    * ``"papillon"`` — deterministic bounded-degree cyclic-butterfly long
      links (arity ``k``), ring-greedy routable in O(log N) hops.

    ``builders()`` lists everything currently registered.
    """
    spec = get_builder(name)
    if cfg is not None and overrides:
        raise ValueError("pass either cfg or field overrides, not both")
    if cfg is None:
        cfg = spec.default_config(**overrides)
    elif spec.config_cls is not None and not isinstance(cfg, spec.config_cls):
        raise TypeError(
            f"builder {name!r} expects {spec.config_cls.__name__}, got "
            f"{type(cfg).__name__}")
    if rng is None:
        rng = np.random.default_rng(seed)
    w = np.asarray(w, dtype=np.float32)
    ov = spec.fn(w, cfg, rng)
    if ov.policy != name:     # builders may leave the stamping to the registry
        # in-place stamp on the freshly built (unaliased) instance: keeps the
        # derived adjacency and any cache_diameter() the builder pre-seeded
        object.__setattr__(ov, "policy", name)
    return ov
