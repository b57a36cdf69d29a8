"""Versioned JSON payloads — the repo's serialization contract.

A copy of ``repro.serde`` (the port imports nothing of ``repro``): both
packages must stamp and accept the same schemas, so an ``Overlay`` written
by one is read by the other byte for byte.

Every durable JSON surface (``Overlay.to_json``, ``Trace.to_json``, the
``repro.service`` API envelopes and its checkpoint snapshots) carries a
``"schema"`` field so readers can refuse payloads from a *future* writer
instead of mis-parsing them.  The rules:

* flat writers stamp ``"schema": SCHEMA_VERSION`` (currently 1) — every
  payload shape that existed before hierarchical overlays keeps emitting
  byte-identical schema-1 JSON;
* hierarchical payloads (``HierarchicalOverlay.to_json``, the service's
  hierarchical snapshots) stamp ``"schema": HIER_SCHEMA`` (2) via
  ``dumps(d, schema=HIER_SCHEMA)``;
* readers accept any schema ``<= MAX_SCHEMA`` — including payloads with
  NO schema field at all (everything serialized before this module
  existed is schema-1 by definition);
* readers reject unknown *future* schemas with a :class:`SchemaError`
  naming both versions, so a daemon fed a v3 snapshot fails loudly at
  the boundary rather than deep inside array parsing.

``dumps``/``check_schema`` are deliberately tiny — the point is that every
surface shares ONE version constant and ONE rejection message, not that
serialization itself is abstracted away.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

__all__ = ["SCHEMA_VERSION", "HIER_SCHEMA", "MAX_SCHEMA", "SchemaError",
           "check_schema", "payload_schema", "dumps", "loads"]

SCHEMA_VERSION = 1      # flat payloads: unchanged, byte-for-byte
HIER_SCHEMA = 2         # hierarchical-overlay payloads
MAX_SCHEMA = 2          # newest schema this reader understands


class SchemaError(ValueError):
    """Payload written by a newer (unknown) schema than this reader."""


def payload_schema(d: Dict[str, Any]) -> int:
    """The schema version a parsed payload was written under (absent = 1)."""
    v = d.get("schema", 1)
    if not isinstance(v, int) or v < 1:
        raise SchemaError(f"payload has malformed schema field {v!r}")
    return v


def check_schema(d: Dict[str, Any], what: str = "payload") -> Dict[str, Any]:
    """Validate ``d``'s schema field and return ``d``.

    Version-absent payloads are legacy schema-1; anything newer than
    :data:`MAX_SCHEMA` raises :class:`SchemaError`.
    """
    v = d.get("schema", 1)
    if not isinstance(v, int) or v < 1:
        raise SchemaError(f"{what} has malformed schema field {v!r}")
    if v > MAX_SCHEMA:
        raise SchemaError(
            f"{what} uses schema {v}, but this reader only understands "
            f"<= {MAX_SCHEMA}; upgrade the reader (or re-export the "
            f"payload from the older writer)")
    return d


def dumps(d: Dict[str, Any], *, schema: Optional[int] = None, **kw) -> str:
    """``json.dumps`` with a schema stamped in (default: flat schema 1)."""
    v = SCHEMA_VERSION if schema is None else int(schema)
    if not 1 <= v <= MAX_SCHEMA:
        raise SchemaError(f"cannot write unknown schema {v}")
    kw.setdefault("sort_keys", True)
    return json.dumps({**d, "schema": v}, **kw)


def loads(s: str, what: str = "payload") -> Dict[str, Any]:
    """``json.loads`` + :func:`check_schema`."""
    d = json.loads(s)
    if not isinstance(d, dict):
        raise SchemaError(f"{what} must be a JSON object, got {type(d).__name__}")
    return check_schema(d, what)
