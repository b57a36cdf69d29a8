"""Atomic-commit service snapshots (crash recovery for
``repro_torch.service``; a copy of ``repro.service.snapshots``, host only).

Same contract as the JAX package's ``repro.checkpoint``: everything is
written into ``snap_<seq>.tmp``, the ``COMMITTED`` marker is written LAST,
and the directory is renamed into place — readers ignore directories
without the marker, so a daemon killed mid-save (or mid-reoptimize,
between the overlay swap and the snapshot commit) can never restore a torn
snapshot; it comes back on the previous committed one.

The payload is one ``state.json`` (``repro_torch.serde`` schema-versioned):
the full capacity-level world — current latency matrix, overlay edge list,
alive mask, drift/straggler factors, the policy's ring membership — plus
the counters and the exact diameter at commit time, so a restart can verify
it serves the same topology the snapshot recorded.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import serde

__all__ = ["write_snapshot", "latest_snapshot", "list_snapshots"]

_MARKER = "COMMITTED"           # the atomic-commit marker of repro.checkpoint


def _snap_dir(directory: str, seq: int) -> str:
    return os.path.join(directory, f"snap_{seq:08d}")


def write_snapshot(directory: str, seq: int, payload: Dict[str, Any], *,
                   keep: int = 3, schema: Optional[int] = None) -> str:
    """Atomically commit ``payload`` as snapshot ``seq``; prune old ones.

    ``schema`` stamps the payload's serde schema (default flat schema 1;
    hierarchical service snapshots pass ``serde.HIER_SCHEMA``).  Returns
    the committed directory path.
    """
    os.makedirs(directory, exist_ok=True)
    final = _snap_dir(directory, seq)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "state.json"), "w") as f:
        f.write(serde.dumps(payload, schema=schema))
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for s in list_snapshots(directory)[:-keep]:
        shutil.rmtree(_snap_dir(directory, s), ignore_errors=True)
    return final


def list_snapshots(directory: str) -> List[int]:
    """Committed snapshot sequence numbers, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if (name.startswith("snap_") and not name.endswith(".tmp")
                and os.path.exists(os.path.join(path, _MARKER))):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_snapshot(directory: str) -> Optional[Tuple[int, Dict[str, Any]]]:
    """(seq, payload) of the newest committed snapshot, or None."""
    seqs = list_snapshots(directory)
    if not seqs:
        return None
    seq = seqs[-1]
    with open(os.path.join(_snap_dir(directory, seq), "state.json")) as f:
        raw = f.read()
    try:
        payload = serde.loads(raw, what=f"service snapshot {seq}")
    except json.JSONDecodeError as e:
        raise ValueError(
            f"committed snapshot {seq} holds unparseable JSON: {e}") from e
    return seq, payload
