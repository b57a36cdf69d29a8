"""Structured stdlib logging: one-line ``key=value`` records.

A copy of ``repro.obs.logsetup`` under the port's own ``repro_torch``
logger namespace (so the two packages never reconfigure each other's
handlers in one process), formatted as greppable single-line records::

    ts=2026-08-08T12:00:01.123Z level=info logger=repro_torch.example \
event=unit.test n=1 ok=true

Control the level with ``REPRO_LOG_LEVEL`` (debug/info/warning/error;
default ``warning`` so library use stays quiet) — the same variable as the
reference.  ``configure()`` is idempotent and only touches the
``repro_torch`` logger — embedding applications keep their root logging
config.

Use :func:`kv` to build the message payload — it quotes values containing
whitespace and renders floats compactly::

    log = get_logger(__name__)
    log.info(kv("reopt.cycle", outcome="swapped", edges=12, ms=34.5))
"""
from __future__ import annotations

import logging
import os
import sys
import time
from typing import Optional

__all__ = ["configure", "get_logger", "kv", "ENV_LEVEL"]

ENV_LEVEL = "REPRO_LOG_LEVEL"
_ROOT = "repro_torch"
_configured = False


def kv(event: str, **fields) -> str:
    """``event=<event> k=v ...`` with minimal quoting."""
    parts = [f"event={_quote(event)}"]
    for k, v in fields.items():
        parts.append(f"{k}={_quote(v)}")
    return " ".join(parts)


def _quote(v) -> str:
    if isinstance(v, float):
        s = f"{v:.6g}"
    elif isinstance(v, bool):
        s = str(v).lower()
    else:
        s = str(v)
    if any(c in s for c in ' "=\n') or s == "":
        s = '"' + s.replace("\\", "\\\\").replace('"', '\\"') \
                   .replace("\n", "\\n") + '"'
    return s


class KVFormatter(logging.Formatter):
    """``ts=<iso8601Z> level=<lvl> logger=<name> <message>``."""

    converter = time.gmtime

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", self.converter(record.created))
        ms = int(record.msecs)
        head = (f"ts={ts}.{ms:03d}Z level={record.levelname.lower()} "
                f"logger={record.name}")
        msg = record.getMessage()
        line = f"{head} {msg}" if msg else head
        if record.exc_info:
            line += " exc=" + _quote(self.formatException(record.exc_info))
        return line


def _level_from_env(default: str) -> int:
    name = os.environ.get(ENV_LEVEL, default).strip().upper()
    level = logging.getLevelName(name)
    if not isinstance(level, int):
        return logging.getLevelName(default.upper())
    return level


def configure(default: str = "warning", *, stream=None,
              force: bool = False) -> logging.Logger:
    """Install the kv handler on the ``repro_torch`` logger (idempotent).

    ``REPRO_LOG_LEVEL`` overrides ``default``; ``force=True`` reinstalls
    (tests changing the env var mid-process).
    """
    global _configured
    root = logging.getLogger(_ROOT)
    if _configured and not force:
        return root
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(KVFormatter())
    root.addHandler(handler)
    root.setLevel(_level_from_env(default))
    root.propagate = False
    _configured = True
    return root


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Logger under the ``repro_torch`` namespace, configuring on first use."""
    configure()
    if not name or name == _ROOT:
        return logging.getLogger(_ROOT)
    if not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
