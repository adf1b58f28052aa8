"""Structured logging — the port's own copy of the JAX package's
``utils/logging.py``: one ``rtfds`` logger tree, configured once.

Environment knobs (read at the first :func:`get_logger` call):

- ``RTFDS_LOG_LEVEL`` — the tree's level (a level name or number; an
  unknown value keeps INFO and says so);
- ``RTFDS_LOG_JSON=1`` — JSON lines instead of the human format. Each
  line carries the current batch's trace id (``utils/trace.py``), so a
  log line can be matched with its span waterfall.
"""

from __future__ import annotations

import json
import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


class JsonLineFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, message, and the
    current trace and batch id."""

    def format(self, record: logging.LogRecord) -> str:
        # imported here: the trace module is loaded after this one
        from real_time_fraud_detection_system_tpu_torch.utils.trace import (
            current_ids,
        )

        trace_id, batch = current_ids()
        out = {
            "t": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if trace_id:
            out["trace_id"] = trace_id
            out["batch"] = batch
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, separators=(",", ":"), default=str)


def _resolve_level(spec: str) -> int:
    try:
        return int(spec)
    except ValueError:
        pass
    level = logging.getLevelName(spec.strip().upper())
    return level if isinstance(level, int) else -1


def get_logger(name: str = "rtfds") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        if os.environ.get("RTFDS_LOG_JSON", "") not in ("", "0"):
            handler.setFormatter(JsonLineFormatter())
        else:
            handler.setFormatter(
                logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root = logging.getLogger("rtfds")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        spec = os.environ.get("RTFDS_LOG_LEVEL", "")
        if spec:
            level = _resolve_level(spec)
            if level >= 0:
                root.setLevel(level)
            else:
                root.warning(
                    "RTFDS_LOG_LEVEL=%r is not a known level; keeping "
                    "INFO", spec)
        root.propagate = False
        _configured = True
    if name == "rtfds" or name.startswith("rtfds."):
        return logging.getLogger(name)
    return logging.getLogger(f"rtfds.{name}")
