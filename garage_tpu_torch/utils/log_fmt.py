"""Structured log formatting with trace correlation.

Every record emitted while a tracing span is active is stamped with the
span's `trace_id`/`span_id` (hex), so bench and chaos logs can be joined
against exported traces — grep a trace id from the OTLP sink and the
matching daemon log lines fall out.  With no active span (or tracing
off) the fields are empty strings, never missing: format strings and
JSON consumers see a stable schema.

Two output shapes, selected by config (`log_format = "text" | "json"`,
env override GARAGE_LOG_FORMAT):

  text   classic single-line, with a `[trace_id]` suffix only when one
         is present (quiet logs stay quiet)
  json   JSON lines — one object per record (ts, level, logger, msg,
         trace_id, span_id, + exc when present), the shape log
         pipelines ingest without a parse grammar

`setup_logging()` is the one entry point (cli/main.py calls it at
process start and re-applies it once the config is read).
"""

from __future__ import annotations

import json
import logging
import time


class TraceContextFilter(logging.Filter):
    """Stamps `record.trace_id` / `record.span_id` from the current
    tracing span.  A Filter (not a Formatter) so every handler — text,
    JSON, a test's capture handler — sees the fields."""

    def filter(self, record: logging.LogRecord) -> bool:
        from .tracing import tracer

        s = tracer.current()
        if s is not None:
            record.trace_id = s.trace_id.hex()
            record.span_id = s.span_id.hex()
        else:
            record.trace_id = ""
            record.span_id = ""
        return True


class TextFormatter(logging.Formatter):
    """Classic text line + ` [trace=<id> span=<id>]` suffix when traced."""

    def __init__(self):
        super().__init__("%(asctime)s %(name)s %(levelname)s %(message)s")

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        tid = getattr(record, "trace_id", "")
        if tid:
            line += f" [trace={tid} span={getattr(record, 'span_id', '')}]"
        return line


class JsonLinesFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(
                record.created if record.created else time.time(), 6
            ),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "trace_id": getattr(record, "trace_id", ""),
            "span_id": getattr(record, "span_id", ""),
        }
        if record.exc_info and record.exc_info[0] is not None:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=repr)


def setup_logging(fmt: str = "text", level: str | int = "INFO") -> None:
    """(Re)configure the root logger: one stderr handler with the chosen
    formatter and the trace-context filter.  Idempotent — safe to call
    again after the config file is read."""
    root = logging.getLogger()
    root.setLevel(level)
    # replace only handlers we installed (marked), preserving pytest's
    # capture handlers and anything the embedding app configured
    for h in list(root.handlers):
        if getattr(h, "_garage_log_fmt", False):
            root.removeHandler(h)
    handler = logging.StreamHandler()
    handler._garage_log_fmt = True  # type: ignore[attr-defined]
    handler.setFormatter(
        JsonLinesFormatter() if fmt == "json" else TextFormatter()
    )
    handler.addFilter(TraceContextFilter())
    root.addHandler(handler)
