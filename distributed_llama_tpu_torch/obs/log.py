"""Structured event log: optional newline-delimited JSON.

The repo's runtime narration is emoji-prefixed prints (🌐 server lines,
⏩ load/fetch lines, 🔶 per-token stats). Those stay the human default;
``DLLAMA_LOG_JSON=1`` (or the ``--log-json`` CLI flag) reroutes each site
through here as one machine-parseable JSON object per line, so a log
shipper gets typed fields instead of emoji scraping. The print sites in
runtime/server.py, runtime/generate.py, and io/stream.py call
``log_event(event, text, **fields)``: JSON mode emits
``{"ts", "event", **fields}``; text mode prints ``text`` verbatim (or
nothing when text is None — a JSON-only event).

Every NDJSON record additionally carries the run-config header
(utils/fingerprint.run_stamp): ``tp_scheme``, the ``DLLAMA_Q40_BODY``
policy, and the same ``env_fingerprint`` bench.py records per row — so a
log stream is JOINABLE with BENCH_* rows and profiler captures by
session basis. Explicit fields win over the stamp on key collision.
"""

from __future__ import annotations

import json
import os
import sys
import time


def json_mode() -> bool:
    """DLLAMA_LOG_JSON=1 switches every routed print site to NDJSON."""
    return os.environ.get("DLLAMA_LOG_JSON", "") not in ("", "0")


def log_event(event: str, text: str | None = None, *, file=None,
              trace=None, **fields) -> None:
    """Emit one log line: NDJSON in json_mode(), else the human text.

    ``file`` defaults to stdout (the emoji sites' stream); pass
    ``sys.stderr`` for diagnostics. ``trace`` (an obs/tracectx
    TraceContext) stamps the record with ``trace_id``/``span_id`` from
    the ONE id producer, so NDJSON logs join span timelines and journal
    records by id. Non-JSON-serializable field
    values degrade to ``repr`` rather than raising — a log line must
    never take down the loop that emits it.
    """
    out = sys.stdout if file is None else file
    if json_mode():
        rec = {"ts": round(time.time(), 6), "event": event}
        if trace is not None:
            from .tracectx import span_fields

            rec.update(span_fields(trace))
        try:
            from ..utils.fingerprint import run_stamp

            rec.update(run_stamp())
        except Exception:  # noqa: BLE001 - the stamp must never kill a line
            pass
        rec.update(fields)
        try:
            line = json.dumps(rec)
        except (TypeError, ValueError):
            line = json.dumps({k: repr(v) for k, v in rec.items()})
        print(line, file=out, flush=True)
    elif text is not None:
        print(text, file=out)
