"""Hierarchical span tracer: request → prefill/decode → layer → phase.

The reference's timing vocabulary is two buckets per token (I/T,
utils.cpp:104-106). This tracer carries the full hierarchy instead, on two
rails that share ONE naming scheme:

* **host spans** — ``SpanTracer.span("step", cat="decode")`` context
  managers around scheduler work (runtime/continuous.py), kept in a
  bounded ring buffer and exported as Chrome-trace/Perfetto JSON
  (``GET /debug/timeline``) or NDJSON;
* **device scopes** — the canonical phase and collective names below,
  the same strings the JAX package's tracer exports, so a timeline or a
  trace from either package buckets the same way.

The names and the export formats are the JAX package's byte for byte:
either package's tools read the other's timelines. Change them here and
there, or nowhere.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import deque

# -- canonical device-scope names (parallel/tp.py emits these) -------------

SCOPE_EMBED = "embed"      # token embedding lookup
SCOPE_ATTN = "attn"        # qkv + rope + attention core + wo (+ its combine)
SCOPE_FFN = "ffn"          # ffn rmsnorm + swiglu + w2 (+ its combine)
SCOPE_LOGITS = "logits"    # final norm + wcls + logits gather
SCOPE_LAYER = "layer"      # the scanned layer body (parent of attn/ffn)
PHASE_SCOPES = (SCOPE_EMBED, SCOPE_ATTN, SCOPE_FFN, SCOPE_LOGITS)

# collective scopes: one per _ici_* helper, named after the helper so a
# trace event inside e.g. `ici_all_gather` is attributable to the exact
# budget term in comm_stats.tp_collective_budget. The mapping to budget
# KINDS mirrors the budget's own accounting: a psum_scatter is charged as
# the reduce_scatter half of the fused Q80 combine.
ICI_SCOPE_PREFIX = "ici_"
SCOPE_ICI_GATHER = "ici_all_gather"
SCOPE_ICI_PSUM = "ici_psum"
SCOPE_ICI_SCATTER = "ici_psum_scatter"
SCOPE_ICI_PPERMUTE = "ici_ppermute"
COLLECTIVE_SCOPE_KINDS = {
    SCOPE_ICI_GATHER: "all_gather",
    SCOPE_ICI_PSUM: "psum",
    SCOPE_ICI_SCATTER: "reduce_scatter",
    SCOPE_ICI_PPERMUTE: "ppermute",
}


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed host span. Times are ``time.perf_counter`` seconds;
    ``depth`` is the nesting level at record time (0 = top level on its
    thread) so exports can rebuild the hierarchy without parent ids."""

    name: str
    cat: str
    t_start: float
    dur_s: float
    tid: int
    depth: int
    meta: dict


class SpanTracer:
    """Thread-safe bounded span recorder.

    ``span()`` is a context manager: it stamps perf_counter on entry and
    records the completed span on exit (exceptions included — a failed
    step still shows up in the timeline, with ``error`` in its meta).
    Each thread keeps its own nesting stack; the buffer is a deque so a
    long-lived server holds the most recent ``capacity`` spans only —
    and overflow is COUNTED, not silent: every
    span the ring evicted bumps ``dropped`` (mirrored into
    ``dllama_spans_dropped_total`` via ``on_drop``) and every export
    carries the count, so a truncated timeline reads as truncated
    instead of quietly misleading.
    """

    def __init__(self, capacity: int = 4096, on_drop=None):
        self._spans: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self.epoch = time.perf_counter()
        self.dropped = 0       # spans evicted by the ring bound
        self.on_drop = on_drop  # e.g. the dllama_spans_dropped_total .inc

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "phase", **meta):
        stack = self._stack()
        depth = len(stack)
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            meta = dict(meta, error=f"{type(e).__name__}: {e}")
            raise
        finally:
            stack.pop()
            self.add(name, cat, t0, time.perf_counter() - t0,
                     depth=depth, **meta)

    def add(self, name: str, cat: str, t_start: float, dur_s: float,
            depth: int = 0, **meta) -> None:
        """Record an already-timed span (e.g. a request's admit→finish
        window derived from its lifecycle timestamps at retirement)."""
        sp = Span(name, cat, t_start, max(dur_s, 0.0),
                  threading.get_ident(), depth, meta)
        overflowed = False
        with self._lock:
            if (self._spans.maxlen is not None
                    and len(self._spans) == self._spans.maxlen):
                # the append below evicts the oldest span: the ring
                # overflow the exports must report
                self.dropped += 1
                overflowed = True
            self._spans.append(sp)
        if overflowed and self.on_drop is not None:
            self.on_drop()

    def snapshot(self, trace_id: str | None = None) -> list:
        """Recorded spans, oldest first; ``trace_id`` filters to one
        trace's spans (the ``/debug/timeline?trace=<id>`` view)."""
        with self._lock:
            spans = list(self._spans)
        if trace_id is not None:
            spans = [s for s in spans
                     if s.meta.get("trace_id") == trace_id]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    # -- exports -----------------------------------------------------------

    def export_chrome(self, trace_id: str | None = None) -> dict:
        """Chrome-trace (Perfetto-loadable) JSON object: complete ('X')
        events, ts/dur in microseconds relative to the tracer epoch. The
        top-level ``dropped`` field counts ring-evicted spans — a viewer
        (or CI) can tell a short timeline from a truncated one."""
        doc = spans_to_chrome(self.snapshot(trace_id), self.epoch)
        doc["dropped"] = self.dropped
        return doc

    def export_ndjson(self, trace_id: str | None = None) -> str:
        """One JSON object per span per line — the log-shipper export
        (and tools/tracejoin.py's input). A final ``_meta`` record
        reports ring overflow whenever any span was dropped."""
        out = []
        for s in self.snapshot(trace_id):
            rec = {"span": s.name, "cat": s.cat,
                   "t_start_s": round(s.t_start - self.epoch, 6),
                   "dur_ms": round(s.dur_s * 1e3, 3),
                   "tid": s.tid, "depth": s.depth}
            rec.update(s.meta)
            out.append(json.dumps(rec))
        if self.dropped:
            out.append(json.dumps({"span": "_meta", "cat": "meta",
                                   "dropped": self.dropped}))
        return "\n".join(out) + ("\n" if out else "")


def spans_to_chrome(spans: list, epoch: float = 0.0) -> dict:
    """Spans → Chrome trace-event JSON (the ``traceEvents`` array form,
    which both chrome://tracing and Perfetto load)."""
    events = []
    for s in spans:
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X",
            # clamp: re-anchored spans (monotonic→perf_counter) can land a
            # hair before the tracer epoch on platforms where the two
            # clocks differ; the viewer needs non-negative timestamps
            "ts": max(round((s.t_start - epoch) * 1e6, 3), 0.0),
            "dur": round(s.dur_s * 1e6, 3),
            "pid": os.getpid(), "tid": s.tid,
            "args": dict(s.meta, depth=s.depth),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(obj) -> None:
    """Schema-check a Chrome trace object (the CI-artifact gate): raises
    ValueError naming the first offending event rather than letting a
    malformed artifact be archived and discovered dead in a viewer."""
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        raise ValueError("chrome trace must be an object with a "
                         "'traceEvents' array")
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}]: not an object")
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            raise ValueError(f"traceEvents[{i}]: missing/empty 'name'")
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "M", "C"):
            raise ValueError(f"traceEvents[{i}]: bad phase {ph!r}")
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            raise ValueError(f"traceEvents[{i}]: bad 'ts' {ev.get('ts')!r}")
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            raise ValueError(f"traceEvents[{i}]: 'X' event needs a "
                             f"non-negative 'dur'")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"traceEvents[{i}]: 'args' must be an object")
