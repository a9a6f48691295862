"""W3C-traceparent-style distributed trace context.

A request can be a DISTRIBUTED object — it can cross a prefill pool,
a page channel, a decode pool and a journal recovery — but every span
the observability stack records is keyed by nothing that survives a
process boundary. This module is the missing identity: a Dapper-shaped
(trace_id, span_id, parent_id) triple minted ONCE at request ingress
(runtime/server.py)
and carried everywhere the request goes —

* on ``runtime/continuous.Request`` (``.trace``), into every span the
  engine records for that request (obs/spans.py meta);
* in the journal admit record (``runtime/journal.py`` ``"trace"`` key)
  and therefore through crash recovery AND the prefill->decode handoff
  wire form (``entry_to_wire``/``entry_from_wire``) — a recovered or
  handed-off continuation keeps the SAME trace_id, opening a new span
  whose ``link`` names the seam it crossed (``recovers``/``handoff``);
* across the ``POST /prefill`` RPC and the page channel's publish store
  as the serialized traceparent header.

One id producer: every trace_id/span_id in the process comes from
``new_trace_id``/``new_span_id`` below — spans, logs (obs/log.py), and
journal records can join on ids because nothing else mints them.
Defaults are os.urandom (ids must not collide ACROSS pools); tests that
need reproducible ids install a seeded producer with ``seed_ids``.

Header form (the W3C traceparent layout, version 00, sampled flag
always on — this repo traces everything it admits):

    00-<32 hex trace_id>-<16 hex span_id>-01
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading

HEADER_VERSION = "00"
TRACE_ID_HEX = 32
SPAN_ID_HEX = 16

# continuation-link kinds: the seam a trace crossed to reach this span
LINK_RECOVERS = "recovers"   # journal replay after a crash/drain
LINK_HANDOFF = "handoff"     # prefill->decode disaggregation hand-over
LINK_KINDS = (LINK_RECOVERS, LINK_HANDOFF)

_lock = threading.Lock()
_seeded: random.Random | None = None  # test hook (seed_ids)


def seed_ids(seed: int | None) -> None:
    """Install (or with None remove) a seeded id producer — TEST hook
    only: deterministic ids collide across processes by construction,
    which is exactly what production ids must never do."""
    global _seeded
    with _lock:
        _seeded = None if seed is None else random.Random(seed)


def _hex(n_hex: int) -> str:
    with _lock:
        if _seeded is not None:
            return "".join(_seeded.choice("0123456789abcdef")
                           for _ in range(n_hex))
    return os.urandom(n_hex // 2).hex()


def new_trace_id() -> str:
    """The ONE trace-id mint (32 hex chars, never all-zero)."""
    tid = _hex(TRACE_ID_HEX)
    return tid if tid.strip("0") else new_trace_id()


def new_span_id() -> str:
    """The ONE span-id mint (16 hex chars, never all-zero)."""
    sid = _hex(SPAN_ID_HEX)
    return sid if sid.strip("0") else new_span_id()


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One span's identity within a trace. ``parent_id`` is the span
    this one descends from (None = a trace root); ``link`` names the
    process-boundary seam this continuation crossed (None = same-process
    child)."""

    trace_id: str
    span_id: str
    parent_id: str | None = None
    link: str | None = None

    def __post_init__(self):
        if len(self.trace_id) != TRACE_ID_HEX or not _is_hex(self.trace_id):
            raise ValueError(f"bad trace_id {self.trace_id!r}: want "
                             f"{TRACE_ID_HEX} hex chars")
        if len(self.span_id) != SPAN_ID_HEX or not _is_hex(self.span_id):
            raise ValueError(f"bad span_id {self.span_id!r}: want "
                             f"{SPAN_ID_HEX} hex chars")
        if self.link is not None and self.link not in LINK_KINDS:
            raise ValueError(f"unknown trace link {self.link!r} "
                             f"(have {LINK_KINDS})")

    def child(self, link: str | None = None) -> "TraceContext":
        """A new span under this one: same trace, fresh span id, parent
        set — the in-process descent, or (with ``link``) a continuation
        that crossed a seam."""
        return TraceContext(trace_id=self.trace_id, span_id=new_span_id(),
                            parent_id=self.span_id, link=link)

    def to_header(self) -> str:
        """The serialized traceparent (what rides wires and journals).
        parent_id/link are per-hop state, deliberately NOT serialized:
        the receiver derives its own parent (= this header's span_id)."""
        return f"{HEADER_VERSION}-{self.trace_id}-{self.span_id}-01"


def mint(link: str | None = None) -> TraceContext:
    """A fresh trace root — request ingress calls this exactly once per
    request."""
    return TraceContext(trace_id=new_trace_id(), span_id=new_span_id(),
                        link=link)


def parse_header(header: str) -> TraceContext:
    """Parse a traceparent header back into the SENDER's context (its
    span_id — what a receiver should parent on). Raises ValueError on
    anything malformed: a half-parsed trace identity would silently
    unjoin the two pools' timelines, which is the failure this whole
    layer exists to surface."""
    if not isinstance(header, str):
        raise ValueError(f"traceparent must be a string, got "
                         f"{type(header).__name__}")
    parts = header.split("-")
    if len(parts) != 4 or parts[0] != HEADER_VERSION:
        raise ValueError(f"malformed traceparent {header!r}")
    return TraceContext(trace_id=parts[1], span_id=parts[2])


def from_header(header: str, link: str | None = None) -> TraceContext:
    """The receiving side of a propagation hop: continue the header's
    trace in a NEW span parented on the sender's. ``link`` marks the
    seam (recovers/handoff) for continuation records."""
    return parse_header(header).child(link=link)


def span_fields(ctx: "TraceContext | None") -> dict:
    """The trace identity as flat span/log/NDJSON fields (None-valued
    members omitted) — the one spelling every export uses, so exports
    join without per-surface field-name translation."""
    if ctx is None:
        return {}
    out = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
    if ctx.parent_id is not None:
        out["parent_span_id"] = ctx.parent_id
    if ctx.link is not None:
        out["link"] = ctx.link
    return out


def _is_hex(s: str) -> bool:
    return all(c in "0123456789abcdef" for c in s)
