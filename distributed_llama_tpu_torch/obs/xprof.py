"""Profiler capture loader: a trace's time by phase and by collective (the
JAX package's obs/xprof.py).

Input is either of:

* the port's own **torch.profiler Chrome trace** — a ``--profile``
  directory (the newest ``*.pt.trace.json`` under it, as
  utils/it_split.find_trace resolves it) or the file itself. The op events
  are utils/it_split.parse_trace's: on the card the kernel events, on the
  CPU each thread's top-level ``cpu_op`` events, plus the tensor-parallel
  collectives' ``tp::<kind>`` host spans where no collective is a kernel
  (gloo). Each event is bucketed by the innermost phase span around it —
  the ``record_function`` ranges that models/llama.py and parallel/tp.py
  open while a profiler runs, named by obs/spans.py (embed, attn, ffn,
  logits). A CPU op is inside a span on its thread by time; a kernel
  through its launch: the runtime call that carries the kernel's
  ``correlation`` id, inside a span on the launching thread. A kernel
  replayed from a CUDA graph was launched by ``cudaGraphLaunch``, which
  no phase span encloses, so it lands in ``unattributed``: coverage is
  reported, never guessed;
* a **synthetic capture fixture** (``*.json``, schema ``dllama-trace/1``,
  tests/fixtures/traces/), events aggregated with counts and bytes and the
  (model, tp, scheme, buffer) header, read exactly as the JAX package
  reads it.

Output is one ``Attribution``: ms a phase, count/bytes/ms a collective
kind, the total, and the token count to divide by. A collective inside a
phase counts in both tables (the phase owns its time; the kind table
feeds obs/drift). From a Chrome trace the token count is the forwards the
trace holds (its ``embed`` spans) unless the caller gives one, and
``logits_skipped`` the forwards that skipped the logits (a prefill chunk's:
one logits gather less each). Chrome traces carry no byte counts, so
``bytes`` is None there.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re

from ..utils.it_split import (_COLLECTIVE_RE, SPAN_PREFIX, WAIT_SPAN,
                              _top_level, base_name, find_trace)
from .spans import (COLLECTIVE_SCOPE_KINDS, PHASE_SCOPES, SCOPE_EMBED,
                    SCOPE_LOGITS)

FIXTURE_SCHEMA = "dllama-trace/1"

# event name -> budget collective kind (comm_stats vocabulary). Ordered:
# reduce-scatter before the bare all-reduce pattern. The port's host spans
# (tp::all_gather, tp::all_reduce, tp::reduce_scatter,
# tp::collective_permute) and NCCL's kernels (ncclDevKernel_AllGather_...)
# match the same patterns.
_KIND_PATTERNS = (
    ("reduce_scatter", re.compile(r"reduce[_-]?scatter|psum[_-]scatter")),
    ("all_gather", re.compile(r"all[_-]?gather")),
    ("psum", re.compile(r"all[_-]?reduce|\bpsum\b|^psum")),
    ("all_to_all", re.compile(r"all[_-]?to[_-]?all")),
    ("ppermute", re.compile(r"collective[_-]permute|ppermute|sendrecv")),
    ("send_recv", re.compile(r"^send|^recv|\bsend\b|\brecv\b")),
)
_PHASE_RE = {p: re.compile(rf"(^|[/_.-]){p}([/_.-]|$)") for p in PHASE_SCOPES}
_EPS_US = 1e-3  # containment slack: the trace rounds ts and dur to ns


@dataclasses.dataclass
class CollectiveMeasure:
    """Totals over the capture for one collective kind; ``bytes`` is None
    where the source carries no byte counts (Chrome traces).
    ``overlap_ms`` is the share of this kind's time covered by concurrent
    compute, carried by fixtures (``overlap_ns``); None where the source
    cannot know, and obs/drift's overlap check then SKIPs."""

    kind: str
    count: int = 0
    ms: float = 0.0
    bytes: int | None = None
    overlap_ms: float | None = None

    def add(self, n: int, ms: float, nbytes: int | None,
            overlap_ms: float | None = None) -> None:
        self.count += n
        self.ms += ms
        if nbytes is not None:
            self.bytes = (self.bytes or 0) + nbytes
        if overlap_ms is not None:
            self.overlap_ms = (self.overlap_ms or 0.0) + overlap_ms

    @property
    def overlap_fraction(self) -> float | None:
        if self.overlap_ms is None:
            return None
        return self.overlap_ms / self.ms if self.ms else 0.0


@dataclasses.dataclass
class Attribution:
    """A capture reduced to the drift reconciler's join keys.

    ``counts_exact`` says whether the collective counts are a faithful
    census of ``tokens`` forwards (fixtures; a Chrome trace whose every
    forward carries its spans) or only near one (a caller-given token
    count over a window that may hold other work). ``backend`` names what
    carried a Chrome trace's collectives: 'gloo' (host spans), 'nccl'
    (kernels), or None (no collectives, or a fixture)."""

    tokens: int
    total_ms: float = 0.0
    phase_ms: dict = dataclasses.field(default_factory=dict)
    collectives: dict = dataclasses.field(default_factory=dict)
    config: dict = dataclasses.field(default_factory=dict)
    source: str = ""
    counts_exact: bool = True
    logits_skipped: int = 0
    backend: str | None = None

    @property
    def attributed_ms(self) -> float:
        return sum(self.phase_ms.values())

    @property
    def coverage(self) -> float:
        """Fraction of op time attributed to a named phase."""
        return self.attributed_ms / self.total_ms if self.total_ms else 0.0

    def phase_ms_per_token(self) -> dict:
        n = max(self.tokens, 1)
        out = {p: round(ms / n, 6) for p, ms in sorted(self.phase_ms.items())}
        out["unattributed"] = round(
            max(self.total_ms - self.attributed_ms, 0.0) / n, 6)
        return out

    def _bucket(self, name: str, scope: str, ms: float, count: int,
                nbytes: int | None, collective: str | None,
                overlap_ms: float | None = None) -> None:
        self.total_ms += ms
        parts = scope.split("/") if scope else []
        phase = next((p for p in reversed(parts) if p in PHASE_SCOPES), None)
        if phase is None:  # no explicit scope: match the event name itself
            for p, rx in _PHASE_RE.items():
                if rx.search(name.lower()):
                    phase = p
                    break
        kind = collective
        if kind is None:
            kind = next((COLLECTIVE_SCOPE_KINDS[p] for p in reversed(parts)
                         if p in COLLECTIVE_SCOPE_KINDS), None)
        if kind is None:
            kind = classify_collective(name)
        if kind is not None and phase is None:
            phase = "collective"  # labeled wire time outside any phase
        if phase is not None:
            self.phase_ms[phase] = self.phase_ms.get(phase, 0.0) + ms
        if kind is not None:
            self.collectives.setdefault(
                kind, CollectiveMeasure(kind)).add(count, ms, nbytes,
                                                  overlap_ms)


def classify_collective(name: str) -> str | None:
    """Budget-vocabulary collective kind of an event name, or None. The
    wait for an issued collective (``tp::wait``) is no collective."""
    if name == WAIT_SPAN:
        return None
    low = name.lower()
    if low.startswith(SPAN_PREFIX):
        low = low[len(SPAN_PREFIX):]
    for kind, rx in _KIND_PATTERNS:
        if rx.search(low):
            return kind
    return None


# -- loaders ---------------------------------------------------------------


def load_capture(path: str, tokens: int = 0) -> Attribution:
    """Load a ``--profile`` directory, a Chrome trace file or a fixture.

    ``tokens`` overrides (fixtures) or supplies (a Chrome trace, which
    otherwise counts its forwards) the per-token divisor."""
    if os.path.isdir(path):
        fixture = os.path.join(path, "capture.json")
        if os.path.exists(fixture):
            return parse_fixture(fixture, tokens)
        return parse_chrome_capture(find_trace(path), tokens)
    if path.endswith(".ndjson"):
        raise ValueError(
            f"{path!r}: NDJSON (e.g. a saved /debug/timeline stream) is "
            f"not a capture — expected a {FIXTURE_SCHEMA!r} fixture .json "
            f"or a --profile directory")
    if path.endswith(".pt.trace.json"):
        return parse_chrome_capture(path, tokens)
    if path.endswith(".json"):
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        if isinstance(doc, dict) and "traceEvents" in doc:
            return parse_chrome_capture(path, tokens)
        return parse_fixture(path, tokens, doc)
    raise ValueError(f"{path!r}: not a capture (a --profile directory, a "
                     f"*.pt.trace.json or a {FIXTURE_SCHEMA!r} fixture)")


def parse_fixture(path: str, tokens: int = 0, doc=None) -> Attribution:
    """Load a ``dllama-trace/1`` synthetic capture fixture."""
    if doc is None:
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
    if not isinstance(doc, dict) or doc.get("schema") != FIXTURE_SCHEMA:
        got = doc.get("schema") if isinstance(doc, dict) else None
        raise ValueError(f"{path!r}: expected schema {FIXTURE_SCHEMA!r}, "
                         f"got {got!r}")
    n_tokens = int(tokens or doc.get("tokens", 0))
    if n_tokens <= 0:
        raise ValueError(f"{path!r}: fixture carries no positive token "
                         f"count and none was supplied")
    att = Attribution(tokens=n_tokens, config=dict(doc.get("config", {})),
                      source=path)
    for i, ev in enumerate(doc.get("events", ())):
        if not isinstance(ev, dict) or "dur_ns" not in ev:
            raise ValueError(f"{path!r}: events[{i}] is not an event "
                             f"object with 'dur_ns'")
        overlap = ev.get("overlap_ns")
        att._bucket(str(ev.get("name", "")), str(ev.get("scope", "")),
                    float(ev["dur_ns"]) / 1e6,
                    int(ev.get("occurrences", 1)),
                    ev.get("bytes"), ev.get("collective"),
                    None if overlap is None else float(overlap) / 1e6)
    return att


class _Spans:
    """One thread's phase spans, for the innermost one around an event.
    The forwards' phase spans follow one another (none opens inside
    another), so the latest span to start at or before the event is the
    only candidate; a few more are looked at for nesting."""

    LOOK_BACK = 8

    def __init__(self, spans: list[dict]):
        self.spans = sorted(spans, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.spans]

    def phase_at(self, ts: float, end: float) -> str | None:
        i = bisect.bisect_right(self.starts, ts + _EPS_US)
        for ev in reversed(self.spans[max(i - self.LOOK_BACK, 0):i]):
            if ev["ts"] + ev["dur"] + _EPS_US >= end:
                return ev["name"]
        return None


def _kind_of(name: str) -> str | None:
    """A trace event's collective kind: the port's ``tp::<kind>`` spans by
    their name, an op or kernel by its base name where utils/it_split
    counts it as a collective (NCCL's kernels)."""
    if name.startswith(SPAN_PREFIX):
        return classify_collective(name)
    base = base_name(name)
    return classify_collective(base) if _COLLECTIVE_RE.search(base) else None


_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def parse_chrome_capture(path: str, tokens: int = 0) -> Attribution:
    """Attribute a torch.profiler Chrome trace (module docstring). Op
    time is averaged over the trace's devices (or threads, on the CPU),
    as utils/it_split.summarize averages it; each collective is counted
    once."""
    with open(find_trace(path)) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if isinstance(e, dict) and "dur" in e and "ts" in e]
    phases = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") in PHASE_SCOPES]
    by_thread: dict = {}
    for ev in phases:
        by_thread.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    spans = {k: _Spans(v) for k, v in by_thread.items()}

    def phase_of(ev):
        s = spans.get((ev.get("pid"), ev.get("tid")))
        return None if s is None else s.phase_at(ev["ts"],
                                                 ev["ts"] + ev["dur"])

    kernels = [e for e in events if e.get("cat") == "kernel"]
    coll_spans = [e for e in events if e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    groups: dict[str, list] = {}
    if kernels:
        launches = {e["args"]["correlation"]: e for e in events
                    if e.get("cat") in _LAUNCH_CATS
                    and isinstance(e.get("args"), dict)
                    and "correlation" in e["args"]}
        nccl = any(_COLLECTIVE_RE.search(base_name(str(k.get("name", ""))))
                   for k in kernels)
        for ev in kernels:
            run = launches.get((ev.get("args") or {}).get("correlation"))
            groups.setdefault(f"/device:cuda:{ev.get('pid')}", []).append(
                (ev, None if run is None else phase_of(run)))
        if not nccl:  # gloo: the collectives are the host spans
            for key in groups:
                groups[key] += [(ev, phase_of(ev)) for ev in coll_spans]
        backend = "nccl" if nccl else ("gloo" if coll_spans else None)
    else:
        gloo = ({(e.get("pid"), e.get("tid")) for e in events
                 if str(e.get("name", "")).startswith("gloo:")}
                - {(e.get("pid"), e.get("tid")) for e in coll_spans})
        per_thread: dict = {}
        for ev in [e for e in events if e.get("cat") == "cpu_op"] \
                + coll_spans:
            key = (ev.get("pid"), ev.get("tid"))
            if key not in gloo:
                per_thread.setdefault(key, []).append(ev)
        for key, evs in per_thread.items():
            groups[f"/host:CPU/{key[0]}/{key[1]}"] = [
                (ev, phase_of(ev)) for ev in _top_level(evs)]
        backend = "gloo" if coll_spans else None
    groups = {k: [(ev, ph) for ev, ph in v
                  if base_name(str(ev.get("name", "")))]
              for k, v in groups.items()}
    groups = {k: v for k, v in groups.items() if v}
    if not groups:
        raise ValueError(f"no op events found in {path!r} (empty trace?)")
    forwards = sum(ev["name"] == SCOPE_EMBED for ev in phases)
    logit_forwards = sum(ev["name"] == SCOPE_LOGITS for ev in phases)
    exact = not tokens or tokens == forwards
    n_tokens = int(tokens or forwards)
    if n_tokens <= 0:
        raise ValueError(f"{path!r}: the trace holds no forward's phase "
                         f"spans — pass the token count (--tokens)")
    att = Attribution(tokens=n_tokens, source=path, counts_exact=exact,
                      logits_skipped=(max(forwards - logit_forwards, 0)
                                      if exact else 0),
                      backend=backend)
    n_dev = len(groups)
    counted: set = set()
    for evs in groups.values():
        for ev, phase in evs:
            name = str(ev.get("name", ""))
            kind = _kind_of(name)
            att._bucket(name, phase or "", float(ev["dur"]) / 1e3 / n_dev,
                        0, None, kind)
            if kind is not None and id(ev) not in counted:
                counted.add(id(ev))
                att.collectives[kind].count += 1
    return att
