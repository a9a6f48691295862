"""Per-request cost ledger + per-dispatch scheduler census.

The accounting plane ROADMAP items 2 (token-budget scheduler) and 5
(multi-tenant attribution) gate on. Two halves:

* ``RequestLedger`` / ``LedgerBook`` — every request accumulates its own
  resource bill: its share of each dispatch's wall time (decode rows vs
  prefill-chunk tokens), KV page-seconds held (integrated at step
  granularity), ICI bytes (pro-rated from the analytic collective
  budget), DCN page bytes (two-pool handoffs), spec tokens
  proposed/wasted, and stall time attributed BY CAUSE. The book closes a
  ledger at retire/cancel/fail and keeps running totals per SLO class,
  so evicting a closed ledger from the bounded ring never drops its
  contribution to the rollup.
* ``CensusRing`` — one record per engine dispatch: composition (active
  decode rows, prefill tokens, parked slots with reasons, queue depth,
  pages held, tier residency) and budget utilization. Records carry NO
  wall-clock fields — on the virtual clock the ring is byte-for-byte
  deterministic (tests/test_sched_census.py), which is what makes the
  scheduler's behavior diffable across builds.

The two halves are charged from the SAME dispatch walk in
``runtime/continuous.py`` but through independent arithmetic paths
(per-slot ledger charges vs whole-dispatch census totals), so
``tools/costcheck.py`` can verify CONSERVATION: Σ per-request ledger
entries == engine/census totals, exactly, in integer units. A
double-count mutation (ChaosMonkey ``double_count_dispatch``) multiplies
only the ledger side and therefore breaks the equality — the CI
mutation gate.

Units: ``*_steps`` fields are exact integers (device steps × rows or ×
pages — the conservation currency); ``*_s`` fields are wall seconds
(the operator currency, Prometheus-facing, never part of the exact
checks). ``handoff_wait`` stall is seconds-only: it is charged by the
DCN seam outside any engine dispatch, so it has no step representation.

Charges are made by the owning engine's scheduler thread (plus the
handoff seam before a request is first scheduled); the book guards its
open/close maps with a lock, individual ledgers rely on that
single-writer discipline.
"""

from __future__ import annotations

import collections
import threading

# the closed stall-cause vocabulary (pre-registered at zero in
# Prometheus; an unknown cause is a bug, not a new series).
# budget_wait: a mixed-dispatch engine had more active decode
# rows than the token budget holds, so the row rode one dispatch deferred
# (span 0) and retries next dispatch under the rotating fairness cursor.
STALL_CAUSES = ("pool_dry", "promo_pending", "prefill_hold",
                "queue_wait", "handoff_wait", "budget_wait")
# dispatch-token kinds: decode = sampled via _advance, prefill = prompt
# positions filled/echoed at admission, spec = draft tokens proposed
TOKEN_KINDS = ("decode", "prefill", "spec")

# snapshot numeric fields, in the order snapshots are emitted. Integers
# first (the conservation currency), then wall-seconds/bytes floats.
_INT_FIELDS = ("decode_row_steps", "tokens", "prefill_chunks",
               "prefill_tokens", "page_steps", "dcn_pages", "dcn_bytes",
               "spec_proposed", "spec_accepted")
_FLOAT_FIELDS = ("dispatch_s", "prefill_s", "page_s", "ici_bytes")


def _zero_totals() -> dict:
    out = {f: 0 for f in _INT_FIELDS}
    out.update({f: 0.0 for f in _FLOAT_FIELDS})
    out["stall_steps"] = {}
    out["stall_s"] = {}
    out["requests"] = 0
    return out


def _merge_snapshot(dst: dict, snap: dict) -> None:
    """Add one ledger snapshot's numerics into a totals dict."""
    for f in _INT_FIELDS:
        dst[f] += int(snap.get(f, 0))
    for f in _FLOAT_FIELDS:
        dst[f] += float(snap.get(f, 0.0))
    for cause, n in (snap.get("stall_steps") or {}).items():
        dst["stall_steps"][cause] = dst["stall_steps"].get(cause, 0) + n
    for cause, s in (snap.get("stall_s") or {}).items():
        dst["stall_s"][cause] = dst["stall_s"].get(cause, 0.0) + s
    dst["requests"] += 1


class RequestLedger:
    """One request's running resource bill. ``carried`` holds the
    snapshot a migrated/recovered request brought with it (journal
    ``ledger`` field) — ``snapshot()`` merges it in, so the bill is
    whole across a prefill→decode handoff."""

    __slots__ = ("rid", "slo_class", "status", "carried",
                 "decode_row_steps", "tokens", "prefill_chunks",
                 "prefill_tokens", "page_steps", "dcn_pages", "dcn_bytes",
                 "spec_proposed", "spec_accepted",
                 "dispatch_s", "prefill_s", "page_s", "ici_bytes",
                 "stall_steps", "stall_s")

    def __init__(self, rid: int, slo_class: str = "default"):
        self.rid = rid
        self.slo_class = slo_class or "default"
        self.status = "open"
        self.carried: dict | None = None
        self.decode_row_steps = 0
        self.tokens = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.page_steps = 0
        self.dcn_pages = 0
        self.dcn_bytes = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.dispatch_s = 0.0
        self.prefill_s = 0.0
        self.page_s = 0.0
        self.ici_bytes = 0.0
        self.stall_steps: dict = {}
        self.stall_s: dict = {}

    # ------------------------------------------------------- charge sites

    def charge_rows(self, k: int, dt_share: float, reps: int = 1) -> None:
        """This request rode ``k`` device steps as an active decode row;
        ``dt_share`` is its share of the dispatch's wall time."""
        self.decode_row_steps += k * reps
        self.dispatch_s += dt_share * reps

    def charge_tokens(self, n: int = 1, reps: int = 1) -> None:
        self.tokens += n * reps

    def charge_prefill(self, chunks: int, tokens: int,
                       dt_s: float) -> None:
        self.prefill_chunks += chunks
        self.prefill_tokens += tokens
        self.prefill_s += dt_s

    def charge_pages(self, npages: int, k: int, dt_s: float,
                     reps: int = 1) -> None:
        """``npages`` KV pages held across ``k`` device steps taking
        ``dt_s`` wall seconds."""
        self.page_steps += npages * k * reps
        self.page_s += npages * dt_s * reps

    def charge_stall(self, cause: str, k: int, dt_s: float,
                     reps: int = 1) -> None:
        """Parked/queued across a ``k``-step dispatch for ``cause``."""
        self.stall_steps[cause] = (self.stall_steps.get(cause, 0)
                                   + k * reps)
        self.stall_s[cause] = self.stall_s.get(cause, 0.0) + dt_s * reps

    def charge_stall_s(self, cause: str, dt_s: float) -> None:
        """Seconds-only stall (handoff_wait — no engine dispatch rode
        it, so it has no step representation)."""
        self.stall_s[cause] = self.stall_s.get(cause, 0.0) + dt_s

    def charge_ici(self, nbytes: float, reps: int = 1) -> None:
        self.ici_bytes += nbytes * reps

    def charge_dcn(self, pages: int, nbytes: int) -> None:
        self.dcn_pages += pages
        self.dcn_bytes += nbytes

    def charge_spec(self, proposed: int, accepted: int) -> None:
        self.spec_proposed += proposed
        self.spec_accepted += accepted

    # --------------------------------------------------------- accessors

    @property
    def spec_wasted(self) -> int:
        return max(self.spec_proposed - self.spec_accepted, 0)

    @property
    def stall_steps_total(self) -> int:
        return sum(self.stall_steps.values())

    def seed_carried(self, snap: dict | None) -> None:
        self.carried = dict(snap) if snap else None

    def snapshot(self) -> dict:
        """The ledger as one JSON-able row, carried snapshot merged in
        (numerics added, stall dicts union-added)."""
        out: dict = {"rid": self.rid, "class": self.slo_class,
                     "status": self.status}
        for f in _INT_FIELDS:
            out[f] = getattr(self, f)
        for f in _FLOAT_FIELDS:
            out[f] = getattr(self, f)
        out["stall_steps"] = dict(self.stall_steps)
        out["stall_s"] = dict(self.stall_s)
        if self.carried:
            c = self.carried
            for f in _INT_FIELDS:
                out[f] += int(c.get(f, 0))
            for f in _FLOAT_FIELDS:
                out[f] += float(c.get(f, 0.0))
            for cause, n in (c.get("stall_steps") or {}).items():
                out["stall_steps"][cause] = \
                    out["stall_steps"].get(cause, 0) + n
            for cause, s in (c.get("stall_s") or {}).items():
                out["stall_s"][cause] = \
                    out["stall_s"].get(cause, 0.0) + s
        out["spec_wasted"] = max(out["spec_proposed"]
                                 - out["spec_accepted"], 0)
        return out


class LedgerBook:
    """The engine's ledger registry: open ledgers by rid, a bounded ring
    of closed snapshots, and NEVER-RESET running totals (grand + per
    class) accumulated at close time — ring eviction cannot lose a
    request's contribution to the rollup (the obs/fleet.py sum-not-mean
    discipline)."""

    def __init__(self, keep: int = 256):
        self._lock = threading.Lock()
        self._open: dict = {}
        self._closed = collections.deque(maxlen=max(keep, 1))
        self._totals = _zero_totals()
        self._class_totals: dict = {}
        self.opened_n = 0
        self.closed_n = 0

    def open_request(self, rid: int, slo_class: str = "default",
                     carried: dict | None = None) -> RequestLedger:
        with self._lock:
            led = self._open.get(rid)
            if led is None:
                led = RequestLedger(rid, slo_class)
                led.seed_carried(carried)
                self._open[rid] = led
                self.opened_n += 1
            return led

    def get(self, rid: int) -> RequestLedger | None:
        with self._lock:
            return self._open.get(rid)

    def close_request(self, rid: int, status: str) -> dict | None:
        """Close and fold into the totals; idempotent (a second close of
        the same rid is a no-op returning None)."""
        with self._lock:
            led = self._open.pop(rid, None)
            if led is None:
                return None
            led.status = status
            snap = led.snapshot()
            self._closed.append(snap)
            self.closed_n += 1
            _merge_snapshot(self._totals, snap)
            cell = self._class_totals.setdefault(led.slo_class,
                                                 _zero_totals())
            _merge_snapshot(cell, snap)
            return snap

    @property
    def n_open(self) -> int:
        with self._lock:
            return len(self._open)

    def open_snapshots(self) -> list:
        with self._lock:
            return [led.snapshot() for led in self._open.values()]

    def closed_tail(self, n: int = 64) -> list:
        with self._lock:
            tail = list(self._closed)
        return tail[-n:]

    def grand_totals(self, include_open: bool = True) -> dict:
        """Σ over every ledger ever closed (+ currently-open ones when
        ``include_open``) — the engine-totals side of the conservation
        equalities lives in the engine/census; THIS is the per-request
        side."""
        with self._lock:
            out = {f: self._totals[f] for f in _INT_FIELDS}
            out.update({f: self._totals[f] for f in _FLOAT_FIELDS})
            out["stall_steps"] = dict(self._totals["stall_steps"])
            out["stall_s"] = dict(self._totals["stall_s"])
            out["requests"] = self._totals["requests"]
            if include_open:
                for led in self._open.values():
                    _merge_snapshot(out, led.snapshot())
        out["stall_steps_total"] = sum(out["stall_steps"].values())
        return out

    def class_rollup(self) -> dict:
        """Per-SLO-class cost columns recomputed from SUMMED counts
        (never averaged ratios — the fleet-rollup pin): cost-per-token =
        Σ compute seconds / Σ tokens within the class."""
        with self._lock:
            cells = {cls: {f: t[f] for f in _INT_FIELDS + _FLOAT_FIELDS}
                     for cls, t in self._class_totals.items()}
            for cls, t in self._class_totals.items():
                cells[cls]["requests"] = t["requests"]
                cells[cls]["stall_steps"] = dict(t["stall_steps"])
                cells[cls]["stall_s"] = dict(t["stall_s"])
        for cls, cell in cells.items():
            toks = cell["tokens"]
            compute_s = cell["dispatch_s"] + cell["prefill_s"]
            cell["compute_s"] = round(compute_s, 9)
            cell["stall_s_total"] = round(
                sum(cell["stall_s"].values()), 9)
            cell["cost_per_token_s"] = (round(compute_s / toks, 9)
                                        if toks else 0.0)
            cell["page_s_per_token"] = (round(cell["page_s"] / toks, 9)
                                        if toks else 0.0)
        return dict(sorted(cells.items()))

    def to_json(self) -> dict:
        return {
            "opened": self.opened_n, "closed": self.closed_n,
            "open": self.n_open,
            "totals": self.grand_totals(include_open=True),
            "by_class": self.class_rollup(),
        }


class CensusRecord:
    """One dispatch's composition. NO wall-clock fields by design — the
    ring must be byte-identical across runs on the virtual clock."""

    __slots__ = ("seq", "kind", "steps", "active", "prefill_tokens",
                 "parked", "queue_depth", "pages_held", "tier_pages",
                 "util")

    def __init__(self, seq: int, kind: str, steps: int, active: int,
                 prefill_tokens: int, parked: dict, queue_depth: int,
                 pages_held: int, tier_pages: dict | None, util: float):
        self.seq = seq
        self.kind = kind
        self.steps = steps
        self.active = active
        self.prefill_tokens = prefill_tokens
        self.parked = parked
        self.queue_depth = queue_depth
        self.pages_held = pages_held
        self.tier_pages = tier_pages
        self.util = util

    def to_json(self) -> dict:
        out = {"seq": self.seq, "kind": self.kind, "steps": self.steps,
               "active": self.active, "queue_depth": self.queue_depth,
               "pages_held": self.pages_held, "util": self.util}
        if self.prefill_tokens:
            out["prefill_tokens"] = self.prefill_tokens
        if self.parked:
            out["parked"] = dict(sorted(self.parked.items()))
        if self.tier_pages is not None:
            out["tier_pages"] = dict(sorted(self.tier_pages.items()))
        return out


class CensusRing:
    """Bounded ring of dispatch census records + never-reset totals (the
    engine-side currency of the conservation equalities):

    * ``steps``     — Σ device steps over decode/spec dispatches;
    * ``row_steps`` — Σ active rows × steps (== ContinuousStats
      ``sum_active`` == Σ ledger ``decode_row_steps``);
    * ``stall_steps`` — Σ (parked slots + queue depth) × steps (== Σ
      ledger engine-cause stall steps);
    * ``page_steps``  — Σ pages held × steps (== Σ ledger
      ``page_steps``);
    * ``tokens``    — by kind, counted at the emit sites (Σ decode +
      prefill == ContinuousStats ``tokens``).
    """

    def __init__(self, slots: int, keep: int = 512):
        self._lock = threading.Lock()
        self.slots = max(slots, 1)
        self._ring = collections.deque(maxlen=max(keep, 1))
        self.dispatches = 0
        self.total_steps = 0
        self.total_row_steps = 0
        self.total_stall_steps = 0
        self.total_page_steps = 0
        self.tokens = {k: 0 for k in TOKEN_KINDS}

    def record(self, kind: str, steps: int, active: int, parked: dict,
               queue_depth: int, pages_held: int,
               tier_pages: dict | None = None,
               prefill_tokens: int = 0) -> None:
        with self._lock:
            rec = CensusRecord(
                seq=self.dispatches, kind=kind, steps=steps,
                active=active, prefill_tokens=prefill_tokens,
                parked={c: n for c, n in sorted(parked.items()) if n},
                queue_depth=queue_depth, pages_held=pages_held,
                tier_pages=tier_pages,
                util=round(active / self.slots, 6))
            self._ring.append(rec)
            self.dispatches += 1
            self.total_steps += steps
            self.total_row_steps += active * steps
            self.total_stall_steps += \
                (sum(rec.parked.values()) + queue_depth) * steps
            self.total_page_steps += pages_held * steps

    def count_tokens(self, kind: str, n: int = 1) -> None:
        with self._lock:
            self.tokens[kind] = self.tokens.get(kind, 0) + n

    def tail(self, n: int = 64) -> list:
        with self._lock:
            recs = list(self._ring)
        return [r.to_json() for r in recs[-n:]]

    def totals(self) -> dict:
        with self._lock:
            return {"dispatches": self.dispatches,
                    "steps": self.total_steps,
                    "row_steps": self.total_row_steps,
                    "stall_steps": self.total_stall_steps,
                    "page_steps": self.total_page_steps,
                    "tokens": dict(self.tokens)}

    def to_json(self, tail: int = 64) -> dict:
        return {"kind": "dllama-sched-census", "version": 1,
                "slots": self.slots, "totals": self.totals(),
                "ring": self.tail(tail)}
