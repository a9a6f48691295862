"""Watchtower: deterministic incident detection over the fleet signal
plane.

Everything the observability stack exports (metrics, /health blocks,
fleet rows, cost ledgers) is a POINT-IN-TIME snapshot a human must read
after the fact. This module adds the missing layer — a time axis plus
machine-made verdicts:

* ``SignalRing`` — a bounded per-replica history of snapshot DELTAS
  (counter diffs + gauge readings per scrape tick). Columns are
  integer/step-unit only, so the ring is byte-identical across
  same-seed runs (the ``CensusRing`` determinism contract): live mode
  samples wall milliseconds, the virtual-clock sims sample engine step
  counts — same columns, different unit, identical math.
* Detector suite — PURE functions over ring windows with pinned
  thresholds (``THRESHOLDS``), each wrapped in a hysteresis state
  machine (ok → warming → firing → cooling) so a single noisy tick
  neither fires nor clears an incident. The suite: multi-window SLO
  burn rate (fast + slow windows, Google-SRE-workbook lineage), KV
  page leak, stall-regime shift, goodput collapse, speculative
  accept-rate collapse, recovery/crash-loop storm, and handoff
  failure spike.
* ``Incident`` — a firing transition's forensics record: kind,
  replica, the exact ring deltas that tripped the detector, and recent
  trace ids from the span ring — enough to pivot straight into
  /debug/timeline or a flight-recorder bundle (the server dumps one
  with reason="incident" via the ``on_incident`` hook).

``tools/watchcheck.py`` is the CI gate: chaos faults replayed on the
virtual clock must raise exactly their matching incident kind within a
pinned tick window, and a healthy sweep must raise none.

ROADMAP item 1's SLO autoscaler and item 4's adaptive-K controller are
the intended readers of this plane: both are "react to a detected
regime change" loops, and the detectors define the regimes.
"""

from __future__ import annotations

import collections
import threading

from .ledger import STALL_CAUSES

# ---------------------------------------------------------------- columns

#: gauge columns: absolute readings copied into each ring row
GAUGE_COLUMNS = ("kv_pages_free", "queue_depth", "active")

#: counter columns: ring rows carry the per-tick DELTA (clamped at zero —
#: a counter that moves backwards is a replica restart, and the standard
#: Prometheus reset semantics apply: the delta restarts, it never goes
#: negative)
COUNTER_COLUMNS = ("met", "violated", "failed", "goodput_tokens",
                   "generated_tokens", "demotions", "recoveries",
                   "handoff_failed", "handoff_total",
                   "spec_proposed", "spec_accepted")

#: stall columns (also counters): integer stall units by cause. The
#: virtual-clock sims feed ledger stall STEP counts; live mode feeds
#: integer milliseconds — the detectors only compare shares and floors,
#: which are unit-invariant.
STALL_COLUMNS = tuple(f"stall_{c}" for c in STALL_CAUSES)

_DELTA_COLUMNS = COUNTER_COLUMNS + STALL_COLUMNS
COLUMNS = ("tick",) + GAUGE_COLUMNS + _DELTA_COLUMNS


def blank_sample() -> dict:
    """An all-zero absolute sample (every column a caller may omit)."""
    return {c: 0 for c in GAUGE_COLUMNS + _DELTA_COLUMNS}


# ---------------------------------------------------------- samples


def _sum_samples(samples: dict, name: str, label: str | None = None,
                 value: str | None = None) -> int:
    """Sum a parsed /metrics family across its label series; with
    ``label``/``value``, only series carrying that label value count."""
    from .fleet import _series_label

    total = 0.0
    for key, v in samples.items():
        if key != name and not key.startswith(name + "{"):
            continue
        if label is not None and _series_label(key, label) != value:
            continue
        total += v
    return int(total)


def sample_from_signals(row, samples: dict | None = None) -> dict:
    """Absolute sample from a fleet row (``obs/fleet.ReplicaSignals``)
    plus its parsed /metrics scrape — the LIVE feed. Stall seconds
    become integer milliseconds (the live stall unit)."""
    samples = samples or {}
    sample = blank_sample()
    sample["kv_pages_free"] = int(row.kv_pages_free)
    sample["queue_depth"] = int(row.queue_depth)
    sample["active"] = int(row.active)
    for cell in row.slo.values():
        sample["met"] += int(cell.get("met", 0))
        sample["violated"] += int(cell.get("violated", 0))
        sample["failed"] += int(cell.get("failed", 0))
    sample["goodput_tokens"] = int(row.goodput_tokens)
    sample["generated_tokens"] = int(row.generated_tokens)
    for cause, s in row.stall_seconds.items():
        if cause in STALL_CAUSES:
            sample[f"stall_{cause}"] = int(round(float(s) * 1000.0))
    sample["demotions"] = _sum_samples(samples,
                                       "dllama_tier_demotions_total")
    sample["recoveries"] = _sum_samples(samples, "dllama_recoveries_total")
    sample["spec_proposed"] = _sum_samples(samples,
                                           "dllama_spec_proposed_total")
    sample["spec_accepted"] = _sum_samples(samples,
                                           "dllama_spec_accepted_total")
    sample["handoff_total"] = _sum_samples(
        samples, "dllama_handoff_requests_total")
    sample["handoff_failed"] = _sum_samples(
        samples, "dllama_handoff_requests_total", "verdict", "failed")
    return sample


def sample_from_engine(eng, verdicts: dict | None = None,
                       goodput_tokens: int = 0,
                       handoff_failed: int = 0, handoff_total: int = 0,
                       recoveries: int | None = None) -> dict:
    """Absolute sample straight off an in-process engine's INTEGER
    counters — the virtual-clock feed (fleetcheck's sim, watchcheck,
    loadcheck's sweep). SLO verdicts and goodput come from the load generator
    (the virtual clock IS the tracker there); stall columns are ledger
    stall STEP counts, the sim's deterministic stall unit."""
    sample = blank_sample()
    with eng._lock:
        sample["queue_depth"] = len(eng._queue)
    sample["active"] = sum(1 for s in eng._pool if not s.free)
    if eng.allocator is not None:
        sample["kv_pages_free"] = eng.allocator.n_free
        sample["demotions"] = sum(eng.allocator.demotions.values())
    for verdict in ("met", "violated", "failed"):
        sample[verdict] = int((verdicts or {}).get(verdict, 0))
    sample["goodput_tokens"] = int(goodput_tokens)
    sample["generated_tokens"] = eng.stats.tokens
    sample["spec_proposed"] = eng.stats.spec_proposed
    sample["spec_accepted"] = eng.stats.spec_accepted
    if recoveries is None and eng._obs is not None:
        recoveries = int(eng._obs.recoveries.value)
    sample["recoveries"] = int(recoveries or 0)
    sample["handoff_failed"] = int(handoff_failed)
    sample["handoff_total"] = int(handoff_total)
    if eng.ledger_book is not None:
        stall = eng.ledger_book.grand_totals()["stall_steps"]
        for cause in STALL_CAUSES:
            sample[f"stall_{cause}"] = int(stall.get(cause, 0))
    return sample


# ---------------------------------------------------------------- the ring


class SignalRing:
    """Bounded per-replica history of snapshot deltas. ``observe`` takes
    an ABSOLUTE sample and records the delta row against the previous
    absolute sample (first tick: counter deltas are the absolutes —
    tick 0 starts the clock). Integer-only rows; same observation
    sequence ⇒ byte-identical ``to_json`` (the CensusRing contract)."""

    KIND = "dllama-signal-ring"
    VERSION = 1

    def __init__(self, keep: int = 512):
        self.keep = keep
        self._lock = threading.Lock()
        self._rows: dict = {}
        self._last: dict = {}
        self._ticks: dict = {}
        self.rows_total = 0

    def observe(self, replica: str, sample: dict) -> dict:
        """Record one scrape tick; returns the delta row appended."""
        with self._lock:
            tick = self._ticks.get(replica, 0)
            last = self._last.get(replica)
            row = {"tick": tick}
            for col in GAUGE_COLUMNS:
                row[col] = int(sample.get(col, 0))
            for col in _DELTA_COLUMNS:
                new = int(sample.get(col, 0))
                prev = int(last.get(col, 0)) if last is not None else 0
                row[col] = max(0, new - prev)
            self._rows.setdefault(
                replica, collections.deque(maxlen=self.keep)).append(row)
            self._last[replica] = {c: int(sample.get(c, 0))
                                   for c in _DELTA_COLUMNS}
            self._ticks[replica] = tick + 1
            self.rows_total += 1
            return row

    def window(self, replica: str, n: int | None = None) -> list:
        """The last ``n`` delta rows (all, when None), oldest first."""
        with self._lock:
            rows = list(self._rows.get(replica, ()))
        return rows if n is None else rows[-n:]

    def ticks(self, replica: str) -> int:
        with self._lock:
            return self._ticks.get(replica, 0)

    def replicas(self) -> list:
        with self._lock:
            return sorted(self._rows)

    def to_json(self, tail: int = 64) -> dict:
        with self._lock:
            return {
                "kind": self.KIND, "version": self.VERSION,
                "keep": self.keep, "rows_total": self.rows_total,
                "replicas": {
                    name: {"ticks": self._ticks.get(name, 0),
                           "rows": list(rows)[-tail:]}
                    for name, rows in sorted(self._rows.items())},
            }


# ------------------------------------------------------------- thresholds

#: the pinned detector thresholds (the watchcheck detection matrix and
#: the README detector table speak in exactly these numbers; the
#: jitter-thresholds mutation arm proves the gate notices a drift)
THRESHOLDS = {
    # multi-window SLO burn rate: bad = violated + failed; both windows
    # must burn (the SRE-workbook multi-window guard against paging on
    # one bad tick or on ancient history)
    "slo_burn_fast_window": 5,
    "slo_burn_slow_window": 60,
    "slo_burn_fast_frac": 0.5,
    "slo_burn_slow_frac": 0.3,
    "slo_burn_fast_min": 4,      # min verdicts in the fast window
    "slo_burn_slow_min": 8,      # min verdicts in the slow window
    # KV page leak: pages_free stepping DOWN across idle rows (no queue,
    # no active slots) with zero demotions in the window — churn-free
    # monotone loss only a leak explains
    "page_leak_window": 12,
    "page_leak_idle_min": 4,     # idle rows needed in the window
    "page_leak_pages_min": 2,    # net decline across the idle rows
    # stall-regime shift: the dominant stall cause of the recent window
    # differs from the preceding base window's, with real mass in both
    "stall_shift_recent": 5,
    "stall_shift_base": 15,
    "stall_shift_share": 0.5,    # recent dominant's share of recent mass
    "stall_shift_min_units": 6,  # mass floor (steps sim / ms live)
    # goodput collapse: requests COMPLETING with zero goodput against a
    # base window that was producing. Completions (not mere demand) are
    # the gate — long decode stretches legitimately show demand with no
    # finishes, and paging on those would alarm on every long request
    "goodput_collapse_recent": 6,
    "goodput_collapse_base": 12,
    "goodput_collapse_base_min": 16,   # base-window goodput tokens
    "goodput_collapse_finished_min": 3,  # recent-window verdicts
    # speculative accept-rate collapse
    "spec_collapse_window": 8,
    "spec_collapse_proposed_min": 16,
    "spec_collapse_ratio": 0.2,
    # recovery/crash-loop storm
    "recovery_storm_window": 10,
    "recovery_storm_min": 3,
    # handoff failure spike
    "handoff_spike_window": 10,
    "handoff_spike_total_min": 4,
    "handoff_spike_failed_frac": 0.5,
}


# -------------------------------------------------------------- detectors
# Pure (rows, thresholds) -> (hot, note) functions. ``rows`` is the
# replica's ring tail, oldest first; each fn slices its own windows.


def detect_slo_burn(rows: list, t: dict) -> tuple:
    fast = rows[-int(t["slo_burn_fast_window"]):]
    slow = rows[-int(t["slo_burn_slow_window"]):]

    def burn(win):
        bad = sum(r["violated"] + r["failed"] for r in win)
        return bad, bad + sum(r["met"] for r in win)

    fb, ft = burn(fast)
    sb, st = burn(slow)
    hot = (ft >= t["slo_burn_fast_min"]
           and fb >= t["slo_burn_fast_frac"] * ft
           and st >= t["slo_burn_slow_min"]
           and sb >= t["slo_burn_slow_frac"] * st)
    return hot, f"fast {fb}/{ft} bad, slow {sb}/{st} bad"


def detect_page_leak(rows: list, t: dict) -> tuple:
    win = rows[-int(t["page_leak_window"]):]
    idle = [r for r in win
            if r["queue_depth"] == 0 and r["active"] == 0]
    if len(idle) < t["page_leak_idle_min"]:
        return False, "too few idle rows"
    frees = [r["kv_pages_free"] for r in idle]
    decline = frees[0] - frees[-1]
    monotone = all(b <= a for a, b in zip(frees, frees[1:]))
    demoted = sum(r["demotions"] for r in win)
    hot = (monotone and decline >= t["page_leak_pages_min"]
           and demoted == 0)
    return hot, (f"idle pages_free {frees[0]}->{frees[-1]} "
                 f"({len(idle)} idle rows, {demoted} demotions)")


def detect_stall_shift(rows: list, t: dict) -> tuple:
    rn, bn = int(t["stall_shift_recent"]), int(t["stall_shift_base"])
    if len(rows) < rn + bn:
        return False, "window not filled"
    recent, base = rows[-rn:], rows[-(rn + bn):-rn]

    def mass(win):
        return {c: sum(r[f"stall_{c}"] for r in win)
                for c in STALL_CAUSES}

    rm, bm = mass(recent), mass(base)
    rtot, btot = sum(rm.values()), sum(bm.values())
    if rtot < t["stall_shift_min_units"] \
            or btot < t["stall_shift_min_units"]:
        return False, "stall mass under the floor"
    # deterministic tie-break: alphabetical-first wins on equal mass
    rdom = max(sorted(rm), key=lambda c: rm[c])
    bdom = max(sorted(bm), key=lambda c: bm[c])
    hot = rdom != bdom and rm[rdom] >= t["stall_shift_share"] * rtot
    return hot, (f"dominant {bdom} ({bm[bdom]}/{btot}) -> "
                 f"{rdom} ({rm[rdom]}/{rtot})")


def detect_goodput_collapse(rows: list, t: dict) -> tuple:
    rn = int(t["goodput_collapse_recent"])
    bn = int(t["goodput_collapse_base"])
    if len(rows) < rn + bn:
        return False, "window not filled"
    recent, base = rows[-rn:], rows[-(rn + bn):-rn]
    recent_tok = sum(r["goodput_tokens"] for r in recent)
    base_tok = sum(r["goodput_tokens"] for r in base)
    finished = sum(r["met"] + r["violated"] + r["failed"]
                   for r in recent)
    hot = (base_tok >= t["goodput_collapse_base_min"]
           and recent_tok == 0
           and finished >= t["goodput_collapse_finished_min"])
    return hot, (f"goodput {base_tok} base -> {recent_tok} recent, "
                 f"{finished} verdict(s) in the recent window")


def detect_spec_collapse(rows: list, t: dict) -> tuple:
    win = rows[-int(t["spec_collapse_window"]):]
    proposed = sum(r["spec_proposed"] for r in win)
    accepted = sum(r["spec_accepted"] for r in win)
    hot = (proposed >= t["spec_collapse_proposed_min"]
           and accepted < t["spec_collapse_ratio"] * proposed)
    return hot, f"accepted {accepted}/{proposed} proposed"


def detect_recovery_storm(rows: list, t: dict) -> tuple:
    win = rows[-int(t["recovery_storm_window"]):]
    n = sum(r["recoveries"] for r in win)
    hot = n >= t["recovery_storm_min"]
    return hot, f"{n} recoveries in {len(win)} ticks"


def detect_handoff_spike(rows: list, t: dict) -> tuple:
    win = rows[-int(t["handoff_spike_window"]):]
    failed = sum(r["handoff_failed"] for r in win)
    total = sum(r["handoff_total"] for r in win)
    hot = (total >= t["handoff_spike_total_min"]
           and failed >= t["handoff_spike_failed_frac"] * total)
    return hot, f"{failed}/{total} handoffs failed"


class Detector:
    """One detector's identity + hysteresis tuning. ``window`` is the
    evidence size (ring rows attached to an incident); ``warm``/``cool``
    are the consecutive hot/quiet ticks required to enter/leave firing."""

    __slots__ = ("kind", "fn", "window", "warm", "cool")

    def __init__(self, kind: str, fn, window: int,
                 warm: int = 2, cool: int = 3):
        self.kind = kind
        self.fn = fn
        self.window = window
        self.warm = warm
        self.cool = cool


DETECTORS = (
    Detector("slo_burn", detect_slo_burn, window=5),
    Detector("page_leak", detect_page_leak, window=12),
    Detector("stall_shift", detect_stall_shift, window=20),
    Detector("goodput_collapse", detect_goodput_collapse, window=18),
    Detector("spec_collapse", detect_spec_collapse, window=8),
    Detector("recovery_storm", detect_recovery_storm, window=10),
    Detector("handoff_spike", detect_handoff_spike, window=10),
)

KINDS = tuple(d.kind for d in DETECTORS)

# hysteresis states (the dllama_detector_state gauge exports the code)
STATE_OK = "ok"
STATE_WARMING = "warming"
STATE_FIRING = "firing"
STATE_COOLING = "cooling"
STATE_CODES = {STATE_OK: 0, STATE_WARMING: 1,
               STATE_FIRING: 2, STATE_COOLING: 3}


class _DetectorState:
    __slots__ = ("state", "streak", "since_tick")

    def __init__(self):
        self.state = STATE_OK
        self.streak = 0
        self.since_tick = 0

    def advance(self, hot: bool, warm: int, cool: int,
                tick: int) -> bool:
        """One hysteresis step; returns True exactly on the transition
        INTO firing (the incident-emitting edge; a cooling detector
        re-heating returns to firing WITHOUT a new incident)."""
        if self.state == STATE_OK:
            if hot:
                self.state, self.streak = STATE_WARMING, 1
                self.since_tick = tick
                if self.streak >= warm:
                    self.state = STATE_FIRING
                    return True
        elif self.state == STATE_WARMING:
            if hot:
                self.streak += 1
                if self.streak >= warm:
                    self.state = STATE_FIRING
                    self.since_tick = tick
                    return True
            else:
                self.state, self.streak = STATE_OK, 0
        elif self.state == STATE_FIRING:
            if not hot:
                self.state, self.streak = STATE_COOLING, 1
        elif self.state == STATE_COOLING:
            if hot:
                self.state, self.streak = STATE_FIRING, 0
            else:
                self.streak += 1
                if self.streak >= cool:
                    self.state, self.streak = STATE_OK, 0
        return False


class Incident:
    """One firing transition's forensics record: the exact ring deltas
    that tripped the detector plus recent trace ids to pivot on."""

    __slots__ = ("seq", "kind", "replica", "tick", "window", "note",
                 "evidence", "trace_ids")

    def __init__(self, seq: int, kind: str, replica: str, tick: int,
                 window: int, note: str, evidence: list,
                 trace_ids: list):
        self.seq = seq
        self.kind = kind
        self.replica = replica
        self.tick = tick
        self.window = window
        self.note = note
        self.evidence = evidence
        self.trace_ids = trace_ids

    def to_json(self) -> dict:
        return {"seq": self.seq, "kind": self.kind,
                "replica": self.replica, "tick": self.tick,
                "window": self.window, "note": self.note,
                "evidence": list(self.evidence),
                "trace_ids": list(self.trace_ids)}


class Watchtower:
    """The detection plane: one ``SignalRing`` + per-(replica, kind)
    hysteresis states + a bounded incident log. ``observe`` is the
    scrape tick (supervisor-owned: the server's watch loop, or a simulated
    clock); snapshots/tails are handler-safe reads.

    ``registry`` pre-registers ``dllama_incidents_total{kind}`` and
    ``dllama_detector_state{kind}`` (state gauge = worst state code of
    the kind across replicas). ``spans`` donates recent trace ids to
    incident forensics. ``on_incident`` is called OUTSIDE the lock for
    every new incident (the server wires a flight-recorder dump here).
    ``mute``/``thresholds`` exist for the watchcheck mutation arms."""

    def __init__(self, keep: int = 512, registry=None, spans=None,
                 on_incident=None, thresholds: dict | None = None,
                 mute=(), keep_incidents: int = 128,
                 detectors=DETECTORS):
        self.ring = SignalRing(keep=keep)
        self.thresholds = dict(THRESHOLDS)
        self.thresholds.update(thresholds or {})
        self._detectors = tuple(detectors)
        self._mute = frozenset(mute)
        self._spans = spans
        self._on_incident = on_incident
        self._lock = threading.Lock()
        self._states: dict = {}
        self._incidents = collections.deque(maxlen=keep_incidents)
        self.incidents_total = 0
        self._by_kind = {d.kind: 0 for d in self._detectors}
        self._inc_counters = None
        self._state_gauges = None
        if registry is not None:
            self._inc_counters = {
                d.kind: registry.labeled_counter(
                    "dllama_incidents_total", {"kind": d.kind},
                    "Incidents raised by the watchtower detector "
                    "suite, by detector kind (obs/watch.py)")
                for d in self._detectors}
            self._state_gauges = {
                d.kind: registry.labeled_gauge(
                    "dllama_detector_state", {"kind": d.kind},
                    "Watchtower detector hysteresis state, worst "
                    "across replicas (0 ok, 1 warming, 2 firing, "
                    "3 cooling)")
                for d in self._detectors}

    def observe(self, replica: str, sample: dict) -> list:
        """One scrape tick for one replica: ring the delta, run every
        detector, advance hysteresis; returns the NEW incidents (the
        transitions into firing) after invoking ``on_incident`` on
        each."""
        row = self.ring.observe(replica, sample)
        rows = self.ring.window(replica)
        tick = row["tick"]
        fired = []
        with self._lock:
            for det in self._detectors:
                if det.kind in self._mute:
                    continue
                hot, note = det.fn(rows, self.thresholds)
                st = self._states.setdefault((replica, det.kind),
                                             _DetectorState())
                if st.advance(hot, det.warm, det.cool, tick):
                    inc = Incident(
                        seq=self.incidents_total, kind=det.kind,
                        replica=replica, tick=tick, window=det.window,
                        note=note, evidence=rows[-det.window:],
                        trace_ids=self._recent_traces())
                    self.incidents_total += 1
                    self._by_kind[det.kind] += 1
                    self._incidents.append(inc)
                    if self._inc_counters is not None:
                        self._inc_counters[det.kind].inc()
                    fired.append(inc)
            if self._state_gauges is not None:
                for det in self._detectors:
                    worst = max(
                        (STATE_CODES[s.state]
                         for (_, kind), s in self._states.items()
                         if kind == det.kind), default=0)
                    self._state_gauges[det.kind].set(worst)
        if self._on_incident is not None:
            for inc in fired:
                self._on_incident(inc)
        return fired

    def _recent_traces(self, n: int = 8) -> list:
        """Distinct trace ids of the newest spans in the span ring —
        the pivot from an incident into /debug/timeline forensics."""
        if self._spans is None:
            return []
        ids: list = []
        for span in reversed(self._spans.snapshot()):
            tid = span.meta.get("trace_id")
            if tid and tid not in ids:
                ids.append(tid)
            if len(ids) >= n:
                break
        return ids

    def states(self) -> dict:
        """{kind: worst state name across replicas} (handler-safe)."""
        with self._lock:
            out = {}
            for det in self._detectors:
                worst = max(
                    (STATE_CODES[s.state]
                     for (_, kind), s in self._states.items()
                     if kind == det.kind), default=0)
                out[det.kind] = next(
                    name for name, code in STATE_CODES.items()
                    if code == worst)
            return out

    def incidents(self, n: int | None = None,
                  kind: str | None = None) -> list:
        """Incident log, oldest first; ``kind`` filters, ``n`` tails."""
        with self._lock:
            out = [i for i in self._incidents
                   if kind is None or i.kind == kind]
        return out if n is None else out[-n:]

    def by_kind(self) -> dict:
        with self._lock:
            return dict(self._by_kind)

    def snapshot(self) -> dict:
        """The /health ``watch`` block: totals + per-kind counts and
        hysteresis states + the last incident's identity (evidence
        stays on /debug/incidents — health is a heartbeat, not a
        forensics dump)."""
        states = self.states()
        with self._lock:
            last = self._incidents[-1] if self._incidents else None
            return {
                "ticks": self.ring.rows_total,
                "incidents_total": self.incidents_total,
                "incidents": dict(self._by_kind),
                "detectors": states,
                "last_incident": (
                    {"seq": last.seq, "kind": last.kind,
                     "replica": last.replica, "tick": last.tick,
                     "note": last.note} if last is not None else None),
            }

    def to_json(self, tail: int = 64) -> dict:
        """The full plane (fleetcheck's watch columns): snapshot plus
        per-replica incident counts and the ring tail."""
        out = self.snapshot()
        with self._lock:
            per: dict = {}
            for inc in self._incidents:
                per[inc.replica] = per.get(inc.replica, 0) + 1
            out["incidents_by_replica"] = dict(sorted(per.items()))
        out["ring"] = self.ring.to_json(tail=tail)
        return out
