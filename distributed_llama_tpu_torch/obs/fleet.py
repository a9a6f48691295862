"""Fleet signal plane: scrape N replicas' /health + /metrics, roll up.

Everything the observability stack exports is per-engine; ROADMAP item 3
(the cache-aware multi-replica router) needs the FLEET view — live
per-replica rows (``kv_pages_free``, ``queue_depth``, goodput, prefix-
tree occupancy) plus fleet rollups (attainment, goodput, pages free,
prefix-tree hit rates). This module is that aggregation layer, shaped so
the router can consume it directly:

* ``ReplicaSignals`` — one replica's row, built from the server's
  /health JSON (``signals_from_health``) or a live scrape
  (``scrape_replica``, which also parses /metrics through
  ``parse_metrics`` and cross-fills counter-backed fields);
* ``rollup`` — the fleet aggregate. Ratios are recomputed from summed
  COUNTS (fleet attainment = Σmet/Σattempted, fleet hit rate =
  Σhits/Σattempts), never averaged from per-replica ratios — a drained
  replica's 1.0 attainment must not launder a loaded replica's 0.5;
* ``tools/fleetcheck.py`` drives it two ways: a wall-clock scrape of
  real servers, and the CI-gated VIRTUAL-CLOCK multi-replica loadgen
  sim — deterministic rows on CPU today (same seed ⇒ identical row),
  which is what makes the rollup math gateable before any multi-host
  session exists.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request

# the row fields a scheduling router reads hot (documented as ONE list so
# the router and the aggregator cannot drift on what "the signals" are)
ROUTER_SIGNALS = ("kv_pages_free", "queue_depth", "active", "occupancy",
                  "goodput_tokens", "prefix_hit_rate")

# the feature-gated /health blocks (wiremodel's "health" format): a
# replica only emits the blocks its features enable, so per-row presence
# must ride beside the values — absent is NOT zero
HEALTH_BLOCKS = ("paged_kv", "kv_tiers", "disagg", "journal", "watchdog",
                 "slo", "sched", "speculative")


@dataclasses.dataclass
class ReplicaSignals:
    """One replica's live signal row. ``healthy`` False (with ``error``
    set) marks a replica the scrape could not read — its numeric fields
    are zeros and the rollup counts it unhealthy instead of treating a
    dead box as an idle one."""

    name: str
    healthy: bool = True
    error: str | None = None
    # the replica's /health schema version (the payload's "schema" key;
    # 0 = pre-schema replica) — rollups surface min/max so version skew
    # across a fleet mid-rolling-upgrade is visible, not inferred
    schema: int = 0
    # which HEALTH_BLOCKS the scrape actually carried. None means the
    # row was built directly (tests, sims) and presence is unknown —
    # every block counts, the older behavior. A set means only
    # these blocks' cells feed the rollup: an absent block (older
    # replica, feature off) is SKIPPED, not summed as phantom zeros.
    present: set | None = None
    # monotonic stamp of when the scrape that built this row finished
    # None = directly-built row (tests, sims),
    # never stale. ``rollup(stale_after=...)`` compares against it so a
    # router polling a cached row table can tell "this replica looked
    # fine 10 minutes ago" from "this replica looks fine".
    scraped_at: float | None = None
    state: str = ""
    uptime_s: float = 0.0
    slots: int = 0
    active: int = 0
    queue_depth: int = 0
    occupancy: float = 0.0
    steps: int = 0
    generated_tokens: int = 0
    kv_pages: int = 0
    kv_pages_free: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefill_tokens_saved: int = 0
    goodput_tokens: int = 0
    # span-ring overflow counter (dllama_spans_dropped_total) — a row
    # whose tracer is shedding spans has forensic blind spots, and the
    # fleet total says whether the FLEET can be trusted to reconstruct
    # an incident timeline
    spans_dropped: int = 0
    # class -> {"attempted", "met", "violated", "failed",
    #           "goodput_tokens"} (the /health slo block's counts)
    slo: dict = dataclasses.field(default_factory=dict)
    # cost-accounting columns (the /health "sched" block):
    # Σ KV page-seconds billed, stall seconds by cause, and per-class
    # SUMMABLE cost counts (tokens/requests/compute_s/page_s/stall_s —
    # ratios are recomputed at rollup, never carried)
    page_seconds: float = 0.0
    stall_seconds: dict = dataclasses.field(default_factory=dict)
    cost_classes: dict = dataclasses.field(default_factory=dict)

    @property
    def prefix_hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    def reports(self, block: str) -> bool:
        """Did this row's scrape carry the given /health block? True
        when presence is unknown (directly-built rows)."""
        return self.present is None or block in self.present

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["present"] = (sorted(self.present)
                          if self.present is not None else None)
        out["prefix_hit_rate"] = round(self.prefix_hit_rate, 6)
        out["occupancy"] = round(self.occupancy, 6)
        out["uptime_s"] = round(self.uptime_s, 3)
        out["page_seconds"] = round(self.page_seconds, 9)
        out["scraped_at"] = (round(self.scraped_at, 6)
                             if self.scraped_at is not None else None)
        return out


@dataclasses.dataclass
class FleetRollup:
    """The fleet aggregate row — sums of counts, ratios recomputed from
    the sums (class docstring of this module)."""

    replicas: int = 0
    healthy: int = 0
    # healthy-but-STALE rows (scrape older than rollup's stale_after):
    # counted here, excluded from `healthy` and every sum below — a row
    # that was fine ten minutes ago is evidence of nothing now, but it
    # is not a dead box either, so it gets its own column
    stale: int = 0
    # /health schema versions seen across HEALTHY replicas: min != max
    # is a fleet mid-rolling-upgrade (0 = at least one pre-schema box)
    schema_min: int = 0
    schema_max: int = 0
    # block -> number of healthy replicas whose scrape carried it: the
    # denominator for every block-derived sum below ("3 replicas, 1
    # reporting paged_kv, 40 pages free" reads very differently from
    # "3 reporting, 40 free")
    reporting: dict = dataclasses.field(default_factory=dict)
    slots: int = 0
    active: int = 0
    queue_depth: int = 0
    steps: int = 0
    generated_tokens: int = 0
    kv_pages: int = 0
    kv_pages_free: int = 0
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefill_tokens_saved: int = 0
    goodput_tokens: int = 0
    # fleet-wide span-ring overflow (Σ dllama_spans_dropped_total):
    # non-zero means some replica's incident timeline has holes
    spans_dropped: int = 0
    slo: dict = dataclasses.field(default_factory=dict)
    page_seconds: float = 0.0
    stall_seconds: dict = dataclasses.field(default_factory=dict)
    cost_classes: dict = dataclasses.field(default_factory=dict)

    @property
    def occupancy(self) -> float:
        return self.active / self.slots if self.slots else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    @property
    def attainment(self) -> dict:
        out = {}
        for cls, counts in sorted(self.slo.items()):
            attempted = counts.get("attempted", 0)
            out[cls] = (round(counts.get("met", 0) / attempted, 6)
                        if attempted else 1.0)
        return out

    @property
    def cost_per_goodput_token(self) -> float:
        """Fleet compute seconds per GOODPUT token — Σ per-class compute
        seconds / Σ goodput tokens, the attribution headline: what a
        deadline-met token actually cost the fleet."""
        compute = sum(c.get("compute_s", 0.0)
                      for c in self.cost_classes.values())
        return compute / self.goodput_tokens if self.goodput_tokens else 0.0

    @property
    def cost(self) -> dict:
        """Per-class cost columns RECOMPUTED from the summed counts (the
        module-docstring pin: never average per-replica ratios)."""
        out = {}
        for cls, c in sorted(self.cost_classes.items()):
            toks = c.get("tokens", 0)
            out[cls] = {
                "tokens": toks,
                "requests": c.get("requests", 0),
                "page_seconds": round(c.get("page_s", 0.0), 9),
                "stall_seconds": round(c.get("stall_s_total", 0.0), 9),
                "cost_per_token_s": (
                    round(c.get("compute_s", 0.0) / toks, 9)
                    if toks else 0.0),
                "page_s_per_token": (
                    round(c.get("page_s", 0.0) / toks, 9)
                    if toks else 0.0),
            }
        return out

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["occupancy"] = round(self.occupancy, 6)
        out["prefix_hit_rate"] = round(self.prefix_hit_rate, 6)
        out["attainment"] = self.attainment
        out["page_seconds"] = round(self.page_seconds, 9)
        out["stall_seconds"] = {k: round(v, 9) for k, v
                                in sorted(self.stall_seconds.items())}
        out["cost"] = self.cost
        out["cost_per_goodput_token"] = round(
            self.cost_per_goodput_token, 9)
        return out


def rollup(rows: list, stale_after: float | None = None,
           now: float | None = None) -> FleetRollup:
    """Aggregate replica rows into the fleet row. Unhealthy replicas
    contribute only to the replica/healthy counts — their zeroed
    signals must not dilute occupancy or hit rates.

    ``stale_after`` (seconds) marks a healthy row STALE when its
    ``scraped_at`` stamp is older than that against ``now`` (defaults
    to ``time.monotonic()``; pass it explicitly in gates for
    determinism). Stale rows count only in ``FleetRollup.stale`` —
    their last-known numbers are excluded from every sum, because a
    router steering on a ten-minute-old pages_free reading is steering
    blind. Rows without a stamp (direct-built: tests, sims) are never
    stale."""
    if now is None:
        now = time.monotonic()
    agg = FleetRollup(replicas=len(rows))
    schemas: list[int] = []
    for r in rows:
        if not r.healthy:
            continue
        if (stale_after is not None and r.scraped_at is not None
                and now - r.scraped_at > stale_after):
            agg.stale += 1
            continue
        agg.healthy += 1
        schemas.append(r.schema)
        for block in HEALTH_BLOCKS:
            if r.reports(block):
                agg.reporting[block] = agg.reporting.get(block, 0) + 1
        agg.slots += r.slots
        agg.active += r.active
        agg.queue_depth += r.queue_depth
        agg.steps += r.steps
        agg.generated_tokens += r.generated_tokens
        # spans_dropped is obs-plane, not block-gated: every replica
        # with a span tracer exports it, and zero from one without is
        # an honest zero (no spans -> none dropped)
        agg.spans_dropped += r.spans_dropped
        # block-derived cells only count when the replica's scrape
        # actually carried the block: an older replica (or one with the
        # feature off) is skipped, not averaged in as zeros — its
        # absence shows in `reporting`, where a router can see it
        if r.reports("paged_kv"):
            agg.kv_pages += r.kv_pages
            agg.kv_pages_free += r.kv_pages_free
            agg.prefix_hits += r.prefix_hits
            agg.prefix_misses += r.prefix_misses
            agg.prefill_tokens_saved += r.prefill_tokens_saved
        if r.reports("slo"):
            agg.goodput_tokens += r.goodput_tokens
            for cls, counts in r.slo.items():
                cell = agg.slo.setdefault(cls, {})
                for key, v in counts.items():
                    if isinstance(v, (int, float)) \
                            and not key.endswith("_s"):
                        cell[key] = cell.get(key, 0) + v
        if r.reports("sched"):
            agg.page_seconds += r.page_seconds
            for cause, s in r.stall_seconds.items():
                agg.stall_seconds[cause] = (
                    agg.stall_seconds.get(cause, 0.0) + s)
            # cost cells: sum EVERY numeric count (tokens AND seconds —
            # cost ratios are recomputed from these sums in
            # FleetRollup.cost, so unlike the slo block the _s fields
            # must survive the merge)
            for cls, counts in r.cost_classes.items():
                cell = agg.cost_classes.setdefault(cls, {})
                for key, v in counts.items():
                    if isinstance(v, (int, float)):
                        cell[key] = cell.get(key, 0) + v
    if schemas:
        agg.schema_min, agg.schema_max = min(schemas), max(schemas)
    return agg


def signals_from_health(name: str, payload: dict) -> ReplicaSignals:
    """Build a replica row from the server's /health JSON (the shape
    runtime/server.py emits — pinned by tests against a live server so
    a /health rename breaks HERE, not silently in a router)."""
    row = ReplicaSignals(name=name)
    row.schema = int(payload.get("schema", 0))
    row.present = {b for b in HEALTH_BLOCKS
                   if isinstance(payload.get(b), dict)}
    row.state = str(payload.get("state", ""))
    row.healthy = row.state in ("starting", "serving", "degraded")
    row.uptime_s = float(payload.get("uptime_s", 0.0))
    row.slots = int(payload.get("slots", 0))
    row.active = int(payload.get("active", 0))
    row.queue_depth = int(payload.get("queue_depth",
                                      payload.get("queued", 0)))
    row.occupancy = float(payload.get("occupancy", 0.0))
    row.steps = int(payload.get("steps", 0))
    row.generated_tokens = int(payload.get("generated_tokens", 0))
    paged = payload.get("paged_kv") or {}
    row.kv_pages = int(paged.get("pages", 0))
    row.kv_pages_free = int(paged.get("pages_free", 0))
    row.prefix_hits = int(paged.get("prefix_hits", 0))
    row.prefix_misses = int(paged.get("prefix_misses", 0))
    row.prefill_tokens_saved = int(paged.get("prefill_tokens_saved", 0))
    slo = payload.get("slo") or {}
    for cls, cell in (slo.get("classes") or {}).items():
        row.slo[cls] = {k: int(cell.get(k, 0))
                        for k in ("attempted", "met", "violated",
                                  "failed", "goodput_tokens")}
        row.goodput_tokens += row.slo[cls]["goodput_tokens"]
    # the accounting plane's /health "sched" block: absent on
    # pre-ledger servers — the row simply carries zero cost columns
    sched = payload.get("sched") or {}
    totals = sched.get("cost_totals") or {}
    row.page_seconds = float(totals.get("page_s", 0.0))
    for cause, s in (totals.get("stall_s") or {}).items():
        row.stall_seconds[str(cause)] = float(s)
    for cls, cell in (sched.get("cost_by_class") or {}).items():
        row.cost_classes[cls] = {
            "tokens": int(cell.get("tokens", 0)),
            "requests": int(cell.get("requests", 0)),
            "compute_s": float(cell.get("compute_s", 0.0)),
            "page_s": float(cell.get("page_s", 0.0)),
            "stall_s_total": float(cell.get("stall_s_total", 0.0)),
            "page_steps": int(cell.get("page_steps", 0)),
        }
    return row


def parse_metrics(text: str) -> dict:
    """Prometheus text exposition -> {series_key: float} (series key =
    ``name{labels}`` exactly as exposed). Tolerant of HELP/TYPE lines;
    raises ValueError on an unparseable sample — a half-read scrape
    feeding a router is worse than a failed one."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        if not key:
            raise ValueError(f"sample line without a name: {line!r}")
        try:
            out[key] = float(value)
        except ValueError as e:
            raise ValueError(f"unparseable sample {line!r}") from e
    return out


def apply_metrics(row: ReplicaSignals, samples: dict) -> ReplicaSignals:
    """Cross-fill counter-backed fields from a parsed /metrics scrape —
    the counters a /health snapshot doesn't carry (spans_dropped and
    friends stay available to callers via ``samples`` itself; this
    fills only the router-facing row)."""
    if "dllama_prefix_hits_total" in samples:
        row.prefix_hits = int(samples["dllama_prefix_hits_total"])
        _mark_present(row, "paged_kv")
    if "dllama_kv_pages_free" in samples:
        row.kv_pages_free = int(samples["dllama_kv_pages_free"])
        _mark_present(row, "paged_kv")
    if "dllama_queue_depth" in samples:
        row.queue_depth = int(samples["dllama_queue_depth"])
    if "dllama_spans_dropped_total" in samples:
        row.spans_dropped = int(samples["dllama_spans_dropped_total"])
    goodput = sum(v for k, v in samples.items()
                  if k.startswith("dllama_goodput_tokens_total"))
    if goodput:
        row.goodput_tokens = int(goodput)
        _mark_present(row, "slo")
    # the labeled cost series: cross-fill the cost columns from the
    # counters when /health came from a pre-ledger build (or was pruned)
    page_s = 0.0
    seen_page = False
    for k, v in samples.items():
        if k.startswith("dllama_page_seconds_total{"):
            page_s += v
            seen_page = True
        elif k.startswith("dllama_stall_seconds_total{"):
            cause = _series_label(k, "cause")
            if cause and cause not in row.stall_seconds:
                row.stall_seconds[cause] = v
    if seen_page and not row.page_seconds:
        row.page_seconds = page_s
    if seen_page or row.stall_seconds:
        _mark_present(row, "sched")
    return row


def _mark_present(row: ReplicaSignals, block: str) -> None:
    """A /metrics cross-fill IS evidence the replica reports the block's
    signal — without this, a row whose /health predates the block but
    whose counters carry it would be skipped by the rollup guards."""
    if row.present is not None:
        row.present.add(block)


def _series_label(series_key: str, label: str) -> str | None:
    """Pull one label value out of a ``name{a="x",b="y"}`` series key
    (parse_metrics keys series by the exposed line verbatim)."""
    lo = series_key.find("{")
    if lo < 0 or not series_key.endswith("}"):
        return None
    for part in series_key[lo + 1:-1].split(","):
        k, _, v = part.partition("=")
        if k.strip() == label:
            return v.strip().strip('"')
    return None


def scrape_replica(name: str, base_url: str,
                   timeout: float = 5.0) -> ReplicaSignals:
    """One replica's row from a live server: GET /health (+ /metrics
    when served). Any failure yields an UNHEALTHY row with ``error``
    set — the fleet plane reports dead replicas, it never hides them.
    Every returned row (error rows included) carries a monotonic
    ``scraped_at`` stamp so ``rollup(stale_after=...)`` can age out
    rows a polling loop stopped refreshing."""
    base = base_url.rstrip("/")
    try:
        with urllib.request.urlopen(f"{base}/health",
                                    timeout=timeout) as r:
            health = json.loads(r.read())
        row = signals_from_health(name, health)
    except (OSError, ValueError) as e:
        return ReplicaSignals(name=name, healthy=False,
                              error=f"{type(e).__name__}: {e}",
                              scraped_at=time.monotonic())
    try:
        with urllib.request.urlopen(f"{base}/metrics",
                                    timeout=timeout) as r:
            apply_metrics(row, parse_metrics(r.read().decode()))
    except (OSError, ValueError):
        pass  # metrics disabled (--no-metrics) — /health alone suffices
    row.scraped_at = time.monotonic()
    return row
