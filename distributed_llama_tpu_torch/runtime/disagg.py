"""Prefill/decode disaggregation: the two-pool serving topology (the JAX
package's runtime/disagg.py, its own copy here).

Prefill and decode fight for the same card: one long prefill dispatch
stalls every in-flight decode behind it, the TTFT/TPOT interference the
disaggregation line of work (DistServe, OSDI'24; Splitwise, ISCA'24)
removes by giving each phase its own pool. This module is that topology
over two ``ContinuousEngine``s:

* the PREFILL pool admits requests (SLO-class priority order, the
  engine's ``slo_priority``, with batch prefills preemptable at
  page-aligned chunk boundaries via ``prefill_hold``), fills their KV
  pages, and samples the FIRST token (TTFT is the prefill pool's job);
* the request then hands off as its JOURNAL record (prompt ids, sampled
  tokens, coin cursor: runtime/journal.entry_to_wire), exactly the state
  crash recovery replays, so the decode pool re-admits through the path
  ``ContinuousEngine.recover`` uses and the continued stream is the
  single-pool run's;
* its full prompt pages ship over the page channel (runtime/
  page_channel.py) in the one page wire layout (runtime/pagewire.py, the
  disk tier's bytes, a CRC32 a page) and land in the decode pool's radix
  tree as promotion-PENDING nodes (``PagedAllocator.adopt_remote_pages``);
  admission PAUSEs the request until the payloads land, then prefills
  only the unshipped tail (the partial last page and the first sampled
  token);
* later same-prefix requests hit the decode pool's tree directly.

The hand-over is durable once the decode pool's journal holds the admit
record: the transfer and adoption can die at any point after it and
recovery re-derives the KV by prefill. ``DisaggPair`` drives both pools
from ONE thread (the deterministic harness of the tests and the offline
path); ``runtime/server.py`` wires the same primitives across two
processes (POST /prefill and the page channel).
"""

from __future__ import annotations

import dataclasses
import time

from ..obs import tracectx
from .continuous import ContinuousEngine, Request
from .journal import JournalEntry

HANDOFF_VERDICTS = ("shipped", "local", "failed")

# the cross-pool clock-skew anchor pair: the initiating pool
# records SPAN_HANDOFF_SEND around the transfer, the serving pool records
# SPAN_HANDOFF_RECV parented on it — a trace join aligns the two pools'
# clocks on exactly this pair
SPAN_HANDOFF_SEND = "handoff"
SPAN_HANDOFF_RECV = "prefill_handoff"
HANDOFF_CAT = "handoff"


class DisaggMetrics:
    """The disaggregation observability surface (pre-registered at zero
    so a fresh scrape already shows the full matrix):

    * ``dllama_handoff_requests_total{verdict}`` — shipped (handed to
      the decode pool), local (completed on the prefill pool: the
      stream ended inside the prefill budget), failed (the handoff
      could not complete);
    * ``dllama_dcn_pages_shipped_total`` / ``dllama_dcn_bytes_total`` —
      page-channel volume (payload bytes, the DCN budget's unit);
    * ``dllama_handoff_seconds`` — prefill-retire -> decode-admission
      latency histogram;
    * ``dllama_handoff_queue_depth`` — handoffs published and not yet
      acked by the decode pool.
    """

    def __init__(self, registry):
        self.registry = registry
        self.handoffs = {
            v: registry.labeled_counter(
                "dllama_handoff_requests_total", {"verdict": v},
                "Prefill->decode handoffs by outcome (shipped/local/"
                "failed)")
            for v in HANDOFF_VERDICTS}
        self.pages_shipped = registry.counter(
            "dllama_dcn_pages_shipped_total",
            "KV pages shipped over the DCN page channel")
        self.bytes_shipped = registry.counter(
            "dllama_dcn_bytes_total",
            "KV page payload bytes shipped over the DCN page channel")
        self.handoff_latency = registry.histogram(
            "dllama_handoff_seconds",
            "Handoff latency: prefill retire to decode admission")
        self.queue_depth = registry.gauge(
            "dllama_handoff_queue_depth",
            "Handoffs in flight (published, not yet acked)")


def export_prefix_pages(engine: ContinuousEngine, tokens) -> list:
    """Wire payloads (host numpy plane tuples) of the full prompt pages
    the engine's radix tree holds for ``tokens``: the prefill side of a
    handoff. Refs are retained for the read and released after; the tree
    keeps its own copy (and its recency bump) so the pages stay warm for
    same-prefix siblings. The export stops at a page whose promotion has
    not landed (its bytes are not in the pool yet)."""
    from ..models.llama import fetch_page_planes

    alloc = engine.allocator
    if alloc is None:
        return []
    n_pre = len(tokens) - 1
    pages = alloc.tree.match(tokens[:n_pre])
    try:
        ready = []
        for pid in pages:
            if alloc.is_pending(pid):
                break
            ready.append(fetch_page_planes(engine.cache, pid))
        return ready
    finally:
        alloc.release_pages(pages)


def encode_handoff_pages(payloads, corrupt=None) -> list:
    """Frame each payload for the wire (pagewire.encode_record).
    ``corrupt`` is the chaos hook (runtime/chaos.ChaosMonkey.page_drop,
    armed through ``DisaggPair(chaos=)``): when it fires for a page, the
    payload is replaced with ZEROS and re-framed with a VALID CRC — the
    seeded in-flight corruption that slips past framing, which only the
    bitwise stream gate can catch (the drop-page-in-flight mutation arm
    of the kill_mid_handoff drill)."""
    import numpy as np

    from .pagewire import encode_record

    records = []
    for planes in payloads:
        if corrupt is not None and corrupt():
            # planes are host numpy (fetch_page_planes output) — zeroing
            # them is pure host work
            planes = tuple(np.zeros(p.shape, p.dtype) for p in planes)
        records.append(encode_record(planes))
    return records


def entry_for_stub(engine: ContinuousEngine, stub: Request) -> JournalEntry:
    """The handoff record of a retired prefill stub: the engine's journal
    entry when one exists (the production path — it carries the exact
    coin cursor), else derived from the stub directly — legal only for
    greedy streams, which draw no coins (the virtual-clock simulation's
    path)."""
    if engine._journal is not None:
        e = engine._journal.entry(stub.index)
        if e is not None:
            if stub.ledger is not None:
                # the stub's closed bill (carried merged in) rides the
                # handoff record — the decode pool's ledger seeds from it
                # so the request's cost stays whole across pools
                e.ledger = stub.ledger.snapshot()
            return e
    temp = (stub.temperature if stub.temperature is not None
            else engine.temperature)
    if temp != 0.0:
        raise ValueError(
            "handing off a sampled stream needs the prefill engine's "
            "journal (the coin cursor lives there); journal-less "
            "handoff is greedy-only")
    n_pre = len(stub.tokens) - 1
    return JournalEntry(
        rid=stub.index, tokens=list(stub.tokens), steps=stub.steps,
        temperature=temp,
        topp=stub.topp if stub.topp is not None else engine.topp,
        seed=(stub.seed if stub.seed is not None
              else engine.seed + stub.index),
        slo=stub.slo_class, cursor=0, sampled=list(stub.out[n_pre:]),
        trace=(stub.trace.to_header() if stub.trace is not None
               else None),
        ledger=(stub.ledger.snapshot() if stub.ledger is not None
                else None))


def decode_request(entry: JournalEntry, steps: int) -> Request:
    """The decode pool's re-admission request: the recovery replay shape
    (already-sampled tokens ride the forced window, the sampler
    fast-forwards by the coin cursor) with the ORIGINAL step budget —
    the stub's budget was the prefill cut, not the request's. The
    entry's traceparent (when the prefill pool propagated one) continues
    the SAME trace with a ``handoff`` link span."""
    trace = None
    if entry.trace:
        try:
            trace = tracectx.from_header(entry.trace,
                                         link=tracectx.LINK_HANDOFF)
        except ValueError:
            trace = None  # a damaged header never blocks the handoff
    return Request(tokens=entry.replay_tokens, steps=steps,
                   temperature=entry.temperature, topp=entry.topp,
                   seed=entry.seed, slo_class=entry.slo,
                   coin_cursor=entry.cursor, trace=trace,
                   carried_cost=entry.ledger)


def make_priority_hold(engine: ContinuousEngine, policy):
    """The prefill pool's chunk-boundary preemption predicate: park a
    slot's prefill when a STRICTLY higher-ranked class is waiting in the
    queue (obs/slo.SLOPolicy.rank — 0 = highest). Wire it with
    ``engine.prefill_hold = make_priority_hold(engine, policy)``."""

    def hold(slot) -> bool:
        mine = policy.rank(slot.req.slo_class)
        with engine._lock:
            queued = list(engine._queue)
        return any(policy.rank(r.slo_class) < mine for r in queued)

    return hold


def prefill_stub(tokens, steps: int, temperature=None, topp=None,
                 seed=None, slo_class=None) -> tuple[Request, bool]:
    """The prefill pool's view of a request: budget cut to prompt
    positions + ONE sampled token (TTFT is the prefill pool's job; the
    decode pool owns the rest). Returns (request, may_hand_off) —
    False when the whole budget fits inside the prefill cut (short
    requests complete locally; no DCN bytes moved for nothing)."""
    n_pre = len(tokens) - 1
    pre_steps = min(steps, n_pre + 1)
    req = Request(tokens=list(tokens), steps=pre_steps,
                  temperature=temperature, topp=topp, seed=seed,
                  slo_class=slo_class)
    return req, pre_steps < steps


def stub_needs_handoff(stub: Request) -> bool:
    """True when a retired prefill stub's stream continues on the decode
    pool: it sampled its one token and that token was not the BOS stop
    (a BOS'd or errored stub IS the finished stream)."""
    if stub.error is not None or stub.cancelled:
        return False
    n_pre = len(stub.tokens) - 1
    return stub.n_sampled >= 1 and len(stub.out) == n_pre + 1


@dataclasses.dataclass
class Handoff:
    """One in-flight prefill->decode hand-over (DisaggPair bookkeeping)."""

    entry: JournalEntry
    req: Request              # the decode pool's re-admission request
    adopted: list             # decode-pool tree nodes holding shipped pages
    n_pages: int
    payload_bytes: int
    t_start: float


class DisaggPair:
    """Two engines, one scheduler thread: the deterministic two-pool
    harness (parity tests, chaos drills, the offline CLI path). The
    prefill engine needs a journal when any request samples at
    temperature > 0 (the coin cursor crosses pools in the journal
    record); the decode engine needs ``remote_pages=True``. With
    ``channel_host`` set, pages genuinely cross a TCP page channel
    (CRC-verified frames); without it they still round-trip the wire
    codec in memory — every handoff exercises the exact bytes the DCN
    would carry."""

    def __init__(self, prefill: ContinuousEngine, decode: ContinuousEngine,
                 channel_host: str | None = None, registry=None,
                 chaos=None):
        if prefill.page_size <= 0 or decode.page_size <= 0:
            raise ValueError("disaggregation ships KV PAGES: both pools "
                             "need page_size > 0")
        if prefill.page_size != decode.page_size:
            raise ValueError(
                f"page_size mismatch: prefill {prefill.page_size} != "
                f"decode {decode.page_size} — the wire unit must agree")
        if decode.allocator is None or not decode.allocator.remote:
            raise ValueError("the decode engine must be constructed with "
                             "remote_pages=True (handoff page ingestion)")
        self.prefill = prefill
        self.decode = decode
        self._chaos = chaos
        self.obs = DisaggMetrics(registry) if registry is not None else None
        self._server = None
        self._client = None
        if channel_host is not None:
            from .page_channel import PageChannelClient, PageChannelServer

            self._server = PageChannelServer(host=channel_host)
            self._client = PageChannelClient(
                f"{channel_host}:{self._server.port}")
        self.handoffs_shipped = 0
        self.handoffs_local = 0
        self.handoffs_failed = 0

    @property
    def channel_port(self) -> int | None:
        return self._server.port if self._server is not None else None

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
        self.prefill.close()
        self.decode.close()

    # ------------------------------------------------------------ handoff

    def _count(self, verdict: str) -> None:
        field = f"handoffs_{verdict}"
        setattr(self, field, getattr(self, field) + 1)
        if self.obs is not None:
            self.obs.handoffs[verdict].inc()
            if self._server is not None:
                self.obs.queue_depth.set(self._server.queue_depth)

    def handoff(self, stub: Request, steps: int,
                cut_after: int | None = None) -> Handoff | None:
        """Hand one retired prefill stub to the decode pool. Order is
        the durability contract: the decode ADMIT is journaled (submit)
        BEFORE any page moves, so a decode-pool death mid-transfer
        recovers the request from its journal — the shipped pages are an
        optimization, prefill re-derives them when they never land.
        ``cut_after`` (drills) aborts the page transfer after that many
        pages. Returns None when the stub needs no handoff (counted as
        a LOCAL completion)."""
        from .pagewire import decode_record, record_payload_bytes

        if not stub_needs_handoff(stub):
            self._count("local")
            return None
        t0 = time.monotonic()
        entry = entry_for_stub(self.prefill, stub)
        # trace propagation across the hand-over: the page transfer
        # rides its own RPC span, the send/recv anchor pair a trace join
        # aligns the two pools' clocks on. The
        # drop-traceparent mutation (ChaosMonkey.trace_drop) strips the
        # header at exactly this seam, so the decode pool's spans can no
        # longer join the prefill pool's — the orphan the join gate must
        # catch.
        parent = None
        if entry.trace:
            try:
                parent = tracectx.parse_header(entry.trace)
            except ValueError:
                parent = None
        dropped = self._chaos is not None and self._chaos.trace_drop()
        if dropped:
            entry.trace = None
        rpc = parent.child() if parent is not None else tracectx.mint()
        t_send0 = time.perf_counter()
        req = decode_request(entry, steps)
        self.decode.submit(req)  # journal admit lands FIRST (durability)
        t_recv0 = time.perf_counter()
        payloads = export_prefix_pages(self.prefill, stub.tokens)
        records = encode_handoff_pages(
            payloads, corrupt=(self._chaos.page_drop
                               if self._chaos is not None else None))
        nbytes = sum(record_payload_bytes(r) for r in records)
        if self.obs is not None and records:
            self.obs.pages_shipped.inc(len(records))
            self.obs.bytes_shipped.inc(nbytes)
        if self._server is not None:
            hid = f"h{stub.index}"
            self._server.publish(hid, records,
                                 trace=(None if dropped
                                        else rpc.to_header()))
            if self.obs is not None:
                self.obs.queue_depth.set(self._server.queue_depth)
            planes = self._client.fetch(hid, len(records),
                                        cut_after=cut_after)
        else:
            if cut_after is not None:
                records = records[:cut_after]
            planes = [decode_record(r) for r in records]
        if self.prefill._spans is not None:
            # the recv half of the anchor pair, on the prefill pool's
            # clock; a dropped header leaves it unparented — the
            # unjoined state the gate exists to surface
            recv = (tracectx.mint() if dropped or parent is None
                    else rpc.child())
            self.prefill._spans.add(
                SPAN_HANDOFF_RECV, HANDOFF_CAT, t_recv0,
                time.perf_counter() - t_recv0, pages=len(records),
                **tracectx.span_fields(recv))
        adopted = self.decode.adopt_remote(
            stub.tokens[:len(stub.tokens) - 1], planes)
        if self.decode._spans is not None:
            self.decode._spans.add(
                SPAN_HANDOFF_SEND, HANDOFF_CAT, t_send0,
                time.perf_counter() - t_send0, pages=len(records),
                bytes=nbytes, **tracectx.span_fields(rpc))
        if req.ledger is not None:
            # the DCN bill + the seconds this request spent crossing
            # pools (seconds-only stall: no engine dispatch rode it)
            req.ledger.charge_dcn(len(records), nbytes)
            req.ledger.charge_stall_s("handoff_wait",
                                      time.monotonic() - t0)
        self._count("shipped")
        if self.obs is not None:
            self.obs.handoff_latency.observe(time.monotonic() - t0)
        return Handoff(entry=entry, req=req, adopted=adopted,
                       n_pages=len(records), payload_bytes=nbytes,
                       t_start=t0)

    def cancel(self, handoff: Handoff) -> None:
        """Mid-transfer/mid-decode cancel: the decode request retires at
        the next sweep (freeing its slot + pages) and the adopted-but-
        never-applied pending nodes drop NOW — a cancelled handoff must
        free pages on both pools, not strand pending junk."""
        self.decode.cancel(handoff.req)
        self.decode.allocator.drop_adopted(handoff.adopted)
        if self._server is not None:
            self._server.retire(f"h{handoff.entry.rid}")
            if self.obs is not None:
                self.obs.queue_depth.set(self._server.queue_depth)

    # ------------------------------------------------------------ offline

    def _drain(self, engine, max_iters: int = 100_000) -> None:
        it = 0
        while engine.step_many(engine.block_steps, quiet=True):
            it += 1
            if it >= max_iters:
                raise RuntimeError("disagg pool is not draining")

    def run(self, requests: list, steps: int) -> tuple[list, dict]:
        """Offline two-pool drive (ContinuousEngine.run's shape): decode
        every request to BOS or ``steps`` positions through prefill ->
        handoff -> decode; outputs in request order, bitwise the
        single-pool streams. Returns (outs, summary)."""
        stubs = []
        for i, tokens in enumerate(requests):
            if not tokens:
                raise ValueError(f"request {i} has no prompt tokens")
            stub, _ = prefill_stub(tokens, steps)
            self.prefill.submit(stub)
            stubs.append(stub)
        self._drain(self.prefill)
        finals: list = []
        for stub in stubs:
            h = self.handoff(stub, steps)
            finals.append(stub if h is None else h.req)
        self._drain(self.decode)
        outs = [r.out for r in finals]
        return outs, self.summary()

    def summary(self) -> dict:
        a = self.decode.allocator
        return {
            "shipped": self.handoffs_shipped,
            "local": self.handoffs_local,
            "failed": self.handoffs_failed,
            "pages_adopted": a.remote_adopted,
            "pages_rejected": a.remote_rejected,
            "prefill_steps": self.prefill.stats.steps,
            "prefill_chunks": self.prefill.stats.prefill_chunks,
            "decode_steps": self.decode.stats.steps,
            "decode_chunks": self.decode.stats.prefill_chunks,
            "channel_port": self.channel_port,
        }
